"""The trainers' entry point (port of :mod:`repro.launch.train`): the
paper's GCN minibatch loop with its Table-1 comparison arms, and the
causal-LM loop with its fault-recovery path.

:func:`train_gcn` keeps the reference's signature.  ``model="gcn"`` with
``dataflow="ours"`` runs the engine-native stacked-core
:class:`~repro_torch.launch.trainer.Trainer`; the reference arms — the
naive (Table-1 baseline) dataflow and the GraphSAGE root-path model — run
the single-device loop (:func:`_train_gcn_reference`): ``gcn_loss`` over
the sampled COO layers, the estimator's per-layer orders, momentum SGD.
Both run on the card unless ``device="cpu"``.

CPU runs (the kernels' plain versions)::

    PYTHONPATH=src python -m repro_torch.launch.train gcn --device cpu \\
        --dataset flickr --scale 0.01 --dataflow naive --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train gcn --device cpu \\
        --model sage --steps 20

:func:`train_lm` trains any LM family (AdamW, global-norm clip) on the
synthetic token stream (encdec on stub frames of ``seq`` positions and
``seq // 4`` decoder tokens, as the reference), with its fault path: a
``HealthMonitor`` over 4 simulated workers, a synchronous checkpoint on
the first missed heartbeat, an async one every 10 steps, and ``resume``
through ``CheckpointManager`` and ``TokenPipeline.restore``.  Like the
reference's it steps without remat; past ``FLASH_THRESHOLD`` tokens
(``--seq`` above 8192) its attention's gradient is ``flash_mha``'s
backward kernel.  Its checkpoints have the reference's layout, so it
resumes the reference's too.  The ``lm`` command trains the smoke config, as the reference's does
(its ``--smoke`` is on by default and cannot be turned off); the full
config trains through ``train_lm(smoke=False)``::

    PYTHONPATH=src python -m repro_torch.launch.train lm --device cpu \
        --arch llama3.2-1b --steps 20
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence, Union

import torch

from repro_torch.checkpoint import Action, CheckpointManager, HealthMonitor
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.gcn_paper import FANOUTS, HIDDEN, gcn_config
from repro_torch.core.estimator import LayerShape
from repro_torch.data import GraphBatchPipeline, TokenPipeline
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine import EngineConfig
from repro_torch.engine.registry import get_format
from repro_torch.graph import GraphDataset, NeighborSampler, make_dataset
from repro_torch.models import lm
from repro_torch.models.gcn_model import (gcn_loss, init_gcn_params,
                                          pick_orders)
from repro_torch.optim import (AdamWState, adamw, apply_updates, sgd,
                               tree_leaves, tree_map)


def _dataset(dataset: Union[str, GraphDataset], scale: float,
             feat_dim: Optional[int]) -> GraphDataset:
    if isinstance(dataset, GraphDataset):
        return dataset
    return make_dataset(dataset, scale=scale, feat_dim=feat_dim)


# ---------------------------------------------------------------------------
# GCN minibatch training (paper §5.1 setup)
# ---------------------------------------------------------------------------
def train_gcn(dataset: Union[str, GraphDataset] = "flickr", *,
              model: str = "gcn", dataflow: str = "ours",
              engine: Optional[str] = None, scale: float = 0.01,
              batch_size: int = 64, steps: int = 100, lr: float = 0.05,
              hidden: Optional[int] = None, feat_dim: Optional[int] = None,
              n_cores: int = 1, input_pipeline: str = "prefetch",
              ckpt_dir: Optional[str] = None, resume: bool = False,
              seed: int = 0, log_every: int = 10,
              device: DeviceLike = None) -> Dict[str, Any]:
    """Train a GCN on ``device`` (``None`` → the card; raises without one).

    ``dataset`` is a name for :func:`make_dataset` (with ``scale`` and
    ``feat_dim``) or a built :class:`GraphDataset`, as the Trainer takes
    it.  ``engine`` is an Engine spec (default ``"coo+serial"``) for the
    'ours' dataflow; ``n_cores`` > 1 trains on that many stacked cores.
    The reference arms (``dataflow="naive"``, ``model="sage"``) run the
    single-device loop.

    Returns ``params``, ``loss_history`` (this invocation's steps),
    ``orders`` (the §4.4 sequence-estimator report) and ``wall_s``.
    """
    if engine is not None:
        EngineConfig.from_spec(engine)   # validate early, listing options
    if dataflow == "naive" or model == "sage":
        return _train_gcn_reference(
            dataset, model=model, dataflow=dataflow, engine=engine,
            scale=scale, batch_size=batch_size, steps=steps, lr=lr,
            hidden=hidden, feat_dim=feat_dim, ckpt_dir=ckpt_dir,
            resume=resume, seed=seed, log_every=log_every, device=device)

    from repro_torch.launch.trainer import Trainer

    ds = _dataset(dataset, scale, feat_dim)
    cfg = gcn_config(ds.stats.name, model, dataflow)
    t0 = time.time()
    tr = Trainer(engine or "coo+serial", ds, n_cores=n_cores,
                 hidden=hidden or HIDDEN, batch_size=batch_size,
                 fanouts=FANOUTS, lr=lr, seed=seed,
                 input_pipeline=input_pipeline, ckpt_dir=ckpt_dir,
                 ckpt_every=50, log_every=log_every, device=device)
    orders = _estimator_orders(ds, tr.sampler, cfg, batch_size, seed,
                               feat_dim=ds.features.shape[1],
                               hidden=hidden or HIDDEN)
    if resume:
        tr.resume()
    try:
        history = tr.train_steps(max(steps - tr.global_step, 0))
    finally:
        tr.close()
    return {"params": tr.params, "loss_history": history,
            "orders": orders, "wall_s": time.time() - t0,
            "spec": tr.engine.spec, "requested_spec": tr.requested_spec}


def _estimator_orders(ds, sampler, cfg, batch_size: int, seed: int, *,
                      feat_dim: int, hidden: int):
    """Sequence estimator report (paper §4.4): one probe batch gives the
    per-layer shapes, the estimator picks CoAg/AgCo per layer.  The
    stacked-core Trainer always runs CoAg; the single-device loop obeys
    the report."""
    mb0, _, _ = next(GraphBatchPipeline(ds, sampler, batch_size, seed=seed))
    shapes = [LayerShape(b=batch_size, n=l.n_dst, nbar=l.n_src,
                         d=feat_dim if i == len(mb0.layers) - 1 else hidden,
                         h=cfg.n_classes if i == 0 else hidden,
                         e=l.nnz, c=cfg.n_classes)
              for i, l in enumerate(mb0.layers)]
    return pick_orders(cfg, shapes)


def _train_gcn_reference(dataset: Union[str, GraphDataset], *, model: str,
                         dataflow: str, scale: float, batch_size: int,
                         steps: int, lr: float, hidden: Optional[int],
                         feat_dim: Optional[int], ckpt_dir: Optional[str],
                         resume: bool, seed: int, log_every: int,
                         engine: Optional[str] = None,
                         device: DeviceLike = None) -> Dict[str, Any]:
    """The single-device loop — the reference arm for the naive (Table-1
    baseline) dataflow and the SAGE root-path model, which the stacked-core
    step does not implement: ``gcn_loss`` over the sampled COO layers with
    momentum SGD and the estimator's orders.  ``engine`` selects the 'ours'
    layers' spec (sage model); the loop runs the layers straight on the
    sampled COOs, so, as in the reference, only the ``coo`` format is
    taken.  Checkpoints hold ``(params, opt_state)`` plus ``step`` and
    ``pipeline`` in the reference's layout."""
    if engine is not None and dataflow == "ours":
        cfg_spec = EngineConfig.from_spec(engine)
        if cfg_spec.is_auto:
            raise ValueError(
                "engine spec 'auto': the reference loop jits one fixed "
                "single-device layer stack, so there is nothing for the "
                "planner to choose — the engine-native Trainer path "
                "(model='gcn', dataflow='ours') resolves 'auto', or name "
                'a concrete traceable spec such as "coo+serial"')
        if not get_format(cfg_spec.format).traceable:
            raise ValueError(
                f"engine spec {engine!r}: format {cfg_spec.format!r} "
                "builds its layout host-side and cannot be jitted over "
                "sampled graphs in this reference loop — the engine-native "
                "Trainer path (model='gcn', dataflow='ours') supports it, "
                'or use a traceable format such as "coo+serial"')
    dev = resolve_device(device)
    ds = _dataset(dataset, scale, feat_dim)
    cfg = gcn_config(ds.stats.name, model, dataflow)
    if engine:
        cfg = type(cfg)(**{**cfg.__dict__, "engine": engine})
    if feat_dim:
        cfg = type(cfg)(**{**cfg.__dict__, "feat_dim": feat_dim})
    if hidden:
        cfg = type(cfg)(**{**cfg.__dict__, "hidden": hidden})
    sampler = NeighborSampler(ds.graph, fanouts=FANOUTS, pad_multiple=16,
                              seed=seed)
    pipe = GraphBatchPipeline(ds, sampler, batch_size, seed=seed)
    params = init_gcn_params(torch.Generator().manual_seed(seed), cfg,
                             device=dev)
    init, update = sgd(lr, momentum=0.9)
    opt_state = init(params)
    start_step = 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr and resume and mgr.latest_step() is not None:
        (params, opt_state), extra = mgr.restore(
            mgr.latest_step(), (params, opt_state))
        pipe.restore(extra["pipeline"])
        start_step = extra["step"]

    # sequence estimator: one order decision per run (paper §4.4)
    orders = _estimator_orders(ds, sampler, cfg, batch_size, seed,
                               feat_dim=cfg.feat_dim, hidden=cfg.hidden)

    history = []
    t0 = time.time()
    for i in range(start_step, steps):
        mb, feats, labels = next(pipe)
        params, opt_state, loss = train_step(
            params, opt_state, update, mb.layers,
            torch.from_numpy(feats).to(dev), torch.from_numpy(labels).to(dev),
            cfg, orders, batch_size)
        history.append(float(loss))
        if log_every and i % log_every == 0:
            print(f"step {i:5d}  loss {history[-1]:.4f}  orders={orders}")
        if mgr and (i + 1) % 50 == 0:
            mgr.save_async(i + 1, (params, opt_state),
                           extra={"step": i + 1, "pipeline": pipe.state()})
    if mgr:
        mgr.wait()
    return {"params": params, "loss_history": history,
            "orders": orders, "wall_s": time.time() - t0}


def train_step(params, opt_state, update, layers, x: torch.Tensor,
               labels: torch.Tensor, cfg, orders: Sequence[str],
               n_valid: int):
    """One step of the single-device loop: ``gcn_loss`` and its gradient
    with respect to every weight, then the optimizer's ``update``.
    Returns ``(params, opt_state, loss)``; the given params are left
    untouched."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = gcn_loss(live, layers, x, labels, cfg, orders, n_valid=n_valid)
    leaves = tree_leaves(live)
    grads = iter(torch.autograd.grad(loss, leaves))
    grads = tree_map(lambda _: next(grads), live)
    with torch.no_grad():
        upd, opt_state = update(grads, opt_state, params)
        params = apply_updates(params, upd)
    return params, opt_state, loss.detach()


# ---------------------------------------------------------------------------
# LM training (every family)
# ---------------------------------------------------------------------------
def _lm_checkpoint_tree(params, opt_state):
    """``(params, opt_state)`` in the reference's layout (host arrays)."""
    return (lm.params_to_reference(params),
            lm.opt_state_to_reference(opt_state))


def _lm_restore(mgr: CheckpointManager, step: int, cfg, device):
    """``(params, opt_state, extra)`` of an LM checkpoint written by either
    package's ``train_lm``."""
    stored, extra = mgr.read(step)

    def tree(prefix: str) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for key, value in stored.items():
            if not key.startswith(prefix + "/"):
                continue
            *path, leaf = key[len(prefix) + 1:].split("/")
            node = out
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = value
        return out

    params = lm.params_from_reference(tree("0"), cfg, device)
    opt_state = lm.opt_state_from_reference(
        AdamWState(mu=tree("1/mu"), nu=tree("1/nu"), step=stored["1/step"]),
        cfg, device)
    return params, opt_state, extra


def train_lm(arch: str, *, smoke: bool = True, steps: int = 20,
             batch: int = 2, seq: int = 64, lr: float = 1e-3,
             ckpt_dir: Optional[str] = None, resume: bool = False,
             seed: int = 0, log_every: int = 5,
             fault_at: Optional[int] = None,
             device: DeviceLike = None,
             params: Optional[lm.Params] = None) -> Dict[str, Any]:
    """Train ``arch`` (its smoke config, or the full one with
    ``smoke=False``) for ``steps`` steps of AdamW on the token stream, on
    ``device`` (``None`` → the card), with f32 weights drawn from a
    generator seeded with ``seed`` on that device, or ``params`` (the
    port's modules on that device, left untouched).

    ``fault_at``: from that step on, worker 3 of the simulated heartbeat
    is dead — the monitor asks for a checkpoint at the first miss (saved
    when ``ckpt_dir`` is set) and evicts the worker at the second.
    ``resume`` continues from the newest checkpoint in ``ckpt_dir``
    (params, AdamW state, token stream).  Returns ``{"losses",
    "survivors", "step_s"}``, ``step_s`` each step's wall seconds, the
    loss read back included."""
    cfg = get_smoke(arch) if smoke else get_config(arch)
    dev = resolve_device(device)
    enc_frames = seq if cfg.family == "encdec" else 0
    pipe = TokenPipeline(cfg, batch=batch, seq=seq, seed=seed,
                         enc_frames=enc_frames)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = lm.init_params(gen, cfg, dtype=torch.float32)
    optimizer = adamw(lr)
    opt_state = optimizer[0](lm.param_tree(params))
    step_fn = lm.train_step_fn(cfg, optimizer, chunk=16, remat=False)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    monitor = HealthMonitor(n_workers=4)
    start = 0
    if mgr and resume and mgr.latest_step() is not None:
        params, opt_state, extra = _lm_restore(mgr, mgr.latest_step(), cfg,
                                               dev)
        pipe.restore(extra["pipeline"])
        start = extra["step"]

    losses, step_s = [], []
    for i in range(start, steps):
        batch_np = next(pipe)
        if cfg.family == "encdec":
            batch_np["tokens"] = batch_np["tokens"][:, :seq // 4]
            batch_np["labels"] = batch_np["labels"][:, :seq // 4]
        batch_dev = {k: torch.from_numpy(v).to(dev)
                     for k, v in batch_np.items()}
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch_dev)
        losses.append(float(metrics["loss"]))
        dt = time.perf_counter() - t0
        step_s.append(dt)
        # heartbeat: this process plays worker 0; others nominal
        times = [dt, dt, dt, dt]
        if fault_at is not None and i >= fault_at:
            times[3] = None                       # worker 3 is dead for good
        actions = monitor.report_step(i, times)
        if Action.CHECKPOINT_NOW in actions.values() and mgr:
            mgr.save(i + 1, _lm_checkpoint_tree(params, opt_state),
                     extra={"step": i + 1, "pipeline": pipe.state()})
            print(f"step {i}: heartbeat miss → checkpointed")
        if log_every and i % log_every == 0:
            print(f"step {i:4d}  loss {losses[-1]:.4f}  ({dt*1e3:.0f} ms)")
        if mgr and (i + 1) % 10 == 0:
            mgr.save_async(i + 1, _lm_checkpoint_tree(params, opt_state),
                           extra={"step": i + 1, "pipeline": pipe.state()})
    if mgr:
        mgr.wait()
    return {"losses": losses, "survivors": monitor.survivors(),
            "step_s": step_s}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("gcn")
    g.add_argument("--dataset", default="flickr")
    g.add_argument("--model", default="gcn", choices=["gcn", "sage"])
    g.add_argument("--dataflow", default="ours", choices=["ours", "naive"])
    g.add_argument("--engine", default=None,
                   help="Engine spec, e.g. coo+serial (the default) — see "
                        "repro_torch.engine.supported_specs()")
    g.add_argument("--n-cores", type=int, default=1,
                   help="stacked cores of the Trainer (a power of two)")
    g.add_argument("--input-pipeline", default="prefetch",
                   choices=["prefetch", "sync"])
    g.add_argument("--scale", type=float, default=0.01)
    g.add_argument("--batch-size", type=int, default=64)
    g.add_argument("--steps", type=int, default=100)
    g.add_argument("--lr", type=float, default=0.05)
    g.add_argument("--hidden", type=int, default=None)
    g.add_argument("--feat-dim", type=int, default=None)
    g.add_argument("--ckpt-dir", default=None)
    g.add_argument("--resume", action="store_true")
    g.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    l = sub.add_parser("lm")
    l.add_argument("--arch", required=True)
    l.add_argument("--smoke", action="store_true", default=True)
    l.add_argument("--steps", type=int, default=20)
    l.add_argument("--batch", type=int, default=2)
    l.add_argument("--seq", type=int, default=64)
    l.add_argument("--ckpt-dir", default=None)
    l.add_argument("--resume", action="store_true")
    l.add_argument("--fault-at", type=int, default=None)
    l.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    if args.cmd == "lm":
        out = train_lm(args.arch, smoke=args.smoke, steps=args.steps,
                       batch=args.batch, seq=args.seq,
                       ckpt_dir=args.ckpt_dir, resume=args.resume,
                       fault_at=args.fault_at, device=args.device)
        print(f"final loss {out['losses'][-1]:.4f} "
              f"survivors={out['survivors']}")
        return
    out = train_gcn(args.dataset, model=args.model, dataflow=args.dataflow,
                    engine=args.engine, scale=args.scale,
                    n_cores=args.n_cores, input_pipeline=args.input_pipeline,
                    batch_size=args.batch_size, steps=args.steps,
                    lr=args.lr, hidden=args.hidden, feat_dim=args.feat_dim,
                    ckpt_dir=args.ckpt_dir, resume=args.resume,
                    device=args.device)
    print(f"final loss {out['loss_history'][-1]:.4f} "
          f"({out['wall_s']:.1f}s, orders={out['orders']})")


if __name__ == "__main__":
    main()
