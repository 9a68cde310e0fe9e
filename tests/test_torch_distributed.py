"""The training slice's own contracts on the CPU (no reference needed).

* the stacked-core kernel call (``[P, nb, K]`` buckets, one launch for all
  cores) is bit-equal to one 2-D call per core, also with a shared
  zero-stride ``x`` and a strided output slice; ``spmm_ell_t`` is the same
  kernel with its own counter;
* the hypercube fold sums every sender's block exactly once, the
  all-gather returns blocks in core order, the two are each other's
  backward, and any wave count is bit-identical to one wave;
* ``ell`` matches the ``coo`` oracle on stacked cores beyond the
  reference's P (8 cores);
* checkpoints cross between the packages in both directions; the Trainer's
  prefetch and sync pipelines are bit-identical, and a mid-epoch
  checkpoint + resume replays the uninterrupted run bit-exactly;
* entry points default to the card and raise without one; unported parts
  raise ``NotImplementedError`` naming the ROADMAP.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.distributed import aggregate as agg  # noqa: E402
from repro_torch.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.graph import from_edges, make_dataset  # noqa: E402
from repro_torch.kernels import spmm_ell, spmm_ell_t  # noqa: E402
from repro_torch.launch.trainer import Trainer, main  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.topology import allgather, reduce_scatter  # noqa: E402

SMALL = dict(scale=0.004, feat_dim=16, hidden=16, batch_size=32, seed=0,
             device="cpu")


def _bucket(rng, P, nb, K, n_src):
    cols = rng.integers(0, n_src, (P, nb, K)).astype(np.int32)
    vals = rng.standard_normal((P, nb, K)).astype(np.float32)
    cols[:, :, K - 1:] = n_src                  # trailing padding
    vals[:, :, K - 1:] = 0.0
    cols[:, -1, :] = n_src                      # pad-only rows
    vals[:, -1, :] = 0.0
    return torch.from_numpy(cols), torch.from_numpy(vals)


@pytest.mark.parametrize("K,d", [(1, 41), (6, 5), (9, 16)])
def test_stacked_bucket_equals_one_call_per_core(K, d):
    rng = np.random.default_rng(K)
    P, nb, n_src = 4, 7, 13
    cols, vals = _bucket(rng, P, nb, K, n_src)
    x = torch.from_numpy(rng.standard_normal((P, n_src, d))
                         .astype(np.float32))
    got = spmm_ell(cols, vals, x)
    for p in range(P):
        assert torch.equal(got[p], spmm_ell(cols[p], vals[p], x[p]))
    # one x shared by every core through a zero core stride
    shared = x[0].unsqueeze(0).expand(P, n_src, d)
    got = spmm_ell_t(cols, vals, shared)
    for p in range(P):
        assert torch.equal(got[p], spmm_ell(cols[p], vals[p], x[0]))
    # written into a strided slice of a larger buffer
    buf = torch.full((P, nb + 3, d), 9.0)
    spmm_ell(cols, vals, x, out=buf[:, 1:nb + 1])
    assert torch.equal(buf[:, 1:nb + 1], spmm_ell(cols, vals, x))
    assert (buf[:, 0] == 9.0).all() and (buf[:, nb + 1:] == 9.0).all()


def test_wrappers_count_no_launch_on_the_cpu_and_reject_bad_stacks():
    rng = np.random.default_rng(0)
    cols, vals = _bucket(rng, 2, 3, 4, 5)
    x = torch.zeros((2, 5, 3))
    before = (spmm_ell.launches, spmm_ell_t.launches)
    spmm_ell(cols, vals, x)
    spmm_ell_t(cols, vals, x)
    assert (spmm_ell.launches, spmm_ell_t.launches) == before
    with pytest.raises(ValueError):
        spmm_ell(cols, vals, torch.zeros((3, 5, 3)))     # core mismatch
    with pytest.raises(ValueError):
        spmm_ell(cols, vals, torch.zeros((5, 3)))        # 2-D x, 3-D bucket
    with pytest.raises(ValueError):
        spmm_ell_t(cols, vals, x, out=torch.zeros((2, 3, 4)))


def test_spmm_ell_t_never_falls_back_off_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the kernel would launch")
    meta = dict(device="meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        spmm_ell_t(torch.zeros((2, 2, 2), dtype=torch.int32, **meta),
                   torch.zeros((2, 2, 2), **meta),
                   torch.zeros((2, 3, 4), **meta))


@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_fold_sums_each_block_once_and_allgather_keeps_core_order(P):
    # power-of-two sender tags: any lost or doubled block changes the sum
    t, d = 3, 2
    tags = torch.tensor([2.0 ** j for j in range(P)])
    partial = tags.view(P, 1, 1, 1).expand(P, P, t, d).contiguous()
    owned = reduce_scatter("hypercube", P, partial)
    assert torch.equal(owned, torch.full((P, t, d), float(2 ** P - 1)))
    x = torch.arange(P * t * d, dtype=torch.float32).view(P, t, d)
    gathered = allgather("hypercube", P, x)
    assert gathered.shape == (P, P, t, d)
    for p in range(P):
        assert torch.equal(gathered[p], x)


@pytest.mark.parametrize("P", [2, 8])
def test_reduce_scatter_and_allgather_are_mirrors(P):
    rng = np.random.default_rng(P)
    t, d = 2, 3
    partial = torch.from_numpy(rng.standard_normal((P, P, t, d))
                               .astype(np.float32)).requires_grad_(True)
    ct = torch.from_numpy(rng.standard_normal((P, t, d)).astype(np.float32))
    (reduce_scatter("hypercube", P, partial) * ct).sum().backward()
    assert torch.equal(partial.grad, allgather("hypercube", P, ct))
    x = ct.clone().requires_grad_(True)
    ct2 = partial.detach()
    (allgather("hypercube", P, x) * ct2).sum().backward()
    assert torch.equal(x.grad, reduce_scatter("hypercube", P, ct2))
    # a dense oracle for the fold itself
    dense = partial.detach().double().sum(0)
    got = reduce_scatter("hypercube", P, partial.detach())
    assert torch.allclose(got.double(), dense, atol=1e-5)


def _graph(seed=2, n_dst=64, n_src=96, nnz=700):
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, n_dst - 8, nnz), np.full(60, 9)])
    cols = np.concatenate([rng.integers(0, n_src, nnz),
                           rng.integers(0, 24, 60)])
    vals = rng.uniform(0.05, 1.0, len(rows)).astype(np.float32)
    x = rng.standard_normal((n_src, 12)).astype(np.float32)
    g = rng.standard_normal((n_dst, 12)).astype(np.float32)
    return from_edges(rows, cols, vals, n_dst, n_src), x, g


def _agg_and_grad(spec, P, coo, x, g, **cfg):
    bundle = Engine(EngineConfig.from_spec(spec, **cfg)).build(
        n_cores=P, device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bundle.aggregate(xt, graph=coo)
    (y * torch.from_numpy(g)).sum().backward()
    return y.detach(), xt.grad


@pytest.mark.parametrize("n_chunks", [2, 3, 5])
def test_wave_count_is_bit_identical(n_chunks):
    coo, x, g = _graph()
    y1, dx1 = _agg_and_grad("ell+pipelined", 4, coo, x, g, n_chunks=1)
    yk, dxk = _agg_and_grad("ell+pipelined", 4, coo, x, g,
                            n_chunks=n_chunks)
    assert torch.equal(y1, yk) and torch.equal(dx1, dxk)


def test_ell_matches_coo_oracle_on_eight_cores():
    coo, x, g = _graph(seed=5)
    y_ell, dx_ell = _agg_and_grad("ell+pipelined", 8, coo, x, g)
    y_coo, dx_coo = _agg_and_grad("coo+serial", 8, coo, x, g)
    dense = coo.todense().double()
    assert (y_ell.double() - dense @ torch.from_numpy(x).double()).abs() \
        .max() <= 1e-5
    assert (y_ell - y_coo).abs().max() <= 1e-5
    assert (dx_ell - dx_coo).abs().max() <= 1e-5
    assert (dx_ell.double() - dense.T @ torch.from_numpy(g).double()).abs() \
        .max() <= 1e-5


def test_shards_for_another_core_count_fail_loudly():
    coo, x, _ = _graph()
    for spec in ("ell+pipelined", "coo+serial"):
        leaves, n_dst, _ = Engine(spec).format.shard(coo, 2, Engine(spec)
                                                     .config)
        bundle = Engine(spec).build(n_cores=4, device="cpu")
        dev = bundle.format.to_device(leaves, bundle.device)
        with pytest.raises(ValueError, match="sender cores"):
            bundle._aggregate(n_dst, dev, torch.zeros((4, 24, 3)))


def test_checkpoints_cross_between_packages(tmp_path):
    from repro.checkpoint import CheckpointManager as RefManager

    params = init_params(3, [(5, 4), (4, 2)], device="cpu")
    extra = {"step": 2, "pipeline": {"seed": 0, "epoch": 1, "batch_idx": 4}}
    CheckpointManager(str(tmp_path / "a")).save(2, params, extra=extra)
    like = [{"w": np.zeros((5, 4), np.float32)},
            {"w": np.zeros((4, 2), np.float32)}]
    tree, got_extra, step = RefManager(str(tmp_path / "a")).restore_latest(
        like)
    assert step == 2 and got_extra == extra
    for a, b in zip(tree, params):
        np.testing.assert_array_equal(np.asarray(a["w"]), b["w"].numpy())
    RefManager(str(tmp_path / "b")).save(7, like, extra={"step": 7})
    mgr = CheckpointManager(str(tmp_path / "b"))
    tree, got_extra, step = mgr.restore_latest(params)
    assert step == 7 and got_extra == {"step": 7}
    assert all(isinstance(p["w"], torch.Tensor) and not p["w"].any()
               for p in tree)


def test_async_saves_land_in_order_and_retain(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    params = init_params(0, [(3, 2)], device="cpu")
    for step in range(4):
        mgr.save_async(step, [{"w": params[0]["w"] + step}])
    mgr.wait()
    assert mgr.all_steps() == [2, 3]
    tree, _, step = mgr.restore_latest(params)
    assert step == 3 and torch.equal(tree[0]["w"], params[0]["w"] + 3)
    assert CheckpointManager(str(tmp_path / "none")).restore_latest(
        params) is None
    assert not (tmp_path / "none").exists()      # reading creates nothing


def test_serving_loader_reads_trainer_checkpoints(tmp_path):
    """The serving slice's ``load_checkpoint_params`` reads what the
    Trainer's ``CheckpointManager`` wrote, and both refuse a leaf whose
    file disagrees with the manifest."""
    import json

    from repro_torch.serving import load_checkpoint_params

    params = init_params(4, [(6, 5), (5, 3)], device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, params)
    mgr.save(4, params[::-1], extra={"step": 4})
    loaded = load_checkpoint_params(str(tmp_path))
    assert [p["w"].shape for p in loaded] == [(5, 3), (6, 5)]
    for got, want in zip(loaded, params[::-1]):
        np.testing.assert_array_equal(got["w"], want["w"].numpy())
    manifest = tmp_path / "step_00000004" / "manifest.json"
    meta = json.loads(manifest.read_text())
    meta["leaves"]["0/w"]["shape"] = [3, 5]
    manifest.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="manifest says"):
        load_checkpoint_params(str(tmp_path))
    with pytest.raises(ValueError, match="manifest says"):
        mgr.restore_latest(params)


def test_init_params_scale_and_seed():
    a = init_params(5, [(400, 64), (64, 8)], device="cpu")
    b = init_params(5, [(400, 64), (64, 8)], device="cpu")
    assert all(torch.equal(p["w"], q["w"]) for p, q in zip(a, b))
    assert abs(float(a[0]["w"].std()) * 400 ** 0.5 - 1.0) < 0.05
    assert a[0]["w"].dtype == torch.float32


def test_prefetch_and_sync_streams_are_bit_identical():
    a = Trainer("ell+pipelined", "reddit", n_cores=2,
                input_pipeline="prefetch", **SMALL)
    b = Trainer("ell+pipelined", "reddit", n_cores=2, input_pipeline="sync",
                **SMALL)
    la, lb = a.train_steps(4), b.train_steps(4)
    a.close()
    b.close()
    assert la == lb and np.all(np.isfinite(la))
    assert a.stall_per_step > 0 and b.stall_per_step > 0
    assert 0.0 <= a.evaluate() <= 1.0


@pytest.mark.parametrize("spec", ["ell+pipelined", "coo+serial"])
def test_mid_epoch_checkpoint_resume_is_bit_exact(tmp_path, spec):
    full = Trainer(spec, "reddit", n_cores=4, **SMALL)
    want = full.train_steps(8)
    want_state = full.fetcher.state()
    full.close()
    part = Trainer(spec, "reddit", n_cores=4, ckpt_dir=str(tmp_path),
                   ckpt_every=0, **SMALL)
    part.train_steps(3)          # batches 4-5 are in flight in the queue
    part.save(sync=True)
    part.close()
    resumed = Trainer(spec, "reddit", n_cores=4, ckpt_dir=str(tmp_path),
                      **SMALL)
    assert resumed.resume() and resumed.global_step == 3
    got = resumed.train_steps(5)
    assert got == want[3:]
    assert resumed.fetcher.state() == want_state
    resumed.close()


def test_fit_resumes_to_the_same_horizon(tmp_path):
    ref = Trainer("ell+pipelined", "reddit", n_cores=2, **SMALL).fit(
        2, steps_per_epoch=3)
    first = Trainer("ell+pipelined", "reddit", n_cores=2,
                    ckpt_dir=str(tmp_path), **SMALL)
    first.fit(1, steps_per_epoch=3)
    again = Trainer("ell+pipelined", "reddit", n_cores=2,
                    ckpt_dir=str(tmp_path), **SMALL)
    out = again.fit(2, steps_per_epoch=3, resume=True)
    assert out["global_step"] == 6
    assert out["loss_history"] == ref["loss_history"][3:]
    assert len(ref["val_acc"]) == 2 and ref["device"] == "cpu"


def test_cli_checkpoint_restart(capsys):
    main(["--device", "cpu", "--spec", "ell+pipelined", "--n-cores", "2",
          "--steps", "6", "--dataset", "reddit", "--scale", "0.004",
          "--feat-dim", "16", "--hidden", "16", "--batch-size", "32",
          "--ckpt-restart"])
    assert "batch-exact" in capsys.readouterr().out


def test_training_entry_points_default_to_cuda_and_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine("ell+pipelined").build(n_cores=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer("ell+pipelined", "reddit", scale=0.004, feat_dim=4,
                batch_size=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(0, [(2, 2)])


def test_unported_training_parts_raise_not_implemented():
    for topo in ("ring", "allpairs", "torus2d"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Engine(f"ell+pipelined+{topo}").build(n_cores=2, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine("ell+pipelined+hypercube+mincom").build(n_cores=2,
                                                       device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer("auto", "reddit", **SMALL)
    # the Block-Message format is ported: its bundle builds
    assert Engine("block+pipelined").build(n_cores=2,
                                           device="cpu").spec == \
        "block+pipelined"
    with pytest.raises(ValueError, match="power-of-two"):
        Engine("ell+pipelined").build(n_cores=3, device="cpu")
    for kw in ({"feature_store": "mmap"}, {"cache_capacity": 8}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Trainer("ell+pipelined", "reddit", **SMALL, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        coo, _, _ = _graph()
        agg.shard_edges_ell(coo, 2, merge="redundancy")
