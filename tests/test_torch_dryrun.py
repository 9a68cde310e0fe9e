"""The one-device dry run (``repro_torch.launch.dryrun``) and
``lm_batch_specs``, on the CPU with fake CPU tensors.

* ``lm_batch_specs``' shapes and types are the reference's
  ``ShapeDtypeStruct`` s, frames too;
* for every family's smoke config and each of train, prefill and decode,
  the dry-run helper's (flops, bytes) on fake tensors equal
  ``count_work`` of the same step on real CPU tensors, and its peak
  memory equals the live bytes of the real call's storages
  (``PeakMemory`` on real tensors), so the trace holds what the step
  would hold;
* for llama3.2-1b's smoke config the counted flops lie within 1% of the
  reference's ``analyze_hlo`` of the jitted step on one CPU device, and
  ``model_flops_global`` is the reference's formula;
* (``stablelm-3b × prefill_32k`` at its published config:
  ``test_torch_dryrun_stablelm.py``);
* each kernel wrapper's output function agrees with its plain version's
  shapes and types, and fake CUDA tensors (shapes only, no autograd)
  get those outputs with no launch;
* the CLI writes its records and refuses the pod meshes.

No test here builds a fake CUDA tensor that records autograd (that aborts
a CPU-only build of torch).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import get_smoke as ref_get_smoke  # noqa: E402
from repro.data.tokens import lm_batch_specs as ref_batch_specs  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro.launch.steps import build_step as ref_build_step  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch.configs import (ARCH_NAMES, SHAPES, Shape,  # noqa: E402
                                 get_smoke)
from repro_torch.data import lm_batch_specs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.roofline import count_work  # noqa: E402
from repro_torch.launch.steps import build_step  # noqa: E402

CPU = torch.device("cpu")
SMOKE_SEQ, SMOKE_BATCH = 128, 2      # the SSM families' chunk: 128
HLO_FLOPS_RTOL = 0.01
RECORD_KEYS = {"arch", "shape", "kind", "mesh", "n_chips", "trace_s",
               "hlo_flops_per_device", "hlo_bytes_per_device",
               "collective_wire_bytes_per_device", "memory", "roofline",
               "model_flops_global", "useful_flops_ratio", "fits"}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("enc_frames", [0, 48])
def test_lm_batch_specs_are_the_references(enc_frames):
    cfg = get_smoke("seamless-m4t-medium")
    got = lm_batch_specs(cfg, 3, 40, enc_frames=enc_frames)
    want = ref_batch_specs(ref_get_smoke("seamless-m4t-medium"), 3, 40,
                           enc_frames=enc_frames)
    assert set(got) == set(want)
    for key, spec in want.items():
        assert tuple(got[key].shape) == tuple(spec.shape), key
        assert str(got[key].dtype).split(".")[-1] == str(spec.dtype), key
        assert got[key].device.type == "meta"


def test_value_free_replacements_compute_what_they_replaced():
    """What made the step traceable on fake tensors: the forwards' layer
    flags from host arithmetic (the reference's ``global_flags``), the
    MoE's expert counts and one-hot without reading the ids, ``mha_ref``'s
    live-row test on the host."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf

    for arch in ARCH_NAMES:
        for cfg, want in ((get_config(arch), ref_get_config(arch)),
                          (get_smoke(arch), ref_get_smoke(arch))):
            assert tf.global_layers(cfg) == np.asarray(
                ref_tf.global_flags(want)).tolist(), arch
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 7, (3, 40)))
    assert torch.equal(moe._counts(ids.reshape(-1), 9),
                       torch.bincount(ids.reshape(-1), minlength=9))
    assert torch.equal(moe._one_hot(ids, 9), F.one_hot(ids, 9))
    for sk in (0, 1, 5, 9):
        for window in (None, 1, 3, 8):
            for r0 in range(12):
                for r1 in range(r0 + 1, 14):
                    assert ref._rows_all_live(r0, r1, sk, window) == bool(
                        ref._live_rows(r0, r1, sk, True, window,
                                       CPU).all()), (r0, r1, sk, window)


def _real_inputs(cfg, shape, seed=0):
    """``fake_inputs``' arguments built on real CPU tensors, the token ids
    drawn in the vocab and the frames from a normal."""
    args = dryrun.fake_inputs(cfg, shape, CPU)
    gen = torch.Generator().manual_seed(seed)
    for t in dryrun.tensors_in(args[1:]):
        if t.dtype == torch.int32:
            t.random_(0, cfg.vocab, generator=gen)
        elif shape.kind != "decode":
            t.normal_(generator=gen)
    return args


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_trace_counts_what_the_real_step_counts(arch, kind):
    cfg = get_smoke(arch)
    shape = Shape(f"smoke_{kind}", kind, SMOKE_SEQ, SMOKE_BATCH)
    rec = dryrun.trace_step(cfg, shape, device="cpu")
    args = _real_inputs(cfg, shape)
    step = build_step(cfg, kind)
    assert (rec["hlo_flops_per_device"], rec["hlo_bytes_per_device"]) == \
        count_work(step, *args)
    mem = dryrun.PeakMemory(CPU)
    inputs = dryrun.tensors_in(args)
    mem.hold(inputs)
    with mem:
        out = step(*args)
    assert rec["memory"]["argument_bytes"] == mem.storage_bytes(inputs)
    assert rec["memory"]["peak_bytes"] == mem.peak
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] \
        + rec["memory"]["output_bytes"] > 0
    assert rec["fits"] and rec["kind"] == kind and rec["n_chips"] == 1
    del out


def _ref_args(ref_cfg, kind, seq, batch):
    """The reference's step arguments as ``ShapeDtypeStruct`` s on one
    device (its ``abstract_inputs`` without a mesh)."""
    params = jax.eval_shape(lambda k: ref_lm.init_params(k, ref_cfg),
                            jax.random.PRNGKey(0))
    specs = ref_batch_specs(ref_cfg, batch, seq)
    if kind == "train":
        return params, jax.eval_shape(ref_adamw(1e-4)[0], params), specs
    if kind == "prefill":
        specs.pop("labels")
        return params, specs
    cache = jax.eval_shape(lambda: ref_lm.init_cache(ref_cfg, batch, seq))
    return (params, cache, jax.ShapeDtypeStruct((batch, 1), jnp.int32),
            jax.ShapeDtypeStruct((), jnp.int32))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_flops_match_the_references_hlo(kind):
    arch = "llama3.2-1b"
    cfg, ref_cfg = get_smoke(arch), ref_get_smoke(arch)
    shape = Shape(f"smoke_{kind}", kind, SMOKE_SEQ, SMOKE_BATCH)
    rec = dryrun.trace_step(cfg, shape, device="cpu")
    hlo = jax.jit(ref_build_step(ref_cfg, kind)).lower(
        *_ref_args(ref_cfg, kind, SMOKE_SEQ, SMOKE_BATCH)).compile().as_text()
    want = analyze_hlo(hlo).flops
    got = rec["hlo_flops_per_device"]
    assert abs(got - want) <= HLO_FLOPS_RTOL * want, (got, want)
    tokens = SMOKE_BATCH * (1 if kind == "decode" else SMOKE_SEQ)
    ref_model = 6 * ref_cfg.active_param_count() * tokens
    if kind != "train":
        ref_model = ref_model / 3
    assert rec["model_flops_global"] == ref_model
    assert rec["useful_flops_ratio"] == ref_model / got


def test_output_functions_match_the_plain_versions():
    import importlib

    from repro_torch.kernels import flash, ref

    gemm = importlib.import_module("repro_torch.kernels.gemm")
    spmm = importlib.import_module("repro_torch.kernels.spmm")
    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (2, n, 80)).astype(np.float32)).to(dtype) for n in (5, 7, 7))
        o, lse = ref.mha_ref(q, k, v, causal=False, return_lse=True)
        got_o, got_lse = flash.forward_outputs(q, True)
        assert (got_o.shape, got_o.dtype, got_lse.shape, got_lse.dtype) == (
            o.shape, o.dtype, lse.shape, lse.dtype)
        assert flash.forward_outputs(q, False)[1] is None
        grads = ref.mha_bwd_ref(q, k, v, o, lse, q, causal=False)
        outs = flash.backward_outputs(q, k, v)
        assert [(t.shape, t.dtype) for t in outs[:3]] == [
            (t.shape, t.dtype) for t in grads]
        # the kernels' f32 scratch: two [bh, sq] δ, then [bh, hd] (the
        # dead rows' share of dv)
        assert (outs[3].shape, outs[3].dtype) == (
            (2 * 2 * 5 + 2 * 80,), torch.float32)
    x, w = torch.ones((6, 4)), torch.ones((4, 3))
    want = ref.gemm_ref(x, w)
    got = gemm.gemm_output(x, w)
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    for lead in ((), (3,)):
        cols = torch.zeros((*lead, 5, 2), dtype=torch.int32)
        xs = torch.ones((*lead, 4, 6))
        want = ref.spmm_ell_ref(cols, torch.ones(cols.shape), xs)
        got = spmm.bucket_output(cols, xs)
        assert (got.shape, got.dtype) == (want.shape, want.dtype)
        rows = torch.zeros((*lead, 8), dtype=torch.int32)
        want = ref.spmm_ref(rows, rows, torch.ones(rows.shape), xs, 9)
        got = spmm.coo_output(lead, 9, xs)
        assert (got.shape, got.dtype) == (want.shape, want.dtype)
        tiles = torch.zeros((*lead, 2, 4), dtype=torch.int32)
        want = ref.spmm_block_ref(tiles, tiles, torch.ones(tiles.shape), xs,
                                  3)
        got = spmm.coo_output(lead, 2 * 3, xs)
        assert (got.shape, got.dtype) == (want.shape, want.dtype)


def test_wrappers_on_fake_cuda_tensors_return_shapes_and_launch_nothing():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import (flash_mha, gemm, spmm, spmm_block,
                                     spmm_ell, spmm_ell_t)
    from repro_torch.kernels.spmm import ell_walk, spmm_ell_walk

    wrappers = (flash_mha, gemm, spmm, spmm_block, spmm_ell, spmm_ell_t)
    before = [f.launches for f in wrappers]
    with FakeTensorMode():
        dev = dict(device="cuda")
        x = torch.empty((10, 6), **dev)
        assert tuple(gemm(x, torch.empty((6, 3), **dev)).shape) == (10, 3)
        cols = torch.empty((4, 2), dtype=torch.int32, **dev)
        vals = torch.empty((4, 2), **dev)
        for fn in (spmm_ell, spmm_ell_t):
            y = fn(cols, vals, x)
            assert (tuple(y.shape), y.device.type) == ((4, 6), "cuda")
        walk = ell_walk([cols], [vals])
        out = torch.empty((4, 6), **dev)
        assert spmm_ell_walk(walk, x, out) is out
        rows = torch.empty((12,), dtype=torch.int32, **dev)
        assert tuple(spmm(rows, rows, torch.empty((12,), **dev), x,
                          7).shape) == (7, 6)
        with pytest.raises(ValueError, match="grouping"):   # checks first
            spmm(rows, rows, torch.empty((12,), **dev), x, 7,
                 perm=torch.empty((5,), dtype=torch.int32, **dev),
                 ptr=torch.empty((8,), dtype=torch.int32, **dev))
        with pytest.raises(ValueError, match="contiguous"):
            spmm(rows, torch.empty_strided((12,), (2,), dtype=torch.int32,
                                           **dev),
                 torch.empty((12,), **dev), x, 7)
        tiles = torch.empty((3, 4), dtype=torch.int32, **dev)
        assert tuple(spmm_block(tiles, tiles, torch.empty((3, 4), **dev), x,
                                5).shape) == (15, 6)
        q = torch.empty((2, 64, 80), dtype=torch.bfloat16, **dev)
        assert flash_mha(q, q, q, q_block=1, k_block=1).dtype == \
            torch.bfloat16
        with pytest.raises(TypeError):
            gemm(x.to(torch.bfloat16), torch.empty((6, 3), **dev))
    assert [f.launches for f in wrappers] == before


def test_cli_writes_its_records_and_refuses_the_pod_meshes(tmp_path,
                                                           capsys):
    out = tmp_path / "records.json"
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                 "--device", "cpu", "--out", str(out)])
    records = json.loads(out.read_text())
    assert len(records) == 1 and set(records[0]) >= RECORD_KEYS
    assert (records[0]["arch"], records[0]["shape"]) == ("llama3.2-1b",
                                                         "decode_32k")
    assert "all 1 cells passed" in capsys.readouterr().out
    dryrun.main(["--arch", "stablelm-3b", "--shape", "long_500k",
                 "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text())[0]["skipped"]
    for flag in ("--multi-pod", "--single-pod"):
        with pytest.raises(NotImplementedError, match="10.3"):
            dryrun.main([flag, "--device", "cpu"])
    assert len(SHAPES) == 4


def test_the_pool_starts_the_scanned_families_first():
    """``--jobs N`` starts every ssm / hybrid cell (the longest traces)
    before any other, each family's train before its prefill before the
    rest, and keeps the grid's order within a rank."""
    from repro_torch.configs import all_cells, get_config

    jobs = [(a, s, "cpu") for a, s, ok, _ in all_cells(include_skipped=True)
            if ok]
    order = sorted(jobs, key=dryrun._trace_order)
    scanned = [get_config(a).family in ("ssm", "hybrid") for a, _, _ in order]
    assert scanned == sorted(scanned, reverse=True) and any(scanned)
    kinds = [SHAPES[s].kind for _, s, _ in order[:scanned.count(True)]]
    assert kinds == sorted(kinds, key=["train", "prefill", "decode"].index)
    assert sorted(order) == sorted(jobs)
