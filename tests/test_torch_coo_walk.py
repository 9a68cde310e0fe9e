"""The COO walk's run rule and ``chip_smoke.py``'s kernel-only clock, on
the CPU.

* Every warp of the COO walk kernel (``csrc/spmm_coo.cu``) finds its own
  run of rows from the row grouping's ``ptr``: warp ``k`` owns the rows
  whose diagonal ``r + ptr[r]`` lies in ``[32k, 32k + 32)``.  A copy of
  the kernel's 32-way search (``find_run``) below decodes that rule; on a
  real P = 4 training batch (forward and transpose groupings), a serving
  ``dst_tiles`` layer and a layout with a hub row, the warps cover every
  (core, row) exactly once and the feature tiles every feature once.  The
  card tests (``tests/test_torch_gpu.py``) hold the kernel itself.
* The search finds what ``np.searchsorted`` finds.
* ``chip_smoke.queued_ms`` / ``kernel_ms``, on a stub card: the time per
  call is one event pair over ``REPS`` calls queued behind a spin, the
  spin is lengthened when the card caught up with the host, and the run
  fails when the wrapper's launch count is not ``REPS`` × its launches
  per call or the host never gets ahead; ``device_records`` sums and
  counts the named CUDA records of a profile.
"""
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import GraphBatchPipeline  # noqa: E402
from repro_torch.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.graph import (NeighborSampler, from_edges,  # noqa: E402
                               make_dataset)
from repro_torch.serving import InferenceEngine  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

KERNEL_TILE = 256          # features one warp walks (kTile in the kernel)
BUDGET = 32                # rows plus entries a warp's range spans (kBudget)


def warps_per_core(n_out: int, n_ent: int) -> int:
    """Warps the kernel's grid gives each core: ``n_out`` rows and all
    ``n_ent`` entries at ``BUDGET`` each."""
    return -(-(int(n_out) + int(n_ent)) // BUDGET)


def first_row(ptr: np.ndarray, t: int):
    """``(r, ptr[r])`` for the smallest ``r`` with ``r + ptr[r] >= t``
    (``r = len(ptr) - 1`` if none), found as the kernel's ``find_run``
    finds it: each round, 32 probes at the ends of 32 equal parts of the
    range pick the part that holds it, and the probe at that part's end
    gives ``ptr`` at the answer."""
    n = len(ptr) - 1
    lo, hi, at_hi = 0, n, int(ptr[n])
    while lo < hi:
        step = -(-(hi - lo) // 32)
        probes = [min(lo + (i + 1) * step - 1, hi - 1) for i in range(32)]
        hits = [q + int(ptr[q]) >= t for q in probes]
        if not any(hits):
            lo = hi
        else:
            j = hits.index(True)
            at_hi = int(ptr[probes[j]])
            lo, hi = lo + j * step, probes[j]
    return lo, at_hi


def warp_rows(ptr: np.ndarray, k: int):
    """The rows ``[r0, r1)`` that warp ``k`` of one core owns; ``r0 >=
    r1`` means none (its range is past the core's rows, or inside a longer
    row that an earlier warp walks)."""
    lo = k * BUDGET
    return first_row(ptr, lo)[0], first_row(ptr, lo + BUDGET)[0]


def _training_groupings(P=4):
    """The deepest hop's tile groupings of a real training batch: the
    forward ``ptr`` (partial rows) and the transpose ``t_ptr`` (source
    slots), each ``[P, n_out + 1]``, with the entry count per core."""
    ds = make_dataset("reddit", scale=0.004, feat_dim=8)
    sampler = NeighborSampler(ds.graph, (10, 25), pad_multiple=P, seed=0)
    bundle = Engine("block+pipelined").build(n_cores=P, device="cpu")
    t = bundle.commit_batch(bundle.prepare_batch(
        *next(GraphBatchPipeline(ds, sampler, 64))))["edges"][-1]
    n_ent = t["perm"].shape[-1]
    return {"train": (t["ptr"].numpy(), n_ent),
            "train_t": (t["t_ptr"].numpy(), n_ent)}


def _serving_grouping():
    """The layer-1 ``dst_tiles`` grouping of an 8-node query."""
    rng = np.random.default_rng(0)
    ds = make_dataset("flickr", scale=0.004, feat_dim=8)
    params = [{"w": (rng.standard_normal((8, 8)) * 0.2).astype(np.float32)},
              {"w": (rng.standard_normal((8, 5)) * 0.2).astype(np.float32)}]
    eng = InferenceEngine(
        Engine(EngineConfig.from_spec("block+pipelined", block_tiles=4)),
        ds.graph, ds.features, params=params, device="cpu")
    q = np.unique(rng.integers(0, ds.graph.n_nodes, 8))
    coo2, f2 = eng.canonical_layer(q)
    coo1, _ = eng.canonical_layer(f2)
    tab = eng.engine.layout(coo1).device_tables("cpu")
    return tab["ptr"].numpy()[None], tab["perm"].shape[-1]


def _hub_grouping():
    """One 5000-entry row between short rows and a run of 700 empty rows
    (longer than a warp's budget)."""
    rng = np.random.default_rng(1)
    n_dst, n_src = 1200, 6000
    rows = np.concatenate([np.full(5000, 3),
                           rng.integers(0, 400, 800),
                           rng.integers(1100, n_dst, 300)])
    cols = rng.integers(0, n_src, len(rows))
    vals = rng.uniform(0.05, 1.0, len(rows)).astype(np.float32)
    from repro_torch.kernels.ref import entries_kept, row_grouping

    coo = from_edges(rows, cols, vals, n_dst, n_src)
    r, c, v = (torch.from_numpy(np.asarray(a)) for a in
               (coo.rows, coo.cols, coo.vals))
    _, ptr = row_grouping(r, entries_kept(c, v, n_src), n_dst)
    assert int((ptr[1:] - ptr[:-1]).max()) == 5000
    return ptr.numpy()[None], len(rows)


@pytest.fixture(scope="module")
def groupings():
    out = _training_groupings()
    out["serving"] = _serving_grouping()
    out["hub"] = _hub_grouping()
    return out


@pytest.mark.parametrize("d", [41, 256, 602])
@pytest.mark.parametrize("name", ["train", "train_t", "serving", "hub"])
def test_warps_cover_every_row_and_feature_once(groupings, name, d):
    ptr, n_ent = groupings[name]
    P, n_out = ptr.shape[0], ptr.shape[1] - 1
    tiles = -(-d // KERNEL_TILE)
    cover = np.zeros((P, n_out, d), np.int32)
    busy = 0
    for core in range(P):
        diag = np.arange(n_out) + ptr[core, :n_out]
        for k in range(warps_per_core(n_out, n_ent)):
            r0, r1 = warp_rows(ptr[core], k)
            if r0 >= r1:
                continue
            busy += 1
            # the warp's rows start inside its budget window
            assert k * BUDGET <= diag[r0] and diag[r1 - 1] < (k + 1) * BUDGET
            for y in range(tiles):
                f0 = y * KERNEL_TILE
                cover[core, r0:r1, f0:min(f0 + KERNEL_TILE, d)] += 1
    assert n_out > 0 and busy > 0 and (cover == 1).all()


def test_warp_search_finds_what_searchsorted_finds():
    rng = np.random.default_rng(2)
    for n in (1, 2, 31, 32, 33, 1023, 1024, 1025, 40000):
        ptr = np.concatenate([[0], np.cumsum(rng.integers(0, 5, n))])
        diag = np.arange(n) + ptr[:n]
        for t in [0, 1, int(diag[-1]), int(diag[-1]) + 1,
                  *rng.integers(0, diag[-1] + 2, 20)]:
            r, e = first_row(ptr, int(t))
            assert r == np.searchsorted(diag, t, side="left")
            assert e == ptr[r]          # the run's first entry, unloaded


def test_warps_inside_a_hub_or_past_the_entries_own_nothing():
    ptr = np.array([0, 0, 3, 3, 130, 130], np.int64)   # row 3: 127 entries
    assert warps_per_core(5, 130) == 5    # diagonal 0 .. 134
    runs = [warp_rows(ptr, k) for k in range(6)]
    assert runs[0] == (0, 4)            # rows 0-3 start in [0, 32)
    assert runs[1] == runs[2] == runs[3] == (4, 4)   # inside row 3
    assert runs[4] == (4, 5)            # row 4 starts at diagonal 134
    assert runs[5] == (5, 5)            # past every row and entry


class _Event:
    """A CUDA event of the stub card: ``query`` says whether the card had
    passed it when it is asked, ``elapsed_time`` reads the stub's clock."""

    def __init__(self, card):
        self.card = card

    def record(self):
        self.at = len(self.card.log)
        self.card.log.append("event")

    def query(self):
        return self.card.caught_up.pop(0)

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return self.card.ms_per_call * self.card.log[self.at:end.at].count(
            "call")


def _stub_torch(caught_up, ms_per_call=0.25):
    """A ``torch`` whose card runs each call in ``ms_per_call``;
    ``caught_up[i]`` is whether spin ``i`` had ended when the host queued
    its last call."""
    card = types.SimpleNamespace(log=[], spins=[], caught_up=list(caught_up),
                                 ms_per_call=ms_per_call)
    cuda = types.SimpleNamespace(
        synchronize=lambda: None, _sleep=card.spins.append,
        Event=lambda enable_timing: _Event(card))
    return types.SimpleNamespace(cuda=cuda), card


def _wrapper(card, per_call):
    """A wrapper of the port: each call launches ``per_call`` kernels and
    counts them in ``launches``."""
    def wrapper():
        card.log.append("call")
        wrapper.launches += per_call
    wrapper.launches = 0
    return wrapper


def test_kernel_ms_times_reps_queued_calls_and_counts_launches():
    torch_, card = _stub_torch([False])
    wrapper = _wrapper(card, 2)
    ms, count = chip_smoke.kernel_ms(torch_, wrapper, wrapper, launches=2)
    assert ms == pytest.approx(0.25) and count == 2 * chip_smoke.REPS
    assert card.spins == [chip_smoke.SPIN_CYCLES_PER_MS]     # one 1 ms spin
    assert card.log.count("call") == 3 + chip_smoke.REPS     # 3 warm-ups


@pytest.mark.parametrize("per_call", [0, 2])
def test_kernel_ms_raises_when_the_count_is_not_the_launches(per_call):
    torch_, card = _stub_torch([False])
    wrapper = _wrapper(card, per_call)
    with pytest.raises(AssertionError,
                       match=f"launched wrapper {per_call * chip_smoke.REPS}"
                             f" times, expected {chip_smoke.REPS}"):
        chip_smoke.kernel_ms(torch_, wrapper, wrapper)


def test_queued_ms_lengthens_the_spin_until_the_host_gets_ahead():
    torch_, card = _stub_torch([True, False], ms_per_call=0.5)
    ms, count = chip_smoke.queued_ms(torch_, _wrapper(card, 1))
    assert ms == pytest.approx(0.5) and count is None
    assert len(card.spins) == 2 and card.spins[1] > card.spins[0]


def test_queued_ms_raises_when_the_card_always_catches_up():
    torch_, card = _stub_torch([True] * chip_smoke.SPIN_TRIES)
    with pytest.raises(AssertionError, match="synchronizes"):
        chip_smoke.queued_ms(torch_, _wrapper(card, 1))
    assert len(card.spins) == chip_smoke.SPIN_TRIES


def _event(key, device, us, count):
    return types.SimpleNamespace(key=key, device_type=device,
                                 self_device_time_total=us, count=count)


def test_device_records_sum_and_count_the_named_cuda_records():
    from torch.autograd import DeviceType

    events = [
        _event("void (anonymous namespace)::flash_mha_kernel<float>(...)",
               DeviceType.CUDA, 3000.0, 15),
        _event("flash_mha_kernel<__nv_bfloat16>", DeviceType.CUDA, 1000.0, 1),
        _event("flash_mha_host_range", DeviceType.CPU, 9e6, 16),
        _event("ProfilerStep*", DeviceType.CUDA, 8e6, 1),   # the step range
        _event("gemm_kernel", DeviceType.CUDA, 50.0, 20)]
    assert chip_smoke.device_records(events, "flash_mha_kernel") == (
        pytest.approx(4.0), 16)
    assert chip_smoke.device_records(events) == (pytest.approx(4.05), 36)
    assert chip_smoke.device_records(events, "spmm_coo_kernel") == (0.0, 0)
