"""The port's roofline accounting (:mod:`repro_torch.launch.roofline`, the
counterpart of :mod:`repro.launch.hlo_analysis`) on the CPU.

* ``count_work`` of ``gemm`` is ``2·M·N·K`` flops and its operands' and
  output's bytes, as ``torch.matmul``'s aten count is;
* an ELL walk counts by its stored (padded) entries, a COO walk and a
  Block-Message walk by their entries, each with its gathered rows and
  output rows;
* a kernel's plain version is not descended into (the CPU runs many ops
  for one ``gemm``; one report counts), and a host↔device transfer counts
  nothing;
* ``roofline_terms`` picks the dominant term, mirroring
  ``tests/test_hlo_analysis.py::test_roofline_terms_and_dominance`` with
  the H100 peaks; ``card_peaks`` keeps the rates ``chip_smoke.py`` had
  and now reads from here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.graph import from_edges  # noqa: E402
from repro_torch.kernels import (edgeplan, ell_apply, gemm,  # noqa: E402
                                 spmm, spmm_block, spmm_ell)
from repro_torch.kernels.work import kernel_work, walk_work  # noqa: E402
from repro_torch.launch.roofline import (H100_SXM, Peaks,  # noqa: E402
                                         card_peaks, count_work,
                                         roofline_terms)


@pytest.mark.parametrize("m,k,n,bias", [(8, 5, 3, False), (33, 64, 41, True),
                                        (1, 602, 256, False)])
def test_gemm_counts_2mnk_flops(m, k, n, bias):
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    b = torch.zeros(n) if bias else None
    flops, nbytes = count_work(gemm, x, w, b, relu=True)
    assert flops == 2 * m * n * k
    assert nbytes == 4 * (m * k + k * n + m * n + (n if bias else 0))
    # the same product through aten counts the same
    assert count_work(torch.matmul, x, w) == (2 * m * n * k,
                                              4 * (m * k + k * n + m * n))


def _graph(seed, n_dst=48, n_src=80, e=500):
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, n_dst, e),
                           rng.integers(0, 3, e // 2)])
    cols = rng.integers(0, n_src, len(rows))
    vals = rng.uniform(0.1, 1, len(rows)).astype(np.float32)
    return from_edges(rows, cols, vals, n_dst, n_src), rng


@pytest.mark.parametrize("d", [1, 16, 41])
def test_ell_walk_counts_by_stored_entries(d):
    coo, rng = _graph(d)
    plan = edgeplan.build_plan(coo)
    tables = plan.device_tables("cpu")
    x = torch.from_numpy(rng.standard_normal((coo.n_src, d))
                         .astype(np.float32))
    stored = sum(c.size for c in plan.fwd.cols)
    total = sum(c.shape[0] for c in plan.fwd.cols)
    assert stored > coo.nnz - 1 or stored >= total   # padded entries
    walk_flops, walk_bytes = walk_work(stored, 8, d, total)
    flops, nbytes = count_work(ell_apply, tables, x)
    assert flops == walk_flops == 2 * stored * d
    # the walk, plus ell_apply's own ops: the zero row and the inv_perm
    # placement (index_select reads the buffer and inv, writes the rows)
    buf = (total + 1) * d * 4
    place = buf + coo.n_dst * 8 + coo.n_dst * d * 4
    assert nbytes == walk_bytes + 2 * d * 4 + place
    # one bucket through its wrapper: padded entries of that bucket only
    c, v = tables["cols"][-1], tables["vals"][-1]
    assert count_work(spmm_ell, c, v, x) == walk_work(
        c.numel(), 8, d, c.shape[0])


def test_coo_and_block_walks_count_their_entries():
    coo, rng = _graph(5, n_dst=32, n_src=32)
    d, P = 8, 2
    x = torch.from_numpy(rng.standard_normal((P, 32, d)).astype(np.float32))
    e = coo.nnz // P * P
    rows = coo.rows[:e].view(P, -1)
    cols = coo.cols[:e].view(P, -1).to(torch.int32)
    vals = coo.vals[:e].view(P, -1)
    assert count_work(spmm, rows, cols, vals, x, 32) == walk_work(
        e, 12, d, P * 32)
    tiles = torch.stack([rows % 8, cols, vals], 0)[..., :48].reshape(
        3, P, 4, 12)
    t_rows, t_cols = tiles[0].to(torch.int32), tiles[1].to(torch.int32)
    assert count_work(spmm_block, t_rows, t_cols, tiles[2], x, 8) == \
        walk_work(P * 48, 12, d, P * 4 * 8)


def test_plain_versions_and_transfers_are_not_descended_into():
    x, w = torch.randn(16, 8), torch.randn(8, 4)
    # gemm's plain version on the CPU sums in K order over many ops; the
    # counter sees the wrapper's one report only
    assert count_work(gemm, x, w) == (2 * 16 * 4 * 8,
                                      4 * (16 * 8 + 8 * 4 + 16 * 4))
    # a nested report inside a kernel's scope adds nothing either
    def nested():
        with kernel_work(lambda: (10, 20)):
            with kernel_work(lambda: (1000, 2000)):
                torch.relu(x)
    assert count_work(nested) == (10, 20)
    # no counter active: the work function is never called
    with kernel_work(lambda: 1 / 0):
        pass
    # a copy between devices is a transfer, not device memory traffic;
    # views and allocations move nothing
    assert count_work(lambda: x.to("meta")) == (0, 0)
    assert count_work(lambda: (x.t(), x.view(-1), torch.empty(5))) == (0, 0)
    assert count_work(torch.relu, x) == (0, 2 * x.numel() * 4)


def test_every_format_layer_counts_positive_and_repeatably():
    from repro_torch.engine import planner

    stats = planner.GraphStats(n_dst=100, n_src=300, avg_deg=5.0,
                               feat_dim=24)
    dims = planner._roofline_dims(stats)
    for spec in ("ell+pipelined", "block+pipelined", "coo+serial"):
        fmt, layout, x, w = planner.roofline_layer_inputs(spec, dims)
        first = count_work(fmt.layer, layout, x, w)
        assert first == count_work(fmt.layer, layout, x, w)
        # the combination's 2·n_src·d·d flops are always in the count
        assert first[0] >= 2 * dims[1] * dims[3] ** 2
        assert first[1] > 0


def test_roofline_terms_and_dominance():
    t = roofline_terms(1e15, 1e12, 1e9, 256)
    assert t["dominant"] == "compute"
    t = roofline_terms(1e12, 1e13, 1e9, 256)
    assert t["dominant"] == "memory"
    t = roofline_terms(1e12, 1e9, 1e12, 256)
    assert t["dominant"] == "collective"
    t = roofline_terms(67e12, 3.35e12, 0, 1)
    assert t["t_compute"] == pytest.approx(1.0)
    assert t["t_memory"] == pytest.approx(1.0)
    assert t["t_collective"] == 0.0
    # stacked cores exchange through the card's memory: wire bytes go at
    # the memory rate
    t = roofline_terms(0, 0, 3.35e12, 4)
    assert t["t_collective"] == pytest.approx(1.0)
    pcie = card_peaks("NVIDIA H100 PCIe")
    assert roofline_terms(51e12, 0, 0, 1, peaks=pcie)["t_compute"] == \
        pytest.approx(1.0)


def test_card_peaks_are_chip_smokes():
    assert H100_SXM == Peaks(3.35e12, 67e12, 495e12, 989e12)
    assert card_peaks("NVIDIA H100 80GB HBM3") == H100_SXM
    assert card_peaks("NVIDIA H100 PCIe") == Peaks(2.0e12, 51e12, 378e12,
                                                   756e12)
    assert card_peaks("NVIDIA H100 NVL").bw == 3.9e12
    assert card_peaks("NVIDIA H200").bw == 4.8e12
    import types

    import chip_smoke
    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(
        get_device_name=lambda i: "NVIDIA H100 PCIe"))
    assert chip_smoke.device_peaks(fake) == card_peaks("NVIDIA H100 PCIe")
