"""Port vs reference: the Block-Message slice (``block+pipelined``) and the
flat COO walk at small sizes.

* ``block_tiles`` / ``dst_tiles`` / ``shard_edges_blocked`` arrays equal
  the reference's at P = 2 and 4;
* the plain versions ``spmm_ref`` / ``spmm_block_ref`` (what the kernel
  wrappers run on the CPU) are within 1e-5 of the reference's Pallas
  ``spmm`` / ``spmm_block``, run interpreted, including the swapped-roles
  transpose and padding that gathers nothing;
* the block layer's forward (≤1e-5) and gradients (2e-3 rtol/atol, the
  reference's gradient tolerance) match ``Engine("block+pipelined").layer``
  in CoAg and AgCo;
* inside the port, block is bit-equal to coo: the distributed aggregate at
  P = 1, 2, 4 (forward and gradient) and the layer on a (row, col)-ordered
  COO, where both add every row's terms in the same order;
* ``InferenceEngine("block+pipelined")`` logits are within 1e-5 of the
  reference's, ``torch.equal`` the port's coo, and incremental reuse is
  off; a Trainer checkpoint + resume on block is bit-exact;
* the walk's own contracts: the row grouping, the stacked form (one call
  for P cores, a shared zero-stride ``x``, strided slices), edge cases, and
  the repaired ``coo`` stacked walk, which gives the CPU bits of the
  ``index_add_`` it replaces.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serving as ref_serving  # noqa: E402
from repro.core import blockmsg as ref_blockmsg  # noqa: E402
from repro.distributed import aggregate as ref_agg  # noqa: E402
from repro.engine import Engine as RefEngine  # noqa: E402
from repro.graph import from_edges as ref_from_edges  # noqa: E402
from repro.graph import make_dataset as ref_make_dataset  # noqa: E402
from repro.graph.partition import block_partition as ref_partition  # noqa
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch import serving as port_serving  # noqa: E402
from repro_torch.core import blockmsg  # noqa: E402
from repro_torch.distributed import aggregate as agg  # noqa: E402
from repro_torch.engine import Engine  # noqa: E402
from repro_torch.graph import from_edges, make_dataset  # noqa: E402
from repro_torch.graph.partition import block_partition  # noqa: E402
from repro_torch.kernels import (ops, row_grouping, spmm,  # noqa: E402
                                 spmm_block, spmm_block_ref, spmm_ref)
from repro_torch.launch.trainer import Trainer, main  # noqa: E402

TOL = 1e-5
SMALL = dict(scale=0.004, feat_dim=16, hidden=16, batch_size=32, seed=0,
             device="cpu")


def _graph(seed=7, n_dst=48, n_src=64, nnz=420, sort=False):
    """A rectangular COO with duplicate edges, a hub row, empty rows and
    zero-weight padding (optionally in (row, col) order), plus ``x`` and a
    cotangent ``g``."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, n_dst - 6, nnz),
                           np.full(40, 5), np.zeros(8, np.int64)])
    cols = np.concatenate([rng.integers(0, n_src - 4, nnz),
                           rng.integers(0, n_src, 40), np.zeros(8, np.int64)])
    vals = np.concatenate([rng.uniform(0.05, 1.0, nnz + 40),
                           np.zeros(8)]).astype(np.float32)
    if sort:
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
    x = rng.standard_normal((n_src, 8)).astype(np.float32)
    g = rng.standard_normal((n_dst, 8)).astype(np.float32)
    return (rows, cols, vals, n_dst, n_src), x, g


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# host-side layout: array-equal
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("P", [2, 4])
def test_tiles_and_shards_array_equal(P):
    args, _, _ = _graph()
    ref_coo, coo = ref_from_edges(*args), from_edges(*args)
    rb, pb = ref_partition(ref_coo, P), block_partition(coo, P)
    pairs = [(ref_blockmsg.dst_tiles(rb), blockmsg.dst_tiles(pb))]
    pairs += [(ref_blockmsg.block_tiles(rb, j), blockmsg.block_tiles(pb, j))
              for j in range(P)]
    for want, got in pairs:
        assert (got.dst_per_core, got.src_per_core, got.n_blocks,
                got.e_per_block) == (want.dst_per_core, want.src_per_core,
                                     want.n_blocks, want.e_per_block)
        for a in ("rows", "cols", "vals"):
            assert getattr(got, a).dtype == getattr(want, a).dtype
            np.testing.assert_array_equal(getattr(got, a), getattr(want, a))
    re_, pe = (ref_agg.shard_edges_blocked(ref_coo, P),
               agg.shard_edges_blocked(coo, P))
    for a in ("rows_local", "cols_local", "vals"):
        np.testing.assert_array_equal(getattr(pe, a), getattr(re_, a))
    assert (pe.n_dst, pe.n_src, pe.n_cores) == (re_.n_dst, re_.n_src,
                                                re_.n_cores)


# ---------------------------------------------------------------------------
# plain versions vs the interpreted Pallas kernels
# ---------------------------------------------------------------------------
def _coo_case(seed, n_dst, n_src, e, d, n_pad=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_dst, e).astype(np.int32)
    cols = rng.integers(0, n_src, e).astype(np.int32)
    vals = rng.standard_normal(e).astype(np.float32)
    if n_pad:                     # padding past the source range, weight 1:
        cols[-n_pad:] = n_src     # it must gather nothing
        vals[-n_pad:] = 1.0
    x = rng.standard_normal((n_src, d)).astype(np.float32)
    return rows, cols, vals, x


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("n_pad", [0, 5])
def test_spmm_matches_interpreted_pallas(transpose, n_pad):
    n_dst, n_src = 24, 40
    rows, cols, vals, x = _coo_case(3 + n_pad, n_dst, n_src, 300, 16, n_pad)
    if transpose:                  # Aᵀe: the same call, roles swapped
        if n_pad:
            rows[-n_pad:] = n_dst  # padding past the error rows
        e = np.random.default_rng(9).standard_normal((n_dst, 16)).astype(
            np.float32)
        args = (cols, rows, vals, e, n_src)
    else:
        args = (rows, cols, vals, x, n_dst)
    want = np.asarray(ref_ops.spmm(*(jnp.asarray(a) for a in args[:4]),
                                   args[4]))
    tensors = [_t(a) for a in args[:4]]
    for got in (spmm_ref(*tensors, args[4]), spmm(*tensors, args[4]),
                ops.spmm(*tensors, args[4])):
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= TOL


@pytest.mark.parametrize("n_tiles", [2, 4])
def test_spmm_block_matches_interpreted_pallas(n_tiles):
    args, x, _ = _graph(seed=n_tiles)
    tiles = blockmsg.dst_tiles(block_partition(from_edges(*args), n_tiles))
    want = np.asarray(ref_ops.spmm_block(
        jnp.asarray(tiles.rows), jnp.asarray(tiles.cols),
        jnp.asarray(tiles.vals), jnp.asarray(x), tiles.dst_per_core))
    tensors = [_t(tiles.rows), _t(tiles.cols), _t(tiles.vals), _t(x)]
    dpc = tiles.dst_per_core
    for got in (spmm_block_ref(*tensors, dpc), spmm_block(*tensors, dpc),
                ops.spmm_block(*tensors, dpc)):
        assert got.shape == want.shape == (args[3], x.shape[1])
        assert np.abs(got.numpy() - want).max() <= TOL


# ---------------------------------------------------------------------------
# the block layer against the reference's, and block == coo in the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("order", ["coag", "agco"])
def test_block_layer_forward_and_grads_match_reference(order):
    args, x, _ = _graph(seed=3)
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((8, 6)) * 0.3).astype(np.float32)
    g = rng.standard_normal((args[3], 6)).astype(np.float32)
    ref_coo = ref_from_edges(*args)
    for activate in (True, False):
        def ref_loss(xv, wv):
            y = RefEngine("block+pipelined").layer(
                ref_coo, xv, wv, order=order, activate=activate)
            return jnp.sum(y * g), y

        (_, want), (want_dx, want_dw) = jax.value_and_grad(
            ref_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                                     jnp.asarray(w))
        xt = _t(x).requires_grad_(True)
        wt = _t(w).requires_grad_(True)
        got = Engine("block+pipelined").layer(
            from_edges(*args), xt, wt, order=order, activate=activate,
            device="cpu")
        (got * _t(g)).sum().backward()
        assert np.abs(got.detach().numpy() - np.asarray(want)).max() <= TOL
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_dw),
                                   rtol=2e-3, atol=2e-3)


def _agg_and_grad(spec, P, coo, x, g):
    bundle = Engine(spec).build(n_cores=P, device="cpu")
    xt = _t(x).requires_grad_(True)
    y = bundle.aggregate(xt, graph=coo)
    (y * _t(g)).sum().backward()
    return y.detach(), xt.grad


@pytest.mark.parametrize("P", [1, 2, 4])
def test_block_is_bit_equal_to_coo(P):
    args, x, g = _graph(seed=P)
    coo = from_edges(*args)
    y_blk, dx_blk = _agg_and_grad("block+pipelined", P, coo, x, g)
    y_coo, dx_coo = _agg_and_grad("coo+serial", P, coo, x, g)
    assert torch.equal(y_blk, y_coo) and torch.equal(dx_blk, dx_coo)
    dense = coo.todense().double()
    assert (y_blk.double() - dense @ _t(x).double()).abs().max() <= TOL
    # the layer: coo adds each row's edges in edge order, block in (row,
    # col) order, so a (row, col)-ordered COO (serving's canonical form)
    # makes them the same sums
    sargs, sx, _ = _graph(seed=P, sort=True)
    scoo = from_edges(*sargs)
    w = _t(np.random.default_rng(P).standard_normal((8, 5))
           .astype(np.float32))
    for order in ("coag", "agco"):
        a = Engine("block+pipelined").layer(scoo, _t(sx), w, order=order,
                                            device="cpu")
        b = Engine("coo+serial").layer(scoo, _t(sx), w, order=order,
                                       device="cpu")
        assert torch.equal(a, b), order


def test_block_shards_for_another_core_count_fail_loudly():
    args, _, _ = _graph()
    coo = from_edges(*args)
    eng = Engine("block+pipelined")
    leaves, n_dst, _ = eng.format.shard(coo, 2, eng.config)
    bundle = eng.build(n_cores=4, device="cpu")
    dev = bundle.format.to_device(leaves, bundle.device)
    with pytest.raises(ValueError, match="sender cores"):
        bundle._aggregate(n_dst, dev, torch.zeros((4, 16, 3)))
    with pytest.raises(ValueError, match="tile count"):
        agg.hypercube_aggregate_pipelined(
            n_dst, dev["rows"][:, :1].contiguous(),
            dev["cols"][:, :1].contiguous(), dev["vals"][:, :1].contiguous(),
            torch.zeros((2, 32, 3)))


# ---------------------------------------------------------------------------
# serving and training on block
# ---------------------------------------------------------------------------
def _params(seed=0, feat=8, hidden=8, n_classes=5):
    rng = np.random.default_rng(seed)
    return [
        {"w": (rng.standard_normal((feat, hidden)) * 0.2).astype(np.float32)},
        {"w": (rng.standard_normal((hidden, n_classes)) * 0.2)
         .astype(np.float32)},
    ]


def test_inference_engine_block_matches_reference_and_coo():
    params = _params()
    rds = ref_make_dataset("flickr", scale=0.004, feat_dim=8)
    pds = make_dataset("flickr", scale=0.004, feat_dim=8)
    ref = ref_serving.InferenceEngine("block+pipelined", rds.graph,
                                      rds.features, params=params)
    blk = port_serving.InferenceEngine("block+pipelined", pds.graph,
                                       pds.features, params=params,
                                       device="cpu")
    coo = port_serving.InferenceEngine("coo+serial", pds.graph, pds.features,
                                       params=params, device="cpu")
    assert not blk.incremental_supported and not ref.incremental_supported
    assert coo.incremental_supported
    rng = np.random.default_rng(1)
    for rnd in range(3):
        q = rng.integers(0, pds.graph.n_nodes, 8)
        want = ref.query(q)
        got = blk.query(q)
        assert got.shape == want.shape == (8, 5)
        assert np.abs(got - want).max() <= TOL, f"round {rnd}"
        assert torch.equal(torch.from_numpy(got),
                           torch.from_numpy(coo.query(q)))
        add = [(int(rng.integers(pds.graph.n_nodes)), int(q[0]))]
        for eng in (ref, blk, coo):
            eng.update_edges(add=add)
    assert blk.rows_from_cache == 0 and blk.stats()[
        "incremental_supported"] is False


def test_block_trainer_checkpoint_resume_is_bit_exact(tmp_path):
    full = Trainer("block+pipelined", "reddit", n_cores=4, **SMALL)
    want = full.train_steps(7)
    full.close()
    part = Trainer("block+pipelined", "reddit", n_cores=4,
                   ckpt_dir=str(tmp_path), ckpt_every=0, **SMALL)
    part.train_steps(3)          # batches 4-5 are in flight in the queue
    part.save(sync=True)
    part.close()
    resumed = Trainer("block+pipelined", "reddit", n_cores=4,
                      ckpt_dir=str(tmp_path), **SMALL)
    assert resumed.resume() and resumed.global_step == 3
    got = resumed.train_steps(4)
    resumed.close()
    assert got == want[3:] and np.all(np.isfinite(want))


def test_block_trainer_losses_equal_coo():
    a = Trainer("block+pipelined", "reddit", n_cores=2, **SMALL)
    b = Trainer("coo+serial", "reddit", n_cores=2, **SMALL)
    la, lb = a.train_steps(3), b.train_steps(3)
    a.close()
    b.close()
    assert la == lb


def test_cli_trains_block(capsys):
    main(["--device", "cpu", "--spec", "block+pipelined", "--n-cores", "2",
          "--steps", "4", "--dataset", "reddit", "--scale", "0.004",
          "--feat-dim", "16", "--hidden", "16", "--batch-size", "32",
          "--ckpt-restart"])
    out = capsys.readouterr().out
    assert "batch-exact" in out and "spec=block+pipelined" in out


# ---------------------------------------------------------------------------
# the walk's own contracts
# ---------------------------------------------------------------------------
def test_row_grouping_is_stable_and_drops_what_adds_nothing():
    keys = _t(np.array([[2, 0, 2, 1, 0, 5, 2], [1, 1, 0, 0, 3, 3, 3]],
                       np.int64))
    keep = _t(np.array([[1, 1, 1, 0, 1, 1, 1], [1, 1, 1, 1, 1, 1, 0]],
                       bool))
    perm, ptr = row_grouping(keys, keep, 4)
    assert perm.dtype == ptr.dtype == torch.int32
    # core 0: row 0 ← entries 1, 4; row 1 ← none (3 dropped); row 2 ← 0,
    # 2, 6; key 5 is out of range: dropped with entry 3, after the rows
    assert ptr[0].tolist() == [0, 2, 2, 5, 5]
    assert perm[0, :5].tolist() == [1, 4, 0, 2, 6]
    assert sorted(perm[0, 5:].tolist()) == [3, 5]
    assert ptr[1].tolist() == [0, 2, 4, 4, 6]
    assert perm[1, :6].tolist() == [2, 3, 0, 1, 4, 5]


@pytest.mark.parametrize("d", [1, 5, 33])
def test_stacked_walks_equal_one_call_per_core(d):
    rng = np.random.default_rng(d)
    P, B, eb, dpc, n_src = 4, 4, 9, 3, 11
    rows = rng.integers(0, dpc, (P, B, eb)).astype(np.int32)
    cols = rng.integers(0, n_src, (P, B, eb)).astype(np.int32)
    vals = rng.standard_normal((P, B, eb)).astype(np.float32)
    vals[:, :, -3:] = 0.0                       # tile padding
    vals[1, 2] = 0.0                            # an empty tile
    cols[2, 0, 0] = n_src                       # padding past the range
    r, c, v = _t(rows), _t(cols), _t(vals)
    x = _t(rng.standard_normal((P, n_src, d)).astype(np.float32))
    got = spmm_block(r, c, v, x, dpc)
    assert got.shape == (P, B * dpc, d)
    for p in range(P):
        assert torch.equal(got[p], spmm_block(r[p], c[p], v[p], x[p], dpc))
    assert not got[1, 2 * dpc:3 * dpc].any()
    # a feature-wave slice of a wider x, and a strided output slice
    wide = _t(rng.standard_normal((P, n_src, d + 4)).astype(np.float32))
    buf = torch.full((P, B * dpc, d + 2), 7.0)
    spmm_block(r, c, v, wide[..., 2:2 + d], dpc, out=buf[..., 1:1 + d])
    assert torch.equal(buf[..., 1:1 + d],
                       spmm_block(r, c, v, wide[..., 2:2 + d].contiguous(),
                                  dpc))
    assert (buf[..., 0] == 7.0).all() and (buf[..., -1] == 7.0).all()
    # the flat walk, transposed over one error shared by every core
    e = _t(rng.standard_normal((B * dpc, d)).astype(np.float32))
    flat_rows = (rows + np.arange(B)[:, None] * dpc).reshape(P, -1)
    fr, fc, fv = _t(flat_rows.astype(np.int32)), c.reshape(P, -1), \
        v.reshape(P, -1)
    got = spmm(fc, fr, fv, e.unsqueeze(0).expand(P, B * dpc, d), n_src)
    for p in range(P):
        assert torch.equal(got[p], spmm(fc[p], fr[p], fv[p], e, n_src))


@pytest.mark.parametrize("eb", [1, 6])
def test_walk_edge_cases_against_dense(eb):
    rng = np.random.default_rng(eb)
    B, dpc, n_src, d = 3, 4, 7, 2
    rows = rng.integers(0, dpc, (B, eb)).astype(np.int32)
    cols = rng.integers(0, n_src, (B, eb)).astype(np.int32)
    vals = rng.standard_normal((B, eb)).astype(np.float32)
    vals[0] = 0.0                               # an all-padding tile
    x = rng.standard_normal((n_src, d)).astype(np.float32)
    dense = np.zeros((B * dpc, n_src))
    for b in range(B):
        for k in range(eb):
            dense[b * dpc + rows[b, k], cols[b, k]] += vals[b, k]
    got = spmm_block(_t(rows), _t(cols), _t(vals), _t(x), dpc)
    assert np.abs(got.numpy() - dense @ x).max() <= TOL
    assert not got[:dpc].any()
    empty = spmm(torch.zeros(0, dtype=torch.int32),
                 torch.zeros(0, dtype=torch.int32), torch.zeros(0), _t(x), 5)
    assert empty.shape == (5, d) and not empty.any()


def test_repaired_coo_walk_gives_the_index_add_bits():
    """The coo stacked walk now runs the flat spmm (plain version on the
    CPU); its CPU result is what the one index_add_ it replaces gave."""
    args, x, _ = _graph(seed=11)
    P = 4
    es = agg.shard_edges(from_edges(*args), P)
    rows, cols, vals = _t(es.rows_global), _t(es.cols_local), _t(es.vals)
    xs = _t(x).view(P, -1, x.shape[1])
    spc = xs.shape[1]
    core = torch.arange(P).view(P, 1)
    old = torch.zeros((P * es.n_dst, x.shape[1])).index_add_(
        0, (rows.long() + core * es.n_dst).view(-1),
        xs.reshape(P * spc, -1)[(cols.long() + core * spc).view(-1)]
        * vals.reshape(-1, 1)).view(P, es.n_dst, -1)
    leaves = {k: _t(v) for k, v in agg.shard_leaves(es).items()}
    new = spmm(rows, cols, vals, xs, es.n_dst, perm=leaves["perm"],
               ptr=leaves["ptr"])
    assert torch.equal(new, old)
    assert torch.equal(new, spmm(rows, cols, vals, xs, es.n_dst))


def test_wrappers_count_no_launch_on_the_cpu_and_never_fall_back():
    from repro_torch.kernels import _build

    before = (spmm.launches, spmm_block.launches)
    rows, cols, vals, x = _coo_case(0, 6, 8, 20, 3)
    spmm(_t(rows), _t(cols), _t(vals), _t(x), 6)
    spmm_block(_t(rows).view(2, 10) % 3, _t(cols).view(2, 10),
               _t(vals).view(2, 10), _t(x), 3)
    assert (spmm.launches, spmm_block.launches) == before
    with pytest.raises(ValueError):
        spmm(_t(rows), _t(cols), _t(vals), _t(x)[None], 6)   # 1 list, P x
    with pytest.raises(TypeError):
        spmm(_t(rows), _t(cols).long(), _t(vals), _t(x), 6)
    with pytest.raises(ValueError, match="perm and ptr"):
        spmm(_t(rows), _t(cols), _t(vals), _t(x), 6,
             perm=torch.zeros(20, dtype=torch.int32))
    if torch.cuda.is_available():
        return                     # the kernel would launch
    meta = dict(device="meta")
    # spmm: 4 entries into 2 rows; spmm_block: 2 tiles of 2 into 2 × 2 rows
    for fn, lead, n_ptr in ((spmm, (4,), 3), (spmm_block, (2, 2), 5)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(torch.zeros(lead, dtype=torch.int32, **meta),
               torch.zeros(lead, dtype=torch.int32, **meta),
               torch.zeros(lead, **meta), torch.zeros((3, 4), **meta), 2,
               perm=torch.zeros((4,), dtype=torch.int32, **meta),
               ptr=torch.zeros((n_ptr,), dtype=torch.int32, **meta))
    with pytest.raises(RuntimeError, match="CUDA"):
        _build.load("spmm_coo")


def test_block_entry_points_default_to_cuda_and_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    args, x, _ = _graph()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine("block+pipelined").layer(from_edges(*args), _t(x),
                                        torch.ones((8, 2)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine("block+pipelined").build(n_cores=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer("block+pipelined", "reddit", scale=0.004, feat_dim=4,
                batch_size=8)
    ds = make_dataset("flickr", scale=0.004, feat_dim=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_serving.InferenceEngine(
            "block+pipelined", ds.graph, ds.features,
            params=[{"w": np.ones((4, 2), np.float32)}])
    spmm_mod = importlib.import_module("repro_torch.kernels.spmm")
    assert spmm_mod.spmm is spmm and spmm_mod.spmm_block is spmm_block


def test_block_tiles_config_and_layout_cache():
    from repro_torch.engine import EngineConfig

    with pytest.raises(ValueError, match="block_tiles"):
        EngineConfig.from_spec("block+pipelined", block_tiles=0)
    args, x, _ = _graph(sort=True)
    coo = from_edges(*args)
    layouts = {n: Engine(EngineConfig.from_spec(
        "block+pipelined", block_tiles=n)).layout(coo) for n in (2, 4)}
    assert [layouts[n].tiles.n_blocks for n in (2, 4)] == [2, 4]
    w = _t(np.eye(8, 3, dtype=np.float32))
    a, b = (Engine(EngineConfig.from_spec("block+pipelined", block_tiles=n))
            .layer(coo, _t(x), w, device="cpu") for n in (2, 4))
    assert torch.equal(a, b)     # the tiling never changes a row's sum


def test_coo_walk_source_is_built_for_hopper_without_atomics():
    from repro_torch.kernels import _build

    src = (_build.CSRC / "spmm_coo.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert "atomic" not in code
    assert "__fadd_rn" in code and "__fmul_rn" in code
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
