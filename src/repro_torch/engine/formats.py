"""The three formats and two schedules, registered (port of
:mod:`repro.engine.formats`).

  * **coo** — the flat COO, identity layout; layer =
    :func:`repro_torch.core.gcn.gcn_layer` (per-row sequential segment
    sum); distributed: :func:`~repro_torch.distributed.aggregate.
    shard_edges` + :func:`hypercube_aggregate` (the flat ``spmm`` kernel
    over the host-grouped edge lists).  Serial schedule only: the oracle
    the other formats match.
  * **block** — Block-Message tiles
    (:func:`repro_torch.core.blockmsg.block_layout`); layer walks them with
    the ``spmm_block`` kernel, backward with the flat ``spmm`` kernel;
    distributed: :func:`shard_edges_blocked` +
    :func:`hypercube_aggregate_pipelined`.  Pipelined only, and fp32
    bit-equal to coo: every row adds its terms in the same order.
  * **ell** — pre-reduced degree-bucketed ELL plans
    (:func:`repro_torch.kernels.edgeplan.build_plan`); layer walks them with
    the ``spmm_ell`` kernel; distributed: :func:`shard_edges_ell` +
    :func:`hypercube_aggregate_ell` (backward through ``spmm_ell_t``).
    Pipelined only; matches coo to fp32 roundoff (the merge may reorder
    additions).
"""
from __future__ import annotations

from repro_torch.core import gcn as _gcn
from repro_torch.distributed import aggregate as _agg

from .registry import Format, Schedule, register_format, register_schedule


@register_schedule("serial")
class SerialSchedule(Schedule):
    description = ("log2(P) dimension-ordered fold, one wave; every round's "
                   "transfer completes before its MAC work starts")


@register_schedule("pipelined")
class PipelinedSchedule(Schedule):
    description = ("double-buffered fold: feature waves issue their sends "
                   "before any wave's local add consumes a received half")

    def resolve_n_chunks(self, n_chunks):
        # The reference takes 2 waves on accelerators, where a second
        # wave's wire time hides under the first wave's MAC work.  Stacked
        # cores share one device and one stream: the exchange is an
        # on-device index permutation with no wire to hide, so a second
        # wave only adds slices and launches.  One wave, as the reference
        # takes on the CPU; every result is the same for any wave count.
        return 1 if n_chunks is None else int(n_chunks)


@register_format("coo")
class CooFormat(Format):
    schedules = ("serial",)
    traceable = True                 # the layout IS the COO
    cache_layouts = False            # identity build: nothing worth caching

    def build_local(self, coo, cfg):
        return coo

    def layer(self, layout, x, w, *, order="coag", activate=True):
        return _gcn.gcn_layer(layout, x, w, order=order, activate=activate)

    def shard(self, coo, n_cores, cfg):
        es = _agg.shard_edges(coo, n_cores)
        return _agg.shard_leaves(es), es.n_dst, es.n_src

    def device_aggregate(self, n_cores, n_dst, leaves, x, n_chunks,
                         topology="hypercube", layout=None):
        _check_cores(leaves["rows"].shape[0], n_cores, layout)
        return _agg.hypercube_aggregate(n_dst, leaves["rows"],
                                        leaves["cols"], leaves["vals"], x,
                                        topology=topology, groups=leaves,
                                        layout=layout)


@register_format("block")
class BlockFormat(Format):
    schedules = ("pipelined",)

    def build_local(self, coo, cfg):
        from repro_torch.core.blockmsg import block_layout
        return block_layout(coo, cfg.block_tiles)

    def layer(self, layout, x, w, *, order="coag", activate=True):
        return _gcn._layer_blocked_impl(layout, x, w, order=order,
                                        activate=activate)

    def shard(self, coo, n_cores, cfg):
        eb = _agg.shard_edges_blocked(coo, n_cores)
        return _agg.block_leaves(eb), eb.n_dst, eb.n_src

    def device_aggregate(self, n_cores, n_dst, leaves, x, n_chunks,
                         topology="hypercube", layout=None):
        _check_cores(leaves["rows"].shape[0], n_cores, layout)
        return _agg.hypercube_aggregate_pipelined(
            n_dst, leaves["rows"], leaves["cols"], leaves["vals"], x,
            n_chunks, topology=topology, groups=leaves, layout=layout)


@register_format("ell")
class EllFormat(Format):
    schedules = ("pipelined",)

    def build_local(self, coo, cfg):
        from repro_torch.kernels import edgeplan
        return edgeplan.build_plan(coo, caps=cfg.caps, merge=cfg.merge)

    def layer(self, layout, x, w, *, order="coag", activate=True):
        return _gcn._layer_ell_impl(layout, x, w, order=order,
                                    activate=activate)

    int64_leaves = ("inv", "t_inv", "vv_inv", "vvt_inv")

    def shard(self, coo, n_cores, cfg):
        ee = _agg.shard_edges_ell(coo, n_cores, caps=cfg.caps,
                                  merge=cfg.merge)
        return {**ee.tables, **ee.items}, ee.n_dst, ee.n_src

    def to_device(self, leaves, device, layout=None):
        """The tables on ``device`` plus each table set's walk descriptor
        (``walk``, ``t_walk``, and ``vv_walk`` / ``vvt_walk`` for a
        redundancy tier), built from the host work lists (``items``, …) in
        one small copy each.  With a ``layout``, this rank's senders only
        (the work lists name buckets, not cores)."""
        from repro_torch.kernels.edgeplan import WALK_PREFIXES
        from repro_torch.kernels.spmm import ell_walk

        leaves = dict(leaves)
        items = {p: leaves.pop(p + "items", None) for p in WALK_PREFIXES}
        out = super().to_device(leaves, device, layout)
        for p in WALK_PREFIXES:
            if p + "cols" in out:
                out[p + "walk"] = ell_walk(out[p + "cols"], out[p + "vals"],
                                           items[p])
        return out

    def device_aggregate(self, n_cores, n_dst, leaves, x, n_chunks,
                         topology="hypercube", layout=None):
        _check_cores(leaves["inv"].shape[0], n_cores, layout)
        return _agg.hypercube_aggregate_ell(n_dst, leaves, x, n_chunks,
                                            topology=topology, layout=layout)


def _check_cores(lead: int, n_cores: int, layout=None) -> None:
    """Fail loudly when a batch was sharded for another core count (or,
    across ranks, placed for another rank count)."""
    want = n_cores if layout is None else layout.count
    if lead != want:
        raise ValueError(
            f"edge tables hold {lead} sender cores but the bundle has "
            f"{want} here; rebuild the batch with this bundle's shard_batch")
