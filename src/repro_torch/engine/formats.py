"""The ported formats and the two schedules, registered (port of
:mod:`repro.engine.formats`).

  * **coo** — the flat COO, identity layout; layer =
    :func:`repro_torch.core.gcn.gcn_layer` (per-row sequential segment
    sum).  Serial schedule only: the oracle the other formats match.
  * **ell** — pre-reduced degree-bucketed ELL plans
    (:func:`repro_torch.kernels.edgeplan.build_plan`); layer walks them with
    the ``spmm_ell`` kernel.  Pipelined only; matches coo to fp32 roundoff
    (the merge may reorder additions).
"""
from __future__ import annotations

from repro_torch.core import gcn as _gcn

from .registry import Format, Schedule, register_format, register_schedule


@register_schedule("serial")
class SerialSchedule(Schedule):
    description = ("log2(P) dimension-ordered fold, one wave; every round's "
                   "transfer completes before its MAC work starts")


@register_schedule("pipelined")
class PipelinedSchedule(Schedule):
    description = ("double-buffered fold: feature waves issue their sends "
                   "before any wave's local add consumes a received half")


@register_format("coo")
class CooFormat(Format):
    schedules = ("serial",)
    cache_layouts = False            # identity build: nothing worth caching

    def build_local(self, coo, cfg):
        return coo

    def layer(self, layout, x, w, *, order="coag", activate=True):
        return _gcn.gcn_layer(layout, x, w, order=order, activate=activate)


@register_format("ell")
class EllFormat(Format):
    schedules = ("pipelined",)

    def build_local(self, coo, cfg):
        from repro_torch.kernels import edgeplan
        return edgeplan.build_plan(coo, caps=cfg.caps, merge=cfg.merge)

    def layer(self, layout, x, w, *, order="coag", activate=True):
        return _gcn._layer_ell_impl(layout, x, w, order=order,
                                    activate=activate)
