"""The aggregation kernels' wrappers (port of :mod:`repro.kernels.spmm`):
``spmm_ell`` / ``spmm_ell_t``, the pre-reduced ELL walk and its transpose,
and ``spmm`` / ``spmm_block``, the flat and Block-Message COO walks.

``y[r] = Σ_k vals[r, k] · x[cols[r, k]]`` over one ``[nb, K]`` degree
bucket of an :class:`~repro_torch.kernels.edgeplan.EllTables`.  A CUDA
tensor goes to the hand-written kernel ``csrc/spmm_ell.cu``; a CPU tensor
goes to its plain version :func:`~repro_torch.kernels.ref.spmm_ell_ref`.

Both wrappers take one bucket either as it is (``cols`` ``[nb, K]``, ``x``
``[n_src, d]``) or for ``P`` stacked sender cores (``cols`` ``[P, nb, K]``,
``x`` ``[P, n_src, d]``): one launch then walks the bucket for every core.
The transpose walk (the training backward, ``dx[c] = Σ_k t_vals[c, k] ·
e[t_cols[c, k]]``) is the same kernel over the plan's column-major
``t_*`` tables; it has a wrapper and a launch counter of its own, so a run
can show that its backward went through the kernel.

``spmm`` (flat COO, ``y[r] = Σ_e [rows[e] = r] · vals[e] · x[cols[e]]``)
and ``spmm_block`` (Block-Message tiles, output row ``b·dpc + rows[b,
e]``) launch one kernel, ``csrc/spmm_coo.cu``, over the entries grouped by
output row (:func:`~repro_torch.kernels.ref.row_grouping`): each row adds
its entries in edge order, from 0, with no atomics.  Callers on the hot
path pass the grouping (``perm``, ``ptr``) built on the host once per
layout; without it the wrapper builds it itself, with a sort on the
tensors' device.  A CPU tensor goes to the plain versions
:func:`~repro_torch.kernels.ref.spmm_ref` /
:func:`~repro_torch.kernels.ref.spmm_block_ref`.  Both take one edge list
or the stacked form of P sender cores (one launch for all of them); each
wrapper counts its own launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .ref import (block_rows, entries_kept, grouped_walk_ref, row_grouping,
                  spmm_ell_ref)

_SIG_2D = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_SIG_CORES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
    + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
_SIG_COO = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
    + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]


def _fn(symbol: str, sig, source: str = "spmm_ell"):
    fn = getattr(_build.load(source), symbol)
    if fn.argtypes is None:
        fn.argtypes = sig
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, cols: torch.Tensor, vals: torch.Tensor,
           x: torch.Tensor, out: Optional[torch.Tensor]) -> None:
    if cols.dim() not in (2, 3) or vals.shape != cols.shape:
        raise ValueError(f"{name}: cols {tuple(cols.shape)} and vals "
                         f"{tuple(vals.shape)} must be one [nb, K] bucket "
                         "or one [P, nb, K] stacked bucket")
    if x.dim() != cols.dim() or (x.dim() == 3 and x.shape[0] != cols.shape[0]):
        raise ValueError(f"{name}: x {tuple(x.shape)} does not match the "
                         f"bucket {tuple(cols.shape)} ([n_src, d] or "
                         "[P, n_src, d])")
    if cols.dtype != torch.int32 or vals.dtype != torch.float32 \
            or x.dtype != torch.float32:
        raise TypeError(f"{name} takes int32 cols and float32 vals/x, got "
                        f"{cols.dtype}, {vals.dtype}, {x.dtype}")
    devices = {cols.device, vals.device, x.device}
    if out is not None:
        devices.add(out.device)
        want = (*cols.shape[:-1], x.shape[-1])
        if out.shape != want or out.dtype != torch.float32:
            raise ValueError(f"{name}: out must be float32 {list(want)}, got "
                             f"{out.dtype} {tuple(out.shape)}")
    if len(devices) != 1:
        raise ValueError(f"{name} inputs span devices {devices}")


def _run(name: str, cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
         out: Optional[torch.Tensor]) -> Tuple[torch.Tensor, bool]:
    """Check, then launch the kernel (CUDA) or run the plain version (CPU).
    Returns the output and whether the kernel was launched."""
    _check(name, cols, vals, x, out)
    if x.device.type == "cpu":
        y = spmm_ell_ref(cols, vals, x)
        return (y if out is None else out.copy_(y)), False
    if x.device.type != "cuda":
        raise RuntimeError(f"{name} runs on CUDA (kernel) or CPU (plain "
                           f"version) tensors, got {x.device}")
    for arg, t in (("cols", cols), ("vals", vals)):
        if not t.is_contiguous():
            raise ValueError(f"{name} needs a contiguous {arg}")
    *lead, nb, K = cols.shape
    n_src, d = x.shape[-2:]
    if out is None:
        out = torch.empty((*lead, nb, d), dtype=torch.float32,
                          device=x.device)
    if cols.dim() == 2:
        if not x.is_contiguous() or not out.is_contiguous():
            raise ValueError(f"{name} needs a contiguous x and out")
        if nb == 0 or d == 0:
            return out, False
        err = _fn("spmm_ell_launch", _SIG_2D)(
            cols.data_ptr(), vals.data_ptr(), x.data_ptr(), out.data_ptr(),
            nb, K, n_src, d, _build.stream_ptr(x.device))
    else:
        if x.stride(-1) != 1 or out.stride(-1) != 1:
            raise ValueError(f"{name} needs unit-stride feature axes of x "
                             "and out")
        P = cols.shape[0]
        if P == 0 or nb == 0 or d == 0:
            return out, False
        err = _fn("spmm_ell_cores_launch", _SIG_CORES)(
            cols.data_ptr(), vals.data_ptr(), x.data_ptr(), out.data_ptr(),
            P, nb, K, n_src, d, x.stride(0), x.stride(1), out.stride(0),
            out.stride(1), _build.stream_ptr(x.device))
    _build.check(name, err)
    return out, True


def spmm_ell(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor, *,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One bucket of the forward ELL walk: ``[nb, d]`` rows (``[P, nb, d]``
    for stacked cores), written to ``out`` when given (a slice of a larger
    buffer: contiguous for one core, unit-stride features for stacked
    cores).

    ``cols`` int32 ``[nb, K]`` / ``[P, nb, K]`` (padding = ``n_src``),
    ``vals`` float32 of the same shape, ``x`` float32 ``[n_src, d]`` /
    ``[P, n_src, d]`` without a zero row (stacked cores may share one ``x``
    through a zero core stride).
    """
    y, launched = _run("spmm_ell", cols, vals, x, out)
    spmm_ell.launches += launched
    return y


def spmm_ell_t(t_cols: torch.Tensor, t_vals: torch.Tensor, e: torch.Tensor,
               *, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One bucket of the transpose walk: ``dx[c] = Σ_k t_vals[c, k] ·
    e[t_cols[c, k]]`` over the plan's column-major tables — the SAME kernel
    as :func:`spmm_ell` (no ``Aᵀ`` table, no scatter), counted on its own
    in ``spmm_ell_t.launches``."""
    y, launched = _run("spmm_ell_t", t_cols, t_vals, e, out)
    spmm_ell_t.launches += launched
    return y


spmm_ell.launches = 0
spmm_ell_t.launches = 0


# ---------------------------------------------------------------------------
# COO walks: flat edge lists and Block-Message tiles (csrc/spmm_coo.cu).
# ---------------------------------------------------------------------------
def _coo_walk(name: str, rows: torch.Tensor, cols: torch.Tensor,
              vals: torch.Tensor, x: torch.Tensor, n_out: int,
              perm: Optional[torch.Tensor], ptr: Optional[torch.Tensor],
              out: Optional[torch.Tensor]) -> Tuple[torch.Tensor, bool]:
    """The walk over flat entries (``rows`` are the output rows, already
    flattened and globalized for tiles): check, group when no grouping is
    given, then launch the kernel (CUDA) or run the plain version (CPU).
    Returns the output and whether the kernel was launched."""
    if x.dim() not in (2, 3) or rows.dim() != x.dim() - 1 \
            or cols.shape != rows.shape or vals.shape != rows.shape:
        raise ValueError(f"{name}: rows {tuple(rows.shape)}, cols "
                         f"{tuple(cols.shape)}, vals {tuple(vals.shape)} "
                         f"and x {tuple(x.shape)} must be one edge list "
                         "with x [n_src, d], or P stacked lists with x "
                         "[P, n_src, d]")
    if x.dim() == 3 and rows.shape[0] != x.shape[0]:
        raise ValueError(f"{name}: {rows.shape[0]} edge lists for "
                         f"{x.shape[0]} cores of x")
    if cols.dtype != torch.int32 or vals.dtype != torch.float32 \
            or x.dtype != torch.float32:
        raise TypeError(f"{name} takes int32 cols and float32 vals/x, got "
                        f"{cols.dtype}, {vals.dtype}, {x.dtype}")
    *lead, n_ent = cols.shape
    n_src, d = x.shape[-2:]
    if (perm is None) != (ptr is None):
        raise ValueError(f"{name}: pass both perm and ptr, or neither")
    if perm is None:
        perm, ptr = row_grouping(rows, entries_kept(cols, vals, n_src), n_out)
    if perm.shape != cols.shape or ptr.shape != (*lead, n_out + 1) \
            or perm.dtype != torch.int32 or ptr.dtype != torch.int32:
        raise ValueError(f"{name}: the grouping must be int32 perm "
                         f"{tuple(cols.shape)} and ptr "
                         f"{(*lead, n_out + 1)}, got {perm.dtype} "
                         f"{tuple(perm.shape)} and {ptr.dtype} "
                         f"{tuple(ptr.shape)}")
    devices = {t.device for t in (perm, ptr, cols, vals, x)}
    want = (*lead, n_out, d)
    if out is not None:
        devices.add(out.device)
        if out.shape != want or out.dtype != torch.float32:
            raise ValueError(f"{name}: out must be float32 {list(want)}, got "
                             f"{out.dtype} {tuple(out.shape)}")
    if len(devices) != 1:
        raise ValueError(f"{name} inputs span devices {devices}")
    if x.device.type == "cpu":
        y = grouped_walk_ref(perm, ptr, cols, vals, x)
        return (y if out is None else out.copy_(y)), False
    if x.device.type != "cuda":
        raise RuntimeError(f"{name} runs on CUDA (kernel) or CPU (plain "
                           f"version) tensors, got {x.device}")
    for arg, t in (("perm", perm), ("ptr", ptr), ("cols", cols),
                   ("vals", vals)):
        if not t.is_contiguous():
            raise ValueError(f"{name} needs a contiguous {arg}")
    if out is None:
        out = torch.empty(want, dtype=torch.float32, device=x.device)
    if x.stride(-1) != 1 or out.stride(-1) != 1:
        raise ValueError(f"{name} needs unit-stride feature axes of x and "
                         "out")
    P = lead[0] if lead else 1
    if P == 0 or n_out == 0 or d == 0:
        return out, False
    x_core = x.stride(0) if lead else 0
    out_core = out.stride(0) if lead else 0
    err = _fn("spmm_coo_launch", _SIG_COO, "spmm_coo")(
        perm.data_ptr(), ptr.data_ptr(), cols.data_ptr(), vals.data_ptr(),
        x.data_ptr(), out.data_ptr(), P, n_out, n_ent, n_src, d, x_core,
        x.stride(-2), out_core, out.stride(-2), _build.stream_ptr(x.device))
    _build.check(name, err)
    return out, True


def spmm(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
         x: torch.Tensor, n_dst: int, *, perm: Optional[torch.Tensor] = None,
         ptr: Optional[torch.Tensor] = None,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flat COO walk ``y[r] = Σ_e [rows[e] = r] · vals[e] · x[cols[e]]``
    → ``[n_dst, d]``, each row in edge order from 0 (``Aᵀe`` is the same
    call with ``rows`` and ``cols`` swapped).

    ``rows``/``cols`` int32 and ``vals`` float32 ``[e]`` with ``x`` float32
    ``[n_src, d]``, or ``[P, e]`` with ``x`` ``[P, n_src, d]`` (a zero core
    stride shares one ``x``) → ``[P, n_dst, d]``.  Entries with weight 0 or
    a column outside ``[0, n_src)`` add nothing.  ``perm``/``ptr`` are
    :func:`~repro_torch.kernels.ref.row_grouping` of ``rows``; ``out`` (unit
    feature stride) receives the result when given.
    """
    y, launched = _coo_walk("spmm", rows, cols, vals, x, int(n_dst), perm,
                            ptr, out)
    spmm.launches += launched
    return y


def spmm_block(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
               x: torch.Tensor, dpc: int, *,
               perm: Optional[torch.Tensor] = None,
               ptr: Optional[torch.Tensor] = None,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Block-Message walk ``y[b·dpc + r] = Σ vals · x[cols]`` over
    per-destination-block tiles with block-local rows → ``[n_blocks·dpc,
    d]``, each row in tile order from 0.

    ``rows``/``cols`` int32 and ``vals`` float32 ``[n_blocks, eb]`` with
    ``x`` ``[n_src, d]``, or the stacked senders' tiles ``[P, n_blocks,
    eb]`` with ``x`` ``[P, n_src, d]`` → ``[P, n_blocks·dpc, d]``, tile *b*
    of core *p* being the partial rows core *p* sends to core *b*.
    ``perm``/``ptr`` group the flattened tiles' entries by
    :func:`~repro_torch.kernels.ref.block_rows`.
    """
    if rows.dim() not in (2, 3) or cols.shape != rows.shape \
            or vals.shape != rows.shape:
        raise ValueError(f"spmm_block: rows {tuple(rows.shape)}, cols "
                         f"{tuple(cols.shape)} and vals {tuple(vals.shape)}"
                         " must be [n_blocks, eb] or [P, n_blocks, eb] tiles")
    n_blocks, eb = rows.shape[-2:]
    flat = rows.shape[:-2] + (n_blocks * eb,)
    grows = block_rows(rows, dpc) if perm is None else rows.reshape(flat)
    y, launched = _coo_walk("spmm_block", grows, cols.reshape(flat),
                            vals.reshape(flat), x, n_blocks * int(dpc),
                            perm, ptr, out)
    spmm_block.launches += launched
    return y


spmm.launches = 0
spmm_block.launches = 0
