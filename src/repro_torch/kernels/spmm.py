"""The aggregation kernels' wrappers (port of :mod:`repro.kernels.spmm`):
``spmm_ell`` / ``spmm_ell_t``, the pre-reduced ELL walk and its transpose,
and ``spmm`` / ``spmm_block``, the flat and Block-Message COO walks.

``y[r] = Σ_k vals[r, k] · x[cols[r, k]]`` over the ``[nb, K]`` degree
buckets of an :class:`~repro_torch.kernels.edgeplan.EllTables`.  A CUDA
tensor goes to the hand-written kernel ``csrc/spmm_ell.cu``; a CPU tensor
goes to its plain version :func:`~repro_torch.kernels.ref.spmm_ell_ref`.

The main path walks a whole table set in one launch:
:func:`ell_walk` builds an :class:`EllWalk` descriptor once per table set
(a record per bucket and a work list, longest rows first), and
:func:`spmm_ell_walk` / :func:`spmm_ell_t_walk` write every bucket's rows
into one buffer with one launch.  :func:`spmm_ell` / :func:`spmm_ell_t`
take one bucket and run the same kernel.  Tables are one plan's (``cols``
``[nb, K]``, ``x`` ``[n_src, d]``) or ``P`` stacked sender cores' (``cols``
``[P, nb, K]``, ``x`` ``[P, n_src, d]``): one launch covers every core.
The transpose walk (the training backward, ``dx[c] = Σ_k t_vals[c, k] ·
e[t_cols[c, k]]``) is the same kernel over the plan's column-major ``t_*``
tables; its wrappers count their launches in ``spmm_ell_t.launches``, so a
run can show that its backward went through the kernel.

``spmm`` (flat COO, ``y[r] = Σ_e [rows[e] = r] · vals[e] · x[cols[e]]``)
and ``spmm_block`` (Block-Message tiles, output row ``b·dpc + rows[b,
e]``) launch one kernel, ``csrc/spmm_coo.cu``, over the entries grouped by
output row (:func:`~repro_torch.kernels.ref.row_grouping`): each row adds
its entries in edge order, from 0, with no atomics.  A warp of the kernel
walks a run of consecutive rows holding about 32 rows plus entries, found
in the kernel from the grouping's ``ptr``.  Callers on the hot path pass
the grouping (``perm``, ``ptr``) built on the host once per layout;
without it the wrapper builds it itself, with a sort on the tensors'
device.  A CPU tensor goes to the plain versions
:func:`~repro_torch.kernels.ref.spmm_ref` /
:func:`~repro_torch.kernels.ref.spmm_block_ref`.  Both take one edge list
or the stacked form of P sender cores (one launch for all of them); each
wrapper counts its own launches.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build
from .ref import (block_rows, entries_kept, grouped_walk_ref, row_grouping,
                  spmm_ell_ref)
from .work import kernel_work, walk_work

_SIG_BUCKET = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
    + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
_SIG_WALK = [ctypes.c_void_p] + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int] \
    + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
_SIG_COO = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
    + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]

#: a work item walks at least this many (padded) entries, or one whole row;
#: items of buckets with K >= ITEM_ENTRIES (one row each) are "long"
ITEM_ENTRIES = 256
#: features one block of the kernel walks for a long item (one per thread)
LONG_SLICE = 64
#: features one warp of the kernel walks for a short item (4 per lane)
SHORT_SLICE = 128
#: the kernel's bucket record (``struct Bucket`` in ``csrc/spmm_ell.cu``)
BUCKET_DTYPE = np.dtype({
    "names": ["cols", "vals", "tab_core", "nb", "K", "out_base", "rows"],
    "formats": ["<u8", "<u8", "<i8", "<i4", "<i4", "<i4", "<i4"],
    "offsets": [0, 8, 16, 24, 28, 32, 36], "itemsize": 40})


def _fn(symbol: str, sig, source: str = "spmm_ell"):
    fn = getattr(_build.load(source), symbol)
    if fn.argtypes is None:
        fn.argtypes = sig
        fn.restype = ctypes.c_int
    return fn


# ---------------------------------------------------------------------------
# ELL walks (csrc/spmm_ell.cu).
# ---------------------------------------------------------------------------
def rows_per_item(K: int) -> int:
    """Rows one work item walks: one row when ``K >= ITEM_ENTRIES``, else
    as many whole rows as fill ``ITEM_ENTRIES`` entries (the kernel's
    ``rows_per_item``)."""
    return 1 if K >= ITEM_ENTRIES else ITEM_ENTRIES // max(int(K), 1)


def walk_items(shapes: Sequence[Tuple[int, int]]) -> np.ndarray:
    """The work list of a walk over buckets of ``(nb, K)``: int32 ``[n, 2]``
    rows of (bucket, first row), every bucket's rows cut into items of
    :func:`rows_per_item` rows, buckets in descending K (ties in bucket
    order), rows ascending.  Empty buckets have no items."""
    order = sorted((b for b, (nb, _) in enumerate(shapes) if nb > 0),
                   key=lambda b: -int(shapes[b][1]))
    parts = [np.zeros((0, 2), np.int32)]
    for b in order:
        nb, K = (int(v) for v in shapes[b])
        row0 = np.arange(0, nb, rows_per_item(K))
        parts.append(np.stack([np.full(len(row0), b), row0], 1))
    return np.concatenate(parts).astype(np.int32)


@dataclasses.dataclass(eq=False)
class EllWalk:
    """One table set's walk descriptor (see :func:`ell_walk`).

    ``cols``/``vals`` are the bucket tensors the descriptor points into
    (kept here, so they outlive it), ``items`` the host work list
    (:func:`walk_items`), ``n_long`` how many of them (the first) are long,
    ``total`` the rows of all buckets, ``lead`` ``()`` for one plan or
    ``(P,)`` for stacked cores, and ``desc`` the packed bucket records and
    items on a CUDA device (``None`` for CPU tables, whose walk runs the
    plain version bucket by bucket).
    """

    cols: Tuple[torch.Tensor, ...]
    vals: Tuple[torch.Tensor, ...]
    items: np.ndarray
    n_long: int
    total: int
    lead: Tuple[int, ...]
    desc: Optional[torch.Tensor]

    @property
    def cores(self) -> int:
        return self.lead[0] if self.lead else 1

    def _slices(self, d: int) -> Tuple[int, int]:
        return -(-int(d) // LONG_SLICE), -(-int(d) // SHORT_SLICE)

    def n_units(self, d: int) -> int:
        """Units of the walk's launch at feature width ``d``: a block per
        (long item, core, ``LONG_SLICE`` features), then a warp per (short
        item, core, ``SHORT_SLICE`` features)."""
        n_l, n_s = self._slices(d)
        return self.cores * (self.n_long * n_l
                             + (len(self.items) - self.n_long) * n_s)

    def unit(self, u: int, d: int) -> Tuple[int, int, int, int, int, int]:
        """What unit ``u`` of the launch walks, decoded as the kernel
        decodes it: ``(bucket, row0, row1, core, f0, f1)``."""
        P = self.cores
        n_l, n_s = self._slices(d)
        if u < self.n_long * P * n_l:
            item, rest = divmod(u, P * n_l)
            (core, fs), width = divmod(rest, n_l), LONG_SLICE
        else:
            item, rest = divmod(u - self.n_long * P * n_l, P * n_s)
            item += self.n_long
            (core, fs), width = divmod(rest, n_s), SHORT_SLICE
        bucket, row0 = (int(v) for v in self.items[item])
        nb, K = self.cols[bucket].shape[-2:]
        row1 = min(row0 + rows_per_item(K), int(nb))
        f0 = fs * width
        return bucket, row0, row1, core, f0, min(f0 + width, int(d))


def walk_descriptor(cols: Sequence[torch.Tensor],
                    vals: Sequence[torch.Tensor], items: np.ndarray
                    ) -> np.ndarray:
    """The bytes the walk kernel reads: one :data:`BUCKET_DTYPE` record per
    bucket (the tensors' addresses, the core stride ``nb·K``, ``nb``,
    ``K``, the bucket's first output row, :func:`rows_per_item`), then the
    int32 (bucket, first row) items."""
    shapes = [tuple(int(s) for s in c.shape[-2:]) for c in cols]
    rec = np.zeros(len(shapes), BUCKET_DTYPE)
    rec["cols"] = [c.data_ptr() for c in cols]
    rec["vals"] = [v.data_ptr() for v in vals]
    rec["tab_core"] = [nb * K for nb, K in shapes]
    rec["nb"] = [nb for nb, _ in shapes]
    rec["K"] = [K for _, K in shapes]
    rec["out_base"] = np.cumsum([0] + [nb for nb, _ in shapes])[:-1]
    rec["rows"] = [rows_per_item(K) for _, K in shapes]
    return np.concatenate([
        rec.view(np.uint8),
        np.ascontiguousarray(items, np.int32).view(np.uint8).reshape(-1)])


def ell_walk(cols: Sequence[torch.Tensor], vals: Sequence[torch.Tensor],
             items: Optional[np.ndarray] = None) -> EllWalk:
    """The walk descriptor of one table set (``[nb, K]`` or ``[P, nb, K]``
    buckets, all on one device).  ``items`` is the host work list when it
    was built beside the tables (:func:`walk_items` of their shapes).  For
    CUDA tables the bucket records and the items
    (:func:`walk_descriptor`) go to the card in one copy; build it once per
    table set and keep it beside the tables."""
    cols, vals = tuple(cols), tuple(vals)
    if items is None:
        items = walk_items([tuple(c.shape[-2:]) for c in cols])
    ks = np.array([int(c.shape[-1]) for c in cols] + [0])
    n_long = int((ks[items[:, 0]] >= ITEM_ENTRIES).sum())
    walk = EllWalk(cols=cols, vals=vals, items=items, n_long=n_long,
                   total=sum(int(c.shape[-2]) for c in cols),
                   lead=tuple(cols[0].shape[:-2]) if cols else (), desc=None)
    if cols and cols[0].device.type == "cuda":
        for c, v in zip(cols, vals):
            if c.dtype != torch.int32 or v.dtype != torch.float32 \
                    or v.shape != c.shape or not c.is_contiguous() \
                    or not v.is_contiguous():
                raise ValueError("ell_walk needs contiguous int32 cols and "
                                 "float32 vals of one shape per bucket")
        walk.desc = torch.from_numpy(walk_descriptor(cols, vals, items)).to(
            cols[0].device)
    return walk


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


def _strides(name: str, x: torch.Tensor, out: torch.Tensor):
    """(x core, x row, out core, out row) strides in elements; a 2-D
    tensor has no core stride.  The feature axes must be unit-stride."""
    if x.stride(-1) != 1 or out.stride(-1) != 1:
        raise ValueError(f"{name} needs unit-stride feature axes of x and "
                         "out")
    return (x.stride(0) if x.dim() == 3 else 0, x.stride(-2),
            out.stride(0) if out.dim() == 3 else 0, out.stride(-2))


def _run(name: str, cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor,
         out: Optional[torch.Tensor]) -> Tuple[torch.Tensor, bool]:
    """One bucket: check, then launch the kernel (CUDA) or run the plain
    version (CPU).  Returns the output and whether the kernel was
    launched."""
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
    strides = _strides(name, x, out)
    P = lead[0] if lead else 1
    if P == 0 or nb == 0 or d == 0:
        return out, False
    err = _fn("spmm_ell_launch", _SIG_BUCKET)(
        cols.data_ptr(), vals.data_ptr(), x.data_ptr(), out.data_ptr(), P,
        nb, K, n_src, d, *strides, _build.stream_ptr(x.device))
    _build.check(name, err)
    return out, True


def _check_packing() -> None:
    """Once per process: the kernel's bucket record has BUCKET_DTYPE's
    size."""
    global _packing_checked
    if not _packing_checked:
        size = _fn("spmm_ell_bucket_bytes", [])()
        if size != BUCKET_DTYPE.itemsize:
            raise RuntimeError(f"spmm_ell.cu's Bucket is {size} bytes, the "
                               f"descriptor packs {BUCKET_DTYPE.itemsize}")
        _packing_checked = True


_packing_checked = False


def _bucket_work(cols: torch.Tensor, x: torch.Tensor) -> Tuple[int, int]:
    """Roofline work of one bucket's walk as laid out (int32 column and
    f32 value per stored entry)."""
    return walk_work(cols.numel(), 8, x.shape[-1],
                     cols.numel() // max(cols.shape[-1], 1))


def _walk_work(walk: EllWalk, x: torch.Tensor) -> Tuple[int, int]:
    """Roofline work of a whole table set's walk as laid out."""
    return walk_work(sum(c.numel() for c in walk.cols), 8, x.shape[-1],
                     walk.cores * walk.total)


def _walk(name: str, walk: EllWalk, x: torch.Tensor, out: torch.Tensor
          ) -> bool:
    """A whole walk into ``out`` (``[*lead, walk.total, d]``): one launch
    (CUDA) or the plain version bucket by bucket (CPU).  Returns whether
    the kernel was launched."""
    if not walk.cols:                  # no buckets: no rows to write
        return False
    lead = walk.lead
    if x.shape[:-2] != lead or out.shape != (*lead, walk.total, x.shape[-1]):
        raise ValueError(f"{name}: x {tuple(x.shape)} and out "
                         f"{tuple(out.shape)} do not match a walk of "
                         f"{walk.total} rows over cores {lead}")
    if x.dtype != torch.float32 or out.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 x and out, got {x.dtype}, "
                        f"{out.dtype}")
    if not len(walk.items):
        return False
    if walk.desc is None:
        if x.device.type != "cpu" or out.device.type != "cpu" or \
                walk.cols[0].device.type != "cpu":
            raise ValueError(f"{name}: CPU tables walk CPU tensors only, got "
                             f"x on {x.device}, out on {out.device}")
        base = 0
        for c, v in zip(walk.cols, walk.vals):
            nb = int(c.shape[-2])
            if nb:
                out[..., base:base + nb, :] = spmm_ell_ref(c, v, x)
            base += nb
        return False
    if x.device != walk.desc.device or out.device != x.device:
        raise ValueError(f"{name}: tables on {walk.desc.device}, x on "
                         f"{x.device}, out on {out.device}")
    strides = _strides(name, x, out)
    n_src, d = x.shape[-2:]
    if d == 0:
        return False
    _check_packing()
    err = _fn("spmm_ell_walk_launch", _SIG_WALK)(
        walk.desc.data_ptr(), len(walk.cols), len(walk.items), walk.n_long,
        walk.cores,
        x.data_ptr(), out.data_ptr(), n_src, d, *strides,
        _build.stream_ptr(x.device))
    _build.check(name, err)
    return True


def spmm_ell_walk(walk: EllWalk, x: torch.Tensor, out: torch.Tensor
                  ) -> torch.Tensor:
    """The forward ELL walk over every bucket of a table set in one launch:
    bucket *b*'s rows land in ``out[..., base_b:base_b + nb_b, :]`` (buckets
    back to back, as :func:`ell_walk` orders them).  ``x`` float32
    ``[n_src, d]`` / ``[P, n_src, d]`` (any row and core strides, a zero
    core stride shares one ``x``), ``out`` float32 ``[*lead, walk.total,
    d]`` with a unit-stride feature axis.  Counts in ``spmm_ell.launches``.
    """
    with kernel_work(lambda: _walk_work(walk, x)):
        spmm_ell.launches += _walk("spmm_ell", walk, x, out)
    return out


def spmm_ell_t_walk(walk: EllWalk, e: torch.Tensor, out: torch.Tensor
                    ) -> torch.Tensor:
    """:func:`spmm_ell_walk` over the column-major ``t_*`` tables (the
    transpose walk of the training backward), counted in
    ``spmm_ell_t.launches``."""
    with kernel_work(lambda: _walk_work(walk, e)):
        spmm_ell_t.launches += _walk("spmm_ell_t", walk, e, out)
    return out


def spmm_ell(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor, *,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One bucket of the forward ELL walk: ``[nb, d]`` rows (``[P, nb, d]``
    for stacked cores), written to ``out`` when given (a slice of a larger
    buffer with a unit-stride feature axis).

    ``cols`` int32 ``[nb, K]`` / ``[P, nb, K]`` (padding = ``n_src``),
    ``vals`` float32 of the same shape, ``x`` float32 ``[n_src, d]`` /
    ``[P, n_src, d]`` without a zero row (stacked cores may share one ``x``
    through a zero core stride).
    """
    with kernel_work(lambda: _bucket_work(cols, x)):
        y, launched = _run("spmm_ell", cols, vals, x, out)
    spmm_ell.launches += launched
    return y


def spmm_ell_t(t_cols: torch.Tensor, t_vals: torch.Tensor, e: torch.Tensor,
               *, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One bucket of the transpose walk: ``dx[c] = Σ_k t_vals[c, k] ·
    e[t_cols[c, k]]`` over the plan's column-major tables — the SAME kernel
    as :func:`spmm_ell` (no ``Aᵀ`` table, no scatter), counted on its own
    in ``spmm_ell_t.launches``."""
    with kernel_work(lambda: _bucket_work(t_cols, e)):
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
    want = (*lead, n_out, d)
    if out is not None and (out.shape != want
                            or out.dtype != torch.float32):
        raise ValueError(f"{name}: out must be float32 {list(want)}, got "
                         f"{out.dtype} {tuple(out.shape)}")
    dev = x.get_device()              # -1 on the CPU; one int per tensor
    if any(t.get_device() != dev for t in (perm, ptr, cols, vals)) or (
            out is not None and out.get_device() != dev):
        raise ValueError(f"{name} inputs span devices " + str(
            {t.device for t in (perm, ptr, cols, vals, x, out)
             if t is not None}))
    if x.is_cpu:
        y = grouped_walk_ref(perm, ptr, cols, vals, x)
        return (y if out is None else out.copy_(y)), False
    if not x.is_cuda:
        raise RuntimeError(f"{name} runs on CUDA (kernel) or CPU (plain "
                           f"version) tensors, got {x.device}")
    if not (perm.is_contiguous() and ptr.is_contiguous()
            and cols.is_contiguous() and vals.is_contiguous()):
        raise ValueError(f"{name} needs contiguous perm, ptr, cols and "
                         "vals")
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
    with kernel_work(lambda: walk_work(
            cols.numel(), 12, x.shape[-1],
            int(n_dst) * (cols.shape[0] if cols.dim() == 2 else 1))):
        y, launched = _coo_walk("spmm", rows, cols, vals, x, int(n_dst),
                                perm, ptr, out)
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
    with kernel_work(lambda: walk_work(
            rows.numel(), 12, x.shape[-1],
            rows.numel() // max(eb, 1) * int(dpc))):
        grows = block_rows(rows, dpc) if perm is None \
            else rows.reshape(flat)
        y, launched = _coo_walk("spmm_block", grows, cols.reshape(flat),
                                vals.reshape(flat), x, n_blocks * int(dpc),
                                perm, ptr, out)
    spmm_block.launches += launched
    return y


spmm.launches = 0
spmm_block.launches = 0
