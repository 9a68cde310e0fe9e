"""Plain PyTorch versions of the port's CUDA kernels, and the COO walks'
row grouping.

Each ``*_ref`` function computes what its kernel computes, in the kernel's
order of accumulation (``mha_ref``: the same math without the online
state), with ordinary tensor operations.  The kernel wrappers
(:mod:`.spmm`, :mod:`.gemm`, :mod:`.flash`) run these for CPU tensors, the CPU
tests hold them against the JAX reference, and ``chip_smoke.py`` holds the
kernels against them on the card; no CUDA path calls them.
:func:`row_grouping` (with :func:`walk_groupings` / :func:`tile_groupings`)
is the one input the COO walk kernel and its plain version share: the
layouts build it on the host, once per graph or batch.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def spmm_ell_ref(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor
                 ) -> torch.Tensor:
    """``y[r] = Σ_k vals[r, k] · x[cols[r, k]]`` over one ``[nb, K]`` bucket
    (or, for ``P`` stacked cores, ``cols``/``vals`` ``[P, nb, K]`` and ``x``
    ``[P, n_src, d]``, core ``p`` reading ``x[p]``).

    The K-unrolled gather-multiply-add of the reference's XLA twin
    (``repro.kernels.ops._ell_walk``): the accumulator starts at the k = 0
    product and adds the later products in ascending k, each product and
    each sum rounded on its own.  Padding entries (column ``n_src``, or any
    column outside ``[0, n_src)``) read an appended zero row, so they add
    exact zeros and touch no real row.
    """
    n_src, d = x.shape[-2:]
    *lead, nb, K = cols.shape
    if nb == 0 or (lead and lead[0] == 0):
        return x.new_zeros((*lead, nb, d))
    idx = cols.long()
    pad = (idx < 0) | (idx >= n_src)
    if lead:                     # stacked cores: one flat source space
        P = lead[0]
        xz = torch.cat([x.reshape(P * n_src, d), x.new_zeros((1, d))])
        idx = idx + (torch.arange(P, device=idx.device) * n_src).view(P, 1, 1)
        idx = torch.where(pad, P * n_src, idx)
    else:
        xz = torch.cat([x, x.new_zeros((1, d))], dim=0)
        idx = torch.where(pad, n_src, idx)
    acc = xz[idx[..., 0]] * vals[..., 0:1]
    for k in range(1, K):
        acc = acc + xz[idx[..., k]] * vals[..., k:k + 1]
    return acc


def row_grouping(keys: torch.Tensor, keep: torch.Tensor, n_out: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stable grouping of a COO's entries by output row, per core.

    ``keys`` (int, ``[E]`` or ``[P, E]``) names each entry's output row and
    ``keep`` (bool, same shape) which entries count; an entry whose key is
    outside ``[0, n_out)`` does not count either.  Returns ``perm`` (int32,
    the shape of ``keys``) and ``ptr`` (int32, ``[n_out + 1]`` or ``[P,
    n_out + 1]``) on ``keys``' device: row *r*'s entries are
    ``perm[ptr[r]:ptr[r + 1]]``, in their order in ``keys``; the entries
    that do not count follow the last row.  The order is what the walks add
    in, so it carries every bit-exactness contract of the COO walks.

    Computed on the host with numpy's stable sort (a radix sort while the
    row count fits 16 bits); the layouts call it there, once per graph or
    batch, so no step sorts on the device.
    """
    squeeze = keys.dim() == 1
    k = keys.reshape(1, -1) if squeeze else keys
    k = k.cpu().numpy().astype(np.int64)
    P, E = k.shape
    kept = keep.reshape(P, E).cpu().numpy() & (k >= 0) & (k < n_out)
    g = np.where(kept, k, n_out).astype(
        np.uint16 if n_out < (1 << 16) else np.int64)
    perm = np.argsort(g, axis=1, kind="stable").astype(np.int32)
    counts = np.bincount((g + np.arange(P).reshape(P, 1) * (n_out + 1))
                         .reshape(-1), minlength=P * (n_out + 1))
    ptr = np.zeros((P, n_out + 1), np.int32)
    np.cumsum(counts.reshape(P, n_out + 1)[:, :n_out], axis=1, out=ptr[:, 1:])
    perm, ptr = (torch.from_numpy(a).to(keys.device) for a in (perm, ptr))
    return (perm[0], ptr[0]) if squeeze else (perm, ptr)


def entries_kept(cols: torch.Tensor, vals: torch.Tensor,
                 n_src: int) -> torch.Tensor:
    """The entries a COO walk adds: weight nonzero and column inside
    ``[0, n_src)``.  Padding (weight 0, or a column routed past the source
    range) adds nothing and gathers nothing."""
    return (vals != 0) & (cols >= 0) & (cols < n_src)


def grouped_walk_ref(perm: torch.Tensor, ptr: torch.Tensor,
                     cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor
                     ) -> torch.Tensor:
    """``y[r] = Σ vals[e] · x[cols[e]]`` over ``e`` in
    ``perm[ptr[r]:ptr[r + 1]]``, added in that order from 0, each product
    and each sum rounded on its own — the arithmetic of the COO walk kernel
    (``csrc/spmm_coo.cu``).

    ``perm``/``cols``/``vals`` are ``[E]`` with ``x`` ``[n_src, d]``, or
    ``[P, E]`` with ``x`` ``[P, n_src, d]`` (core *p* reads ``x[p]``; a zero
    core stride shares one ``x``).  Entries whose column is outside
    ``[0, n_src)`` add nothing.  On the CPU one ``index_add_`` adds the
    products in grouping order (it adds its rows one after another); on
    other devices ``index_add_`` adds concurrently, so step *k* adds the
    *k*-th entry of every row that has one, over distinct rows.
    """
    squeeze = perm.dim() == 1
    n_src, d = x.shape[-2:]
    n_out = ptr.shape[-1] - 1
    perm = (perm.unsqueeze(0) if squeeze else perm).long()
    ptr = ptr.reshape(perm.shape[0], n_out + 1).long()
    P, E = perm.shape
    cols = cols.reshape(P, E)
    vals = vals.reshape(P, E)
    if x.dim() == 2 or x.stride(0) == 0:        # one x for every core
        xs, x_off = (x if x.dim() == 2 else x[0]), 0
    else:
        xs, x_off = x.reshape(P * n_src, d), n_src
    out = x.new_zeros((P * n_out, d))
    counts = (ptr[:, 1:] - ptr[:, :-1]).reshape(-1)
    total = int(counts.sum())
    if total and d:
        dev = perm.device
        core = torch.arange(P, device=dev).view(P, 1)
        listed = torch.arange(E, device=dev).view(1, E) < ptr[:, -1:]
        ent = (perm + core * E)[listed]              # core-major, k order
        orow = torch.repeat_interleave(torch.arange(P * n_out, device=dev),
                                       counts)
        c = cols.reshape(-1)[ent].long()
        real = (c >= 0) & (c < n_src)
        rows = orow[real]
        prod = xs[(c + (ent // E) * x_off)[real]] \
            * vals.reshape(-1)[ent][real][:, None]
        if dev.type == "cpu":
            out.index_add_(0, rows, prod)
        else:
            first = torch.cumsum(counts, 0) - counts
            slot = torch.arange(total, device=dev)[real] - first[rows]
            by = torch.sort(slot, stable=True)
            rows, prod = rows[by.indices], prod[by.indices]
            off = 0
            for cnt in torch.bincount(by.values).tolist():
                out.index_add_(0, rows[off:off + cnt], prod[off:off + cnt])
                off += cnt
    return out.view(n_out, d) if squeeze else out.view(P, n_out, d)


def spmm_ref(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor, n_dst: int, perm: Optional[torch.Tensor] = None,
             ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flat COO ``y[r] = Σ_e [rows[e] = r] · vals[e] · x[cols[e]]`` →
    ``[n_dst, d]``: every row sums its entries in edge order, from 0.

    ``rows``/``cols``/``vals`` ``[e]`` with ``x`` ``[n_src, d]``, or the
    stacked form ``[P, e]`` with ``x`` ``[P, n_src, d]`` → ``[P, n_dst,
    d]``.  ``perm``/``ptr`` are the entries' grouping by row
    (:func:`row_grouping`); without them it is computed here.  The
    transpose ``Aᵀe`` is the same call with the roles swapped:
    ``spmm_ref(cols, rows, vals, e, n_src)``.
    """
    if perm is None:
        perm, ptr = row_grouping(rows, entries_kept(cols, vals, x.shape[-2]),
                                 n_dst)
    return grouped_walk_ref(perm, ptr, cols, vals, x)


def spmm_t_ref(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
               e: torch.Tensor, n_src: int) -> torch.Tensor:
    """Backward-order oracle ``y = Aᵀ e`` → ``[n_src, d]``: the same COO
    walked column-major (no ``Aᵀ`` table), each column summing its entries
    in edge order, from 0 — :func:`spmm_ref` with the roles swapped."""
    return spmm_ref(cols, rows, vals, e, n_src)


def block_rows(rows: torch.Tensor, dpc: int) -> torch.Tensor:
    """Block-Message tiles' output rows ``b·dpc + rows[b, e]``, flattened
    over the tiles: ``[B, eb]`` → ``[B·eb]`` (``[P, B, eb]`` → ``[P,
    B·eb]``).  A row outside ``[0, dpc)`` maps to -1 (counts nowhere)."""
    B, eb = rows.shape[-2:]
    r = rows.long()
    g = r + (torch.arange(B, device=rows.device) * dpc).view(B, 1)
    g = torch.where((r >= 0) & (r < dpc), g, -1)
    return g.reshape(*rows.shape[:-2], B * eb)


def walk_groupings(rows: torch.Tensor, cols: torch.Tensor,
                   vals: torch.Tensor, n_dst: int, n_src: int
                   ) -> Dict[str, torch.Tensor]:
    """Both groupings of one (stacked) flat edge list: ``perm``/``ptr`` by
    output row ``rows`` (the forward walk, ``n_dst`` rows) and
    ``t_perm``/``t_ptr`` by source ``cols`` (the transpose walk, ``n_src``
    rows), over the same entries — those :func:`entries_kept` keeps with a
    row inside ``[0, n_dst)``.  Built once per layout, on the host for the
    hot path."""
    keep = entries_kept(cols, vals, n_src) & (rows >= 0) & (rows < n_dst)
    perm, ptr = row_grouping(rows, keep, n_dst)
    t_perm, t_ptr = row_grouping(cols, keep, n_src)
    return {"perm": perm, "ptr": ptr, "t_perm": t_perm, "t_ptr": t_ptr}


def tile_groupings(rows: torch.Tensor, cols: torch.Tensor,
                   vals: torch.Tensor, dpc: int, n_src: int
                   ) -> Dict[str, torch.Tensor]:
    """:func:`walk_groupings` of Block-Message tiles (``[B, eb]`` or ``[P,
    B, eb]``) flattened, plus ``t_rows``: the entries' output rows
    ``b·dpc + rows[b, e]`` (:func:`block_rows`), which the transpose walk
    gathers the error rows at."""
    B, eb = rows.shape[-2:]
    flat = rows.shape[:-2] + (B * eb,)
    grows = block_rows(rows, dpc)
    out = walk_groupings(grows, cols.reshape(flat), vals.reshape(flat),
                         B * dpc, n_src)
    out["t_rows"] = grows.to(torch.int32)
    return out


def spmm_block_ref(rows: torch.Tensor, cols: torch.Tensor,
                   vals: torch.Tensor, x: torch.Tensor, dpc: int,
                   perm: Optional[torch.Tensor] = None,
                   ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Block-Message SpMM ``y[b·dpc + r] = Σ vals · x[cols]`` over
    ``[n_blocks, eb]`` tiles with block-local rows → ``[n_blocks·dpc, d]``
    (stacked: ``[P, n_blocks, eb]`` tiles, ``x`` ``[P, n_src, d]`` →
    ``[P, n_blocks·dpc, d]``), each row in tile order, from 0: the flat
    walk over the tiles' entries with rows :func:`block_rows`."""
    B, eb = rows.shape[-2:]
    flat = rows.shape[:-2] + (B * eb,)
    return spmm_ref(block_rows(rows, dpc), cols.reshape(flat),
                    vals.reshape(flat), x, B * dpc, perm, ptr)


def gemm_ref(x: torch.Tensor, w: torch.Tensor,
             bias: Optional[torch.Tensor] = None, *, relu: bool = False
             ) -> torch.Tensor:
    """``relu(x @ w + bias)`` in fp32, summed over K in ascending order.

    The kernel's contract is that an output row's bits do not depend on how
    many rows share the call; a BLAS ``x @ w`` does not promise that (its
    blocking changes with M), so the plain version sums the K rank-1 terms
    in a fixed order instead: the same order as the kernel, which differs
    only in fusing each multiply-add.
    """
    m, k = x.shape
    n = w.shape[1]
    if k == 0:
        acc = x.new_zeros((m, n))
    else:
        acc = x[:, 0:1] * w[0:1]
        for kk in range(1, k):
            acc = acc + x[:, kk:kk + 1] * w[kk:kk + 1]
    if bias is not None:
        acc = acc + bias
    if relu:
        acc = torch.relu(acc)
    return acc


MHA_NEG = torch.finfo(torch.float32).min
LOG2E = 1.0 / math.log(2.0)          # the lse's base: 2


def _live_rows(r0: int, r1: int, sk: int, causal: bool,
               window: Optional[int], device) -> torch.Tensor:
    """Whether each row in ``[r0, r1)`` keeps a live key under
    ``flash_mha``'s masks (a row past ``sk - 1 + window`` keeps none)."""
    rows = torch.arange(r0, r1, device=device)
    hi = rows.clamp(max=sk - 1) if causal else torch.full_like(rows, sk - 1)
    lo = (rows - int(window) + 1).clamp(min=0) if window is not None \
        else torch.zeros_like(rows)
    return hi >= lo


def _rows_all_live(r0: int, r1: int, sk: int,
                   window: Optional[int]) -> bool:
    """Whether every row in ``[r0, r1)`` keeps a live key: :func:`_live_rows`
    computed on the host (a row's keys run out only past ``sk - 2 +
    window``, with or without the causal mask)."""
    return sk > 0 and (window is None or r1 - 1 <= sk - 2 + int(window))


def _key_span(r0: int, r1: int, sk: int, causal: bool,
              window: Optional[int]) -> Tuple[int, int]:
    """``[lo, hi)``: the keys some row in ``[r0, r1)`` attends."""
    lo = 0 if window is None else min(max(r0 - int(window) + 1, 0), sk)
    hi = min(r1, sk) if causal else sk
    return lo, max(hi, lo)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, q_block: int = 512,
            window: Optional[int] = None, return_lse: bool = False):
    """Plain attention (the reference's ``mha_ref``): q ``[bh, sq, hd]``,
    k/v ``[bh, sk, hd]`` → ``[bh, sq, hd]`` in ``q``'s type.

    f32 logits ``q kᵀ / √hd``, the causal mask ``j <= i`` counted from 0 on
    both axes (and, with ``window``, the band ``i - j < window``, as the
    reference's ``flash_attend`` masks ``w_eff``), a full softmax per row,
    the probabilities cast to ``q``'s type, then ``p @ v`` summed in f32.  float64 inputs keep float64
    throughout (a yardstick for the f32 kernel).  No online state: the
    rows go through in blocks of ``q_block``, so memory stays at
    ``[bh, q_block, sk]`` logits however long the sequence.  A block whose
    rows all keep a live key sees only the keys some row of it attends
    (the causal triangle's and the band's others weigh exactly 0).

    ``return_lse``: also each row's log-sum-exp of its masked logits in
    base 2 (``logsumexp · log2 e``, f32, or float64 for float64 inputs),
    ``[bh, sq]``: the kernel's ``lse`` output, which :func:`mha_bwd_ref`
    takes.  A row with no live key (a window, and no causal mask or
    ``sq > sk``) averages ``v`` here, as the reference does, and gets
    ``-inf`` (the kernel's ``o`` is 0 there).
    """
    bh, sq, hd = q.shape
    sk = k.shape[1]
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    out = torch.empty((bh, sq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, sq), dtype=acc, device=q.device) \
        if return_lse else None
    kf, vf = k.to(acc), v.to(acc)
    step = max(int(q_block), 1)
    for r0 in range(0, sq, step):
        r1 = min(r0 + step, sq)
        live = _live_rows(r0, r1, sk, causal, window, q.device)
        # the other keys weigh exactly 0 in a row that keeps a live key
        lo, hi = _key_span(r0, r1, sk, causal, window) \
            if _rows_all_live(r0, r1, sk, window) else (0, sk)
        logits = torch.matmul(q[:, r0:r1].to(acc),
                              kf[:, lo:hi].transpose(1, 2)) / math.sqrt(hd)
        rows = torch.arange(r0, r1, device=q.device)
        cols = torch.arange(lo, hi, device=q.device)
        if causal:
            logits.masked_fill_(cols[None, :] > rows[:, None], MHA_NEG)
        if window is not None:
            logits.masked_fill_(rows[:, None] - cols[None, :] >= window,
                                MHA_NEG)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        out[:, r0:r1] = torch.matmul(probs.to(acc), vf[:, lo:hi]).to(q.dtype)
        if lse is not None:
            # log Σ e^(x - m) + m: torch.logsumexp is slow on the CPU
            m = logits.amax(dim=-1, keepdim=True)
            nat = (logits - m).exp_().sum(dim=-1).log_() + m[..., 0]
            lse[:, r0:r1] = torch.where(live, nat * LOG2E, -math.inf)
    return (out, lse) if return_lse else out


def mha_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                causal: bool = True, window: Optional[int] = None,
                q_block: int = 512
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of :func:`mha_ref` (the plain version of
    ``csrc/flash_mha_bwd.cu``): ``(dq, dk, dv)`` in the inputs' types from
    ``o`` and the base-2 ``lse`` of the forward and the output's gradient
    ``do`` (``[bh, sq, hd]``).

    Per block of ``q_block`` rows, over only the keys some row of the block
    attends: ``p = 2^(s · log2 e − lse)`` with ``s = q kᵀ / √hd`` (masked
    pairs 0), ``dv += p̃ᵀ do`` with ``p̃`` the probabilities cast to ``q``'s
    type as the forward casts them, ``dP = do vᵀ``, ``δ = rowsum(do ∘ o)``,
    ``dS = p ∘ (dP − δ) / √hd``, ``dq = dS k``, ``dk += dSᵀ q``; f32 sums
    (float64 for float64 inputs), never ``[bh, sq, sk]`` at once.  Equal to
    ``torch.autograd`` of :func:`mha_ref` to rounding, a row with no
    live key (``lse`` ``-inf``) too: ``mha_ref`` averages ``v`` there, as
    the reference does, so each key's ``dv`` takes 1 / sk of that row's
    ``do``, and ``dq`` and ``dk`` take nothing from it.
    """
    bh, sq, hd = q.shape
    sk = k.shape[1]
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    dq = torch.zeros((bh, sq, hd), dtype=acc, device=q.device)
    dk = torch.zeros((bh, sk, hd), dtype=acc, device=q.device)
    dv = torch.zeros((bh, sk, hd), dtype=acc, device=q.device)
    kf, vf = k.to(acc), v.to(acc)
    step = max(int(q_block), 1)
    for r0 in range(0, sq, step):
        r1 = min(r0 + step, sq)
        lo, hi = _key_span(r0, r1, sk, causal, window)
        if hi <= lo:
            continue
        qb, dob = q[:, r0:r1].to(acc), do[:, r0:r1].to(acc)
        kb, vb = kf[:, lo:hi], vf[:, lo:hi]
        rows = torch.arange(r0, r1, device=q.device)[:, None]
        cols = torch.arange(lo, hi, device=q.device)[None, :]
        masked = torch.zeros((r1 - r0, hi - lo), dtype=torch.bool,
                             device=q.device)
        if causal:
            masked |= cols > rows
        if window is not None:
            masked |= rows - cols >= window
        logits = torch.matmul(qb, kb.transpose(1, 2)) / math.sqrt(hd)
        row_lse = lse[:, r0:r1].to(acc)
        row_lse = torch.where(torch.isneginf(row_lse), math.inf, row_lse)
        p = torch.exp2(logits * LOG2E - row_lse[..., None])
        p.masked_fill_(masked, 0.0)
        dv[:, lo:hi] += torch.matmul(p.to(q.dtype).to(acc).transpose(1, 2),
                                     dob)
        dp = torch.matmul(dob, vb.transpose(1, 2))
        delta = (dob * o[:, r0:r1].to(acc)).sum(-1, keepdim=True)
        ds = p * (dp - delta) / math.sqrt(hd)
        dq[:, r0:r1] = torch.matmul(ds, kb)
        dk[:, lo:hi] += torch.matmul(ds.transpose(1, 2), qb)
    d0 = sq if window is None else max(sk - 1 + int(window), 0)
    if d0 < sq and sk > 0:
        # the rows with no live key: 1 / sk of their do to every key's dv
        dv += do[:, d0:].to(acc).sum(1, keepdim=True) / sk
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
