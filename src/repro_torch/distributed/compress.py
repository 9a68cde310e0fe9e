"""int8 error-feedback compressed all-reduce on the stacked cores (port of
:mod:`repro.distributed.compress`).

The paper's Weight Bank synchronizes the global weights after every
update; this is that gradient sync with int8 wire traffic, built from the
same hypercube rounds as the aggregation layer
(:func:`repro_torch.topology.hypercube._round`):

  * reduce-scatter phase: round ``b`` runs over ``reversed(range(ndim))``;
    each core keeps its half by bit ``b``, quantizes the half it sends to
    int8 with one f32 scale per core per round, and adds its partner's
    (``p ^ (1 << b)``) dequantized half: ``mine + dequant``;
  * all-gather phase: the fully-reduced shard is quantized once and doubled
    around the cube in int8 (:func:`hypercube_allgather` of the codes and
    of the scales);
  * error feedback: each core keeps the quantization residual of its OWN
    contribution and re-injects it next step (EF-SGD).

Every tensor carries the stacked core axis first: ``x`` is ``[P, n]`` with
row *p* core *p*'s vector, and every core ends with the sum.  Rounding is
``torch.round`` (half to even, as ``jnp.round``), and every division,
clip and add is the reference's, so the results are the reference's bit
for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.topology.hypercube import _round, hypercube_allgather


def _per_core(scale: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return scale.view(-1, *([1] * (like.dim() - 1)))


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each core's row of ``x`` as int8 codes and one f32 scale ``[P]``."""
    amax = x.reshape(x.shape[0], -1).abs().amax(dim=1)
    # a tensor divisor: CUDA turns division by a Python number into a
    # multiply by its reciprocal, the CPU divides (as the reference does)
    scale = torch.clamp(amax, min=1e-30) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(x / _per_core(scale, x)), -127, 127)
    return q.to(torch.int8), scale


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * _per_core(scale, q)


def _hypercube_ndim(n_cores: int) -> int:
    """Hypercube dimensionality for ``n_cores``, or a loud error.

    The exchange pairs core ``i`` with ``i ^ (1 << b)``, a wiring that
    exists only when the core count is a power of two; on any other count
    this fails naming the topology instead of mis-routing halves.
    """
    if n_cores < 1 or n_cores & (n_cores - 1):
        raise ValueError(
            f"compressed_psum runs dimension-ordered hypercube rounds "
            f"(peer = i ^ 2^b), which require a power-of-two core count; "
            f"got {n_cores} cores.  Use a topology-registry exchange for "
            f"non-hypercube meshes.")
    return n_cores.bit_length() - 1


def _resolve_ndim(ndim: Optional[int], n_cores: Optional[int]) -> int:
    if (ndim is None) == (n_cores is None):
        raise ValueError("pass exactly one of ndim= or n_cores=")
    if n_cores is not None:
        return _hypercube_ndim(int(n_cores))
    return int(ndim)


def compressed_psum(x: torch.Tensor, ndim: Optional[int] = None, *,
                    n_cores: Optional[int] = None) -> torch.Tensor:
    """int8 hypercube all-reduce of flat f32 vectors on the stacked cores.

    ``x``: ``[P, n]`` (row *p* is core *p*'s vector), n divisible by
    P = 2**ndim.  Returns ``[P, n]``: every row the f32 sum over the cores,
    computed with int8 wire traffic.  Pass EITHER ``ndim`` or ``n_cores=``
    (which must be a power of two; a ``ValueError`` otherwise).
    """
    ndim = _resolve_ndim(ndim, n_cores)
    n_cores = 1 << ndim
    if x.dim() != 2 or x.shape[0] != n_cores or x.shape[1] % n_cores:
        raise ValueError(f"x must be [{n_cores}, n] with n divisible by "
                         f"{n_cores}, got {tuple(x.shape)}")
    buf = x.reshape(n_cores, n_cores, -1)
    # --- reduce-scatter fold (int8 wire), high bit first ---
    for b in reversed(range(ndim)):
        split, permute = _round(b)
        mine, send = split(buf)
        q, s = _quant(send)
        buf = mine + _dequant(permute(q), permute(s))
    shard = buf[:, 0]                               # [P, n/P] fully reduced
    # --- all-gather double (int8 wire) ---
    q, s = _quant(shard)
    qbuf = hypercube_allgather(q, n_cores)          # [P, P, n/P] int8
    sbuf = hypercube_allgather(s, n_cores)          # [P, P] scales
    return (qbuf.to(torch.float32) * sbuf[..., None]).reshape(n_cores, -1)


def ef_compress_grads(grads, err, ndim: Optional[int] = None, *,
                      n_cores: Optional[int] = None):
    """Error-feedback compressed all-reduce over a gradient tree.

    Every gradient leaf is ``[P, ...]`` (core *p*'s gradient in row *p*)
    and every residual leaf ``[P, n_pad]`` (:func:`init_error_state`).
    Returns ``(mean_grads, new_err)`` of the same structures.  Each leaf:
    inject the residual, quantize the contribution (that quantized value is
    what enters the fold), keep the new residual.  ``ndim`` vs ``n_cores=``
    as in :func:`compressed_psum`.
    """
    ndim = _resolve_ndim(ndim, n_cores)
    n_cores = 1 << ndim

    def one(g: torch.Tensor, e: torch.Tensor):
        flat = g.reshape(g.shape[0], -1)
        size = flat.shape[1]
        flat = F.pad(flat, (0, (-size) % n_cores))
        corrected = flat + e
        q, s = _quant(corrected)
        contribution = _dequant(q, s)
        new_e = corrected - contribution
        summed = compressed_psum(contribution, ndim)
        # n_cores is a power of two: its reciprocal is exact on every device
        return (summed[:, :size] / n_cores).reshape(g.shape), new_e

    outs = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(err))]
    means, errs = iter([o[0] for o in outs]), iter([o[1] for o in outs])
    return (tree_map(lambda _: next(means), grads),
            tree_map(lambda _: next(errs), grads))


def init_error_state(params, n_cores: int):
    """Zero EF residuals: per parameter leaf (one core's weights) a
    ``[n_cores, n_pad]`` f32 tensor on the leaf's device, ``n_pad`` its
    element count padded to a multiple of ``n_cores``."""
    def one(p: torch.Tensor) -> torch.Tensor:
        n = p.numel() + ((-p.numel()) % n_cores)
        return torch.zeros((n_cores, n), dtype=torch.float32,
                           device=p.device)
    return tree_map(one, params)


def compression_ratio(dtype_bytes: int = 4) -> float:
    """Wire-byte ratio vs uncompressed f32 all-reduce (scales amortize out)."""
    return dtype_bytes / 1.0
