"""Tensor parallelism over a mesh's ``model`` axis: the pieces that split
the LM's dense layers as GSPMD splits the reference's from the placement
rules of ``launch/steps.py`` (megatron's column / row pairs, Mamba2's
channel split, the vocab-parallel embedding, head and loss).

The reference has no module of this kind: GSPMD derives the collectives
from the placements.  Here they are explicit, each an autograd function
over the ``model`` group:

* :func:`replicate` — megatron's f: identity forward into a split region,
  the gradient summed over ``model`` backward (each rank reaches its input
  only through its own block);
* :func:`reduce` — megatron's g: a row block's partial outputs summed over
  ``model`` forward, the gradient passed on unchanged backward;
* :func:`model_sum` — a sum over ``model`` both ways: the mean square of a
  norm over a split width, where every rank's share feeds every rank's
  norm;
* :func:`vocab_embed` — the lookup in this rank's block of vocab rows,
  zeros for a token outside it, then g;
* :func:`vocab_nll` — the next-token NLL from this rank's block of vocab
  columns: the max, the sum of exps and the target logit, each combined
  over ``model``;
* :func:`gather_vocab` — the vocab blocks of the logits gathered whole.

Each is the identity at ``W = 1`` and makes no copy there.

:class:`Split` is the ``model`` axis as the layers see it: its group, its
size, this rank's index on it and the plan (block → ``"split"`` or
``"whole"``, ``launch/steps.py::tp_plan``).  :func:`use_split` makes one
current, as ``sharding.use_mesh`` makes a mesh current; the layers read
it through :func:`enter` / :func:`leave` (f / g of a block where the plan
splits it, the identity where it computes whole) and :func:`split_for`.
Outside a :func:`use_split` block every layer computes whole.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator, Mapping, Optional

import torch
import torch.nn.functional as F

from .sharding import MODEL, _all_gather

SPLIT, WHOLE = "split", "whole"


@dataclasses.dataclass(frozen=True)
class Split:
    """The ``model`` axis of a mesh for the tensor-parallel layers:
    ``group`` (its process group), ``size`` (``W``), ``rank`` (this rank's
    index on it) and ``plan`` (each block of the model → ``"split"`` or
    ``"whole"``)."""

    group: Any
    size: int
    rank: int
    plan: Mapping[str, str]

    @classmethod
    def over(cls, mesh, plan: Mapping[str, str]) -> "Split":
        """The ``model`` dimension of ``mesh`` under ``plan``."""
        names = tuple(mesh.mesh_dim_names or ())
        return cls(group=mesh.get_group(MODEL),
                   size=int(mesh.size(names.index(MODEL))),
                   rank=int(mesh.get_local_rank(MODEL)), plan=dict(plan))

    def splits(self, block: str) -> bool:
        """Whether ``block`` computes split (``KeyError`` for a block the
        plan does not name: no layer falls back to whole unnoticed)."""
        return self.plan[block] == SPLIT


_CURRENT = []


@contextlib.contextmanager
def use_split(split: Optional[Split]) -> Iterator:
    """Make ``split`` current inside the block (nests; ``None``: every
    layer whole)."""
    _CURRENT.append(split)
    try:
        yield split
    finally:
        _CURRENT.pop()


def current() -> Optional[Split]:
    """The innermost :func:`use_split` split, or ``None``."""
    return _CURRENT[-1] if _CURRENT else None


def split_for(block: str) -> Optional[Split]:
    """The current split where it splits ``block``, else ``None``."""
    split = current()
    return split if split is not None and split.splits(block) else None


# ---------------------------------------------------------------------------
# f, g and the sum over model
# ---------------------------------------------------------------------------
def _all_reduce(t: torch.Tensor, group, op=None) -> torch.Tensor:
    """A contiguous copy of ``t`` summed (or ``op``) over ``group``."""
    import torch.distributed as dist

    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op is None else op,
                    group=group)
    return out


class _Replicate(torch.autograd.Function):
    """Megatron's f: identity forward into the split region, the gradient
    summed over ``group`` backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    """Megatron's g: the partial outputs summed over ``group`` forward, the
    gradient unchanged backward (every rank holds the same)."""

    @staticmethod
    def forward(ctx, y, group):
        return _all_reduce(y, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ModelSum(torch.autograd.Function):
    """A sum over ``group`` forward, and backward (each rank's share feeds
    every rank's result)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def replicate(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """f over ``group`` of ``size`` ranks: ``x`` itself when ``size`` is
    1."""
    return x if size == 1 else _Replicate.apply(x, group)


def reduce(y: torch.Tensor, group, size: int) -> torch.Tensor:
    """g over ``group`` of ``size`` ranks: ``y`` itself when ``size`` is
    1."""
    return y if size == 1 else _Reduce.apply(y, group)


def model_sum(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """``x`` summed over ``group`` both ways: ``x`` itself when ``size`` is
    1."""
    return x if size == 1 else _ModelSum.apply(x, group)


def enter(x: torch.Tensor, block: str) -> torch.Tensor:
    """``x`` as the input of ``block``: through f where the current split
    splits ``block``, else itself."""
    split = split_for(block)
    return x if split is None else replicate(x, split.group, split.size)


def leave(y: torch.Tensor, block: str) -> torch.Tensor:
    """``block``'s output: its partial sums through g where the current
    split splits ``block``, else itself."""
    split = split_for(block)
    return y if split is None else reduce(y, split.group, split.size)


# ---------------------------------------------------------------------------
# the vocab-parallel embedding, loss and logits
# ---------------------------------------------------------------------------
def _in_block(ids: torch.Tensor, n: int, rank: int):
    """(whether each of ``ids`` lies in this rank's block of ``n`` vocab
    rows, its index in the block, 0 where it does not)."""
    local = ids.long() - rank * n
    inside = (local >= 0) & (local < n)
    return inside, torch.where(inside, local, 0)


def vocab_embed(tokens: torch.Tensor, embed: torch.Tensor,
                split: Optional[Split]) -> torch.Tensor:
    """``F.embedding(tokens, embed)`` with ``embed`` this rank's block of
    vocab rows under ``split`` (``None``: the whole table): each rank
    looks up the tokens in its block, zeros elsewhere, and g sums the
    blocks (one non-zero each, so the rows are the whole lookup's
    bits)."""
    if split is None or split.size == 1:
        return F.embedding(tokens.long(), embed)
    inside, local = _in_block(tokens, embed.shape[0], split.rank)
    rows = torch.where(inside[..., None], F.embedding(local, embed), 0)
    return reduce(rows, split.group, split.size)


class _VocabNLL(torch.autograd.Function):
    """Per-token ``logsumexp(logits) - logits[label]`` over the vocab
    blocks of ``group``: the max over ``model`` (all-reduce max), then the
    sums of exps and the target logit (one all-reduce sum of the pair).
    Backward is local: ``softmax - onehot`` of the rank's columns."""

    @staticmethod
    def forward(ctx, logits, labels, group, rank):
        import torch.distributed as dist

        inside, local = _in_block(labels, logits.shape[-1], rank)
        m = _all_reduce(logits.amax(-1), group, dist.ReduceOp.MAX)
        e = torch.exp(logits - m[..., None])
        target = torch.where(inside, torch.gather(
            logits, -1, local[..., None])[..., 0], 0)
        se, target = _all_reduce(torch.stack([e.sum(-1), target]),
                                 group).unbind(0)
        ctx.save_for_backward(e, se, inside, local)
        return torch.log(se) + m - target

    @staticmethod
    def backward(ctx, g):
        e, se, inside, local = ctx.saved_tensors
        p = e / se[..., None]
        p.scatter_add_(-1, local[..., None], -inside[..., None].to(p.dtype))
        return p * g[..., None], None, None, None


def vocab_nll(logits: torch.Tensor, labels: torch.Tensor,
              split: Optional[Split]) -> torch.Tensor:
    """Per-token next-token NLL of ``labels`` from ``logits``, this rank's
    block of vocab columns under ``split`` (``None`` or one rank: the
    whole vocab, through ``log_softmax``)."""
    if split is None or split.size == 1:
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    return _VocabNLL.apply(logits, labels, split.group, split.rank)


def gather_vocab(logits: torch.Tensor, split: Optional[Split]
                 ) -> torch.Tensor:
    """The vocab blocks of ``logits`` (the last dimension) gathered whole
    on every rank of ``split``: ``logits`` itself at one rank."""
    if split is None or split.size == 1:
        return logits
    return _all_gather(logits, logits.ndim - 1, split.group, split.size)
