"""Collectives for the row-sharded index and the data-parallel train step,
over torch.distributed.

Counterpart of nann_tpu/parallel/collectives.py. The primitive is
`sharded_gather`: fetch any rows of a table whose rows are split over the
"mp" axis. Each rank gathers the rows it owns (through the `gather_rows`
kernel on the card), zeroes the others, and a SUM over the mp group
assembles the rows on every rank.

The train step's collectives, which XLA inserts from the shardings in JAX:
`all_reduce_sum`, a SUM that autograd differentiates (the batch-norm
statistics and the loss over the global batch); `all_reduce_grads`, the
gradients' SUM over "dp" in one flat buffer per dtype; and
`sharded_lookup`, the embedding lookup of a row-sharded table as an
autograd Function (forward `gather_owned`, backward an `index_add_` of the
rows this rank owns).

Only one rank contributes non-zero bits to each row, so the sum is exact
when it adds the rows as integers: every dtype moves as 32-bit words
(`.view(torch.int32)`), which keeps every bit, -0.0 and NaN payloads
included. The words are also what `gather_rows` moves, and int32 is reduced
by every backend, where int16 (bfloat16's width) is reduced neither by gloo
nor by NCCL. A row must therefore hold a whole number of 4-byte words: every
table of the port does (the scorer needs D % 4 == 0).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch
import torch.distributed as dist

from ..kernels import visited_ops
from .mesh import Mesh


def as_words(t: torch.Tensor) -> torch.Tensor:
    """t's last axis as int32 words (the same bytes, no copy)."""
    if t.dtype == torch.int32:
        return t
    nbytes = t.shape[-1] * t.element_size()
    if nbytes % 4 or not t.is_contiguous():
        raise ValueError(f"rows of {t.shape[-1]} x {t.dtype} are not a whole "
                         f"number of 4-byte words (or not contiguous)")
    return t.view(torch.int32)


def sum_exact(t: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """SUM of t over `group`, in place, as int32 words; exact where at most
    one rank holds non-zero bits at each place."""
    dist.all_reduce(as_words(t), op=dist.ReduceOp.SUM, group=group)
    return t


def gather_owned(table_local: torch.Tensor, ids: torch.Tensor, lo: int,
                 group: dist.ProcessGroup, gather_rows: Callable = None
                 ) -> torch.Tensor:
    """Rows [*ids.shape, W] of the global table whose rows [lo, lo + rows)
    this rank holds as table_local [rows, W]: a masked local gather (by
    `gather_rows`, by default the kernel's wrapper), then an exact SUM over
    `group`. Ids no rank owns give zero rows."""
    gather_rows = gather_rows or visited_ops.gather_rows
    words = as_words(table_local)
    local = ids.int() - lo
    mine = (local >= 0) & (local < words.shape[0])
    got = gather_rows(words, torch.where(mine, local, 0).contiguous())
    got = torch.where(mine[..., None], got, 0).contiguous()
    sum_exact(got, group)
    return got.view(table_local.dtype)


def gather_blocks(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The blocks t of every rank along `axis`, stacked on the first axis in
    the axis' order (each rank's block in its place, zeros elsewhere, then an
    exact SUM): every rank gets the whole."""
    size, at = mesh.size(axis), mesh.index(axis)
    full = torch.zeros((size * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                       device=t.device)
    full[at * t.shape[0]:(at + 1) * t.shape[0]] = t
    return sum_exact(full, mesh.group(axis))


def sharded_gather(mesh: Mesh, axis: str = "mp") -> Callable:
    """gather(table_local, ids) for a table whose rows are split evenly over
    `axis` (this rank holds block `mesh.index(axis)`) and ids replicated
    over it: the rows [*ids.shape, W], on every rank of the axis. The
    table's global row count must divide by the axis size."""
    def gather(table_local: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        lo = mesh.index(axis) * table_local.shape[0]
        return gather_owned(table_local, ids, lo, mesh.group(axis))

    return gather


def whole_leaf(t: torch.Tensor, placements, mesh: Mesh) -> torch.Tensor:
    """The whole tensor of which t is this rank's block under `placements`
    (one per mesh axis; the inverse of parallel.sharding.local_block), on
    every rank: a `gather_blocks` along each axis whose placement is Shard
    of dimension 0, the last axis first (local_block narrows the first
    first). Collective over those axes."""
    for axis, p in reversed(list(zip(mesh.axis_names, placements))):
        dim = getattr(p, "dim", None)
        if dim is None:
            continue
        if dim != 0:
            raise ValueError(f"only first-axis shards are gathered, got "
                             f"Shard({dim}) on {axis}")
        t = gather_blocks(t.detach().contiguous(), mesh, axis)
    return t


# ----------------------------------------------------- the train step's


class _AllReduceSum(torch.autograd.Function):
    """SUM over a group. The derivative of a sum over ranks, taken on each
    rank of its own share of the loss, is the SUM of the incoming gradients:
    the backward is this Function again, so it differentiates twice."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(t: torch.Tensor, group: dist.ProcessGroup
                   ) -> torch.Tensor:
    """SUM of t over `group`, differentiable: a new tensor, equal on every
    rank of the group. Each rank must backprop its own share of the loss
    (the backward sums the shares' gradients over the group)."""
    return _AllReduceSum.apply(t, group)


def all_reduce_grads(leaves: Iterable[torch.Tensor],
                     group: dist.ProcessGroup) -> int:
    """SUM of the leaves' .grad over `group`, in place: one flat buffer and
    one all_reduce per dtype. A leaf without a gradient adds zeros, so every
    rank sends the same layout. Returns the bytes reduced."""
    by_dtype = {}
    for leaf in leaves:
        if leaf.grad is None:
            leaf.grad = torch.zeros_like(leaf)
        by_dtype.setdefault(leaf.grad.dtype, []).append(leaf)
    nbytes = 0
    for dtype in sorted(by_dtype, key=str):
        group_leaves = by_dtype[dtype]
        flat = torch.cat([leaf.grad.reshape(-1) for leaf in group_leaves])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        nbytes += flat.numel() * flat.element_size()
        at = 0
        for leaf in group_leaves:
            n = leaf.grad.numel()
            leaf.grad.copy_(flat[at:at + n].view_as(leaf.grad))
            at += n
    return nbytes


class _ShardedLookup(torch.autograd.Function):
    """Rows of a table whose rows [lo, lo + rows) this rank holds: forward
    `gather_owned` (the exact SUM over the group), backward the gradient
    rows of the ids this rank owns added into its block. The backward needs
    no collective: every rank of the group computes the same upstream
    gradient, as each holds the same ids and replicated weights."""

    @staticmethod
    def forward(ctx, table_local, ids, lo, group, gather_rows):
        ctx.save_for_backward(ids)
        ctx.lo, ctx.shape = lo, table_local.shape
        return gather_owned(table_local.detach(), ids, lo, group, gather_rows)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        rows, width = ctx.shape
        local = ids.reshape(-1).long() - ctx.lo
        mine = (local >= 0) & (local < rows)
        out = torch.zeros((rows, width), dtype=grad.dtype,
                          device=grad.device)
        out.index_add_(0, local[mine], grad.reshape(-1, width)[mine])
        return out, None, None, None, None


def sharded_lookup(table_local: torch.Tensor, ids: torch.Tensor, lo: int,
                   group: dist.ProcessGroup,
                   gather_rows: Optional[Callable] = None) -> torch.Tensor:
    """Rows [*ids.shape, W] of a row-sharded table (this rank holds rows
    [lo, lo + rows) as table_local), differentiable in table_local."""
    return _ShardedLookup.apply(table_local, ids, lo, group, gather_rows)


def sharded_embedding(mesh: Mesh, axis: str = "mp") -> Callable:
    """lookup(table_local, ids) for tables whose rows are split evenly over
    `axis` (this rank holds block `mesh.index(axis)`): the train step's
    counterpart of `sharded_gather`, differentiable in the block."""
    def lookup(table_local: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        lo = mesh.index(axis) * table_local.shape[0]
        return sharded_lookup(table_local, ids, lo, mesh.group(axis))

    return lookup
