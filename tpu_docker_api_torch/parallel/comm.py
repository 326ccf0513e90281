"""Collectives of the sharded code path, written out (no counterpart
file in the JAX package, where XLA inserts them from the shardings).

Every collective here takes a process group that may be None (a size-1
axis): it is then the identity, so the mesh path at world size 1 issues
none. The differentiable ones are ``torch.autograd.Function``s whose
backward is the collective the JAX transpose rule would run:

- :func:`reduce_from` (Megatron's ``g``): forward all-reduce, backward
  identity: the sum of a row-parallel product's partial outputs, whose
  consumers are replicated over the axis;
- :func:`copy_to` (``f``): forward identity, backward all-reduce: a
  replicated input that feeds column-parallel products;
- :func:`all_gather`: concatenation along a dim; its backward is a
  reduce-scatter (``bwd="sum"``, the axis splits the batch: every rank's
  loss reaches every slice) or the rank's own slice (``bwd="slice"``,
  the computation after it is replicated over the axis);
- :func:`scatter_to`: this rank's slice of a tensor replicated over the
  axis; backward all-gathers the slices' gradients (a replicated bias
  of a column-parallel product);
- :func:`all_to_all`: the tiled ``lax.all_to_all``; backward is the
  inverse exchange;
- :func:`ppermute`: ``lax.ppermute`` over ``batch_isend_irecv``;
  backward sends the gradients the other way round.

:func:`exchange` is the point-to-point step under ``ppermute``, outside
autograd: the 1F1B pipeline sends a tick's activation and cotangent in
one batch with it (parallel/pipeline.py).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM):
    x = x.contiguous().clone()
    dist.all_reduce(x, op=op, group=group)
    return x


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = x.shape[dim] // _size(group)
    return x.narrow(dim, _rank(group) * n, n).contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((xt.shape[0] // n, *xt.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, xt, group=group)
    return out.movedim(0, dim).contiguous()


def _a2a(x: torch.Tensor, split_dim: int, concat_dim: int, group):
    """Tiled all-to-all: split ``split_dim`` into ``n`` chunks, send
    chunk j to rank j, concatenate the received chunks along
    ``concat_dim`` in rank order."""
    n = _size(group)
    xs = x.movedim(split_dim, 0)
    xs = xs.reshape(n, xs.shape[0] // n, *xs.shape[1:]).contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=group)
    # out[j] is rank j's chunk for this rank: (n, split/n, ...)
    out = out.movedim(1, split_dim + 1)   # (n, ..., split/n, ...)
    cd = concat_dim + 1
    out = out.movedim(0, cd - 1 if cd > 0 else 0)
    shape = list(out.shape)
    merged = shape[:cd - 1] + [shape[cd - 1] * shape[cd]] + shape[cd + 1:]
    return out.reshape(merged)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, bwd):
        ctx.dim, ctx.group, ctx.bwd = dim, group, bwd
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd == "slice":
            return _slice(g, ctx.dim, ctx.group), None, None, None
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _a2a(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _a2a(g, concat_dim, split_dim, ctx.group), None, None, None


def _permute(x: torch.Tensor, perm, group) -> torch.Tensor:
    """Rank ``src`` of ``group`` sends ``x`` to ``dst`` for each (src,
    dst) of ``perm``; a rank no pair sends to receives zeros."""
    me = _rank(group)
    x = x.contiguous()
    if (me, me) in perm:
        return x.clone()
    got = exchange([(x, dst) for src, dst in perm if src == me],
                   [(x, src) for src, dst in perm if dst == me], group)
    return got[0] if got else torch.zeros_like(x)


def exchange(sends, recvs, group) -> list[torch.Tensor]:
    """One step of point-to-point traffic outside autograd, in one
    ``batch_isend_irecv``: ``sends`` is [(tensor, dst)], ``recvs``
    [(like, src)] with ranks of ``group``; returns the received tensors
    (shaped and typed as their ``like``) in ``recvs``' order. The peer
    of each entry must post the matching one in the same step."""
    ops, out = [], []
    for x, dst in sends:
        ops.append(dist.P2POp(dist.isend, x.contiguous(),
                              dist.get_global_rank(group, dst), group))
    for like, src in recvs:
        out.append(torch.empty_like(like))
        ops.append(dist.P2POp(dist.irecv, out[-1],
                              dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _permute(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        inverse = [(dst, src) for src, dst in ctx.perm]
        return _permute(g, inverse, ctx.group), None, None


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Element-wise max over ranks, outside autograd (a softmax shift)."""
    if group is None:
        return x.detach()
    return _all_reduce(x.detach(), group, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, dim: int, group,
               bwd: str = "sum") -> torch.Tensor:
    if group is None:
        return x
    if bwd not in ("sum", "slice"):
        raise ValueError(f"all_gather bwd must be sum or slice, got {bwd!r}")
    return _AllGather.apply(x, dim, group, bwd)


def scatter_to(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return x if group is None else _ScatterTo.apply(x, dim, group)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
               group) -> torch.Tensor:
    return x if group is None else _AllToAll.apply(x, split_dim,
                                                   concat_dim, group)


def ppermute(x: torch.Tensor, perm, group) -> torch.Tensor:
    return x if group is None else _PPermute.apply(x, tuple(perm), group)


def gather_nograd(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather along ``dim`` outside autograd."""
    return x if group is None else _gather(x, dim, group)
