"""Mesh axes and the autograd-aware collectives the models, the loss and
the parallel strategies run over them (torch only; ``mesh.py`` places a
model on a mesh, ``pipeline.py`` streams stages over one).

Each collective's backward is its exact adjoint (all-reduce <->
all-reduce, all-gather <-> reduce-scatter), so the backward of every
rank's copy of a loss is the backward of one global program. On an axis
of one rank every collective is the identity, as a JAX collective over a
one-device axis is: ``ONE_RANK`` is the axis of a module that no mesh
splits."""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


class Axis:
    """One axis of a mesh as this rank sees it: its process group, size
    and this rank's coordinate. Deep copies share it (a model copied for
    its EMA stays on the same mesh)."""

    __slots__ = ("group", "size", "rank")

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank

    def __deepcopy__(self, memo):
        return self


ONE_RANK = Axis(None, 1, 0)


def axis(mesh, name: str) -> Axis:
    """``name`` of ``mesh`` (a ``DeviceMesh``); ``ONE_RANK`` when the mesh
    has no such axis (or no mesh is given)."""
    if mesh is None or name not in mesh.mesh_dim_names:
        return ONE_RANK
    return Axis(mesh.get_group(name),
                mesh.size(mesh.mesh_dim_names.index(name)),
                mesh.get_local_rank(name))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank, dim):
        ctx.group, ctx.rank, ctx.dim, ctx.n = group, rank, dim, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        # reduce-scatter: every rank's cotangent of the whole, summed, and
        # this rank's slice of it
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None, \
            None


def all_reduce(x: torch.Tensor, *axes: Axis) -> torch.Tensor:
    """Sum of ``x`` over the ranks of each axis in turn; the backward sums
    the cotangents the same way (the adjoint)."""
    for ax in axes:
        if ax.size > 1:
            x = _AllReduce.apply(x, ax.group)
    return x


def all_gather(x: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    """The slices of ``x`` of every rank of ``ax``, concatenated along
    ``dim`` in rank order (equal slices); the backward is the
    reduce-scatter. A bool tensor travels as uint8 (no gradient)."""
    if ax.size == 1:
        return x
    if x.dtype == torch.bool:
        return _AllGather.apply(x.to(torch.uint8), ax.group, ax.size,
                                ax.rank, dim).bool()
    return _AllGather.apply(x, ax.group, ax.size, ax.rank, dim)


def gather_sequence(traces: torch.Tensor, mask: Optional[torch.Tensor],
                    seq: Axis):
    """The whole ``[B, L, F]`` features and ``[B, L]`` mask from every
    rank's slice along ``seq`` (a recurrence model's input on a 'seq'
    mesh); on one rank ``(traces, mask)`` as they are."""
    if seq.size == 1:
        return traces, mask
    if mask is None:
        mask = torch.ones(traces.shape[:2], dtype=torch.bool,
                          device=traces.device)
    return all_gather(traces, seq, 1), all_gather(mask, seq, 1)
