"""Differentiable collectives over a mesh's process groups
(``launch.mesh.Mesh``): gathers of a tensor's shards along one dim, whose
backward reduce-scatters the gradient (their adjoint), reduce-scatters
along one dim, whose backward all-gathers the gradient, and a sum
all-reduce whose backward sums the gradient too.  Every collective goes
through one ``Mesh`` method of its kind, which records it."""
from __future__ import annotations

import torch


def gather_axis(t, mesh, axis: str, dim: int = 0):
    """``t``'s shards along ``dim`` gathered over the mesh's ``axis``
    group, in rank order (no autograd)."""
    return gather_group(t, mesh, mesh.group(axis), dim)


def axis_groups(mesh, names) -> list:
    """The groups that gather a dim split over the axes ``names`` (major
    first): their one group where the mesh has it (one axis, `model` and
    `tp`, the world), else each axis's group, minor first, so that each
    gather joins the blocks of one coordinate of the axes before it."""
    names = tuple(a for a in names if a in mesh.axis_names)
    if not names:
        return []
    try:
        return [mesh.group_for(names)]
    except NotImplementedError:
        return [mesh.group_for(a) for a in reversed(names)]


def gather_group(t, mesh, group, dim: int):
    """``t``'s shards along ``dim`` gathered over ``group``, in rank order
    (no autograd)."""
    tm = t.movedim(dim, 0).contiguous()
    out = tm.new_empty((mesh.group_size(group) * tm.shape[0],
                        *tm.shape[1:]))
    mesh.all_gather(out, tm, group)
    return out.movedim(0, dim).contiguous()


def scatter_group(t, mesh, group, dim: int):
    """This rank's block along ``dim`` of ``t`` summed over ``group``
    (blocks in rank order; no autograd)."""
    tm = t.movedim(dim, 0).contiguous()
    out = tm.new_empty((tm.shape[0] // mesh.group_size(group),
                        *tm.shape[1:]))
    mesh.reduce_scatter(out, tm, group)
    return out.movedim(0, dim).contiguous()


class _Gather(torch.autograd.Function):
    """All-gather of ``t``'s shards along ``dim`` over ``group``, in rank
    order; the backward is its adjoint, the reduce-scatter of the gradient
    (summed over the group)."""

    @staticmethod
    def forward(ctx, t, mesh, group, dim):
        ctx.mesh, ctx.group, ctx.dim = mesh, group, dim
        return gather_group(t, mesh, group, dim)

    @staticmethod
    def backward(ctx, g):
        return scatter_group(g, ctx.mesh, ctx.group, ctx.dim), None, None, \
            None


def gather_grad(t, mesh, group, dim: int):
    """``t``'s shards along ``dim`` gathered over ``group`` (autograd: the
    gradient is reduce-scattered back)."""
    return _Gather.apply(t, mesh, group, dim)


def gather_axes(t, mesh, names, dim: int):
    """``t``'s shards along ``dim`` (split over the axes ``names``)
    gathered whole, through ``axis_groups`` (autograd)."""
    for group in axis_groups(mesh, names):
        t = gather_grad(t, mesh, group, dim)
    return t


class _ReduceScatter(torch.autograd.Function):
    """Reduce-scatter of ``t`` along ``dim`` over ``group``: this rank's
    block of the group's sum; the backward is its adjoint, the all-gather
    of the gradient's blocks."""

    @staticmethod
    def forward(ctx, t, mesh, group, dim):
        ctx.mesh, ctx.group, ctx.dim = mesh, group, dim
        return scatter_group(t, mesh, group, dim)

    @staticmethod
    def backward(ctx, g):
        return gather_group(g, ctx.mesh, ctx.group, ctx.dim), None, None, \
            None


def reduce_scatter_grad(t, mesh, group, dim: int):
    """This rank's block along ``dim`` of ``t`` summed over ``group``
    (autograd: the gradient's blocks are all-gathered back)."""
    return _ReduceScatter.apply(t, mesh, group, dim)


class _AllReduce(torch.autograd.Function):
    """Sum all-reduce of ``t`` over ``group``; the backward is its
    adjoint, the sum all-reduce of the gradient."""

    @staticmethod
    def forward(ctx, t, mesh, group):
        ctx.mesh, ctx.group = mesh, group
        out = t.contiguous().clone()
        mesh.all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.contiguous().clone()
        ctx.mesh.all_reduce(out, ctx.group)
        return out, None, None


def all_reduce_grad(t, mesh, group):
    """``t`` summed over ``group`` (autograd: the gradient is summed over
    the group too)."""
    return _AllReduce.apply(t, mesh, group)
