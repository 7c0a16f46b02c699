"""Collectives over one named mesh axis, with their transposes.

Port of ``paddle_tpu/parallel/compat.py``: ``ppermute``, ``psum``,
``all_to_all``, ``psum_scatter`` and ``all_gather`` over the process group
of one axis of a live ``specs.Mesh`` (the ``mesh=`` argument).  Each is a ``torch.autograd.Function`` whose
backward is the transposed collective, as JAX transposes them:

- ``all_gather`` and ``psum_scatter`` transpose into each other;
- ``psum`` of a replicated cotangent is the identity; ``pbroadcast`` is
  its twin, an identity whose backward is ``psum`` (the input of a
  column-parallel projection);
- ``ppermute`` transposes into the inverse permutation;
- ``all_to_all`` transposes into the one with split and concat swapped.

An axis of size 1 is a no-op, as GSPMD compiles no collective for it.  The
JAX module promotes bf16 reductions to fp32 on the CPU backend; so does
this one on gloo.  The ``*_raw`` helpers are the same collectives without
autograd, for code that runs under ``no_grad`` (the optimizer's layout
transforms, ``ShardedTensor.full``).
"""

from __future__ import annotations

import warnings
from typing import Sequence, Tuple

import torch
import torch.distributed as dist


def _size(mesh, axis: str) -> int:
    return int(mesh.shape.get(axis, 1))


def _promoted(x: torch.Tensor, group) -> torch.Tensor:
    if x.dtype == torch.bfloat16 and dist.get_backend(group) == "gloo":
        return x.float()
    return x


def _quiet(fn, *args, **kwargs):
    # torch 2.13 marks all_gather_into_tensor / reduce_scatter_tensor as
    # deprecated; the CUDA machine's torch 2.11 has no successor names
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*is deprecated.*")
        return fn(*args, **kwargs)


# ------------------------------------------------------------- raw forms

def all_reduce_raw(x: torch.Tensor, axis: str, mesh, op=None
                   ) -> torch.Tensor:
    """Sum (or ``op``) over ``axis``; a new tensor."""
    if _size(mesh, axis) <= 1:
        return x
    group = mesh.group(axis)
    y = _promoted(x, group).clone()
    dist.all_reduce(y, op=op or dist.ReduceOp.SUM, group=group)
    return y.to(x.dtype)


def all_gather_raw(x: torch.Tensor, axis: str, dim: int, mesh
                   ) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in coordinate order."""
    n = _size(mesh, axis)
    if n <= 1:
        return x
    dim = dim % x.dim()
    shape = tuple(x.shape)
    buf = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    _quiet(dist.all_gather_into_tensor, buf, x.contiguous().reshape(-1),
           group=mesh.group(axis))
    buf = buf.reshape((n,) + shape)
    return buf.movedim(0, dim).reshape(
        shape[:dim] + (n * shape[dim],) + shape[dim + 1:])


def reduce_scatter_raw(x: torch.Tensor, axis: str, dim: int, mesh
                       ) -> torch.Tensor:
    """Sum over ``axis`` and keep this rank's block of ``dim``."""
    n = _size(mesh, axis)
    if n <= 1:
        return x
    dim = dim % x.dim()
    shape = tuple(x.shape)
    if shape[dim] % n:
        raise ValueError(f"psum_scatter: dim {dim} of {shape} does not split "
                         f"over {axis}={n}")
    group = mesh.group(axis)
    src = _promoted(x, group)
    blk = shape[dim] // n
    src = src.reshape(shape[:dim] + (n, blk) + shape[dim + 1:]) \
        .movedim(dim, 0).contiguous()
    out = torch.empty(src[0].numel(), dtype=src.dtype, device=src.device)
    _quiet(dist.reduce_scatter_tensor, out, src.reshape(-1), group=group)
    return out.reshape(src.shape[1:]).to(x.dtype)


def _all_to_all_raw(x, axis, split_axis, concat_axis, mesh, tiled):
    n = _size(mesh, axis)
    split_axis %= x.dim()
    shape = tuple(x.shape)
    if tiled:
        if n <= 1:
            return x
        if shape[split_axis] % n:
            raise ValueError(f"all_to_all: dim {split_axis} of {shape} does "
                             f"not split over {axis}={n}")
        blk = shape[split_axis] // n
        blocks = x.reshape(shape[:split_axis] + (n, blk)
                           + shape[split_axis + 1:]).movedim(split_axis, 0)
    else:
        if shape[split_axis] != n:
            raise ValueError(f"untiled all_to_all: dim {split_axis} of "
                             f"{shape} must equal {axis}={n}")
        blocks = x.movedim(split_axis, 0)
    out = blocks.contiguous()
    if n > 1:
        src, out = out, torch.empty_like(out)
        dist.all_to_all_single(out, src, group=mesh.group(axis))
    # out[j] is the block coordinate j sent here
    if tiled:
        return torch.cat(out.unbind(0), dim=concat_axis)
    return out.movedim(0, concat_axis)


def _ppermute_raw(x, axis, perm, mesh):
    if _size(mesh, axis) <= 1:
        return x
    me = mesh.axis_index(axis)
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me:
            ops.append(dist.P2POp(dist.isend, x.contiguous(),
                                  mesh.peer(axis, dst)))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, out, mesh.peer(axis, src)))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


# ---------------------------------------------------------- the functions

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        ctx.meta = (axis, dim, mesh)
        return all_gather_raw(x, axis, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        axis, dim, mesh = ctx.meta
        return reduce_scatter_raw(g, axis, dim, mesh), None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        ctx.meta = (axis, dim, mesh)
        return reduce_scatter_raw(x, axis, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        axis, dim, mesh = ctx.meta
        return all_gather_raw(g, axis, dim, mesh), None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        return all_reduce_raw(x, axis, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PBroadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.meta = (axis, mesh)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        axis, mesh = ctx.meta
        return all_reduce_raw(g, axis, mesh), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_axis, concat_axis, tiled, mesh):
        ctx.meta = (axis, split_axis, concat_axis, tiled, mesh)
        return _all_to_all_raw(x, axis, split_axis, concat_axis, mesh, tiled)

    @staticmethod
    def backward(ctx, g):
        axis, split_axis, concat_axis, tiled, mesh = ctx.meta
        return (_all_to_all_raw(g, axis, concat_axis, split_axis, mesh,
                                tiled), None, None, None, None, None)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm, mesh):
        ctx.meta = (axis, perm, mesh)
        return _ppermute_raw(x, axis, perm, mesh)

    @staticmethod
    def backward(ctx, g):
        axis, perm, mesh = ctx.meta
        inverse = tuple((d, s) for s, d in perm)
        return _ppermute_raw(g, axis, inverse, mesh), None, None, None


def ppermute(x: torch.Tensor, axis_name: str,
             perm: Sequence[Tuple[int, int]], *, mesh) -> torch.Tensor:
    """Send this rank's ``x`` to coordinate ``dst`` for each ``(src, dst)``
    of ``perm``; a rank no pair sends to gets zeros."""
    perm = tuple(map(tuple, perm))
    if _size(mesh, axis_name) <= 1:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _PPermute.apply(x, axis_name, perm, mesh)


def psum(x: torch.Tensor, axis_name: str, *, mesh) -> torch.Tensor:
    """Sum over ``axis_name``; backward the identity."""
    if _size(mesh, axis_name) <= 1:
        return x
    return _Psum.apply(x, axis_name, mesh)


def pbroadcast(x: torch.Tensor, axis_name: str, *, mesh) -> torch.Tensor:
    """The identity; backward ``psum`` over ``axis_name``."""
    if _size(mesh, axis_name) <= 1:
        return x
    return _PBroadcast.apply(x, axis_name, mesh)


def all_to_all(x: torch.Tensor, axis_name: str, split_axis: int,
               concat_axis: int, *, tiled: bool = False, mesh
               ) -> torch.Tensor:
    """Split ``split_axis`` into one block per rank, send block j to
    coordinate j and lay the received blocks along ``concat_axis``.
    Untiled, ``split_axis`` must have the axis size and is removed, and the
    received blocks stack as a new ``concat_axis``."""
    return _AllToAll.apply(x, axis_name, split_axis, concat_axis, tiled,
                           mesh)


def psum_scatter(x: torch.Tensor, axis_name: str, *,
                 scatter_dimension: int = 0, tiled: bool = True, mesh
                 ) -> torch.Tensor:
    """Reduce-scatter: sum over ``axis_name`` and keep this rank's block of
    ``scatter_dimension`` (untiled: the dim has the axis size and is
    removed)."""
    y = x if _size(mesh, axis_name) <= 1 else \
        _PsumScatter.apply(x, axis_name, scatter_dimension, mesh)
    return y if tiled else y.squeeze(scatter_dimension)


def all_gather(x: torch.Tensor, axis_name: str, *, axis: int = 0,
               tiled: bool = True, mesh) -> torch.Tensor:
    """Every rank's ``x`` along ``axis`` in coordinate order (untiled: a new
    ``axis`` of the axis size)."""
    if not tiled:
        x = x.unsqueeze(axis)
    if _size(mesh, axis_name) <= 1:
        return x
    return _AllGather.apply(x, axis_name, axis, mesh)


__all__ = ["all_gather", "all_to_all", "pbroadcast", "ppermute", "psum",
           "psum_scatter", "all_gather_raw", "all_reduce_raw",
           "reduce_scatter_raw"]
