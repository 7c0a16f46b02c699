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

``gather_blocks`` is the port's all-gather of a value every rank then
uses whole (the MoE router's probabilities, the EP block's stats rows,
GPT-MoE's embedding hidden blocks): its cotangent is complete on every
rank, so its backward keeps this rank's block of it, where
``all_gather``'s reduce-scatters a partial one.

``psum``, ``psum_scatter``, ``all_gather`` and ``all_to_all`` (and their
raw forms) take ``axis_index_groups``, a partition of the axis's positions:
each group reduces or gathers within itself, as ``lax.psum(...,
axis_index_groups=)`` does, and the transposes keep the groups.  A group is
a torch process group over this rank's line of the axis, made once per
group list by ``Mesh.create_index_groups`` (a collective over the world);
a group of one rank is a no-op.

An axis of size 1 is a no-op, as GSPMD compiles no collective for it.  The
JAX module promotes bf16 reductions to fp32 on the CPU backend; so does
this one on gloo.  The ``*_raw`` helpers are the same collectives without
autograd, for code that runs under ``no_grad`` (the optimizer's layout
transforms, ``ShardedTensor.full``, the overlap engine's bucket
transport); with ``async_op=True`` they return a ``Pending`` whose
``wait()`` gives the value.
"""

from __future__ import annotations

import warnings
from typing import Callable, Sequence, Tuple

import numpy as np
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

class Pending:
    """A collective issued with ``async_op=True``: ``wait()`` waits its
    ``Work`` and returns the value, after the steps chained with ``then``
    (a reshape, a cast back from the promoted dtype, a decode).  Nothing
    may read the buffer before ``wait()``: on NCCL the collective still
    runs on its own stream, on gloo on its own thread."""

    def __init__(self, work, value, post=None):
        self._work = work
        self._value = value
        self._posts = [post] if post is not None else []

    def then(self, fn: Callable) -> "Pending":
        """Run ``fn`` on the value after the wait (in place; returns
        self)."""
        self._posts.append(fn)
        return self

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        value = self._value
        for fn in self._posts:
            value = fn(value)
        self._value, self._posts = value, []
        return value


def _issue(call, buf, post, async_op: bool):
    """Run ``call(async_op)`` (the ``torch.distributed`` call writing
    ``buf``) and return ``post(buf)``, or a ``Pending`` of it."""
    work = call(async_op)
    if async_op:
        return Pending(work, buf, post)
    return post(buf)


def _ready(x: torch.Tensor, async_op: bool):
    """The value of a collective that moves nothing (an axis or a group of
    one rank)."""
    return Pending(None, x) if async_op else x


def _grouping(mesh, axis: str, groups):
    """(process group, ranks, order) of a collective over ``axis``: the
    axis's group, or with ``groups`` (a partition of the axis's positions,
    ``lax``'s ``axis_index_groups``) this rank's group of them.  ``order``
    maps the group's k-th rank (ranks ascending, the process group's
    numbering) to its position in the listed group, None when they agree;
    a listed group of one rank has no process group."""
    if groups is None:
        return mesh.group(axis), _size(mesh, axis), None
    pg, members = mesh.index_group(axis, groups)
    n = len(members)
    if n <= 1:
        return None, 1, None
    order = [members.index(r) for r in sorted(members)]
    return pg, n, (None if order == list(range(n)) else order)


def all_reduce_raw(x: torch.Tensor, axis: str, mesh, op=None, *,
                   groups=None, async_op: bool = False):
    """Sum (or ``op``) over ``axis`` (within each group of ``groups``); a
    new tensor."""
    if _size(mesh, axis) <= 1:
        return _ready(x, async_op)
    group, n, _ = _grouping(mesh, axis, groups)
    if n <= 1:
        return _ready(x, async_op)
    y = _promoted(x, group).clone()
    return _issue(lambda a: dist.all_reduce(
        y, op=op or dist.ReduceOp.SUM, group=group, async_op=a),
        y, lambda t: t.to(x.dtype), async_op)


def all_gather_raw(x: torch.Tensor, axis: str, dim: int, mesh, *,
                   groups=None, async_op: bool = False):
    """Concatenate every rank's ``x`` along ``dim`` in coordinate order
    (with ``groups``, in the order the group lists its positions)."""
    if _size(mesh, axis) <= 1:
        return _ready(x, async_op)
    group, n, order = _grouping(mesh, axis, groups)
    if n <= 1:
        return _ready(x, async_op)
    dim = dim % x.dim()
    shape = tuple(x.shape)
    buf = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    src = x.contiguous().reshape(-1)

    def post(b):
        b = b.reshape((n,) + shape)
        if order is not None:
            b = b[torch.as_tensor(np.argsort(order)).to(b.device)]
        return b.movedim(0, dim).reshape(
            shape[:dim] + (n * shape[dim],) + shape[dim + 1:])

    return _issue(lambda a: _quiet(dist.all_gather_into_tensor, buf, src,
                                   group=group, async_op=a),
                  buf, post, async_op)


def reduce_scatter_raw(x: torch.Tensor, axis: str, dim: int, mesh, *,
                       groups=None, async_op: bool = False):
    """Sum over ``axis`` and keep this rank's block of ``dim`` (with
    ``groups``: within each group, the block of this rank's position in
    it)."""
    if _size(mesh, axis) <= 1:
        return _ready(x, async_op)
    group, n, order = _grouping(mesh, axis, groups)
    if n <= 1:
        return _ready(x, async_op)
    dim = dim % x.dim()
    shape = tuple(x.shape)
    if shape[dim] % n:
        raise ValueError(f"psum_scatter: dim {dim} of {shape} does not split "
                         f"over {axis}={n}")
    src = _promoted(x, group)
    blk = shape[dim] // n
    src = src.reshape(shape[:dim] + (n, blk) + shape[dim + 1:]) \
        .movedim(dim, 0)
    if order is not None:
        src = src[torch.as_tensor(order).to(src.device)]
    src = src.contiguous()
    out = torch.empty(src[0].numel(), dtype=src.dtype, device=src.device)
    return _issue(lambda a: _quiet(dist.reduce_scatter_tensor, out,
                                   src.reshape(-1), group=group, async_op=a),
                  out, lambda t: t.reshape(src.shape[1:]).to(x.dtype),
                  async_op)


def _all_to_all_raw(x, axis, split_axis, concat_axis, mesh, tiled,
                    groups=None, async_op=False):
    n = _size(mesh, axis)
    group, order = None, None
    if n > 1:
        group, n, order = _grouping(mesh, axis, groups)
    split_axis %= x.dim()
    shape = tuple(x.shape)
    if tiled:
        if n <= 1:
            return _ready(x, async_op)
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
    if order is not None:
        blocks = blocks[torch.as_tensor(order).to(blocks.device)]
    src = blocks.contiguous()

    def post(out):
        # out[j] is the block the j-th listed member sent here
        if order is not None:
            out = out[torch.as_tensor(np.argsort(order)).to(out.device)]
        if tiled:
            return torch.cat(out.unbind(0), dim=concat_axis)
        return out.movedim(0, concat_axis)

    if n <= 1:
        return _ready(post(src), async_op)
    out = torch.empty_like(src)
    return _issue(lambda a: dist.all_to_all_single(out, src, group=group,
                                                   async_op=a),
                  out, post, async_op)


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
    def forward(ctx, x, axis, dim, mesh, groups):
        ctx.meta = (axis, dim, mesh, groups)
        return all_gather_raw(x, axis, dim, mesh, groups=groups)

    @staticmethod
    def backward(ctx, g):
        axis, dim, mesh, groups = ctx.meta
        return (reduce_scatter_raw(g, axis, dim, mesh, groups=groups),
                None, None, None, None)


class _GatherBlock(torch.autograd.Function):
    """All-gather of a block whose gathered value every rank uses whole:
    the backward keeps this rank's block of the (complete) cotangent."""

    @staticmethod
    def forward(ctx, x, axis, dim, mesh):
        ctx.meta = (dim, mesh.axis_index(axis) * x.shape[dim], x.shape[dim])
        return all_gather_raw(x, axis, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        dim, start, n = ctx.meta
        return g.narrow(dim, start, n), None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, mesh, groups):
        ctx.meta = (axis, dim, mesh, groups)
        return reduce_scatter_raw(x, axis, dim, mesh, groups=groups)

    @staticmethod
    def backward(ctx, g):
        axis, dim, mesh, groups = ctx.meta
        return (all_gather_raw(g, axis, dim, mesh, groups=groups),
                None, None, None, None)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, groups):
        return all_reduce_raw(x, axis, mesh, groups=groups)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


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
    def forward(ctx, x, axis, split_axis, concat_axis, tiled, mesh, groups):
        ctx.meta = (axis, split_axis, concat_axis, tiled, mesh, groups)
        return _all_to_all_raw(x, axis, split_axis, concat_axis, mesh, tiled,
                               groups)

    @staticmethod
    def backward(ctx, g):
        axis, split_axis, concat_axis, tiled, mesh, groups = ctx.meta
        return (_all_to_all_raw(g, axis, concat_axis, split_axis, mesh,
                                tiled, groups),
                None, None, None, None, None, None)


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


def _norm_groups(groups):
    return None if groups is None else tuple(tuple(int(p) for p in g)
                                             for g in groups)


def ppermute(x: torch.Tensor, axis_name: str,
             perm: Sequence[Tuple[int, int]], *, mesh) -> torch.Tensor:
    """Send this rank's ``x`` to coordinate ``dst`` for each ``(src, dst)``
    of ``perm``; a rank no pair sends to gets zeros."""
    perm = tuple(map(tuple, perm))
    if _size(mesh, axis_name) <= 1:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _PPermute.apply(x, axis_name, perm, mesh)


def psum(x: torch.Tensor, axis_name: str, *, mesh,
         axis_index_groups=None) -> torch.Tensor:
    """Sum over ``axis_name`` (within each group of ``axis_index_groups``,
    a partition of the axis's positions); backward the identity."""
    if _size(mesh, axis_name) <= 1:
        return x
    return _Psum.apply(x, axis_name, mesh, _norm_groups(axis_index_groups))


def pbroadcast(x: torch.Tensor, axis_name: str, *, mesh) -> torch.Tensor:
    """The identity; backward ``psum`` over ``axis_name``."""
    if _size(mesh, axis_name) <= 1:
        return x
    return _PBroadcast.apply(x, axis_name, mesh)


def all_to_all(x: torch.Tensor, axis_name: str, split_axis: int,
               concat_axis: int, *, tiled: bool = False, mesh,
               axis_index_groups=None) -> torch.Tensor:
    """Split ``split_axis`` into one block per rank, send block j to
    coordinate j (with ``axis_index_groups``: to the j-th position of this
    rank's group) and lay the received blocks along ``concat_axis``.
    Untiled, ``split_axis`` must have the axis (group) size and is removed,
    and the received blocks stack as a new ``concat_axis``."""
    return _AllToAll.apply(x, axis_name, split_axis, concat_axis, tiled,
                           mesh, _norm_groups(axis_index_groups))


def psum_scatter(x: torch.Tensor, axis_name: str, *,
                 scatter_dimension: int = 0, tiled: bool = True, mesh,
                 axis_index_groups=None) -> torch.Tensor:
    """Reduce-scatter: sum over ``axis_name`` and keep this rank's block of
    ``scatter_dimension`` (untiled: the dim has the axis size and is
    removed); with ``axis_index_groups``, within this rank's group."""
    y = x if _size(mesh, axis_name) <= 1 else \
        _PsumScatter.apply(x, axis_name, scatter_dimension, mesh,
                           _norm_groups(axis_index_groups))
    return y if tiled else y.squeeze(scatter_dimension)


def all_gather(x: torch.Tensor, axis_name: str, *, axis: int = 0,
               tiled: bool = True, mesh, axis_index_groups=None
               ) -> torch.Tensor:
    """Every rank's ``x`` along ``axis`` in coordinate order (untiled: a new
    ``axis`` of the axis size); with ``axis_index_groups``, every rank of
    this rank's group, in the group's order."""
    if not tiled:
        x = x.unsqueeze(axis)
    if _size(mesh, axis_name) <= 1:
        return x
    return _AllGather.apply(x, axis_name, axis, mesh,
                            _norm_groups(axis_index_groups))


def gather_blocks(x: torch.Tensor, axes: Sequence[str], *, dim: int = 0,
                  mesh) -> torch.Tensor:
    """Every rank's block of ``dim`` along ``axes``, in block order
    (row-major over ``axes``, the first axis major), on every rank: one
    all-gather per axis, the innermost first.  The result is a replicated
    value (every rank uses all of it), so each rank's backward keeps its
    own block of the cotangent."""
    for a in reversed(tuple(axes)):
        if _size(mesh, a) > 1:
            x = _GatherBlock.apply(x, a, dim % x.dim(), mesh)
    return x


__all__ = ["Pending", "all_gather", "all_to_all", "gather_blocks",
           "pbroadcast", "ppermute", "psum", "psum_scatter",
           "all_gather_raw", "all_reduce_raw", "reduce_scatter_raw"]
