"""Pipeline parallelism over the ``pp`` axis of a live mesh.

Port of ``paddle_tpu/parallel/pipelining.py``.  Per-stage parameters are
stacked on a leading axis and cut over ``pp``, so each rank holds its
stage; micro-batch activations advance one stage per tick by one
``ppermute`` (``compat.py``).

- ``pipeline_apply``: GPipe dataflow over m + p - 1 ticks, differentiable
  by autograd (the backward runs the ticks in reverse, one transposed
  ``ppermute`` each).  Every rank runs the same ops in the same order:
  stage 0 takes its feed through ``torch.where`` (the value that arrived
  from the last stage stays in its graph with a zero gradient) and the
  last stage writes its outputs through a mask, as the JAX loop does, so
  that each ``ppermute``'s backward runs on every rank or on none.  A rank
  that dropped a received value by a Python branch would skip that
  ``ppermute``'s backward send and receive, and its peer would wait.
- ``pipeline_train_step``: one forward and backward over micro-batches
  under an explicit schedule (``schedules.py``'s static tables).  Each
  tick this rank runs its table entry (FWD, BWD, BWDX, BWDW or nothing), a
  Python branch, then exactly one raw ``ppermute`` to the right and one to
  the left, on every rank whatever its op.  The backward ops recompute the
  stage from the stashed input and take ``torch.autograd.grad`` (per-op
  remat).  Collectives inside a stage (``mp``, ``sep``) are safe in the
  branches: the members of their groups share the pp coordinate and so run
  the same table row.  Collectives over ``sharding`` are not, so the
  hybrid step gathers those weights once before the schedule.  The loss
  head runs only where its stage lives (the last global stage), which the
  JAX executor runs on every rank for its SPMD uniformity.
- the stage stacking helpers, unchanged from JAX's.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils import _pytree as pytree

from .compat import _ppermute_raw, _size, all_reduce_raw, ppermute


def pipeline_apply(stage_fn: Callable, stage_params: Any, x: torch.Tensor,
                   axis: str = "pp", num_microbatches: Optional[int] = None,
                   squeeze_stage_dim: bool = True, *, mesh) -> torch.Tensor:
    """Run a P-stage pipeline over ``axis`` of the live ``mesh`` (mirror of
    ``pipeline_apply``).

    stage_fn(params, activation) -> activation, one stage's compute.
    stage_params: this rank's stage slice of the stacked parameters (a
        pytree whose leaves lead with 1; ``squeeze_stage_dim=False`` keeps
        a meaningful leading dim, e.g. the [L/P, ...] layer stacks the
        stage loops over).
    x: [M, mb, ...] micro-batches, the same on every rank (stage 0 reads
        them).
    Returns [M, mb, ...]: the outputs on the last stage, zeros elsewhere.
    """
    p, me = _size(mesh, axis), mesh.axis_index(axis)
    m = x.shape[0] if num_microbatches is None else num_microbatches
    perm = [(i, (i + 1) % p) for i in range(p)]
    params = pytree.tree_map(lambda a: a[0], stage_params) \
        if squeeze_stage_dim else stage_params
    # factory ops, not tensor literals: a capture on fake tensors records
    # them and allocates nothing
    first = torch.full((), me == 0, dtype=torch.bool, device=x.device)
    last = torch.full((), me == p - 1, dtype=torch.bool, device=x.device)
    state = torch.zeros_like(x[0])
    outs = [torch.zeros_like(x[0]) for _ in range(m)]
    for t in range(m + p - 1):
        # stage 0 ingests micro-batch t (while there is one); the others
        # take what arrived from the left neighbour
        inp = torch.where(first, x[min(t, m - 1)], state)
        out = stage_fn(params, inp)
        emit = t - (p - 1)
        if emit >= 0:           # the last stage emits micro-batch t - (p-1)
            outs[emit] = torch.where(last, out.to(x.dtype), outs[emit])
        if t + 1 < m + p - 1:
            state = ppermute(out, axis, perm, mesh=mesh)
    return torch.stack(outs)


def stack_stage_params(per_stage_params: list) -> Any:
    """Stack a list of per-stage param pytrees into [P, ...] leaves."""
    return pytree.tree_map(lambda *xs: torch.stack(xs, dim=0),
                           *per_stage_params)


def device_major_order(sched):
    """Placement-aware device-major position list of a Schedule: stacked
    position r*v + j holds global stage ``sched.stage_of(r, j)``
    (Megatron-interleaved for VPP, zigzag for ZBV).  Returns (order,
    inverse) as ``vpp_device_major_order``."""
    p, v = sched.p, sched.v
    order = [sched.stage_of(r, j) for r in range(p) for j in range(v)]
    inv = [0] * (p * v)
    for pos, st in enumerate(order):
        inv[st] = pos
    return order, inv


def vpp_device_major_order(p: int, v: int):
    """Megatron VPP placement as a position list: stacked position r*v + j
    holds global stage j*p + r, so cutting dim 0 over ``pp`` hands rank r
    its chunks in chunk order.  (order, inverse): ``stacked[i] =
    stages[order[i]]`` and ``stages[s] = stacked[inverse[s]]``."""
    order = [j * p + r for r in range(p) for j in range(v)]
    inv = [0] * (p * v)
    for pos, st in enumerate(order):
        inv[st] = pos
    return order, inv


def stack_stage_params_interleaved(per_stage_params: list, p: int) -> Any:
    """Stack per-GLOBAL-stage params for a VPP run in the device-major
    order of ``vpp_device_major_order``."""
    n = len(per_stage_params)
    assert n % p == 0, f"{n} stages not divisible by {p} ranks"
    order, _ = vpp_device_major_order(p, n // p)
    return pytree.tree_map(
        lambda *xs: torch.stack([xs[i] for i in order], dim=0),
        *per_stage_params)


# --------------------------------------------------------------------------
# the schedule executor (1F1B / VPP / zero-bubble / FThenB)
# --------------------------------------------------------------------------


def _grad_leaves(tree):
    """Detached copies of ``tree``'s leaves that take a gradient."""
    return pytree.tree_map(lambda a: a.detach().requires_grad_(True), tree)


def pipeline_train_step(stage_fn: Callable, loss_fn: Callable, sched,
                        stage_params: Any, x: torch.Tensor, y: torch.Tensor,
                        axis: str = "pp", loss_params: Any = None,
                        want_x_grad: bool = False, *, mesh):
    """One forward and backward over micro-batches under the schedule
    ``sched`` (mirror of ``pipeline_train_step``).  Returns (mean_loss,
    param_grads[, loss_param_grads][, x_grads]), each replicated over
    ``axis``: the loss as an fp32 scalar, the grads fp32 in
    ``stage_params``' layout.

    stage_fn(chunk_params, act) -> act (uniform activation shapes);
    loss_fn(act, y_mb) -> scalar at the last global stage, or with
    ``loss_params`` (the head closed into the loss: final norm, LM head)
    ``loss_fn(loss_params, act, y_mb)``, whose grads come back too;
    ``want_x_grad``: the [m, ...] gradient w.r.t. the stage-0 input (an
    embedding outside the pipeline needs it).
    stage_params: a pytree whose leaves lead with this rank's v chunks;
    x, y: [m, ...] micro-batched inputs and targets, the same on every
    rank.  The stash holds ``sched.num_slots`` activations and as many
    upstream gradients."""
    from .schedules import BWD, BWDW, BWDX, CH_NONE, FWD

    p, me = _size(mesh, axis), mesh.axis_index(axis)
    if p != sched.p:
        raise ValueError(f"schedule built for p={sched.p}, mesh has {p}")
    m, v = sched.m, sched.v
    perm_r = [(i, (i + 1) % p) for i in range(p)]
    perm_l = [(i, (i - 1) % p) for i in range(p)]
    act_shape, act_dtype, dev = tuple(x.shape[1:]), x.dtype, x.device
    S = sched.num_slots
    stash = [None] * S
    gin = [None] * S
    carries = [None] * 3

    def zero_act():
        return torch.zeros(act_shape, dtype=act_dtype, device=dev)

    gacc = pytree.tree_map(
        lambda a: torch.zeros(a.shape, dtype=torch.float32, device=a.device),
        stage_params)
    lacc = None if loss_params is None else pytree.tree_map(
        lambda a: torch.zeros(a.shape, dtype=torch.float32, device=a.device),
        loss_params)
    dxs = [zero_act() for _ in range(m)] if want_x_grad else None
    loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
    is_last = me == sched.rank_of_stage(p * v - 1)
    is_first = me == sched.rank_of_stage(0)

    def chunk(ch):
        return pytree.tree_map(lambda a: a[ch], stage_params)

    def accum(tree, ch, grads):
        for acc, g in zip(pytree.tree_leaves(tree), grads):
            acc[ch] += g.float()

    def loss_grad(out, y_mb, g_up, last_here):
        """(upstream grad at this op's stage, loss share): the loss's
        gradient at the last global stage (head grads added into
        ``lacc``), else the stashed arrival."""
        nonlocal lacc
        if not last_here:
            return g_up, None
        o = out.detach().requires_grad_(True)
        with torch.enable_grad():
            if loss_params is not None:
                lp = _grad_leaves(loss_params)
                l = loss_fn(lp, o, y_mb)
                gs = torch.autograd.grad(l / m, [o] + pytree.tree_leaves(lp))
                for acc, d in zip(pytree.tree_leaves(lacc), gs[1:]):
                    acc += d.float()
            else:
                l = loss_fn(o, y_mb)
                gs = torch.autograd.grad(l / m, [o])
        return gs[0].to(act_dtype), (l / m).detach().float()

    for t in range(sched.ticks):
        # 1) this tick's arrivals (what the channels delivered last tick):
        # an activation into the stash, an upstream grad into the grad
        # buffer
        for c in range(3):
            if sched.recv_mask[c, me, t]:
                sl_ = int(sched.recv_slot[c, me, t])
                if sched.recv_isact[c, me, t]:
                    stash[sl_] = carries[c]
                else:
                    gin[sl_] = carries[c]
        k = int(sched.kind[me, t])
        mb = max(int(sched.mb[me, t]), 0)
        ch = int(sched.chunk[me, t])
        sl = int(sched.slot[me, t])
        first_here = is_first and ch == 0
        last_here = is_last and ch == v - 1
        fsend = bsend = None
        if k == FWD:
            inp = x[mb].to(act_dtype) if first_here else stash[sl]
            stash[sl] = inp               # the stage-0 path stores x[mb]
            with torch.no_grad():
                fsend = stage_fn(chunk(ch), inp).to(act_dtype)
        elif k in (BWD, BWDX, BWDW):
            pc = _grad_leaves(chunk(ch))
            inp = stash[sl].detach().requires_grad_(k != BWDW)
            with torch.enable_grad():
                out = stage_fn(pc, inp)
            if k == BWDW:
                gs = torch.autograd.grad(out, pytree.tree_leaves(pc), gin[sl])
                accum(gacc, ch, gs)
            else:
                g, l = loss_grad(out, y[mb], gin[sl], last_here)
                if l is not None:
                    loss_acc = loss_acc + l
                want = [inp] + (pytree.tree_leaves(pc) if k == BWD else [])
                gs = torch.autograd.grad(out, want, g)
                if k == BWD:
                    accum(gacc, ch, gs[1:])
                else:
                    gin[sl] = g         # the last stage keeps g for BWDW
                bsend = gs[0].to(act_dtype)
                if want_x_grad and first_here:
                    dxs[mb] = bsend
        # 2) route the op's outputs onto their channels (right, left,
        # local), zeros where nothing departs: one exchange per direction
        # per tick on every rank
        sends = [zero_act() for _ in range(3)]
        adir, gdir = int(sched.asend_ch[me, t]), int(sched.gsend_ch[me, t])
        if fsend is not None and adir != CH_NONE:
            sends[adir] = fsend
        if bsend is not None and gdir != CH_NONE:
            sends[gdir] = sends[gdir] + bsend
        carries = [_ppermute_raw(sends[0], axis, perm_r, mesh),
                   _ppermute_raw(sends[1], axis, perm_l, mesh), sends[2]]
    # the loss, the head grads and the input grads live on one rank each:
    # share them over the axis
    loss = all_reduce_raw(loss_acc if is_last else torch.zeros_like(loss_acc),
                          axis, mesh)
    out = [loss, gacc]
    if loss_params is not None:
        out.append(pytree.tree_map(
            lambda a: all_reduce_raw(a if is_last else torch.zeros_like(a),
                                     axis, mesh), lacc))
    if want_x_grad:
        d = torch.stack(dxs)
        out.append(all_reduce_raw(d if is_first else torch.zeros_like(d),
                                  axis, mesh))
    return tuple(out)


__all__ = ["device_major_order", "pipeline_apply", "pipeline_train_step",
           "stack_stage_params", "stack_stage_params_interleaved",
           "vpp_device_major_order"]
