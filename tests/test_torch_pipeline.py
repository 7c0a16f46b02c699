"""Pipeline parallelism of the port (paddle_tpu_torch/parallel/schedules.py,
pipelining.py and incubate/distributed/models/moe/pipelined.py) against
the JAX package on the CPU.

- The schedule tables are the port's own copy of the numpy module: every
  field of every table, ``simulate_cost`` and ``rank_schedules`` equal
  JAX's for the sizes tests/test_pipeline_schedules.py uses (in-process).
- Gangs as tests/test_torch_mesh_train.py's (one ``torch.multiprocessing``
  spawn of gloo ranks per test run, a ``FileStore`` rendezvous, ranks that
  import torch and paddle_tpu_torch only, npz results):
  ``pp2``: ``pipeline_train_step`` under 1F1B on 2 ranks, with and without
  the loss-params and x-grad channels; ``pp4``: ``pipeline_apply`` at the
  shapes of tests/test_parallel.py:118-150 with gradients, and the five
  schedules at tests/test_pipeline_schedules.py's (p 4, m 8);
  ``moe8``: the pipelined MoE forwards on (pp, ep, mp) = (2, 2, 2) as in
  tests/test_gpt_moe.py:279-327.
- Each is held against the JAX function under ``shard_map`` on the
  conftest's virtual CPU devices (and the sequential references) within
  fp32 1e-5 of the largest magnitude unless stated.
"""

from __future__ import annotations

import math
import os

import numpy as np
import pytest
import torch
from torch_gang import file_store, run_gang

TOL = 1e-5
# pipeline_apply: tests/test_parallel.py's P, M, MB, D
AP_P, AP_M, AP_MB, AP_D = 4, 8, 4, 16
# the executor: tests/test_pipeline_schedules.py's sizes
EX_M, EX_MB, EX_DIM = 8, 2, 16
SCHEDULES4 = [("FThenB", 1), ("1F1B", 1), ("ZBH1", 1), ("VPP", 2),
              ("ZBV", 2)]
TWO_M = 4                 # micro-batches of the 2-rank 1F1B executor


# --------------------------------------------------------------- schedules

def _schedule_sizes():
    """(name, p, m, v) of every table tests/test_pipeline_schedules.py
    builds."""
    out = {(n, 4, 8, v) for n, v in SCHEDULES4}
    for p in (2, 3, 4):
        for m in (p, 2 * p + 1):
            for n, v in (("FThenB", 1), ("1F1B", 1), ("ZBH1", 1),
                         ("VPP", 2)):
                out.add((n, p, m, v))
    for p, m in ((4, 8), (4, 16), (8, 16), (8, 32)):
        out |= {("ZBV", p, m, 2), ("ZBH1", p, m, 1)}
    for p, m in ((4, 8), (4, 16), (8, 8)):
        out |= {("FThenB", p, m, 1), ("1F1B", p, m, 1)}
    out |= {("1F1B", 2, TWO_M, 1), ("FThenB", 2, 4, 1)}
    return sorted(out)


FIELDS = ("kind", "mb", "chunk", "slot", "recv_slot", "recv_mask",
          "recv_isact", "asend_ch", "gsend_ch")


@pytest.mark.parametrize("name,p,m,v", _schedule_sizes())
def test_schedule_tables_equal_jax(name, p, m, v):
    from paddle_tpu.parallel import schedules as J

    from paddle_tpu_torch.parallel import schedules as T

    a, b = T.build_schedule(name, p, m, v), J.build_schedule(name, p, m, v)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
        assert getattr(a, f).dtype == getattr(b, f).dtype, f
    assert (a.num_slots, a.placement, a.ticks, a.bubbles, a.render()) == \
        (b.num_slots, b.placement, b.ticks, b.bubbles, b.render())
    assert [a.stage_of(r, c) for r in range(p) for c in range(a.v)] == \
        [b.stage_of(r, c) for r in range(p) for c in range(b.v)]
    for kw in ({}, {"t_f": 0.5, "t_b": 1.0, "t_w": 0.5},
               {"t_f": 1.0, "t_b": 2.2, "t_w": 0.9, "t_p2p": 0.5}):
        assert T.simulate_cost(a, **kw) .__dict__ == \
            J.simulate_cost(b, **kw).__dict__, kw


@pytest.mark.parametrize("p,m,kw", [
    (4, 8, {"t_f": 1.0, "t_b": 2.0}), (4, 16, {"t_f": 1.0, "t_b": 2.0}),
    (8, 8, {"t_f": 1.0, "t_b": 2.0}),
    (4, 8, {"t_f": 1.0, "t_b": 2.0, "t_p2p": 0.5}),
    (4, 8, {"t_f": 1.0, "t_b": 2.2, "t_w": 0.9}), (2, 4, {"t_f": 1.0}),
    (4, 8, {"t_f": 1.0, "v": 1})])
def test_rank_schedules_equal_jax(p, m, kw):
    from paddle_tpu.parallel import schedules as J

    from paddle_tpu_torch.parallel import schedules as T

    assert [c.__dict__ for c in T.rank_schedules(p, m, **kw)] == \
        [c.__dict__ for c in J.rank_schedules(p, m, **kw)]


def test_schedule_errors_match_jax():
    from paddle_tpu_torch.parallel.schedules import build_schedule

    for args, match in ((("nope", 2, 2), "unknown schedule"),
                        (("1F1B", 2, 4, 2), "requires v=1"),
                        (("VPP", 2, 4, 1), "v >= 2")):
        with pytest.raises(ValueError, match=match):
            build_schedule(*args)


def test_stage_stacking_equals_jax():
    """``device_major_order`` (VPP and ZBV placements),
    ``vpp_device_major_order`` and the two stacking helpers put every
    stage where JAX's do."""
    import jax.numpy as jnp

    from paddle_tpu.parallel import pipelining as J
    from paddle_tpu.parallel.schedules import build_schedule as jbuild

    from paddle_tpu_torch.parallel import pipelining as T
    from paddle_tpu_torch.parallel.schedules import build_schedule

    for name in ("VPP", "ZBV", "1F1B"):
        v = 1 if name == "1F1B" else 2
        assert T.device_major_order(build_schedule(name, 4, 8, v)) == \
            J.device_major_order(jbuild(name, 4, 8, v))
    assert T.vpp_device_major_order(3, 2) == J.vpp_device_major_order(3, 2)
    stages = [{"w": np.full((2, 2), s, np.float32)} for s in range(6)]
    for p in (2, 3):
        got = T.stack_stage_params_interleaved(
            [{"w": torch.from_numpy(d["w"])} for d in stages], p)["w"]
        want = J.stack_stage_params_interleaved(
            [{"w": jnp.asarray(d["w"])} for d in stages], p)["w"]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        T.stack_stage_params([{"w": torch.from_numpy(d["w"])}
                              for d in stages])["w"].numpy(),
        np.asarray(J.stack_stage_params([{"w": jnp.asarray(d["w"])}
                                         for d in stages])["w"]))


# --------------------------------------------------------------- the gangs

def _mesh(root, world, rank, shape, names):
    from paddle_tpu_torch.parallel import init_mesh

    return init_mesh("cpu", shape, names, store=file_store(root, world),
                     rank=rank, world_size=world)


def _apply_problem():
    rng = np.random.RandomState(2)
    ws = np.stack([rng.randn(AP_D, AP_D).astype(np.float32) * 0.3
                   for _ in range(AP_P)])
    x = rng.randn(AP_M, AP_MB, AP_D).astype(np.float32)
    cot = np.random.RandomState(12).randn(AP_M, AP_MB, AP_D).astype(
        np.float32)
    return ws, x, cot


def _exec_problem(nstage, m, with_head):
    """tests/test_pipeline_schedules.py's problem (seed 0) for ``nstage``
    stages and ``m`` micro-batches; with ``with_head`` a head matrix closed
    into the loss."""
    rng = np.random.RandomState(0)
    params = [{"w": rng.randn(EX_DIM, EX_DIM).astype(np.float32) * 0.4,
               "b": rng.randn(EX_DIM).astype(np.float32) * 0.1}
              for _ in range(nstage)]
    x = rng.randn(m, EX_MB, EX_DIM).astype(np.float32)
    y = rng.randn(m, EX_MB, EX_DIM).astype(np.float32)
    head = (np.random.RandomState(9).randn(EX_DIM, EX_DIM).astype(
        np.float32) * 0.3) if with_head else None
    return params, x, y, head


def _t_stage(params, a):
    return torch.tanh(a @ params["w"] + params["b"])


def _run_executor(mesh, name, p, m, v, with_head):
    """This rank's (loss, grads[, head grads, x grads]) of the schedule."""
    from paddle_tpu_torch.parallel.pipelining import (device_major_order,
                                                      pipeline_train_step)
    from paddle_tpu_torch.parallel.schedules import build_schedule

    sched = build_schedule(name, p, m, v)
    params, x, y, head = _exec_problem(p * sched.v, m, with_head)
    order, _ = device_major_order(sched)
    me = mesh.axis_index("pp")
    mine = [params[order[me * sched.v + j]] for j in range(sched.v)]
    sp = {k: torch.from_numpy(np.stack([d[k] for d in mine]))
          for k in ("w", "b")}
    if with_head:
        def loss_fn(lp, a, yy):
            return ((a @ lp["h"] - yy) ** 2).mean()
        res = pipeline_train_step(
            _t_stage, loss_fn, sched, sp, torch.from_numpy(x),
            torch.from_numpy(y), loss_params={"h": torch.from_numpy(head)},
            want_x_grad=True, mesh=mesh)
    else:
        res = pipeline_train_step(
            _t_stage, lambda a, yy: ((a - yy) ** 2).mean(), sched, sp,
            torch.from_numpy(x), torch.from_numpy(y), mesh=mesh)
    out = {"loss": res[0].numpy(), "gw": res[1]["w"].numpy(),
           "gb": res[1]["b"].numpy()}
    if with_head:
        out["gh"] = res[2]["h"].numpy()
        out["dx"] = res[3].numpy()
    return out


def _pp2_rank(rank, world, root):
    torch.set_num_threads(1)
    import torch.distributed as dist

    mesh = _mesh(root, world, rank, (world,), ("pp",))
    for head in (False, True):
        out = _run_executor(mesh, "1F1B", 2, TWO_M, 1, head)
        np.savez(os.path.join(root, f"ex.1F1B.{int(head)}.{rank}.npz"),
                 **out)
    dist.barrier()
    dist.destroy_process_group()


def _pp4_rank(rank, world, root):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import compat, pipeline_apply

    mesh = _mesh(root, world, rank, (world,), ("pp",))
    ws, x, cot = _apply_problem()
    w = torch.from_numpy(ws[rank:rank + 1].copy()).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    outs = pipeline_apply(lambda prm, a: torch.tanh(a @ prm["w"]),
                          {"w": w}, xt, axis="pp", mesh=mesh)
    last = float(rank == world - 1)
    h = compat.psum(outs * last, "pp", mesh=mesh)
    gw, gx = torch.autograd.grad(h, (w, xt), torch.from_numpy(cot))
    np.savez(os.path.join(root, f"apply.{rank}.npz"), out=h.detach().numpy(),
             gw=gw.numpy(), gx=gx.numpy())
    for name, v in SCHEDULES4:
        out = _run_executor(mesh, name, world, EX_M, v, False)
        np.savez(os.path.join(root, f"ex.{name}.0.{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


MOE_SHAPE = (2, 2, 2)


def _moe8_rank(rank, world, root):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from paddle_tpu_torch.incubate.distributed.models.moe import pipelined

    mesh = _mesh(root, world, rank, MOE_SHAPE, ("pp", "ep", "mp"))
    params = pipelined.init_pipelined_moe_params(
        mesh, num_layers=2, num_expert=4, d_model=8, d_hidden=16,
        device="cpu")
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 8, 8).astype(
        np.float32))
    out = {f"rest/{k}": v.local.numpy() for k, v in params.items()}
    out["fwd"] = pipelined.pipelined_moe_forward(params, x, mesh).numpy()
    out["fwd_ep"] = pipelined.pipelined_moe_forward_ep(params, x,
                                                       mesh).numpy()
    np.savez(os.path.join(root, f"moe.{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def pp2(tmp_path_factory):
    return run_gang("pipe_gang2", _pp2_rank, 2, tmp_path_factory)


@pytest.fixture(scope="module")
def pp4(tmp_path_factory):
    return run_gang("pipe_gang4", _pp4_rank, 4, tmp_path_factory)


@pytest.fixture(scope="module")
def moe8(tmp_path_factory):
    return run_gang("pipe_moe8", _moe8_rank, 8, tmp_path_factory)


# --------------------------------------------------------------- JAX side

def _jmesh(shape, names):
    import jax
    from jax.sharding import Mesh

    devs = np.asarray(jax.devices()[:math.prod(shape)], dtype=object)
    return Mesh(devs.reshape(shape), names)


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


def test_pipeline_apply_matches_jax(pp4):
    """``pipeline_apply`` over 4 ranks (tests/test_parallel.py:118-150's
    P 4, M 8, MB 4, D 16): the outputs equal JAX's ``pipeline_apply``
    under shard_map, and the stage-weight and input gradients under a
    seeded cotangent equal ``jax.vjp`` of the sequential reference (the
    x gradient summed over the ranks, as every rank holds x), within fp32
    1e-5."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from paddle_tpu.common.jax_compat import shard_map
    from paddle_tpu.parallel import pipeline_apply

    ws, x, cot = _apply_problem()

    def body(params, xx):
        outs = pipeline_apply(lambda prm, a: jnp.tanh(a @ prm["w"]), params,
                              xx, axis="pp")
        last = (jax.lax.axis_index("pp") == AP_P - 1).astype(outs.dtype)
        return jax.lax.psum(outs * last, "pp")

    want = jax.jit(shard_map(body, mesh=_jmesh((AP_P,), ("pp",)),
                             in_specs=({"w": P("pp", None, None)}, P(None)),
                             out_specs=P(None)))({"w": jnp.asarray(ws)},
                                                 jnp.asarray(x))

    def seq(w, xx):
        for i in range(AP_P):
            xx = jnp.tanh(xx @ w[i])
        return xx

    ref, vjp = jax.vjp(seq, jnp.asarray(ws), jnp.asarray(x))
    gw, gx = vjp(jnp.asarray(cot))
    got = [dict(np.load(pp4 / f"apply.{r}.npz")) for r in range(AP_P)]
    for r in range(AP_P):
        _close(got[r]["out"], want, what=f"out rank {r}")
        _close(got[r]["gw"][0], np.asarray(gw)[r], what=f"gw {r}")
    _close(np.asarray(ref), want, what="jax pipeline vs sequential")
    _close(sum(g["gx"] for g in got), gx, what="gx")


def _jax_executor(name, p, m, v, with_head):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from paddle_tpu.common.jax_compat import shard_map
    from paddle_tpu.parallel.pipelining import (device_major_order,
                                                pipeline_train_step,
                                                stack_stage_params)
    from paddle_tpu.parallel.schedules import build_schedule

    sched = build_schedule(name, p, m, v)
    params, x, y, head = _exec_problem(p * sched.v, m, with_head)
    order, _ = device_major_order(sched)
    stacked = stack_stage_params([{k: jnp.asarray(a) for k, a in
                                   params[s].items()} for s in order])
    pspec = {"w": P("pp", None, None), "b": P("pp", None)}

    def stage(prm, a):
        return jnp.tanh(a @ prm["w"] + prm["b"])

    if with_head:
        def body(sp, xx, yy, hh):
            return pipeline_train_step(
                stage, lambda lp, a, t: jnp.mean((a @ lp["h"] - t) ** 2),
                sched, sp, xx, yy, axis="pp", loss_params={"h": hh},
                want_x_grad=True)
        f = shard_map(body, mesh=_jmesh((p,), ("pp",)),
                      in_specs=(pspec, P(None), P(None), P()),
                      out_specs=(P(), pspec, P(), P(None)), check_vma=False)
        res = jax.jit(f)(stacked, jnp.asarray(x), jnp.asarray(y),
                         jnp.asarray(head))
    else:
        def body(sp, xx, yy):
            return pipeline_train_step(
                stage, lambda a, t: jnp.mean((a - t) ** 2), sched, sp, xx,
                yy, axis="pp")
        f = shard_map(body, mesh=_jmesh((p,), ("pp",)),
                      in_specs=(pspec, P(None), P(None)),
                      out_specs=(P(), pspec), check_vma=False)
        res = jax.jit(f)(stacked, jnp.asarray(x), jnp.asarray(y))
    return [np.asarray(a) if not isinstance(a, dict) else
            {k: np.asarray(b) for k, b in a.items()} for a in res], sched.v


def _check_executor(root, name, p, m, v, with_head):
    res, vv = _jax_executor(name, p, m, v, with_head)
    got = [dict(np.load(root / f"ex.{name}.{int(with_head)}.{r}.npz"))
           for r in range(p)]
    for r in range(p):
        _close(got[r]["loss"], res[0], what=f"loss rank {r}")
        for key in ("w", "b"):
            _close(got[r][f"g{key}"], res[1][key][r * vv:(r + 1) * vv],
                   what=f"g{key} rank {r}")
        if with_head:
            _close(got[r]["gh"], res[2]["h"], what=f"head grad rank {r}")
            _close(got[r]["dx"], res[3], what=f"x grad rank {r}")


@pytest.mark.parametrize("with_head", [False, True])
def test_1f1b_executor_matches_jax(pp2, with_head):
    """``pipeline_train_step`` under 1F1B on 2 ranks (4 micro-batches):
    the loss and the stage gradients (and with the head closed into the
    loss, its gradients and the stage-0 input gradients) equal JAX's
    executor under shard_map within fp32 1e-5."""
    _check_executor(pp2, "1F1B", 2, TWO_M, 1, with_head)


@pytest.mark.slow
@pytest.mark.parametrize("name,v", SCHEDULES4)
def test_schedules_on_four_ranks_match_jax(pp4, name, v):
    """Every schedule at tests/test_pipeline_schedules.py's p 4, m 8 (VPP
    and ZBV at 2 chunks a rank, all three channels): loss and gradients
    equal JAX's executor.  Tier-1 home: the 2-rank 1F1B legs above."""
    _check_executor(pp4, name, 4, EX_M, v, False)


def test_pipelined_moe_forwards_match_jax(moe8):
    """The pipelined MoE forwards on (pp, ep, mp) = (2, 2, 2)
    (tests/test_gpt_moe.py:279-327's sizes): each rank's at-rest blocks are
    the shards JAX places on the device at its coordinate, and both
    forwards equal JAX's on every rank within fp32 1e-5 (and the
    sequential reference within JAX's own 5e-4 / 5e-5)."""
    import jax.numpy as jnp

    from paddle_tpu.incubate.distributed.models.moe.pipelined import (
        init_pipelined_moe_params, pipelined_moe_forward,
        pipelined_moe_forward_ep, sequential_moe_forward)

    mesh = _jmesh(MOE_SHAPE, ("pp", "ep", "mp"))
    params = init_pipelined_moe_params(mesh, num_layers=2, num_expert=4,
                                       d_model=8, d_hidden=16)
    x = jnp.asarray(np.random.RandomState(0).randn(2, 8, 8).astype(
        np.float32))
    want = np.asarray(pipelined_moe_forward(params, x, mesh))
    want_ep = np.asarray(pipelined_moe_forward_ep(params, x, mesh))
    ref = np.asarray(sequential_moe_forward(
        {k: jnp.asarray(np.asarray(v)) for k, v in params.items()}, x))
    dev_of = {d.id: i for i, d in enumerate(mesh.devices.flat)}
    for r in range(8):
        got = dict(np.load(moe8 / f"moe.{r}.npz"))
        for k, v in params.items():
            shard = next(s for s in v.addressable_shards
                         if dev_of[s.device.id] == r)
            np.testing.assert_array_equal(got[f"rest/{k}"],
                                          np.asarray(shard.data), err_msg=k)
        _close(got["fwd"], want, what=f"fwd rank {r}")
        _close(got["fwd_ep"], want_ep, what=f"fwd_ep rank {r}")
        np.testing.assert_allclose(got["fwd"], ref, rtol=5e-4, atol=5e-5)
