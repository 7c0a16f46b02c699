"""The overlap engine of the port (parallel/overlap.py, the two-stage and
coded collectives, compat's axis_index_groups, distributed/topology.py,
the schedule's stack_plan and the mesh train step's ``overlap=``) against
the JAX package on the CPU.

Gangs follow tests/test_torch_mesh_train.py: one ``torch.multiprocessing``
spawn of gloo ranks per gang and test run (``_gang``), a ``FileStore``
rendezvous, ranks that import torch and paddle_tpu_torch only, results as
npz, and under xdist the first worker runs a gang under a lock file while
the others read its results.

- ``coll4``: 4 ranks on ("sharding",) with slice_map (0, 0, 1, 1): the
  uncoded two-stage collectives equal the flat ones exactly; the coded ones
  equal the JAX package's coded ones to 1e-6 relative and stay within its
  3/127 and 3/127 + 1/8 bounds of the flat ones; the collective-matmul
  ring equals psum(y @ w), and an indivisible width falls back.
- ``step8``: 8 ranks, the overlap train step on dp2 x sh2 x mp2 and on the
  fake-2-slice (1, 4, 2) mesh, 3 fp32 AdamW steps against JAX's
  ``build_train_step(..., overlap=...)``: loss 1e-5 relative, parameters
  within 1e-5 relative for all but a 1e-3 share of elements, signed
  moment1 the same (the mesh-step tests' tolerance).  The JAX region's
  gradients exceed the loss's by the sizes of the axes its shard_map
  transpose psums over a second time (``_jax_grad_factor``; parallel/overlap.py's docstring):
  AdamW's update cancels that power of two exactly but for its epsilon, so
  these gangs run AdamW with epsilon 1e-30 (``EPS``), and moment1 is held
  after multiplying the port's by that factor.  The port's overlap step is
  also held to the port's mesh step (``overlap=None``) in the same gang.
"""

from __future__ import annotations

import fcntl
import json
import math
import os
import time
import traceback

import numpy as np
import pytest
import torch

LR = 1e-3
STEPS = 3
# AdamW's epsilon in the step gangs: the JAX overlap step's gradients are
# scaled by powers of two (``_jax_grad_factor``), which AdamW's update
# cancels exactly but for eps; a negligible eps keeps that scale out of the
# parameters, and moment1 is held to the factor explicitly
EPS = 1e-30
SLICES = (0, 0, 1, 1)


def _gang(name, target, args, world, tmp_path_factory, prepare=None):
    """Run (once per test run, whatever the xdist worker) ``target(rank,
    world, root, *args)`` on ``world`` gloo ranks; return the results
    directory."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    base = tmp_path_factory.getbasetemp()
    root = (base.parent / f"{name}-{uid}") if uid else (base / name)
    root.mkdir(parents=True, exist_ok=True)
    with open(root / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (root / "failed").exists():
            raise RuntimeError("the gang failed in another worker:\n"
                               + (root / "failed").read_text())
        if not (root / "done").exists():
            try:
                if prepare is not None:
                    prepare(root)
                t0 = time.time()
                torch.multiprocessing.spawn(
                    target, args=(world, str(root)) + tuple(args),
                    nprocs=world, join=True)
                (root / "done").write_text(json.dumps(
                    {"seconds": time.time() - t0}))
            except BaseException:
                (root / "failed").write_text(traceback.format_exc())
                raise
    return root


def _store(root, world):
    import torch.distributed as dist

    return dist.FileStore(os.path.join(root, "store"), world)


# ------------------------------------------------- the collectives (4 ranks)

COLL_CODEC = dict(block=64)


def _coll_x(rank):
    return np.random.RandomState(100 + rank).randn(16, 6).astype(np.float32)


def _coll_xi(rank):
    """Integer-valued: sums in any order are exact."""
    return np.round(_coll_x(rank) * 8)


def _ring_inputs(rank, n):
    rng = np.random.RandomState(10 + rank)
    return (rng.randn(2, 8, 32).astype(np.float32),
            rng.randn(32, n).astype(np.float32))


def _coll_main(rank, world, root):
    """One rank of ``coll4``: every two-stage collective on its own x."""
    torch.set_num_threads(1)
    from paddle_tpu_torch.parallel import compat, overlap as OV
    from paddle_tpu_torch.parallel.codec import CollectiveCodec
    from paddle_tpu_torch.parallel.specs import init_mesh

    mesh = init_mesh("cpu", (world,), ("sharding",),
                     store=_store(root, world), rank=rank, world_size=world)
    hier = OV.OverlapConfig(hierarchical="on",
                            slice_map=SLICES).resolve_hier(mesh, "sharding")
    OV.register_hier(mesh, "sharding", hier)
    codec = CollectiveCodec(**COLL_CODEC)
    xi = torch.from_numpy(_coll_xi(rank))
    x = torch.from_numpy(_coll_x(rank))
    out = {
        "flat_rs": compat.reduce_scatter_raw(xi, "sharding", 0, mesh),
        "flat_ag": compat.all_gather_raw(xi, "sharding", 0, mesh),
        "flat_ps": compat.all_reduce_raw(xi, "sharding", mesh),
        "h_rs": OV.hier_psum_scatter(xi, "sharding", hier, mesh=mesh),
        "h_ag": OV.hier_all_gather(xi, "sharding", hier, mesh=mesh),
        "h_ps": OV.hier_psum(xi, "sharding", hier, mesh=mesh),
        "h_rs_async": OV.hier_psum_scatter(xi, "sharding", hier, mesh=mesh,
                                           async_op=True).wait(),
        "fr_rs": compat.reduce_scatter_raw(x, "sharding", 0, mesh),
        "fr_ps": compat.all_reduce_raw(x, "sharding", mesh),
        "q_rs": OV.hier_psum_scatter(x, "sharding", hier, codec, "grad",
                                     mesh=mesh),
        "q_ag": OV.hier_all_gather(x, "sharding", hier, codec, "weight",
                                   mesh=mesh),
        "q_ps": OV.hier_psum(x, "sharding", hier, codec, "grad", mesh=mesh),
        "q_rt": OV.hier_all_gather(
            OV.hier_psum_scatter(x, "sharding", hier, codec, "grad",
                                 mesh=mesh),
            "sharding", hier, codec, "weight", mesh=mesh, async_op=True
        ).wait(),
        # the groups themselves: a psum within each slice, a gather across
        "ici_ps": compat.psum(x, "sharding", mesh=mesh,
                              axis_index_groups=hier.ici_groups),
        "dcn_ag": compat.all_gather(x, "sharding", mesh=mesh,
                                    axis_index_groups=hier.dcn_groups),
    }
    for n in (16, 13):
        y, w = (torch.from_numpy(a) for a in _ring_inputs(rank, n))
        out[f"ring{n}"] = OV.ring_collective_matmul(y, w, "sharding",
                                                    mesh=mesh)
        out[f"psum{n}"] = compat.psum(y @ w, "sharding", mesh=mesh)
    # the ring's gradient against the psum's
    y, w = (torch.from_numpy(a).requires_grad_()
            for a in _ring_inputs(rank, 16))
    ct = torch.from_numpy(np.random.RandomState(7).randn(2, 8, 16).astype(
        np.float32))
    gy, gw = torch.autograd.grad(
        OV.ring_collective_matmul(y, w, "sharding", mesh=mesh), (y, w), ct)
    ry, rw = torch.autograd.grad(compat.psum(y @ w, "sharding", mesh=mesh),
                                 (y, w), ct)
    out.update(ring_gy=gy, ring_gw=gw, psum_gy=ry, psum_gw=rw)
    # the bucket transport on its own (flat and two-stage), with autograd
    ct = torch.from_numpy(np.tile(_coll_xi(7).reshape(-1), 4))
    for name, h, mode in (("bucket", None, "scatter"),
                          ("bucket_hier", hier, "scatter"),
                          ("bucket_slice", None, "slice")):
        local = xi.reshape(-1).clone().requires_grad_()
        full = OV.make_bucket_gather("sharding", h, grad_mode=mode,
                                     mesh=mesh)(local)
        (g,) = torch.autograd.grad(full, local, ct * (rank + 1))
        out[name + ".y"], out[name + ".g"] = full, g
    # a tree of [2, *local] leaves (a leading chunk dim) gathered over
    # sharding bucket by bucket, and each rank's own shard sliced back
    from paddle_tpu_torch.parallel.overlap import _LeafPlace

    layout = {"a": _LeafPlace("a", (8, 3), 0, None),
              "b": _LeafPlace("b", (5, 8), 1, None),
              "n": _LeafPlace("n", (6,), None, None)}
    tree = {"a": xi[:2, :3].reshape(1, 2, 3).expand(2, 2, 3) + 0,
            "b": xi[:5, :2].reshape(1, 5, 2).expand(2, 5, 2) + 0,
            "n": xi[0].reshape(1, 6).expand(2, 6) + 0}
    for name, h, cap in (("tree", None, 24), ("tree_hier", hier, 1 << 20)):
        full = OV.gather_tree_over_sharding(tree, layout, 1, 4, 1,
                                            "sharding", h, bucket_bytes=cap,
                                            mesh=mesh)
        back = OV.slice_tree_own_shard(full, layout, 1, 4, "sharding",
                                       mesh=mesh)
        for k in tree:
            out[f"{name}.{k}"] = full[k]
            assert torch.equal(back[k], tree[k]), (name, k)
    np.savez(os.path.join(root, f"coll.{rank}.npz"),
             **{k: v.detach().numpy() for k, v in out.items()})


@pytest.fixture(scope="module")
def coll4(tmp_path_factory):
    return _gang("overlap_coll4", _coll_main, (), 4, tmp_path_factory)


def _coll(root):
    return [dict(np.load(root / f"coll.{r}.npz")) for r in range(4)]


def test_hier_collectives_equal_flat(coll4):
    """Uncoded, the two-stage reduce-scatter, all-gather and psum (and the
    async reduce-scatter) give the flat collectives' values exactly, on
    integer-valued inputs (so that the two summation orders cannot round
    apart); and the flat ones are the numpy sums and concatenations."""
    xs = [_coll_xi(r) for r in range(4)]
    for r, got in enumerate(_coll(coll4)):
        for h, f in (("h_rs", "flat_rs"), ("h_rs_async", "flat_rs"),
                     ("h_ag", "flat_ag"), ("h_ps", "flat_ps")):
            np.testing.assert_array_equal(got[h], got[f],
                                          err_msg=f"{h} rank {r}")
        np.testing.assert_array_equal(got["flat_ps"], sum(xs))
        np.testing.assert_array_equal(got["flat_rs"],
                                      sum(xs)[4 * r:4 * r + 4])
        np.testing.assert_array_equal(got["flat_ag"], np.concatenate(xs))


def test_axis_index_groups_partition_the_axis(coll4):
    """psum within each slice's group and all_gather within each
    cross-slice group, in the group's order."""
    xs = [_coll_x(r) for r in range(4)]
    for r, got in enumerate(_coll(coll4)):
        ici = [g for g in ([0, 1], [2, 3]) if r in g][0]
        dcn = [g for g in ([0, 2], [1, 3]) if r in g][0]
        np.testing.assert_array_equal(got["ici_ps"],
                                      sum(xs[j] for j in ici))
        np.testing.assert_array_equal(got["dcn_ag"],
                                      np.concatenate([xs[j] for j in dcn]))


def _jax_coded():
    """The JAX package's coded collectives on 4 virtual devices, each
    device's x its rank's (per-device outputs stacked on dim 0)."""
    import jax
    from jax import lax
    from jax.sharding import Mesh, PartitionSpec as JP

    from paddle_tpu.common.jax_compat import shard_map
    from paddle_tpu.distributed.topology import hierarchical_axis
    from paddle_tpu.parallel import overlap as JOV
    from paddle_tpu.parallel.codec import CollectiveCodec as JCodec

    mesh = Mesh(np.asarray(jax.devices()[:4], dtype=object), ("sharding",))
    hier = hierarchical_axis(mesh, "sharding", slice_map=SLICES)
    codec = JCodec(**COLL_CODEC)
    x = np.concatenate([_coll_x(r) for r in range(4)])

    def body(x):
        f_rs = lax.psum_scatter(x, "sharding", scatter_dimension=0,
                                tiled=True)
        q_rs = JOV.hier_psum_scatter(x, "sharding", hier, codec=codec,
                                     kind="grad")
        q_ag = JOV.hier_all_gather(x, "sharding", hier, codec=codec,
                                   kind="weight")
        q_rt = JOV.hier_all_gather(q_rs, "sharding", hier, codec=codec,
                                   kind="weight")
        fs = lax.psum(x, "sharding")
        q_ps = JOV.hier_psum(x, "sharding", hier, codec=codec, kind="grad")
        return tuple(t[None] for t in (f_rs, q_rs, q_ag, q_rt, fs, q_ps))

    outs = jax.jit(shard_map(
        body, mesh=mesh, in_specs=(JP("sharding"),),
        out_specs=(JP("sharding"),) * 6, check_vma=False))(x)
    names = ("f_rs", "q_rs", "q_ag", "q_rt", "fs", "q_ps")
    # out_specs stack each device's value on a new leading dim
    return {k: np.asarray(v) for k, v in zip(names, outs)}


def test_coded_hier_collectives_match_jax(coll4):
    """The coded reduce-scatter (int8, stochastic rounding), the coded
    all-gather (fp8), their round trip and the coded psum equal the JAX
    package's to 1e-6 relative (the same bytes cross the wire; only the
    fp32 sums may round apart), and stay within JAX's bounds of the flat
    collectives: 3/127 of the absmax, 3/127 + 1/8 for the round trip."""
    want = _jax_coded()
    for r, got in enumerate(_coll(coll4)):
        for k in ("q_rs", "q_ag", "q_rt", "q_ps"):
            w = want[k][r]
            np.testing.assert_allclose(got[k], w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=f"{k} rank {r}")
        f_rs, fs = got["fr_rs"], got["fr_ps"]
        np.testing.assert_allclose(f_rs, want["f_rs"][r], rtol=1e-6,
                                   atol=1e-6)
        assert np.abs(got["q_rs"] - f_rs).max() <= np.abs(f_rs).max() * 3 / 127
        assert np.abs(got["q_rt"] - fs).max() <= \
            np.abs(fs).max() * (3 / 127 + 1 / 8)
        assert np.abs(got["q_ps"] - fs).max() <= np.abs(fs).max() * 3 / 127


def test_bucket_transport_and_tree_gather(coll4):
    """``make_bucket_gather`` on its own: the forward is the flat
    all-gather (two-stage alike), the backward the reduce-scatter of the
    rank-scaled cotangent ("scatter") or this rank's slice of it
    ("slice"); ``gather_tree_over_sharding`` joins each sharded leaf along
    its dim (small buckets or one), and ``slice_tree_own_shard`` gives
    every rank its own block back (asserted in the ranks)."""
    xs = [_coll_xi(r).reshape(-1) for r in range(4)]
    ct = np.tile(_coll_xi(7).reshape(-1), 4)
    scatter = sum(ct * (j + 1) for j in range(4))
    n = xs[0].size
    for r, got in enumerate(_coll(coll4)):
        for name in ("bucket", "bucket_hier", "bucket_slice"):
            np.testing.assert_array_equal(got[name + ".y"],
                                          np.concatenate(xs))
        np.testing.assert_array_equal(got["bucket.g"],
                                      scatter[r * n:(r + 1) * n])
        np.testing.assert_array_equal(got["bucket_hier.g"],
                                      scatter[r * n:(r + 1) * n])
        np.testing.assert_array_equal(got["bucket_slice.g"],
                                      (ct * (r + 1))[r * n:(r + 1) * n])
        for name in ("tree", "tree_hier"):
            a = np.concatenate([_coll_xi(j)[:2, :3] for j in range(4)])
            b = np.concatenate([_coll_xi(j)[:5, :2] for j in range(4)], 1)
            np.testing.assert_array_equal(got[f"{name}.a"],
                                          np.broadcast_to(a, (2, 8, 3)))
            np.testing.assert_array_equal(got[f"{name}.b"],
                                          np.broadcast_to(b, (2, 5, 8)))
            np.testing.assert_array_equal(
                got[f"{name}.n"], np.broadcast_to(_coll_xi(r)[0], (2, 6)))


def test_ring_collective_matmul_matches_psum(coll4):
    """The ring equals psum(y @ w) (1e-5), its gradients equal the psum
    path's, and a width the ring does not divide (13 over 4) falls back to
    the psum itself."""
    for r, got in enumerate(_coll(coll4)):
        np.testing.assert_allclose(got["ring16"], got["psum16"], rtol=1e-5,
                                   atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_array_equal(got["ring13"], got["psum13"])
        for k in ("gy", "gw"):
            np.testing.assert_allclose(got["ring_" + k], got["psum_" + k],
                                       rtol=1e-5, atol=1e-5)
    # and psum(y @ w) is the sum over ranks
    ys = [_ring_inputs(r, 16) for r in range(4)]
    np.testing.assert_allclose(_coll(coll4)[0]["psum16"],
                               sum(y @ w for y, w in ys), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------ the train step (8 ranks)

# name -> (mesh shape, OverlapConfig kwargs, step kwargs, state)
_ALL = dict(collective_matmul_min_out_elems=1)
_HIER = dict(hierarchical="on", slice_map=SLICES,
             collective_matmul_min_out_elems=1)
CASES = {
    "full": ((2, 2, 2), _ALL, {}, "adamw"),
    "remat": ((2, 2, 2), _ALL, {"remat": True}, "adamw"),
    "masked": ((2, 2, 2), _ALL, {"mask": True}, "adamw"),
    "accum2": ((2, 2, 2), _ALL, {"accum": 2}, "adamw"),
    "coded": ((1, 4, 2), dict(_HIER, codec=dict(weight_profile="none",
                                                 block=128)), {}, "adamw"),
    "flat": ((2, 2, 2), _ALL, {}, "flat"),
    "host": ((2, 2, 2), _ALL, {}, "host"),
}
SLOW_CASES = {
    "no_prefetch": ((2, 2, 2), dict(_ALL, prefetch=False), {}, "adamw"),
    "unbucketed": ((2, 2, 2), dict(_ALL, bucket_bytes=0), {}, "adamw"),
    "no_collective_matmul": ((2, 2, 2), dict(collective_matmul=False), {},
                             "adamw"),
    "flat_collectives": ((2, 2, 2), dict(prefetch=False,
                                         collective_matmul=False,
                                         hierarchical="off"), {}, "adamw"),
    "hier": ((1, 4, 2), _HIER, {}, "adamw"),
    "full_codec": ((1, 4, 2), dict(_HIER, codec=dict(block=128)), {},
                   "adamw"),
}


def _cfg(cls):
    return cls.debug(vocab=128, hidden=32, layers=2, heads=4, kv_heads=2,
                     inter=64, max_pos=64)


def _data(accum, mask):
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 128, (8, 16)).astype(np.int32)
    lab = rng.randint(0, 128, (8, 16)).astype(np.int32)
    seg = None
    if mask:
        seg = np.ones(ids.shape, np.int32)
        seg[:, -5:] = 0
    if accum > 1:
        ids, lab = ids.reshape(accum, -1, 16), lab.reshape(accum, -1, 16)
        seg = None if seg is None else seg.reshape(accum, -1, 16)
    return ids, lab, seg


def _oc(kw):
    from paddle_tpu_torch.parallel.codec import CollectiveCodec
    from paddle_tpu_torch.parallel.overlap import OverlapConfig

    kw = dict(kw)
    if "codec" in kw:
        kw["codec"] = CollectiveCodec(**kw["codec"])
    return OverlapConfig(**kw)


def _run_port(mesh, init, oc, kw, state_kind, overlap=True):
    """3 steps of the port's mesh step (``overlap`` or not): losses,
    gathered params after each step, the gathered final state."""
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         apply_llama_sharding,
                                         build_train_step, gather_opt_state,
                                         gather_params, llama_decay_mask,
                                         params_from_jax)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.memory import init_offloaded_state

    model = LlamaForCausalLM(_cfg(LlamaConfig), device="cpu")
    model.load_functional_state(params_from_jax(init, "cpu"))
    apply_llama_sharding(model, mesh)
    # the JAX arrays cut into this rank's at-rest blocks, which both steps
    # take (one at-rest layout)
    params = params_from_jax(init, "cpu", mesh=mesh, schedule=model.schedule)
    opt = AdamW(learning_rate=LR, epsilon=EPS)
    accum = kw.get("accum", 1)
    step = build_train_step(model, opt, mesh=mesh,
                            compute_dtype=torch.float32, accum_steps=accum,
                            remat=kw.get("remat", False),
                            overlap=oc if overlap else None)
    mask = llama_decay_mask(model)
    if state_kind == "adamw":
        state = opt.init_state(params)
    elif state_kind == "host":
        state = init_offloaded_state(opt, params, decay_mask=mask,
                                     bucket_bytes=2 << 10,
                                     flat_layout=step.flat_layout)
    else:
        state = opt.init_flat_state(params, decay_mask=mask,
                                    flat_layout=step.flat_layout)
    ids, lab, seg = _data(accum, kw.get("mask", False))
    out = {}
    for i in range(STEPS):
        loss, params, state = step(params, state, i, LR, ids, lab,
                                   attention_mask=seg)
        out[f"loss{i}"] = loss.numpy()
        for k, v in gather_params(params).items():
            out[f"p{i}/{k}"] = v.numpy().copy()
        if i == 0 and state_kind == "adamw":
            for k, v in gather_opt_state(state).items():
                out[f"m0/{k}"] = v["moment1"].numpy().copy()
    st = gather_opt_state(state, step.flat_layout)
    flat = st.get("__flat__", st)
    for g, gs in flat.items():
        for key, v in gs.items():
            out[f"st/{g}/{key}"] = v.numpy()
    return out


def _step_main(rank, world, root, cases):
    """One rank of a step gang: each case with the overlap engine, and (for
    the adamw and flat cases of the first mesh) the mesh step beside it."""
    torch.set_num_threads(1)
    from paddle_tpu_torch.parallel.specs import init_mesh

    store = _store(root, world)
    init = dict(np.load(os.path.join(root, "init.npz")))
    meshes = {}
    for name, (shape, oc_kw, kw, state_kind) in cases.items():
        if shape not in meshes:
            meshes[shape] = init_mesh("cpu", shape, ("dp", "sharding", "mp"),
                                      store=store, rank=rank,
                                      world_size=world)
        mesh = meshes[shape]
        oc = _oc(oc_kw)
        runs = {"": _run_port(mesh, init, oc, kw, state_kind)}
        if name == "coded":
            runs["again."] = _run_port(mesh, init, oc, kw, state_kind)
            # the control: the same two-stage step with the codec off
            runs["uncoded."] = _run_port(
                mesh, init, _oc({k: v for k, v in oc_kw.items()
                                 if k != "codec"}), kw, state_kind)
        if name in ("full", "flat", "masked"):
            runs["mesh."] = _run_port(mesh, init, oc, kw, state_kind,
                                      overlap=False)
        if rank == 0:
            for tag, out in runs.items():
                np.savez(os.path.join(root, f"{tag}{name}.npz"), **out)


def _prepare_step(root):
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig as JaxConfig
    from paddle_tpu.models import LlamaForCausalLM as JaxModel

    state = paddle.get_rng_state()
    paddle.seed(20260803)
    jm = JaxModel(_cfg(JaxConfig))
    paddle.set_rng_state(state)
    np.savez(root / "init.npz",
             **{k: np.asarray(v) for k, v in jm.functional_state().items()})


@pytest.fixture(scope="module")
def step8(tmp_path_factory):
    return _gang("overlap_step8", _step_main, (CASES,), 8, tmp_path_factory,
                 prepare=_prepare_step)


@pytest.fixture(scope="module")
def step8_slow(tmp_path_factory):
    return _gang("overlap_step8_slow", _step_main, (SLOW_CASES,), 8,
                 tmp_path_factory, prepare=_prepare_step)


def _jax_run(root, shape, oc_kw, kw, state_kind):
    """JAX's overlap step on the same weights and batches."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig as JaxConfig
    from paddle_tpu.models import LlamaForCausalLM as JaxModel
    from paddle_tpu.models import build_train_step
    from paddle_tpu.models.llama import (apply_llama_sharding,
                                         llama_decay_mask)
    from paddle_tpu.parallel.codec import CollectiveCodec as JCodec
    from paddle_tpu.parallel.overlap import OverlapConfig as JOC

    state = paddle.get_rng_state()
    paddle.seed(20260803)
    jm = JaxModel(_cfg(JaxConfig))
    paddle.set_rng_state(state)
    mesh = Mesh(np.asarray(jax.devices()[:8], dtype=object).reshape(shape),
                ("dp", "sharding", "mp"))
    apply_llama_sharding(jm, mesh)
    okw = dict(oc_kw)
    if "codec" in okw:
        okw["codec"] = JCodec(**okw["codec"])
    opt = paddle.optimizer.AdamW(learning_rate=LR, epsilon=EPS,
                                 parameters=jm.parameters())
    accum = kw.get("accum", 1)
    step = build_train_step(jm, opt, mesh=mesh, compute_dtype=jnp.float32,
                            overlap=JOC(**okw), remat=kw.get("remat", False),
                            accum_steps=accum)
    params = {k: jnp.array(v, copy=True)
              for k, v in jm.functional_state().items()}
    if state_kind == "adamw":
        st = opt.init_state(params)
    else:
        from paddle_tpu.parallel.schedule import PartitionSchedule

        st = opt.init_flat_state(
            params, decay_mask=llama_decay_mask(jm),
            flat_layout=PartitionSchedule.from_model(
                jm, mesh).flat_update_layout())
    ids, lab, seg = _data(accum, kw.get("mask", False))
    extra = () if seg is None else (seg,)
    out = {}
    for i in range(STEPS):
        loss, params, st = step(params, st, i, LR, ids, lab, *extra)
        out[f"loss{i}"] = np.asarray(loss)
        for k, v in params.items():
            out[f"p{i}/{k}"] = np.asarray(v)
        if i == 0 and state_kind == "adamw":
            for k, v in st.items():
                out[f"m0/{k}"] = np.asarray(v["moment1"])
    flat = st.get("__flat__", st)
    for g, gs in flat.items():
        for key, v in gs.items():
            out[f"st/{g}/{key}"] = np.asarray(v)
    return out


def _jax_grad_factor(name, shape):
    """By how much the JAX overlap step's gradient of ``name`` exceeds the
    loss's on a (dp, sharding, mp) mesh: its shard_map transpose psums the
    cotangent of every input over the axes the input is replicated on, on
    top of the region's own syncs (bucket leaves over dp, the other layer
    leaves over dp and sharding) and of the entry's mp sync of x (the
    embedding).  Measured against the flat step; see parallel/overlap.py's
    module docstring."""
    dp, sh, mp = shape
    if name == "model.embed_tokens.weight":
        return mp
    if not name.startswith("model.layers."):
        return 1
    if "layernorm" in name or sh == 1:
        return dp * sh
    return dp


def _close(got, want, what):
    """All but a 1e-3 share of the elements within 1e-5 relative of the
    largest (Adam turns a near-zero gradient whose sign the two summation
    orders disagree on into a full lr step)."""
    scale = np.abs(want).max() or 1.0
    bad = np.abs(got - want) > 1e-5 * scale
    assert np.mean(bad) < 1e-3, (what, int(bad.sum()), bad.size)


def _check(root, name, cases, quantum_note=None):
    shape, oc_kw, kw, state_kind = cases[name]
    got = dict(np.load(root / f"{name}.npz"))
    want = _jax_run(root, shape, oc_kw, kw, state_kind)
    for i in range(STEPS):
        np.testing.assert_allclose(got[f"loss{i}"], want[f"loss{i}"],
                                   rtol=1e-5, err_msg=f"loss step {i}")
    assert float(got[f"loss{STEPS - 1}"]) < float(got["loss0"])
    for k in [k for k in want if k.startswith("p")]:
        _close(got[k], want[k], k)
    if state_kind == "adamw":
        for k in [k for k in want if k.endswith("/moment1")
                  or k.startswith("m0/")]:
            leaf = k.split("/")[1]
            _close(got[k] * _jax_grad_factor(leaf, shape), want[k], k)
    return got, want


@pytest.mark.parametrize("name", ["full", "remat", "masked", "accum2"])
def test_overlap_step_matches_jax(step8, name):
    """dp2 x sh2 x mp2, every lever on (the ring at any size): the
    all-levers point, remat (the gather inside the checkpointed layer),
    segment ids with the last 5 positions padded, accum 2."""
    _check(step8, name, CASES)


# the share of the coded leaves' step-1 moment1 elements that may differ
# from JAX's coded step beyond 1e-5 of their leaf's largest: the two
# round about half of them to neighbouring quanta, while an uncoded step
# misses JAX's coded one by up to a quantum almost everywhere
CODED_M1_SHARE = 0.75


def _coded_counts(got, want, shape):
    """The coded leaves' step-1 moment1 ("m0") and params after step 1
    ("p0") against JAX's coded step: per kind [elements beyond 1e-5 of
    their leaf's largest, elements, largest difference over its leaf's
    largest, largest difference].  The leaves no codec touches (embedding,
    head, final norm) are held at the uncoded tolerance here."""
    coded = [k[3:] for k in want if k.startswith("m0/model.layers.")]
    counts = {"m0": [0, 0, 0.0, 0.0], "p0": [0, 0, 0.0, 0.0]}
    for k in [k for k in want if k.startswith(("m0/", "p0/"))]:
        leaf = k.split("/")[1]
        g = got[k] * (_jax_grad_factor(leaf, shape) if k[0] == "m" else 1)
        w = want[k]
        if leaf not in coded:
            _close(g, w, k)
            continue
        scale = np.abs(w).max()
        d = np.abs(g - w)
        c = counts[k[:2]]
        c[0] += int((d > 1e-5 * scale).sum())
        c[1] += d.size
        c[2] = max(c[2], float(d.max() / scale))
        c[3] = max(c[3], float(d.max()))
    return counts


def _coded_note(name, counts):
    m, p = counts["m0"], counts["p0"]
    return (f"{name}: coded leaves' step-1 moment1 {m[0]} of {m[1]} "
            f"elements beyond 1e-5, at most {m[2] * 127:.2f} quanta of the "
            f"largest; params after step 1 {p[0]} of {p[1]} beyond 1e-5")


def _check_coded(root, name, cases):
    """A coded step against JAX's.  The stochastic rounding hashes the
    payload's bits, and the port's gradients differ from XLA's in their
    last bits, so the two round about half the coded elements to different
    neighbouring quanta (each slice's residue row may move one quantum, 1/127
    of its block's absmax).  Held: the losses of every step to 1e-5; the
    leaves no codec touches at the uncoded tolerance; the coded leaves'
    first moment1 within 6/127 of its largest element (two slices' quanta,
    a slice's absmax up to 3x the sum's where they cancel), all but a
    CODED_M1_SHARE of its elements within 1e-5; the params after the first
    step within 1e-5 but for a 1 % share, each of those within a 2 lr sign
    flip of Adam's step.  Returns the counts (printed with -s)."""
    shape, oc_kw, kw, state_kind = cases[name]
    got = dict(np.load(root / f"{name}.npz"))
    want = _jax_run(root, shape, oc_kw, kw, state_kind)
    for i in range(STEPS):
        np.testing.assert_allclose(got[f"loss{i}"], want[f"loss{i}"],
                                   rtol=1e-5, err_msg=f"loss step {i}")
    counts = _coded_counts(got, want, shape)
    m, p = counts["m0"], counts["p0"]
    print(_coded_note(name, counts))
    assert m[2] <= 6 / 127, counts
    assert m[0] <= CODED_M1_SHARE * m[1], counts
    assert p[3] <= 2 * LR + 1e-6, counts
    assert p[0] <= 0.01 * p[1], counts
    return got, want


def test_coded_step_matches_jax_and_is_deterministic(step8):
    """The fake-2-slice (1, 4, 2) mesh, int8 stochastic gradient codec on
    the inter-slice stage (weights uncoded, block 128), held to JAX's coded
    step (``_check_coded``); two runs are bitwise equal.  Control: the
    same two-stage step with the codec off fails the moment1 share against
    JAX's coded step, so the check tells a coded step from an uncoded
    one."""
    got, want = _check_coded(step8, "coded", CASES)
    again = dict(np.load(step8 / "again.coded.npz"))
    assert set(again) == set(got)
    for k in got:
        np.testing.assert_array_equal(again[k], got[k], err_msg=k)
    uncoded = dict(np.load(step8 / "uncoded.coded.npz"))
    counts = _coded_counts(uncoded, want, CASES["coded"][0])
    print(_coded_note("uncoded control", counts))
    m = counts["m0"]
    assert m[0] > CODED_M1_SHARE * m[1], counts


@pytest.mark.parametrize("name", ["full", "masked", "flat"])
def test_overlap_step_equals_mesh_step(step8, name):
    """The port's overlap step and its mesh step (``overlap=None``) on the
    same weights and batches: the same losses (1e-6 relative), parameters
    and optimizer state (moments to 1e-5 of the largest, all but a 1e-3
    share); the gradients are the same, only the summation order
    differs."""
    got = dict(np.load(step8 / f"{name}.npz"))
    ref = dict(np.load(step8 / f"mesh.{name}.npz"))
    assert set(got) == set(ref)
    for k in ref:
        if k.startswith("loss"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6)
        else:
            _close(got[k], ref[k], k)


def test_overlap_flat_and_host_state(step8):
    """The shard-major flat state and its host-resident form under the
    overlap step: the host state equals the device flat state bit for bit
    (the flat state is held to the mesh step's in
    ``test_overlap_step_equals_mesh_step[flat]``, whose own flat state
    tests/test_torch_mesh_train.py holds to JAX's)."""
    host = dict(np.load(step8 / "host.npz"))
    flat = dict(np.load(step8 / "flat.npz"))
    assert set(host) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(host[k], flat[k], err_msg=k)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(SLOW_CASES))
def test_overlap_lever_breadth_matches_jax(step8_slow, name):
    """The single-lever ablations (no prefetch, one leaf a bucket, no
    collective matmul, flat collectives), the uncoded fake-2-slice step and
    the full codec (fp8 weight gathers), against JAX's."""
    if "codec" in SLOW_CASES[name][1]:
        _check_coded(step8_slow, name, SLOW_CASES)
    else:
        _check(step8_slow, name, SLOW_CASES)


# ----------------------------------------------------- in-process, no gang

MESH_SHAPES = [((2, 2, 1), {}), ((1, 2, 2), {}), ((1, 4, 1), {}),
               ((1, 1, 4), {"kv_heads": 2}), ((2, 2, 2), {}),
               ((1, 4, 2), {})]


def _stack_plan_cases():
    from paddle_tpu_torch.parallel.codec import CollectiveCodec

    return [("default", {}), ("tiny_buckets", {"bucket_bytes": 1 << 10}),
            ("no_prefetch", {"prefetch": False}),
            ("hier", {"hierarchical": "on", "slice_map": None,
                      "codec": CollectiveCodec(block=128)})]


@pytest.mark.parametrize("shape,cfg_kw", MESH_SHAPES,
                         ids=["x".join(map(str, s)) for s, _ in MESH_SHAPES])
def test_stack_plan_equals_jax(shape, cfg_kw):
    """``PartitionSchedule.stack_plan().describe()`` equals JAX's on every
    mesh of the mesh-spec tests (buckets, sync leaves, ring order,
    hierarchy, codec), under several OverlapConfigs, and its layout equals
    ``stack_layout_plan``'s."""
    import dataclasses

    import jax
    from jax.sharding import Mesh as JaxMesh

    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig as JaxConfig
    from paddle_tpu.models import LlamaForCausalLM as JaxModel
    from paddle_tpu.parallel import codec as jcodec
    from paddle_tpu.parallel import overlap as JOV
    from paddle_tpu.parallel.schedule import PartitionSchedule as JSched
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.parallel import overlap as OV
    from paddle_tpu_torch.parallel.schedule import PartitionSchedule
    from paddle_tpu_torch.parallel.specs import Mesh

    state = paddle.get_rng_state()
    paddle.seed(7)
    jm = JaxModel(JaxConfig.debug(**cfg_kw))
    paddle.set_rng_state(state)
    model = LlamaForCausalLM(LlamaConfig.debug(**cfg_kw), device="cpu")
    n = math.prod(shape)
    jmesh = JaxMesh(np.asarray(jax.devices()[:n], dtype=object).reshape(
        shape), ("dp", "sharding", "mp"))
    tsched = PartitionSchedule.from_model(model, Mesh(shape, ("dp",
                                                              "sharding",
                                                              "mp")))
    jsched = JSched.from_model(jm, jmesh)
    for label, kw in _stack_plan_cases():
        if "hierarchical" in kw:
            if shape[1] < 4:
                continue
            kw = dict(kw, slice_map=(0, 0, 1, 1))
        oc = OV.OverlapConfig(**kw)
        jkw = dict(kw)
        if "codec" in jkw:
            jkw["codec"] = jcodec.CollectiveCodec(
                **dataclasses.asdict(kw["codec"]))
        jsp = jsched.stack_plan(JOV.OverlapConfig(**jkw))
        tsp = tsched.stack_plan(oc)
        assert tsp.describe() == jsp.describe(), label
        assert {s: (p.shape, p.sh_dim, p.mp_dim)
                for s, p in tsp.layout.items()} == \
            {s: (p.shape, p.sh_dim, p.mp_dim)
             for s, p in jsp.layout.items()}, label
        for sfx, pl in tsp.layout.items():
            jpl = jsp.layout[sfx]
            for lead in (None, "pp"):
                assert tuple(OV.leaf_partition_spec(pl, lead)) == \
                    tuple(JOV.leaf_partition_spec(jpl, lead)), sfx
            assert tuple(OV.chunk_leaf_spec(pl)) == \
                tuple(JOV.chunk_leaf_spec(jpl)), sfx
        assert tsched.layer_shapes() == jsched.layer_shapes()
        lay, buckets, sync = OV.stack_layout_plan(
            tsched.layer_shapes(), tsched.mesh, tsched.plan_spec_for, oc)
        assert (buckets, sync) == (tsp.buckets, tsp.sync_suffixes)


def test_bucket_planning_caps_and_splits():
    """Twin of tests/test_overlap.py's: a generous cap makes one bucket of
    every gathered leaf, a zero cap one leaf a bucket, the norms are never
    gathered, a mid cap splits without dropping or reordering; the same
    plans as JAX's."""
    import jax
    from jax.sharding import Mesh as JaxMesh

    from paddle_tpu.models.llama import plan_spec_for as jplan
    from paddle_tpu.parallel import overlap as JOV
    from paddle_tpu.parallel.specs import filter_spec_to_mesh as jfilter
    from paddle_tpu_torch.models import LlamaConfig, plan_spec_for
    from paddle_tpu_torch.parallel import overlap as OV
    from paddle_tpu_torch.parallel.specs import Mesh, filter_spec_to_mesh

    cfg = _cfg(LlamaConfig)
    shapes = OV.llama_layer_shapes(cfg)
    mesh = Mesh((2, 2, 2), ("dp", "sharding", "mp"))
    jmesh = JaxMesh(np.asarray(jax.devices()[:8], dtype=object).reshape(
        2, 2, 2), ("dp", "sharding", "mp"))
    layout = OV.plan_layer_layout(
        shapes, mesh, lambda s: filter_spec_to_mesh(plan_spec_for(s), mesh))
    jlayout = JOV.plan_layer_layout(
        shapes, jmesh, lambda s: jfilter(jplan(s), jmesh))
    order = sorted(shapes)
    gathered = [s for s in order if layout[s].sh_dim is not None]
    assert all("layernorm" not in s for s in gathered)
    mid_cap = max(math.prod(layout[s].local_shape(2, 2)) * 4
                  for s in gathered)
    for cap in (1 << 30, 0, mid_cap):
        got = OV.plan_buckets(layout, order, 2, 2, cap, 4)
        assert got == JOV.plan_buckets(jlayout, order, 2, 2, cap, 4)
        assert [s for b in got for s in b] == gathered
    assert len(OV.plan_buckets(layout, order, 2, 2, 1 << 30, 4)) == 1
    assert len(OV.plan_buckets(layout, order, 2, 2, 0, 4)) == len(gathered)
    assert 1 < len(OV.plan_buckets(layout, order, 2, 2, mid_cap, 4)) \
        <= len(gathered)


def test_hierarchical_axis_detection():
    """Twin of tests/test_overlap.py's: the port's ranks carry no slice
    index (flat), an explicit map gives the two groupings, unbalanced
    slices fall back to flat, a wrong length raises; resolve_hier's
    "on" without a map raises."""
    from paddle_tpu_torch.distributed.topology import (device_slice_index,
                                                       hierarchical_axis,
                                                       mesh_spans_slices)
    from paddle_tpu_torch.parallel.overlap import OverlapConfig
    from paddle_tpu_torch.parallel.specs import Mesh

    mesh = Mesh((4,), ("x",))
    assert device_slice_index(torch.device("cpu")) is None
    assert hierarchical_axis(mesh, "x") is None
    assert not mesh_spans_slices(mesh, "x")
    hier = hierarchical_axis(mesh, "x", slice_map=(0, 0, 1, 1))
    assert hier.ici_groups == [[0, 1], [2, 3]]
    assert hier.dcn_groups == [[0, 2], [1, 3]]
    assert hier.size == 4 and repr(hier) == "HierAxis(slices=2, per_slice=2)"
    assert hierarchical_axis(mesh, "x", slice_map=(0, 0, 0, 1)) is None
    with pytest.raises(ValueError):
        hierarchical_axis(mesh, "x", slice_map=(0, 1))
    assert OverlapConfig().resolve_hier(mesh, "x") is None
    with pytest.raises(ValueError, match="slice_map"):
        OverlapConfig(hierarchical="on").resolve_hier(mesh, "x")
    with pytest.raises(ValueError, match="hierarchical"):
        OverlapConfig(hierarchical="yes").resolve_hier(mesh, "x")
    assert OverlapConfig(prefetch=False).hides_collectives() is False


def test_overlap_needs_a_mesh_and_accepts_degree_one_ep():
    """``overlap=`` without a mesh raises ValueError, as in JAX; at world
    size 1 the overlap step equals the mesh step bit for bit; the EP block
    takes an OverlapConfig at degree 1 (its codec inert)."""
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         build_train_step)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import expert
    from paddle_tpu_torch.parallel.codec import CollectiveCodec
    from paddle_tpu_torch.parallel.overlap import OverlapConfig
    from paddle_tpu_torch.parallel.specs import Mesh

    model = LlamaForCausalLM(_cfg(LlamaConfig), device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    opt = AdamW(learning_rate=LR)
    with pytest.raises(ValueError, match="needs a mesh"):
        build_train_step(model, opt, overlap=OverlapConfig())
    mesh = Mesh((1, 1, 1), ("dp", "sharding", "mp"), device_type="cpu")
    ids, lab, _ = _data(1, False)
    outs = []
    for oc in (None, OverlapConfig()):
        p = {k: v.clone() for k, v in model.functional_state().items()}
        step = build_train_step(model, opt, mesh=mesh,
                                compute_dtype=torch.float32, overlap=oc)
        outs.append(step(p, opt.init_state(p), 0, LR, ids, lab))
    assert torch.equal(outs[0][0], outs[1][0])
    for k, v in outs[0][1].items():
        assert torch.equal(v.local, outs[1][1][k].local), k
    cfg = expert.MoEEPConfig(d_model=8, d_hidden=16, num_expert=4)
    fwd = expert.build_moe_ep_forward(
        cfg, None, oc=OverlapConfig(codec=CollectiveCodec()))
    assert callable(fwd)
    with pytest.raises(TypeError):
        expert.build_moe_ep_forward(cfg, None, oc="on")
