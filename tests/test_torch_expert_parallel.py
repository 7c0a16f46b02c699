"""Expert parallelism of the port at degree > 1 (paddle_tpu_torch/parallel/
expert.py: the EP all-to-all, the capacity and dropless regions, their
train steps, the at-rest plan and ``PartitionSchedule.from_moe_ep``)
against the JAX package's ``shard_map`` bodies on the CPU.

Two gloo gangs, one ``torch.multiprocessing`` spawn each per test run,
rendezvousing through a ``FileStore`` (as tests/test_torch_mesh_train.py):

- ``coll4``: 4 ranks on an ``x`` axis.  The flat exchange and the two-stage
  one (slice maps (0, 0, 1, 1) and (0, 1, 0, 1)) against JAX's
  ``_ep_exchange_impl`` bit for bit, exchange o exchange, the backward,
  and the coded exchange (int8 stochastic, block 32): its packed bytes
  against JAX's and its error within one quantum (1/127 of the block
  absmax, with the bf16 scale's slack).
- ``ep8``: 8 ranks on (dp, sharding, ep) = (1, 2, 4), the JAX tests'
  mesh.  For the capacity block (JAX's ``_CFG``) and the dropless one
  (capacity pinned above the token count): the at-rest blocks against
  JAX's shards, the forward, aux, dropped and load, every leaf's gradient,
  3 SGD steps against ``build_moe_ep_(dropless_)train_step``, the
  two-stage codec-off step bit-equal to the flat one, the coded step
  against JAX's coded step, capacity overflow, and dropless routing under
  forced skew.

The ranks import torch and paddle_tpu_torch only; JAX runs in the test
bodies on the conftest's virtual CPU devices, rank r at device r.  fp32
tolerance 1e-5 of the largest magnitude unless stated.
"""

from __future__ import annotations

import fcntl
import json
import os
import time
import traceback

import numpy as np
import pytest
import torch

TOL = 1e-5
STEPS = 3
LR = 1e-2
SLICE_MAPS = {"s0011": (0, 0, 1, 1), "s0101": (0, 1, 0, 1)}
EP_SHAPE = (1, 2, 4)
EP_AXES = ("dp", "sharding", "ep")
CODEC_BLOCK = 64

# name -> (region, config, data).  "cap": JAX's _CFG; "drop": the ample
# dropless config of tests/test_moe_dropless.py (capacity above the token
# count); "overflow": top-1 at capacity factor 0.25 with every token sent
# to expert 1; "skew": top-1 at factor 6 with the gate's column 1 at 4.
CASES = {
    "cap": ("capacity", dict(d_model=8, d_hidden=16, num_expert=4, top_k=2,
                             capacity_factor=8.0, aux_weight=0.01), "a"),
    "drop": ("dropless", dict(d_model=16, d_hidden=32, num_expert=8, top_k=2,
                              capacity=128, aux_weight=0.01), "b"),
}
SKEW_CFG = dict(d_model=16, d_hidden=32, num_expert=8, top_k=1,
                capacity_factor=6.0, aux_weight=0.01)
OVERFLOW_CFG = dict(d_model=8, d_hidden=16, num_expert=4, top_k=1,
                    capacity_factor=0.25, aux_weight=0.01)


def _data(name):
    """The JAX tests' batches: "a" RandomState(1) [64, 8] (x, tgt), "b"
    default_rng(7) [64, 16]."""
    if name == "a":
        rng = np.random.RandomState(1)
        return (rng.randn(64, 8).astype(np.float32),
                rng.randn(64, 8).astype(np.float32))
    rng = np.random.default_rng(7)
    return (rng.standard_normal((64, 16)).astype(np.float32),
            rng.standard_normal((64, 16)).astype(np.float32))


def _exchange_x():
    return np.random.RandomState(0).randn(32, 8).astype(np.float32)


def _coded_x():
    return np.random.RandomState(3).randn(32, 8).astype(np.float32)


# ------------------------------------------------------------- the gangs

def _gang(name, target, world, tmp_path_factory):
    """Run (once per test run, whatever the xdist worker) ``target`` on
    ``world`` gloo ranks; return its results directory."""
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
                t0 = time.time()
                torch.multiprocessing.spawn(target, args=(world, str(root)),
                                            nprocs=world, join=True)
                (root / "done").write_text(json.dumps(
                    {"seconds": time.time() - t0}))
            except BaseException:
                (root / "failed").write_text(traceback.format_exc())
                raise
    return root


def _coll_rank(rank, world, root):
    """The exchanges on an ``x`` axis of 4 ranks, each rank's block of the
    JAX tests' inputs."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from paddle_tpu_torch.distributed.topology import hierarchical_axis
    from paddle_tpu_torch.parallel import compat, expert
    from paddle_tpu_torch.parallel.codec import CollectiveCodec
    from paddle_tpu_torch.parallel.overlap import register_hier
    from paddle_tpu_torch.parallel.specs import init_mesh

    store = dist.FileStore(os.path.join(root, "store"), world)
    mesh = init_mesh("cpu", (4,), ("x",), store=store, rank=rank,
                     world_size=world)
    hiers = {}
    for name, sm in SLICE_MAPS.items():
        hiers[name] = hierarchical_axis(mesh, "x", sm)
        register_hier(mesh, "x", hiers[name])
    blk = slice(rank * 8, (rank + 1) * 8)
    x = torch.from_numpy(_exchange_x()[blk])
    out = {"flat": compat._all_to_all_raw(x, "x", 0, 0, mesh, True).numpy()}
    for name, hier in hiers.items():
        ex = expert.make_ep_all_to_all("x", hier, mesh=mesh)
        out[f"two.{name}"] = ex(x).numpy()
        out[f"twice.{name}"] = ex(ex(x)).numpy()
        xg = x.clone().requires_grad_()
        w = torch.arange(xg.numel(), dtype=torch.float32).reshape(
            xg.shape) + 100.0 * rank
        (g,) = torch.autograd.grad(ex(xg), xg, w)
        out[f"grad.{name}"] = g.numpy()
        out[f"ex_w.{name}"] = ex(w).numpy()
    # the coded exchange, its packed rows captured as the codec made them
    packed = []
    encode = expert.encode_rows

    def spy(*a, **k):
        packed.append(encode(*a, **k))
        return packed[-1]

    expert.encode_rows = spy
    try:
        codec = CollectiveCodec(block=32)
        xc = torch.from_numpy(_coded_x()[blk])
        out["coded"] = expert.make_ep_all_to_all(
            "x", hiers["s0011"], codec, mesh=mesh)(xc).numpy()
        out["coded.packed"] = packed[-1].numpy()
    finally:
        expert.encode_rows = encode
    np.savez(os.path.join(root, f"coll.{rank}.npz"), **out)
    dist.barrier()


def _ep_rank(rank, world, root):
    """Every EP configuration on (dp, sharding, ep) = (1, 2, 4)."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from paddle_tpu_torch.models import gather_params, params_from_jax
    from paddle_tpu_torch.parallel import expert as pexp
    from paddle_tpu_torch.parallel.codec import CollectiveCodec
    from paddle_tpu_torch.parallel.overlap import OverlapConfig
    from paddle_tpu_torch.parallel.schedule import PartitionSchedule
    from paddle_tpu_torch.parallel.specs import init_mesh

    store = dist.FileStore(os.path.join(root, "store"), world)
    mesh = init_mesh("cpu", EP_SHAPE, EP_AXES, store=store, rank=rank,
                     world_size=world)
    hier_oc = OverlapConfig(hierarchical="on", slice_map=(0, 0, 1, 1))
    coded_oc = OverlapConfig(hierarchical="on", slice_map=(0, 0, 1, 1),
                             codec=CollectiveCodec(block=CODEC_BLOCK))
    builders = {
        "capacity": (pexp.build_moe_ep_forward, pexp.build_moe_ep_train_step),
        "dropless": (pexp.build_moe_ep_dropless_forward,
                     pexp.build_moe_ep_dropless_train_step)}

    def t(a):
        return torch.from_numpy(np.array(a))

    def save(name, out, all_ranks=False):
        if all_ranks or rank == 0:
            np.savez(os.path.join(root, f"{name}.{rank}.npz"), **out)

    for case, (region, cfg_kw, data) in CASES.items():
        cfg = pexp.MoEEPConfig(**cfg_kw)
        fwd_b, step_b = builders[region]
        x2d, tgt = map(t, _data(data))
        params = pexp.init_moe_ep_params(cfg, mesh, device="cpu")
        out = {f"rest/{k}": v.local.numpy() for k, v in params.items()}
        # the global JAX-side values cut by params_from_jax under the
        # block's schedule
        whole = pexp.init_moe_ep_params(cfg, device="cpu")
        cut = params_from_jax({k: v.numpy() for k, v in whole.items()},
                              "cpu", schedule=PartitionSchedule.from_moe_ep(
                                  cfg, mesh))
        out["converter_ok"] = np.array(all(
            torch.equal(cut[k].local, v.local) and cut[k].spec == v.spec
            for k, v in params.items()))
        fwd = fwd_b(cfg, mesh)
        blk = slice(rank * 8, (rank + 1) * 8)
        y, aux, dropped, load = fwd(params, x2d[blk])
        out.update(y=y.detach().numpy(), aux=aux.detach().numpy(),
                   dropped=dropped.numpy(), load=load.numpy())
        save(f"{case}.fwd", out, all_ranks=True)
        step = step_b(cfg, mesh, lr=LR)
        loss, *_, grads = step.gradients(params, x2d, tgt)
        out = {"loss": loss.numpy()}
        for k, g in grads.items():
            out[f"g/{k}"] = params[k].with_local(g).full().numpy()
        for oc_name, oc in (("flat", None), ("hier", hier_oc),
                            ("coded", coded_oc)):
            run = step_b(cfg, mesh, oc=oc, lr=LR)
            p = pexp.init_moe_ep_params(cfg, mesh, device="cpu")
            quanta = []
            if oc_name == "coded":
                encode = pexp.encode_rows

                def spy(rows, *a, **k):
                    # one quantum of each encoded row: its largest block
                    # absmax / 127
                    quanta.append(float(rows.abs().max()) / 127.0)
                    return encode(rows, *a, **k)

                pexp.encode_rows = spy
            try:
                for i in range(STEPS if oc_name != "coded" else 1):
                    if oc_name == "coded":
                        yc = run.forward(p, x2d[blk])[0]
                        out["coded.y"] = yc.detach().numpy()
                    loss_i, aux_i, drop_i, load_i, p = run(p, x2d, tgt)
                    out[f"{oc_name}.loss{i}"] = loss_i.numpy()
                    out[f"{oc_name}.dropped{i}"] = drop_i.numpy()
                    # copies: a replicated leaf's full() is its block,
                    # which the next step updates in place
                    for k, v in gather_params(p).items():
                        out[f"{oc_name}.p{i}/{k}"] = v.numpy().copy()
            finally:
                if oc_name == "coded":
                    pexp.encode_rows = encode
            if quanta:
                out["coded.quantum"] = np.float32(max(quanta))
        save(case, out, all_ranks=True)

    # capacity overflow: every token to expert 1 at capacity factor 0.25
    cfg = pexp.MoEEPConfig(**OVERFLOW_CFG)
    params = pexp.init_moe_ep_params(cfg, mesh, device="cpu")
    g = params["gate_w"].local
    g.zero_()
    g[:, 1] = 4.0
    x2d = t(np.abs(_data("a")[0]))
    y, aux, dropped, load = pexp.build_moe_ep_forward(cfg, mesh)(
        params, x2d[rank * 8:(rank + 1) * 8])
    save("overflow", {"y": y.detach().numpy(), "dropped": dropped.numpy()},
         all_ranks=True)

    # forced skew: capacity drops, dropless does not
    cfg = pexp.MoEEPConfig(**SKEW_CFG)
    x2d, tgt = map(t, _data("b"))
    x2d = x2d.abs() + 0.1
    out = {}
    for region, (_, step_b) in builders.items():
        params = pexp.init_moe_ep_params(cfg, mesh, device="cpu")
        params["gate_w"].local[:, 1] = 4.0
        loss, _, dropped, _, _ = step_b(cfg, mesh, oc=hier_oc)(params, x2d,
                                                               tgt)
        out[f"{region}.loss"] = loss.numpy()
        out[f"{region}.dropped"] = dropped.numpy()
    save("skew", out)
    dist.barrier()


@pytest.fixture(scope="module")
def coll4(tmp_path_factory):
    return _gang("ep_coll4", _coll_rank, 4, tmp_path_factory)


@pytest.fixture(scope="module")
def ep8(tmp_path_factory):
    return _gang("ep_gang8", _ep_rank, 8, tmp_path_factory)


# ---------------------------------------------------------------- JAX side

def _jax_mesh(shape, names):
    import jax
    from jax.sharding import Mesh

    n = int(np.prod(shape))
    devs = np.asarray(jax.devices("cpu")[:n], dtype=object)
    return Mesh(devs.reshape(shape), names)


def _x4(body, n_out=1):
    import jax
    from jax.sharding import PartitionSpec as P

    from paddle_tpu.common.jax_compat import shard_map

    out = P("x") if n_out == 1 else (P("x"),) * n_out
    return jax.jit(shard_map(body, mesh=_jax_mesh((4,), ("x",)),
                             in_specs=(P("x"),), out_specs=out,
                             check_vma=False))


def _ranks(root, name, key, n):
    return np.concatenate([np.load(root / f"{name}.{r}.npz")[key]
                           for r in range(n)])


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    den = np.abs(want).max()
    return float(np.abs(got - want).max() / (den if den > 0 else 1.0))


# ------------------------------------------------------- the transport

@pytest.mark.parametrize("sm", list(SLICE_MAPS))
def test_exchange_equals_jax_and_flat(coll4, sm):
    """Codec off: the two-stage exchange equals the flat one bit for bit,
    and both equal JAX's; exchange o exchange is the identity; the backward
    is the same exchange on the cotangent."""
    import jax.numpy as jnp

    from paddle_tpu.distributed.topology import hierarchical_axis
    from paddle_tpu.parallel import compat as jcompat
    from paddle_tpu.parallel.expert import _ep_exchange_impl

    x = jnp.asarray(_exchange_x())
    hier = hierarchical_axis(_jax_mesh((4,), ("x",)), "x",
                             slice_map=SLICE_MAPS[sm])
    flat = np.asarray(_x4(lambda v: jcompat.all_to_all(
        v, "x", split_axis=0, concat_axis=0, tiled=True))(x))
    two = np.asarray(_x4(lambda v: _ep_exchange_impl(v, "x", hier,
                                                     None))(x))
    np.testing.assert_array_equal(flat, two)
    np.testing.assert_array_equal(_ranks(coll4, "coll", "flat", 4), flat)
    np.testing.assert_array_equal(_ranks(coll4, "coll", f"two.{sm}", 4),
                                  two)
    np.testing.assert_array_equal(_ranks(coll4, "coll", f"twice.{sm}", 4),
                                  _exchange_x())
    np.testing.assert_array_equal(_ranks(coll4, "coll", f"grad.{sm}", 4),
                                  _ranks(coll4, "coll", f"ex_w.{sm}", 4))


def test_coded_exchange_bytes_and_error(coll4):
    """The coded two-stage exchange (int8 stochastic, block 32): each
    rank's packed inter-slice rows equal JAX's byte for byte, and the
    decoded output stays within one quantum of the flat exchange (1/127 of
    a block's absmax, 1.5x for the bf16 scale's rounding, as JAX's own
    test bounds it)."""
    import jax.numpy as jnp

    import paddle_tpu.parallel.expert as jexp
    from paddle_tpu.distributed.topology import hierarchical_axis
    from paddle_tpu.parallel import compat as jcompat
    from paddle_tpu.parallel.codec import CollectiveCodec

    hier = hierarchical_axis(_jax_mesh((4,), ("x",)), "x",
                             slice_map=SLICE_MAPS["s0011"])
    codec = CollectiveCodec(block=32)
    x = jnp.asarray(_coded_x())
    seen = []
    encode = jexp.encode_rows

    def spy(*a, **k):
        seen.append(encode(*a, **k))
        return seen[-1]

    jexp.encode_rows = spy
    try:
        coded, packed = _x4(lambda v: (jexp._ep_exchange_impl(
            v, "x", hier, codec), seen[-1]), n_out=2)(x)
    finally:
        jexp.encode_rows = encode
    np.testing.assert_array_equal(_ranks(coll4, "coll", "coded.packed", 4),
                                  np.asarray(packed))
    got = _ranks(coll4, "coll", "coded", 4)
    np.testing.assert_array_equal(got, np.asarray(coded))
    flat = np.asarray(_x4(lambda v: jcompat.all_to_all(
        v, "x", split_axis=0, concat_axis=0, tiled=True))(x))
    bound = np.abs(_coded_x()).max() / 127.0 * 1.5
    assert np.abs(got - flat).max() <= bound


# ------------------------------------------------------------ the regions

def _jax_cfg(case):
    from paddle_tpu.parallel.expert import MoEEPConfig

    return MoEEPConfig(**CASES[case][1])


def _jax_builders(region):
    import paddle_tpu.parallel.expert as jexp

    if region == "capacity":
        return jexp.build_moe_ep_forward, jexp.build_moe_ep_train_step
    return (jexp.build_moe_ep_dropless_forward,
            jexp.build_moe_ep_dropless_train_step)


def _jax_params(cfg, mesh, gate=None):
    import jax.numpy as jnp

    from paddle_tpu.parallel.expert import init_moe_ep_params

    p = init_moe_ep_params(cfg, mesh)
    if gate is not None:
        p["gate_w"] = gate(p["gate_w"])
    return {k: jnp.array(v, copy=True) for k, v in p.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_at_rest_blocks_equal_jax_shards(ep8, case):
    """``init_moe_ep_params(mesh=)``: rank r's block of every leaf is the
    shard JAX places on device r (the same mesh coordinate), and
    ``params_from_jax(schedule=from_moe_ep)`` cuts the global state into
    the same blocks."""
    from paddle_tpu.parallel.expert import init_moe_ep_params

    mesh = _jax_mesh(EP_SHAPE, EP_AXES)
    want = init_moe_ep_params(_jax_cfg(case), mesh)
    devs = list(mesh.devices.flat)
    for r in range(8):
        got = np.load(ep8 / f"{case}.fwd.{r}.npz")
        assert bool(got["converter_ok"])
        for k, v in want.items():
            shard = next(s for s in v.addressable_shards
                         if s.device == devs[r])
            np.testing.assert_array_equal(got[f"rest/{k}"],
                                          np.asarray(shard.data),
                                          err_msg=f"{k} rank {r}")


@pytest.mark.parametrize("case", list(CASES))
def test_forward_aux_dropped_load_match_jax(ep8, case):
    """The region's y (each rank's rows) and its global aux, dropped and
    load, on every rank, against JAX's region."""
    import jax

    region, _, data = CASES[case]
    mesh = _jax_mesh(EP_SHAPE, EP_AXES)
    cfg = _jax_cfg(case)
    x2d, _ = _data(data)
    y, aux, dropped, load = jax.jit(_jax_builders(region)[0](cfg, mesh))(
        _jax_params(cfg, mesh), x2d)
    assert _rel(_ranks(ep8, f"{case}.fwd", "y", 8), y) <= TOL
    for r in range(8):
        got = np.load(ep8 / f"{case}.fwd.{r}.npz")
        assert _rel(got["aux"], aux) <= TOL
        assert _rel(got["load"], load) <= TOL
        assert float(got["dropped"]) == float(dropped) == 0.0


@pytest.mark.parametrize("case", list(CASES))
def test_leaf_gradients_match_jax(ep8, case):
    """Every leaf's gradient of the step's loss against ``jax.grad`` of
    JAX's region: expert leaves reduced over dp and sharding only (a sum
    over ep would make them 4x), the gate over all three axes."""
    import jax

    from paddle_tpu.parallel.expert import _moe_loss

    region, _, data = CASES[case]
    mesh = _jax_mesh(EP_SHAPE, EP_AXES)
    cfg = _jax_cfg(case)
    x2d, tgt = _data(data)
    fwd = _jax_builders(region)[0](cfg, mesh)

    def loss(p):
        y, aux, _, _ = fwd(p, x2d)
        total, aux_term = _moe_loss(y, x2d, tgt, aux, cfg.aux_weight)
        return total / x2d.shape[0] + aux_term

    lv, grads = jax.jit(jax.value_and_grad(loss))(_jax_params(cfg, mesh))
    got = np.load(ep8 / f"{case}.0.npz")
    assert _rel(got["loss"], lv) <= TOL
    for k, g in grads.items():
        assert _rel(got[f"g/{k}"], g) <= TOL, k


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_match_jax(ep8, case):
    """3 SGD steps against JAX's ``build_moe_ep_(dropless_)train_step``:
    losses and params to 1e-5, nothing dropped; the two-stage step with
    the codec off equals the flat step bit for bit on every step."""
    region, _, data = CASES[case]
    mesh = _jax_mesh(EP_SHAPE, EP_AXES)
    cfg = _jax_cfg(case)
    x2d, tgt = _data(data)
    step = _jax_builders(region)[1](cfg, mesh, lr=LR)
    params = _jax_params(cfg, mesh)
    got = np.load(ep8 / f"{case}.0.npz")
    for i in range(STEPS):
        loss, _, dropped, _, params = step(params, x2d, tgt)
        assert _rel(got[f"flat.loss{i}"], loss) <= TOL
        assert float(got[f"flat.dropped{i}"]) == float(dropped) == 0.0
        for k, v in params.items():
            assert _rel(got[f"flat.p{i}/{k}"], v) <= TOL, (i, k)
            np.testing.assert_array_equal(got[f"hier.p{i}/{k}"],
                                          got[f"flat.p{i}/{k}"])
        np.testing.assert_array_equal(got[f"hier.loss{i}"],
                                      got[f"flat.loss{i}"])
    assert float(got[f"flat.loss{STEPS - 1}"]) < float(got["flat.loss0"])


@pytest.mark.parametrize("case", list(CASES))
def test_coded_step_matches_jax(ep8, case):
    """The fake-2-slice coded step (int8 stochastic on the inter-slice
    stage, block 64) against JAX's coded region and step.  The dispatched
    tokens are the same bits in both, so they encode alike; the expert
    outputs differ from XLA's in their last bits, and their stochastic
    rounding may then pick the other neighbouring quantum: each element
    of y within one quantum of the largest block per routed copy (top_k
    copies, raw weights <= 1) of JAX's, and the step's loss within the
    same budget."""
    import jax

    from paddle_tpu.parallel.codec import CollectiveCodec
    from paddle_tpu.parallel.overlap import OverlapConfig

    region, cfg_kw, data = CASES[case]
    mesh = _jax_mesh(EP_SHAPE, EP_AXES)
    cfg = _jax_cfg(case)
    x2d, tgt = _data(data)
    oc = OverlapConfig(hierarchical="on", slice_map=(0, 0, 1, 1),
                       codec=CollectiveCodec(block=CODEC_BLOCK))
    fwd_b, step_b = _jax_builders(region)
    y = np.asarray(jax.jit(fwd_b(cfg, mesh, oc=oc))(
        _jax_params(cfg, mesh), x2d)[0])
    loss = step_b(cfg, mesh, oc=oc, lr=LR)(_jax_params(cfg, mesh), x2d,
                                           tgt)[0]
    quantum = max(float(np.load(ep8 / f"{case}.{r}.npz")["coded.quantum"])
                  for r in range(8))
    budget = cfg_kw["top_k"] * quantum * 1.01 + TOL
    got = _ranks(ep8, case, "coded.y", 8)
    assert np.abs(got - y).max() <= budget
    # the codec moves the loss (JAX's flat step as the yardstick)
    flat = float(np.load(ep8 / f"{case}.0.npz")["flat.loss0"])
    coded = float(np.load(ep8 / f"{case}.0.npz")["coded.loss0"])
    assert abs(coded - float(loss)) <= 0.5 * abs(float(loss) - flat) + \
        1e-3 * abs(float(loss))


def test_capacity_overflow_surfaces(ep8):
    """Every token at expert 1 at capacity factor 0.25: the region reports
    the same global drop count as JAX's, above 0, and stays finite."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.parallel.expert import MoEEPConfig, build_moe_ep_forward

    mesh = _jax_mesh(EP_SHAPE, EP_AXES)
    cfg = MoEEPConfig(**OVERFLOW_CFG)
    params = _jax_params(cfg, mesh, gate=lambda g: jnp.zeros_like(g).at[
        :, 1].set(4.0))
    y, _, dropped, _ = jax.jit(build_moe_ep_forward(cfg, mesh))(
        params, np.abs(_data("a")[0]))
    for r in range(8):
        got = np.load(ep8 / f"overflow.{r}.npz")
        assert float(got["dropped"]) == float(dropped) > 0
    got_y = _ranks(ep8, "overflow", "y", 8)
    assert np.isfinite(got_y).all()
    assert _rel(got_y, y) <= TOL


def test_forced_skew_dropless_drops_nothing(ep8):
    """Top-1 routing skewed at expert 1 on the two-stage mesh: the capacity
    step drops assignments, the dropless one none, and both losses match
    JAX's steps."""
    import jax.numpy as jnp

    from paddle_tpu.parallel.expert import (MoEEPConfig,
                                            build_moe_ep_dropless_train_step,
                                            build_moe_ep_train_step)
    from paddle_tpu.parallel.overlap import OverlapConfig

    mesh = _jax_mesh(EP_SHAPE, EP_AXES)
    cfg = MoEEPConfig(**SKEW_CFG)
    x2d, tgt = _data("b")
    x2d = np.abs(x2d) + 0.1
    oc = OverlapConfig(hierarchical="on", slice_map=(0, 0, 1, 1))
    got = np.load(ep8 / "skew.0.npz")
    for region, build in (("capacity", build_moe_ep_train_step),
                          ("dropless", build_moe_ep_dropless_train_step)):
        params = _jax_params(cfg, mesh, gate=lambda g: g.at[:, 1].set(4.0))
        loss, _, dropped, _, _ = build(cfg, mesh, oc=oc)(
            params, jnp.asarray(x2d), jnp.asarray(tgt))
        assert _rel(got[f"{region}.loss"], loss) <= TOL
        assert float(got[f"{region}.dropped"]) == float(dropped)
    assert float(got["capacity.dropped"]) > 0
    assert float(got["dropless.dropped"]) == 0.0


# ---------------------------------------------------------- the plan

def test_from_moe_ep_and_layout_match_jax():
    """``PartitionSchedule.from_moe_ep`` and ``moe_ep_layout`` on the
    (1, 2, 4) mesh: the same tables as JAX's; ``dropless=True`` names
    ``ep_dropless`` with the same table; the spec vocabulary."""
    import paddle_tpu.parallel.expert as jexp
    from paddle_tpu.parallel.schedule import PartitionSchedule as JSched
    from paddle_tpu_torch.parallel import expert as pexp
    from paddle_tpu_torch.parallel.schedule import PartitionSchedule
    from paddle_tpu_torch.parallel.specs import Mesh

    jmesh = _jax_mesh(EP_SHAPE, EP_AXES)
    mesh = Mesh(EP_SHAPE, EP_AXES)
    kw = dict(d_model=16, d_hidden=32, num_expert=8)
    jcfg, cfg = jexp.MoEEPConfig(**kw), pexp.MoEEPConfig(**kw)
    assert pexp.moe_ep_layout(cfg, mesh).to_table() == \
        jexp.moe_ep_layout(jcfg, jmesh).to_table()
    for dropless in (False, True):
        got = PartitionSchedule.from_moe_ep(cfg, mesh, dropless=dropless)
        want = JSched.from_moe_ep(jcfg, jmesh, dropless=dropless)
        assert got.tactic_names() == want.tactic_names()
        assert got.table.to_table() == want.table.to_table()
    assert "ep_dropless" in PartitionSchedule.from_moe_ep(
        cfg, mesh, dropless=True).tactic_names()
    for name in ("w_up", "gate_w", "blocks.1.mlp.b_down"):
        assert tuple(pexp.moe_ep_spec_for(name)) == \
            tuple(jexp.moe_ep_spec_for(name))
    with pytest.raises(ValueError, match="not divisible by ep"):
        pexp.init_moe_ep_params(pexp.MoEEPConfig(8, 16, 6),
                                Mesh((1, 1, 4), EP_AXES), device="cpu")
