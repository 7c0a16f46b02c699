"""GPT-MoE and ``MoELayer`` on a dp x ep x mp mesh (paddle_tpu_torch/models/
gpt_moe.py ``apply_gpt_moe_sharding`` and ``build_moe_train_step(mesh=)``,
incubate/distributed/models/moe ``MoELayer(mesh=)`` and
``ClipGradForMOEByGlobalNorm`` on blocks) against the JAX package on the
CPU.

Two gloo gangs, one spawn each per test run (as tests/
test_torch_mesh_train.py): 8 ranks on (dp, ep, mp) = (2, 2, 2), and 4 ranks
on (1, 2, 2) then (2, 2, 1).  On each mesh the ranks place the JAX debug
model's weights (random gates), run 3 fp32 AdamW steps and the
``MoELayer`` legs, and write numpy results; each test holds them against
JAX's GSPMD step on the conftest's virtual CPU devices (rank r at device
r), against the port's ``mesh=None`` step, and the layer against JAX's
meshless ops (GSPMD partitions the same function).  Tolerances: fp32 1e-5
of the largest magnitude; AdamW parameters as tests/test_torch_gpt_moe.py
holds them.
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

TOL = 1e-5
LR = 1e-2
STEPS = 3
AXES = ("dp", "ep", "mp")
MESHES8 = {"dp2_ep2_mp2": (2, 2, 2)}
MESHES4 = {"ep2_mp2": (1, 2, 2), "dp2_ep2": (2, 2, 1),
           "ep2_mp2_tokens_on_ep": (1, 2, 2)}
# the step's data axes per mesh: ("dp",), as JAX's default, but for one
# mesh whose batch also splits over ep (the MoE layers then gather their
# ep line's tokens and reduce-scatter the outputs back)
DATA_AXES = {"ep2_mp2_tokens_on_ep": ("dp", "ep")}
GATE_SCALE = 0.5
# MoELayer legs: d_model, d_hidden, experts, tokens, clip norm
LAYER = dict(d_model=8, d_hidden=16, num_expert=4)
LAYER_TOKENS = 32
CLIP_NORM = 0.05


def _cfg(cls):
    return cls.debug()


def _batch():
    rng = np.random.RandomState(4)
    return (rng.randint(0, 128, (8, 16)).astype(np.int32),
            rng.randint(0, 128, (8, 16)).astype(np.int32))


def _layer_inputs():
    """(x [tokens, d_model], gate weight, output weights w) of the layer
    legs."""
    rng = np.random.RandomState(11)
    m, e = LAYER["d_model"], LAYER["num_expert"]
    return (rng.randn(LAYER_TOKENS, m).astype(np.float32),
            rng.randn(m, e).astype(np.float32),
            rng.randn(LAYER_TOKENS, m).astype(np.float32))


def _layer_shapes():
    m, h, e = (LAYER[k] for k in ("d_model", "d_hidden", "num_expert"))
    return {"gate.weight": (m, e), "w_up": (e, m, h), "b_up": (e, h),
            "w_down": (e, h, m), "b_down": (e, m)}


# ------------------------------------------------------------- the gangs

def _gang(name, meshes, world, tmp_path_factory):
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
                _prepare(root)
                t0 = time.time()
                torch.multiprocessing.spawn(
                    _rank_main, args=(world, str(root), meshes),
                    nprocs=world, join=True)
                (root / "done").write_text(json.dumps(
                    {"seconds": time.time() - t0}))
            except BaseException:
                (root / "failed").write_text(traceback.format_exc())
                raise
    return root


def _jax_model():
    """The JAX debug GPT-MoE (seeded) with N(0, GATE_SCALE^2) gates."""
    import jax.numpy as jnp

    import paddle_tpu as paddle
    from paddle_tpu.models import GPTMoEConfig as JaxConfig
    from paddle_tpu.models import GPTMoEForCausalLM as JaxModel

    state = paddle.get_rng_state()
    paddle.seed(2)
    jm = JaxModel(_cfg(JaxConfig))
    paddle.set_rng_state(state)
    rng = np.random.RandomState(102)
    for blk in jm.blocks:
        if blk.use_moe:
            w = blk.mlp.gate.weight
            w.set_value(jnp.asarray(
                rng.randn(*w.shape).astype(np.float32) * GATE_SCALE))
    return jm


def _prepare(root):
    jm = _jax_model()
    np.savez(root / "init.npz", **{k: np.asarray(v) for k, v in
                                   jm.functional_state().items()})


def _layer_legs(mesh, out):
    """MoELayer(mesh=) on both routes: y and dx of this rank's tokens,
    the gathered parameter gradients of sum(y * w) + 0.1 * aux, and the
    MoE clip on the blocks."""
    from paddle_tpu_torch.incubate.distributed.models.moe import (
        ClipGradForMOEByGlobalNorm, MoELayer)
    from paddle_tpu_torch.parallel.specs import ShardedTensor

    x, gate, w = _layer_inputs()
    shapes = _layer_shapes()
    for route in ("capacity", "dropless"):
        layer = MoELayer(**LAYER, mesh=mesh, ep_axis="ep", mp_axis="mp",
                         dropless=route == "dropless", device="cpu")
        with torch.no_grad():
            layer.gate.weight.copy_(torch.from_numpy(gate))
        data = layer._placement.data_axes
        b = LAYER_TOKENS // math.prod(int(mesh.shape[a]) for a in data)
        rows = slice(mesh.block_index(data) * b,
                     (mesh.block_index(data) + 1) * b)
        xb = torch.from_numpy(x[rows]).requires_grad_()
        y = layer(xb)
        loss = (y * torch.from_numpy(w[rows])).sum() + 0.1 * layer.l_aux
        named = dict(layer.named_parameters())
        grads = torch.autograd.grad(loss, [xb] + list(named.values()))
        out[f"{route}.y"] = y.detach().numpy()
        out[f"{route}.dx"] = grads[0].numpy()
        out[f"{route}.aux"] = layer.l_aux.detach().numpy()
        out[f"{route}.dropped"] = layer.tokens_dropped.numpy()
        blocks = {}
        for (k, p), g in zip(named.items(), grads[1:]):
            # partial over the token-splitting axes the block is not cut on
            st = ShardedTensor(g, shapes[k], p.placement.spec, mesh)
            blocks[k] = st.with_local(g, tuple(
                a for a in data if a not in st.axes_at_rest())).complete()
            out[f"{route}.g/{k}"] = blocks[k].full().numpy()
        clip = ClipGradForMOEByGlobalNorm(CLIP_NORM)
        clipped = clip(list(named.values()),
                       [blocks[k].local for k in named])
        out[f"{route}.clip.norms"] = np.array([clip.last_global_norm,
                                               clip.last_moe_norm])
        for (k, p), c in zip(named.items(), clipped):
            out[f"{route}.clip/{k}"] = blocks[k].with_local(c).full().numpy()


def _rank_main(rank, world, root, meshes):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from paddle_tpu_torch.models import (GPTMoEConfig, GPTMoEForCausalLM,
                                         apply_gpt_moe_sharding,
                                         build_moe_train_step, gather_params,
                                         params_from_jax)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.specs import init_mesh

    store = dist.FileStore(os.path.join(root, "store"), world)
    init = dict(np.load(os.path.join(root, "init.npz")))
    ids, labels = _batch()
    for mname, shape in meshes.items():
        mesh = init_mesh("cpu", shape, AXES, store=store, rank=rank,
                         world_size=world)
        model = GPTMoEForCausalLM(_cfg(GPTMoEConfig), device="cpu")
        model.load_state_dict(params_from_jax(init, "cpu"))
        apply_gpt_moe_sharding(model, mesh)
        params = model.functional_state()
        out = {f"rest/{k}": v.local.numpy().copy() for k, v in params.items()}
        cut = params_from_jax(init, "cpu", schedule=model.schedule)
        out["converter_ok"] = np.array(all(
            torch.equal(cut[k].local, v.local) for k, v in params.items()))
        opt = AdamW(learning_rate=LR)
        state = opt.init_state(params)
        step = build_moe_train_step(model, opt, mesh=mesh,
                                    data_axes=DATA_AXES.get(mname, ("dp",)))
        for i in range(STEPS):
            ce, aux, params, state = step(params, state, i, LR, ids, labels)
            out[f"ce{i}"], out[f"aux{i}"] = ce.numpy(), aux.numpy()
            out[f"dropped{i}"] = np.array(
                [float(b.mlp.tokens_dropped) for b in model.blocks
                 if b.use_moe])
            for k, v in gather_params(params).items():
                out[f"p{i}/{k}"] = v.numpy().copy()
        _layer_legs(mesh, out)
        np.savez(os.path.join(root, f"{mname}.{rank}.npz"), **out)
        dist.barrier()


@pytest.fixture(scope="module")
def gang8(tmp_path_factory):
    return _gang("gpt_moe_gang8", MESHES8, 8, tmp_path_factory)


@pytest.fixture(scope="module")
def gang4(tmp_path_factory):
    return _gang("gpt_moe_gang4", MESHES4, 4, tmp_path_factory)


def _root(request, mname):
    return request.getfixturevalue("gang8" if mname in MESHES8 else "gang4")


MESHES = {**MESHES8, **MESHES4}


# ---------------------------------------------------------------- JAX side

def _jax_mesh(shape):
    import jax
    from jax.sharding import Mesh

    devs = np.asarray(jax.devices("cpu")[:math.prod(shape)], dtype=object)
    return Mesh(devs.reshape(shape), AXES)


def _jax_run(mname):
    """JAX's build_moe_train_step(mesh=) on the same weights and batch: per
    step ce, aux and the params; and the model placed on the mesh."""
    import jax.numpy as jnp

    from paddle_tpu.models import apply_gpt_moe_sharding as japply
    from paddle_tpu.models import build_moe_train_step as jbuild
    from paddle_tpu.optimizer.optimizer import AdamW as JaxAdamW

    jm = _jax_model()
    mesh = _jax_mesh(MESHES[mname])
    japply(jm, mesh)
    params = {k: jnp.array(v, copy=True)
              for k, v in jm.functional_state().items()}
    opt = JaxAdamW(learning_rate=LR)
    state = opt.init_state(params)
    step = jbuild(jm, opt, mesh=mesh,
                  data_axes=DATA_AXES.get(mname, ("dp",)))
    ids, labels = _batch()
    out = {}
    for i in range(STEPS):
        ce, aux, params, state = step(params, state, i, LR, ids, labels)
        out[f"ce{i}"], out[f"aux{i}"] = np.asarray(ce), np.asarray(aux)
        for k, v in params.items():
            out[f"p{i}/{k}"] = np.asarray(v)
    return out, jm, mesh


def _meshless_run(root):
    """The port's mesh=None step on the same weights and batch."""
    from paddle_tpu_torch.models import (GPTMoEConfig, GPTMoEForCausalLM,
                                         build_moe_train_step,
                                         params_from_jax)
    from paddle_tpu_torch.optimizer import AdamW

    model = GPTMoEForCausalLM(_cfg(GPTMoEConfig), device="cpu")
    model.load_state_dict(params_from_jax(dict(np.load(root / "init.npz")),
                                          "cpu"))
    opt = AdamW(learning_rate=LR)
    params = model.functional_state()
    state = opt.init_state(params)
    step = build_moe_train_step(model, opt)
    ids, labels = _batch()
    out = {}
    for i in range(STEPS):
        ce, aux, params, state = step(params, state, i, LR, ids, labels)
        out[f"ce{i}"], out[f"aux{i}"] = ce.numpy(), aux.numpy()
        out[f"dropped{i}"] = np.array([float(b.mlp.tokens_dropped)
                                       for b in model.blocks if b.use_moe])
        for k, v in params.items():
            out[f"p{i}/{k}"] = v.numpy().copy()
    return out


def _check_params(got, want, i):
    """AdamW parameters after step i (tests/test_torch_mesh_train.py's
    rule): Adam moves a weight by about lr whatever its gradient's size,
    so an element whose near-zero gradient two summation orders give
    different last bits (or signs) may move up to 2 lr apart a step; all
    but 1e-3 of the model's elements agree to 1e-5 + 1e-5 relative.  The
    qkv bias's key third, whose exact gradient is 0 (softmax ignores a
    shift shared by every key), is left out."""
    h = 32
    off, total = 0, 0
    for k in [k for k in want if k.startswith(f"p{i}/")]:
        g, w = got[k], want[k]
        if k.endswith("attn.qkv_proj.bias"):
            g, w = (np.delete(a, np.s_[h:2 * h]) for a in (g, w))
        diff = np.abs(g - w)
        assert diff.max() <= 2 * LR * (i + 1) + 1e-6, k
        off += int((diff > 1e-5 + 1e-5 * np.abs(w)).sum())
        total += diff.size
    assert off <= 1e-3 * total, (off, total)


@pytest.mark.parametrize("mname", list(MESHES))
def test_train_steps_match_jax_and_meshless(request, mname):
    """3 fp32 AdamW steps on the mesh (the batch over ``dp``, or over
    ``dp`` and ``ep``): ce and aux each step within 1e-5 of JAX's GSPMD
    step and of the port's mesh=None step, the MoE layers'
    drop counts equal to mesh=None's, every parameter (gathered) as the
    rule of ``_check_params`` holds it against both."""
    root = _root(request, mname)
    got = dict(np.load(root / f"{mname}.0.npz"))
    want, _, _ = _jax_run(mname)
    ref = _meshless_run(root)
    for i in range(STEPS):
        for k in (f"ce{i}", f"aux{i}"):
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, err_msg=k)
            np.testing.assert_allclose(got[k], ref[k], rtol=TOL, err_msg=k)
        np.testing.assert_array_equal(got[f"dropped{i}"], ref[f"dropped{i}"])
        _check_params(got, want, i)
        _check_params(got, ref, i)
    assert float(got[f"ce{STEPS - 1}"]) < float(got["ce0"])


@pytest.mark.parametrize("mname", list(MESHES))
def test_at_rest_blocks_match_jax_shards(request, mname):
    """``apply_gpt_moe_sharding``: rank r's block of every parameter is the
    shard JAX's ``apply_gpt_moe_sharding`` places on device r, and
    ``params_from_jax(schedule=model.schedule)`` cuts the JAX state into
    the same blocks."""
    from paddle_tpu.models import apply_gpt_moe_sharding as japply

    root = _root(request, mname)
    jm = _jax_model()
    mesh = _jax_mesh(MESHES[mname])
    japply(jm, mesh)
    devs = list(mesh.devices.flat)
    for r in range(len(devs)):
        got = np.load(root / f"{mname}.{r}.npz")
        assert bool(got["converter_ok"])
        for k, v in jm.named_parameters():
            shard = next(s for s in v._value.addressable_shards
                         if s.device == devs[r])
            np.testing.assert_array_equal(got[f"rest/{k}"],
                                          np.asarray(shard.data),
                                          err_msg=f"{k} rank {r}")


def _jax_layer(route):
    """JAX's meshless op of the layer legs: (y, aux, dropped) and the
    gradients of sum(y * w) + 0.1 * aux in x and every parameter."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.incubate.distributed.models.moe.gate import (
        load_balance_aux_loss, moe_capacity)
    from paddle_tpu.incubate.distributed.models.moe.moe_layer import (
        _moe_dropless_op, _moe_forward_op)

    x, gate, w = _layer_inputs()
    m, h, e = (LAYER[k] for k in ("d_model", "d_hidden", "num_expert"))
    rng = np.random.RandomState(0)
    scale = 1.0 / m ** 0.5
    p = {"gate.weight": gate,
         "w_up": (rng.randn(e, m, h) * scale).astype(np.float32),
         "b_up": np.zeros((e, h), np.float32),
         "w_down": (rng.randn(e, h, m) * scale).astype(np.float32),
         "b_down": np.zeros((e, m), np.float32)}

    def f(x, p):
        args = (x, p["gate.weight"], p["w_up"], p["b_up"], p["w_down"],
                p["b_down"])
        if route == "dropless":
            y, aux, dropped = _moe_dropless_op.raw_fn(
                *args, topk=2, aux_fn=load_balance_aux_loss)
        else:
            y, aux, dropped = _moe_forward_op.raw_fn(
                *args, topk=2, capacity=moe_capacity(x.shape[0], 2, e, 1.2),
                aux_fn=load_balance_aux_loss)
        return jnp.sum(y * w) + 0.1 * aux, (y, aux, dropped)

    (_, (y, aux, dropped)), (dx, dp) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                         {k: jnp.asarray(v)
                                          for k, v in p.items()})
    return y, aux, dropped, dx, dp


def _rank_rows(root, mname, key):
    """The ranks' row blocks of ``key`` joined in token order (ranks that
    share rows hold equal copies, checked)."""
    shape = MESHES[mname]
    by_block = {}
    for r in range(math.prod(shape)):
        dp = np.unravel_index(r, shape)[0]
        v = np.load(root / f"{mname}.{r}.npz")[key]
        if dp in by_block:
            np.testing.assert_array_equal(v, by_block[dp])
        by_block[dp] = v
    return np.concatenate([by_block[b] for b in sorted(by_block)])


@pytest.mark.parametrize("route", ["capacity", "dropless"])
@pytest.mark.parametrize("mname", list(MESHES))
def test_moe_layer_on_mesh_matches_jax(request, mname, route):
    """``MoELayer(mesh=, ep_axis="ep", mp_axis="mp")``: y, dx, aux, the
    drop count and every parameter's gradient (gathered) against JAX's
    meshless op (the function GSPMD partitions), 1e-5."""
    root = _root(request, mname)
    y, aux, dropped, dx, dp = _jax_layer(route)

    def rel(a, b):
        b = np.asarray(b)
        return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)

    assert rel(_rank_rows(root, mname, f"{route}.y"), y) <= TOL
    assert rel(_rank_rows(root, mname, f"{route}.dx"), dx) <= TOL
    got = np.load(root / f"{mname}.0.npz")
    assert rel(got[f"{route}.aux"], aux) <= TOL
    assert float(got[f"{route}.dropped"]) == float(dropped)
    for k, g in dp.items():
        assert rel(got[f"{route}.g/{k}"], g) <= TOL, k


@pytest.mark.parametrize("mname", list(MESHES))
def test_moe_clip_on_blocks_equals_global_clip(request, mname):
    """``ClipGradForMOEByGlobalNorm`` on the layer's gradient blocks: the
    global and expert norms and the clipped gradients equal those of the
    same clip on the whole gradients on one device."""
    from paddle_tpu_torch.incubate.distributed.models.moe import (
        ClipGradForMOEByGlobalNorm, MoELayer)

    root = _root(request, mname)
    got = np.load(root / f"{mname}.0.npz")
    layer = MoELayer(**LAYER, device="cpu")
    names = list(_layer_shapes())
    for route in ("capacity", "dropless"):
        clip = ClipGradForMOEByGlobalNorm(CLIP_NORM)
        params = [dict(layer.named_parameters())[k] for k in names]
        whole = [torch.from_numpy(got[f"{route}.g/{k}"]) for k in names]
        out = clip(params, whole)
        np.testing.assert_allclose(
            got[f"{route}.clip.norms"],
            [clip.last_global_norm, clip.last_moe_norm], rtol=1e-6)
        assert clip.last_global_norm > CLIP_NORM
        for k, c in zip(names, out):
            np.testing.assert_allclose(got[f"{route}.clip/{k}"], c.numpy(),
                                       rtol=1e-6, atol=1e-9)
