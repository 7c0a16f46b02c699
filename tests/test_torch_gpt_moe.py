"""GPT-MoE on the PyTorch port (paddle_tpu_torch/models/gpt_moe.py and the
nn layers it is built from) against the JAX package on the CPU.

The JAX model's weights cross with ``params_from_jax`` and
``load_state_dict`` (the parameter names and layouts are the same); ids and
labels come from numpy seeds.  On the CPU the JAX attention entry takes its
XLA softmax path and the port its plain HB versions; each MoE FFN runs
``MoELayer``'s capacity path in both.  Tolerances: fp32 1e-5 of the
output's largest magnitude, bf16 2e-2; drop counts exactly.  The legs
mirror tests/test_gpt_moe.py's eager-forward and alternating-block legs,
and add logits, CE, aux and ``tokens_dropped`` at the zero-init gate and at
random gates, and 3-step train trajectories with SGD and AdamW.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.models import GPTMoEConfig as JaxConfig
from paddle_tpu.models import GPTMoEForCausalLM as JaxModel
from paddle_tpu.models import build_moe_train_step as jax_build_step
from paddle_tpu.ops.nn_ops import layer_norm as jlayer_norm
from paddle_tpu.optimizer.optimizer import SGD as JaxSGD
from paddle_tpu.optimizer.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch import nn as pnn
from paddle_tpu_torch.incubate.distributed.models.moe import \
    moe_layer as player
from paddle_tpu_torch.models import (GPTMoEConfig, GPTMoEForCausalLM,
                                     apply_gpt_moe_sharding,
                                     build_moe_train_step, params_from_jax)
from paddle_tpu_torch.models import gpt_moe as pgpt
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import random as prandom
from paddle_tpu_torch.optimizer import SGD, AdamW

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    den = np.abs(want).max()
    return float(np.abs(got - want).max() / (den if den > 0 else 1.0))


def _data(cfg, batch=8, seq=16, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    labels = rng.randint(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    return ids, labels


def _pair(gate_scale=None, seed=0):
    """A JAX debug GPT-MoE (paddle.seed(seed)) and the port model carrying
    its weights; ``gate_scale``: N(0, gate_scale^2) gate weights set on the
    JAX model first (None keeps the zero init)."""
    state = paddle.get_rng_state()
    paddle.seed(seed)
    jm = JaxModel(JaxConfig.debug())
    paddle.set_rng_state(state)
    if gate_scale is not None:
        rng = np.random.RandomState(seed + 100)
        for blk in jm.blocks:
            if blk.use_moe:
                w = blk.mlp.gate.weight
                blk.mlp.gate.weight.set_value(jnp.asarray(
                    rng.randn(*w.shape).astype(np.float32) * gate_scale))
    js = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    pm = GPTMoEForCausalLM(GPTMoEConfig.debug(), device="cpu")
    pm.load_state_dict(params_from_jax(js, "cpu"))
    return jm, js, pm


def test_param_names_and_shapes_match_jax():
    jm, js, pm = _pair()
    got = [(k, tuple(v.shape)) for k, v in pm.functional_state().items()]
    assert got == [(k, v.shape) for k, v in js.items()]
    assert pm.blocks[1].mlp.w_up.is_expert
    assert pm.blocks[0].mlp[0].weight.shape == (32, 64)       # [in, out]
    assert pm.lm_head.bias is None


def test_eager_forward_and_aux():
    cfg = GPTMoEConfig.debug()
    prandom.seed(0)
    model = GPTMoEForCausalLM(cfg, device="cpu")
    ids, _ = _data(cfg, batch=2, seq=8)
    logits = model(torch.from_numpy(ids))
    assert tuple(logits.shape) == (2, 8, cfg.vocab_size)
    auxes = model.aux_losses()
    assert len(auxes) == cfg.num_hidden_layers // cfg.moe_every
    assert np.isfinite(float(auxes[0]))


def test_moe_blocks_alternate():
    model = GPTMoEForCausalLM(GPTMoEConfig.debug(), device="cpu")
    assert [blk.use_moe for blk in model.blocks] == [False, True]
    wide = GPTMoEConfig(vocab_size=64, hidden_size=32, num_hidden_layers=6,
                        num_attention_heads=2, ffn_hidden_size=32,
                        num_experts=2, moe_every=3, max_position_embeddings=16)
    assert [blk.use_moe for blk in GPTMoEForCausalLM(
        wide, device="cpu").blocks] == [False, False, True] * 2


def test_init_draws_from_the_port_generator():
    """Seeded construction repeats; Xavier-uniform Linear weights within
    their limit, zero biases, unit LayerNorm gains, zero gates."""
    prandom.seed(3)
    a = GPTMoEForCausalLM(GPTMoEConfig.debug(), device="cpu")
    prandom.seed(3)
    b = GPTMoEForCausalLM(GPTMoEConfig.debug(), device="cpu")
    for (k, v), w in zip(a.functional_state().items(),
                         b.functional_state().values()):
        assert torch.equal(v, w), k
    qkv = a.blocks[0].attn.qkv_proj
    assert qkv.weight.abs().max() <= (6 / (32 + 96)) ** 0.5
    assert not qkv.bias.any() and torch.equal(a.ln_f.weight, torch.ones(32))
    assert not a.blocks[1].mlp.gate.weight.any()


@pytest.mark.parametrize("gate_scale", [None, 0.5])
def test_logits_ce_aux_and_drops_match_jax(gate_scale):
    """fp32 logits, CE, each MoE block's aux and drop count against the JAX
    model: at the zero-init gate (all ties: every token to experts 0 and
    1, most of the second choices dropped at capacity 10 of 16 tokens)
    and at random gates."""
    jm, _, pm = _pair(gate_scale)
    ids, labels = _data(pm.cfg, batch=2, seq=8, seed=1)
    jl = np.asarray(jm(paddle.to_tensor(ids))._value)
    pl = pm(torch.from_numpy(ids))
    assert _rel(pl.detach().numpy(), jl) <= TOL["float32"]
    jaux = [float(a) for a in jm.aux_losses()]
    paux = [float(a) for a in pm.aux_losses()]
    np.testing.assert_allclose(paux, jaux, rtol=1e-5)
    jdrop = [float(b.mlp.tokens_dropped) for b in jm.blocks if b.use_moe]
    pdrop = [float(b.mlp.tokens_dropped) for b in pm.blocks if b.use_moe]
    assert pdrop == jdrop
    if gate_scale is None:
        assert pdrop[0] > 0
    lv = pl.detach().double()
    ce = (torch.logsumexp(lv, -1)
          - lv.gather(-1, torch.from_numpy(labels).long()[..., None])[..., 0]
          ).mean()
    jlv = jl.astype(np.float64)
    jce = (np.log(np.exp(jlv - jlv.max(-1, keepdims=True)).sum(-1))
           + jlv.max(-1) - np.take_along_axis(jlv, labels[..., None],
                                              -1)[..., 0]).mean()
    np.testing.assert_allclose(float(ce), jce, rtol=1e-6)


def test_gelu_forms_are_told_apart():
    """The dense FFN's nn.GELU is the exact erf form and the experts' gelu
    the tanh form: either one swapped moves the logits past the 1e-5
    gate."""
    jm, _, pm = _pair(0.5)
    ids, _ = _data(pm.cfg, batch=2, seq=8, seed=1)
    jl = np.asarray(jm(paddle.to_tensor(ids))._value)
    assert pm.blocks[0].mlp[1].approximate is False
    pm.blocks[0].mlp[1].approximate = True
    assert _rel(pm(torch.from_numpy(ids)).detach().numpy(), jl) > 1e-5
    pm.blocks[0].mlp[1].approximate = False
    saved = player._activation
    try:
        player._activation = lambda h, kind: F.gelu(h)
        assert _rel(pm(torch.from_numpy(ids)).detach().numpy(), jl) > 1e-5
    finally:
        player._activation = saved
    assert _rel(pm(torch.from_numpy(ids)).detach().numpy(), jl) <= 1e-5


def _trajectory(opt_name, gate_scale, dtype, steps=3, lr=1e-2):
    jm, js, pm = _pair(gate_scale, seed=2)
    ids, labels = _data(pm.cfg, seed=4)
    jopt = (JaxSGD(learning_rate=lr) if opt_name == "sgd"
            else JaxAdamW(learning_rate=lr))
    popt = SGD(learning_rate=lr) if opt_name == "sgd" else AdamW(lr)
    jstep = jax_build_step(jm, jopt, compute_dtype={
        "float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype])
    pstep = build_moe_train_step(pm, popt, compute_dtype={
        "float32": torch.float32, "bfloat16": torch.bfloat16}[dtype])
    jp = {k: jnp.asarray(v) for k, v in js.items()}   # the step donates
    jstate = jopt.init_state(jp)
    pp = pm.functional_state()
    pstate = popt.init_state(pp)
    out = []
    for i in range(steps):
        jce, jaux, jp, jstate = jstep(jp, jstate, i, lr, ids, labels)
        pce, paux, pp, pstate = pstep(pp, pstate, i, lr, ids, labels)
        drops = [float(b.mlp.tokens_dropped) for b in pm.blocks
                 if b.use_moe]
        out.append((float(jce), float(jaux), float(pce), float(paux), drops))
    return out, jp, pp


@pytest.mark.parametrize("gate_scale", [None, 0.5])
@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_train_step_trajectory_matches_jax(opt_name, gate_scale):
    """Three fp32 steps from the same weights (lr 1e-2): CE and aux each
    step within 1e-5 of JAX's, and every parameter after them (SGD and
    AdamW; the zero-init gate and random gates).  SGD's parameters are
    held to 1e-5 of each tensor's largest magnitude.  AdamW divides each
    gradient by its running RMS, so an update is lr times a ratio near 1
    that a gradient's last bits move by up to ~1e-4 where it nears
    epsilon: its parameters get 1e-4 lr of absolute slack per step, and
    the key third of each qkv bias is left out, since softmax ignores a
    shift shared by every key: its exact gradient is 0, and Adam turns the
    rounding noise in its place into updates of up to 0.1 lr."""
    lr, steps = 1e-2, 3
    out, jp, pp = _trajectory(opt_name, gate_scale, "float32", steps, lr)
    for jce, jaux, pce, paux, _ in out:
        np.testing.assert_allclose(pce, jce, rtol=TOL["float32"])
        np.testing.assert_allclose(paux, jaux, rtol=TOL["float32"])
    assert out[-1][2] < out[0][2]
    h = GPTMoEConfig.debug().hidden_size
    slack = 1e-4 * lr * steps if opt_name == "adamw" else 0.0
    for k, v in pp.items():
        got, want = v.numpy(), np.asarray(jp[k])
        if opt_name == "adamw" and k.endswith("attn.qkv_proj.bias"):
            got, want = (np.delete(a, np.s_[h:2 * h]) for a in (got, want))
        err = np.abs(got - want).max()
        assert err <= TOL["float32"] * np.abs(want).max() + slack, (k, err)


def test_train_step_bf16_matches_jax():
    """compute_dtype bf16: every float parameter cast first, the router in
    fp32 on the bf16-rounded gate weights; CE and aux of three AdamW steps
    within the bf16 gate of JAX's, gradients and updates in fp32."""
    out, jp, pp = _trajectory("adamw", 0.5, "bfloat16", lr=1e-3)
    for jce, jaux, pce, paux, _ in out:
        np.testing.assert_allclose(pce, jce, rtol=TOL["bfloat16"])
        np.testing.assert_allclose(paux, jaux, rtol=TOL["bfloat16"])
    assert all(v.dtype == torch.float32 for v in pp.values())


def test_train_step_runs_flash_entry_on_cpu_plain():
    """On the CPU every attention call takes the plain HB versions: no
    kernel launch is counted."""
    _, _, pm = _pair()
    ids, labels = _data(pm.cfg, batch=2, seq=8)
    fa.reset_launches()
    step = build_moe_train_step(pm, SGD(learning_rate=1e-2))
    pp = pm.functional_state()
    ce, aux, _, _ = step(pp, {}, 0, 1e-2, ids, labels)
    assert set(fa.LAUNCHES.values()) == {0}
    assert np.isfinite(float(ce)) and np.isfinite(float(aux))


def test_nn_layers_match_jax():
    """Linear ([in, out], x @ W + b), Embedding (padding row zero),
    LayerNorm (fp32 statistics, cast, then gain and bias), GELU (erf by
    default), Sequential and LayerList naming, against the JAX layers on
    the same weights."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    lin = pnn.Linear(16, 8, device="cpu")
    jlin = jnn.Linear(16, 8)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.asarray(jlin.weight._value)))
    assert _rel(lin(torch.from_numpy(x)).detach().numpy(),
                np.asarray(jlin(paddle.to_tensor(x))._value)) <= 1e-6
    assert pnn.Linear(4, 4, bias_attr=False, device="cpu").bias is None
    emb = pnn.Embedding(10, 4, padding_idx=2, device="cpu")
    assert not emb.weight[2].any()
    ids = np.array([[1, 2, 3]])
    assert not emb(ids)[0, 1].any()
    ln, jln = pnn.LayerNorm(16, device="cpu"), jnn.LayerNorm(16)
    assert _rel(ln(torch.from_numpy(x)).detach().numpy(),
                np.asarray(jln(paddle.to_tensor(x))._value)) <= 1e-6
    # bf16 input, fp32 gain and bias: normalised in fp32, cast to bf16,
    # then the fp32 affine (the result promotes to fp32, as in JAX)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jlayer_norm.raw_fn(xb, jnp.ones(16), jnp.zeros(16))
    got = ln(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    g = pnn.GELU()(torch.from_numpy(x))
    assert _rel(g.numpy(), np.asarray(jax.nn.gelu(x, approximate=False))) \
        <= 1e-6
    seq = pnn.Sequential(pnn.Linear(2, 3, device="cpu"), pnn.GELU(),
                         pnn.Linear(3, 2, device="cpu"))
    assert [n for n, _ in seq.named_parameters()] == [
        "0.weight", "0.bias", "2.weight", "2.bias"]
    named = pnn.Sequential(("a", pnn.GELU()), ("b", pnn.GELU()))
    assert list(dict(named.named_children())) == ["a", "b"]
    assert len(pnn.LayerList([pnn.GELU(), pnn.GELU()])) == 2
    with pytest.raises(NotImplementedError, match="A8"):
        pnn.Linear(2, 2, weight_attr=object(), device="cpu")


# since the dp x ep x mp plan is ported, a mesh must be a
# parallel.specs.Mesh, and the plan answers JAX's specs
@pytest.mark.parametrize("call", [
    lambda m: build_moe_train_step(m, SGD(), mesh=object()),
    lambda m: apply_gpt_moe_sharding(m, object()),
    lambda m: pgpt._param_specs("blocks.1.mlp.w_up"),
], ids=["step_mesh", "apply_sharding", "param_specs"])
def test_mesh_pieces_raise_citing_a5(call):
    from paddle_tpu.models.gpt_moe import _param_specs as jax_specs

    model = GPTMoEForCausalLM(GPTMoEConfig.debug(), device="cpu")
    try:
        got = call(model)
    except TypeError as e:
        assert "parallel.specs.Mesh" in str(e)
        return
    assert tuple(got) == tuple(jax_specs("blocks.1.mlp.w_up"))
