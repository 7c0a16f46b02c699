"""Training slice of the PyTorch port (incubate/nn/fused.py, models/llama.py
forward/loss/build_train_step, optimizer/optimizer.py) against the JAX
package on the CPU.

Each op's forward and gradients are held to ``jax.vjp`` of its JAX
counterpart; the debug Llama's logits to the JAX model's; the train step's
loss trajectory and parameters to JAX's ``build_train_step`` from the same
weights (``params_from_jax``) and the same flat AdamW state
(``opt_state_from_jax``).  Inputs come from numpy seeds.  On the CPU the
JAX attention entry takes its XLA softmax path and the port its plain HB
versions, so the model-level comparisons also cross two attention
formulations.  Each tolerance is stated where it is used.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn import fused as jfused
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.models import build_train_step as jax_build_train_step
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops.nn_ops import _rms_norm_weighted
from paddle_tpu.optimizer.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch.incubate.nn.fused import (
    fused_rms_norm, fused_rotary_position_embedding, swiglu)
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     build_train_step, llama_decay_mask,
                                     opt_state_from_jax, params_from_jax)
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.optimizer import AdamW

# fp32: the same fp32 arithmetic in another order (1e-5 relative to the
# output's largest magnitude).  bf16: one bf16 rounding of either side may
# differ by an ulp, 2^-8 (the 2e-2 gate of bench.py).
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    den = np.abs(want).max()
    return float(np.abs(got - want).max() / (den if den > 0 else 1.0))


def _t(x, dt="float32", grad=False):
    t = torch.from_numpy(np.ascontiguousarray(x)).to(TDT[dt])
    return t.requires_grad_() if grad else t


def _np(t):
    return t.detach().float().numpy()


# ------------------------------------------------------------------ fused ops

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_fused_rms_norm_matches_jax_vjp(dt):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    dy = rng.standard_normal((3, 5, 64)).astype(np.float32)
    jy, vjp = jax.vjp(lambda a, b: _rms_norm_weighted(a, b, 1e-5),
                      jnp.asarray(x, JDT[dt]), jnp.asarray(w, JDT[dt]))
    jdx, jdw = vjp(jnp.asarray(dy, JDT[dt]))
    tx, tw = _t(x, dt, True), _t(w, dt, True)
    y = fused_rms_norm(tx, tw, 1e-5)
    y.backward(_t(dy, dt))
    assert y.dtype == TDT[dt] and tw.grad.dtype == TDT[dt]
    for got, want in ((y, jy), (tx.grad, jdx), (tw.grad, jdw)):
        assert _rel(_np(got), want) <= TOL[dt]
    # no weight: the plain normalisation
    np.testing.assert_allclose(
        _np(fused_rms_norm(_t(x), None, 1e-6)),
        np.asarray(jfused._fused_rms_norm_op.raw_fn(jnp.asarray(x), None,
                                                    1e-6)), rtol=1e-6)


@pytest.mark.parametrize("neox", [True, False])
def test_rope_matches_jax_vjp(neox):
    rng = np.random.default_rng(1)
    b, s, h, kvh, d = 2, 6, 4, 2, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    ang = rng.uniform(0, 6, (1, s, 1, d)).astype(np.float32)
    sin, cos = np.sin(ang), np.cos(ang)
    gq = rng.standard_normal(q.shape).astype(np.float32)
    gk = rng.standard_normal(k.shape).astype(np.float32)

    def jrope(q, k):
        return jfused._fused_rope_op.raw_fn(
            q, k, sin=jnp.asarray(sin), cos=jnp.asarray(cos),
            use_neox_rotary_style=neox)

    (jq, jk), vjp = jax.vjp(jrope, jnp.asarray(q), jnp.asarray(k))
    jdq, jdk = vjp((jnp.asarray(gq), jnp.asarray(gk)))
    tq, tk = _t(q, grad=True), _t(k, grad=True)
    oq, ok = fused_rotary_position_embedding(
        tq, tk, sin=_t(sin), cos=_t(cos), use_neox_rotary_style=neox)
    torch.autograd.backward((oq, ok), (_t(gq), _t(gk)))
    for got, want in ((oq, jq), (ok, jk), (tq.grad, jdq), (tk.grad, jdk)):
        assert _rel(_np(got), want) <= TOL["float32"]
    # bf16 q: sin/cos are cast to q's dtype, the output stays bf16
    (bq,) = fused_rotary_position_embedding(_t(q, "bfloat16"), sin=_t(sin),
                                            cos=_t(cos))
    assert bq.dtype == torch.bfloat16


def test_swiglu_matches_jax_vjp():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    y = rng.standard_normal((4, 32)).astype(np.float32)
    g = rng.standard_normal((4, 32)).astype(np.float32)
    jo, vjp = jax.vjp(jfused._swiglu_op.raw_fn, jnp.asarray(x),
                      jnp.asarray(y))
    jdx, jdy = vjp(jnp.asarray(g))
    tx, ty = _t(x, grad=True), _t(y, grad=True)
    o = swiglu(tx, ty)
    o.backward(_t(g))
    for got, want in ((o, jo), (tx.grad, jdx), (ty.grad, jdy)):
        assert _rel(_np(got), want) <= TOL["float32"]
    # one argument: its halves
    np.testing.assert_allclose(
        _np(swiglu(_t(np.concatenate([x, y], -1)))), np.asarray(jo),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_ce_loss_matches_jax_vjp(dt, masked):
    rng = np.random.default_rng(3)
    lv = (3 * rng.standard_normal((2, 5, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 5)).astype(np.int32)
    mask = rng.integers(0, 2, (2, 5)).astype(np.int32) if masked else None
    jl, vjp = jax.vjp(
        lambda a: jllama._ce_loss(a, jnp.asarray(labels),
                                  None if mask is None else jnp.asarray(mask),
                                  None, None), jnp.asarray(lv, JDT[dt]))
    (jg,) = vjp(jnp.ones((), jnp.float32))
    tl = _t(lv, dt, True)
    loss = tllama._ce_loss(tl, torch.from_numpy(labels),
                           None if mask is None else torch.from_numpy(mask))
    loss.backward()
    assert loss.dtype == torch.float32 and tl.grad.dtype == TDT[dt]
    assert _rel(_np(loss), jl) <= TOL["float32"]   # fp32 over exact inputs
    assert _rel(_np(tl.grad), jg) <= TOL[dt]
    # the gold logit is the label column itself, read in fp32
    np.testing.assert_array_equal(
        _np(tllama._gold_logit(_t(lv, dt), torch.from_numpy(labels))),
        np.asarray(jllama._gold_logit(jnp.asarray(lv, JDT[dt]),
                                      jnp.asarray(labels))))


# ---------------------------------------------------------------- the model

def _jax_pair(tie=False, **cfg_kw):
    """A JAX debug Llama and its port twin with the same weights."""
    state = paddle.get_rng_state()
    paddle.seed(20240807)
    jcfg = JaxConfig.debug(**cfg_kw)
    jcfg.tie_word_embeddings = tie
    jm = JaxModel(jcfg)
    paddle.set_rng_state(state)
    jstate = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    cfg = LlamaConfig.debug(**cfg_kw)
    cfg.tie_word_embeddings = tie
    model = LlamaForCausalLM(cfg, device="cpu").load_functional_state(
        params_from_jax(jstate, "cpu"))
    return jm, jstate, cfg, model


@pytest.mark.parametrize("tie", [False, True])
def test_model_logits_match_jax(tie):
    """fp32 logits of LlamaForCausalLM.forward on LlamaConfig.debug() vs the
    JAX model (its XLA attention path).  1e-5 of the largest logit: the two
    forwards sum the same fp32 terms in another order through two layers."""
    jm, _, cfg, model = _jax_pair(tie)
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                            (2, 24)).astype(np.int32)
    want = np.asarray(jm(paddle.to_tensor(ids))._value)
    fa.reset_launches()
    got = model(torch.from_numpy(ids))
    assert set(fa.LAUNCHES.values()) == {0}
    assert _rel(_np(got), want) <= TOL["float32"]
    # explicit position ids gather the rope phases per token
    pos = np.stack([np.arange(24), np.arange(24) + 5]).astype(np.int32)
    want = np.asarray(jm(paddle.to_tensor(ids),
                         position_ids=paddle.to_tensor(pos))._value)
    got = model(torch.from_numpy(ids), position_ids=torch.from_numpy(pos))
    assert _rel(_np(got), want) <= TOL["float32"]


def _train(jm, jstate, cfg, model, accum, steps, lr=1e-3):
    """Run ``steps`` fp32 AdamW steps of both train steps on one batch from
    the same flat state; returns (jax losses, port losses, jax params and
    port params after step 1)."""
    shape = (accum, 2, 16) if accum > 1 else (2, 16)
    rng = np.random.default_rng(5 + accum)
    ids = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    jopt = JaxAdamW(learning_rate=lr, parameters=jm.parameters(),
                    multi_precision=True)
    jstep = jax_build_train_step(jm, jopt, compute_dtype=jnp.float32,
                                 accum_steps=accum)
    jp = {k: jnp.asarray(v) for k, v in jstate.items()}
    jst = jopt.init_flat_state(jp, decay_mask=jllama.llama_decay_mask(jm))
    opt = AdamW(learning_rate=lr, multi_precision=True)
    step = build_train_step(model, opt, compute_dtype=torch.float32,
                            accum_steps=accum)
    tp = model.functional_state()
    tst = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jst), "cpu")
    jl, tl, after1 = [], [], None
    for i in range(steps):
        loss, jp, jst = jstep(jp, jst, i, lr, ids, lab)
        jl.append(float(loss))
        loss, tp, tst = step(tp, tst, i, lr, ids, lab)
        tl.append(float(loss))
        if i == 0:      # the port's step updates tp in place: copy it
            after1 = ({k: np.asarray(v) for k, v in jp.items()},
                      {k: _np(v).copy() for k, v in tp.items()})
    return np.array(jl), np.array(tl), after1


@pytest.mark.parametrize("accum", [1, 4])
def test_train_step_trajectory_matches_jax(accum):
    """Step-0 loss, a 5-step loss trajectory and the params after step 1 of
    the port's build_train_step vs JAX's, fp32, AdamW (lr 1e-3, decay 0.01,
    flat state).  Every loss within 1e-5 relative (read: 2e-6 at step 4).
    Params after step 1: Adam's first step moves every weight by about lr
    whatever the gradient's size, so a gradient element near 0 whose sign
    the two summation orders disagree on moves up to 2 lr apart; all other
    elements stay within 1e-5 + 1e-6 relative of JAX."""
    jm, jstate, cfg, model = _jax_pair()
    jl, tl, (jp1, tp1) = _train(jm, jstate, cfg, model, accum, 5)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]                          # same batch: it learns
    for k, want in jp1.items():
        got = tp1[k]
        diff = np.abs(got - want)
        assert diff.max() <= 2 * 1e-3 + 1e-6, k
        assert np.mean(diff > 1e-5 + 1e-6 * np.abs(want)) < 1e-3, k


def test_bf16_carry_matches_fp32_accumulator():
    """Mirror of tests/test_grad_accum_bf16_carry.py at accum 32: the bf16
    micro-grad carry (fold 8) vs the fp32 accumulator.  Losses come from
    identical forwards (exactly equal); each merged gradient within 5 % of
    the fp32 one in norm (depth-8 bf16 sums carry ~8 * 2^-9 = 1.6 % per
    element at worst)."""
    _, _, cfg, model = _jax_pair(vocab=64, hidden=32, layers=1, heads=2,
                                 kv_heads=1, inter=64, max_pos=64)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 64, (32, 1, 8))).long()
    lab = torch.from_numpy(rng.integers(0, 64, (32, 1, 8))).long()
    opt = AdamW(1e-2)
    params = model.functional_state()
    runs = {}
    for name, adt in (("fp32", torch.float32), ("bf16", torch.bfloat16),
                      ("default", None)):
        step = build_train_step(model, opt, compute_dtype=torch.float32,
                                accum_steps=32, accum_dtype=adt)
        runs[name] = step.accumulate(params, ids, lab)
    (l32, g32), (l16, g16), (ld, gd) = (runs["fp32"], runs["bf16"],
                                        runs["default"])
    assert float(l16) == float(l32)
    for k in g32:
        den = torch.linalg.norm(g32[k]).item()
        assert den > 0, k
        assert torch.linalg.norm(g16[k] - g32[k]).item() / den < 5e-2, k
        assert g16[k].dtype == torch.float32
    # fp32 compute: the default carry is the fp32 accumulator, exactly
    assert float(ld) == float(l32)
    for k in g32:
        assert torch.equal(gd[k], g32[k]), k


def test_accum_fold_table():
    for n in (64, 32, 12, 7, 13, 2, 1, 48, 9):
        assert tllama._accum_fold(n) == jllama._accum_fold(n), n
    assert tllama._accum_fold(64) == 8 and tllama._accum_fold(13) == 1


def test_decay_mask_matches_jax():
    jm, _, _, model = _jax_pair()
    assert llama_decay_mask(model) == jllama.llama_decay_mask(jm)


# ------------------------------------------------------------ fused AdamW

def _opt_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"layers.0.w": rng.standard_normal((16, 8)).astype(np.float32),
            "layers.0.norm.weight": np.ones(8, np.float32),
            "layers.1.w": rng.standard_normal((8, 8)).astype(np.float32),
            "head.bias": np.zeros(8, np.float32)}


BF16_KEYS = ("layers.0.w", "layers.1.w")
DECAY = {"layers.0.w": True, "layers.1.w": True,
         "layers.0.norm.weight": False, "head.bias": False}


def _opt_grads(params, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(v.shape).astype(np.float32)
            for k, v in params.items()}


def _torch_params(p32):
    return {k: _t(v, "bfloat16" if k in BF16_KEYS else "float32")
            for k, v in p32.items()}


def test_flat_matches_per_tensor_over_steps():
    """apply_flat vs the per-tensor apply, mixed dtypes and decay mask, 3
    steps: the same elementwise math on the same fp32 values, so the new
    params agree to fp32 rounding (1e-6)."""
    opt = AdamW(learning_rate=1e-3, weight_decay=0.05)
    p32 = _opt_params()
    p_ref = _torch_params(p32)
    p_flat = dict(p_ref)
    st_ref = opt.init_state(p_ref)
    st_flat = opt.init_flat_state(p_flat, decay_mask=DECAY)
    assert sorted(st_flat["__flat__"]) == ["decay|bfloat16",
                                           "nodecay|float32"]
    assert "master" in st_flat["__flat__"]["decay|bfloat16"]
    assert "master" not in st_flat["__flat__"]["nodecay|float32"]
    for step in range(1, 4):
        g = {k: _t(v, "bfloat16" if k in BF16_KEYS else "float32")
             for k, v in _opt_grads(p32, step).items()}
        p_ref, st_ref = opt.apply(p_ref, g, st_ref, 1e-3, step,
                                  decay_mask=DECAY)
        p_flat, st_flat = opt.apply_flat(p_flat, g, st_flat, 1e-3, step,
                                         decay_mask=DECAY)
        for k in p_ref:
            assert p_flat[k].dtype == p_ref[k].dtype
            np.testing.assert_allclose(_np(p_flat[k]), _np(p_ref[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k} step {step}")


def test_flat_matches_jax_apply_flat_bf16_master_from():
    """The port's apply_flat vs JAX's with bf16 params, fp32 masters from
    unrounded values (master_from) and the decay mask, over 3 steps: the
    masters and moments agree to fp32 rounding (1e-6 relative), the bf16
    params up to one bf16 rounding of nearly equal masters."""
    p32 = _opt_params(7)
    jparams = {k: jnp.asarray(v, jnp.bfloat16 if k in BF16_KEYS
                              else jnp.float32) for k, v in p32.items()}
    jopt = JaxAdamW(learning_rate=1e-3, weight_decay=0.05)
    jst = jopt.init_flat_state(jparams, decay_mask=DECAY,
                               master_from={k: jnp.asarray(v)
                                            for k, v in p32.items()})
    opt = AdamW(learning_rate=1e-3, weight_decay=0.05)
    tparams = _torch_params(p32)
    tst = opt.init_flat_state(tparams, decay_mask=DECAY,
                              master_from={k: _t(v) for k, v in p32.items()})
    for name, gs in jst["__flat__"].items():
        for key, val in gs.items():
            np.testing.assert_array_equal(tst["__flat__"][name][key].numpy(),
                                          np.asarray(val))
    for step in range(1, 4):
        g = _opt_grads(p32, 10 + step)
        jparams, jst = jopt.apply_flat(
            jparams, {k: jnp.asarray(v, jparams[k].dtype)
                      for k, v in g.items()}, jst, 1e-3, step,
            decay_mask=DECAY)
        tparams, tst = opt.apply_flat(
            tparams, {k: _t(v, "bfloat16" if k in BF16_KEYS else "float32")
                      for k, v in g.items()}, tst, 1e-3, step,
            decay_mask=DECAY)
    for name, gs in jst["__flat__"].items():
        for key, val in gs.items():
            np.testing.assert_allclose(tst["__flat__"][name][key].numpy(),
                                       np.asarray(val), rtol=1e-6,
                                       atol=1e-9, err_msg=f"{name}.{key}")
    for k, v in jparams.items():
        assert tparams[k].dtype == TDT[str(v.dtype)]
        assert _rel(_np(tparams[k]), np.asarray(v, np.float32)) <= 2 ** -8


def test_flat_state_guards():
    opt = AdamW(1e-3)
    p = _torch_params(_opt_params())
    st = opt.init_flat_state(p, decay_mask=DECAY)
    g = {k: torch.zeros_like(v) for k, v in p.items()}
    with pytest.raises(ValueError, match="init_flat_state"):
        opt.apply_flat(p, g, opt.init_state(p), 1e-3, 1)
    with pytest.raises(ValueError, match="missing"):
        opt.apply_flat(p, {k: g[k] for k in list(g)[1:]}, st, 1e-3, 1,
                       decay_mask=DECAY)
    with pytest.raises(ValueError, match="groups"):
        opt.apply_flat(p, g, st, 1e-3, 1)          # grouped without the mask


# ---------------------------------------------------------- unported routes

@pytest.mark.parametrize("option", ["mesh", "overlap", "memory", "health",
                                    "schedule", "remat", "remat_policy"])
def test_train_step_later_options_raise(option):
    """The health option is ported (tests/test_torch_health.py holds it
    against JAX): a value of the wrong type raises TypeError and a
    HealthConfig builds.  The memory
    engine's (``memory``, ``remat``, ``remat_policy``) are ported: a value
    of the wrong type raises TypeError, a valid one builds
    (tests/test_torch_memory.py holds them against JAX).  ``mesh`` and
    ``schedule`` are ported too: a value of the wrong type raises
    TypeError, and a mesh without process groups is refused (the mesh step
    runs on a live mesh, tests/test_torch_mesh_train.py).  ``overlap`` is
    ported (tests/test_torch_overlap.py): without a mesh it raises
    ValueError, as in JAX; on a live mesh a value of the wrong type raises
    TypeError and an OverlapConfig builds."""
    from paddle_tpu_torch.parallel import memory as M
    from paddle_tpu_torch.parallel import Mesh, OverlapConfig, \
        PartitionSchedule

    model = LlamaForCausalLM(LlamaConfig.debug(), device="cpu")
    if option == "overlap":
        with pytest.raises(ValueError, match="needs a mesh"):
            build_train_step(model, AdamW(1e-3), overlap=OverlapConfig())
        one = Mesh((1, 1, 1), ("dp", "sharding", "mp"), device_type="cpu")
        with pytest.raises(TypeError, match="overlap"):
            build_train_step(model, AdamW(1e-3), mesh=one, overlap=object())
        assert callable(build_train_step(model, AdamW(1e-3), mesh=one,
                                         overlap=OverlapConfig()))
        return
    if option in ("mesh", "schedule"):
        with pytest.raises(TypeError, match=option):
            build_train_step(model, AdamW(1e-3), **{option: object()})
        mesh = Mesh((1, 2, 2), ("dp", "sharding", "mp"))
        value = mesh if option == "mesh" else \
            PartitionSchedule.from_model(model, mesh)
        with pytest.raises(ValueError, match="live mesh"):
            build_train_step(model, AdamW(1e-3), **{option: value})
        return
    from paddle_tpu_torch.distributed.health import HealthConfig

    valid = {"memory": M.MemoryConfig(remat="full"), "remat": True,
             "remat_policy": M.named_save_policy(), "health": HealthConfig()}
    with pytest.raises(TypeError, match=option):
        build_train_step(model, AdamW(1e-3), **{option: object()})
    assert callable(build_train_step(model, AdamW(1e-3),
                                     **{option: valid[option]}))


def test_masked_routes_raise():
    """The masked routes run (masked kernels B5/B6, here their plain
    versions): one segment of all-valid ids, and the causal document mask
    of one document, equal the unmasked model (fp32 1e-5); the masked
    train step's loss equals the unmasked one's.  Full parity with JAX is
    in tests/test_torch_masked_training.py."""
    model = LlamaForCausalLM(LlamaConfig.debug(), device="cpu")
    ids = torch.from_numpy(np.random.default_rng(8).integers(
        0, model.cfg.vocab_size, (1, 8)))
    mask = torch.ones(1, 8, dtype=torch.int32)
    want = _np(model(ids))
    assert _rel(_np(model(ids, attention_mask=mask)), want) <= 1e-5
    doc = torch.from_numpy(np.full((1, 1, 8, 1), 8, np.int32))
    assert _rel(_np(model(ids, startend_row_indices=doc)), want) <= 1e-5
    opt = AdamW(1e-3)
    step = build_train_step(model, opt, compute_dtype=torch.float32)
    params = model.functional_state()
    # the step updates its params in place: each call gets its own copy
    masked = step({k: v.clone() for k, v in params.items()},
                  opt.init_state(params), 0, 1e-3, ids, ids,
                  attention_mask=mask)[0]
    plain = step({k: v.clone() for k, v in params.items()},
                 opt.init_state(params), 0, 1e-3, ids, ids)[0]
    assert abs(float(masked) - float(plain)) <= 1e-5 * abs(float(plain))


def test_optimizer_later_options_raise():
    """``lr_ratio``, ``grad_clip`` and regularizers are ported
    (tests/test_torch_optimizer.py holds them against JAX); so is the
    shard-major flat layout of multi-GPU training (tests/
    test_torch_mesh_specs.py and test_torch_mesh_train.py): anything but a
    ``FlatUpdateLayout`` is refused."""
    from paddle_tpu_torch.optimizer import ClipGradByGlobalNorm

    assert AdamW(1e-3, lr_ratio=lambda p: 1.0)._lr_ratio_fn is not None
    clip = ClipGradByGlobalNorm(1.0)
    assert AdamW(1e-3, grad_clip=clip)._grad_clip is clip
    opt = AdamW(1e-3)
    p = _torch_params(_opt_params())
    with pytest.raises(TypeError, match="FlatUpdateLayout"):
        opt.init_flat_state(p, flat_layout=object())
    st = opt.init_flat_state(p)
    with pytest.raises(TypeError, match="FlatUpdateLayout"):
        opt.apply_flat(p, p, st, 1e-3, 1, flat_layout=object())


# ----------------------------------------------- the in-place update (C.7)


def _functional_twin(step, opt, decay_mask):
    """The update as it was before it went in place: the step's gradient
    half, then the optimizer's functional ``apply_flat`` / ``apply``, which
    build new params and state beside the caller's."""
    def run(params, state, step_no, lr, ids, labels):
        loss, grads = step.accumulate(params, ids, labels)
        apply = opt.apply_flat if opt.state_is_flat(state) else opt.apply
        new_p, new_s = apply(params, grads, state, float(lr), step_no + 1,
                             decay_mask=decay_mask)
        return loss, new_p, new_s
    return run


def _tensors(tree):
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _c7_case(accum, flat, dtype=torch.float32):
    model = LlamaForCausalLM(LlamaConfig.debug(), device="cpu",
                             dtype=dtype,
                             generator=torch.Generator().manual_seed(7))
    opt = AdamW(learning_rate=1e-3, weight_decay=0.01)
    mask = llama_decay_mask(model)
    step = build_train_step(model, opt, compute_dtype=torch.bfloat16,
                            accum_steps=accum)
    shape = (accum, 2, 16) if accum > 1 else (2, 16)
    rng = np.random.default_rng(11 + accum)
    ids = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, shape))
    lab = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, shape))
    params = {k: v.detach().clone()
              for k, v in model.functional_state().items()}
    state = (opt.init_flat_state(params, decay_mask=mask) if flat
             else opt.init_state(params))
    return model, opt, mask, step, ids, lab, params, state


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "per_tensor"])
@pytest.mark.parametrize("accum", [1, 4])
def test_in_place_step_is_bit_equal_to_the_functional_step(accum, flat):
    """Five steps of the in-place step against its functional twin from
    the same params and state (bf16 params: the flat state's fp32 masters
    and the per-tensor state's): losses, params and every state tensor
    bit-equal; the step returns the caller's objects, overwritten."""
    _, opt, mask, step, ids, lab, p, st = _c7_case(accum, flat,
                                                   torch.bfloat16)
    twin = _functional_twin(step, opt, mask)
    tp = {k: v.clone() for k, v in p.items()}
    tst = {"__flat__": {g: {n: t.clone() for n, t in gs.items()}
                        for g, gs in st["__flat__"].items()}} if flat \
        else {k: {n: t.clone() for n, t in s.items()} for k, s in st.items()}
    ptrs = [t.data_ptr() for t in _tensors((p, st))]
    for i in range(5):
        loss, p2, st2 = step(p, st, i, 1e-3, ids, lab)
        assert p2 is p and st2 is st
        tloss, tp, tst = twin(tp, tst, i, 1e-3, ids, lab)
        assert torch.equal(loss, tloss), i
        for a, b in zip(_tensors((p, st)), _tensors((tp, tst))):
            assert a.dtype == b.dtype and torch.equal(a, b), i
    assert [t.data_ptr() for t in _tensors((p, st))] == ptrs


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "per_tensor"])
def test_fired_gate_leaves_the_callers_tensors_untouched(flat):
    """With ``health=``, a forced fired gate (a loss cutoff below the loss)
    returns the caller's params and state, the same objects, bit-identical;
    an open gate equals the unguarded step bit for bit, and its probe's
    update ratio is the functional update's (summed bucket by bucket)."""
    from paddle_tpu_torch.distributed.health import (HealthConfig,
                                                     make_probe)

    model, opt, mask, step, ids, lab, p, st = _c7_case(1, flat)
    hstep = build_train_step(model, opt, compute_dtype=torch.bfloat16,
                             health=HealthConfig())
    before = [t.clone() for t in _tensors((p, st))]
    loss, p2, st2, probe = hstep(p, st, 0, 1e-3, ids, lab,
                                 health_gates=np.array([-1.0, np.inf,
                                                        np.inf]))
    assert not probe["ok"] and p2 is p and st2 is st
    for a, b in zip(_tensors((p, st)), before):
        assert torch.equal(a, b)
    # the open gate: the same update as the step without health
    twin_p = {k: v.clone() for k, v in p.items()}
    twin_st = {"__flat__": {g: {n: t.clone() for n, t in gs.items()}
                            for g, gs in st["__flat__"].items()}} if flat \
        else {k: {n: t.clone() for n, t in s.items()} for k, s in st.items()}
    _, twin_grads = step.accumulate(twin_p, ids, lab)
    apply = opt.apply_flat if flat else opt.apply
    fp, _ = apply(twin_p, twin_grads, twin_st, 1e-3, 1, decay_mask=mask)
    want = make_probe(loss, twin_grads, twin_p, fp)
    hloss, _, _, probe = hstep(p, st, 0, 1e-3, ids, lab)
    loss1, p1, st1 = step(twin_p, twin_st, 0, 1e-3, ids, lab)
    assert probe["ok"] and torch.equal(hloss, loss1)
    for a, b in zip(_tensors((p, st)), _tensors((p1, st1))):
        assert torch.equal(a, b)
    np.testing.assert_allclose(probe["update_ratio"], want["update_ratio"],
                               rtol=1e-5)
    assert probe["grad_norm"] == want["grad_norm"]


# the in-place update's bucket edges: buckets of 997 fp32 elements, whose
# edges fall inside the debug model's leaves (the default 16 MB bucket
# holds a whole debug group)
_SMALL_BUCKET_BYTES = 4 * 997


@pytest.mark.parametrize("health", [False, True], ids=["plain", "health"])
@pytest.mark.parametrize("flat,dtype", [(True, torch.bfloat16),
                                        (True, torch.float32),
                                        (False, torch.bfloat16)],
                         ids=["flat_bf16", "flat_fp32", "per_tensor"])
def test_in_place_step_across_bucket_edges(flat, dtype, health,
                                           monkeypatch):
    """The in-place update in small buckets, leaf spans crossing them (bf16
    params with fp32 masters, fp32 params without): three steps bit-equal
    to the functional twin; under ``health=`` a fired gate leaves every
    tensor bit-identical and an open one is the twin's update, its update
    ratio the twin's to 1e-5 (the bucketed first pass sums the same
    squares in another order)."""
    from paddle_tpu_torch.distributed.health import (HealthConfig,
                                                     make_probe)
    from paddle_tpu_torch.parallel import memory as M

    monkeypatch.setattr(M, "IN_PLACE_BUCKET_BYTES", _SMALL_BUCKET_BYTES)
    model, opt, mask, step, ids, lab, p, st = _c7_case(1, flat, dtype)
    if flat:        # the premise: bucket edges inside leaves
        edges = crossing = 0
        for g in opt._flat_groups(p, mask):
            plan = M.stream_bucket_plan(sum(g["sizes"]), 4,
                                        M.IN_PLACE_BUCKET_BYTES)
            edges += len(plan) - 1
            crossing += sum(any(a < off < b for off, _ in plan[1:])
                            for _, a, b in M._key_spans(g))
        assert edges > 10 and crossing > 10, (edges, crossing)
    twin = _functional_twin(step, opt, mask)

    def copies(p, st):
        return ({k: v.clone() for k, v in p.items()},
                {"__flat__": {g: {n: t.clone() for n, t in gs.items()}
                              for g, gs in st["__flat__"].items()}} if flat
                else {k: {n: t.clone() for n, t in s.items()}
                      for k, s in st.items()})

    tp, tst = copies(p, st)
    if not health:
        for i in range(3):
            loss, p2, st2 = step(p, st, i, 1e-3, ids, lab)
            assert p2 is p and st2 is st
            tloss, tp, tst = twin(tp, tst, i, 1e-3, ids, lab)
            assert torch.equal(loss, tloss), i
            for a, b in zip(_tensors((p, st)), _tensors((tp, tst))):
                assert a.dtype == b.dtype and torch.equal(a, b), i
        return
    hstep = build_train_step(model, opt, compute_dtype=torch.bfloat16,
                             health=HealthConfig())
    _, p2, st2, probe = hstep(p, st, 0, 1e-3, ids, lab,
                              health_gates=np.array([-1.0, np.inf, np.inf]))
    assert not probe["ok"] and p2 is p and st2 is st
    for a, b in zip(_tensors((p, st)), _tensors((tp, tst))):
        assert torch.equal(a, b)
    tloss, tgrads = step.accumulate(tp, ids, lab)
    apply = opt.apply_flat if flat else opt.apply
    fp, fst = apply(tp, tgrads, tst, 1e-3, 1, decay_mask=mask)
    want = make_probe(tloss, tgrads, tp, fp)
    loss, p2, st2, probe = hstep(p, st, 0, 1e-3, ids, lab)
    assert probe["ok"] and p2 is p and st2 is st
    assert torch.equal(loss, tloss)
    for a, b in zip(_tensors((p, st)), _tensors((fp, fst))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    np.testing.assert_allclose(probe["update_ratio"], want["update_ratio"],
                               rtol=1e-5)


@pytest.fixture(scope="module")
def in_place_mesh(tmp_path_factory):
    """The four gloo ranks of ``torch_gang.in_place_rank``: their checks."""
    from torch_gang import in_place_rank, run_gang

    root = run_gang("in_place_mesh", in_place_rank, 4, tmp_path_factory)
    return [json.loads((root / f"in_place.{r}.json").read_text())
            for r in range(4)]


@pytest.mark.parametrize("case", ["flat_bf16", "flat_fp32", "per_tensor",
                                  "flat_bf16_health", "flat_fp32_health",
                                  "per_tensor_health", "host_fp32_health"])
def test_in_place_mesh_update_across_bucket_edges(in_place_mesh, case):
    """On a (1, 2, 2) gloo mesh in small buckets (each rank's shard-major
    rows crossing bucket edges, written back to the at-rest blocks as the
    stream passes them): three steps bit-equal to the functional
    ``apply_flat`` / ``apply`` on every rank; under ``health=`` a fired
    gate leaves every block bit-identical and an open one is the twin's
    update, its update ratio (the first pass's per-piece squares summed
    over the layout's axes) the twin's to 1e-5; the host-resident state's
    buckets (C.9) the same way, through both of its streamed passes."""
    assert not torch.distributed.is_initialized()
    for rank, out in enumerate(in_place_mesh):
        rec = out[case]
        if case.startswith("flat"):
            assert rec["buckets"] > 4 and rec["crossing"] > 4, (rank, rec)
        if case.endswith("health"):
            assert rec["fired_untouched"] and rec["open_bit_equal"], rank
            got, want = rec["ratio"]
            assert want > 0 and abs(got - want) <= 1e-5 * want, (rank, rec)
        else:
            assert rec["bit_equal"], rank
