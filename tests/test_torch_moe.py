"""MoE slice of the PyTorch port against the JAX package on the CPU: sparse
(Mixtral-shaped) Llama serving on float and int8 expert banks
(paddle_tpu_torch/models/generation.py ``_moe_ffn``, both engine paths),
weight-only int8 plumbing, and the dropless MoE train step
(paddle_tpu_torch/parallel/expert.py).

The toy sparse checkpoint is tests/test_expert_parallel.py's
``toy_sparse_llama``, copied here: a debug Llama whose every FFN is a
router and stacked ``[E, in, out]`` SwiGLU banks.  Its JAX state crosses to
the port through ``params_from_jax``.  fp32 throughout: ``_moe_ffn`` agrees
to 1e-5, greedy tokens exactly (``_generate_greedy`` and both port engine
paths against JAX ``_generate_jit``), the int8 quantization bit for bit,
and a 5-step dropless train trajectory (loss, aux, load, params) to 1e-5
relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.models import generation as jgen
from paddle_tpu.parallel import expert as jexp
from paddle_tpu_torch.inference.serving import ContinuousBatchingEngine
from paddle_tpu_torch.models import LlamaConfig, params_from_jax
from paddle_tpu_torch.models import generation as gen
from paddle_tpu_torch.ops import grouped_matmul as gm
from paddle_tpu_torch.parallel import expert as pexp

TOY = dict(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2, inter=128,
           max_pos=64)


def toy_sparse_llama(num_experts=4, top_k=2, seed=0):
    """A debug Llama whose every decoder FFN is a router + stacked expert
    bank (copy of tests/test_expert_parallel.py::toy_sparse_llama)."""
    cfg = JaxConfig.debug(**TOY)
    cfg = dataclasses.replace(cfg, num_experts=num_experts,
                              moe_top_k=top_k)
    paddle.seed(seed)
    model = JaxModel(cfg)
    params = {k: jnp.asarray(v)
              for k, v in model.functional_state().items()}
    rng = np.random.RandomState(seed)
    E, h, it = num_experts, cfg.hidden_size, cfg.intermediate_size
    out = {k: v for k, v in params.items() if ".mlp." not in k}
    for i in range(cfg.num_hidden_layers):
        pre = f"model.layers.{i}.mlp."
        out[pre + "router.weight"] = jnp.asarray(
            rng.randn(h, E).astype(np.float32) * 0.5)
        out[pre + "experts.gate_proj.weight"] = jnp.asarray(
            rng.randn(E, h, it).astype(np.float32) / np.sqrt(h))
        out[pre + "experts.up_proj.weight"] = jnp.asarray(
            rng.randn(E, h, it).astype(np.float32) / np.sqrt(h))
        out[pre + "experts.down_proj.weight"] = jnp.asarray(
            rng.randn(E, it, h).astype(np.float32) / np.sqrt(it))
    return cfg, out


def _port_cfg(jcfg):
    return dataclasses.replace(LlamaConfig.debug(**TOY),
                               num_experts=jcfg.num_experts,
                               moe_top_k=jcfg.moe_top_k)


@pytest.fixture(scope="module")
def sparse():
    """(JAX cfg, JAX params, port cfg, port params) for seeds 0 (fp32) and
    2 (its int8 form: the JAX quantization, crossed)."""
    state = paddle.get_rng_state()
    out = {}
    for name, seed, q in (("fp32", 0, False), ("int8", 2, True)):
        jcfg, jp = toy_sparse_llama(seed=seed)
        if q:
            jp = jgen.quantize_params_int8(jp)
        out[name] = (jcfg, jp, _port_cfg(jcfg),
                     params_from_jax({k: np.asarray(v)
                                      for k, v in jp.items()}, "cpu"))
    paddle.set_rng_state(state)
    return out


def _x(rows, seed=0):
    return np.random.RandomState(seed).randn(rows, TOY["hidden"]).astype(
        np.float32)


# ------------------------------------------------------------ int8 plumbing

def test_quantize_params_int8_bit_exact(sparse):
    jcfg, jp, _, _ = sparse["fp32"]
    want = jgen.quantize_params_int8(jp)
    got = gen.quantize_params_int8(params_from_jax(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu"))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert str(got[k].dtype).split(".")[-1] == v.dtype.name, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    bank = "model.layers.0.mlp.experts.gate_proj.weight"
    assert got[bank + "._scale"].shape == (jcfg.num_experts,
                                           jcfg.intermediate_size)
    assert got["model.layers.0.mlp.router.weight"].dtype == torch.float32


def test_params_from_jax_cast_leaves_int8_and_scales(sparse):
    """``dtype=`` casts floating weights only: an int8 dict crosses with
    its int8 banks and fp32 scales unchanged."""
    _, jp, _, _ = sparse["int8"]
    got = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu",
                          dtype=torch.bfloat16)
    for k, v in jp.items():
        v = np.asarray(v)
        if v.dtype == np.int8 or k.endswith("._scale"):
            assert got[k].dtype == (torch.int8 if v.dtype == np.int8
                                    else torch.float32), k
            np.testing.assert_array_equal(got[k].numpy(), v)
        else:
            assert got[k].dtype == torch.bfloat16, k


def test_weights_views_match_jax(sparse):
    """``_dt`` (first floating non-scale param), the dequantizing layer /
    embed / head views and the gather-then-dequant expert view."""
    jcfg, jp, cfg, params = sparse["int8"]
    jw, w = jgen._Weights(jcfg, jp), gen._Weights(cfg, params)
    assert w._dt == torch.float32 and jw._dt == jnp.float32
    ids = np.array([[3, 17, 9]], np.int32)
    idx = np.array([0, 3, 1], np.int32)
    x = _x(3)
    pairs = [
        (w.layer(0, "self_attn.q_proj.weight"),
         jw.layer(0, "self_attn.q_proj.weight")),
        (w.embed(torch.from_numpy(ids)), jw.embed(jnp.asarray(ids))),
        (w.head(torch.from_numpy(x)), jw.head(jnp.asarray(x))),
        (w.expert(1, "up_proj", torch.from_numpy(idx)),
         jw.expert(1, "up_proj", jnp.asarray(idx)))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    assert gen._Weights(cfg, {"a._scale": torch.ones(2),
                              "a": torch.zeros(2, dtype=torch.int8)}
                        )._dt == torch.bfloat16


def test_int8_engine_allocates_a_bf16_pool(sparse):
    """The engine's cache follows the JAX rule: the first non-scale
    param's dtype, bf16 when that is not floating (an int8 embedding)."""
    _, _, cfg, params = sparse["int8"]
    assert params["model.embed_tokens.weight"].dtype == torch.int8
    assert next(iter(params)) == "model.embed_tokens.weight"
    eng = ContinuousBatchingEngine(cfg, params, max_slots=2, num_pages=9,
                                   page_size=16, max_seq_len=64,
                                   device="cpu")
    assert eng.cache_dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in eng.k_pages + eng.v_pages)
    _, _, cfg32, p32 = sparse["fp32"]
    eng32 = ContinuousBatchingEngine(cfg32, p32, max_slots=2, num_pages=9,
                                     page_size=16, max_seq_len=64,
                                     device="cpu")
    assert eng32.cache_dtype == torch.float32


# ------------------------------------------------------------------ _moe_ffn

@pytest.mark.parametrize("kind", ["fp32", "int8"])
@pytest.mark.parametrize("layer", [0, 1])
def test_moe_ffn_matches_jax(sparse, kind, layer):
    jcfg, jp, cfg, params = sparse[kind]
    x = _x(7, seed=layer).reshape(1, 7, -1)
    want = np.asarray(jgen._moe_ffn(jgen._Weights(jcfg, jp), layer,
                                    jnp.asarray(x)))
    gm.reset_launches()
    got = gen._moe_ffn(gen._Weights(cfg, params), layer, torch.from_numpy(x))
    assert got.shape == (1, 7, TOY["hidden"])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert gm.LAUNCHES == dict.fromkeys(gm.LAUNCHES, 0)  # CPU: plain only


def test_moe_ffn_checks_raise(sparse):
    jcfg, _, cfg, params = sparse["fp32"]
    x = torch.from_numpy(_x(3))
    bad_k = dataclasses.replace(cfg, moe_top_k=5)
    with pytest.raises(ValueError, match="moe_top_k"):
        gen._moe_ffn(gen._Weights(bad_k, params), 0, x)
    cut = dict(params)
    cut["model.layers.0.mlp.router.weight"] = cut[
        "model.layers.0.mlp.router.weight"][:, :3]
    with pytest.raises(ValueError, match="stacked bank"):
        gen._moe_ffn(gen._Weights(cfg, cut), 0, x)


# --------------------------------------------------------- greedy serving

PROMPTS = [np.array([3, 17, 9, 42, 7], np.int32),
           np.array([11, 23, 64, 8, 1, 90, 33], np.int32)]
N_NEW = 8


def _jax_greedy(jcfg, jp, prompt):
    cfg_id = jgen.register_config(jcfg)
    out = jgen._generate_jit(jp, jnp.asarray(prompt[None]),
                             jax.random.PRNGKey(0), cfg_id, N_NEW, False,
                             1.0, 0, 1.0, -1)
    return np.asarray(out)[0]


@pytest.mark.parametrize("kind", ["fp32", "int8"])
def test_sparse_greedy_tokens_match_jax(sparse, kind):
    """``_generate_greedy`` and both engine paths of the port emit JAX
    ``_generate_jit``'s greedy tokens on the toy sparse model."""
    jcfg, jp, cfg, params = sparse[kind]
    refs = [_jax_greedy(jcfg, jp, p) for p in PROMPTS]
    for p, ref in zip(PROMPTS, refs):
        got = gen._generate_greedy(cfg, params, torch.from_numpy(p)[None],
                                   N_NEW, -1)
        np.testing.assert_array_equal(got[0].numpy(), ref)
    for extra in ({"decode_chunk_steps": 3},
                  {"prefill_token_budget": 8}):
        eng = ContinuousBatchingEngine(cfg, params, max_slots=2,
                                       num_pages=17, page_size=16,
                                       max_seq_len=64, device="cpu", **extra)
        for p in PROMPTS:
            eng.add_request(p, max_new_tokens=N_NEW)
        done = {f.rid: f.tokens for f in eng.run()}
        eng.shutdown()
        for rid, ref in enumerate(refs):
            np.testing.assert_array_equal(done[rid], ref)


# ---------------------------------------------------- dropless train step

def test_dropless_train_step_matches_jax():
    """5 steps of the port's dropless step against JAX's on a 1-device
    (dp, sharding, ep) = (1, 1, 1) mesh, fp32, block_rows 8: loss, aux,
    load and params within 1e-5 relative; dropped 0."""
    jcfg = jexp.MoEEPConfig(d_model=16, d_hidden=32, num_expert=4, top_k=2,
                            aux_weight=0.05)
    cfg = pexp.MoEEPConfig(d_model=16, d_hidden=32, num_expert=4, top_k=2,
                           aux_weight=0.05)
    mesh = Mesh(np.asarray(jax.devices("cpu")[:1], dtype=object)
                .reshape(1, 1, 1), ("dp", "sharding", "ep"))
    rng = np.random.RandomState(5)
    x = rng.randn(24, 16).astype(np.float32)
    tgt = rng.randn(24, 16).astype(np.float32)
    jstep = jexp.build_moe_ep_dropless_train_step(jcfg, mesh, block_rows=8)
    step = pexp.build_moe_ep_dropless_train_step(cfg, block_rows=8)
    jp = jexp.init_moe_ep_params(jcfg, seed=3)
    params = pexp.init_moe_ep_params(cfg, seed=3, device="cpu")
    for k in params:
        np.testing.assert_array_equal(params[k].numpy(), np.asarray(jp[k]))
    xt, tt = torch.from_numpy(x), torch.from_numpy(tgt)

    def close(got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(),
                                                      1e-30)

    losses = []
    for _ in range(5):
        jl, ja, jd, jload, jp = jstep(
            {k: jnp.array(v) for k, v in jp.items()}, jnp.asarray(x),
            jnp.asarray(tgt))
        loss, aux, dropped, load, params = step(params, xt, tt)
        close(loss, jl)
        close(aux, ja)
        close(load, jload)
        assert float(dropped) == float(jd) == 0.0
        for k in params:
            close(params[k].numpy(), jp[k])
        losses.append(float(loss))
    assert losses[-1] < losses[0]


def test_dropless_step_refuses_expert_parallel_and_overlap():
    cfg = pexp.MoEEPConfig(d_model=16, d_hidden=32, num_expert=4)

    class TwoDevices:
        shape = (1, 1, 2)

    with pytest.raises(NotImplementedError, match="A5"):
        pexp.build_moe_ep_dropless_train_step(cfg, TwoDevices())
    # since A5.2 an OverlapConfig is accepted at degree 1 (its codec inert,
    # as in JAX); anything else is refused
    from paddle_tpu_torch.parallel.overlap import OverlapConfig

    with pytest.raises(TypeError, match="OverlapConfig"):
        pexp.build_moe_ep_dropless_forward(cfg, oc=object())
    with pytest.raises(NotImplementedError, match="A5.3"):
        pexp.build_moe_ep_dropless_forward(cfg, TwoDevices(),
                                           oc=OverlapConfig())
    assert callable(pexp.build_moe_ep_dropless_forward(cfg,
                                                       oc=OverlapConfig()))
