"""Sampling and beam search of the port's ``generate``
(paddle_tpu_torch/models/generation.py) against the JAX package on the CPU.

The debug Llama of tests/test_torch_serving.py crosses to the port through
``params_from_jax``, fp32.  JAX's PRNG bits cannot be reproduced, so
sampling is held by its filter (element for element against a jnp
transcription of ``paddle_tpu/models/generation.py:411-422``), by
``top_k=1`` against JAX's greedy tokens, by seed determinism and by the
distribution of 20k draws (total variation under 0.02).  Beam search is
exact: token ids equal JAX's ``_beam_search_jit`` at 1, 2 and 4 beams,
with and without an EOS that freezes beams, scores within 1e-5."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.models.generation import _beam_search_jit, register_config
from paddle_tpu.models.generation import generate as jax_generate
from paddle_tpu.models.generation import \
    self_draft_params as jax_self_draft_params
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     params_from_jax)
from paddle_tpu_torch.models.generation import (_beam_search, _sample,
                                                _sample_filter, generate,
                                                self_draft_params)
from test_torch_serving import DEBUG, _jax_tokens, _prompts


@pytest.fixture(scope="module")
def pair():
    state = paddle.get_rng_state()
    paddle.seed(20240806)
    jm = JaxModel(JaxConfig.debug(**DEBUG))
    paddle.set_rng_state(state)
    jstate = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    cfg = LlamaConfig.debug(**DEBUG)
    params = params_from_jax(jstate, "cpu")
    model = LlamaForCausalLM(cfg, device="cpu").load_functional_state(params)
    return jm, jstate, cfg, model, params


def _jax_filter(logits, temperature, top_k, top_p):
    """``paddle_tpu/models/generation.py:411-422`` transcribed in jnp."""
    logits = jnp.asarray(logits, jnp.float32)
    logits = logits / jnp.maximum(temperature, 1e-6)
    if top_k > 0:
        kth = jnp.sort(logits, axis=-1)[:, -top_k][:, None]
        logits = jnp.where(logits < kth, -jnp.inf, logits)
    if top_p < 1.0:
        sorted_l = jnp.sort(logits, axis=-1)[:, ::-1]
        probs = jax.nn.softmax(sorted_l, axis=-1)
        cum = jnp.cumsum(probs, axis=-1)
        cutoff_idx = jnp.sum(cum < top_p, axis=-1)
        cutoff = jnp.take_along_axis(sorted_l, cutoff_idx[:, None], axis=-1)
        logits = jnp.where(logits < cutoff, -jnp.inf, logits)
    return np.asarray(logits)


def _tied_logits(seed, rows=6, vocab=64):
    """Logits on a coarse grid, so that many ties fall on every cutoff."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-8, 8, (rows, vocab)) * 0.25).astype(np.float32)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.8, 50, 0.9), (0.7, 5, 1.0), (1.3, 0, 0.5),
    (0.5, 10, 0.3), (1e-9, 3, 0.95), (2.0, 64, 0.999)])
def test_sample_filter_matches_jax(temperature, top_k, top_p):
    """Same -inf set, same kept values, ties at both cutoffs included."""
    for seed in (0, 1):
        logits = _tied_logits(seed)
        want = _jax_filter(logits, temperature, top_k, top_p)
        got = _sample_filter(torch.from_numpy(logits), temperature, top_k,
                             top_p).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_array_equal(got, want)
    if top_k:      # ties at the k-th value are kept: more than k survive
        kept = np.isfinite(_jax_filter(logits, temperature, top_k, 1.0))
        assert (kept.sum(-1) >= min(top_k, logits.shape[1])).all()


def test_top_k_one_is_jax_greedy_and_seeded(pair):
    jm, _, cfg, model, _ = pair
    ids = np.stack(_prompts(cfg, 31, (7, 7)))
    want = _jax_tokens(jax_generate(jm, ids, max_new_tokens=10), 7)
    kw = dict(max_new_tokens=10, do_sample=True, temperature=0.7, top_k=1)
    got = generate(model, ids, seed=3, **kw)[:, 7:].numpy()
    np.testing.assert_array_equal(got, want)
    kw.update(top_k=20, top_p=0.95)
    a = generate(model, ids, seed=5, **kw)
    b = generate(model, ids, seed=5, **kw)
    c = generate(model, ids, seed=6, **kw)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.8, 50, 0.9), (1.5, 8, 1.0), (0.9, 0, 0.6)])
def test_sampling_distribution_tv(temperature, top_k, top_p):
    """20k draws of one logits row: total variation under 0.02 from the
    softmax of the filtered logits."""
    n = 20000
    row = np.random.default_rng(4).normal(size=(1, 64)).astype(np.float32) * 2
    logits = torch.from_numpy(np.repeat(row, n, axis=0))
    gen = torch.Generator().manual_seed(11)
    toks = _sample(logits, gen, True, temperature, top_k, top_p).numpy()
    want = torch.softmax(_sample_filter(logits[:1], temperature, top_k,
                                        top_p), -1)[0].double().numpy()
    got = np.bincount(toks, minlength=64) / n
    assert got[want == 0].sum() == 0
    assert 0.5 * np.abs(got - want).sum() < 0.02


def _eos_freezing(jm, ids):
    """The first prompt's most likely first token: as the EOS, it finishes
    a beam at the first step, so every later step freezes it."""
    return int(_jax_tokens(jax_generate(jm, ids[:1], max_new_tokens=1),
                           ids.shape[1])[0, 0])


@pytest.mark.parametrize("beams", [1, 2, 4])
@pytest.mark.parametrize("eos", [None, "freeze"])
def test_beam_search_matches_jax(pair, beams, eos):
    jm, jstate, cfg, _, params = pair
    ids = np.stack(_prompts(cfg, 33, (9, 9)))
    eos_id = -1 if eos is None else _eos_freezing(jm, ids)
    cid = register_config(jm.cfg)
    jparams = {k: jnp.asarray(v) for k, v in jstate.items()}
    want, wscore = _beam_search_jit(jparams, jnp.asarray(ids), cid, 8, beams,
                                    1.3, eos_id)
    got, score = _beam_search(cfg, params, torch.from_numpy(ids), 8, beams,
                              1.3, eos_id)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(score.numpy(), np.asarray(wscore), rtol=1e-5,
                               atol=1e-5)


def test_generate_num_beams_matches_jax(pair):
    jm, _, cfg, model, _ = pair
    ids = np.stack(_prompts(cfg, 33, (9, 9)))
    want = _jax_tokens(jax_generate(jm, ids, max_new_tokens=8, num_beams=2,
                                    length_penalty=1.3), 9)
    got = generate(model, ids, max_new_tokens=8, num_beams=2,
                   length_penalty=1.3)
    np.testing.assert_array_equal(got[:, 9:].numpy(), want)
    np.testing.assert_array_equal(got[:, :9].numpy(), ids)


def test_self_draft_params_matches_jax(pair):
    jm, jstate, cfg, _, params = pair
    jcfg, jd = jax_self_draft_params(jm.cfg, jstate, 1)
    dcfg, dp = self_draft_params(cfg, params, 1)
    assert dcfg.num_hidden_layers == jcfg.num_hidden_layers == 1
    assert {k: tuple(v.shape) for k, v in dp.items()} == \
        {k: tuple(v.shape) for k, v in jd.items()}
    assert all(dp[k] is params[k] for k in dp)          # shared, not copied
    with pytest.raises(ValueError):
        self_draft_params(cfg, params, cfg.num_hidden_layers + 1)
