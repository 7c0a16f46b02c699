"""Masked training of the PyTorch port (models/llama.py: the segment-id and
FlashMask branches of the forward, the mask normalisation, the
token-weighted masked accumulation of build_train_step) against the JAX
package on the CPU.

The debug Llama is built in JAX and its functional state crosses to the
port through ``params_from_jax``.  On the CPU the JAX model's segment-id
attention takes its XLA softmax path and its FlashMask attention the
Pallas kernels in interpret mode; the port takes the plain versions of B5
and B6.  Segment ids are packed documents with a padding tail (id 0), as
in packed pre-training.

Tolerances: fp32 logits 1e-5 of the largest logit (the same fp32 terms
summed in another order through two layers); train-step losses 2e-6
relative over 5 AdamW steps, as the unmasked trajectory of
tests/test_torch_training.py reads.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.models import build_train_step as jax_build_train_step
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops.pallas import flashmask as jfm
from paddle_tpu.optimizer.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     build_train_step, opt_state_from_jax,
                                     params_from_jax)
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import flashmask as fm
from paddle_tpu_torch.optimizer import AdamW


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _np(t):
    return t.detach().float().numpy()


def _val(x):
    return np.asarray(x._value if hasattr(x, "_value") else x)


@pytest.fixture(scope="module")
def pair():
    """A JAX debug Llama and its port twin with the same weights."""
    state = paddle.get_rng_state()
    paddle.seed(20240808)
    jm = JaxModel(JaxConfig.debug())
    paddle.set_rng_state(state)
    jstate = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    model = LlamaForCausalLM(LlamaConfig.debug(), device="cpu")
    model.load_functional_state(params_from_jax(jstate, "cpu"))
    return jm, jstate, model


def _documents(rng, rows, seq, pad):
    """[rows, seq] int32 ids of packed documents (1-based per row), with
    ``pad`` trailing padding tokens (id 0); and each row's lengths."""
    ids = np.zeros((rows, seq), np.int32)
    lens = []
    for r in range(rows):
        pos, row = 0, []
        while pos < seq - pad:
            n = min(int(rng.integers(3, 12)), seq - pad - pos)
            row.append(n)
            ids[r, pos:pos + n] = len(row)
            pos += n
        lens.append(row)
    return ids, lens


@pytest.mark.parametrize("mask", ["segments", "bool", "bands",
                                  "bands_per_head"])
def test_masked_logits_match_jax(pair, mask):
    """fp32 logits of LlamaForCausalLM.forward with segment ids (int and a
    bool keep-mask) and with FlashMask bands (broadcast and per kv head)
    vs the JAX model; no kernel launches on the CPU."""
    jm, _, model = pair
    cfg = model.cfg
    rng = np.random.default_rng(30)
    ids = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    kw = {}
    if mask == "segments":
        kw["attention_mask"] = _documents(rng, 2, 24, 5)[0]
    if mask == "bool":
        kw["attention_mask"] = np.arange(24)[None] < np.array([[24], [17]])
    if mask == "bands":
        kw["startend_row_indices"] = np.broadcast_to(
            np.asarray(jfm.share_question_row_indices(6, (10, 18), 24)),
            (2, 1, 24, 2)).copy()
    if mask == "bands_per_head":
        lo = np.maximum(np.arange(24) + 1, rng.integers(0, 24, (2, 2, 24)))
        kw["startend_row_indices"] = lo[..., None].astype(np.int32)
    want = _val(jm(paddle.to_tensor(ids),
                   **{k: paddle.to_tensor(v) for k, v in kw.items()}))
    fa.reset_launches()
    got = model(torch.from_numpy(ids),
                **{k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()})
    assert set(fa.LAUNCHES.values()) == {0}
    assert _rel(_np(got), want) <= 1e-5


def test_document_mask_logits_equal_segment_logits(pair):
    """The causal document mask as bands gives the logits of the same
    documents as segment ids (mirror of tests/test_flashmask.py ::
    test_llama_doc_mask_equals_segment_mask)."""
    _, _, model = pair
    rng = np.random.default_rng(31)
    seg, lens = _documents(rng, 1, 40, 0)
    ids = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (1, 40)))
    by_ids = model(ids, attention_mask=torch.from_numpy(seg))
    by_doc = model(ids, startend_row_indices=fm.causal_document_row_indices(
        lens[0]))
    assert _rel(_np(by_doc), _np(by_ids)) <= 1e-6


@pytest.mark.parametrize("accum", [1, 4])
def test_masked_train_step_trajectory_matches_jax(pair, accum):
    """5 fp32 AdamW steps of build_train_step with attention_mask = packed
    segment ids, port vs JAX, from the same weights and flat state.  At
    accum 4 micro-batch 2 is all padding: it weighs 0 on both sides.
    Every loss within 2e-6 relative of JAX's; the loss falls."""
    jm, jstate, model = pair
    cfg = model.cfg
    shape = (accum, 2, 16) if accum > 1 else (2, 16)
    rng = np.random.default_rng(40 + accum)
    ids = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    seg = _documents(rng, int(np.prod(shape[:-1])), 16, 3)[0].reshape(shape)
    if accum > 1:
        seg[2] = 0
    lr = 1e-3
    jopt = JaxAdamW(learning_rate=lr, parameters=jm.parameters(),
                    multi_precision=True)
    jstep = jax_build_train_step(jm, jopt, compute_dtype=jnp.float32,
                                 accum_steps=accum)
    jp = {k: jnp.asarray(v) for k, v in jstate.items()}
    jst = jopt.init_flat_state(jp, decay_mask=jllama.llama_decay_mask(jm))
    opt = AdamW(learning_rate=lr, multi_precision=True)
    step = build_train_step(model, opt, compute_dtype=torch.float32,
                            accum_steps=accum)
    # the step updates its params in place: leave the shared model alone
    tp = {k: v.clone() for k, v in model.functional_state().items()}
    tst = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jst), "cpu")
    jl, tl = [], []
    for i in range(5):
        loss, jp, jst = jstep(jp, jst, i, lr, ids, lab,
                              attention_mask=jnp.asarray(seg))
        jl.append(float(loss))
        loss, tp, tst = step(tp, tst, i, lr, ids, lab,
                             attention_mask=torch.from_numpy(seg))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=2e-6)
    assert tl[-1] < tl[0]


def test_all_padding_micro_batch_weighs_zero(pair):
    """The token-weighted accumulation: an all-padding micro-batch adds
    nothing, so accum 3 with one such micro-batch gives the loss and
    gradients of accum 2 without it; the total weight is clamped to 1
    only when every micro-batch is padding (loss 0, grads 0)."""
    _, _, model = pair
    rng = np.random.default_rng(50)
    ids = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (3, 2, 16)))
    seg = torch.from_numpy(_documents(rng, 6, 16, 4)[0].reshape(3, 2, 16))
    seg[1] = 0
    params = model.functional_state()
    opt = AdamW(1e-3)
    three = build_train_step(model, opt, compute_dtype=torch.float32,
                             accum_steps=3).accumulate
    two = build_train_step(model, opt, compute_dtype=torch.float32,
                           accum_steps=2).accumulate
    keep = torch.tensor([0, 2])
    l3, g3 = three(params, ids, ids, seg)
    l2, g2 = two(params, ids[keep], ids[keep], seg[keep])
    assert abs(float(l3) - float(l2)) <= 1e-6 * abs(float(l2))
    for k in g2:
        assert g3[k].dtype == torch.float32
        torch.testing.assert_close(g3[k], g2[k], rtol=1e-5, atol=1e-8)
    l0, g0 = three(params, ids, ids, torch.zeros_like(seg))
    assert float(l0) == 0.0 and all(not g.any() for g in g0.values())


def test_mask_normalisation_errors(pair):
    """As LlamaModel.forward: a float mask and negative ids raise
    TypeError, both masks together ValueError; the train step raises the
    same before any micro-step."""
    _, _, model = pair
    ids = torch.zeros(1, 8, dtype=torch.long)
    seg = torch.ones(1, 8, dtype=torch.int32)
    with pytest.raises(TypeError, match="bool keep-mask"):
        model(ids, attention_mask=seg.float())
    with pytest.raises(TypeError, match=">= 0"):
        model(ids, attention_mask=-seg)
    with pytest.raises(ValueError, match="not both"):
        model(ids, attention_mask=seg,
              startend_row_indices=torch.full((1, 1, 8, 1), 8))
    jm = pair[0]
    with pytest.raises(TypeError):
        jm(paddle.to_tensor(ids.numpy()),
           attention_mask=paddle.to_tensor(-seg.numpy()))
    opt = AdamW(1e-3)
    step = build_train_step(model, opt, compute_dtype=torch.float32)
    params = model.functional_state()
    with pytest.raises(TypeError):
        step(params, opt.init_state(params), 0, 1e-3, ids, ids,
             attention_mask=-seg)
    with pytest.raises(ValueError, match="does not match"):
        step(params, opt.init_state(params), 0, 1e-3, ids, ids,
             attention_mask=seg[:, :4])
