"""Additive and decode-shaped masks, dropout and position ids in the port
(incubate/nn/attention.py, nn/functional.py, ops/nn_ops.py, ops/random.py,
incubate/nn/fused.py) against the JAX package on the CPU.

On the CPU the JAX attention entry takes its XLA softmax path
(``scaled_dot_product_attention``); the port sends the same masks to its
plain attention by the JAX entry's rule.  Same seeded numpy inputs, fp32
within 1e-5 of the largest magnitude, gradients through JAX's tape against
torch autograd.  Dropout draws different bits in the two packages, so it is
held by distribution: the keep rate within 3 sigma, the 1/(1 - p) scaling,
and the same mask for the same seed.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.nn.attention as jattn
import paddle_tpu.nn.functional as JF
from paddle_tpu.incubate.nn import fused as jfused
from paddle_tpu_torch.incubate.nn import attention as tattn
from paddle_tpu_torch.incubate.nn.fused import fused_rotary_position_embedding
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import random as trandom
from paddle_tpu_torch.ops.nn_ops import scaled_dot_product_attention as tsdpa

TOL = 1e-5


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    den = np.abs(want).max()
    return float(np.abs(got - want).max() / (den if den > 0 else 1.0))


def _qkv(b, sq, sk, h, kvh, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, kvh, d)).astype(np.float32),
            rng.standard_normal((b, sk, kvh, d)).astype(np.float32))


def _jax_attention(q, k, v, dy=None, **kw):
    """The JAX entry's output (and with ``dy`` the tape's q, k, v grads)."""
    ts = [paddle.to_tensor(x) for x in (q, k, v)]
    for t in ts:
        t.stop_gradient = dy is None
    out = jattn.flash_attention(*ts, **kw)
    if dy is None:
        return np.asarray(out._value)
    (out * paddle.to_tensor(dy)).sum().backward()
    return np.asarray(out._value), [np.asarray(t.grad._value) for t in ts]


def _port_attention(q, k, v, dy=None, **kw):
    ts = [torch.from_numpy(x.copy()).requires_grad_(dy is not None)
          for x in (q, k, v)]
    out = tattn.flash_attention(*ts, **kw)
    if dy is None:
        return out.detach().numpy()
    (out * torch.from_numpy(dy)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _masks(b, h, sq, sk, seed=1):
    rng = np.random.default_rng(seed)
    add = rng.standard_normal((b, 1, sq, sk)).astype(np.float32)
    add[rng.random((b, 1, sq, sk)) < 0.2] = -1e9           # masked entries
    return {
        "float_b1": add,
        "float_bh": rng.standard_normal((b, h, sq, sk)).astype(np.float32),
        "int": np.where(rng.random((b, 1, 1, sk)) < 0.3, -10000,
                        rng.integers(-2, 3, (b, 1, 1, sk))).astype(np.int32),
        "bool_4d": rng.random((b, 1, sq, sk)) < 0.8,
    }


CASES = [  # (mask, causal, b, sq, sk, h, kvh, d)
    ("float_b1", False, 2, 8, 8, 2, 2, 16),
    ("float_b1", True, 2, 8, 8, 4, 2, 16),        # GQA, causal
    ("float_bh", False, 1, 6, 10, 4, 1, 8),       # MQA, sq != sk
    ("int", False, 2, 8, 8, 2, 2, 16),
    ("int", True, 2, 5, 9, 4, 2, 16),             # bottom-right causal
    ("bool_4d", False, 2, 8, 8, 4, 2, 16),        # not a [b, sk] keep-mask
]


@pytest.mark.parametrize("mask,causal,b,sq,sk,h,kvh,d", CASES,
                         ids=[f"{c[0]}-{'causal' if c[1] else 'full'}-"
                              f"{c[3]}x{c[4]}-h{c[5]}kv{c[6]}" for c in CASES])
def test_masked_attention_and_grads_match_jax(mask, causal, b, sq, sk, h,
                                               kvh, d):
    q, k, v = _qkv(b, sq, sk, h, kvh, d)
    m = _masks(b, h, sq, sk)[mask]
    dy = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    jo, jg = _jax_attention(q, k, v, dy, causal=causal,
                            attn_mask=paddle.to_tensor(m))
    to, tg = _port_attention(q, k, v, dy, causal=causal,
                             attn_mask=torch.from_numpy(m))
    assert _rel(to, jo) <= TOL
    for got, want in zip(tg, jg):
        assert _rel(got, want) <= TOL


@pytest.mark.parametrize("sq", [1, 3])
@pytest.mark.parametrize("form", ["b_sk", "b11sk"])
def test_decode_shaped_bool_mask_matches_jax(sq, form):
    """A [b, sk] (or [b, 1, 1, sk]) keep-mask with sq != sk masks keys
    only: [b, 1, 1, sk] on the plain path."""
    b, sk, h, kvh, d = 3, 12, 4, 2, 16
    q, k, v = _qkv(b, sq, sk, h, kvh, d, seed=3)
    keep = np.arange(sk)[None, :] < np.array([12, 7, 3])[:, None]
    if form == "b11sk":
        keep = keep[:, None, None, :]
    jo = _jax_attention(q, k, v, attn_mask=paddle.to_tensor(keep))
    to = _port_attention(q, k, v, attn_mask=torch.from_numpy(keep))
    assert _rel(to, jo) <= TOL


def test_causal_sq_ne_sk_without_mask_matches_jax(monkeypatch):
    """Causal attention with sq != sk (the kernels refuse it) takes the
    plain path, aligned bottom-right; no kernel is called."""
    q, k, v = _qkv(2, 4, 10, 4, 2, 16, seed=4)
    dy = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)
    calls = []
    monkeypatch.setattr(fa._FlashHB, "apply",
                        lambda *a: calls.append("hb") or None)
    monkeypatch.setattr(fa._Flash, "apply",
                        lambda *a: calls.append("masked") or None)
    jo, jg = _jax_attention(q, k, v, dy, causal=True)
    to, tg = _port_attention(q, k, v, dy, causal=True)
    assert calls == []
    assert _rel(to, jo) <= TOL
    for got, want in zip(tg, jg):
        assert _rel(got, want) <= TOL


def test_bf16_additive_mask_within_bf16_gate():
    q, k, v = _qkv(2, 16, 16, 4, 2, 32, seed=6)
    m = _masks(2, 4, 16, 16)["float_b1"]
    want = _jax_attention(q, k, v, causal=True, attn_mask=paddle.to_tensor(m))
    got = tattn.flash_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        causal=True, attn_mask=torch.from_numpy(m))
    assert got.dtype == torch.bfloat16
    assert _rel(got.float().numpy(), want) <= 2e-2


def test_keep_mask_routes_by_dropout(monkeypatch):
    """A [b, sk] bool keep-mask at sq == sk takes the masked kernels
    without dropout and the plain path (its equality mask) with it; so do
    segment ids."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 8, 8, 2, 2, 16, seed=7))
    keep = torch.arange(8)[None, :] < torch.tensor([8, 5])[:, None]
    seen = []
    real = fa._Flash.apply

    def spy(*a):
        seen.append("masked")
        return real(*a)

    monkeypatch.setattr(fa._Flash, "apply", spy)
    tattn.flash_attention(q, k, v, attn_mask=keep)
    assert seen == ["masked"]
    trandom.seed(3)
    drop = tattn.flash_attention(q, k, v, attn_mask=keep, dropout=0.2)
    trandom.seed(3)
    seg = keep.int()
    drop_seg = tattn.flash_attention(q, k, v, dropout=0.2, q_segment_ids=seg,
                                     kv_segment_ids=seg)
    assert seen == ["masked"]
    trandom.seed(3)
    mask = trandom.bernoulli(0.8, (2, 2, 8, 8), "cpu")
    want = tsdpa(q, k, v, attn_mask=(seg[:, :, None] == seg[:, None, :])
                 [:, None], dropout_mask=mask, dropout_p=0.2)
    # the keep-mask: every query attends its row's kept keys
    want_keep = tsdpa(q, k, v, attn_mask=keep[:, None, None, :],
                      dropout_mask=mask, dropout_p=0.2)
    assert torch.equal(drop_seg, want)
    assert torch.equal(drop, want_keep)


def _uniform_dropout_outputs(p, seed, b=4, s=64, h=4, d=8):
    """q = 0 (uniform attention) and v = 1: each output entry is the kept
    share of its row scaled by 1/(1 - p), mean 1."""
    trandom.seed(seed)
    q = torch.zeros(b, s, h, d)
    v = torch.ones(b, s, h, d)
    return tattn.flash_attention(q, q, v, dropout=p)


def test_dropout_by_distribution():
    p, b, s, h = 0.3, 4, 64, 4
    out = _uniform_dropout_outputs(p, seed=11)
    trandom.seed(11)
    mask = trandom.bernoulli(1 - p, (b, h, s, s), "cpu")
    n = mask.numel()
    keep = float(mask.float().mean())
    sigma = (p * (1 - p) / n) ** 0.5
    assert abs(keep - (1 - p)) <= 3 * sigma
    # each output entry: the row's kept count / s / (1 - p)
    rows = mask.float().sum(-1).permute(0, 2, 1) / s / (1 - p)
    assert torch.allclose(out[..., 0], rows, rtol=1e-6, atol=1e-6)
    assert abs(float(out.mean()) - 1.0) <= 3 * sigma / (1 - p)
    # the JAX entry under the same law: its mean lies within 3 sigma too
    jout = _jax_attention(*(np.asarray(t) for t in (
        torch.zeros(b, s, h, 8), torch.zeros(b, s, h, 8),
        torch.ones(b, s, h, 8))), dropout=p)
    assert abs(float(jout.mean()) - 1.0) <= 3 * sigma / (1 - p)
    # same seed, same mask; another seed, another one
    assert torch.equal(_uniform_dropout_outputs(p, seed=11), out)
    assert not torch.equal(_uniform_dropout_outputs(p, seed=12), out)


def test_dropout_gradient_flows_through_kept_weights():
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(1, 8, 8, 2, 2, 16, seed=13))
    trandom.seed(5)
    tattn.flash_attention(q, k, v, causal=True, dropout=0.5).sum().backward()
    trandom.seed(5)
    mask = trandom.bernoulli(0.5, (1, 2, 8, 8), "cpu")
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    tsdpa(q2, k2, v2, dropout_mask=mask, dropout_p=0.5,
          is_causal=True).sum().backward()
    for a, b in ((q, q2), (k, k2), (v, v2)):
        assert torch.equal(a.grad, b.grad)


def test_sdpa_functional_matches_jax():
    """``nn.functional.scaled_dot_product_attention`` without dropout (or
    not training) equals JAX's ``scaled_dot_product_attention_``."""
    q, k, v = _qkv(2, 6, 6, 2, 2, 16, seed=14)
    m = _masks(2, 2, 6, 6)["float_bh"]
    args = [paddle.to_tensor(x) for x in (q, k, v)]
    for kw in (dict(), dict(is_causal=True),
               dict(attn_mask=m), dict(dropout_p=0.4, training=False)):
        jkw = dict(kw)
        if "attn_mask" in kw:
            jkw["attn_mask"] = paddle.to_tensor(m)
            kw = dict(kw, attn_mask=torch.from_numpy(m))
        want = np.asarray(JF.scaled_dot_product_attention_(*args, **jkw)
                          ._value)
        got = TF.scaled_dot_product_attention(
            *(torch.from_numpy(x) for x in (q, k, v)), **kw)
        assert _rel(got.numpy(), want) <= TOL
    trandom.seed(9)
    a = TF.scaled_dot_product_attention(*(torch.from_numpy(x)
                                          for x in (q, k, v)), dropout_p=0.4)
    trandom.seed(9)
    mask = trandom.bernoulli(0.6, (2, 2, 6, 6), "cpu")
    assert torch.equal(a, tsdpa(*(torch.from_numpy(x) for x in (q, k, v)),
                                dropout_mask=mask, dropout_p=0.4))


def test_flash_attention_functional_dropout():
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 8, 8, 2, 2, 16, seed=15))
    trandom.seed(1)
    out, sm = TF.flash_attention(q, k, v, dropout=0.25, causal=True,
                                 return_softmax=True)
    trandom.seed(1)
    assert sm is None
    assert torch.equal(out, tattn.flash_attention(q, k, v, causal=True,
                                                  dropout=0.25))
    assert torch.equal(TF.flash_attention(q, k, v, dropout=0.25, causal=True,
                                          training=False),
                       tattn.flash_attention(q, k, v, causal=True))


@pytest.mark.parametrize("entry", ["flash_attn_unpadded",
                                   "flashmask_attention",
                                   "flash_attn_varlen_qkvpacked"])
def test_varlen_and_flashmask_entries_raise_on_dropout(entry):
    """As in the JAX package: dropout there raises, with the advice to
    apply dropout outside attention."""
    x = torch.zeros(8, 2, 16)
    cu = torch.tensor([0, 8])
    call = {"flash_attn_unpadded": lambda: TF.flash_attn_unpadded(
                x, x, x, cu, cu, dropout=0.1),
            "flashmask_attention": lambda: TF.flashmask_attention(
                x[None], x[None], x[None], dropout=0.1, causal=True),
            "flash_attn_varlen_qkvpacked": lambda:
                TF.flash_attn_varlen_qkvpacked(torch.zeros(8, 3, 1, 16),
                                               cu, cu, dropout=0.1)}[entry]
    with pytest.raises(NotImplementedError, match="dropout outside"):
        call()


def test_functional_dropout():
    """Keep rate within 3 sigma, kept entries scaled by 1/(1 - p), one
    draw per ``axis`` index, the seed fixes the mask; inference passes x
    through, or scales by 1 - p in downscale_in_infer mode, as JAX."""
    p = 0.4
    x = torch.from_numpy(np.random.default_rng(16).standard_normal(
        (32, 64)).astype(np.float32)) + 3.0
    trandom.seed(2)
    y = TF.dropout(x, p=p)
    kept = y != 0
    sigma = (p * (1 - p) / x.numel()) ** 0.5
    assert abs(float(kept.float().mean()) - (1 - p)) <= 3 * sigma
    assert torch.equal(y[kept], (x / (1 - p))[kept])
    trandom.seed(2)
    assert torch.equal(TF.dropout(x, p=p), y)
    col = TF.dropout(x, p=p, axis=1)
    assert torch.equal((col != 0).all(0) | (col == 0).all(0),
                       torch.ones(64, dtype=torch.bool))
    y = TF.dropout(x, p=p, mode="downscale_in_infer")
    assert torch.equal(y[y != 0], x[y != 0])
    jx = paddle.to_tensor(x.numpy())
    for mode in ("upscale_in_train", "downscale_in_infer"):
        want = np.asarray(JF.dropout(jx, p=p, training=False,
                                     mode=mode)._value)
        got = TF.dropout(x, p=p, training=False, mode=mode).numpy()
        assert np.array_equal(got, want)


def test_generator_state_round_trip():
    trandom.seed(21)
    a = trandom.bernoulli(0.5, (100,), "cpu")
    state = trandom.get_rng_state()
    b = trandom.bernoulli(0.5, (100,), "cpu")
    trandom.set_rng_state(state)
    assert torch.equal(trandom.bernoulli(0.5, (100,), "cpu"), b)
    assert state[0] == 21 and not torch.equal(a, b)
    # an explicit generator per device: torch's global stream is untouched
    torch.manual_seed(0)
    before = torch.rand(3)
    torch.manual_seed(0)
    trandom.bernoulli(0.5, (100,), "cpu")
    assert torch.equal(torch.rand(3), before)


@pytest.mark.parametrize("table", ["2d", "paddle4d"])
@pytest.mark.parametrize("neox", [True, False])
def test_rope_position_ids_gather_matches_jax(table, neox):
    """``position_ids`` [b, s] gathers each token's row of the sin/cos
    tables; the JAX op ignores them, so its reference gets the rows
    gathered by numpy."""
    rng = np.random.default_rng(17)
    b, s, h, d, max_pos = 2, 6, 2, 8, 20
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, h, d)).astype(np.float32)
    sin = rng.standard_normal((max_pos, d)).astype(np.float32)
    cos = rng.standard_normal((max_pos, d)).astype(np.float32)
    pid = rng.integers(0, max_pos, (b, s))
    want = jfused.fused_rotary_position_embedding(
        paddle.to_tensor(q), paddle.to_tensor(k),
        sin=paddle.to_tensor(sin[pid][:, :, None]),
        cos=paddle.to_tensor(cos[pid][:, :, None]),
        use_neox_rotary_style=neox)
    shape = (1, max_pos, 1, d) if table == "paddle4d" else (max_pos, d)
    got = fused_rotary_position_embedding(
        torch.from_numpy(q), torch.from_numpy(k),
        sin=torch.from_numpy(sin).reshape(shape),
        cos=torch.from_numpy(cos).reshape(shape),
        position_ids=torch.from_numpy(pid), use_neox_rotary_style=neox)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), np.asarray(w._value)) <= TOL
    with pytest.raises(ValueError, match="tables"):
        fused_rotary_position_embedding(
            torch.from_numpy(q), sin=torch.zeros(b, s, 1, d),
            cos=torch.zeros(b, s, 1, d), position_ids=torch.from_numpy(pid))
