"""Head-batched flash attention of the PyTorch port
(paddle_tpu_torch/ops/flash_attention.py, kernels B1/B2) against the JAX
package on the CPU.

The plain PyTorch versions are held to the Pallas kernels run in interpret
mode (``_hb_flash_forward`` / ``_hb_flash_backward``, interpret=True), and
the port's ``flash_attention`` autograd to ``jax.grad`` of
``flash_attention_raw(interpret=True)``.  Inputs come from numpy seeds.

Tolerances, as max |port - jax| over max |jax| of each output:
- fp32 1e-5: the same fp32 arithmetic summed in another order (over at most
  640 keys and 4 heads the sums differ by a few ulps of their largest
  term);
- bf16 2e-2 (the ``bench.py`` kernel gate): inputs are rounded identically,
  but the two sides may round a final fp32 value, or p before the PV
  product, one bf16 ulp (2^-8) apart.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.incubate.nn import attention as port_attention
from paddle_tpu_torch.ops import flash_attention as fa

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(x, dt):
    return torch.from_numpy(np.ascontiguousarray(x)).to(TDT[dt])


def _j(x, dt):
    return jnp.asarray(x, JDT[dt])


def _np(t):
    return t.float().numpy()


def _hb_inputs(seed, rep, s, d=64, bkv=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bkv, rep, s, d)).astype(np.float32)
    k = rng.standard_normal((bkv, s, d)).astype(np.float32)
    v = rng.standard_normal((bkv, s, d)).astype(np.float32)
    do = rng.standard_normal((bkv, rep, s, d)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [128, 200, 640])
@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_hb_plain_matches_pallas(causal, rep, s, dt):
    """B1 and B2 plain versions vs the Pallas kernels (interpret mode);
    s 200 and 640 leave partial q/k blocks (the padded-block masks)."""
    q, k, v, do = _hb_inputs(rep * 1000 + s, rep, s)
    scale = 64 ** -0.5
    tol = TOL[dt]
    o, lse = fa.hb_flash_forward_plain(_t(q, dt), _t(k, dt), _t(v, dt),
                                       causal, scale)
    jo, jlse = jfa._hb_flash_forward(_j(q, dt), _j(k, dt), _j(v, dt),
                                     causal, scale, interpret=True)
    assert o.dtype == TDT[dt] and lse.dtype == torch.float32
    assert _rel(_np(o), jo) <= tol
    assert _rel(lse.numpy(), np.asarray(jlse)[:, :, 0, :]) <= tol
    # the backward from one (o, lse): the plain forward's, broadcast to the
    # TPU's 8-row lse layout for the Pallas kernel
    dq, dk, dv = fa.hb_flash_backward_plain(
        _t(q, dt), _t(k, dt), _t(v, dt), o, lse, _t(do, dt), causal, scale)
    jlse8 = jnp.broadcast_to(jnp.asarray(lse.numpy())[:, :, None, :],
                             (q.shape[0], rep, 8, s))
    jdq, jdk, jdv = jfa._hb_flash_backward(
        _j(q, dt), _j(k, dt), _j(v, dt), jnp.asarray(_np(o), JDT[dt]), jlse8,
        _j(do, dt), causal, scale, interpret=True)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert got.dtype == TDT[dt]
        assert _rel(_np(got), want) <= tol


def test_hb_plain_row_without_keys():
    """A row that sees no key: o = 0 and lse = +1e30 (here sk = 0), and
    its backward contributes nothing."""
    q = torch.randn(1, 2, 5, 16)
    k = torch.zeros(1, 0, 16)
    o, lse = fa.hb_flash_forward_plain(q, k, k, True, 0.25)
    assert torch.all(o == 0) and torch.all(lse == 1e30)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,kvh", [(4, 2), (4, 4), (8, 2)])
def test_flash_attention_autograd_matches_jax_grad(h, kvh, dt):
    """The port's flash_attention (``_FlashHB``) vs jax.grad of
    flash_attention_raw(interpret=True) through its HB route."""
    rng = np.random.default_rng(h * 10 + kvh)
    b, s, d = 2, 200, 64
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    w = rng.standard_normal((b, s, h, d)).astype(np.float32)

    def jloss(q, k, v):
        o = jfa.flash_attention_raw(q, k, v, causal=True, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * w), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                     has_aux=True)(_j(q, dt), _j(k, dt),
                                                   _j(v, dt))
    tq, tk, tv = (_t(x, dt).requires_grad_() for x in (q, k, v))
    before = dict(fa.LAUNCHES)
    o = port_attention.flash_attention(tq, tk, tv, causal=True)
    (o.float() * torch.from_numpy(w)).sum().backward()
    assert fa.LAUNCHES == before          # CPU tensors: plain versions only
    tol = TOL[dt]
    assert o.shape == (b, s, h, d) and o.dtype == TDT[dt]
    assert _rel(_np(o.detach()), jo) <= tol
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        assert got.dtype == TDT[dt]
        assert _rel(_np(got), want) <= tol


@pytest.mark.parametrize("rep", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("s", [1, 100, 128, 1000, 1024, 4096, 8192])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_hb_bwd_blocks_matches_jax(rep, s, d):
    assert fa.hb_bwd_blocks(rep, s, s, d) == jfa._hb_bwd_blocks(rep, s, s, d)


def test_to_hb_matches_jax_and_round_trips():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 7, 8, 4)).astype(np.float32)
    k = rng.standard_normal((2, 7, 2, 4)).astype(np.float32)
    got = fa.to_hb(*(torch.from_numpy(x) for x in (q, k, k)), 8, 2)
    want = jfa._to_hb(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), 8, 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(fa.from_hb(got[0], 2).numpy(), q)


def _route_spy(monkeypatch):
    """Record which autograd function ``flash_attention`` applies."""
    seen = []
    for cls in (fa._FlashHB, fa._Flash):
        orig = cls.apply
        monkeypatch.setattr(cls, "apply", (lambda orig, name: lambda *a: (
            seen.append(name), orig(*a))[1])(orig, cls.__name__))
    return seen


@pytest.mark.parametrize("case", ["segments", "bands", "blocks", "rep16",
                                  "sk_ne_s", "long_seq"])
def test_unported_routes_raise(case, monkeypatch):
    """Every call outside the HB route takes the masked kernels B5/B6
    (``_Flash``), as JAX's ``flash_attention_raw`` takes ``_flash``: output
    and gradients match jax.grad of it (interpret mode), fp32 1e-5.  Causal
    with sq != sk raises FlashUnsupportedError on both sides.  ``long_seq``
    (s 8192, d 128, where the HB backward scratch rule says no) is checked
    as a routing decision only, without computing."""
    b, s, h, kvh, d = 1, 64, 4, 2, 16
    sk, causal, kw = s, True, {}
    if case == "rep16":
        h = 32
    if case == "sk_ne_s":
        sk, causal = s // 2, False
    if case == "long_seq":
        s = sk = 8192
        d = 128
        assert fa.hb_bwd_blocks(h // kvh, s, s, d) is None
        assert jfa._hb_bwd_blocks(h // kvh, s, s, d) is None
        seen = []
        monkeypatch.setattr(fa._FlashHB, "apply", None)
        monkeypatch.setattr(fa._Flash, "apply",
                            lambda q, *a: seen.append(a[4:6]) or q)
        out = fa.flash_attention(torch.zeros(b, s, h, d),
                                 torch.zeros(b, s, kvh, d),
                                 torch.zeros(b, s, kvh, d))
        assert out.shape == (b, s, h, d) and seen == [(h, kvh)]
        return
    rng = np.random.default_rng(40 + len(case))
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kvh, d)).astype(np.float32)
    w = rng.standard_normal((b, s, h, d)).astype(np.float32)
    if case == "segments":
        ids = np.repeat([[1, 2, 3]], [20, 30, 14], axis=1).astype(np.int32)
        kw = dict(q_segment_ids=ids, kv_segment_ids=ids)
    if case == "bands":
        doc = np.repeat([20, 50, 64], [20, 30, 14]).astype(np.int32)
        bands = (doc, np.full(s, s), np.zeros(s), np.zeros(s))
        kw = dict(mask_bands=tuple(x.astype(np.int32).reshape(1, 1, s)
                                   for x in bands))
    if case == "blocks":
        kw = dict(blocks=(128, 128))

    def jloss(q, k, v):
        o = jfa.flash_attention_raw(
            q, k, v, causal=causal, interpret=True,
            **{n: (tuple(jnp.asarray(x) for x in a) if n == "mask_bands"
                   else a if n == "blocks" else jnp.asarray(a))
               for n, a in kw.items()})
        return jnp.sum(o * w), o

    (_, jo), jg = jax.value_and_grad(jloss, (0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(x, "float32").requires_grad_() for x in (q, k, v))
    tkw = {n: (tuple(torch.from_numpy(x) for x in a) if n == "mask_bands"
               else a if n == "blocks" else torch.from_numpy(a))
           for n, a in kw.items()}
    seen = _route_spy(monkeypatch)
    o = fa.flash_attention(tq, tk, tv, causal=causal, **tkw)
    (o * torch.from_numpy(w)).sum().backward()
    assert seen == ["_Flash"]
    assert _rel(_np(o.detach()), jo) <= TOL["float32"]
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        assert _rel(_np(got), want) <= TOL["float32"]
    if case == "sk_ne_s":
        with pytest.raises(fa.FlashUnsupportedError):
            fa.flash_attention(tq, tk, tv, causal=True)
        with pytest.raises(jfa.FlashUnsupportedError):
            jfa.flash_attention_raw(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True,
                                    interpret=True)


@pytest.mark.parametrize("kw", [dict(attn_mask=torch.ones(1, 8, dtype=bool)),
                                dict(q_segment_ids=torch.ones(1, 8),
                                     kv_segment_ids=torch.ones(1, 8)),
                                dict(dropout=0.1)])
def test_entry_later_slices_raise(kw, monkeypatch):
    """A bool keep-mask and segment ids take the masked kernels (``_Flash``):
    all-kept and one segment equal the unmasked causal attention (fp32
    1e-5).  Dropout takes the plain attention path (no kernel), with the
    mask the seeded generator draws; tests/test_torch_attention_masks.py
    holds it against JAX."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(np.float32))
    if "dropout" in kw:
        from paddle_tpu_torch.ops import random as trandom
        from paddle_tpu_torch.ops.nn_ops import scaled_dot_product_attention

        seen = _route_spy(monkeypatch)
        trandom.seed(4)
        got = port_attention.flash_attention(q, q, q, causal=True, **kw)
        assert seen == []
        trandom.seed(4)
        mask = trandom.bernoulli(1 - kw["dropout"], (1, 2, 8, 8), "cpu")
        want = scaled_dot_product_attention(q, q, q, dropout_mask=mask,
                                            dropout_p=kw["dropout"],
                                            is_causal=True)
        assert torch.equal(got, want)
        return
    want = port_attention.flash_attention(q, q, q, causal=True)
    seen = _route_spy(monkeypatch)
    got = port_attention.flash_attention(q, q, q, causal=True, **kw)
    assert seen == ["_Flash"]
    assert _rel(_np(got), _np(want)) <= TOL["float32"]


def test_kernel_tiles_fit_every_routed_shape():
    """The CUDA launch tiles chosen by the wrapper fit the card's shared
    memory for every rep the route admits, head dim and dtype, and keep the
    bf16 tensor-core tiles 16-row aligned."""
    for kind in ("fwd", "dq", "dkv"):
        for rep in range(1, fa.MAX_REP + 1):
            for d in fa.SUPPORTED_HEAD_DIMS:
                for dt in (torch.float32, torch.bfloat16):
                    bq, bk = fa.kernel_tiles(kind, rep, d, dt)
                    assert fa.smem_bytes(kind, rep * bq, bk, d, dt) \
                        <= fa._SMEM_LIMIT
                    if dt == torch.bfloat16:
                        assert (rep * bq) % 16 == 0 and bk % 16 == 0
    # the bench.py attention shape (rep 4, d 128, bf16): the forward takes
    # the wgmma kernel's 32 positions x 4 heads against 64 keys; the
    # backward the tiles above
    assert fa.fwd_route(128, torch.bfloat16) == "wgmma"
    assert fa.wgmma_fwd_tiles(4) == (32, 64)
    assert fa.kernel_tiles("dq", 4, 128, torch.bfloat16)[0] == 16


def test_wrappers_take_plain_on_cpu_and_guard_inputs():
    q = torch.randn(2, 2, 32, 16)
    k = torch.randn(2, 32, 16)
    before = dict(fa.LAUNCHES)
    o, lse = fa.hb_flash_forward(q, k, k)
    fa.hb_flash_backward(q, k, k, o, lse, torch.randn_like(q))
    assert fa.LAUNCHES == before
    with pytest.raises(TypeError):
        fa.hb_flash_forward(q.half(), k.half(), k.half())
    with pytest.raises(ValueError):
        fa.hb_flash_forward(q, k[:, :, :8], k[:, :, :8])
    with pytest.raises(ValueError):
        fa.hb_flash_backward(q, k, k, o, lse[:, :, :5], q)
