"""Masked flash attention of the PyTorch port (paddle_tpu_torch/ops/
flash_attention.py B5/B6, ops/flashmask.py, the varlen entries) against the
JAX package on the CPU.

The plain versions ``flash_forward_plain`` / ``flash_backward_plain`` are
held to the Pallas kernels run in interpret mode (``_flash_forward`` /
``_flash_backward``, interpret=True) for every mask the kernels take:
segment ids (negative ids included), each FlashMask class of
tests/test_flashmask.py with per-head (mh = kvh) and broadcast (mh = 1)
bands, unaligned sequences, rep 1 to 16 and non-causal sk != s.  The dq +
dkv route is reached on both sides by setting the fused-scratch budget to 0
(the JAX launcher reads its global at call time).  The live tables, the
backward route, the mask builders and the entries must equal JAX's.

Tolerances, as max |port - jax| over max |jax| of each output (rows that
see no key must be exactly o = 0, lse = +1e30 on both sides):
- fp32 1e-5: the same fp32 arithmetic summed in another order;
- bf16 2e-2 (the ``bench.py`` kernel gate): both sides may round a final
  fp32 value, or p before the PV product, one bf16 ulp apart.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import flashmask as jfm
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import flashmask as fm

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BIG = 1e30


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    den = np.abs(want).max()
    return float(np.abs(got - want).max() / (den if den > 0 else 1.0))


def _t(x, dt="float32"):
    return torch.from_numpy(np.ascontiguousarray(x)).to(TDT[dt])


def _i(x):
    return torch.from_numpy(np.array(x, np.int32))


def _np(t):
    return t.detach().float().numpy()


# ------------------------------------------------------------- mask makers

def _packed_ids(rng, b, s, median, pad):
    """[b, s] segment ids of whole documents (lognormal lengths), 1-based,
    ascending along each row; ``pad`` trailing tokens of id 0."""
    out = np.zeros((b, s), np.int32)
    for r in range(b):
        pos, doc = 0, 1
        while pos < s - pad:
            n = int(np.clip(rng.lognormal(np.log(median), 0.6), 2, s))
            n = min(n, s - pad - pos)
            out[r, pos:pos + n] = doc
            pos, doc = pos + n, doc + 1
    return out


def _random_bands(rng, b, mh, s, causal, has_end):
    """The reference's gen_random_flashmask, as tests/test_flashmask.py."""
    n = (1 if causal else 2) * (2 if has_end else 1)
    m = rng.integers(0, s, (b, mh, s, n))
    diag = np.arange(s).reshape(1, 1, s)
    m[..., 0] = np.maximum(diag + 1, m[..., 0])
    if not causal:
        if has_end:
            m[..., 1] = np.maximum(m[..., 0], m[..., 1])
            m[..., 2] = np.minimum(diag, m[..., 2])
            m[..., 3] = np.clip(m[..., 3], None, diag + 1)
            m[..., 3] = np.maximum(m[..., 2], m[..., 3])
        else:
            m[..., 1] = np.minimum(diag, m[..., 1])
    elif has_end:
        m[..., 1] = np.maximum(m[..., 0], m[..., 1])
    return m.astype(np.int32)


def _bidir_document(lens):
    ends = np.cumsum(lens)
    starts = np.concatenate([[0], ends[:-1]])
    return np.stack([np.repeat(ends, lens), np.repeat(starts, lens)],
                    -1).astype(np.int32).reshape(1, 1, int(ends[-1]), 2)


def _bands_of(sri, causal, sq, b):
    sri = np.broadcast_to(np.asarray(sri), (b,) + np.asarray(sri).shape[1:])
    return tuple(np.asarray(x) for x in jfm.normalize_startend_row_indices(
        jnp.asarray(sri), causal, sq))


# case -> (b, sq, sk, h, kvh, d, causal, mask builder(rng) -> dict)
def _case(name, rng):
    def seg(b, sq, sk=None, pad=7, median=40):
        q = _packed_ids(rng, b, sq, median, pad)
        return dict(q_seg=q, k_seg=q if sk is None else
                    _packed_ids(rng, b, sk, median, pad))

    if name == "segments":
        return (2, 200, 200, 4, 2, 16, True), seg(2, 200)
    if name == "segments_negative":
        # the varlen qkv-packed padded layout: unique negative ids, q side
        # and k side disjoint, so padding rows see no key at all
        lens, smax = [20, 32, 9], 32
        pos = np.arange(3 * smax)
        i, off = pos // smax, pos % smax
        real = off < np.asarray(lens)[i]
        qs = np.where(real, i + 1, -(2 * pos + 2)).astype(np.int32)[None]
        ks = np.where(real, i + 1, -(2 * pos + 3)).astype(np.int32)[None]
        return (1, 96, 96, 4, 2, 16, True), dict(q_seg=qs, k_seg=ks)
    if name == "causal_document":
        idx = np.asarray(jfm.causal_document_row_indices([30, 20, 14]))
        return (2, 64, 64, 4, 2, 16, True), dict(sri=idx, causal=True)
    if name == "share_question":
        idx = np.asarray(jfm.share_question_row_indices(12, (20, 44), 64))
        return (1, 64, 64, 4, 2, 16, True), dict(sri=idx, causal=True)
    if name == "sliding_causal":
        idx = np.asarray(jfm.sliding_window_row_indices(64, 9, True))
        return (1, 64, 64, 4, 2, 16, True), dict(sri=idx, causal=True)
    if name == "sliding_bidirectional":
        idx = np.asarray(jfm.sliding_window_row_indices(64, (5, 11), False))
        return (1, 64, 64, 4, 2, 16, False), dict(sri=idx, causal=False)
    if name == "global_sliding":
        idx = np.asarray(jfm.global_sliding_row_indices(64, 6, n_global=5))
        return (1, 64, 64, 4, 2, 16, False), dict(sri=idx, causal=False)
    if name == "bidirectional_document":
        return (1, 48, 48, 2, 2, 16, False), dict(
            sri=_bidir_document([20, 17, 11]), causal=False)
    if name == "per_head_bands":
        idx = _random_bands(rng, 1, 2, 64, True, True)        # mh = kvh
        return (1, 64, 64, 4, 2, 16, True), dict(sri=idx, causal=True)
    if name == "gqa_broadcast_bands":
        idx = _random_bands(rng, 2, 1, 64, True, False)       # mh = 1
        return (2, 64, 64, 8, 2, 16, True), dict(sri=idx, causal=True)
    if name == "unaligned":
        idx = _random_bands(rng, 1, 1, 23, True, False)
        return (1, 23, 23, 2, 2, 16, True), dict(sri=idx, causal=True)
    if name == "rep16":
        return (1, 96, 96, 16, 1, 16, True), seg(1, 96)
    if name == "sk_ne_s":
        return (2, 48, 80, 4, 2, 16, False), seg(2, 48, 80, pad=5, median=20)
    raise KeyError(name)


CASES = ["segments", "segments_negative", "causal_document", "share_question",
         "sliding_causal", "sliding_bidirectional", "global_sliding",
         "bidirectional_document", "per_head_bands", "gqa_broadcast_bands",
         "unaligned", "rep16", "sk_ne_s"]
BF16_CASES = ["segments", "per_head_bands", "rep16"]


def _run_case(name, dt, seed):
    rng = np.random.default_rng(seed)
    (b, sq, sk, h, kvh, d, causal), mask = _case(name, rng)
    q = rng.standard_normal((b * h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b * kvh, sk, d)).astype(np.float32)
    v = rng.standard_normal((b * kvh, sk, d)).astype(np.float32)
    do = rng.standard_normal((b * h, sq, d)).astype(np.float32)
    jkw, tkw = {}, {}
    if "q_seg" in mask:
        jkw = dict(q_seg=jnp.asarray(mask["q_seg"]),
                   k_seg=jnp.asarray(mask["k_seg"]))
        tkw = dict(q_seg=_i(mask["q_seg"]), k_seg=_i(mask["k_seg"]))
    if "sri" in mask:
        bands = _bands_of(mask["sri"], mask["causal"], sq, b)
        mh = bands[0].shape[1]
        jkw = dict(bands=tuple(jnp.asarray(x) for x in bands), mask_h=mh)
        tkw = dict(bands=tuple(_i(x) for x in bands), mask_h=mh)
    scale = d ** -0.5
    J = JDT[dt]
    o, lse = fa.flash_forward_plain(_t(q, dt), _t(k, dt), _t(v, dt), causal,
                                    scale, h, kvh, **tkw)
    jo, jlse = jfa._flash_forward(jnp.asarray(q, J), jnp.asarray(k, J),
                                  jnp.asarray(v, J), causal, scale, h=h,
                                  kvh=kvh, interpret=True, **jkw)
    jlse = np.asarray(jlse)[:, 0]
    assert o.dtype == TDT[dt] and lse.dtype == torch.float32
    # rows that see no key: exactly o = 0 and lse = +1e30 on both sides
    dead = jlse >= BIG * 0.5
    np.testing.assert_array_equal(lse.numpy() >= BIG * 0.5, dead)
    assert np.all(_np(o)[dead] == 0) and np.all(np.asarray(jo, np.float32)[dead] == 0)
    assert _rel(_np(o), jo) <= TOL[dt]
    assert _rel(lse.numpy()[~dead], jlse[~dead]) <= TOL[dt]
    # the backward from one (o, lse): the plain forward's
    jlse8 = jnp.broadcast_to(jnp.asarray(lse.numpy())[:, None, :],
                             (b * h, 8, sq))
    got = fa.flash_backward_plain(_t(q, dt), _t(k, dt), _t(v, dt), o, lse,
                                  _t(do, dt), causal, scale, h, kvh, **tkw)
    want = jfa._flash_backward(jnp.asarray(q, J), jnp.asarray(k, J),
                               jnp.asarray(v, J), jnp.asarray(_np(o), J),
                               jlse8, jnp.asarray(do, J), causal, scale, h=h,
                               kvh=kvh, interpret=True, **jkw)
    for name_, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == TDT[dt], name_
        assert _rel(_np(g), w) <= TOL[dt], name_
    return dead.mean()


@pytest.mark.parametrize("dt,case", [("float32", c) for c in CASES]
                         + [("bfloat16", c) for c in BF16_CASES])
def test_masked_plain_matches_pallas(case, dt):
    """B5 and B6 plain versions vs the Pallas kernels (interpret mode),
    fused backward route, for every mask class."""
    assert fa.flash_bwd_route(200, 200, 16) == "fused"
    dead = _run_case(case, dt, CASES.index(case))
    if case == "segments_negative":
        assert dead > 0.2                   # the padding rows see no key


@pytest.mark.parametrize("case", ["segments", "global_sliding"])
def test_masked_plain_matches_pallas_split_route(case, monkeypatch):
    """The dq + dkv route on both sides: both budgets 0, so the JAX
    launcher runs _flash_bwd_dq_kernel + _flash_bwd_dkv_kernel (a spy on the
    fused body proves it) and the port routes "split"."""
    monkeypatch.setattr(jfa, "_FUSED_BWD_VMEM_BUDGET", 0)
    monkeypatch.setattr(fa, "_FUSED_BWD_VMEM_BUDGET", 0)
    fused = jfa._flash_bwd_fused_kernel
    calls = []

    def spy(*a, **kw):
        calls.append(1)
        return fused(*a, **kw)

    monkeypatch.setattr(jfa, "_flash_bwd_fused_kernel", spy)
    assert fa.flash_bwd_route(200, 200, 16) == "split"
    _run_case(case, "float32", 100 + CASES.index(case))
    assert not calls


# ----------------------------------------------------------------- tables

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("masks", ["none", "segments", "negative", "bands",
                                   "bands_per_head", "both"])
def test_live_tables_match_jax(masks, causal):
    """_live_tables and _compress_live (and the transposed lists of the dk/dv
    kernels) equal JAX's exactly, at TPU and GPU tile sizes: the smem
    B5/B6's, then the wgmma B5's (``masked_fwd_wgmma_tiles`` at rep 1, 4,
    3, 5 and 16: block_q 128, 32, 42, 25 and 16 against 64 keys), which are
    also the wgmma B6 dq kernel's, then the wgmma B6 dk/dv kernel's
    (``masked_bwd_wgmma_tiles``: block_q 64, 16, 21, 12 and 8 against 128
    keys)."""
    rng = np.random.default_rng(7)
    b, s, kvh = 2, 200, 2
    tkw, jkw, mh = {}, {}, 1
    if masks in ("segments", "both"):
        ids = _packed_ids(rng, b, s, 30, 9)
        tkw.update(q_seg=_i(ids), k_seg=_i(ids))
        jkw.update(q_seg=jnp.asarray(ids), k_seg=jnp.asarray(ids))
    if masks == "negative":
        ids = np.where(rng.random((b, s)) < 0.3, -np.arange(b * s).reshape(b, s)
                       - 1, np.sort(rng.integers(1, 5, (b, s)), -1))
        tkw.update(q_seg=_i(ids), k_seg=_i(ids))
        jkw.update(q_seg=jnp.asarray(ids, jnp.int32),
                   k_seg=jnp.asarray(ids, jnp.int32))
    if masks in ("bands", "bands_per_head", "both"):
        mh = kvh if masks == "bands_per_head" else 1
        sri = _random_bands(rng, b, mh, s, causal, not causal)
        if causal and masks == "both":
            sri = np.broadcast_to(np.asarray(
                jfm.causal_document_row_indices([64, 100, 36])), (b, 1, s, 1))
        bands = _bands_of(sri, causal, s, b)
        tkw["bands"] = tuple(_i(x) for x in bands)
        jkw["bands"] = tuple(jnp.asarray(x) for x in bands)
    reps = (1, 4, 3, 5, 16)
    wgmma = [fa.masked_fwd_wgmma_tiles(rep)[1:] for rep in reps]
    assert wgmma == [(128, 64), (32, 64), (42, 64), (25, 64), (16, 64)]
    bwd = [fa.masked_bwd_wgmma_tiles(rep) for rep in reps]
    assert [t[1][1:] for t in bwd] == wgmma
    bwd_kv = [t[0][1:] for t in bwd]
    assert bwd_kv == [(64, 128), (16, 128), (21, 128), (12, 128), (8, 128)]
    for bq, bk in ((512, 512), (16, 64), (64, 32), *wgmma, *bwd_kv):
        bq_, bk_ = jfa._clamp_block(bq, s), jfa._clamp_block(bk, s)
        nq, nk = -(-s // bq_), -(-s // bk_)
        want = jfa._live_tables(b, mh, nq, nk, bq_, bk_, s, s, causal, **jkw)
        got = fa._live_tables(b, mh, nq, nk, bq_, bk_, s, s, causal, **tkw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for tr in (False, True):
            jl = jnp.swapaxes(want, 1, 2) if tr else want
            tl = got.transpose(1, 2) if tr else got
            (jc, jx), (tc, tx) = jfa._compress_live(jl), fa._compress_live(tl)
            assert tc.dtype == tx.dtype == torch.int32
            np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
            np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))


def _jax_route(sq, sk, d, blocks=None):
    """_flash_backward's decision (flash_attention.py:1067-1108), read from
    JAX's own _clamp_block and budget."""
    block_q, block_k = (512, 512) if blocks is None else blocks
    block_q, block_k = jfa._clamp_block(block_q, sq), jfa._clamp_block(block_k, sk)
    while block_q * block_k > 512 * 1024 and (block_q > 128 or block_k > 128):
        if block_k >= block_q and block_k > 128:
            block_k //= 2
        else:
            block_q //= 2
    sk_pad = -(-sk // block_k) * block_k
    return ("fused" if 2 * sk_pad * d * 4 <= jfa._FUSED_BWD_VMEM_BUDGET
            else "split")


@pytest.mark.parametrize("blocks", [None, (1024, 1024), (256, 128)])
def test_flash_bwd_route_matches_jax(blocks):
    assert fa._FUSED_BWD_VMEM_BUDGET == jfa._FUSED_BWD_VMEM_BUDGET
    for s in (1, 23, 200, 1000, 1024, 4096, 6144, 6145, 6200, 8192, 12288):
        for d in (16, 64, 128, 256):
            for sk in (s, 2 * s):
                assert fa.flash_bwd_route(s, sk, d, blocks) == \
                    _jax_route(s, sk, d, blocks), (s, sk, d, blocks)
    # the long-context train shape takes the dq + dkv pair, the 1K one fused
    assert fa.flash_bwd_route(8192, 8192, 128) == "split"
    assert fa.flash_bwd_route(1024, 1024, 128) == "fused"


def test_masked_tiles_fit_every_rep_and_head_dim():
    """One (hpc, block_q, block_k) per (rep, d, dtype) for all four masked
    kernels: each kernel's shared memory fits the card, bf16 tensor-core
    tiles stay 16-row aligned and hpc divides rep."""
    for rep in range(1, 17):
        for d in fa.SUPPORTED_HEAD_DIMS:
            for dt in (torch.float32, torch.bfloat16):
                hpc, bq, bk = fa.masked_tiles(rep, d, dt)
                assert rep % hpc == 0 and hpc <= 4
                for kind in fa.MASKED_KINDS:
                    assert fa.masked_smem_bytes(kind, hpc * bq, bq, bk, d,
                                                dt) <= fa._SMEM_LIMIT
                if dt == torch.bfloat16:
                    assert (hpc * bq) % 16 == 0 and bk % 16 == 0
    assert fa.masked_tiles(4, 128, torch.bfloat16) == (4, 16, 64)


# --------------------------------------------------- builders and entries

def test_flashmask_builders_and_normalisation_match_jax():
    built = [
        (fm.causal_document_row_indices([5, 9, 2]),
         jfm.causal_document_row_indices([5, 9, 2]), True),
        (fm.share_question_row_indices(4, (6, 11), 16),
         jfm.share_question_row_indices(4, (6, 11), 16), True),
        (fm.sliding_window_row_indices(16, 3, True),
         jfm.sliding_window_row_indices(16, 3, True), True),
        (fm.sliding_window_row_indices(16, (2, 5), False),
         jfm.sliding_window_row_indices(16, (2, 5), False), False),
        (fm.global_sliding_row_indices(16, 3, 2),
         jfm.global_sliding_row_indices(16, 3, 2), False),
        (torch.from_numpy(_bidir_document([7, 6, 3])),
         jnp.asarray(_bidir_document([7, 6, 3])), False),
    ]
    for got, want, causal in built:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        s = got.shape[2]
        for g, w in zip(fm.normalize_startend_row_indices(got, causal, s),
                        jfm.normalize_startend_row_indices(want, causal, s)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(
            fm.flashmask_to_dense_bias(got, causal, s).numpy(),
            np.asarray(jfm.flashmask_to_dense_bias(want, causal, s)))
        for block in (4, 8):
            assert fm.flashmask_block_skip_fraction(got, causal, s, block) == \
                jfm.flashmask_block_skip_fraction(want, causal, s, block)
    with pytest.raises(ValueError):
        fm.normalize_startend_row_indices(built[0][0], False, 16)
    with pytest.raises(ValueError):
        fm.normalize_startend_row_indices(built[0][0][0], True, 16)
    for lens in ([512, 512, 512, 512], [100, 700, 30, 1200]):
        assert fa.varlen_block_skip_fraction(lens, 256) == \
            jfa.varlen_block_skip_fraction(lens, 256)
    cu = np.asarray([0, 3, 3, 10], np.int32)
    np.testing.assert_array_equal(
        fa.segment_ids_from_cu_seqlens(_i(cu), 13).numpy(),
        np.asarray(jfa.segment_ids_from_cu_seqlens(jnp.asarray(cu), 13)))


def _qkv(rng, b, s, h, kvh, d):
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, kvh, d)).astype(np.float32),
            rng.standard_normal((b, s, kvh, d)).astype(np.float32))


@pytest.mark.parametrize("window,causal", [(4, True), ((3, 5), False)])
def test_flashmask_attention_window_matches_jax(window, causal):
    """flashmask_attention_raw with window_size, forward and gradients
    (through the _Flash autograd) vs jax.grad of the JAX entry."""
    rng = np.random.default_rng(21)
    q, k, v = _qkv(rng, 2, 40, 4, 2, 16)
    w = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)

    def jloss(q, k, v):
        o = jfm.flashmask_attention_raw(q, k, v, window_size=window,
                                        causal=causal, interpret=True)
        return jnp.sum(o * w), o

    (_, jo), jg = jax.value_and_grad(jloss, (0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    o = fm.flashmask_attention_raw(tq, tk, tv, window_size=window,
                                   causal=causal)
    (o * _t(w)).sum().backward()
    assert _rel(_np(o), jo) <= TOL["float32"]
    for g, want in zip((tq.grad, tk.grad, tv.grad), jg):
        assert _rel(_np(g), want) <= TOL["float32"]
    with pytest.raises(ValueError):
        fm.flashmask_attention_raw(tq, tk, tv, _i(np.zeros((2, 1, 40, 1))),
                                   causal=True, window_size=2)
    with pytest.raises(ValueError):
        fm.flashmask_attention_raw(tq, tk, tv, _i(np.zeros((2, 3, 40, 1))),
                                   causal=True)


def test_flash_attn_unpadded_matches_jax():
    rng = np.random.default_rng(22)
    cu = np.asarray([0, 9, 30, 37], np.int32)
    q = rng.standard_normal((37, 4, 16)).astype(np.float32)
    k = rng.standard_normal((37, 2, 16)).astype(np.float32)
    v = rng.standard_normal((37, 2, 16)).astype(np.float32)
    for causal in (True, False):
        want = jfa.flash_attn_unpadded_raw(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cu),
            jnp.asarray(cu), causal=causal, interpret=True)
        got = fa.flash_attn_unpadded_raw(_t(q), _t(k), _t(v), _i(cu), _i(cu),
                                         causal=causal)
        assert _rel(_np(got), want) <= TOL["float32"]
        np.testing.assert_array_equal(_np(PF.flash_attn_unpadded(
            _t(q), _t(k), _t(v), _i(cu), _i(cu), causal=causal)), _np(got))


@pytest.mark.parametrize("padded", [True, False])
def test_flash_attn_varlen_qkvpacked_matches_jax(padded):
    """Both layouts, with the g-major <-> group-major head permutation
    (g = 2 q heads per kv head); padded layout rows past a length are 0."""
    rng = np.random.default_rng(23)
    g, kvh, d, smax, lens = 2, 2, 16, 16, [11, 16, 5]
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    total = 3 * smax if padded else int(sum(lens))
    qkv = rng.standard_normal((total, g + 2, kvh, d)).astype(np.float32)
    kw = dict(max_seqlen_q=smax, max_seqlen_k=smax) if padded else {}
    want = jfm.flash_attn_varlen_qkvpacked_raw(
        jnp.asarray(qkv), jnp.asarray(cu), jnp.asarray(cu), causal=True,
        varlen_padded=padded, interpret=True, **kw)
    got = fm.flash_attn_varlen_qkvpacked_raw(_t(qkv), _i(cu), _i(cu),
                                             causal=True,
                                             varlen_padded=padded, **kw)
    assert got.shape == (total, g * kvh, d)
    assert _rel(_np(got), want) <= TOL["float32"]
    if padded:
        for i, n in enumerate(lens):
            assert torch.all(got[i * smax + n:(i + 1) * smax] == 0)
    out, sm = PF.flash_attn_varlen_qkvpacked(
        _t(qkv), _i(cu), _i(cu), causal=True, varlen_padded=padded,
        return_softmax=True, **kw)
    assert sm is None and torch.equal(out, got)


@pytest.mark.parametrize("lens", [[40, 33], [12, 20]])
def test_flash_attention_auto_matches_jax(lens):
    """Both sides of PACKED_PADDING_CROSSOVER (padding 0.175: dense;
    0.6: packed); real rows match JAX, padding rows of the packed path
    are 0."""
    assert fa.PACKED_PADDING_CROSSOVER == jfa.PACKED_PADDING_CROSSOVER
    rng = np.random.default_rng(24)
    q, k, v = _qkv(rng, 2, 40, 4, 2, 16)
    pad = 1 - sum(lens) / 80
    want = np.asarray(jfa.flash_attention_auto(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lens, causal=True,
        interpret=True))
    got = _np(fa.flash_attention_auto(_t(q), _t(k), _t(v), lens, causal=True))
    for r, n in enumerate(lens):
        assert _rel(got[r, :n], want[r, :n]) <= TOL["float32"]
        if pad >= fa.PACKED_PADDING_CROSSOVER:
            assert np.all(got[r, n:] == 0)
    with pytest.raises(ValueError):
        fa.flash_attention_auto(_t(q), _t(k), _t(v), [41, 3])


def test_routing_and_unsupported_errors():
    """flash_attention's routing: the HB predicate -> _FlashHB, every other
    call -> _Flash; h % kvh != 0 and causal sq != sk raise
    FlashUnsupportedError, a ValueError as in JAX; CPU tensors launch
    nothing."""
    assert issubclass(fa.FlashUnsupportedError, ValueError)
    q = torch.randn(1, 32, 6, 16)
    k = torch.randn(1, 32, 4, 16)
    with pytest.raises(fa.FlashUnsupportedError):
        fa.flash_attention(q, k, k)
    with pytest.raises(fa.FlashUnsupportedError):
        fa.flash_attention(q[:, :, :4], k[:, :16], k[:, :16], causal=True)
    with pytest.raises(ValueError):
        fa.flash_attention(q[:, :, :4], k, k, q_segment_ids=_i(np.ones((1, 32))))
    seen = []
    for cls in (fa._FlashHB, fa._Flash):
        orig = cls.apply
        cls.apply = (lambda orig, name: lambda *a: seen.append(name)
                     or orig(*a))(orig, cls.__name__)
    try:
        before = dict(fa.LAUNCHES)
        fa.flash_attention(q[:, :, :4], k, k)
        fa.flash_attention(q[:, :, :4], k, k, blocks=(128, 128))
        fa.flash_attention(q[:, :, :4], k, k, q_segment_ids=_i(np.ones((1, 32))),
                           kv_segment_ids=_i(np.ones((1, 32))))
        assert fa.LAUNCHES == before
    finally:
        del fa._FlashHB.apply, fa._Flash.apply
    assert seen == ["_FlashHB", "_Flash", "_Flash"]
