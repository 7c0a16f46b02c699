"""Decode-attention port (paddle_tpu_torch/ops/decode_attention.py) against
the Pallas kernels of paddle_tpu/ops/pallas/decode_attention.py, run as
tests/test_flash_decoding.py runs them (interpret mode on the CPU).

The same numpy inputs, made from a seed, go to the JAX launcher and to
the port's plain version.  Tolerances: fp32 rtol 1e-5 / atol 1e-6 (the
two differ only in summation order); bf16 2e-2 relative max-error, the
gate of bench.py, since the TPU kernel rounds p to bf16 per page against
its running max while the plain version rounds it once against the final
max."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.ops.pallas.decode_attention import (
    default_pages_per_step as jax_default_pp, flash_decode_raw,
    paged_decode_raw, ragged_paged_decode_raw)
from paddle_tpu_torch import resolve_device
from paddle_tpu_torch.ops import decode_attention as port


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


def _j(x, dtype=None):
    return jnp.asarray(x) if dtype is None else jnp.asarray(x, dtype)


def _close(got, want, dtype, vscale=1.0):
    """``vscale`` divides both sides first: int8 V values span +-127, so
    their outputs are compared in the units the caller's dequant scale
    (absmax / 127) brings back to O(1)."""
    got = np.asarray(got, np.float32) / vscale
    want = np.asarray(want, np.float32) / vscale
    assert np.isfinite(got).all()
    if dtype == "bf16":
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
        assert err <= 2e-2, err
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _kv(rng, shape, dtype):
    if dtype == "int8":
        return rng.integers(-127, 128, shape).astype(np.int8)
    return rng.standard_normal(shape).astype(np.float32)


# (torch dtype, jax dtype) of each case's q; None keeps numpy's fp32
_DT = {"fp32": (None, None), "bf16": (torch.bfloat16, jnp.bfloat16)}


# ---------------------------------------------------------------- dense B4

@pytest.mark.parametrize("h,kvh", [(4, 2), (8, 1), (4, 4)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_flash_decode_plain_matches_pallas(h, kvh, dtype):
    rng = np.random.default_rng(100 + h * 10 + kvh)
    b, d, t_max = 4, 32, 300
    lens = np.array([0, 1, 130, 300], np.int32)    # zero row, partial block
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kc = rng.standard_normal((b, kvh, t_max, d)).astype(np.float32)
    vc = rng.standard_normal((b, kvh, t_max, d)).astype(np.float32)
    tdt, jdt = _DT[dtype]
    want = flash_decode_raw(_j(q, jdt), _j(kc, jdt), _j(vc, jdt), _j(lens),
                            block_k=128)
    got = port.flash_decode_plain(_t(q, tdt), _t(kc, tdt), _t(vc, tdt),
                                  _t(lens))
    _close(got.float().numpy(), np.asarray(want, np.float32), dtype)
    assert np.all(got[0].float().numpy() == 0.0)   # sees no key -> exactly 0


def test_flash_decode_plain_garbage_past_len():
    """NaN keys and inf values past seq_len must not reach the result."""
    rng = np.random.default_rng(1)
    b, h, d, t_max = 2, 4, 16, 256
    lens = np.array([7, 131], np.int32)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kc = np.full((b, 2, t_max, d), np.nan, np.float32)
    vc = np.full((b, 2, t_max, d), np.inf, np.float32)
    for bi in range(b):
        kc[bi, :, :lens[bi]] = rng.standard_normal((2, lens[bi], d))
        vc[bi, :, :lens[bi]] = rng.standard_normal((2, lens[bi], d))
    want = np.asarray(flash_decode_raw(q, kc, vc, lens, block_k=128))
    got = port.flash_decode_plain(_t(q), _t(kc), _t(vc), _t(lens))
    _close(got.numpy(), want, "fp32")


@pytest.mark.parametrize("qdt", ["fp32", "bf16"])
def test_flash_decode_plain_int8_kv(qdt):
    """int8 K/V are widened to q's dtype; scales stay with the caller."""
    rng = np.random.default_rng(2)
    b, h, kvh, d, t_max = 3, 8, 2, 16, 96
    lens = np.array([5, 96, 40], np.int32)
    q = (0.05 * rng.standard_normal((b, h, d))).astype(np.float32)
    kc = _kv(rng, (b, kvh, t_max, d), "int8")
    vc = _kv(rng, (b, kvh, t_max, d), "int8")
    tdt, jdt = _DT[qdt]
    want = flash_decode_raw(_j(q, jdt), _j(kc), _j(vc), _j(lens))
    got = port.flash_decode_plain(_t(q, tdt), _t(kc), _t(vc), _t(lens))
    _close(got.float().numpy(), np.asarray(want, np.float32), qdt, 127.0)


@pytest.mark.parametrize("b,kvh,t_max", [(8, 8, 2048), (1, 8, 222),
                                         (5, 2, 700), (64, 8, 8192),
                                         (1, 1, 5), (3, 4, 1)])
@pytest.mark.parametrize("block_k", [1, 3, 16, 100, 128, 512])
def test_decode_split_plan_is_a_static_rule(b, kvh, t_max, block_k):
    """C is a power of two, at most block_k and the split kernel's 128
    threads, and the grid covers t_max; the plan takes static shapes only
    (no lengths), and only shrinks C to keep two CTAs per SM in flight."""
    import inspect
    assert list(inspect.signature(port.decode_split_plan).parameters) == [
        "b", "kvh", "t_max", "block_k"]
    chunk, splits = port.decode_split_plan(b, kvh, t_max, block_k)
    assert chunk & (chunk - 1) == 0 and chunk <= min(block_k, 128)
    assert splits == -(-t_max // chunk)
    top = 1 << (min(block_k, 128).bit_length() - 1)   # largest allowed
    if 16 <= chunk < top:
        assert b * kvh * -(-t_max // (2 * chunk)) < 2 * 132
    assert port.decode_split_plan(b, kvh, t_max, block_k) == (chunk, splits)


def test_decode_split_plan_at_the_main_shapes():
    """The kernel phase's cache (8 rows x 8 kv heads x 2048) takes 128-token
    chunks; generate's one row of 222 positions takes 16."""
    assert port.decode_split_plan(8, 8, 2048, 512) == (128, 16)
    assert port.decode_split_plan(1, 8, 222, 512) == (16, 14)
    with pytest.raises(ValueError):
        port.decode_split_plan(1, 1, 8, 0)


@pytest.mark.parametrize("kv_dtype,qdt", [("fp32", "fp32"), ("int8", "fp32"),
                                          ("fp32", "bf16"), ("int8", "bf16")])
def test_split_merge_plain_matches_plain_and_pallas(kv_dtype, qdt):
    """The split kernel's chunk partials merged as the combine kernel merges
    them (``split_merge_plain``) against ``flash_decode_plain`` and the
    Pallas ``flash_decode_raw`` (interpret mode): lengths 0, 1, C - 1, C,
    C + 1 and t_max at the plan's C, with NaN keys and values planted past
    each length (float caches).  fp32 1e-5; bf16 and int8 as _close."""
    rng = np.random.default_rng(12)
    b, h, kvh, d, t_max = 6, 8, 2, 32, 150
    chunk, _ = port.decode_split_plan(b, kvh, t_max, 512)
    lens = np.array([0, 1, chunk - 1, chunk, chunk + 1, t_max], np.int32)
    q = ((0.05 if kv_dtype == "int8" else 1.0)
         * rng.standard_normal((b, h, d))).astype(np.float32)
    kc = _kv(rng, (b, kvh, t_max, d), kv_dtype)
    vc = _kv(rng, (b, kvh, t_max, d), kv_dtype)
    if kv_dtype == "fp32":
        for i, n in enumerate(lens):
            kc[i, :, n:] = np.nan
            vc[i, :, n:] = np.nan
    tdt, jdt = _DT[qdt]
    kvt = tdt if kv_dtype == "fp32" else None
    kvj = jdt if kv_dtype == "fp32" else None
    got = port.split_merge_plain(_t(q, tdt), _t(kc, kvt), _t(vc, kvt),
                                 _t(lens), chunk=chunk)
    assert got.dtype == (torch.float32 if tdt is None else tdt)
    vscale = 127.0 if kv_dtype == "int8" else 1.0
    plain = port.flash_decode_plain(_t(q, tdt), _t(kc, kvt), _t(vc, kvt),
                                    _t(lens))
    _close(got.float().numpy(), plain.float().numpy(), qdt, vscale)
    want = flash_decode_raw(_j(q, jdt), _j(kc, kvj), _j(vc, kvj), _j(lens),
                            block_k=128)
    _close(got.float().numpy(), np.asarray(want, np.float32), qdt, vscale)
    assert np.all(got[0].float().numpy() == 0.0)   # sees no key -> exactly 0


# ---------------------------------------------------------------- paged B3

def _paged_inputs(rng, b, h, kvh, d, page, mp, kv_dtype="fp32"):
    nb = b * mp + 1
    tables = rng.permutation(nb)[:b * mp].reshape(b, mp).astype(np.int32)
    kp = _kv(rng, (nb, kvh, page, d), kv_dtype)
    vp = _kv(rng, (nb, kvh, page, d), kv_dtype)
    scale = 0.05 if kv_dtype == "int8" else 1.0
    q = (scale * rng.standard_normal((b, h, d))).astype(np.float32)
    return q, kp, vp, tables


@pytest.mark.parametrize("h,kvh", [(4, 2), (8, 1), (4, 4)])
@pytest.mark.parametrize("pp", [1, 2, 4])
def test_paged_decode_plain_matches_pallas(h, kvh, pp):
    """Shuffled physical pages, ragged lens (0, non page multiples), -1
    table entries past the visible pages; mp=7 is not a multiple of 2/4."""
    rng = np.random.default_rng(200 + h + kvh + pp)
    b, d, page, mp = 4, 16, 16, 7
    q, kp, vp, tables = _paged_inputs(rng, b, h, kvh, d, page, mp)
    lens = np.array([0, 5, 50, 112], np.int32)
    tables[1, 1:] = -1
    tables[2, 4:] = -1
    want = paged_decode_raw(_j(q), _j(kp), _j(vp), _j(lens), _j(tables),
                            pages_per_step=pp)
    got = port.paged_decode_plain(_t(q), _t(kp), _t(vp), _t(lens),
                                  _t(tables), pages_per_step=pp)
    _close(got.numpy(), np.asarray(want), "fp32")


@pytest.mark.parametrize("pp", [2, 4])
def test_paged_decode_plain_overrun_lens(pp):
    """Lengths past the table (the lookahead chunk of a finished slot)
    re-read the clamped last page exactly as the TPU kernel does, and
    finite; the other rows are untouched."""
    rng = np.random.default_rng(4)
    b, h, kvh, d, page, mp = 2, 4, 2, 32, 16, 4
    q, kp, vp, tables = _paged_inputs(rng, b, h, kvh, d, page, mp)
    lens = np.array([40, 999], np.int32)
    want = np.asarray(paged_decode_raw(_j(q), _j(kp), _j(vp), _j(lens),
                                       _j(tables), pages_per_step=pp))
    got = port.paged_decode_plain(_t(q), _t(kp), _t(vp), _t(lens),
                                  _t(tables), pages_per_step=pp).numpy()
    _close(got, want, "fp32")


def test_paged_decode_plain_negative_table_clamps_to_page0():
    """A -1 entry INSIDE the visible range reads physical page 0."""
    rng = np.random.default_rng(6)
    b, h, kvh, d, page, mp = 1, 4, 2, 16, 8, 3
    q, kp, vp, _ = _paged_inputs(rng, b, h, kvh, d, page, mp)
    tables = np.array([[3, -1, -1]], np.int32)
    lens = np.array([13], np.int32)
    want = paged_decode_raw(_j(q), _j(kp), _j(vp), _j(lens), _j(tables),
                            pages_per_step=1)
    got = port.paged_decode_plain(_t(q), _t(kp), _t(vp), _t(lens),
                                  _t(tables), pages_per_step=1)
    _close(got.numpy(), np.asarray(want), "fp32")


def test_paged_decode_plain_garbage_in_trash_page():
    """NaN in pages and rows past each length (the trash page, unwritten
    slots) never reaches the result."""
    rng = np.random.default_rng(7)
    b, h, kvh, d, page, mp = 2, 4, 2, 16, 16, 4
    q, kp, vp, tables = _paged_inputs(rng, b, h, kvh, d, page, mp)
    lens = np.array([20, 33], np.int32)
    for bi in range(b):
        for j in range(mp):
            lo = max(0, int(lens[bi]) - j * page)
            kp[tables[bi, j], :, lo:] = np.nan
            vp[tables[bi, j], :, lo:] = np.inf
    want = np.asarray(paged_decode_raw(_j(q), _j(kp), _j(vp), _j(lens),
                                       _j(tables), pages_per_step=2))
    got = port.paged_decode_plain(_t(q), _t(kp), _t(vp), _t(lens),
                                  _t(tables), pages_per_step=2).numpy()
    _close(got, want, "fp32")


@pytest.mark.parametrize("kv_dtype,qdt", [("fp32", "bf16"), ("int8", "fp32"),
                                          ("int8", "bf16")])
def test_paged_decode_plain_dtypes(kv_dtype, qdt):
    rng = np.random.default_rng(8)
    b, h, kvh, d, page, mp = 3, 8, 2, 32, 16, 5
    q, kp, vp, tables = _paged_inputs(rng, b, h, kvh, d, page, mp, kv_dtype)
    lens = np.array([3, 47, 80], np.int32)
    tdt, jdt = _DT[qdt]
    kvt = tdt if kv_dtype == "fp32" else None
    kvj = jdt if kv_dtype == "fp32" else None
    want = paged_decode_raw(_j(q, jdt), _j(kp, kvj), _j(vp, kvj), _j(lens),
                            _j(tables), pages_per_step=2)
    got = port.paged_decode_plain(_t(q, tdt), _t(kp, kvt), _t(vp, kvt),
                                  _t(lens), _t(tables), pages_per_step=2)
    _close(got.float().numpy(), np.asarray(want, np.float32), qdt,
           127.0 if kv_dtype == "int8" else 1.0)


@pytest.mark.parametrize("rows,kvh", [(8, 8), (264, 8), (1, 1), (4, 2)])
@pytest.mark.parametrize("page,max_pages,pp", [(16, 128, 32), (16, 9, 1),
                                               (16, 9, 3), (8, 7, 2),
                                               (48, 5, 5), (128, 4, 1)])
def test_paged_split_plan_is_a_static_rule(rows, kvh, page, max_pages, pp):
    """C is a whole number of pages (at least one, at most the split
    kernel's 128 threads): ``decode_split_plan``'s chunk over the walked
    length ceil(max_pages / pp) * pp * page, cut down to pages; the grid
    at full length covers the walk.  Static shapes only (no lengths)."""
    import inspect
    assert list(inspect.signature(port.paged_split_plan).parameters) == [
        "rows", "kvh", "page", "max_pages", "pp"]
    chunk, splits = port.paged_split_plan(rows, kvh, page, max_pages, pp)
    walk = -(-max_pages // pp) * pp * page
    dense, _ = port.decode_split_plan(rows, kvh, walk)
    assert chunk % page == 0 and page <= chunk <= 128
    assert chunk == max(page, dense // page * page)
    assert (splits - 1) * chunk < walk <= splits * chunk
    assert port.paged_split_plan(rows, kvh, page, max_pages, pp) == (
        chunk, splits)


def test_paged_split_plan_at_the_main_shapes():
    """The serving pools (page 16, 128 table columns, pp 32): the chunked
    engine's 8 rows and the unified engine's 264 take 8-page chunks, 16
    of them; a page over 128 tokens is refused."""
    assert port.paged_split_plan(8, 8, 16, 128, 32) == (128, 16)
    assert port.paged_split_plan(264, 8, 16, 128, 32) == (128, 16)
    with pytest.raises(ValueError, match="page"):
        port.paged_split_plan(8, 8, 256, 4, 1)


def _plant_unseen_np(kp, vp, tables, lens, slots, walked):
    """NaN in every pool position no row sees (past each length, unused
    entries, the trash page), by the kernels' walk and clamps."""
    page, mp = kp.shape[2], tables.shape[1]
    seen = np.zeros((kp.shape[0], page), bool)
    for n, s in zip(lens, slots):
        if s < 0:
            continue
        t = np.arange(min(max(int(n), 0), walked * page))
        phys = np.maximum(tables[s, np.minimum(t // page, mp - 1)], 0)
        seen[phys, t % page] = True
    unseen = np.broadcast_to(~seen[:, None, :, None], kp.shape)
    kp[unseen] = np.nan
    vp[unseen] = np.nan


@pytest.mark.parametrize("chunk", ["plan", 48])
@pytest.mark.parametrize("kv_dtype,qdt", [("fp32", "fp32"), ("fp32", "bf16"),
                                          ("int8", "bf16"), ("bf16", "fp32")])
@pytest.mark.parametrize("ragged", [False, True])
def test_paged_split_merge_plain_matches_pallas(ragged, kv_dtype, qdt, chunk):
    """The paged split and combine kernels' arithmetic
    (``paged_split_merge_plain``: each row's walked pages gathered, then
    ``split_merge_plain`` over chunks of whole pages) against the Pallas
    ``paged_decode_raw`` / ``ragged_paged_decode_raw`` (interpret mode)
    and the port's plain versions, at the plan's chunk and a forced
    three-page one: lengths 0, ending mid-page and mid-chunk, past the
    table; a -1 entry inside the visible range; padding rows (ragged); NaN
    everywhere no row sees (float pools).  The pools are q's dtype, int8
    under bf16 q, or bf16 under fp32 q (an fp32 model on an int8 dict's
    bf16 pools).  fp32 1e-5; bf16 and int8, and fp32 q over bf16 K/V (p
    rounded to bf16 against the chunk's max here, the running max in
    Pallas and the row's in the plain versions), as _close's bf16."""
    rng = np.random.default_rng(21 + ragged)
    b, h, kvh, d, page, mp, pp = 6, 8, 2, 16, 16, 9, 3
    q, kp, vp, tables = _paged_inputs(rng, b, h, kvh, d, page, mp, kv_dtype)
    tables[0, 1:] = -1
    tables[2, 3] = -1
    if ragged:
        lens, slots = _ragged_rows(rng, [7, 0, 100, 999, 57, 95], 2)
        q = ((0.05 if kv_dtype == "int8" else 1.0) * rng.standard_normal(
            (len(lens), h, d))).astype(np.float32)
    else:
        lens = np.array([7, 0, 100, 999, 57, 95], np.int32)
        slots = np.arange(b, dtype=np.int32)
    if kv_dtype != "int8":
        _plant_unseen_np(kp, vp, tables, lens, slots, mp)
    tdt, jdt = _DT[qdt]
    kvt, kvj = {"fp32": (tdt, jdt), "int8": (None, None),
                "bf16": _DT["bf16"]}[kv_dtype]
    gate = "fp32" if (qdt, kv_dtype) == ("fp32", "fp32") else "bf16"
    c = None if chunk == "plan" else chunk
    vscale = 127.0 if kv_dtype == "int8" else 1.0
    tq, tk, tv = _t(q, tdt), _t(kp, kvt), _t(vp, kvt)
    if ragged:
        got = port.paged_split_merge_plain(tq, tk, tv, _t(lens), _t(tables),
                                           _t(slots), pages_per_step=pp,
                                           chunk=c)
        plain = port.ragged_paged_decode_plain(tq, tk, tv, _t(lens),
                                               _t(slots), _t(tables),
                                               pages_per_step=pp)
        want = ragged_paged_decode_raw(_j(q, jdt), _j(kp, kvj), _j(vp, kvj),
                                       _j(lens), _j(slots), _j(tables),
                                       pages_per_step=pp)
    else:
        got = port.paged_split_merge_plain(tq, tk, tv, _t(lens), _t(tables),
                                           pages_per_step=pp, chunk=c)
        plain = port.paged_decode_plain(tq, tk, tv, _t(lens), _t(tables),
                                        pages_per_step=pp)
        want = paged_decode_raw(_j(q, jdt), _j(kp, kvj), _j(vp, kvj),
                                _j(lens), _j(tables), pages_per_step=pp)
    assert got.dtype == (torch.float32 if tdt is None else tdt)
    _close(got.float().numpy(), plain.float().numpy(), gate, vscale)
    _close(got.float().numpy(), np.asarray(want, np.float32), gate, vscale)
    seen_none = (lens <= 0) | (slots < 0)
    assert np.all(got.float().numpy()[seen_none] == 0.0)


# --------------------------------------------------------------- ragged B3'

def _ragged_rows(rng, slots_lens, pad_rows):
    """Decode rows (one per slot, sees its whole length), a prefill chunk
    of slot 0 (rows see positions up to themselves) and padding rows."""
    lens, slots = [], []
    for s, n in enumerate(slots_lens):
        lens.append(n)
        slots.append(s)
    for p in range(max(1, slots_lens[0] - 6), slots_lens[0] + 1):
        lens.append(p)
        slots.append(0)
    for _ in range(pad_rows):
        lens.append(int(rng.integers(0, 40)))      # ignored: slot < 0
        slots.append(-1)
    return np.array(lens, np.int32), np.array(slots, np.int32)


@pytest.mark.parametrize("h,kvh", [(4, 2), (8, 1), (4, 4)])
@pytest.mark.parametrize("pp", [1, 4])
def test_ragged_paged_decode_plain_matches_pallas(h, kvh, pp):
    rng = np.random.default_rng(300 + h + kvh + pp)
    nslots, d, page, mp = 3, 16, 16, 6
    _, kp, vp, tables = _paged_inputs(rng, nslots, h, kvh, d, page, mp)
    tables[2, 2:] = -1
    lens, slots = _ragged_rows(rng, [45, 0, 17], pad_rows=3)
    q = rng.standard_normal((len(lens), h, d)).astype(np.float32)
    want = np.asarray(ragged_paged_decode_raw(
        _j(q), _j(kp), _j(vp), _j(lens), _j(slots), _j(tables),
        pages_per_step=pp))
    got = port.ragged_paged_decode_plain(
        _t(q), _t(kp), _t(vp), _t(lens), _t(slots), _t(tables),
        pages_per_step=pp).numpy()
    _close(got, want, "fp32")
    assert np.all(got[slots < 0] == 0.0)            # padding rows -> 0


@pytest.mark.parametrize("kv_dtype,qdt", [("fp32", "bf16"), ("int8", "bf16")])
def test_ragged_paged_decode_plain_dtypes(kv_dtype, qdt):
    rng = np.random.default_rng(9)
    nslots, h, kvh, d, page, mp = 2, 4, 2, 32, 16, 4
    _, kp, vp, tables = _paged_inputs(rng, nslots, h, kvh, d, page, mp,
                                      kv_dtype)
    lens, slots = _ragged_rows(rng, [30, 9], pad_rows=2)
    q = (0.05 * rng.standard_normal((len(lens), h, d))).astype(np.float32)
    tdt, jdt = _DT[qdt]
    kvt = tdt if kv_dtype == "fp32" else None
    kvj = jdt if kv_dtype == "fp32" else None
    want = ragged_paged_decode_raw(_j(q, jdt), _j(kp, kvj), _j(vp, kvj),
                                   _j(lens), _j(slots), _j(tables))
    got = port.ragged_paged_decode_plain(_t(q, tdt), _t(kp, kvt),
                                         _t(vp, kvt), _t(lens), _t(slots),
                                         _t(tables))
    _close(got.float().numpy(), np.asarray(want, np.float32), qdt,
           127.0 if kv_dtype == "int8" else 1.0)


# ------------------------------------------------------- wrappers and guards

def test_default_pages_per_step_matches_jax():
    for args in [(128, 4, 128, 16), (512, 4, 128, 16), (64, 4, 128, 2),
                 (16, 8, 128, 128), (512, 32, 128, 16, 2), (16, 2, 8, 8)]:
        assert port.default_pages_per_step(*args) == jax_default_pp(*args)


def test_cpu_tensor_takes_plain_version_without_launch():
    rng = np.random.default_rng(10)
    q, kp, vp, tables = _paged_inputs(rng, 2, 4, 2, 16, 8, 3)
    lens = np.array([5, 20], np.int32)
    port.reset_launches()
    got = port.paged_decode(_t(q), _t(kp), _t(vp), _t(lens), _t(tables))
    want = port.paged_decode_plain(_t(q), _t(kp), _t(vp), _t(lens),
                                   _t(tables))
    assert torch.equal(got, want)
    kc = rng.standard_normal((2, 2, 24, 16)).astype(np.float32)
    got = port.flash_decode(_t(q), _t(kc), _t(kc), _t(lens))
    assert torch.equal(got, port.flash_decode_plain(_t(q), _t(kc), _t(kc),
                                                    _t(lens)))
    got = port.ragged_paged_decode(_t(q), _t(kp), _t(vp), _t(lens),
                                   _t(np.array([1, -1], np.int32)),
                                   _t(tables))
    assert torch.all(got[1] == 0)
    assert port.LAUNCHES == {"flash_decode": 0, "paged_decode": 0,
                             "ragged_paged_decode": 0}


def test_default_device_raises_without_cuda(monkeypatch):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        LlamaForCausalLM(LlamaConfig.debug(layers=1))
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("case", ["heads", "dtype", "mixed", "contig",
                                  "head_dim"])
def test_wrapper_guards_raise(case):
    rng = np.random.default_rng(11)
    q = _t(rng.standard_normal((2, 4, 16)).astype(np.float32))
    kc = _t(rng.standard_normal((2, 2, 32, 16)).astype(np.float32))
    lens = _t(np.array([3, 9], np.int32))
    if case == "heads":                             # 4 q heads, 3 kv heads
        kc3 = _t(rng.standard_normal((2, 3, 32, 16)).astype(np.float32))
        args, exc = (q, kc3, kc3), ValueError
    elif case == "dtype":
        args, exc = (q.double(), kc.double(), kc.double()), TypeError
    elif case == "mixed":          # bf16 q over fp32 K/V (fp32 q over bf16
        # K/V is served: an fp32 model on the bf16 pool of an int8 dict)
        args, exc = (q.to(torch.bfloat16), kc, kc), TypeError
    elif case == "contig":
        args, exc = (q, kc.transpose(2, 3).contiguous().transpose(2, 3),
                     kc), ValueError
    else:
        args, exc = (q[..., :12].contiguous(), kc[..., :12].contiguous(),
                     kc[..., :12].contiguous()), ValueError
    with pytest.raises(exc):
        port.flash_decode(*args, lens)
