"""Grouped matmul of the PyTorch port (paddle_tpu_torch/ops/grouped_matmul.py)
against the Pallas kernels of paddle_tpu/ops/pallas/grouped_matmul.py run in
interpret mode on the CPU.

The same seeded numpy inputs go through ``grouped_matmul_raw`` (B7) and
``grouped_outer_raw`` (B8) of both packages; the port's CPU tensors take its
``*_plain`` versions.  fp32 agrees to 1e-5 and bf16 to 2e-2 (largest
|port - JAX| over the largest |JAX|) on every row a segment's window covers;
the rows no segment covers are exact zeros in the port (the JAX contract
leaves them unspecified).  The autograd form is held against ``jax.grad``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import grouped_matmul as jgm
from paddle_tpu_torch.models import params_from_jax
from paddle_tpu_torch.ops import grouped_matmul as gm

TOL = {"fp32": 1e-5, "bf16": 2e-2}
DTYPES = {"fp32": (np.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}

# name -> (lens, wids or None for arange, block_rows)
CASES = {
    "exact_blocks": ([8, 8, 8], None, 8),
    "ragged_empty": ([3, 0, 13, 8], None, 8),
    "all_empty": ([0, 0, 0], None, 8),
    "one_segment_many_blocks": ([25], None, 8),
    "tiny_segments": ([1, 1, 1, 1, 1, 1], None, 8),
    "skewed_one_expert": ([0, 0, 37, 0], None, 8),
    "repeated_wids": ([5, 9, 2, 7], [1, 0, 1, 1], 8),
    "block_rows_16_unaligned": ([17, 3, 0, 30], None, 16),
}


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if want.size == 0:
        return 0.0
    den = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) / den


def _pack(lens, bm, K, rng, pad_blocks=1):
    """x [R, K] with zero alignment slack and ``pad_blocks`` uncovered
    blocks at the end, the dense block-aligned starts, and the covered
    row mask (every row of each segment's aligned window)."""
    aligned = [int(jgm.align_rows(n, bm)) for n in lens]
    R = sum(aligned) + pad_blocks * bm
    x = np.zeros((R, K), np.float32)
    starts, off = [], 0
    covered = np.zeros(R, bool)
    for n, a in zip(lens, aligned):
        starts.append(off)
        x[off:off + n] = rng.standard_normal((n, K))
        covered[off:off + a] = True
        off += a
    return x, np.asarray(starts, np.int32), covered


def _inputs(case, K, N, seed, e_extra=1):
    lens, wids, bm = CASES[case]
    rng = np.random.default_rng(seed)
    x, starts, covered = _pack(lens, bm, K, rng)
    S = len(lens)
    wids = np.arange(S, dtype=np.int32) if wids is None \
        else np.asarray(wids, np.int32)
    E = int(wids.max()) + 1 + e_extra
    w = (rng.standard_normal((E, K, N)) / np.sqrt(K)).astype(np.float32)
    return dict(x=x, w=w, starts=starts, lens=np.asarray(lens, np.int32),
                wids=wids, bm=bm, covered=covered, rng=rng)


def _t(a, dtype=None):
    t = params_from_jax({"a": a}, "cpu")["a"]
    return t if dtype is None else t.to(dtype)


def _seg_t(inp):
    return (torch.from_numpy(inp["starts"]), torch.from_numpy(inp["lens"]),
            torch.from_numpy(inp["wids"]))


def _jax_gmm(inp, x, w, **kw):
    return np.asarray(jgm.grouped_matmul_raw(
        x, w, jnp.asarray(inp["starts"]), jnp.asarray(inp["lens"]),
        jnp.asarray(inp["wids"]), block_rows=inp["bm"], interpret=True,
        **kw).astype(jnp.float32))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind", ["fp32", "bf16"])
def test_grouped_matmul_plain_matches_pallas(case, kind):
    jdt, tdt = DTYPES[kind]
    inp = _inputs(case, 16, 24, 0)
    xj, wj = jnp.asarray(inp["x"], jdt), jnp.asarray(inp["w"], jdt)
    want = _jax_gmm(inp, xj, wj)
    got = gm.grouped_matmul_raw(_t(xj), _t(wj), *_seg_t(inp),
                                block_rows=inp["bm"])
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    cov = inp["covered"]
    assert _rel(got.float().numpy()[cov], want[cov]) <= TOL[kind]
    assert torch.all(got[torch.from_numpy(~cov)] == 0)


@pytest.mark.parametrize("case", ["ragged_empty", "repeated_wids",
                                  "skewed_one_expert"])
@pytest.mark.parametrize("kind", ["fp32", "bf16"])
def test_grouped_matmul_int8_scale_matches_pallas(case, kind):
    """An int8 bank with per-(slice, out-channel) fp32 scales: widened to
    x's dtype, the scale folded into the fp32 accumulator."""
    jdt, _ = DTYPES[kind]
    inp = _inputs(case, 32, 16, 1)
    rng = inp["rng"]
    wq = rng.integers(-127, 128, inp["w"].shape).astype(np.int8)
    sc = (rng.random(inp["w"].shape[::2]) * 0.02).astype(np.float32)
    xj = jnp.asarray(inp["x"], jdt)
    want = _jax_gmm(inp, xj, jnp.asarray(wq), w_scale=jnp.asarray(sc))
    got = gm.grouped_matmul_raw(_t(xj), torch.from_numpy(wq),
                                *_seg_t(inp), block_rows=inp["bm"],
                                w_scale=torch.from_numpy(sc))
    cov = inp["covered"]
    assert _rel(got.float().numpy()[cov], want[cov]) <= TOL[kind]


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
def test_grouped_matmul_transposed_matches_pallas_on_swapped_bank(kind):
    """``transpose_w`` (the backward's dx) equals the Pallas launch on
    ``w.swapaxes(1, 2)``, without a transposed copy."""
    jdt, _ = DTYPES[kind]
    inp = _inputs("repeated_wids", 24, 16, 2)
    xj = jnp.asarray(inp["x"][:, :16], jdt)     # [R, N] against w [E, K, N]
    wj = jnp.asarray(inp["w"], jdt)
    want = _jax_gmm(inp, xj, wj.swapaxes(1, 2))
    got = gm.grouped_matmul_raw(_t(xj), _t(wj), *_seg_t(inp),
                                block_rows=inp["bm"], transpose_w=True)
    cov = inp["covered"]
    assert _rel(got.float().numpy()[cov], want[cov]) <= TOL[kind]


@pytest.mark.parametrize("case", ["ragged_empty", "repeated_wids",
                                  "block_rows_16_unaligned", "all_empty"])
@pytest.mark.parametrize("kind", ["fp32", "bf16"])
def test_grouped_outer_plain_matches_pallas(case, kind):
    jdt, _ = DTYPES[kind]
    inp = _inputs(case, 16, 8, 3)
    dy = inp["rng"].standard_normal((inp["x"].shape[0], 24)).astype(
        np.float32)
    xj, dyj = jnp.asarray(inp["x"], jdt), jnp.asarray(dy, jdt)
    want = np.asarray(jgm.grouped_outer_raw(
        xj, dyj, jnp.asarray(inp["starts"]), jnp.asarray(inp["lens"]),
        block_rows=inp["bm"], interpret=True))
    got = gm.grouped_outer_raw(_t(xj), _t(dyj), *_seg_t(inp)[:2],
                               block_rows=inp["bm"])
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    empty = inp["lens"] == 0
    assert torch.all(got[torch.from_numpy(empty)] == 0)
    assert np.all(want[empty] == 0)
    if not empty.all():
        assert _rel(got.numpy(), want) <= TOL["fp32"]


def test_segment_starts_equal_jax():
    for lens, bm in (([3, 0, 13, 8], 8), ([0, 0], 8), ([130, 1, 0, 7], 128),
                     ([5], 1)):
        want = np.asarray(jgm.segment_starts(jnp.asarray(lens, jnp.int32),
                                             bm))
        got = gm.segment_starts(torch.tensor(lens, dtype=torch.int32), bm)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert gm.align_rows(13, 8) == int(jgm.align_rows(13, 8)) == 16


@pytest.mark.parametrize("kind", ["fp32", "bf16"])
def test_grouped_matmul_autograd_matches_jax_grad(kind):
    """dx and dW (repeated wids accumulate into one slice) of
    ``sum(grouped_matmul(x, w) * g)`` against ``jax.grad`` through the
    custom_vjp, on the covered rows."""
    jdt, tdt = DTYPES[kind]
    inp = _inputs("repeated_wids", 16, 24, 4)
    R = inp["x"].shape[0]
    g = inp["rng"].standard_normal((R, 24)).astype(np.float32)
    cov = inp["covered"]
    g[~cov] = 0.0                    # the JAX output there is unspecified
    xj, wj, gj = (jnp.asarray(a, jdt) for a in (inp["x"], inp["w"], g))
    st, ln, wd = (jnp.asarray(inp[k]) for k in ("starts", "lens", "wids"))

    def f(x, w):
        y = jgm.grouped_matmul(x, w, st, ln, wd, block_rows=inp["bm"])
        return jnp.sum((y * gj).astype(jnp.float32))

    jdx, jdw = jax.grad(f, argnums=(0, 1))(xj, wj)
    x = _t(xj).requires_grad_()
    w = _t(wj).requires_grad_()
    y = gm.grouped_matmul(x, w, *_seg_t(inp), block_rows=inp["bm"])
    (y.float() * _t(gj).float()).sum().backward()
    assert x.grad.dtype == tdt and w.grad.dtype == tdt
    tol = TOL[kind]
    assert _rel(x.grad.float().numpy()[cov],
                np.asarray(jdx.astype(jnp.float32))[cov]) <= tol
    assert _rel(w.grad.float().numpy(),
                np.asarray(jdw.astype(jnp.float32))) <= tol
    unused = w.grad[int(inp["wids"].max()) + 1:]
    assert torch.all(unused == 0)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(12, 8)
    w = torch.zeros(2, 8, 8)
    seg = (torch.tensor([0], dtype=torch.int32),) * 3
    with pytest.raises(ValueError, match="multiple of block_rows"):
        gm.grouped_matmul_raw(x, w, *seg, block_rows=8)
    with pytest.raises(ValueError, match="w_scale"):
        gm.grouped_matmul_raw(x[:8], w.to(torch.int8), *seg, block_rows=8)
    with pytest.raises(ValueError, match="inner dim"):
        gm.grouped_matmul_raw(x[:8, :4], w, *seg, block_rows=8)
    with pytest.raises(TypeError):
        gm.grouped_matmul_raw(x[:8], w.double(), *seg, block_rows=8)
    with pytest.raises(ValueError, match="rows"):
        gm.grouped_outer_raw(x[:8], torch.zeros(16, 8), *seg[:2],
                             block_rows=8)


@pytest.mark.parametrize("x_needs_grad", [True, False])
def test_grouped_matmul_dx_only_when_x_needs_it(x_needs_grad, monkeypatch):
    """The backward launches the transposed B7 only when x needs a
    gradient (the dropless block's first GEMM reads dispatched tokens that
    need none); dW is the same either way, and dx, when made, equals the
    plain transposed product of the output gradient."""
    inp = _inputs("repeated_wids", 16, 24, 5)
    calls = []
    raw = gm.grouped_matmul_raw

    def counted(*a, **kw):
        calls.append(bool(kw.get("transpose_w", False)))
        return raw(*a, **kw)

    monkeypatch.setattr(gm, "grouped_matmul_raw", counted)
    x = torch.from_numpy(inp["x"]).requires_grad_(x_needs_grad)
    w = torch.from_numpy(inp["w"]).requires_grad_()
    g = torch.from_numpy(inp["rng"].standard_normal(
        (inp["x"].shape[0], 24)).astype(np.float32))
    y = gm.grouped_matmul(x, w, *_seg_t(inp), block_rows=inp["bm"])
    (y * g).sum().backward()
    assert calls == [False] + ([True] if x_needs_grad else [])
    want_dw = torch.zeros_like(w)
    want_dw.index_add_(0, torch.from_numpy(inp["wids"]).long(),
                       gm.grouped_outer_plain(x.detach(), g, *_seg_t(inp)[:2],
                                              inp["bm"]))
    assert torch.allclose(w.grad, want_dw, rtol=1e-6, atol=1e-6)
    if x_needs_grad:
        want_dx = gm.grouped_matmul_plain(g, w.detach(), *_seg_t(inp),
                                          inp["bm"], transpose_w=True)
        assert torch.equal(x.grad, want_dx)
    else:
        assert x.grad is None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("w_int8", [False, True])
def test_gmm_route_is_a_rule_on_dtype_and_bank(dtype, w_int8):
    bf16 = dtype == torch.bfloat16
    want = (("int8_wgmma" if bf16 else "int8") if w_int8 else
            "wgmma" if bf16 else "cuda_cores")
    assert gm.gmm_route(dtype, w_int8) == want


# (R, K, N, S) of the Mixtral serving calls: decode (8 slots x top-2 = 16
# copies at block_rows 8), a unified step (528 copies), a 6 x 300-token
# prefill (3600 copies); up (K 4096, N 14336) and down (K 14336, N 4096)
@pytest.mark.parametrize("R,K,N,S,want", [
    (80, 4096, 14336, 8, (16, 1, False, 13 * 112)),
    (80, 14336, 4096, 8, (16, 4, False, 13 * 4 * 32)),
    (592, 4096, 14336, 8, (128, 1, False, 13 * 112)),
    (592, 14336, 4096, 8, (128, 2, False, 13 * 2 * 32)),
    (3664, 4096, 14336, 8, (128, 1, True, 37 * 112)),
    (3664, 14336, 4096, 8, (128, 1, True, 37 * 32)),
    (80, 4096, 256, 8, (16, 8, False, 13 * 8 * 2)),
    (360, 64, 64, 8, (64, 1, False, 14)),
])
def test_gmm_int8_plan_at_the_serving_shapes(R, K, N, S, want):
    assert gm.gmm_int8_plan(R, K, N, S) == want


@pytest.mark.parametrize("R", [8, 80, 144, 145, 576, 577, 3664, 70000])
@pytest.mark.parametrize("K", [64, 512, 4096, 14336])
@pytest.mark.parametrize("N,S", [(128, 1), (4096, 8), (14336, 8),
                                 (256, 64)])
def test_gmm_int8_plan_is_a_static_rule(R, K, N, S):
    """B7 int8's plan from (R, K, N, S) alone: the row tile is 16 while R
    <= 16 (S + 1), else 64 while R <= 64 (S + 1), else 128; the grid holds
    R / tile + S row tiles x splits x ceil(N / 128); splits is a power of
    two up to 8, doubled only while the likely live CTAs (max(S, R / tile)
    row tiles) fill fewer than two waves of 132 SMs (two CTAs an SM below
    tile 128) and each split keeps at least 8 K steps of 64; row tiles
    run innermost when R > 2 tile (S + 1)."""
    import inspect
    assert list(inspect.signature(gm.gmm_int8_plan).parameters) == [
        "R", "K", "N", "S"]
    tile, splits, rows_inner, grid = gm.gmm_int8_plan(R, K, N, S)
    assert tile == (16 if R <= 16 * (S + 1) else
                    64 if R <= 64 * (S + 1) else 128)
    assert rows_inner == (R > 2 * tile * (S + 1))
    cols = -(-N // 128)
    assert grid == (-(-R // tile) + S) * splits * cols
    assert splits in (1, 2, 4, 8)
    steps = -(-K // 64)
    live = max(S, -(-R // tile)) * cols
    slots = (1 if tile == 128 else 2) * 132
    if splits > 1:
        assert steps >= splits * 8 and live * splits // 2 < 2 * slots
    if splits < 8 and steps >= 2 * splits * 8:
        assert live * splits >= 2 * slots
