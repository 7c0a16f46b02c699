"""Grouped (segmented) matmul: one ragged launch applies a different
``[in, out]`` weight slice to each variable-length row segment.

Port of ``paddle_tpu/ops/pallas/grouped_matmul.py``, the expert compute of
the dropless MoE path and of sparse serving.  Tokens arrive sorted by
expert, so segment ``s`` owns the row window ``[start_s, start_s +
align(len_s))`` of ``x`` and is multiplied by ``w[wid_s]``.  Two kernels,
hand-written for Hopper in ``csrc/grouped_matmul.cu``:

- ``grouped_matmul_raw`` (TPU body ``_gmm_kernel``, B7): y = x @ w[wid] per
  segment, float banks or int8 banks with per-(slice, out-channel) fp32
  scales folded into the fp32 accumulator; ``transpose_w=True`` multiplies
  by ``w[wid]ᵀ`` (the backward's dx) without a transposed copy;
- ``grouped_outer_raw`` (TPU body ``_outer_kernel``, B8): the per-segment
  ``x[win]ᵀ · dy[win]`` of the backward's dW, fp32 [S, K, N].

``grouped_matmul`` is the differentiable form (``_GroupedMatmul``): dx is
the B7 launch on the transposed slices, made only when x needs a gradient;
dW is B8 followed by an fp32 ``index_add_`` over ``seg_wids`` (repeated ids
accumulate, as the JAX ``.at[seg_wids].add`` does), cast to ``w.dtype``.

``gmm_route`` picks B7's kernel on the card by an explicit rule: a bf16
bank runs ``gmm_wgmma_kernel`` (TMA ring, wgmma, register accumulators),
forward and transposed; bf16 x over an int8 bank (serving) runs
``gmm_int8_wgmma_kernel`` (the bank streamed by TMA and widened in shared
memory, the product swapped so a segment's few rows are wgmma's narrow N),
its row tile and K splits picked by ``gmm_int8_plan`` from static shapes;
fp32 x runs ``gmm_kernel``.

Each launcher is a registered operator (``ops/_registry.py``:
``grouped_matmul``, ``grouped_outer``): on a CUDA tensor its implementation
runs the kernel and counts the launch in ``LAUNCHES``; on a CPU tensor it
runs the ``*_plain`` PyTorch version beside it; on fake tensors it gives
the output shape and runs nothing.  A tensor on any other device raises.

Contract (as the TPU launcher's): ``x`` [R, K] with R a multiple of
``block_rows``; ``seg_starts`` ``block_rows``-aligned (an unaligned start
rounds down to its block, as the TPU's block index map does); the rows of a
segment's alignment slack ``[len, align(len))`` of ``x`` are zero (the
dispatch guarantees it), so they add exact zeros to dW; segments do not
overlap; ``seg_wids`` lie in ``[0, E)``.  The windows are the TPU's: whole
row blocks, so a segment covers ``align(len)`` rows.  Rows that no segment
covers are left unspecified by the JAX contract; here they are exact zeros,
in the kernel and in the plain version alike, so no uninitialised memory
reaches a ``torch.where`` or a product downstream.  On the card ``K`` and
``N`` must be multiples of 8 (16-byte row loads, TMA strides), ``N`` of 16
over an int8 bank (its rows are the TMA stride), and the wgmma routes' x
and bank need 16-byte aligned bases.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from . import _build, _registry

#: kernel launches per kernel, counted where each wrapper launches: B7 with
#: a float bank, B7 with an int8 bank, B7 on the transposed slices (dx), B8
LAUNCHES: Dict[str, int] = {"grouped_matmul": 0, "grouped_matmul_int8": 0,
                            "grouped_matmul_t": 0, "grouped_outer": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the C interface's route codes (pt_grouped_matmul)
_ROUTE_CODES = {"cuda_cores": 0, "int8": 0, "wgmma": 1, "int8_wgmma": 2}
# gmm_kernel's row tile (kBM in csrc/grouped_matmul.cu); a grid row per tile
_KERNEL_ROWS = 64
_MAX_GRID_Y = 65535
# gmm_int8_wgmma_kernel: its row tiles (the products' N), output columns
# per CTA, K per pipeline step; the H100's SMs; the fewest K steps a split
# takes and the most splits
_INT8_ROW_TILES = (16, 64, 128)
_INT8_COLS = 128
_INT8_STEP = 64
_SMS = 132
_INT8_MIN_SPLIT_STEPS = 8
_INT8_MAX_SPLITS = 8


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def gmm_route(dtype: torch.dtype, w_int8: bool) -> str:
    """Which CUDA kernel runs B7 for x's dtype and the bank's kind:
    ``"wgmma"`` (``gmm_wgmma_kernel``) for bf16 x over a bf16 bank, forward
    and transposed (the train cell's GEMMs); ``"int8_wgmma"``
    (``gmm_int8_wgmma_kernel``) for bf16 x over an int8 bank (serving);
    ``"int8"`` for fp32 x over an int8 bank and ``"cuda_cores"`` for fp32 x
    over an fp32 bank (``gmm_kernel``)."""
    if dtype == torch.bfloat16:
        return "int8_wgmma" if w_int8 else "wgmma"
    return "int8" if w_int8 else "cuda_cores"


@functools.lru_cache(maxsize=256)
def gmm_int8_plan(R: int, K: int, N: int, S: int):
    """(row tile, K splits, rows innermost, CTAs) of
    ``gmm_int8_wgmma_kernel`` from static shapes only (segment lengths stay
    on the device).  The row tile is the products' N: 16 when R <= 16
    (S + 1) (decode: a segment holds a few rows), 64 when R <= 64 (S + 1),
    else 128.  The grid holds R / tile + S row tiles (the most the segments
    can need) x splits x ceil(N / 128).  About max(S, R / tile) of its row
    tiles hold rows; K is split in two while those live CTAs fill fewer
    than two waves of the card (two CTAs per SM at tiles 16 and 64, one at
    128), each split keeping at least _INT8_MIN_SPLIT_STEPS K steps of 64,
    at most _INT8_MAX_SPLITS.  Row tiles run innermost when the segments
    average more than two row tiles (R > 2 tile (S + 1), the prefill
    calls), so a segment's tiles read each weight tile close together;
    else column tiles, so the CTAs in flight read neighbouring pieces of
    the same bank rows, faster at the decode and unified calls
    (``chip_smoke.py`` times both orders at the Mixtral calls)."""
    tile = next((t for t in _INT8_ROW_TILES[:-1] if R <= t * (S + 1)),
                _INT8_ROW_TILES[-1])
    row_tiles = -(-R // tile) + S
    col_tiles = -(-N // _INT8_COLS)
    live = max(S, -(-R // tile)) * col_tiles
    slots = (1 if tile == 128 else 2) * _SMS
    steps = -(-K // _INT8_STEP)
    splits = 1
    while (splits * 2 <= _INT8_MAX_SPLITS and live * splits < 2 * slots
           and steps >= 2 * splits * _INT8_MIN_SPLIT_STEPS):
        splits *= 2
    rows_inner = R > 2 * tile * (S + 1)
    return tile, splits, rows_inner, row_tiles * splits * col_tiles


def align_rows(n, block_rows: int):
    """Round ``n`` up to a multiple of ``block_rows`` (ints and integer
    tensors)."""
    return ((n + block_rows - 1) // block_rows) * block_rows


def segment_starts(seg_lens: torch.Tensor, block_rows: int) -> torch.Tensor:
    """Block-aligned exclusive cumsum of segment lengths: the ``seg_starts``
    the kernels want (segments densely tile ``[0, sum(align(len)))``)."""
    aligned = align_rows(seg_lens, block_rows)
    return torch.cumsum(aligned, 0, dtype=seg_lens.dtype) - aligned


def sorted_segments(expert_ids: torch.Tensor, num_experts: int,
                    block_rows: int):
    """The sorted ragged dispatch of the MoE callers (``_moe_ffn``, the
    dropless block): flat expert ids [T] of the token copies ->
    ``(order, sorted_ids, counts, seg_starts, dest, rows)``: the copies
    sorted by expert (stable, as ``jnp.argsort``), their expert ids, the
    per-expert counts [E] int32, the block-aligned segment starts [E], the
    padded row of each sorted copy [T], and the static padded row count
    ``align(T) + E * block_rows`` (every segment's slack).  Counts come from
    ``scatter_add_`` and ``rows`` from the shapes: no host sync."""
    dev = expert_ids.device
    ids = expert_ids.reshape(-1).to(torch.int32)
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order].long()
    counts = torch.zeros(num_experts, dtype=torch.int32, device=dev)
    counts.scatter_add_(0, ids.long(), torch.ones_like(ids))
    seg_st = segment_starts(counts, block_rows)
    run_st = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    T = ids.shape[0]
    pos = torch.arange(T, dtype=torch.int32, device=dev) - run_st[sorted_ids]
    dest = (seg_st[sorted_ids] + pos).long()
    rows = int(align_rows(T, block_rows) + num_experts * block_rows)
    return order, sorted_ids, counts, seg_st, dest, rows


def _windows(seg_starts, seg_lens, block_rows, rows):
    """Each segment's row window ``[lo, hi)`` as the TPU walks it: whole
    blocks from the start's block, ``align(len)`` rows, cut at ``rows``."""
    out = []
    for st, n in zip(seg_starts.tolist(), seg_lens.tolist()):
        lo = st // block_rows * block_rows
        out.append((lo, min(lo + align_rows(max(n, 0), block_rows), rows)))
    return out


# ------------------------------------------------------------- plain versions

def grouped_matmul_plain(x, w, seg_starts, seg_lens, seg_wids,
                         block_rows: int = 128, w_scale=None,
                         transpose_w: bool = False):
    """Plain PyTorch ``grouped_matmul_raw``: per segment, the fp32 product
    of x's window and ``w[wid]`` (widened to x's dtype first when int8),
    times ``w_scale[wid]`` in fp32, cast to x's dtype; other rows 0."""
    R = x.shape[0]
    N = w.shape[1] if transpose_w else w.shape[2]
    y = torch.zeros((R, N), dtype=x.dtype, device=x.device)
    for (lo, hi), wid in zip(_windows(seg_starts, seg_lens, block_rows, R),
                             seg_wids.tolist()):
        if hi <= lo:
            continue
        wb = w[wid].T if transpose_w else w[wid]
        acc = x[lo:hi].float() @ wb.to(x.dtype).float()
        if w_scale is not None:
            acc = acc * w_scale[wid].float()
        y[lo:hi] = acc.to(x.dtype)
    return y


def grouped_outer_plain(x, dy, seg_starts, seg_lens, block_rows: int = 128):
    """Plain PyTorch ``grouped_outer_raw``: ``out[s] = x[win_s]ᵀ @
    dy[win_s]`` in fp32, exact zeros for an empty segment."""
    S, K, N = seg_starts.shape[0], x.shape[1], dy.shape[1]
    out = torch.zeros((S, K, N), dtype=torch.float32, device=x.device)
    for s, (lo, hi) in enumerate(_windows(seg_starts, seg_lens, block_rows,
                                          x.shape[0])):
        if hi > lo:
            out[s] = x[lo:hi].float().T @ dy[lo:hi].float()
    return out


# ------------------------------------------------------------------ wrappers

def _device(name, *tensors):
    dev = tensors[0].device
    for t in tensors[1:]:
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev.type


def _check_segments(name, seg_starts, *more):
    S = seg_starts.shape[0]
    for t in (seg_starts, *more):
        if t.dim() != 1 or t.shape[0] != S:
            raise ValueError(f"{name}: segment arrays must be [S] alike")
        if t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{name}: segment arrays must be integer")
    return S


def _i32(t):
    return t.to(torch.int32).contiguous()


def _stream():
    return torch.cuda.current_stream().cuda_stream


def grouped_matmul_raw(x, w, seg_starts, seg_lens, seg_wids,
                       block_rows: int = 128, w_scale=None,
                       transpose_w: bool = False):
    """Ragged grouped matmul (mirror of ``grouped_matmul_raw``):
    ``y[win_s] = x[win_s] @ w[wid_s]`` for every segment in one launch.
    x [R, K] fp32 or bf16 (R % block_rows == 0); w [E, K, N] in x's dtype,
    or int8 with ``w_scale`` [E, N] (its per-out-channel dequant scales,
    applied to the fp32 accumulator); ``transpose_w``: w is [E, N, K] and
    each segment multiplies by ``w[wid]ᵀ``.  seg_starts/seg_lens/seg_wids
    [S].  Returns y [R, N] in x's dtype, rows no segment covers 0."""
    name = "grouped_matmul_raw"
    dev = _device(name, x, w, seg_starts, seg_lens, seg_wids, w_scale)
    S = _check_segments(name, seg_starts, seg_lens, seg_wids)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: x dtype {x.dtype} (float32 or bfloat16)")
    if w.dtype not in (x.dtype, torch.int8):
        raise TypeError(f"{name}: w dtype {w.dtype} with x {x.dtype}")
    if w.dtype == torch.int8 and w_scale is None:
        raise ValueError(f"{name}: an int8 bank needs w_scale")
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"{name}: x [R, K], w [E, K, N]")
    R, K = x.shape
    E = w.shape[0]
    Kw, N = (w.shape[2], w.shape[1]) if transpose_w else (w.shape[1],
                                                          w.shape[2])
    if Kw != K:
        raise ValueError(f"x inner dim {K} != weight inner dim {Kw}")
    bm = int(block_rows)
    if R % bm:
        raise ValueError(f"rows {R} not a multiple of block_rows {bm}")
    if w_scale is not None and tuple(w_scale.shape) != (E, N):
        raise ValueError(f"{name}: w_scale {tuple(w_scale.shape)} != "
                         f"{(E, N)}")
    if dev == "cuda":
        _check_gmm_cuda(name, x, w, K, N, R, S, transpose_w)
    return _GMM(x, w, seg_starts, seg_lens, seg_wids, bm, w_scale,
                bool(transpose_w))


def _check_gmm_cuda(name, x, w, K, N, R, S, transpose_w):
    """The card's envelope, from shapes alone (checked before the
    operator, so a capture meets it too)."""
    if transpose_w and w.dtype == torch.int8:
        raise ValueError(f"{name}: the transposed launch takes float banks")
    route = gmm_route(x.dtype, w.dtype == torch.int8)
    if K % 8 or N % 8:
        raise ValueError(f"{name}: K {K} and N {N} must be multiples of 8 "
                         f"on the card")
    if route == "int8_wgmma" and N % 16:
        raise ValueError(f"{name}: N {N} of an int8 bank must be a multiple "
                         f"of 16 on the card (its rows are a TMA stride)")
    for t, what in ((x, "x"), (w, "w")):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if route == "int8_wgmma" and R and S and N and K:
        if gmm_int8_plan(R, K, N, S)[3] >= 2 ** 31:
            raise ValueError(f"{name}: {R} rows over {S} segments exceed "
                             f"the grid")
    elif route != "wgmma" and -(-R // _KERNEL_ROWS) + S > _MAX_GRID_Y:
        raise ValueError(f"{name}: {R} rows over {S} segments exceed the "
                         f"grid")


def _gmm_cpu(x, w, seg_starts, seg_lens, seg_wids, block_rows, w_scale,
             transpose_w):
    return grouped_matmul_plain(x, w, seg_starts, seg_lens, seg_wids,
                                block_rows, w_scale, transpose_w)


def _gmm_splits(x, w, seg_starts, transpose_w):
    R, K = x.shape
    N = w.shape[1] if transpose_w else w.shape[2]
    S = seg_starts.shape[0]
    if gmm_route(x.dtype, w.dtype == torch.int8) != "int8_wgmma" \
            or not (R and S and N and K):
        return 0, 1, False
    tile, splits, rows_inner, _ = gmm_int8_plan(R, K, N, S)
    return tile, splits, rows_inner


def _gmm_cuda(x, w, seg_starts, seg_lens, seg_wids, block_rows, w_scale,
              transpose_w):
    R, K = x.shape
    E = w.shape[0]
    N = w.shape[1] if transpose_w else w.shape[2]
    S = seg_starts.shape[0]
    route = gmm_route(x.dtype, w.dtype == torch.int8)
    y = torch.zeros((R, N), dtype=x.dtype, device=x.device)
    if R == 0 or S == 0 or N == 0 or K == 0:
        return y
    tile, splits, rows_inner = _gmm_splits(x, w, seg_starts, transpose_w)
    scale = (None if w_scale is None
             else w_scale.to(torch.float32).contiguous())
    starts, lens, wids = _i32(seg_starts), _i32(seg_lens), _i32(seg_wids)
    # the K splits' fp32 sums, added in split order by the kernel's reducer
    part = (torch.empty((splits, R, N), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    lib = _build.library()
    rc = lib.pt_grouped_matmul(
        x.data_ptr(), w.data_ptr(), None if scale is None else
        scale.data_ptr(), y.data_ptr(), starts.data_ptr(), lens.data_ptr(),
        wids.data_ptr(), None if part is None else part.data_ptr(), R, K, N,
        S, E, block_rows, _DTYPE_CODES[x.dtype], int(w.dtype == torch.int8),
        int(bool(transpose_w)), _ROUTE_CODES[route], tile, splits,
        int(rows_inner), _stream())
    _build.check(lib, rc, "grouped_matmul_raw")
    key = ("grouped_matmul_t" if transpose_w else "grouped_matmul_int8"
           if w.dtype == torch.int8 else "grouped_matmul")
    LAUNCHES[key] += 1
    return y


def _gmm_fake(x, w, seg_starts, seg_lens, seg_wids, block_rows, w_scale,
              transpose_w):
    N = w.shape[1] if transpose_w else w.shape[2]
    return x.new_empty((x.shape[0], N))


def _index_bytes(*ts) -> int:
    """The int32 copies ``_i32`` makes of segment arrays not int32 yet."""
    return sum(4 * t.numel() for t in ts if t.dtype != torch.int32)


def _gmm_scratch(x, w, seg_starts, seg_lens, seg_wids, block_rows, w_scale,
                 transpose_w):
    R = x.shape[0]
    N = w.shape[1] if transpose_w else w.shape[2]
    _, splits, _ = _gmm_splits(x, w, seg_starts, transpose_w)
    n = _index_bytes(seg_starts, seg_lens, seg_wids)
    if splits > 1:
        n += 4 * splits * R * N
    if w_scale is not None and w_scale.dtype != torch.float32:
        n += 4 * w_scale.numel()
    return n


_GMM = _registry.define(
    "grouped_matmul", "(Tensor x, Tensor w, Tensor seg_starts, "
    "Tensor seg_lens, Tensor seg_wids, int block_rows, Tensor? w_scale, "
    "bool transpose_w) -> Tensor", kernel="B7", cpu=_gmm_cpu, cuda=_gmm_cuda,
    fake=_gmm_fake, scratch=_gmm_scratch)


def grouped_outer_raw(x, dy, seg_starts, seg_lens, block_rows: int = 128):
    """Per-segment outer product ``out[s] = x[win_s]ᵀ @ dy[win_s]`` (mirror
    of ``grouped_outer_raw``), the dW half of the backward.  x [R, K]; dy
    [R, N] in x's dtype; returns [S, K, N] fp32, exact zeros for an empty
    segment.  Deterministic: one CTA owns each output tile."""
    name = "grouped_outer_raw"
    dev = _device(name, x, dy, seg_starts, seg_lens)
    _check_segments(name, seg_starts, seg_lens)
    if x.dtype not in _DTYPE_CODES or dy.dtype != x.dtype:
        raise TypeError(f"{name}: x {x.dtype}, dy {dy.dtype} (one of "
                        f"float32, bfloat16)")
    if x.dim() != 2 or dy.dim() != 2:
        raise ValueError(f"{name}: x [R, K], dy [R, N]")
    R, K = x.shape
    Rd, N = dy.shape
    if Rd != R:
        raise ValueError(f"x rows {R} != dy rows {Rd}")
    bm = int(block_rows)
    if R % bm:
        raise ValueError(f"rows {R} not a multiple of block_rows {bm}")
    if dev == "cuda":
        if K % 8 or N % 8:
            raise ValueError(f"{name}: K {K} and N {N} must be multiples of "
                             f"8 on the card")
        for t, what in ((x, "x"), (dy, "dy")):
            if not t.is_contiguous():
                raise ValueError(f"{name}: {what} must be contiguous")
    return _OUTER(x, dy, seg_starts, seg_lens, bm)


def _outer_cpu(x, dy, seg_starts, seg_lens, block_rows):
    return grouped_outer_plain(x, dy, seg_starts, seg_lens, block_rows)


def _outer_cuda(x, dy, seg_starts, seg_lens, block_rows):
    R, K = x.shape
    N = dy.shape[1]
    S = seg_starts.shape[0]
    out = torch.empty((S, K, N), dtype=torch.float32, device=x.device)
    if S == 0 or K == 0 or N == 0:
        return out
    starts, lens = _i32(seg_starts), _i32(seg_lens)
    lib = _build.library()
    rc = lib.pt_grouped_outer(
        x.data_ptr(), dy.data_ptr(), out.data_ptr(), starts.data_ptr(),
        lens.data_ptr(), R, K, N, S, block_rows, _DTYPE_CODES[x.dtype],
        _stream())
    _build.check(lib, rc, "grouped_outer_raw")
    LAUNCHES["grouped_outer"] += 1
    return out


def _outer_fake(x, dy, seg_starts, seg_lens, block_rows):
    return x.new_empty((seg_starts.shape[0], x.shape[1], dy.shape[1]),
                       dtype=torch.float32)


_OUTER = _registry.define(
    "grouped_outer", "(Tensor x, Tensor dy, Tensor seg_starts, "
    "Tensor seg_lens, int block_rows) -> Tensor", kernel="B8",
    cpu=_outer_cpu, cuda=_outer_cuda, fake=_outer_fake,
    scratch=lambda x, dy, starts, lens, bm: _index_bytes(starts, lens))


class _GroupedMatmul(torch.autograd.Function):
    """Mirror of ``_make_grouped_matmul``'s custom_vjp: forward B7; dx B7
    on the transposed slices, only when x needs a gradient (the JAX
    backward always computes it, and ``jit`` drops it when it is unused:
    the gradients returned are the same); dW B8 then an fp32
    ``index_add_`` over ``seg_wids`` cast to ``w.dtype``."""

    @staticmethod
    def forward(ctx, x, w, seg_starts, seg_lens, seg_wids, block_rows):
        ctx.block_rows = block_rows
        ctx.save_for_backward(x, w, seg_starts, seg_lens, seg_wids)
        return grouped_matmul_raw(x, w, seg_starts, seg_lens, seg_wids,
                                  block_rows)

    @staticmethod
    def backward(ctx, dy):
        x, w, seg_starts, seg_lens, seg_wids = ctx.saved_tensors
        bm = ctx.block_rows
        dy = dy.contiguous()
        dx = None
        if ctx.needs_input_grad[0]:
            dx = grouped_matmul_raw(dy, w, seg_starts, seg_lens, seg_wids, bm,
                                    transpose_w=True).to(x.dtype)
        dwseg = grouped_outer_raw(x, dy, seg_starts, seg_lens, bm)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dw.index_add_(0, seg_wids.long(), dwseg)
        return dx, dw.to(w.dtype), None, None, None, None


def grouped_matmul(x, w, seg_starts, seg_lens, seg_wids,
                   block_rows: int = 128):
    """Differentiable grouped matmul over float weight banks (training):
    forward ``grouped_matmul_raw``; backward the transposed launch for dx
    (when x needs a gradient) and per-segment outer products added over
    ``seg_wids`` for dW."""
    return _GroupedMatmul.apply(x, w, seg_starts, seg_lens, seg_wids,
                                int(block_rows))
