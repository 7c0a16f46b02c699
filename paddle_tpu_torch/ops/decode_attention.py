"""Decode attention: one-token queries against a dense or a paged KV cache.

Port of ``paddle_tpu/ops/pallas/decode_attention.py``.  Three launchers
keep the signatures, layouts and semantics of the TPU ones:

- ``flash_decode`` mirrors ``flash_decode_raw`` (TPU body
  ``_decode_kernel``): q [b, h, d], k/v [b, kvh, t_max, d], seq_lens [b];
- ``paged_decode`` mirrors ``paged_decode_raw`` (``_paged_decode_kernel``
  with nsp=2): q [b, h, d], pools [n_pages, kvh, page, d], seq_lens [b],
  block_tables [b, max_pages] (-1 = unused);
- ``ragged_paged_decode`` mirrors ``ragged_paged_decode_raw`` (the same
  body with nsp=3): packed rows q [T, h, d], row_lens [T] (causal
  visibility), row_slot [T] (< 0 = padding, output 0), block_tables
  [slots, max_pages].

On a CUDA tensor each launcher runs its hand-written kernel
(``csrc/decode_attention.cu``) and counts the launch in ``LAUNCHES``;
on a CPU tensor it runs the ``*_plain`` PyTorch version beside it.  There
is no other route: a tensor on any other device raises.

``pages_per_step`` keeps its TPU name and heuristic; on the GPU it is the
number of pages a CTA stages per loop trip.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from . import _build

# masking constant of paddle_tpu/ops/pallas/flash_attention.py (NEG_INF):
# finite, so an all-masked row keeps m = NEG_INF and outputs 0
NEG_INF = -1e30

# pages-per-step heuristic of the TPU launcher (its VMEM budget and target
# window keep their values, so both packages pick the same pp)
_PAGED_VMEM_BUDGET = 8 * 1024 * 1024
_PAGED_TARGET_WINDOW = 512

# shared memory a block may use on the H100, and the warps per CTA of the
# kernel (kWarps in csrc/decode_attention.cu), which size its per-warp sums
_SMEM_LIMIT = 227 * 1024
_KERNEL_WARPS = 8

SUPPORTED_HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

#: kernel launches per launcher, counted where each wrapper launches
LAUNCHES: Dict[str, int] = {"flash_decode": 0, "paged_decode": 0,
                            "ragged_paged_decode": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def default_pages_per_step(page: int, kvh: int, d: int, max_pages: int,
                           itemsize: int = 2) -> int:
    """Heuristic pp: cover ~_PAGED_TARGET_WINDOW tokens per loop trip,
    capped by the page count and the TPU launcher's double-buffered VMEM
    budget (``decode_attention.py:263``)."""
    pp = max(1, _PAGED_TARGET_WINDOW // max(page, 1))
    pp = min(pp, max_pages)
    blk = 2 * 2 * page * kvh * d * itemsize
    while pp > 1 and pp * blk > _PAGED_VMEM_BUDGET:
        pp //= 2
    return max(1, pp)


# ------------------------------------------------------------- plain versions

def _attend_plain(q, k, v, lens, scale):
    """Shared math of the plain versions.  q [R, h, d]; k/v [R, kvh, S, d]
    already gathered per row; lens [R] visible positions.  Same semantics
    as the kernels: NEG_INF mask, fp32 scores and softmax, p rounded to
    v's dtype (q's for int8 V) before an fp32 PV sum, V past the
    length zeroed, rows that see no key output 0."""
    R, h, d = q.shape
    kvh, S = k.shape[1], k.shape[2]
    rep = h // kvh
    if S == 0:
        return torch.zeros_like(q)
    kw = k.to(q.dtype)
    vw = v.to(q.dtype)
    pdt = q.dtype if v.dtype == torch.int8 else v.dtype
    qg = q.reshape(R, kvh, rep, d).float()
    s = torch.einsum("rgqd,rgsd->rgqs", qg, kw.float()) * scale
    vis = (torch.arange(S, device=q.device)[None, :]
           < lens.to(torch.long)[:, None])                     # [R, S]
    s = torch.where(vis[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    vz = torch.where(vis[:, None, :, None], vw, torch.zeros_like(vw))
    acc = torch.einsum("rgqs,rgsd->rgqd", p.to(pdt).float(), vz.float())
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    valid = m > NEG_INF * 0.5
    out = torch.where(valid, acc / l, torch.zeros_like(acc))
    return out.to(q.dtype).reshape(R, h, d)


def flash_decode_plain(q, k_cache, v_cache, seq_lens, scale=None):
    """Plain PyTorch ``flash_decode``.  Lengths past ``t_max`` clamp to it
    (the dense cache holds no rows beyond)."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    t_max = k_cache.shape[2]
    lens = seq_lens.to(torch.long).clamp(0, t_max)
    s_max = int(lens.max()) if lens.numel() else 0
    return _attend_plain(q, k_cache[:, :, :s_max], v_cache[:, :, :s_max],
                         lens, scale)


def _paged_rows_plain(q, key_cache, value_cache, lens, slots, block_tables,
                      scale, pp):
    """Gather each row's logical pages exactly as the kernel walks them:
    ceil(max_pages / pp) * pp logical pages, each clamped to the row's last
    visible page and to the table width, -1 entries clamped to page 0."""
    T = q.shape[0]
    page = key_cache.shape[2]
    max_pages = block_tables.shape[1]
    walked = -(-max_pages // pp) * pp
    lens = lens.to(torch.long).clamp(min=0)
    lens = torch.minimum(lens, torch.full_like(lens, walked * page))
    need = int(-(-int(lens.max()) // page)) if T else 0        # pages visible
    if need == 0:
        return torch.zeros_like(q)
    last = ((lens + page - 1) // page - 1).clamp(0, max_pages - 1)
    li = torch.arange(need, device=q.device)
    idx = torch.minimum(li[None, :], last[:, None])           # [T, need]
    phys = block_tables.to(torch.long)[slots.to(torch.long)[:, None], idx]
    phys = phys.clamp(min=0)
    kvh, d = key_cache.shape[1], key_cache.shape[3]

    def gather(pool):
        x = pool[phys]                                        # [T, need, kvh, page, d]
        return x.permute(0, 2, 1, 3, 4).reshape(T, kvh, need * page, d)

    return _attend_plain(q, gather(key_cache), gather(value_cache), lens,
                         scale)


def _resolve_pp(pages_per_step, key_cache, max_pages):
    if pages_per_step == "auto":
        pages_per_step = default_pages_per_step(
            key_cache.shape[2], key_cache.shape[1], key_cache.shape[3],
            max_pages, key_cache.element_size())
    return max(1, min(int(pages_per_step), max_pages))


def paged_decode_plain(q, key_cache, value_cache, seq_lens, block_tables,
                       scale=None, pages_per_step="auto"):
    """Plain PyTorch ``paged_decode``."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    pp = _resolve_pp(pages_per_step, key_cache, block_tables.shape[1])
    slots = torch.arange(q.shape[0], device=q.device)
    return _paged_rows_plain(q, key_cache, value_cache, seq_lens, slots,
                             block_tables, scale, pp)


def ragged_paged_decode_plain(q, key_cache, value_cache, row_lens, row_slot,
                              block_tables, scale=None,
                              pages_per_step="auto"):
    """Plain PyTorch ``ragged_paged_decode``: padding rows (slot < 0) read
    table row 0 with visibility 0, so they output 0."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    pp = _resolve_pp(pages_per_step, key_cache, block_tables.shape[1])
    pad = row_slot < 0
    lens = torch.where(pad, torch.zeros_like(row_lens), row_lens)
    slots = row_slot.clamp(min=0)
    return _paged_rows_plain(q, key_cache, value_cache, lens, slots,
                             block_tables, scale, pp)


# ------------------------------------------------------------------ wrappers

def _check_inputs(q, k, v, name):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: q dtype {q.dtype} not supported "
                        f"(float32 or bfloat16)")
    if k.dtype != v.dtype or k.dtype not in (q.dtype, torch.int8,
                                             torch.bfloat16):
        raise TypeError(f"{name}: K/V dtypes {k.dtype}/{v.dtype} not "
                        f"supported with q {q.dtype} (q's dtype, int8 or "
                        f"bf16)")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: bad ranks/shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    h, d = q.shape[1], q.shape[2]
    kvh = k.shape[1]
    if h % kvh != 0:
        raise ValueError(f"q heads {h} not a multiple of kv heads {kvh}")
    if k.shape[3] != d:
        raise ValueError(f"{name}: head dim of q {d} != K/V {k.shape[3]}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not supported "
                         f"({SUPPORTED_HEAD_DIMS})")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")


def _on_device(name, q, *others):
    """'cpu' or 'cuda' for the call; every tensor must be on q's device."""
    for t in others:
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {q.device}")
    return q.device.type


def _i32(x):
    return x.to(torch.int32).contiguous()


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _fit_tile(rep, d, tile, unit):
    """Largest multiple of ``unit`` <= tile for which the CTA's shared
    memory fits the card: fp32 q and per-warp sums, the staged fp32 scores
    [rep, tile], the softmax state and the staged page ids."""
    fixed = 4 * ((1 + _KERNEL_WARPS) * rep * d + 3 * rep + tile // unit + 1)
    cap = (_SMEM_LIMIT - fixed) // (4 * rep)
    if cap < unit:
        raise ValueError(f"a {rep}-head group cannot stage one {unit}-token "
                         f"block in shared memory")
    return max(unit, min(tile, cap) // unit * unit)


def flash_decode(q, k_cache, v_cache, seq_lens, scale=None,
                 block_k: int = 512):
    """One decode step of attention against a dense cache (mirrors
    ``flash_decode_raw``).  q [b, h, d]; k/v [b, kvh, t_max, d] (kvh
    divides h, heads group-major); seq_lens [b] = visible cache rows (the
    new token's K/V already written).  Returns [b, h, d] in q's dtype.
    ``block_k``: tokens a CTA stages per loop trip."""
    _check_inputs(q, k_cache, v_cache, "flash_decode")
    dev = _on_device("flash_decode", q, k_cache, v_cache, seq_lens)
    b, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if dev == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, seq_lens, scale)
    kvh, t_max = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    if b == 0:
        return out
    tile = _fit_tile(h // kvh, d, min(int(block_k), -(-t_max // 32) * 32),
                     32)
    lens = _i32(seq_lens)
    lib = _build.library()
    rc = lib.pt_flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        lens.data_ptr(), b, h, kvh, t_max, d, tile, float(scale),
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_cache.dtype], _stream())
    _build.check(lib, rc, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return out


def _paged_pp(pages_per_step, key_cache, max_pages, rep):
    pp = _resolve_pp(pages_per_step, key_cache, max_pages)
    page, d = key_cache.shape[2], key_cache.shape[3]
    return _fit_tile(rep, d, pp * page, page) // page


def paged_decode(q, key_cache, value_cache, seq_lens, block_tables,
                 scale=None, pages_per_step="auto"):
    """Paged (vLLM-layout) decode (mirrors ``paged_decode_raw``).  q
    [b, h, d]; pools [n_pages, kvh, page, d]; seq_lens [b] (visible
    tokens, the current one included); block_tables [b, max_pages]
    physical page ids, -1 for unused entries.  Only the visible pages are
    read; lengths past the table (the lookahead chunk of a finished
    sequence) re-read the last page and stay finite."""
    _check_inputs(q, key_cache, value_cache, "paged_decode")
    dev = _on_device("paged_decode", q, key_cache, value_cache, seq_lens,
                     block_tables)
    b, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if dev == "cpu":
        return paged_decode_plain(q, key_cache, value_cache, seq_lens,
                                  block_tables, scale, pages_per_step)
    kvh, page = key_cache.shape[1], key_cache.shape[2]
    max_pages = block_tables.shape[1]
    out = torch.empty_like(q)
    if b == 0:
        return out
    pp = _paged_pp(pages_per_step, key_cache, max_pages, h // kvh)
    lens, tables = _i32(seq_lens), _i32(block_tables)
    lib = _build.library()
    rc = lib.pt_paged_decode(
        q.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
        out.data_ptr(), lens.data_ptr(), tables.data_ptr(), b, h, kvh, page,
        d, max_pages, pp, float(scale), _DTYPE_CODES[q.dtype],
        _DTYPE_CODES[key_cache.dtype], _stream())
    _build.check(lib, rc, "paged_decode")
    LAUNCHES["paged_decode"] += 1
    return out


def ragged_paged_decode(q, key_cache, value_cache, row_lens, row_slot,
                        block_tables, scale=None, pages_per_step="auto"):
    """Ragged paged attention over packed rows of many sequences (mirrors
    ``ragged_paged_decode_raw``): decode slots give one row each, prefill
    chunks one row per prompt token.  Row r attends positions
    < row_lens[r] of sequence row_slot[r] (its K/V already scattered into
    the pages); rows with row_slot < 0 are padding and output 0."""
    _check_inputs(q, key_cache, value_cache, "ragged_paged_decode")
    dev = _on_device("ragged_paged_decode", q, key_cache, value_cache,
                     row_lens, row_slot, block_tables)
    T, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if dev == "cpu":
        return ragged_paged_decode_plain(q, key_cache, value_cache, row_lens,
                                         row_slot, block_tables, scale,
                                         pages_per_step)
    kvh, page = key_cache.shape[1], key_cache.shape[2]
    max_pages = block_tables.shape[1]
    out = torch.empty_like(q)
    if T == 0:
        return out
    pp = _paged_pp(pages_per_step, key_cache, max_pages, h // kvh)
    lens, slots, tables = _i32(row_lens), _i32(row_slot), _i32(block_tables)
    lib = _build.library()
    rc = lib.pt_ragged_paged_decode(
        q.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
        out.data_ptr(), lens.data_ptr(), slots.data_ptr(), tables.data_ptr(),
        T, h, kvh, page, d, max_pages, pp, float(scale),
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[key_cache.dtype], _stream())
    _build.check(lib, rc, "ragged_paged_decode")
    LAUNCHES["ragged_paged_decode"] += 1
    return out
