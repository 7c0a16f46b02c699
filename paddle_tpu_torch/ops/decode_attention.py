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

Each launcher is a registered operator (``ops/_registry.py``:
``flash_decode``, ``paged_decode``, ``ragged_paged_decode``): on a CUDA
tensor its implementation runs the hand-written kernels
(``csrc/decode_attention.cu``) and counts the launch in ``LAUNCHES``; on a
CPU tensor it runs the ``*_plain`` PyTorch version beside it; on fake
tensors it gives the output shape and runs nothing.  There is no other
route: a tensor on any other device raises.

All three split each row's visible length over CTAs (a split kernel per
chunk of C tokens, then a combine kernel): ``decode_split_plan`` picks C
from static shapes, ``paged_split_plan`` the paged launchers' C (a whole
number of pages); ``split_merge_plain`` and ``paged_split_merge_plain`` are
the plain twins of the kernels' arithmetic.  ``block_k`` keeps its TPU name
and meaning (tokens per step) and caps the dense C.  ``pages_per_step``
keeps its TPU name, heuristic and argument check; the walk covers
ceil(max_pages / pp) * pp logical pages, as the TPU grid does.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch

from . import _build, _registry

# masking constant of paddle_tpu/ops/pallas/flash_attention.py (NEG_INF):
# finite, so an all-masked row keeps m = NEG_INF and outputs 0
NEG_INF = -1e30

# pages-per-step heuristic of the TPU launcher (its VMEM budget and target
# window keep their values, so both packages pick the same pp)
_PAGED_VMEM_BUDGET = 8 * 1024 * 1024
_PAGED_TARGET_WINDOW = 512

# the split kernels (decode_split_kernel, paged_split_kernel): threads per
# CTA, which is also the largest chunk (one key per thread in the score
# pass), the smallest chunk, and the CTAs per SM their plan aims at over
# the H100's 132
_SPLIT_THREADS = 128
_MIN_CHUNK = 16
_SPLIT_TARGET_CTAS = 2 * 132
#: the largest page the paged launchers take on the card (a chunk is a
#: whole number of pages of at most _SPLIT_THREADS tokens)
MAX_PAGE_ON_CARD = _SPLIT_THREADS

SUPPORTED_HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

#: kernel launches per launcher, counted where each wrapper launches
LAUNCHES: Dict[str, int] = {"flash_decode": 0, "paged_decode": 0,
                            "ragged_paged_decode": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=256)
def decode_split_plan(b: int, kvh: int, t_max: int,
                      block_k: int = 512) -> Tuple[int, int]:
    """(C, splits) of the dense split kernel, from static shapes only (the
    lengths stay on the device).  C is a power of two, at most ``block_k``
    (tokens per step) and _SPLIT_THREADS: the largest such chunk of at
    least _MIN_CHUNK tokens whose grid at full length, b * kvh *
    ceil(t_max / C) CTAs, still puts about _SPLIT_TARGET_CTAS CTAs on the
    card (two per SM), else the smallest.  splits = ceil(t_max / C)."""
    if block_k < 1:
        raise ValueError(f"flash_decode: block_k {block_k} < 1")
    cap = min(int(block_k), _SPLIT_THREADS)
    chunk = 1 << (min(cap, _MIN_CHUNK).bit_length() - 1)
    while chunk * 2 <= cap and \
            b * kvh * -(-t_max // (chunk * 2)) >= _SPLIT_TARGET_CTAS:
        chunk *= 2
    return chunk, -(-t_max // chunk)


@functools.lru_cache(maxsize=256)
def paged_split_plan(rows: int, kvh: int, page: int, max_pages: int,
                     pp: int) -> Tuple[int, int]:
    """(C, splits) of the paged split kernel, from static shapes only: the
    walk covers ceil(max_pages / pp) * pp pages of ``page`` tokens; C is
    ``decode_split_plan``'s chunk over that length, cut down to a whole
    number of pages (at least one page, so ``page`` <= _SPLIT_THREADS);
    splits = ceil(walked tokens / C)."""
    if not 1 <= page <= _SPLIT_THREADS:
        raise ValueError(f"paged decode: page {page} outside [1, "
                         f"{_SPLIT_THREADS}] on the card")
    t_walk = -(-max_pages // pp) * pp * page
    chunk, _ = decode_split_plan(rows, kvh, t_walk)
    chunk = max(page, chunk // page * page)
    return chunk, -(-t_walk // chunk)


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


def split_merge_plain(q, k_cache, v_cache, seq_lens, scale=None,
                      chunk: int = 128):
    """``flash_decode`` as its two kernels compute it, in plain PyTorch:
    each chunk of ``chunk`` visible tokens gives fp32 partials (m_c = the
    chunk's max score, l_c = the sum of the unrounded p = exp(s - m_c), acc_c
    = p rounded to v's dtype (q's for int8 V) times V), and the combine
    merges a row's ceil(len / chunk) partials in split order: M = max m_c,
    l = sum l_c e^(m_c - M), o = sum acc_c e^(m_c - M) / l.  Keys past the
    length score NEG_INF and their V rows are zeroed, so garbage there
    never enters a sum; a row that sees no key outputs 0."""
    b, h, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    kvh, t_max = k_cache.shape[1], k_cache.shape[2]
    rep = h // kvh
    pdt = q.dtype if v_cache.dtype == torch.int8 else v_cache.dtype
    lens = seq_lens.to(torch.long).clamp(0, t_max)
    qg = q.reshape(b, kvh, rep, d).float()
    parts = []                                 # (live, m_c, l_c, acc_c)
    for c0 in range(0, t_max, chunk):
        vis = (c0 + torch.arange(min(chunk, t_max - c0), device=q.device)
               [None, :] < lens[:, None])                      # [b, n]
        kc = k_cache[:, :, c0:c0 + chunk].to(q.dtype).float()
        vc = v_cache[:, :, c0:c0 + chunk].to(q.dtype)
        s = torch.einsum("bgqd,bgsd->bgqs", qg, kc) * scale
        s = torch.where(vis[:, None, None, :], s, torch.full_like(s, NEG_INF))
        m_c = s.amax(-1, keepdim=True)
        p = torch.exp(s - m_c)
        vz = torch.where(vis[:, None, :, None], vc, torch.zeros_like(vc))
        parts.append(((c0 < lens)[:, None, None, None], m_c,
                      p.sum(-1, keepdim=True),
                      torch.einsum("bgqs,bgsd->bgqd", p.to(pdt).float(),
                                   vz.float())))
    # the combine: over the chunks that hold a visible key, in split order
    mx = torch.full((b, kvh, rep, 1), NEG_INF, device=q.device)
    for live, m_c, _, _ in parts:
        mx = torch.where(live, torch.maximum(mx, m_c), mx)
    l = torch.zeros((b, kvh, rep, 1), device=q.device)
    acc = torch.zeros((b, kvh, rep, d), device=q.device)
    for live, m_c, l_c, acc_c in parts:
        w = torch.exp(m_c - mx)
        l = torch.where(live, l + l_c * w, l)
        acc = torch.where(live, acc + acc_c * w, acc)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.where(mx > NEG_INF * 0.5, acc / l, torch.zeros_like(acc))
    return out.to(q.dtype).reshape(b, h, d)


def _gather_pages(pool, block_tables, slots, pages):
    """Each row's first ``pages`` logical pages of ``pool`` [n_pages, kvh,
    page, d] as a dense [rows, kvh, pages * page, d] cache, as the kernels
    walk them: the logical page clamped to the table's width, -1 entries
    to page 0."""
    rows, max_pages = slots.shape[0], block_tables.shape[1]
    li = torch.arange(pages, device=pool.device).clamp(max=max_pages - 1)
    phys = block_tables.to(torch.long)[slots.to(torch.long)[:, None],
                                       li[None, :]].clamp(min=0)
    x = pool[phys]                                # [rows, pages, kvh, page, d]
    return x.permute(0, 2, 1, 3, 4).reshape(rows, pool.shape[1],
                                            pages * pool.shape[2],
                                            pool.shape[3])


def _walk_lens(lens, row_slot, page, max_pages, pp):
    """(lengths, table rows) of the paged launchers' rows: padding rows
    (slot < 0) see nothing and read table row 0; lengths clamp to the
    ceil(max_pages / pp) * pp walked pages."""
    if row_slot is None:
        slots = torch.arange(lens.shape[0], device=lens.device)
    else:
        lens = torch.where(row_slot < 0, torch.zeros_like(lens), lens)
        slots = row_slot.clamp(min=0)
    walked = -(-max_pages // pp) * pp
    return lens.to(torch.long).clamp(0, walked * page), slots


def _paged_rows_plain(q, key_cache, value_cache, lens, row_slot,
                      block_tables, scale, pp):
    """The rows' visible pages gathered (``_gather_pages``), then the
    shared attention math."""
    page = key_cache.shape[2]
    lens, slots = _walk_lens(lens, row_slot, page, block_tables.shape[1], pp)
    need = int(-(-int(lens.max()) // page)) if q.shape[0] else 0
    if need == 0:
        return torch.zeros_like(q)
    return _attend_plain(q, _gather_pages(key_cache, block_tables, slots,
                                          need),
                         _gather_pages(value_cache, block_tables, slots,
                                       need), lens, scale)


def paged_split_merge_plain(q, key_cache, value_cache, lens, block_tables,
                            row_slot=None, scale=None, pages_per_step="auto",
                            chunk=None):
    """``paged_decode`` (``row_slot`` None) or ``ragged_paged_decode`` as
    the paged split and combine kernels compute it, in plain PyTorch: each
    row's walked pages gathered (``_gather_pages``), then
    ``split_merge_plain`` over chunks of ``chunk`` tokens (default
    ``paged_split_plan``'s)."""
    T, h, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    kvh, page = key_cache.shape[1], key_cache.shape[2]
    max_pages = block_tables.shape[1]
    pp = _resolve_pp(pages_per_step, key_cache, max_pages)
    if chunk is None:
        chunk, _ = paged_split_plan(T, kvh, page, max_pages, pp)
    lens, slots = _walk_lens(lens, row_slot, page, max_pages, pp)
    walked = -(-max_pages // pp) * pp
    return split_merge_plain(
        q, _gather_pages(key_cache, block_tables, slots, walked),
        _gather_pages(value_cache, block_tables, slots, walked), lens, scale,
        chunk)


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
    return _paged_rows_plain(q, key_cache, value_cache, seq_lens, None,
                             block_tables, scale, pp)


def ragged_paged_decode_plain(q, key_cache, value_cache, row_lens, row_slot,
                              block_tables, scale=None,
                              pages_per_step="auto"):
    """Plain PyTorch ``ragged_paged_decode``: padding rows (slot < 0) read
    table row 0 with visibility 0, so they output 0."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    pp = _resolve_pp(pages_per_step, key_cache, block_tables.shape[1])
    return _paged_rows_plain(q, key_cache, value_cache, row_lens, row_slot,
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


def _partials(rows, h, d, splits, device):
    """One fp32 scratch of the split kernels' partials and the addresses
    of its parts: the chunks' m and l [rows, h, splits], acc [.., d].  The
    caller holds the scratch until its kernels are enqueued."""
    n = rows * h * splits
    part = torch.empty(n * (d + 2), dtype=torch.float32, device=device)
    base = part.data_ptr()
    return part, base, base + 4 * n, base + 8 * n


def flash_decode(q, k_cache, v_cache, seq_lens, scale=None,
                 block_k: int = 512):
    """One decode step of attention against a dense cache (mirrors
    ``flash_decode_raw``).  q [b, h, d]; k/v [b, kvh, t_max, d] (kvh
    divides h, heads group-major); seq_lens [b] = visible cache rows (the
    new token's K/V already written).  Returns [b, h, d] in q's dtype.
    The operator ``flash_decode``; on the card: the split kernel over
    chunks of C tokens (``decode_split_plan``; ``block_k`` caps C), its fp32
    partials in a scratch allocated there, then the combine kernel; K and V
    must be 16-byte aligned (their chunks are copied in bulk)."""
    _check_inputs(q, k_cache, v_cache, "flash_decode")
    _on_device("flash_decode", q, k_cache, v_cache, seq_lens)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[2])
    return _FLASH_DECODE(q, k_cache, v_cache, seq_lens, float(scale),
                         int(block_k))


def _flash_decode_cpu(q, k_cache, v_cache, seq_lens, scale, block_k):
    return flash_decode_plain(q, k_cache, v_cache, seq_lens, scale)


def _flash_decode_cuda(q, k_cache, v_cache, seq_lens, scale, block_k):
    b, h, d = q.shape
    kvh, t_max = k_cache.shape[1], k_cache.shape[2]
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("flash_decode: K and V must be 16-byte aligned")
    out = torch.empty_like(q)
    if b == 0 or t_max == 0:          # no key to see: every row is 0
        return out.zero_()
    chunk, splits = decode_split_plan(b, kvh, t_max, block_k)
    part, part_m, part_l, part_acc = _partials(b, h, d, splits, q.device)
    lens = _i32(seq_lens)
    lib = _build.library()
    rc = lib.pt_flash_decode(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        lens.data_ptr(), part_m, part_l,
        part_acc, b, h, kvh, t_max, d, chunk, float(scale),
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_cache.dtype], _stream())
    _build.check(lib, rc, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return out


def _decode_fake(q, *rest):
    return torch.empty_like(q)


def _i32_bytes(*ts) -> int:
    """The int32 copies ``_i32`` makes of index tensors not int32 yet."""
    return sum(4 * t.numel() for t in ts
               if t is not None and t.dtype != torch.int32)


def _flash_decode_scratch(q, k_cache, v_cache, seq_lens, scale, block_k):
    b, h, d = q.shape
    _, splits = decode_split_plan(b, k_cache.shape[1], k_cache.shape[2],
                                  block_k)
    return 4 * b * h * splits * (d + 2) + _i32_bytes(seq_lens)


_FLASH_DECODE = _registry.define(
    "flash_decode", "(Tensor q, Tensor k_cache, Tensor v_cache, "
    "Tensor seq_lens, float scale, int block_k) -> Tensor", kernel="B4",
    cpu=_flash_decode_cpu, cuda=_flash_decode_cuda, fake=_decode_fake,
    scratch=_flash_decode_scratch)


def _paged_kernel(name, q, key_cache, value_cache, lens, row_slot,
                  block_tables, scale, pp):
    """The card side of both paged operators (``row_slot`` None: one row
    per table row): the paged split kernel over chunks of whole pages
    (``paged_split_plan``), then the combine kernel.  The pools' pages are
    bulk-copied, so both pools must be 16-byte aligned and one page of one
    kv head a multiple of 16 bytes."""
    rows, h, d = q.shape
    kvh, page = key_cache.shape[1], key_cache.shape[2]
    max_pages = block_tables.shape[1]
    out = torch.empty_like(q)
    if rows == 0:
        return out
    if key_cache.data_ptr() % 16 or value_cache.data_ptr() % 16:
        raise ValueError(f"{name}: K and V pools must be 16-byte aligned")
    if page * d * key_cache.element_size() % 16:
        raise ValueError(f"{name}: a page of {page} x {d} "
                         f"{key_cache.dtype} is not a multiple of 16 bytes")
    if rows > 65535 or max_pages == 0:
        raise ValueError(f"{name}: {rows} rows, {max_pages} table columns "
                         f"on the card")
    chunk, splits = paged_split_plan(rows, kvh, page, max_pages, pp)
    part, part_m, part_l, part_acc = _partials(rows, h, d, splits,
                                               q.device)
    lens, tables = _i32(lens), _i32(block_tables)
    slots = None if row_slot is None else _i32(row_slot)
    lib = _build.library()
    rc = lib.pt_paged_decode(
        q.data_ptr(), key_cache.data_ptr(), value_cache.data_ptr(),
        out.data_ptr(), lens.data_ptr(),
        None if slots is None else slots.data_ptr(), tables.data_ptr(),
        part_m, part_l, part_acc, rows, h,
        kvh, page, d, max_pages, pp, chunk, float(scale),
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[key_cache.dtype], _stream())
    _build.check(lib, rc, name)
    LAUNCHES[name] += 1
    return out


def _paged_scratch(q, key_cache, lens, row_slot, block_tables, pp):
    rows, h, d = q.shape
    if rows == 0 or block_tables.shape[1] == 0:
        return 0
    _, splits = paged_split_plan(rows, key_cache.shape[1], key_cache.shape[2],
                                 block_tables.shape[1], pp)
    return (4 * rows * h * splits * (d + 2)
            + _i32_bytes(lens, row_slot, block_tables))


def paged_decode(q, key_cache, value_cache, seq_lens, block_tables,
                 scale=None, pages_per_step="auto"):
    """Paged (vLLM-layout) decode (mirrors ``paged_decode_raw``).  q
    [b, h, d]; pools [n_pages, kvh, page, d]; seq_lens [b] (visible
    tokens, the current one included); block_tables [b, max_pages]
    physical page ids, -1 for unused entries.  Only the visible pages are
    read; lengths past the table (the lookahead chunk of a finished
    sequence) re-read the last page and stay finite.  The operator
    ``paged_decode``; on the card the paged split and combine kernels
    (``_paged_kernel``)."""
    _check_inputs(q, key_cache, value_cache, "paged_decode")
    _on_device("paged_decode", q, key_cache, value_cache, seq_lens,
               block_tables)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    pp = _resolve_pp(pages_per_step, key_cache, block_tables.shape[1])
    return _PAGED(q, key_cache, value_cache, seq_lens, block_tables,
                  float(scale), pp)


def _paged_cpu(q, key_cache, value_cache, seq_lens, block_tables, scale, pp):
    return paged_decode_plain(q, key_cache, value_cache, seq_lens,
                              block_tables, scale, pp)


def _paged_cuda(q, key_cache, value_cache, seq_lens, block_tables, scale,
                pp):
    return _paged_kernel("paged_decode", q, key_cache, value_cache, seq_lens,
                         None, block_tables, scale, pp)


_PAGED = _registry.define(
    "paged_decode", "(Tensor q, Tensor key_cache, Tensor value_cache, "
    "Tensor seq_lens, Tensor block_tables, float scale, int pp) -> Tensor",
    kernel="B3", cpu=_paged_cpu, cuda=_paged_cuda, fake=_decode_fake,
    scratch=lambda q, kc, vc, lens, tables, scale, pp: _paged_scratch(
        q, kc, lens, None, tables, pp))


def ragged_paged_decode(q, key_cache, value_cache, row_lens, row_slot,
                        block_tables, scale=None, pages_per_step="auto"):
    """Ragged paged attention over packed rows of many sequences (mirrors
    ``ragged_paged_decode_raw``): decode slots give one row each, prefill
    chunks one row per prompt token.  Row r attends positions
    < row_lens[r] of sequence row_slot[r] (its K/V already scattered into
    the pages); rows with row_slot < 0 are padding and output 0.  The
    operator ``ragged_paged_decode``; on the card ``paged_decode``'s
    kernels, each row split on its own."""
    _check_inputs(q, key_cache, value_cache, "ragged_paged_decode")
    _on_device("ragged_paged_decode", q, key_cache, value_cache,
               row_lens, row_slot, block_tables)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    pp = _resolve_pp(pages_per_step, key_cache, block_tables.shape[1])
    return _RAGGED(q, key_cache, value_cache, row_lens, row_slot,
                   block_tables, float(scale), pp)


def _ragged_cpu(q, key_cache, value_cache, row_lens, row_slot, block_tables,
                scale, pp):
    return ragged_paged_decode_plain(q, key_cache, value_cache, row_lens,
                                     row_slot, block_tables, scale, pp)


def _ragged_cuda(q, key_cache, value_cache, row_lens, row_slot,
                 block_tables, scale, pp):
    return _paged_kernel("ragged_paged_decode", q, key_cache, value_cache,
                         row_lens, row_slot, block_tables, scale, pp)


_RAGGED = _registry.define(
    "ragged_paged_decode", "(Tensor q, Tensor key_cache, "
    "Tensor value_cache, Tensor row_lens, Tensor row_slot, "
    "Tensor block_tables, float scale, int pp) -> Tensor", kernel="B3'",
    cpu=_ragged_cpu, cuda=_ragged_cuda, fake=_decode_fake,
    scratch=lambda q, kc, vc, lens, slot, tables, scale, pp: _paged_scratch(
        q, kc, lens, slot, tables, pp))
