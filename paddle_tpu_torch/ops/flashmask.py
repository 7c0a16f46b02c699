"""FlashMask attention: column-wise row-band masks over the masked kernels.

Port of ``paddle_tpu/ops/pallas/flashmask.py``.  A dense [sq, sk] mask is
written column by column: key column j hides one or two contiguous row
bands.  ``startend_row_indices`` [b, mh, sk, {1, 2, 4}] int32 encodes them:

- causal, last 1: band [r1, sq) (causal document mask);
- causal, last 2: band [r1, r2) (share-question mask);
- non-causal, last 2: bands [r1, sq) and [0, r2) (bidirectional document);
- non-causal, last 4: bands [r1, r2) and [r3, r4) (global + sliding window).

``normalize_startend_row_indices`` turns every class into the four
per-column bounds (lts, lte, uts, ute) that the masked flash kernels
(``ops/flash_attention.py``, B5/B6) take as ``mask_bands``; they mask score
tiles with them and skip tiles the bands cover whole.  The mask-class
builders return torch tensors made from numpy, on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .flash_attention import (FlashUnsupportedError, flash_attention,
                              segment_ids_from_cu_seqlens)

__all__ = [
    "flashmask_attention_raw", "normalize_startend_row_indices",
    "flashmask_to_dense_bias", "sliding_window_row_indices",
    "causal_document_row_indices", "share_question_row_indices",
    "global_sliding_row_indices", "flashmask_block_skip_fraction",
    "flash_attn_varlen_qkvpacked_raw",
]


def normalize_startend_row_indices(idx, causal: bool, seq_q: int):
    """Mirror of ``normalize_startend_row_indices``: [b, mh, sk, {1,2,4}]
    -> 4 int32 band arrays (lts, lte, uts, ute) each [b, mh, sk]: column j
    masks rows [lts, lte) and [uts, ute)."""
    idx = torch.as_tensor(idx)
    if idx.dim() != 4:
        raise ValueError(
            f"startend_row_indices rank must be 4, got shape {tuple(idx.shape)}")
    idx = idx.to(torch.int32)
    last = idx.shape[-1]
    empty = torch.zeros_like(idx[..., 0])
    if causal:
        if last == 1:
            return (idx[..., 0], torch.full_like(idx[..., 0], seq_q), empty,
                    empty)
        if last == 2:
            return idx[..., 0], idx[..., 1], empty, empty
        raise ValueError(f"causal flashmask expects last dim 1 or 2, got {last}")
    if last == 2:
        return (idx[..., 0], torch.full_like(idx[..., 0], seq_q), empty,
                idx[..., 1])
    if last == 4:
        return idx[..., 0], idx[..., 1], idx[..., 2], idx[..., 3]
    raise ValueError(f"non-causal flashmask expects last dim 2 or 4, got {last}")


def flashmask_to_dense_bias(idx, causal: bool, seq_q: int,
                            dtype=torch.float32, neg: float = -1e30):
    """Mirror of ``flashmask_to_dense_bias``: the dense [b, mh, sq, sk]
    additive bias (0 where visible, ``neg`` where masked), causal
    included."""
    lts, lte, uts, ute = (x[:, :, None, :] for x in
                          normalize_startend_row_indices(idx, causal, seq_q))
    rows = torch.arange(seq_q, dtype=torch.int32, device=lts.device)[:, None]
    masked = ((rows >= lts) & (rows < lte)) | ((rows >= uts) & (rows < ute))
    if causal:
        cols = torch.arange(lts.shape[-1], dtype=torch.int32,
                            device=lts.device)[None, :]
        masked = masked | (rows < cols)
    return torch.where(masked, torch.tensor(neg, dtype=dtype),
                       torch.tensor(0, dtype=dtype))


# ------------------------------------------------------ mask-class builders

def causal_document_row_indices(seqlens, *, dtype=np.int32):
    """Causal document mask: tokens attend causally within their document.
    Per-document lengths -> [1, 1, total, 1] (a column of the document
    ending at row e masks rows [e, total))."""
    ends = np.cumsum(np.asarray(seqlens, dtype=np.int64))
    total = int(ends[-1])
    r1 = np.repeat(ends, np.asarray(seqlens)).astype(dtype)
    return torch.from_numpy(r1.reshape(1, 1, total, 1))


def share_question_row_indices(q_len, span, total, *, dtype=np.int32):
    """Share-question mask: the first ``q_len`` columns are visible to every
    row except those of ``span`` = (start, end); the other columns are pure
    causal.  Causal 2-bound class, [1, 1, total, 2]."""
    r = np.full((total, 2), total, dtype=dtype)
    s, e = span
    r[:q_len, 0] = s
    r[:q_len, 1] = e
    return torch.from_numpy(r.reshape(1, 1, total, 2))


def sliding_window_row_indices(seq_len, window, causal: bool,
                               *, dtype=np.int32):
    """``window_size`` -> startend_row_indices: causal -> [.., 1] with
    r1 = clip(j + w0 + 1, max=s); bidirectional -> [.., 2] adding
    r2 = clip(j - w1, 0, s)."""
    if isinstance(window, int):
        window = (window, window)
    j = np.arange(seq_len, dtype=np.int64)
    r1 = np.clip(j + window[0] + 1, None, seq_len).astype(dtype)
    if causal:
        return torch.from_numpy(r1.reshape(1, 1, seq_len, 1))
    r2 = np.clip(j - window[1], 0, seq_len).astype(dtype)
    return torch.from_numpy(
        np.stack([r1, r2], axis=-1).reshape(1, 1, seq_len, 2))


def global_sliding_row_indices(seq_len, window, n_global, *, dtype=np.int32):
    """Global + sliding-window mask (the 4-bound class): the first
    ``n_global`` columns are visible to all rows; every other column only
    within ``window`` rows of the diagonal."""
    j = np.arange(seq_len, dtype=np.int64)
    lts = np.clip(j + window + 1, None, seq_len)
    lte = np.full(seq_len, seq_len, dtype=np.int64)
    uts = np.zeros(seq_len, dtype=np.int64)
    ute = np.clip(j - window, 0, seq_len)
    lts[:n_global] = seq_len
    ute[:n_global] = 0
    out = np.stack([lts, lte, uts, ute], axis=-1).astype(dtype)
    return torch.from_numpy(out.reshape(1, 1, seq_len, 4))


def flashmask_block_skip_fraction(idx, causal: bool, seq_q: int,
                                  block: int = 512) -> float:
    """Mirror of ``flashmask_block_skip_fraction``: the share of (q, k)
    tiles the band cover (and the causal triangle) skips, host-side."""
    lts, lte, uts, ute = (x.cpu().numpy() for x in
                          normalize_startend_row_indices(idx, causal, seq_q))
    b, mh, sk = lts.shape
    nq, nk = -(-seq_q // block), -(-sk // block)
    run = skip = 0
    for bi in range(b):
        for hi in range(mh):
            for qi in range(nq):
                q_lo, q_hi = qi * block, min((qi + 1) * block, seq_q)
                for ki in range(nk):
                    if causal and (qi + 1) * block - 1 < ki * block:
                        skip += 1
                        continue
                    sl = slice(ki * block, min((ki + 1) * block, sk))
                    a, b_, c, d = (lts[bi, hi, sl], lte[bi, hi, sl],
                                   uts[bi, hi, sl], ute[bi, hi, sl])
                    lt = (a <= q_lo) & (b_ >= q_hi)
                    ut = (c <= q_lo) & (d >= q_hi)
                    j1 = (a <= q_lo) & (c <= b_) & (d >= q_hi)
                    j2 = (c <= q_lo) & (a <= d) & (b_ >= q_hi)
                    if np.all(lt | ut | j1 | j2):
                        skip += 1
                    else:
                        run += 1
    return skip / max(run + skip, 1)


# ------------------------------------------------------------ public entries

def flashmask_attention_raw(q, k, v, startend_row_indices=None, *,
                            causal: bool = False, window_size=None,
                            scale=None, blocks=None):
    """Mirror of ``flashmask_attention_raw``: q/k/v [b, s, h|kvh, d];
    ``startend_row_indices`` [b, mh, sk, {1,2,4}] int32 with mh 1 or kvh, or
    ``window_size`` (int or (left, right)) for a sliding window.  Returns
    [b, s, h, d]."""
    if window_size is not None:
        if startend_row_indices is not None:
            raise ValueError("can't use window_size with startend_row_indices")
        sri = sliding_window_row_indices(q.shape[1], window_size, causal)
        startend_row_indices = sri.expand((q.shape[0],) + sri.shape[1:])
    if startend_row_indices is None:
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               blocks=blocks)
    b, sq = q.shape[0], q.shape[1]
    kvh = k.shape[2]
    idx = torch.as_tensor(startend_row_indices, device=q.device)
    if idx.dim() != 4 or idx.shape[0] != b or idx.shape[2] != k.shape[1]:
        raise ValueError(f"startend_row_indices shape {tuple(idx.shape)} does "
                         f"not match batch {b} / seqlen_k {k.shape[1]}")
    if idx.shape[1] not in (1, kvh):
        raise ValueError(f"startend_row_indices head dim must be 1 or kv "
                         f"heads ({kvh}), got {idx.shape[1]}")
    bands = normalize_startend_row_indices(idx, causal, sq)
    return flash_attention(q, k, v, causal=causal, scale=scale, blocks=blocks,
                           mask_bands=bands)


def flash_attn_varlen_qkvpacked_raw(qkv, cu_seqlens_q, cu_seqlens_k,
                                    max_seqlen_q=None, max_seqlen_k=None,
                                    scale=None, causal: bool = False,
                                    varlen_padded: bool = True):
    """Mirror of ``flash_attn_varlen_qkvpacked_raw``.  qkv [total, g + 2,
    kvh, d]: the first g slots of axis 1 are q heads in the reference's
    g-major order (q head hq reads kv head hq % kvh), then k, then v.
    ``varlen_padded=True``: sequence i fills rows [i * max_seqlen_q,
    i * max_seqlen_q + len_i); padding rows get unique negative segment ids
    (q side and k side disjoint), so they see no key and come out 0.
    False: the packed layout of ``flash_attn_unpadded``.  Returns
    [total, h, d] in the reference head order."""
    total, g2, kvh, d = qkv.shape
    g = g2 - 2
    if g < 1:
        raise FlashUnsupportedError(f"qkv axis 1 must be h/kvh + 2, got {g2}")
    h = g * kvh
    # the kernels' GQA map is group-major (q head hq reads kv head hq // g):
    # present q as [total, kvh * g, d] and permute the output back
    qg = qkv[:, :g].transpose(1, 2).reshape(total, h, d)
    k, v = qkv[:, g], qkv[:, g + 1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    cu_q = torch.as_tensor(cu_seqlens_q, device=qkv.device).to(torch.int32)
    cu_k = torch.as_tensor(cu_seqlens_k, device=qkv.device).to(torch.int32)
    if varlen_padded:
        if max_seqlen_q is None:
            raise ValueError("varlen_padded=True requires max_seqlen_q")
        pos = torch.arange(total, dtype=torch.int32, device=qkv.device)
        seq_i = (pos // max_seqlen_q).long()
        off = pos % max_seqlen_q
        len_q = cu_q[seq_i + 1] - cu_q[seq_i]
        len_k = cu_k[seq_i + 1] - cu_k[seq_i]
        qs = torch.where(off < len_q, seq_i.to(torch.int32) + 1, -(2 * pos + 2))
        ks = torch.where(off < len_k, seq_i.to(torch.int32) + 1, -(2 * pos + 3))
    else:
        qs = segment_ids_from_cu_seqlens(cu_q, total)
        ks = segment_ids_from_cu_seqlens(cu_k, total)
    out = flash_attention(qg[None], k[None], v[None], causal=causal,
                          scale=scale, q_segment_ids=qs[None],
                          kv_segment_ids=ks[None], blocks=(1024, 1024))[0]
    return out.reshape(total, kvh, g, d).transpose(1, 2).reshape(total, h, d)
