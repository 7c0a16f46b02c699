"""Flash-attention entry of the port.

Port of ``paddle_tpu/incubate/nn/attention.py :: flash_attention``, with
its routing rule:

- no mask, or explicit int segment ids, and no dropout: the kernels
  (``ops/flash_attention.py :: flash_attention``: the head-batched B1/B2
  for plain attention, the masked B5/B6 for segment ids), GQA passed
  unexpanded;
- a boolean [b, sk] (or [b, 1, 1, sk]) keep-mask with sq == sk and no
  dropout becomes segment ids (``_as_padding_segments``) and takes the
  masked kernels;
- everything else takes the plain attention the JAX entry runs outside
  Pallas (``ops/nn_ops.py :: scaled_dot_product_attention``), with the kv
  heads repeated: an additive (integer or float) mask, a decode-shaped
  bool mask (made [b, 1, 1, sk]), segment ids or a keep-mask that meet
  dropout (as the equality mask), causal attention with sq != sk (the
  kernels' shape rule refuses it, aligned bottom-right here), and dropout,
  whose mask comes from ``ops/random.py``'s default generator.

The JAX entry's silent fallback (catch any kernel failure, then run the
softmax path) is not ported: here a kernel failure raises.
"""

from __future__ import annotations

import torch

from ...ops import random as _random
from ...ops.flash_attention import _ids
from ...ops.flash_attention import flash_attention as _flash_entry
from ...ops.nn_ops import scaled_dot_product_attention as _sdpa


def _as_padding_segments(attn_mask, query, key):
    """A boolean [b, sk] (or [b, 1, 1, sk]) keep-mask as int32 segment ids
    (kept 1, padding 0); anything else returns None (mirror of
    ``_as_padding_segments``: integer and float masks are additive in the
    JAX entry's XLA path, so only bool masks are keep-masks)."""
    m = torch.as_tensor(attn_mask)
    if m.dim() == 4 and m.shape[1] == 1 and m.shape[2] == 1:
        m = m[:, 0, 0]
    if m.dim() != 2 or tuple(m.shape) != (key.shape[0], key.shape[1]):
        return None
    if m.dtype != torch.bool or query.shape[1] != key.shape[1]:
        return None
    return m.to(device=query.device, dtype=torch.int32)


def flash_attention(query, key, value, causal: bool = False,
                    dropout: float = 0.0, attn_mask=None, scale=None,
                    q_segment_ids=None, kv_segment_ids=None):
    """(batch, seq, heads, head_dim) attention; GQA (fewer kv heads, heads
    group-major).  ``q_segment_ids``/``kv_segment_ids`` [b, s] (sequence
    packing: a query attends a key iff their ids match) or ``attn_mask``
    (a bool keep-mask, or an additive mask broadcastable to [b, h, sq,
    sk]), not both; ``dropout`` the probability of dropping an attention
    weight."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("q_segment_ids and kv_segment_ids must be given "
                         "together")
    seg_pair = None
    if q_segment_ids is not None:
        if attn_mask is not None:
            raise ValueError("pass either attn_mask or segment ids, not "
                             "both")
        seg_pair = (_ids(q_segment_ids, query.device),
                    _ids(kv_segment_ids, query.device))
    if attn_mask is not None and dropout == 0.0:
        seg = _as_padding_segments(attn_mask, query, key)
        if seg is not None:
            seg_pair, attn_mask = (seg, seg), None
    sq, sk = query.shape[1], key.shape[1]
    if dropout == 0.0 and attn_mask is None and not (causal and sq != sk):
        q_seg, k_seg = seg_pair if seg_pair is not None else (None, None)
        return _flash_entry(query, key, value, causal=causal, scale=scale,
                            q_segment_ids=q_seg, kv_segment_ids=k_seg)
    rep = query.shape[2] // key.shape[2]
    if rep > 1:
        key = key.repeat_interleave(rep, dim=2)
        value = value.repeat_interleave(rep, dim=2)
    if attn_mask is None and seg_pair is not None:
        attn_mask = (seg_pair[0][:, :, None]
                     == seg_pair[1][:, None, :])[:, None]
    elif attn_mask is not None:
        m = torch.as_tensor(attn_mask, device=query.device)
        if m.dim() == 4 and m.shape[1] == 1 and m.shape[2] == 1 \
                and m.dtype == torch.bool:
            m = m[:, 0, 0]
        if m.dtype == torch.bool and m.dim() == 2 \
                and tuple(m.shape) == (key.shape[0], sk):
            m = m[:, None, None, :]       # every query live, keys padded
        attn_mask = m
    dropout_mask = None
    if dropout > 0.0:
        b, _, h, _ = query.shape
        dropout_mask = _random.bernoulli(1.0 - dropout, (b, h, sq, sk),
                                         query.device)
    return _sdpa(query, key, value, attn_mask=attn_mask,
                 dropout_mask=dropout_mask, dropout_p=dropout,
                 is_causal=causal, scale=scale)
