"""Flash-attention entry of the port.

Port of ``paddle_tpu/incubate/nn/attention.py :: flash_attention``.  The
call goes to ``ops/flash_attention.py :: flash_attention``, which routes
unmasked attention to the head-batched kernels (B1/B2) and segment ids to
the masked kernels (B5/B6).  A boolean [b, sk] (or [b, 1, 1, sk]) keep-mask
becomes segment ids (``_as_padding_segments``), as in the JAX entry.  Other
masks (additive, integer or float, or a decode-shaped sq != sk keep-mask),
which the JAX entry sends to its XLA softmax path, and dropout raise
``NotImplementedError`` naming their ROADMAP item.  The JAX entry's silent
fallback (catch any kernel failure, then run the XLA softmax path) is not
ported: here a kernel failure raises.
"""

from __future__ import annotations

import torch

from ...ops.flash_attention import flash_attention as _flash_entry


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
    group-major) is passed unexpanded to the kernels.  Explicit int [b, s]
    segment ids (sequence packing) or a bool keep-mask ride the masked
    kernels, splash-attention style: a query attends a key iff their ids
    match."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("q_segment_ids and kv_segment_ids must be given "
                         "together")
    if q_segment_ids is not None and attn_mask is not None:
        raise ValueError("pass either attn_mask or segment ids, not both")
    if dropout > 0.0:
        raise NotImplementedError(
            "flash_attention: dropout needs an in-kernel Philox generator "
            "(ROADMAP A1, additive masks and dropout)")
    if attn_mask is not None:
        seg = _as_padding_segments(attn_mask, query, key)
        if seg is None:
            raise NotImplementedError(
                "flash_attention: an additive or decode-shaped attn_mask "
                "takes the JAX entry's XLA softmax path, not ported "
                "(ROADMAP A1, additive masks and dropout)")
        q_segment_ids = kv_segment_ids = seg
    return _flash_entry(query, key, value, causal=causal, scale=scale,
                        q_segment_ids=q_segment_ids,
                        kv_segment_ids=kv_segment_ids)
