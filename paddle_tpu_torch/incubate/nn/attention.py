"""Flash-attention entry of the port.

Port of ``paddle_tpu/incubate/nn/attention.py :: flash_attention``.  The
unmasked, dropout-free call goes to the head-batched kernels
(``ops/flash_attention.py``, B1/B2).  Masks, segment ids and dropout raise
``NotImplementedError`` naming the slice that will port them.  The JAX
entry's silent fallback (catch any kernel failure, then run the XLA softmax
path) is not ported: here a kernel failure raises.
"""

from __future__ import annotations

from ...ops.flash_attention import flash_attention as _flash_hb_entry


def flash_attention(query, key, value, causal: bool = False,
                    dropout: float = 0.0, attn_mask=None, scale=None,
                    q_segment_ids=None, kv_segment_ids=None):
    """(batch, seq, heads, head_dim) attention; GQA (fewer kv heads, heads
    group-major) is passed unexpanded to the kernels."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("q_segment_ids and kv_segment_ids must be given "
                         "together")
    if q_segment_ids is not None or attn_mask is not None:
        raise NotImplementedError(
            "flash_attention: masks and segment ids take the masked kernels "
            "B5/B6 (the masked/varlen/FlashMask slice), not ported yet")
    if dropout > 0.0:
        raise NotImplementedError(
            "flash_attention: dropout needs an in-kernel Philox generator, "
            "a later slice of the port")
    return _flash_hb_entry(query, key, value, causal=causal, scale=scale)
