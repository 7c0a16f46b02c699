"""The public attention entries of ``paddle.nn.functional``.

Port of the flash-attention functions of
``paddle_tpu/nn/functional/__init__.py``: ``flash_attention``,
``flash_attn_unpadded``, ``flashmask_attention`` and
``flash_attn_varlen_qkvpacked``, with the reference signatures.  They run
on the port's flash kernels (``ops/flash_attention.py``,
``ops/flashmask.py``).  Dropout during training raises
``NotImplementedError`` (ROADMAP A1); ``return_softmax`` and
``return_softmax_lse`` return None in their place, as the JAX entries do.
"""

from __future__ import annotations

from ..incubate.nn import attention as _attn
from ..ops.flash_attention import flash_attn_unpadded_raw
from ..ops.flashmask import (flash_attn_varlen_qkvpacked_raw,
                             flashmask_attention_raw)


def _no_dropout(name: str, dropout: float, training: bool) -> None:
    if dropout and training:
        raise NotImplementedError(
            f"{name}: dropout needs an in-kernel Philox generator (ROADMAP "
            f"A1, additive masks and dropout); apply dropout outside "
            f"attention")


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    training=True):
    """[b, s, h, d] attention (``paddle.nn.functional.flash_attention``)."""
    out = _attn.flash_attention(query, key, value, causal=causal,
                                dropout=dropout if training else 0.0)
    return (out, None) if return_softmax else out


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q=None, max_seqlen_k=None, scale=None,
                        dropout=0.0, causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True):
    """Ragged attention over a packed token stream: query [total_q, h, d],
    cu_seqlens offsets [b+1]; max_seqlen_* are shape hints the kernels do
    not need."""
    _no_dropout("flash_attn_unpadded", dropout, training)
    out = flash_attn_unpadded_raw(query, key, value, cu_seqlens_q,
                                  cu_seqlens_k, scale=scale, causal=causal)
    return (out, None) if return_softmax else out


def flashmask_attention(query, key, value, startend_row_indices=None,
                        dropout=0.0, causal=False, window_size=None,
                        return_softmax_lse=False, return_seed_offset=False,
                        fixed_seed_offset=None, rng_name="", training=True):
    """FlashMask column-band attention: ``startend_row_indices``
    [b, mh, sk, {1,2,4}] int32 (see ``ops/flashmask.py``) or
    ``window_size``."""
    _no_dropout("flashmask_attention", dropout, training)
    out = flashmask_attention_raw(query, key, value, startend_row_indices,
                                  causal=causal, window_size=window_size)
    extras = [None] * (int(return_softmax_lse) + int(return_seed_offset))
    return (out, *extras) if extras else out


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q=None, max_seqlen_k=None,
                                scale=None, dropout=0.0, causal=False,
                                return_softmax=False, fixed_seed_offset=None,
                                rng_name="", varlen_padded=True,
                                training=True):
    """Varlen attention on a GQA-packed qkv [total, h/kvh + 2, kvh, d]."""
    _no_dropout("flash_attn_varlen_qkvpacked", dropout, training)
    out = flash_attn_varlen_qkvpacked_raw(
        qkv, cu_seqlens_q, cu_seqlens_k, max_seqlen_q, max_seqlen_k,
        scale=scale, causal=causal, varlen_padded=varlen_padded)
    return (out, None) if return_softmax else out
