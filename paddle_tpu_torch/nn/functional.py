"""The public attention and dropout entries of ``paddle.nn.functional``.

Port of ``paddle_tpu/nn/functional/__init__.py``'s ``dropout``,
``scaled_dot_product_attention`` and flash-attention functions
(``flash_attention``, ``flash_attn_unpadded``, ``flashmask_attention``,
``flash_attn_varlen_qkvpacked``), with the reference signatures.  The
flash functions run on the port's flash kernels (``ops/flash_attention.py``,
``ops/flashmask.py``); ``flash_attention`` with dropout and
``scaled_dot_product_attention`` run the plain attention of
``ops/nn_ops.py``.  The varlen and FlashMask entries raise on dropout
during training, as the JAX ones do.  ``return_softmax`` and
``return_softmax_lse`` return None in their place, as the JAX entries do.
"""

from __future__ import annotations

from ..incubate.nn import attention as _attn
from ..ops import random as _random
from ..ops.flash_attention import flash_attn_unpadded_raw
from ..ops.flashmask import (flash_attn_varlen_qkvpacked_raw,
                             flashmask_attention_raw)
from ..ops.nn_ops import dropout_impl
from ..ops.nn_ops import scaled_dot_product_attention as _sdpa


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Mirror of ``dropout``: zero each entry with probability ``p`` (one
    draw per index of the ``axis`` dims, broadcast over the others),
    scaling the kept ones by 1/(1 - p) in ``upscale_in_train`` mode; in
    ``downscale_in_infer`` mode inference scales by 1 - p instead."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    shape = tuple(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = tuple(s if i in axes else 1 for i, s in enumerate(shape))
    mask = _random.bernoulli(1.0 - p, shape, x.device).expand(x.shape)
    return dropout_impl(x, mask, p=p, mode=mode)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True):
    """[b, s, h, d] attention with equal head counts (mirror of
    ``scaled_dot_product_attention_``): the dropout mask, when training
    with ``dropout_p > 0``, comes from the default generator."""
    mask = None
    if dropout_p > 0.0 and training:
        b, sq, h, _ = query.shape
        mask = _random.bernoulli(1.0 - dropout_p, (b, h, sq, key.shape[1]),
                                 query.device)
    return _sdpa(query, key, value, attn_mask=attn_mask, dropout_mask=mask,
                 dropout_p=dropout_p, is_causal=is_causal)


def _no_dropout(name: str, dropout: float, training: bool) -> None:
    if dropout and training:
        raise NotImplementedError(
            f"{name}: dropout is not supported on this path (nor in the JAX "
            f"package); apply nn.functional.dropout outside attention")


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    training=True):
    """[b, s, h, d] attention (``paddle.nn.functional.flash_attention``);
    dropout during training takes the plain attention path."""
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
