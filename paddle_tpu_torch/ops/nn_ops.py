"""Attention and dropout as plain PyTorch (mirror of the
``scaled_dot_product_attention`` and ``dropout_impl`` ops of
``paddle_tpu/ops/nn_ops.py``).

This is the path the JAX package runs outside any Pallas kernel: the
attention entries send additive masks, decode-shaped masks and dropout
here (``incubate/nn/attention.py``).  It takes an explicit dropout mask,
so ``torch.nn.functional.scaled_dot_product_attention``, whose dropout
draws its own bits, is not used.
"""

from __future__ import annotations

import math

import torch


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False, scale=None):
    """q [b, sq, h, d], k/v [b, sk, h, d] (the flash layout, equal head
    counts).  The logits q k^T * scale in q's dtype, then fp32; a causal
    mask aligned bottom-right (query i sees keys up to i + sk - sq); a
    bool ``attn_mask`` keeps where True, any other dtype is added in fp32
    (broadcast to [b, h, sq, sk]); softmax, cast to q's dtype; with
    ``dropout_p > 0`` the bool ``dropout_mask`` [b, h, sq, sk] keeps
    probabilities scaled by 1/(1 - p).  Returns [b, sq, h, d]."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if k.shape[2] != h or v.shape[2] != h:
        raise ValueError(f"scaled_dot_product_attention: q has {h} heads, "
                         f"k/v {k.shape[2]}/{v.shape[2]}; repeat the kv "
                         f"heads first")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    logits = (torch.matmul(qt, kt.transpose(-1, -2)) * scale).float()
    if is_causal:
        keep = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, float("-inf"))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, float("-inf"))
        else:
            logits = logits + attn_mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout_mask is not None and dropout_p > 0.0:
        probs = torch.where(dropout_mask, probs / (1.0 - dropout_p),
                            torch.zeros_like(probs))
    return torch.matmul(probs, vt).transpose(1, 2)


def dropout_impl(x, mask, p: float = 0.5, mode: str = "upscale_in_train"):
    """``x`` where ``mask`` keeps it (scaled by 1/(1 - p) in
    ``upscale_in_train`` mode), else 0."""
    if mode == "upscale_in_train":
        return torch.where(mask, x / (1.0 - p), torch.zeros_like(x))
    return torch.where(mask, x, torch.zeros_like(x))
