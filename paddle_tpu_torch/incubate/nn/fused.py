"""Fused LLM ops: RMSNorm, rotary embedding, SwiGLU and ``fused_moe``.

Port of ``paddle_tpu/incubate/nn/fused.py``.  The JAX package left these to
XLA's fusion, so here they are plain PyTorch; only the weighted RMSNorm
keeps a hand-written backward (``_RmsNormWeighted``), as the JAX one keeps
its custom vjp (``paddle_tpu/ops/nn_ops.py :: _rms_norm_weighted``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.models.moe.moe_layer import (_activation, _promoted,
                                                _router, top_k_sorted)


class _RmsNormWeighted(torch.autograd.Function):
    """Mirror of ``paddle_tpu/ops/nn_ops.py :: _rms_norm_weighted`` and its
    fwd/bwd: the output is ``x * rrms * w`` in fp32, cast to x's dtype at the
    end (the training order; the serving ``_rms_norm`` casts before the gain
    multiply).  The backward saves rrms and computes, with xhat = x * rrms,
    ``dw = sum_t dy * xhat`` and ``dx = rrms * (w*dy - xhat * mean(w*dy*xhat))``."""

    @staticmethod
    def forward(ctx, x, weight, epsilon):
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        rrms = torch.rsqrt(var + epsilon)
        ctx.save_for_backward(x, weight, rrms)
        return (xf * rrms * weight.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, rrms = ctx.saved_tensors
        xhat = x.float() * rrms
        dyf = dy.float()
        dxhat = dyf * weight.float()
        dw = (dyf * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
        proj = (dxhat * xhat).mean(dim=-1, keepdim=True)
        dx = rrms * (dxhat - xhat * proj)
        return dx.to(x.dtype), dw.to(weight.dtype), None


def fused_rms_norm(x, weight=None, epsilon: float = 1e-6):
    """RMSNorm over the last axis (mirror of ``fused_rms_norm``): fp32
    statistics; with ``weight`` the custom-backward path above."""
    if weight is not None:
        return _RmsNormWeighted.apply(x, weight, float(epsilon))
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + epsilon)).to(x.dtype)


def swiglu(x, y=None):
    """``silu(x) * y``; with one argument its halves along the last axis
    (mirror of ``swiglu``)."""
    if y is None:
        x, y = x.chunk(2, dim=-1)
    return F.silu(x) * y


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _gather_rows(table, pid):
    """Rows ``pid`` [b, s] of a rope table as [b, s, 1, d]."""
    t = table.reshape(table.shape[1], table.shape[3]) if table.dim() == 4 \
        and table.shape[0] == 1 and table.shape[2] == 1 else table
    if t.dim() != 2:
        raise ValueError(f"fused_rotary_position_embedding: with "
                         f"position_ids, sin/cos must be [max_pos, d] or "
                         f"[1, max_pos, 1, d] tables, got {tuple(table.shape)}")
    return t[pid][:, :, None, :]


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style: bool = True):
    """Rotary embedding in the (batch, seq, heads, head_dim) layout (mirror
    of ``fused_rotary_position_embedding``); returns a tuple of the rotated
    q, k, v that were given.  sin/cos (broadcastable to q) are cast to q's
    dtype first, as the JAX op does, so bf16 q/k stay bf16.  Neox style
    rotates halves; the interleaved (GPT-J) style rotates even/odd pairs
    with the even entries of sin/cos.

    With ``position_ids`` [b, s], sin and cos are tables, [max_pos, d] or
    Paddle's [1, max_pos, 1, d], and each token takes the row of its
    position, as the reference op gathers them (the JAX op ignores
    ``position_ids`` and wants sin/cos gathered by its caller)."""
    if position_ids is not None:
        pid = torch.as_tensor(position_ids, device=q.device).long()
        sin, cos = (_gather_rows(t, pid) for t in (sin, cos))
    sin = sin.to(q.dtype)
    cos = cos.to(q.dtype)

    def apply(x):
        if x is None:
            return None
        if use_neox_rotary_style:
            return x * cos + _rotate_half(x) * sin
        x1, x2 = x[..., ::2], x[..., 1::2]
        c, s = cos[..., ::2], sin[..., ::2]
        return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s],
                           dim=-1).reshape(x.shape)

    return tuple(r for r in (apply(q), apply(k), apply(v)) if r is not None)


def fused_moe(x, gate_weight, ffn1_weight, ffn2_weight, ffn1_bias=None,
              ffn2_bias=None, moe_topk: int = 2, norm_topk_prob: bool = True,
              activation: str = "gelu"):
    """The inference-path MoE FFN with no token dropping (mirror of
    ``fused_moe``): every expert runs every token (dense einsums, as JAX
    leaves them to XLA), and each token combines its top-k experts with
    their router probabilities, renormalised to sum 1 when
    ``norm_topk_prob`` (MoELayer combines raw probabilities).  The top-k
    ties go to the lowest index (``lax.top_k``); the experts' gelu is the
    tanh form (``jax.nn.gelu``).  x [..., m]; gate_weight [m, E];
    ffn1_weight [E, m, h] (2h for swiglu); ffn2_weight [E, h, m]."""
    if activation not in ("gelu", "relu", "swiglu"):
        raise ValueError(f"fused_moe: unsupported activation {activation!r} "
                         f"(gelu | relu | swiglu)")
    orig = x.shape
    x2 = x.reshape(-1, orig[-1])
    g, e = x2.shape[0], gate_weight.shape[-1]
    topv, topi = top_k_sorted(_router(x2, gate_weight), moe_topk)
    if norm_topk_prob:
        topv = topv / torch.clamp(topv.sum(dim=-1, keepdim=True), min=1e-12)
    h = torch.einsum("gm,emh->egh", *_promoted(x2, ffn1_weight))
    if ffn1_bias is not None:
        h = h + ffn1_bias[:, None, :]
    h = _activation(h, activation)
    eo = torch.einsum("egh,ehm->egm", *_promoted(h, ffn2_weight))
    if ffn2_bias is not None:
        eo = eo + ffn2_bias[:, None, :]
    rows = torch.arange(g, device=x.device)[:, None].expand_as(topi)
    w_full = torch.zeros((g, e), dtype=torch.float32,
                         device=x.device).index_put(
                             (rows, topi), topv, accumulate=True)
    y = torch.einsum("ge,egm->gm", *_promoted(w_full.to(x.dtype), eo))
    return y.reshape(orig)
