"""Ring attention: exact attention over a sequence cut along a mesh axis.

Port of ``paddle_tpu/parallel/ring_attention.py`` (``ring_flash_attention``,
the ``_ring_flash`` custom_vjp with ``_ring_forward_loop`` and
``_ring_bwd``).  q, k and v are this rank's [b, s_local, heads, d] block of
a sequence cut over ``axis`` in rank order.

Forward: q stays; the k/v block makes P - 1 ``ppermute`` hops to the right,
so after i hops this rank holds rank (me - i)'s block.  Each hop runs one
masked flash forward (``ops/flash_attention.py::flash_forward``, B5 on the
card) on [b*h, s_local, d]; under ``causal`` the hop is the full block
(src < me), the causal diagonal (src == me) or skipped (src > me: every key
lies in the future), a Python branch, since src and me are ints on each
rank.  The hops merge online by their logsumexp, with the ``-inf`` guard of
the JAX loop (a skipped hop leaves the carry unchanged exactly, so it is
not merged at all).

Backward: a second ring pass.  The forward saves the merged output ``o``
and the GLOBAL row logsumexp ``[b*h, s_local]`` fp32 (the port's lse has no
8-row sublane axis, so the JAX loop's ``lse8`` broadcast has no
counterpart).  Each hop reruns the masked flash backward
(``flash_backward``, B6) on (q, the visiting k/v, o, lse, do): with the
global o and lse its recomputed probabilities are the global softmax's and
its ``delta = rowsum(do * o)`` the global one, so the hop's dq, dk and dv
are exact contributions.  dq adds up here; the dk/dv accumulators travel
with their blocks and are ``ppermute``d on every hop, the last one too, so
every block comes home carrying every rank's contribution.

The collectives are the raw ``ppermute`` of ``compat.py`` inside one
``torch.autograd.Function``: every rank issues the same sends and receives
in the same order whatever its branches, so the branches cannot unbalance
them.  At P = 1 the ring is one diagonal hop: one B5 and one B6 call.
Each hop's exchange blocks (``batch_isend_irecv`` then wait): it is not
overlapped with the previous hop's flash call, and under ``causal`` rank r
runs r + 1 live hops (ROADMAP speed items).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .compat import _ppermute_raw, _size


def _hop_branch(src: int, me: int) -> int:
    """0 = full block (src < me), 1 = causal diagonal (src == me), 2 = skip
    (src > me: all keys in the future)."""
    return int(src == me) + 2 * int(src > me)


def _ring_perm(p: int):
    return tuple((i, (i + 1) % p) for i in range(p))


def _hops(p: int, me: int, causal: bool):
    """(hop, src, flash causal flag or None for a skipped hop)."""
    for i in range(p):
        src = (me - i) % p
        branch = _hop_branch(src, me) if causal else 0
        yield i, src, (None if branch == 2 else branch == 1)


class _RingFlash(torch.autograd.Function):
    """The ring on the [b*heads, s_local, d] layouts of the flash
    kernels."""

    @staticmethod
    def forward(ctx, qf, kf, vf, h, kvh, axis, causal, scale, mesh):
        from ..ops import flash_attention as fa

        p, me = _size(mesh, axis), mesh.axis_index(axis)
        perm = _ring_perm(p)
        bh, sl, d = qf.shape
        m = torch.full((bh, sl), float("-inf"), dtype=torch.float32,
                       device=qf.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((bh, sl, d), dtype=torch.float32, device=qf.device)
        kb, vb = kf, vf
        for i, _, flag in _hops(p, me, causal):
            if flag is not None:
                o_i, lse_i = fa.flash_forward(qf, kb, vb, flag, scale, h,
                                              kvh)
                m_new = torch.maximum(m, lse_i)
                # guard -inf - -inf (a row no key of the carry has seen)
                dead = torch.isinf(m_new) & (m_new < 0)
                alpha = torch.where(dead, 0.0, torch.exp(m - m_new))
                beta = torch.where(dead, 0.0, torch.exp(lse_i - m_new))
                l = l * alpha + beta
                # o_i is normalised within its block: re-weight it by beta
                acc = acc * alpha[..., None] + o_i.float() * beta[..., None]
                m = m_new
            if i != p - 1:
                kb = _ppermute_raw(kb, axis, perm, mesh)
                vb = _ppermute_raw(vb, axis, perm, mesh)
        l_safe = torch.where(l == 0.0, 1.0, l)
        o = (acc / l_safe[..., None]).to(qf.dtype)
        lse = torch.where(l > 0.0, m + torch.log(l_safe),
                          torch.full_like(m, float("-inf")))
        ctx.save_for_backward(qf, kf, vf, o, lse)
        ctx.meta = (h, kvh, axis, causal, scale, mesh)
        return o

    @staticmethod
    def backward(ctx, g):
        from ..ops import flash_attention as fa

        qf, kf, vf, of, lse = ctx.saved_tensors
        h, kvh, axis, causal, scale, mesh = ctx.meta
        p, me = _size(mesh, axis), mesh.axis_index(axis)
        perm = _ring_perm(p)
        gf = g.to(of.dtype).contiguous()
        dq = torch.zeros(qf.shape, dtype=torch.float32, device=qf.device)
        dkb = torch.zeros(kf.shape, dtype=torch.float32, device=qf.device)
        dvb = torch.zeros_like(dkb)
        kb, vb = kf, vf
        for i, _, flag in _hops(p, me, causal):
            if flag is not None:
                dq_i, dk_i, dv_i = fa.flash_backward(
                    qf, kb, vb, of, lse, gf, flag, scale, h, kvh)
                dq += dq_i.float()
                dkb += dk_i.float()
                dvb += dv_i.float()
            # the accumulators travel with their blocks: after p hops every
            # block is home with all ranks' contributions
            if i != p - 1:
                kb = _ppermute_raw(kb, axis, perm, mesh)
                vb = _ppermute_raw(vb, axis, perm, mesh)
            dkb = _ppermute_raw(dkb, axis, perm, mesh)
            dvb = _ppermute_raw(dvb, axis, perm, mesh)
        return (dq.to(qf.dtype), dkb.to(kf.dtype), dvb.to(vf.dtype),
                None, None, None, None, None, None)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         axis: str = "sep", causal: bool = True,
                         scale: Optional[float] = None, *,
                         mesh) -> torch.Tensor:
    """Exact, exactly differentiable attention for a sequence cut over
    ``axis`` of the live ``mesh`` (mirror of ``ring_flash_attention``).
    q: [b, s_local, h, d]; k, v: [b, s_local, kvh, d] (h a multiple of
    kvh), this rank's blocks in rank order.  Returns [b, s_local, h, d] in
    q's dtype."""
    from ..ops.flash_attention import _from_bh, _to_bh

    b, _, h, d = q.shape
    kvh = k.shape[2]
    if h % kvh:
        raise ValueError(f"q heads {h} not a multiple of kv heads {kvh}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    o = _RingFlash.apply(_to_bh(q), _to_bh(k), _to_bh(v), h, kvh, axis,
                         bool(causal), float(scale), mesh)
    return _from_bh(o, b, h)


__all__ = ["ring_flash_attention"]
