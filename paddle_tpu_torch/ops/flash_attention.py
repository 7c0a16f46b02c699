"""Head-batched flash attention: the training forward and backward.

Port of the head-batched (HB) path of
``paddle_tpu/ops/pallas/flash_attention.py``, the one ``flash_attention_raw``
takes for unmasked GQA attention:

- ``hb_flash_forward`` mirrors ``_hb_flash_forward`` (TPU body
  ``_hb_flash_kernel``, B1): q [b*kvh, rep, s, d], k/v [b*kvh, sk, d] ->
  o [b*kvh, rep, s, d] (q's dtype) and lse [b*kvh, rep, s] fp32;
- ``hb_flash_backward`` mirrors ``_hb_flash_backward`` (TPU body
  ``_hb_bwd_kernel``, B2): (q, k, v, o, lse, do) -> dq [b*kvh, rep, s, d]
  and dk, dv [b*kvh, sk, d] summed over the rep heads of each group;
- ``_FlashHB`` mirrors the ``_flash_hb`` custom_vjp and ``flash_attention``
  mirrors ``flash_attention_raw``'s routing to it.

The TPU kernel writes lse as [b*kvh, rep, 8, s]: the 8-row broadcast is
TPU sublane padding, so the port keeps [b*kvh, rep, s].

On a CUDA tensor each launcher runs its hand-written kernel
(``csrc/flash_attention.cu``) and counts the launch in ``LAUNCHES``; on a
CPU tensor it runs the ``*_plain`` PyTorch version beside it.  There is no
other route: a tensor on any other device raises, and every call outside
the HB path (segment ids, mask bands, explicit blocks, rep > 8, sk != s,
a backward scratch that would not fit) raises ``NotImplementedError``: it
belongs to the masked kernels B5/B6 of a later slice.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from . import _build

# masking constant of paddle_tpu/ops/pallas/flash_attention.py (NEG_INF):
# finite, so a row that sees no key keeps m = NEG_INF and outputs 0
NEG_INF = -1e30

# The TPU's full-sequence dk/dv VMEM budget of the fused backward
# (flash_attention.py _FUSED_BWD_VMEM_BUDGET).  Kept only as the constant of
# the admissibility rule ``hb_bwd_blocks``, so both packages route the same
# calls to the HB kernels; no GPU tile is sized from it.
_FUSED_BWD_VMEM_BUDGET = 6 * 2 ** 20
# the routing predicate's GQA limit (flash_attention_raw: h // kvh <= 8)
MAX_REP = 8

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# shared memory a block may use on the H100 (dynamic, after opt-in)
_SMEM_LIMIT = 227 * 1024

#: kernel launches per launcher, counted where each wrapper launches
LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0,
                            "flash_attention_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------- routing and layouts

def _clamp_block(block: int, seq: int) -> int:
    """Mirror of ``flash_attention._clamp_block``: a block clipped to a
    shorter sequence rounds up to a multiple of 128."""
    if seq >= block:
        return block
    return -(-seq // 128) * 128


def hb_bwd_blocks(rep: int, sq: int, sk: int,
                  d: int) -> Optional[Tuple[int, int]]:
    """Admissibility rule of the TPU's fused HB backward
    (``flash_attention._hb_bwd_blocks``): its (block_q, block_k), or None
    when the full-sequence dk/dv scratch would not fit the TPU budget.
    The port routes by it and sizes nothing from it."""
    block_q, block_k = 512, 512
    while rep * block_q * block_k > 512 * 512 and \
            (block_q > 128 or block_k > 128):
        if block_q >= block_k and block_q > 128:
            block_q //= 2
        else:
            block_k //= 2
    block_q = _clamp_block(block_q, sq)
    block_k = _clamp_block(block_k, sk)
    sk_pad = -(-sk // block_k) * block_k
    if 2 * sk_pad * d * 4 > _FUSED_BWD_VMEM_BUDGET:
        return None
    return block_q, block_k


def to_hb(q, k, v, h: int, kvh: int):
    """[b, s, h, d] q + [b, sk, kvh, d] k/v -> contiguous HB layouts
    (mirror of ``flash_attention._to_hb``; q heads are group-major, so
    head g*rep + r belongs to kv head g)."""
    b, s, _, d = q.shape
    rep = h // kvh
    qhb = q.transpose(1, 2).reshape(b * kvh, rep, s, d).contiguous()
    khb = k.transpose(1, 2).reshape(b * kvh, k.shape[1], d).contiguous()
    vhb = v.transpose(1, 2).reshape(b * kvh, v.shape[1], d).contiguous()
    return qhb, khb, vhb


def from_hb(ohb, b: int):
    """Inverse of ``to_hb`` for q-shaped tensors: [b*kvh, rep, s, d] ->
    [b, s, h, d] (a view)."""
    bkv, rep, s, d = ohb.shape
    return ohb.reshape(b, (bkv // b) * rep, s, d).transpose(1, 2)


# ------------------------------------------------------------ plain versions

def _scores_plain(q, k, causal, scale):
    """fp32 scores [bkv, rep, sq, sk] with the kernels' NEG_INF mask."""
    s = torch.einsum("grqd,gkd->grqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[2], k.shape[1]
        keep = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    return s


def hb_flash_forward_plain(q, k, v, causal: bool, scale: float):
    """Plain PyTorch ``hb_flash_forward``, with the TPU kernel's semantics:
    fp32 scores and softmax state, p rounded to v's dtype before an fp32
    PV sum, ``lse = m + log l`` (l the sum of the unrounded p), and a row
    that sees no key gets o = 0, lse = +1e30.  It rounds p against the
    row's final max; the kernels round it against the running max of their
    k tile loop (identical when one tile covers the row)."""
    sk = k.shape[1]
    if sk == 0:
        bkv, rep, sq, _ = q.shape
        return (torch.zeros_like(q),
                torch.full((bkv, rep, sq), -NEG_INF, device=q.device))
    s = _scores_plain(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("grqk,gkd->grqd", p.to(v.dtype).float(), v.float())
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    valid = m > NEG_INF * 0.5
    o = torch.where(valid, acc / l, torch.zeros_like(acc)).to(q.dtype)
    lse = torch.where(valid, m + torch.log(l),
                      torch.full_like(m, -NEG_INF))
    return o, lse[..., 0]


def hb_flash_backward_plain(q, k, v, o, lse, do, causal: bool, scale: float):
    """Plain PyTorch ``hb_flash_backward`` (the TPU kernel's rounding
    points): p = exp(s - lse) in fp32, delta = rowsum(do * o), ds = p *
    (dp - delta) * scale; dq = ds(k's dtype) @ k, dv = sum over the group
    of p(do's dtype)^T @ do, dk = sum of ds(q's dtype)^T @ q, all summed
    in fp32 and cast to their input's dtype at the end."""
    s = _scores_plain(q, k, causal, scale)
    p = torch.exp(s - lse.float()[..., None])
    delta = (do.float() * o.float()).sum(dim=-1)
    dp = torch.einsum("grqd,gkd->grqk", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("grqk,gkd->grqd", ds.to(k.dtype).float(), k.float())
    dv = torch.einsum("grqk,grqd->gkd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("grqk,grqd->gkd", ds.to(q.dtype).float(), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------ wrappers

def _check(name, q, k, v, *rest):
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported "
                        f"(float32 or bfloat16)")
    if q.dim() != 4 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"{name}: bad ranks/shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    if k.shape[0] != q.shape[0] or k.shape[2] != q.shape[3]:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree on groups or head dim")
    for t in (k, v, *rest):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {q.device}")
    return q.device.type


def _check_cuda(name, tensors, dtype, d):
    for what, t in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {what} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not supported "
                         f"({SUPPORTED_HEAD_DIMS})")


def _stream():
    return torch.cuda.current_stream().cuda_stream


def kernel_tiles(kind: str, rep: int, d: int, dtype: torch.dtype):
    """(block_q, block_k) of a CUDA launch: the CTA covers rep * block_q
    query rows (all heads of a group at the same positions) against
    block_k keys per loop trip.  block_q is a multiple of 16 (the bf16
    tensor-core tile) with rep * block_q near 64 rows; block_k halves until the block's
    shared memory (``smem_bytes``, the formula of csrc/flash_attention.cu)
    fits the card."""
    block_q = max(16, 64 // rep // 16 * 16)
    block_k = 64
    while smem_bytes(kind, rep * block_q, block_k, d, dtype) > _SMEM_LIMIT:
        if block_k > 16:
            block_k //= 2
        elif block_q > 8 and dtype == torch.float32:
            block_q //= 2                      # CUDA-core path: no 16-row tile
        else:
            raise ValueError(f"flash attention {kind}: rep {rep}, d {d} does "
                             f"not fit one CTA's shared memory")
    return block_q, block_k


def smem_bytes(kind: str, m: int, bk: int, d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one CTA, as csrc/flash_attention.cu lays it
    out (rows padded by 8 elements against bank conflicts)."""
    t = 2 if dtype == torch.bfloat16 else 4
    ld_d, ld_k = d + 8, bk + 8
    if kind == "fwd":
        # q [m, d], k/v [bk, d], scores fp32 [m, bk], p [m, bk],
        # o fp32 [m, d], m/l/alpha fp32 [m]
        return (t * (m + 2 * bk) * ld_d + 4 * m * ld_k + t * m * ld_k
                + 4 * m * ld_d + 4 * 3 * m)
    if kind == "dq":
        # q/do [m, d], k/v [bk, d], s/dp fp32 [m, bk], ds [m, bk],
        # dq fp32 [m, d], lse/delta [m]
        return (t * (2 * m + 2 * bk) * ld_d + 8 * m * ld_k + t * m * ld_k
                + 4 * m * ld_d + 8 * m)
    if kind == "dkv":
        # q/do [m, d], k/v [bk, d], s/dp fp32 [m, bk], p/ds [m, bk],
        # dk/dv fp32 [bk, d], lse/delta [m]
        return (t * (2 * m + 2 * bk) * ld_d + 8 * m * ld_k
                + 2 * t * m * ld_k + 8 * bk * ld_d + 8 * m)
    raise ValueError(kind)


def hb_flash_forward(q, k, v, causal: bool = True,
                     scale: Optional[float] = None):
    """Head-batched flash attention forward (mirrors ``_hb_flash_forward``).
    q [b*kvh, rep, sq, d]; k/v [b*kvh, sk, d], one dtype (float32 or
    bfloat16).  Returns (o [b*kvh, rep, sq, d] in q's dtype, lse
    [b*kvh, rep, sq] fp32)."""
    dev = _check("hb_flash_forward", q, k, v)
    bkv, rep, sq, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    if dev == "cpu":
        return hb_flash_forward_plain(q, k, v, causal, scale)
    _check_cuda("hb_flash_forward", {"q": q, "k": k, "v": v}, q.dtype, d)
    o = torch.empty_like(q)
    lse = torch.empty((bkv, rep, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    bq, bk = kernel_tiles("fwd", rep, d, q.dtype)
    lib = _build.library()
    rc = lib.pt_hb_flash_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bkv, rep, sq, sk, d, bq, bk, int(causal),
        scale, _DTYPE_CODES[q.dtype], _stream())
    _build.check(lib, rc, "hb_flash_forward")
    LAUNCHES["flash_attention_fwd"] += 1
    return o, lse


def hb_flash_backward(q, k, v, o, lse, do, causal: bool = True,
                      scale: Optional[float] = None):
    """Head-batched flash attention backward (mirrors
    ``_hb_flash_backward``): returns (dq [b*kvh, rep, sq, d], dk, dv
    [b*kvh, sk, d]) with dk/dv summed over the rep heads of each group.
    delta = rowsum(do * o) is one PyTorch reduction before the kernels, as
    the TPU launcher computes it outside its kernel.  One launch of this
    wrapper runs two kernels: dk/dv per k tile, then dq per q tile."""
    dev = _check("hb_flash_backward", q, k, v, o, lse, do)
    bkv, rep, sq, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    if o.shape != q.shape or do.shape != q.shape \
            or lse.shape != (bkv, rep, sq):
        raise ValueError(f"hb_flash_backward: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)}, lse {tuple(lse.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if dev == "cpu":
        return hb_flash_backward_plain(q, k, v, o, lse, do, causal, scale)
    _check_cuda("hb_flash_backward", {"q": q, "k": k, "v": v, "o": o,
                                      "do": do}, q.dtype, d)
    _check_cuda("hb_flash_backward", {"lse": lse}, torch.float32, d)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = (do.float() * o.float()).sum(dim=-1)       # [bkv, rep, sq]
    bq_kv, bk_kv = kernel_tiles("dkv", rep, d, q.dtype)
    bq_q, bk_q = kernel_tiles("dq", rep, d, q.dtype)
    lib = _build.library()
    rc = lib.pt_hb_flash_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), bkv, rep, sq, sk, d, bq_kv, bk_kv, bq_q, bk_q,
        int(causal), scale, _DTYPE_CODES[q.dtype], _stream())
    _build.check(lib, rc, "hb_flash_backward")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class _FlashHB(torch.autograd.Function):
    """Mirror of the ``_flash_hb`` custom_vjp (``_flash_hb_fwd`` /
    ``_flash_hb_bwd``): saves (q, k, v, o, lse); the backward is
    ``hb_flash_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = hb_flash_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = hb_flash_backward(q, k, v, o, lse, do.contiguous(),
                                       ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def _unported(what: str):
    return NotImplementedError(
        f"flash_attention: {what} takes the masked per-head kernels "
        f"(B5 _flash_kernel, B6 _flash_bwd_*), a later slice of the port")


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None, q_segment_ids=None,
                    kv_segment_ids=None, blocks=None, mask_bands=None):
    """Mirror of ``flash_attention_raw``: q [b, s, h, d], k/v
    [b, sk, kvh, d] (kvh divides h, heads group-major) -> [b, s, h, d].
    The default scale is 1/sqrt(d).  Routed to the HB kernels (``_FlashHB``)
    under the TPU entry's predicate; every other call raises."""
    if q_segment_ids is not None or kv_segment_ids is not None:
        raise _unported("segment ids")
    if mask_bands is not None:
        raise _unported("FlashMask bands")
    if blocks is not None:
        raise _unported("an explicit (block_q, block_k)")
    b, s, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if h % kvh != 0:
        raise ValueError(f"q heads {h} not a multiple of kv heads {kvh}")
    if h // kvh > MAX_REP:
        raise _unported(f"rep {h // kvh} > {MAX_REP}")
    if sk != s:
        raise _unported(f"sk {sk} != s {s}")
    if hb_bwd_blocks(h // kvh, s, sk, d) is None:
        raise _unported(f"sequence {s} (the HB backward scratch rule)")
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    qhb, khb, vhb = to_hb(q, k, v, h, kvh)
    return from_hb(_FlashHB.apply(qhb, khb, vhb, bool(causal), scale), b)
