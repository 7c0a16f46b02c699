"""Flash attention: the training forward and backward, head-batched and masked.

Port of ``paddle_tpu/ops/pallas/flash_attention.py``.  Two kernel families:

- the head-batched (HB) path, the one ``flash_attention_raw`` takes for
  unmasked GQA attention: ``hb_flash_forward`` mirrors ``_hb_flash_forward``
  (TPU body ``_hb_flash_kernel``, B1): q [b*kvh, rep, s, d], k/v
  [b*kvh, sk, d] -> o [b*kvh, rep, s, d] (q's dtype) and lse [b*kvh, rep, s]
  fp32; ``hb_flash_backward`` mirrors ``_hb_flash_backward`` (TPU body
  ``_hb_bwd_kernel``, B2) -> dq and dk, dv summed over each group's rep
  heads; ``_FlashHB`` mirrors the ``_flash_hb`` custom_vjp;
- the masked per-head path for everything else (segment ids, FlashMask
  bands, explicit ``blocks``, rep > 8, sk != s, long sequences):
  ``flash_forward`` mirrors ``_flash_forward`` (TPU body ``_flash_kernel``,
  B5) and ``flash_backward`` mirrors ``_flash_backward`` (B6: the fused
  one-pass kernel where ``flash_bwd_route`` says the TPU runs it, else the
  dq and dk/dv kernels; ``masked_fwd_route`` and ``masked_bwd_route`` pick
  wgmma or shared-memory kernels), both over the compressed live-tile lists of
  ``_live_tables``/``_compress_live``; q/o [b*h, sq, d], k/v [b*kvh, sk, d],
  lse [b*h, sq]; ``_Flash`` mirrors the ``_flash`` custom_vjp.

``flash_attention`` mirrors ``flash_attention_raw``'s routing between the
two; ``segment_ids_from_cu_seqlens``, ``flash_attn_unpadded_raw``,
``varlen_block_skip_fraction`` and ``flash_attention_auto`` (the
padding-fraction threshold of ``PACKED_PADDING_CROSSOVER``; the autotuner is
not ported) are the varlen entries.

The TPU kernels write lse as [.., 8, s]: the 8-row broadcast is TPU sublane
padding, so the port keeps [.., s].

Each launcher is a registered operator (``ops/_registry.py``:
``hb_flash_fwd``, ``hb_flash_bwd``, ``masked_flash_fwd``,
``masked_flash_bwd``): on a CUDA tensor its implementation runs the
hand-written kernel (``csrc/flash_attention.cu`` for B1/B2,
``csrc/masked_flash_attention.cu`` for B5/B6) and counts the launch in
``LAUNCHES``; on a CPU tensor it runs the ``*_plain`` PyTorch version
beside it; on fake tensors (a Graph Doctor capture) it gives the output
shapes and runs nothing.  There is no other route: a tensor on any other
device raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _build, _registry

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
# the bf16 forward on wgmma (csrc/flash_attention.cu hb_fwd_wgmma_kernel):
# its head dims, rows per CTA and keys per k tile
WGMMA_FWD_HEAD_DIMS = (64, 128)
WGMMA_FWD_ROWS, WGMMA_FWD_BK = 128, 64
# the bf16 backward on wgmma (hb_dkv_wgmma_kernel, hb_dq_wgmma_kernel): the
# same head dims; a dk/dv CTA covers 128 keys against q tiles of 64 rows, a
# dq CTA 128 q rows against k tiles of 64 keys
WGMMA_BWD_ROWS, WGMMA_BWD_TILE = 128, 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# shared memory a block may use on the H100 (dynamic, after opt-in)
_SMEM_LIMIT = 227 * 1024

#: kernel launches per launcher, counted where each wrapper launches
LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0,
                            "flash_attention_bwd": 0,
                            "flash_masked_fwd": 0,
                            "flash_masked_bwd_fused": 0,
                            "flash_masked_bwd_dq": 0,
                            "flash_masked_bwd_dkv": 0}


class FlashUnsupportedError(ValueError):
    """Mirror of ``flash_attention.FlashUnsupportedError``: a shape or
    configuration outside the kernels' envelope (q heads not a multiple of
    kv heads; causal with sq != sk).  A ``ValueError``, so callers that
    catch either behave alike in both packages."""


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

def _causal_keep(sq: int, sk: int, device) -> torch.Tensor:
    """[sq, sk] bool: query position i sees key j iff i >= j."""
    return (torch.arange(sq, device=device)[:, None]
            >= torch.arange(sk, device=device)[None, :])


def _scores_plain(q, k, keep, scale):
    """fp32 scores [g, rep, sq, sk] with the kernels' NEG_INF mask where
    ``keep`` (bool, broadcast to the scores; None keeps all) is False."""
    s = torch.einsum("grqd,gkd->grqk", q.float(), k.float()) * scale
    if keep is not None:
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    return s


def _attend_plain(s, v, dtype):
    """(o, lse) from masked fp32 scores s [g, rep, sq, sk] and v [g, sk, d],
    with the TPU kernels' semantics: p rounded to v's dtype before an fp32
    PV sum, ``lse = m + log l`` (l the sum of the unrounded p), and a row
    that sees no key gets o = 0, lse = +1e30.  p is rounded against the
    row's final max; the kernels round it against the running max of their
    k tile loop (identical when one tile covers the row)."""
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("grqk,gkd->grqd", p.to(v.dtype).float(), v.float())
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    valid = m > NEG_INF * 0.5
    o = torch.where(valid, acc / l, torch.zeros_like(acc)).to(dtype)
    lse = torch.where(valid, m + torch.log(l),
                      torch.full_like(m, -NEG_INF))
    return o, lse[..., 0]


def _grads_plain(s, q, k, v, o, lse, do, scale):
    """(dq, dk, dv) from masked fp32 scores s [g, rep, sq, sk] at the TPU
    kernels' rounding points: p = exp(s - lse) in fp32, delta = rowsum(do
    * o), ds = p * (dp - delta) * scale; dq = ds(k's dtype) @ k, dv = sum
    over the group of p(do's dtype)^T @ do, dk = sum of ds(q's dtype)^T @
    q, all summed in fp32 and cast to their input's dtype at the end."""
    p = torch.exp(s - lse.float()[..., None])
    delta = (do.float() * o.float()).sum(dim=-1)
    dp = torch.einsum("grqd,gkd->grqk", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("grqk,gkd->grqd", ds.to(k.dtype).float(), k.float())
    dv = torch.einsum("grqk,grqd->gkd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("grqk,grqd->gkd", ds.to(q.dtype).float(), q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def hb_flash_forward_plain(q, k, v, causal: bool, scale: float):
    """Plain PyTorch ``hb_flash_forward`` (``_attend_plain`` over the
    causal or full scores)."""
    sk = k.shape[1]
    if sk == 0:
        bkv, rep, sq, _ = q.shape
        return (torch.zeros_like(q),
                torch.full((bkv, rep, sq), -NEG_INF, device=q.device))
    keep = _causal_keep(q.shape[2], sk, q.device) if causal else None
    return _attend_plain(_scores_plain(q, k, keep, scale), v, q.dtype)


def hb_flash_backward_plain(q, k, v, o, lse, do, causal: bool, scale: float):
    """Plain PyTorch ``hb_flash_backward`` (``_grads_plain``)."""
    keep = _causal_keep(q.shape[2], k.shape[1], q.device) if causal else None
    return _grads_plain(_scores_plain(q, k, keep, scale), q, k, v, o, lse,
                        do, scale)


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


def fwd_route(d: int, dtype: torch.dtype) -> str:
    """Which CUDA kernel runs the forward, by an explicit rule on the head
    dim and dtype: ``"wgmma"`` (``hb_fwd_wgmma_kernel``: TMA ring, wgmma,
    register accumulators) for bf16 at d 64 and 128, every Llama shape of
    the repo; ``"smem"`` (``hb_fwd_kernel``: shared-memory accumulators,
    wmma for bf16, CUDA cores for fp32) for bf16 at d 16 and 32 and for
    fp32."""
    if dtype == torch.bfloat16 and d in WGMMA_FWD_HEAD_DIMS:
        return "wgmma"
    return "smem"


def bwd_route(d: int, dtype: torch.dtype) -> str:
    """Which CUDA kernels run the backward, by the forward's rule:
    ``"wgmma"`` (``hb_dkv_wgmma_kernel`` + ``hb_dq_wgmma_kernel``: TMA ring,
    wgmma, register accumulators) for bf16 at d 64 and 128; ``"smem"``
    (``hb_dkv_kernel`` + ``hb_dq_kernel``: shared-memory accumulators, wmma
    for bf16, CUDA cores for fp32) for bf16 at d 16 and 32 and for fp32."""
    return fwd_route(d, dtype)


def wgmma_bwd_tiles(rep: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((block_q, block_k) of the dk/dv kernel, (block_q, block_k) of the
    dq kernel) on wgmma: dk/dv takes q tiles of 64 // rep positions x rep
    heads (at most 64 rows) against its CTA's 128 keys; dq takes 128 // rep
    positions x rep heads (at most 128 rows) against k tiles of 64 keys.
    Rows past rep * block_q stay idle when rep does not divide 64 or 128."""
    return ((WGMMA_BWD_TILE // rep, WGMMA_BWD_ROWS),
            (WGMMA_BWD_ROWS // rep, WGMMA_BWD_TILE))


def wgmma_fwd_tiles(rep: int) -> Tuple[int, int]:
    """(block_q, block_k) of the wgmma forward: the CTA's 128 rows (two
    warpgroups of 64) hold rep heads at block_q = 128 // rep positions
    (rows past rep * block_q stay idle when rep does not divide 128),
    against k tiles of 64 keys."""
    return WGMMA_FWD_ROWS // rep, WGMMA_FWD_BK


def hb_flash_forward(q, k, v, causal: bool = True,
                     scale: Optional[float] = None):
    """Head-batched flash attention forward (mirrors ``_hb_flash_forward``).
    q [b*kvh, rep, sq, d]; k/v [b*kvh, sk, d], one dtype (float32 or
    bfloat16).  Returns (o [b*kvh, rep, sq, d] in q's dtype, lse
    [b*kvh, rep, sq] fp32).  The operator ``hb_flash_fwd``: on the card
    ``fwd_route`` picks the kernel before the launch; the wgmma kernel also
    needs 16-byte aligned q, k, v (TMA) and raises otherwise."""
    dev = _check("hb_flash_forward", q, k, v)
    d = q.shape[3]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    if dev == "cuda":
        _check_cuda("hb_flash_forward", {"q": q, "k": k, "v": v}, q.dtype, d)
    return _HB_FWD(q, k, v, bool(causal), scale)


def _hb_fwd_cpu(q, k, v, causal, scale):
    return hb_flash_forward_plain(q, k, v, causal, scale)


def _hb_fwd_cuda(q, k, v, causal, scale):
    bkv, rep, sq, d = q.shape
    sk = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((bkv, rep, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, lse
    if sk == 0:                 # no key: every row is o = 0, lse = +1e30
        return o.zero_(), lse.fill_(-NEG_INF)
    wgmma = fwd_route(d, q.dtype) == "wgmma"
    bq, bk = (wgmma_fwd_tiles(rep) if wgmma
              else kernel_tiles("fwd", rep, d, q.dtype))
    lib = _build.library()
    rc = lib.pt_hb_flash_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bkv, rep, sq, sk, d, bq, bk, int(causal),
        scale, _DTYPE_CODES[q.dtype], int(wgmma), _stream())
    _build.check(lib, rc, "hb_flash_forward")
    LAUNCHES["flash_attention_fwd"] += 1
    return o, lse


def _hb_fwd_fake(q, k, v, causal, scale):
    bkv, rep, sq, _ = q.shape
    return torch.empty_like(q), q.new_empty((bkv, rep, sq),
                                            dtype=torch.float32)


_HB_FWD = _registry.define(
    "hb_flash_fwd", "(Tensor q, Tensor k, Tensor v, bool causal, "
    "float scale) -> (Tensor, Tensor)", kernel="B1", cpu=_hb_fwd_cpu,
    cuda=_hb_fwd_cuda, fake=_hb_fwd_fake)


def hb_flash_backward(q, k, v, o, lse, do, causal: bool = True,
                      scale: Optional[float] = None):
    """Head-batched flash attention backward (mirrors
    ``_hb_flash_backward``): returns (dq [b*kvh, rep, sq, d], dk, dv
    [b*kvh, sk, d]) with dk/dv summed over the rep heads of each group.
    The operator ``hb_flash_bwd``: delta = rowsum(do * o) is one PyTorch
    reduction before the kernels, as the TPU launcher computes it outside
    its kernel.  One launch of this wrapper runs two kernels, chosen by
    ``bwd_route``: dk/dv per k tile, then dq per q tile.  The wgmma pair
    also needs 16-byte aligned q, k, v and do (TMA) and raises
    otherwise."""
    dev = _check("hb_flash_backward", q, k, v, o, lse, do)
    bkv, rep, sq, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    if o.shape != q.shape or do.shape != q.shape \
            or lse.shape != (bkv, rep, sq):
        raise ValueError(f"hb_flash_backward: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)}, lse {tuple(lse.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if dev == "cuda":
        _check_cuda("hb_flash_backward", {"q": q, "k": k, "v": v, "o": o,
                                          "do": do}, q.dtype, d)
        _check_cuda("hb_flash_backward", {"lse": lse}, torch.float32, d)
    return _HB_BWD(q, k, v, o, lse, do, bool(causal), scale)


def _hb_bwd_cpu(q, k, v, o, lse, do, causal, scale):
    return hb_flash_backward_plain(q, k, v, o, lse, do, causal, scale)


def _hb_bwd_cuda(q, k, v, o, lse, do, causal, scale):
    bkv, rep, sq, d = q.shape
    sk = k.shape[1]
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = (do.float() * o.float()).sum(dim=-1)       # [bkv, rep, sq]
    wgmma = bwd_route(d, q.dtype) == "wgmma"
    if wgmma:
        (bq_kv, bk_kv), (bq_q, bk_q) = wgmma_bwd_tiles(rep)
    else:
        bq_kv, bk_kv = kernel_tiles("dkv", rep, d, q.dtype)
        bq_q, bk_q = kernel_tiles("dq", rep, d, q.dtype)
    lib = _build.library()
    rc = lib.pt_hb_flash_backward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), bkv, rep, sq, sk, d, bq_kv, bk_kv, bq_q, bk_q,
        int(causal), scale, _DTYPE_CODES[q.dtype], int(wgmma), _stream())
    _build.check(lib, rc, "hb_flash_backward")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


def _hb_bwd_fake(q, k, v, o, lse, do, causal, scale):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _delta_scratch(q, o, do, *rest):
    """delta = rowsum(do * o) of a backward: do and o widened to fp32 (a
    copy unless already fp32), their product, then the [.., sq] sum, all
    live together at the sum."""
    n = q.numel()
    wide = 0 if q.dtype == torch.float32 else 2 * 4 * n
    return wide + 4 * n + 4 * (n // max(q.shape[-1], 1))


_HB_BWD = _registry.define(
    "hb_flash_bwd", "(Tensor q, Tensor k, Tensor v, Tensor o, Tensor lse, "
    "Tensor do, bool causal, float scale) -> (Tensor, Tensor, Tensor)",
    kernel="B2", cpu=_hb_bwd_cpu, cuda=_hb_bwd_cuda, fake=_hb_bwd_fake,
    scratch=lambda q, k, v, o, lse, do, *a: _delta_scratch(q, o, do))


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


# ------------------------------------------- masked path: live-tile tables

def _live_tables(b: int, mask_h: int, nq: int, nk: int, block_q: int,
                 block_k: int, seq_q: int, seq_k: int, causal: bool,
                 q_seg=None, k_seg=None, bands=None, device=None):
    """Mirror of ``flash_attention._live_tables``: live [gb, nq, nk] bool,
    True where the (q tile, k tile) pair can hold an unmasked entry, with
    one gate row per (batch entry, mask head), gb = b * mask_h with bands
    and b otherwise.  The tests are the TPU's: causal by tile corners; the
    interval test on segment ids (ids ascend along a packed row, so it is
    exact there and conservative otherwise, negative ids included); and
    the band cover (a tile is dead iff for every valid key column the bands
    [lts, lte) u [uts, ute) cover the tile's rows, alone or joined,
    ``join1``/``join2``).  Computed on the device, without a host sync."""
    if device is None:
        device = (q_seg if q_seg is not None else
                  bands[0] if bands is not None else torch.empty(0)).device
    qi = torch.arange(nq, device=device)
    ki = torch.arange(nk, device=device)
    live = torch.ones((1, nq, nk), dtype=torch.bool, device=device)
    if causal:
        live = live & ((qi[:, None] + 1) * block_q - 1
                       >= ki[None, :] * block_k)[None]
    if q_seg is not None:
        big = 2 ** 30

        def _mm(seg, nb, blk, seq):
            seg = seg.to(torch.int32)
            pad = nb * blk - seq
            lo = F.pad(seg, (0, pad), value=big)
            hi = F.pad(seg, (0, pad), value=-big)
            return (lo.reshape(-1, nb, blk).amin(-1),
                    hi.reshape(-1, nb, blk).amax(-1))

        qmn, qmx = _mm(q_seg, nq, block_q, seq_q)
        kmn, kmx = _mm(k_seg, nk, block_k, seq_k)
        ov = ((qmn[:, :, None] <= kmx[:, None, :])
              & (qmx[:, :, None] >= kmn[:, None, :]))          # [b, nq, nk]
        if mask_h > 1:
            ov = ov.repeat_interleave(mask_h, dim=0)
        live = live & ov
    if bands is not None:
        lts, lte, uts, ute = (x.to(torch.int32).reshape(b * mask_h, 1, -1)
                              for x in bands)                  # [gb, 1, sk]
        q_lo = (qi * block_q)[None, :, None]                   # [1, nq, 1]
        q_hi = torch.clamp((qi + 1) * block_q, max=seq_q)[None, :, None]
        lt_cov = (lts <= q_lo) & (lte >= q_hi)
        ut_cov = (uts <= q_lo) & (ute >= q_hi)
        join1 = (lts <= q_lo) & (uts <= lte) & (ute >= q_hi)
        join2 = (uts <= q_lo) & (lts <= ute) & (lte >= q_hi)
        cov = lt_cov | ut_cov | join1 | join2                  # [gb, nq, sk]
        pad = nk * block_k - cov.shape[-1]
        cov = torch.cat([cov, cov.new_ones(cov.shape[:-1] + (pad,))], -1)
        live = live & ~cov.reshape(cov.shape[0], nq, nk, block_k).all(-1)
    gb = b * (mask_h if bands is not None else 1)
    if live.shape[0] == 1 and gb > 1:
        live = live.expand(gb, nq, nk)
    assert live.shape[0] == gb, (tuple(live.shape), gb)
    return live


def _compress_live(live):
    """Mirror of ``flash_attention._compress_live``: live [gb, nq, nk] ->
    (count [gb, nq], idx [gb, nq, nk]) int32: the live column indices
    first, ascending, then dead slots repeating the last live one (a count
    of 0 points at tile 0)."""
    nk = live.shape[-1]
    col = torch.arange(nk, device=live.device)[None, None, :]
    count = live.sum(-1, dtype=torch.int32)
    order = torch.argsort(torch.where(live, col, nk + col), dim=-1)
    jsel = torch.minimum(col, torch.clamp(count[..., None] - 1, min=0))
    return count, torch.gather(order, -1, jsel).to(torch.int32)


def flash_bwd_route(sq: int, sk: int, d: int, blocks=None) -> str:
    """Which backward the TPU launcher ``_flash_backward`` runs: ``"fused"``
    (``_flash_bwd_fused_kernel``) when its full-sequence dk/dv scratch
    (2 * sk_pad * d * 4 bytes) fits ``_FUSED_BWD_VMEM_BUDGET``, else
    ``"split"`` (``_flash_bwd_dq_kernel`` + ``_flash_bwd_dkv_kernel``).
    Mirrors its block defaults (512, or ``blocks``), ``_clamp_block`` and the
    tile-area clamp; the budget is read at call time.  The port launches its
    fused kernel exactly where the TPU launches its own, and sizes no GPU
    tile from the TPU budget."""
    block_q, block_k = (512, 512) if blocks is None else blocks
    block_q = _clamp_block(block_q, sq)
    block_k = _clamp_block(block_k, sk)
    while block_q * block_k > 512 * 1024 and (block_q > 128 or block_k > 128):
        if block_k >= block_q and block_k > 128:
            block_k //= 2
        else:
            block_q //= 2
    sk_pad = -(-sk // block_k) * block_k
    fits = 2 * sk_pad * d * 4 <= _FUSED_BWD_VMEM_BUDGET
    return "fused" if fits else "split"


# ------------------------------------------- masked path: plain versions

def _group_keep(g: int, kvh: int, sq: int, sk: int, causal: bool, q_seg,
                k_seg, bands, mask_h: int, device):
    """[sq, sk] bool keep mask of GQA group g (batch g // kvh, kv head
    g % kvh): causal, equal segment ids, and outside the bands of its mask
    head (kv head // (kvh // mask_h))."""
    bi, kv = divmod(g, kvh)
    keep = (_causal_keep(sq, sk, device) if causal
            else torch.ones(sq, sk, dtype=torch.bool, device=device))
    if q_seg is not None:
        keep = keep & (q_seg[bi][:, None] == k_seg[bi][None, :])
    if bands is not None:
        row = kv // (kvh // mask_h)
        lts, lte, uts, ute = (x[bi, row][None, :] for x in bands)
        rows = torch.arange(sq, device=device)[:, None]
        keep = keep & ~(((rows >= lts) & (rows < lte))
                        | ((rows >= uts) & (rows < ute)))
    return keep


def flash_forward_plain(q, k, v, causal: bool, scale: float, h: int,
                        kvh: int, q_seg=None, k_seg=None, bands=None,
                        mask_h: int = 1):
    """Plain PyTorch ``flash_forward``: dense masked attention, one GQA
    group at a time (bounding memory at long sequences), with
    ``_attend_plain``'s semantics (a row that sees no key: o = 0,
    lse = +1e30).  q [b*h, sq, d]; k/v [b*kvh, sk, d] -> (o [b*h, sq, d],
    lse [b*h, sq] fp32)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    rep = h // kvh
    if sk == 0:
        return (torch.zeros_like(q),
                torch.full((bh, sq), -NEG_INF, device=q.device))
    qg = q.reshape(bh // rep, rep, sq, d)
    o = torch.empty_like(qg)
    lse = torch.empty((bh // rep, rep, sq), dtype=torch.float32,
                      device=q.device)
    for g in range(bh // rep):
        keep = _group_keep(g, kvh, sq, sk, causal, q_seg, k_seg, bands,
                           mask_h, q.device)
        o[g:g + 1], lse[g:g + 1] = _attend_plain(
            _scores_plain(qg[g:g + 1], k[g:g + 1], keep, scale),
            v[g:g + 1], q.dtype)
    return o.reshape(bh, sq, d), lse.reshape(bh, sq)


def flash_backward_plain(q, k, v, o, lse, do, causal: bool, scale: float,
                         h: int, kvh: int, q_seg=None, k_seg=None,
                         bands=None, mask_h: int = 1):
    """Plain PyTorch ``flash_backward`` (``_grads_plain`` per GQA group):
    (dq [b*h, sq, d], dk, dv [b*kvh, sk, d]), dk/dv summed over the
    group.  Either TPU route (fused, or dq + dkv) computes this function."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    rep = h // kvh
    dq = torch.empty_like(q).reshape(bh // rep, rep, sq, d)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for g in range(bh // rep):
        keep = _group_keep(g, kvh, sq, sk, causal, q_seg, k_seg, bands,
                           mask_h, q.device)
        rows = slice(g * rep, (g + 1) * rep)
        dq[g:g + 1], dk[g:g + 1], dv[g:g + 1] = _grads_plain(
            _scores_plain(q[rows][None], k[g:g + 1], keep, scale),
            q[rows][None], k[g:g + 1], v[g:g + 1], o[rows][None],
            lse[rows][None], do[rows][None], scale)
    return dq.reshape(bh, sq, d), dk, dv


# ------------------------------------------------ masked path: CUDA launch

# kernel kinds and argument order of csrc/masked_flash_attention.cu's
# pt_masked_flash
MASKED_KINDS = {"fwd": 0, "dq": 1, "dkv": 2, "fused": 3}
_MASKED_PTRS = ("q", "k", "v", "do", "lse", "delta", "o", "lse_out", "dq",
                "dq_acc", "dk", "dv", "q_seg", "k_seg", "band", "count",
                "idx")
_MASKED_INTS = ("batch", "kvh", "rep", "hpc", "sq", "sk", "d", "bq", "bk",
                "mask_h", "gate_h", "n_outer", "n_inner", "causal")


def masked_smem_bytes(kind: str, m: int, bq: int, bk: int, d: int,
                      dtype: torch.dtype) -> int:
    """Dynamic shared memory of one masked-kernel CTA (m = heads per CTA x
    bq rows), as csrc/masked_flash_attention.cu lays it out: the HB layouts
    of ``smem_bytes`` plus the mask rows (bq query ids, bk key ids, 4 x bk
    band bounds); the fused dk/dv pass keeps its fp32 dq tile in the score
    region."""
    t = 2 if dtype == torch.bfloat16 else 4
    ldd, ldk = d + 8, bk + 8
    masks = 4 * (bq + 5 * bk)
    if kind == "fwd":
        return (t * (m + 2 * bk) * ldd + 4 * m * ldk + t * m * ldk
                + 4 * m * ldd + 12 * m + masks)
    if kind == "dq":
        return (t * (2 * m + 2 * bk) * ldd + 8 * m * ldk + t * m * ldk
                + 4 * m * ldd + 8 * m + masks)
    if kind in ("dkv", "fused"):
        scores = (max(2 * m * ldk, m * ldd) if kind == "fused"
                  else 2 * m * ldk)
        return (t * (2 * m + 2 * bk) * ldd + 4 * scores + 2 * t * m * ldk
                + 8 * bk * ldd + 8 * m + masks)
    raise ValueError(kind)


def masked_tiles(rep: int, d: int, dtype: torch.dtype):
    """(heads per CTA, block_q, block_k) of the masked kernels, one choice
    for all four so that one live table (and its transpose) serves them: a
    CTA covers hpc heads of a group (the largest divisor of rep up to 4) at
    block_q positions, a multiple of 16 with hpc * block_q near 64 rows;
    block_k halves until the fused pass's shared memory, the largest of
    the four, fits the card."""
    hpc = max(c for c in range(1, min(rep, 4) + 1) if rep % c == 0)
    bq, bk = max(16, 64 // hpc // 16 * 16), 64
    while masked_smem_bytes("fused", hpc * bq, bq, bk, d, dtype) > _SMEM_LIMIT:
        if bk <= 16:
            raise ValueError(f"masked flash attention: d {d} does not fit "
                             f"one CTA's shared memory")
        bk //= 2
    return hpc, bq, bk


# the B5 forward and B6 backward on wgmma (csrc/masked_flash_attention.cu
# masked_fwd_wgmma_kernel, masked_dq_wgmma_kernel, masked_dkv_wgmma_kernel
# split and fused): their C kinds, and the most heads a CTA covers (the q
# tile's TMA box)
_MASKED_WGMMA_KINDS = {"fwd_wgmma": 4, "dq_wgmma": 5, "dkv_wgmma": 6,
                       "fused_wgmma": 7}
MASKED_WGMMA_MAX_HPC = 8


def masked_fwd_route(d: int, dtype: torch.dtype) -> str:
    """Which CUDA kernel runs the masked forward (B5), by ``fwd_route``'s
    rule on the head dim and dtype: ``"wgmma"`` (``masked_fwd_wgmma_kernel``:
    TMA ring over the live k tiles, wgmma, register accumulators, the mask
    in registers) for bf16 at d 64 and 128; ``"smem"``
    (``masked_fwd_kernel``: shared-memory accumulators, wmma for bf16, CUDA
    cores for fp32) for bf16 at d 16 and 32 and for fp32."""
    return fwd_route(d, dtype)


def masked_fwd_wgmma_tiles(rep: int) -> Tuple[int, int, int]:
    """(heads per CTA, block_q, block_k) of the wgmma masked forward: the
    CTA's 128 rows (two warpgroups of 64) hold hpc heads, the largest
    divisor of rep up to 8, at block_q = 128 // hpc positions (rows past
    hpc * block_q stay idle when hpc does not divide 128), against k tiles
    of 64 keys.  The forward's live tables are built at these tiles."""
    hpc = max(c for c in range(1, min(rep, MASKED_WGMMA_MAX_HPC) + 1)
              if rep % c == 0)
    return hpc, WGMMA_FWD_ROWS // hpc, WGMMA_FWD_BK


def masked_bwd_route(d: int, dtype: torch.dtype) -> str:
    """Which CUDA kernels run the masked backward (B6), by ``fwd_route``'s
    rule on the head dim and dtype: ``"wgmma"`` (``masked_dkv_wgmma_kernel``,
    fused or split, and ``masked_dq_wgmma_kernel``: TMA ring over the live
    lists, wgmma, register accumulators, the mask in registers) for bf16 at
    d 64 and 128; ``"smem"`` (``masked_dkv_kernel`` and ``masked_dq_kernel``:
    shared-memory accumulators, wmma for bf16, CUDA cores for fp32) for bf16
    at d 16 and 32 and for fp32.  Which of the fused or split routes runs is
    ``flash_bwd_route``'s separate question."""
    return fwd_route(d, dtype)


def masked_bwd_wgmma_tiles(rep: int):
    """((hpc, block_q, block_k) of the dk/dv kernel, (hpc, block_q,
    block_k) of the dq kernel) on wgmma, hpc the largest divisor of rep up
    to 8 (the TMA box's head extent) in both: a dk/dv CTA holds 128 keys
    against ringed q tiles of hpc heads x 64 // hpc positions (at most 64
    rows); a dq CTA holds hpc heads x 128 // hpc positions (at most 128
    rows) against ringed k tiles of 64 keys.  Each kernel's live table is
    built at its own tiles."""
    hpc = masked_fwd_wgmma_tiles(rep)[0]
    return ((hpc, WGMMA_BWD_TILE // hpc, WGMMA_BWD_ROWS),
            (hpc, WGMMA_BWD_ROWS // hpc, WGMMA_BWD_TILE))


def masked_live_lists(tiles, b: int, gate_h: int, sq: int, sk: int,
                      causal: bool, q_seg=None, k_seg=None, bands=None,
                      transposed: bool = False, device=None):
    """The live lists of one masked kernel at its own tiles (hpc, block_q,
    block_k), as its launch takes them: ({count, idx}, {hpc, bq, bk,
    n_outer, n_inner}); ``transposed`` gives each k tile's live q tiles
    (the dk/dv kernels), else each q tile's live k tiles."""
    hpc, bq, bk = tiles
    nq, nk = -(-sq // bq), -(-sk // bk)
    live = _live_tables(b, gate_h, nq, nk, bq, bk, sq, sk, causal, q_seg,
                        k_seg, bands, device=device)
    count, idx = _compress_live(live.transpose(1, 2) if transposed else live)
    outer, inner = (nk, nq) if transposed else (nq, nk)
    return (dict(count=count, idx=idx),
            dict(hpc=hpc, bq=bq, bk=bk, n_outer=outer, n_inner=inner))


def _masked_launch(kind: str, ptrs: dict, ints: dict, scale: float,
                   dtype: torch.dtype) -> None:
    lib = _build.library()
    p = (ctypes.c_void_p * len(_MASKED_PTRS))(
        *[None if ptrs.get(n) is None else ptrs[n].data_ptr()
          for n in _MASKED_PTRS])
    i = (ctypes.c_int * len(_MASKED_INTS))(*[int(ints[n])
                                             for n in _MASKED_INTS])
    code = _MASKED_WGMMA_KINDS.get(kind, MASKED_KINDS.get(kind))
    rc = lib.pt_masked_flash(code, p, i, scale, _DTYPE_CODES[dtype],
                             _stream())
    _build.check(lib, rc, f"masked flash attention ({kind})")


def _check_masked(name, q, k, v, h, kvh, q_seg, k_seg, bands, mask_h,
                  *rest):
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"must be [b*h, s, d] and [b*kvh, sk, d]")
    bh, sq, d = q.shape
    if h <= 0 or kvh <= 0 or h % kvh or bh % h or k.shape[0] * h != bh * kvh:
        raise FlashUnsupportedError(
            f"{name}: q {tuple(q.shape)} with h {h} and k {tuple(k.shape)} "
            f"with kvh {kvh} do not form GQA groups")
    # as the HB launchers' layout [groups, rep, sq, d] for the common checks;
    # the masks must lie on q's device too (the kernels read them)
    masks = [x for x in (q_seg, k_seg, *(bands or ())) if x is not None]
    dev = _check(name, q.reshape(k.shape[0], h // kvh, sq, d), k, v, *rest,
                 *masks)
    if (q_seg is None) != (k_seg is None):
        raise ValueError(f"{name}: q_seg and k_seg must be given together")
    b = bh // h
    if q_seg is not None and (tuple(q_seg.shape) != (b, sq)
                              or tuple(k_seg.shape) != (b, k.shape[1])):
        raise ValueError(f"{name}: segment ids {tuple(q_seg.shape)} / "
                         f"{tuple(k_seg.shape)} do not match [b, s]")
    if bands is not None:
        if mask_h <= 0 or kvh % mask_h or len(bands) != 4 or any(
                tuple(x.shape) != (b, mask_h, k.shape[1]) for x in bands):
            raise ValueError(f"{name}: bands must be 4 x [b, mask_h, sk] with "
                             f"mask_h dividing kvh {kvh}")
    return dev


def _mask_tensors(q_seg, k_seg, bands, b, mask_h, sk):
    """The masks as the kernels take them: int32 contiguous segment ids,
    and the four bands stacked into one [4, b * mask_h, sk]."""
    if q_seg is not None:
        q_seg = q_seg.to(torch.int32).contiguous()
        k_seg = k_seg.to(torch.int32).contiguous()
    band = None
    if bands is not None:
        band = torch.stack([x.to(torch.int32) for x in bands]).reshape(
            4, b * mask_h, sk).contiguous()
    return q_seg, k_seg, band


def flash_forward(q, k, v, causal: bool, scale: Optional[float], h: int,
                  kvh: int, q_seg=None, k_seg=None, bands=None,
                  mask_h: int = 1):
    """Masked flash attention forward (mirrors ``_flash_forward``, TPU body
    ``_flash_kernel``, B5).  q [b*h, sq, d]; k/v [b*kvh, sk, d], one dtype
    (float32 or bfloat16); q_seg [b, sq] and k_seg [b, sk] segment ids;
    bands (lts, lte, uts, ute) each [b, mask_h, sk].  Returns (o
    [b*h, sq, d] in q's dtype, lse [b*h, sq] fp32).  On the card
    ``masked_fwd_route`` picks the kernel and the live tables are built at
    its own tiles (``masked_fwd_wgmma_tiles`` or ``masked_tiles``); the
    wgmma kernel also needs 16-byte aligned q, k, v (TMA) and raises
    otherwise."""
    dev = _check_masked("flash_forward", q, k, v, h, kvh, q_seg, k_seg,
                        bands, mask_h)
    d = q.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    if dev == "cuda":
        _check_cuda("flash_forward", {"q": q, "k": k, "v": v}, q.dtype, d)
    return _MASKED_FWD(q, k, v, bool(causal), scale, int(h), int(kvh), q_seg,
                       k_seg, None if bands is None else list(bands),
                       int(mask_h))


def _masked_fwd_cpu(q, k, v, causal, scale, h, kvh, q_seg, k_seg, bands,
                    mask_h):
    return flash_forward_plain(q, k, v, causal, scale, h, kvh, q_seg, k_seg,
                               None if bands is None else tuple(bands),
                               mask_h)


def _masked_fwd_cuda(q, k, v, causal, scale, h, kvh, q_seg, k_seg, bands,
                     mask_h):
    bh, sq, d = q.shape
    sk = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    if o.numel() == 0 or sk == 0:
        return o.zero_(), lse.fill_(-NEG_INF)
    b, rep = bh // h, h // kvh
    wgmma = masked_fwd_route(d, q.dtype) == "wgmma"
    gate_h = mask_h if bands is not None else 1
    lists, tiles = masked_live_lists(
        masked_fwd_wgmma_tiles(rep) if wgmma
        else masked_tiles(rep, d, q.dtype), b, gate_h, sq, sk, causal, q_seg,
        k_seg, bands, device=q.device)
    qs, ks, band = _mask_tensors(q_seg, k_seg, bands, b, mask_h, sk)
    _masked_launch("fwd_wgmma" if wgmma else "fwd",
                   dict(q=q, k=k, v=v, o=o, lse_out=lse, q_seg=qs, k_seg=ks,
                        band=band, **lists),
                   dict(batch=b, kvh=kvh, rep=rep, sq=sq, sk=sk, d=d,
                        mask_h=mask_h, gate_h=gate_h, causal=causal, **tiles),
                   scale, q.dtype)
    LAUNCHES["flash_masked_fwd"] += 1
    return o, lse


def _masked_fwd_fake(q, k, v, causal, scale, h, kvh, q_seg, k_seg, bands,
                     mask_h):
    bh, sq, _ = q.shape
    return torch.empty_like(q), q.new_empty((bh, sq), dtype=torch.float32)


def _live_list_bytes(tiles, b, gate_h, sq, sk):
    """Device bytes of one kernel's live lists (``masked_live_lists``): the
    bool table [gb, nq, nk], its int32 count [gb, nq] and idx [gb, nq,
    nk], and the int64 argsort order beside them."""
    _, bq, bk = tiles
    nq, nk = -(-sq // bq), -(-sk // bk)
    cells = b * gate_h * nq * nk
    return cells * (1 + 4 + 8) + 4 * b * gate_h * nq


def _mask_bytes(q_seg, k_seg, bands, b, mask_h, sk):
    """The int32 masks ``_mask_tensors`` makes (segment ids cast when not
    int32 already; the four bands stacked)."""
    n = 0
    for x in (q_seg, k_seg):
        if x is not None and x.dtype != torch.int32:
            n += 4 * x.numel()
    if bands is not None:
        n += 4 * 4 * b * mask_h * sk
    return n


def _masked_fwd_scratch(q, k, v, causal, scale, h, kvh, q_seg, k_seg, bands,
                        mask_h):
    bh, sq, d = q.shape
    b, rep = bh // h, h // kvh
    tiles = (masked_fwd_wgmma_tiles(rep)
             if masked_fwd_route(d, q.dtype) == "wgmma"
             else masked_tiles(rep, d, q.dtype))
    gate_h = mask_h if bands is not None else 1
    return (_live_list_bytes(tiles, b, gate_h, sq, k.shape[1])
            + _mask_bytes(q_seg, k_seg, bands, b, mask_h, k.shape[1]))


_MASKED_FWD = _registry.define(
    "masked_flash_fwd", "(Tensor q, Tensor k, Tensor v, bool causal, "
    "float scale, int h, int kvh, Tensor? q_seg, Tensor? k_seg, "
    "Tensor[]? bands, int mask_h) -> (Tensor, Tensor)", kernel="B5",
    cpu=_masked_fwd_cpu, cuda=_masked_fwd_cuda, fake=_masked_fwd_fake,
    scratch=_masked_fwd_scratch)


def flash_backward(q, k, v, o, lse, do, causal: bool, scale: Optional[float],
                   h: int, kvh: int, q_seg=None, k_seg=None, bands=None,
                   mask_h: int = 1, blocks=None):
    """Masked flash attention backward (mirrors ``_flash_backward``, B6):
    (dq [b*h, sq, d], dk, dv [b*kvh, sk, d]), dk/dv summed over each GQA
    group.  On the card, where ``flash_bwd_route`` says ``"fused"`` one
    launch of the fused pass (dq summed with fp32 atomics, so two runs may
    differ at fp32 rounding in dq); else a dq launch over the live k-tile
    lists and a dk/dv launch over the transposed lists (deterministic).
    ``masked_bwd_route`` picks the kernels (wgmma or shared memory) and
    their tiles (``masked_bwd_wgmma_tiles`` or ``masked_tiles``); each
    kernel's live table is built at its own tiles.  The wgmma kernels also
    need 16-byte aligned q, k, v and do (TMA) and raise otherwise.
    delta = rowsum(do * o) is one PyTorch reduction before the kernels, as
    the TPU launcher computes it outside its kernels."""
    dev = _check_masked("flash_backward", q, k, v, h, kvh, q_seg, k_seg,
                        bands, mask_h, o, lse, do)
    bh, sq, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (bh, sq):
        raise ValueError(f"flash_backward: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)}, lse {tuple(lse.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if dev == "cuda":
        _check_cuda("flash_backward", {"q": q, "k": k, "v": v, "o": o,
                                       "do": do}, q.dtype, d)
        _check_cuda("flash_backward", {"lse": lse}, torch.float32, d)
    return _MASKED_BWD(q, k, v, o, lse, do, bool(causal), scale, int(h),
                       int(kvh), q_seg, k_seg,
                       None if bands is None else list(bands), int(mask_h),
                       None if blocks is None else [int(x) for x in blocks])


def _masked_bwd_cpu(q, k, v, o, lse, do, causal, scale, h, kvh, q_seg, k_seg,
                    bands, mask_h, blocks):
    return flash_backward_plain(q, k, v, o, lse, do, causal, scale, h, kvh,
                                q_seg, k_seg,
                                None if bands is None else tuple(bands),
                                mask_h)


def _masked_bwd_tiles(q, h, kvh):
    d = q.shape[2]
    rep = h // kvh
    if masked_bwd_route(d, q.dtype) == "wgmma":
        return masked_bwd_wgmma_tiles(rep)
    t = masked_tiles(rep, d, q.dtype)
    return t, t


def _masked_bwd_cuda(q, k, v, o, lse, do, causal, scale, h, kvh, q_seg,
                     k_seg, bands, mask_h, blocks):
    bh, sq, d = q.shape
    sk = k.shape[1]
    if q.numel() == 0 or k.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    b, rep = bh // h, h // kvh
    wgmma = masked_bwd_route(d, q.dtype) == "wgmma"
    tiles_kv, tiles_q = _masked_bwd_tiles(q, h, kvh)
    suffix = "_wgmma" if wgmma else ""
    gate_h = mask_h if bands is not None else 1
    masks = (b, gate_h, sq, sk, causal, q_seg, k_seg, bands)
    qs, ks, band = _mask_tensors(q_seg, k_seg, bands, b, mask_h, sk)
    delta = (do.float() * o.float()).sum(dim=-1)               # [bh, sq]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ptrs = dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta, dk=dk, dv=dv,
                q_seg=qs, k_seg=ks, band=band)
    ints = dict(batch=b, kvh=kvh, rep=rep, sq=sq, sk=sk, d=d, mask_h=mask_h,
                gate_h=gate_h, causal=causal)
    kv_ptrs, kv_ints = masked_live_lists(tiles_kv, *masks, transposed=True,
                                         device=q.device)
    if flash_bwd_route(sq, sk, d, blocks) == "fused":
        if q.dtype == torch.float32:
            dq = dq_acc = torch.zeros_like(q)
        else:
            dq = torch.empty_like(q)
            dq_acc = torch.zeros(q.shape, dtype=torch.float32,
                                 device=q.device)
        _masked_launch("fused" + suffix, dict(ptrs, dq=dq, dq_acc=dq_acc,
                                              **kv_ptrs),
                       dict(ints, **kv_ints), scale, q.dtype)
        LAUNCHES["flash_masked_bwd_fused"] += 1
        return dq, dk, dv
    q_ptrs, q_ints = masked_live_lists(tiles_q, *masks, device=q.device)
    dq = torch.empty_like(q)
    _masked_launch("dq" + suffix, dict(ptrs, dq=dq, **q_ptrs),
                   dict(ints, **q_ints), scale, q.dtype)
    LAUNCHES["flash_masked_bwd_dq"] += 1
    _masked_launch("dkv" + suffix, dict(ptrs, **kv_ptrs),
                   dict(ints, **kv_ints), scale, q.dtype)
    LAUNCHES["flash_masked_bwd_dkv"] += 1
    return dq, dk, dv


def _masked_bwd_fake(q, k, v, o, lse, do, causal, scale, h, kvh, q_seg,
                     k_seg, bands, mask_h, blocks):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _masked_bwd_scratch(q, k, v, o, lse, do, causal, scale, h, kvh, q_seg,
                        k_seg, bands, mask_h, blocks):
    bh, sq, d = q.shape
    sk = k.shape[1]
    b = bh // h
    gate_h = mask_h if bands is not None else 1
    tiles_kv, tiles_q = _masked_bwd_tiles(q, h, kvh)
    n = (_delta_scratch(q, o, do)
         + _mask_bytes(q_seg, k_seg, bands, b, mask_h, sk)
         + _live_list_bytes(tiles_kv, b, gate_h, sq, sk))
    if flash_bwd_route(sq, sk, d, blocks) == "fused":
        return n + (0 if q.dtype == torch.float32 else 4 * q.numel())
    return n + _live_list_bytes(tiles_q, b, gate_h, sq, sk)


_MASKED_BWD = _registry.define(
    "masked_flash_bwd", "(Tensor q, Tensor k, Tensor v, Tensor o, "
    "Tensor lse, Tensor do, bool causal, float scale, int h, int kvh, "
    "Tensor? q_seg, Tensor? k_seg, Tensor[]? bands, int mask_h, "
    "int[]? blocks) -> (Tensor, Tensor, Tensor)", kernel="B6",
    cpu=_masked_bwd_cpu, cuda=_masked_bwd_cuda, fake=_masked_bwd_fake,
    scratch=_masked_bwd_scratch)


def _to_bh(x):
    """[b, s, heads, d] -> contiguous [b*heads, s, d] (mirror of
    ``flash_attention._to_bh``)."""
    b, s, hh, d = x.shape
    return x.transpose(1, 2).reshape(b * hh, s, d).contiguous()


def _from_bh(x, b: int, hh: int):
    """Inverse of ``_to_bh`` (a view): [b*heads, s, d] -> [b, s, heads, d]."""
    _, s, d = x.shape
    return x.reshape(b, hh, s, d).transpose(1, 2)


class _Flash(torch.autograd.Function):
    """Mirror of the ``_flash`` custom_vjp (``_flash_fwd`` / ``_flash_bwd``)
    on the [b*h, s, d] layouts: saves (q, k, v, o, lse) and the masks; the
    backward is ``flash_backward`` with the same ``blocks`` routing signal.
    Segment ids and bands get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, h, kvh, q_seg, k_seg, bands,
                mask_h, blocks):
        o, lse = flash_forward(q, k, v, causal, scale, h, kvh, q_seg, k_seg,
                               bands, mask_h)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, h, kvh, q_seg, k_seg, bands, mask_h,
                    blocks)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale, h, kvh, q_seg, k_seg, bands, mask_h, blocks = ctx.args
        dq, dk, dv = flash_backward(q, k, v, o, lse, do.contiguous(), causal,
                                    scale, h, kvh, q_seg, k_seg, bands,
                                    mask_h, blocks)
        return (dq, dk, dv) + (None,) * 9


def _ids(x, device):
    return None if x is None else torch.as_tensor(x, device=device).to(
        torch.int32)


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None, q_segment_ids=None,
                    kv_segment_ids=None, blocks=None, mask_bands=None):
    """Mirror of ``flash_attention_raw``: q [b, s, h, d], k/v
    [b, sk, kvh, d] (heads group-major); optional [b, s] segment ids (a
    query attends a key iff their ids match), an optional (block_q,
    block_k) that routes to the per-head path (the TPU tiling itself is not
    used), optional ``mask_bands`` (lts, lte, uts, ute) each [b, mh, sk]
    (mh divides kvh).  The default scale is 1/sqrt(d).  The TPU entry's
    predicate picks the HB kernels (``_FlashHB``); every other call takes
    the masked kernels (``_Flash``).  Raises ``FlashUnsupportedError`` for
    h % kvh != 0 and for causal with sq != sk."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("q_segment_ids and kv_segment_ids must be given "
                         "together")
    b, s, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    if (q_segment_ids is None and mask_bands is None and blocks is None
            and h % kvh == 0 and h // kvh <= MAX_REP and sk == s
            and hb_bwd_blocks(h // kvh, s, sk, d) is not None):
        qhb, khb, vhb = to_hb(q, k, v, h, kvh)
        return from_hb(_FlashHB.apply(qhb, khb, vhb, bool(causal), scale), b)
    if h % kvh != 0:
        raise FlashUnsupportedError(
            f"q heads {h} not a multiple of kv heads {kvh}")
    if causal and s != sk:
        raise FlashUnsupportedError(
            "causal flash kernel assumes sq == sk (training self-attention); "
            "decode uses the cached path")
    bands = None
    if mask_bands is not None:
        bands = tuple(_ids(x, q.device) for x in mask_bands)
    mask_h = bands[0].shape[1] if bands is not None else 1
    o = _Flash.apply(_to_bh(q), _to_bh(k), _to_bh(v), bool(causal), scale, h,
                     kvh, _ids(q_segment_ids, q.device),
                     _ids(kv_segment_ids, q.device), bands, mask_h,
                     None if blocks is None else tuple(blocks))
    return _from_bh(o, b, h)


# ------------------------------------------------------------ varlen entries

def segment_ids_from_cu_seqlens(cu_seqlens, total: int):
    """Mirror of ``segment_ids_from_cu_seqlens``: cu_seqlens [b+1] (monotone
    token offsets) -> per-token segment ids [total] int32, 1-based;
    trailing tokens past cu_seqlens[-1] share the id b+1."""
    cu = torch.as_tensor(cu_seqlens).to(torch.int32)
    pos = torch.arange(total, dtype=torch.int32, device=cu.device)
    return (torch.searchsorted(cu[1:].contiguous(), pos, right=True)
            + 1).to(torch.int32)


def flash_attn_unpadded_raw(q, k, v, cu_seqlens_q, cu_seqlens_k, scale=None,
                            causal: bool = False):
    """Mirror of ``flash_attn_unpadded_raw``: ragged attention on a packed
    token stream.  q [total_q, h, d]; k, v [total_k, kvh, d]; cu_seqlens_*
    [b+1] offsets.  causal=True is causal within each sequence.  Takes the
    masked kernels with segment ids (and the TPU entry's (1024, 1024)
    ``blocks``, which only routes)."""
    qs = segment_ids_from_cu_seqlens(
        torch.as_tensor(cu_seqlens_q, device=q.device), q.shape[0])
    ks = segment_ids_from_cu_seqlens(
        torch.as_tensor(cu_seqlens_k, device=q.device), k.shape[0])
    out = flash_attention(q[None], k[None], v[None], causal=causal,
                          scale=scale, q_segment_ids=qs[None],
                          kv_segment_ids=ks[None], blocks=(1024, 1024))
    return out[0]


def varlen_block_skip_fraction(seqlens, block: int = 512) -> float:
    """Mirror of ``varlen_block_skip_fraction``: the share of causal (q, k)
    tiles the interval test skips for a packing (host-side, numpy)."""
    ends = np.cumsum(np.asarray(seqlens))
    total = int(ends[-1])
    ids = np.searchsorted(ends, np.arange(total), side="right")
    nb = -(-total // block)
    run = skip = 0
    for qi in range(nb):
        qseg = ids[qi * block:(qi + 1) * block]
        for ki in range(qi + 1):
            kseg = ids[ki * block:(ki + 1) * block]
            if qseg.min() <= kseg.max() and qseg.max() >= kseg.min():
                run += 1
            else:
                skip += 1
    return skip / max(run + skip, 1)


# Packed-vs-dense crossover padding fraction of flash_attention_auto (the
# JAX package's constant; its autotuner, which replaces it by a per-shape
# measurement, is not ported).
PACKED_PADDING_CROSSOVER = 0.40

_VARLEN_META_CACHE: dict = {}


def _varlen_meta(b: int, s: int, lens, device):
    """Mirror of ``_varlen_meta``: (segment map [b, s] int32, 1-based per
    row with padding 0; gather indices of the live tokens; cu_seqlens),
    cached per (b, s, lens, device)."""
    key = (b, s, tuple(int(n) for n in lens), str(device))
    hit = _VARLEN_META_CACHE.get(key)
    if hit is not None:
        return hit
    live = np.arange(s)[None, :] < lens[:, None]
    seg = np.where(live, np.arange(1, b + 1, dtype=np.int32)[:, None],
                   np.int32(0))
    idx = np.flatnonzero(live.reshape(-1)).astype(np.int64)
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    out = tuple(torch.from_numpy(x).to(device) for x in (seg, idx, cu))
    if len(_VARLEN_META_CACHE) > 64:
        _VARLEN_META_CACHE.clear()
    _VARLEN_META_CACHE[key] = out
    return out


def _varlen_paths(q, k, v, lens, causal, scale):
    """Mirror of ``_varlen_paths``: the two candidates over padded
    [b, s, ...] inputs with host lengths, as {"dense", "packed"} thunks
    mapping (q, k, v) to a padded [b, s, h, d] output (pad rows: garbage
    on the dense path, zeros on the packed one)."""
    b, s = q.shape[0], q.shape[1]
    seg, idx, cu = _varlen_meta(b, s, lens, q.device)

    def dense(q, k, v):
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               q_segment_ids=seg, kv_segment_ids=seg)

    def packed(q, k, v):
        h, d, kvh = q.shape[2], q.shape[3], k.shape[2]
        out = flash_attn_unpadded_raw(
            q.reshape(b * s, h, d).index_select(0, idx),
            k.reshape(b * s, kvh, d).index_select(0, idx),
            v.reshape(b * s, kvh, d).index_select(0, idx), cu, cu,
            scale=scale, causal=causal)
        full = torch.zeros((b * s, h, d), dtype=out.dtype, device=out.device)
        return full.index_copy(0, idx, out).reshape(b, s, h, d)

    return {"dense": dense, "packed": packed}


def flash_attention_auto(q, k, v, seqlens, causal: bool = True, scale=None):
    """Mirror of ``flash_attention_auto`` with autotuning off: padded
    [b, s, h|kvh, d] inputs and host-known per-row lengths; the packed
    path (gather -> ragged attention -> scatter) when the padding fraction
    reaches ``PACKED_PADDING_CROSSOVER``, the dense segment-masked path
    otherwise."""
    if isinstance(seqlens, torch.Tensor):
        seqlens = seqlens.cpu().numpy()
    b, s = q.shape[0], q.shape[1]
    lens = np.asarray(seqlens, np.int64).reshape(-1)
    if lens.shape[0] != b or (lens > s).any():
        raise ValueError(f"seqlens {lens} inconsistent with batch {b} x "
                         f"padded length {s}")
    pad_frac = 1.0 - float(lens.sum()) / float(b * s)
    choice = "packed" if pad_frac >= PACKED_PADDING_CROSSOVER else "dense"
    return _varlen_paths(q, k, v, lens, causal, scale)[choice](q, k, v)
