"""Block-scaled int8/fp8 codec for the inter-slice stage of a collective.

Port of ``paddle_tpu/parallel/codec.py``.  Where a mesh axis spans slices,
the inter-slice (DCN) stage of the two-stage collectives
(``parallel/overlap.py``) moves only the 1/per_slice residue; the codec
shrinks those bytes about fourfold:

- **block-scaled encode**: a row is cut into ``block``-element blocks (the
  last zero-padded) and each block is quantized against its own absmax,
  ``scale = absmax / qmax`` rounded to bf16 before the divide, ``q =
  round(x / scale)``;
- **seeded stochastic rounding** for int8 gradients: ``floor(r + u)`` with
  ``u`` a counter-based hash of (seed, element position, payload bits),
  unbiased and bitwise deterministic from run to run;
- **one wire buffer**: the bf16 scales' bytes follow the payload, and
  optionally a 4-byte position-weighted checksum of the row:

      int8[nb*block + 2*nb (+ 4)] = payload ++ bf16 scales ++ checksum

Profiles: ``"int8"`` (qmax 127), ``"fp8"`` (e4m3fn, qmax 448, round to
nearest even by the cast) and ``"none"`` (that direction stays
unquantized).  NaN encodes to 0, +-inf saturates to the block's finite
absmax, an all-zero block decodes to exact zeros.

For the same input the packed bytes equal the JAX package's bit for bit,
for every profile, with and without stochastic rounding and the checksum:
the hash runs on int64 values below 2^32 with every product taken mod
2^32, ``torch.round`` rounds half to even as ``jnp.round`` does, the bf16
and fp8 casts round to nearest even in both, and the block scale divides by
a tensor (on CUDA a Python-scalar divisor becomes a product with its
reciprocal, one bf16 scale in 173 056 off at qmax 448).  The JAX package leaves the codec to
XLA, so this is plain PyTorch on whatever device the row lies on (a fused
kernel is later work); ``encode_rows_host`` runs the same arithmetic on
the CPU, without ``ml_dtypes``, and ``decode_jit`` is a plain closure that
moves the packed bytes to its placement before it decodes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

PROFILES = ("int8", "fp8", "none")


class ChecksumError(RuntimeError):
    """A checksummed payload failed verification: the bytes were corrupted
    on the wire.  Paths that can raise (``verify_rows_host``) raise this;
    ``decode_rows`` poisons the corrupted row to NaN instead."""


#: the fp8 wire dtype (e4m3fn)
FP8_DTYPE = getattr(torch, "float8_e4m3fn", None)

INT8_QMAX = 127.0


@dataclasses.dataclass(frozen=True)
class CollectiveCodec:
    """Per-direction quantization profiles of the inter-slice hop (mirror of
    ``CollectiveCodec``).  ``grad_profile``: the reduce path (the bucket
    gradient reduce-scatter, the grad-sync psum); ``weight_profile``: the
    gather path (never stochastic).  ``stochastic`` applies to int8
    gradient encodes only; ``seed`` salts the hash; ``checksum`` appends
    the 4-byte row checksum."""

    grad_profile: str = "int8"
    weight_profile: str = "fp8"
    block: int = 256
    stochastic: bool = True
    seed: int = 0
    checksum: bool = False

    def __post_init__(self):
        for name in ("grad_profile", "weight_profile"):
            p = getattr(self, name)
            if p not in PROFILES:
                raise ValueError(
                    f"CollectiveCodec.{name}={p!r}; expected one of "
                    f"{PROFILES}")
        if self.block < 2:
            raise ValueError(
                f"CollectiveCodec.block={self.block}; blocks need >= 2 "
                f"elements for a meaningful absmax scale")

    def resolve(self, kind: str) -> Optional[Tuple[str, bool]]:
        """(profile, stochastic) for ``kind`` in {"grad", "weight"}, or None
        when that direction is unquantized."""
        if kind not in ("grad", "weight"):
            raise ValueError(f"codec kind {kind!r}")
        profile = self.grad_profile if kind == "grad" else \
            self.weight_profile
        if profile == "none":
            return None
        if profile == "fp8" and FP8_DTYPE is None:
            profile = "int8"
        stochastic = bool(self.stochastic and kind == "grad"
                          and profile == "int8")
        return profile, stochastic

    def wire_bytes(self, n_elems: int) -> int:
        """Bytes of one encoded ``n_elems`` row under this codec."""
        return packed_width(int(n_elems), self.block, self.checksum)

    def to_json(self):
        return dataclasses.asdict(self)

    def label(self) -> str:
        g = self.grad_profile + ("/sr" if self.stochastic
                                 and self.grad_profile == "int8" else "")
        cs = ",cs" if self.checksum else ""
        return f"codec[g={g},w={self.weight_profile},b={self.block}{cs}]"


# ---------------------------------------------------------------------------
# wire-format arithmetic
# ---------------------------------------------------------------------------


def num_blocks(n: int, block: int) -> int:
    return -(-int(n) // int(block))


def packed_width(n: int, block: int, checksum: bool = False) -> int:
    """Bytes of one encoded row of ``n`` elements: a byte per (padded)
    element, 2 per block's bf16 scale, 4 for the checksum."""
    nb = num_blocks(n, block)
    return nb * block + 2 * nb + (4 if checksum else 0)


def wire_ratio(n: int, block: int, itemsize: int = 4) -> float:
    """Raw bytes over packed bytes of one row."""
    return (int(n) * int(itemsize)) / float(packed_width(n, block))


def _qmax(profile: str) -> float:
    if profile == "int8":
        return INT8_QMAX
    if profile == "fp8":
        return float(torch.finfo(FP8_DTYPE).max)
    raise ValueError(f"profile {profile!r} has no qmax")


# ---------------------------------------------------------------------------
# seeded stochastic rounding
# ---------------------------------------------------------------------------

# the JAX package's SplitMix32-style finalizer over uint32; here on int64
# values below 2^32, each product taken mod 2^32 by 16-bit halves of the
# constant, so no int64 product overflows
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_MIX1 = 0x7FEB352D
_MIX2 = 0x846CA68B


def _mul32(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x * k mod 2^32`` for int64 ``x`` in [0, 2^32) and a 32-bit ``k``."""
    lo, hi = k & 0xFFFF, k >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _hash_uniform(rows: int, cols: int, seed: int, value_bits=None,
                  device=None) -> torch.Tensor:
    """[rows, cols] fp32 uniforms in [0, 1) from a hash of the position
    and, when given, the uint32 payload bits (an int64 tensor of them)."""
    if value_bits is not None:
        device = value_bits.device
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    salt = ((int(seed) & _M32) * _GOLDEN) & _M32
    x = ((r * cols + c) & _M32) ^ salt
    if value_bits is not None:
        x = x ^ _mul32(value_bits, _GOLDEN)
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX1)
    x = x ^ (x >> 15)
    x = _mul32(x, _MIX2)
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


# ---------------------------------------------------------------------------
# per-row checksums
# ---------------------------------------------------------------------------
#
# A position-weighted byte sum mod 2^32 (weight i+1 on byte i): every
# single-bit flip and every byte transposition changes it.  The 4 bytes
# follow the scale sidecar, so the sum covers payload and scales.


def _checksum_rows(packed: torch.Tensor) -> torch.Tensor:
    """[rows, w] int8 -> [rows] int64 position-weighted byte sums mod
    2^32."""
    b = packed.to(torch.int64) & 0xFF
    w = torch.arange(1, packed.shape[-1] + 1, dtype=torch.int64,
                     device=packed.device)
    return (b * w).sum(dim=-1) & _M32


def _u32_bytes(v: torch.Tensor) -> torch.Tensor:
    """[rows] int64 (< 2^32) -> [rows, 4] int8, little-endian."""
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=v.device)
    return ((v[:, None] >> shifts) & 0xFF).to(torch.uint8).view(torch.int8)


def _bytes_u32(b: torch.Tensor) -> torch.Tensor:
    """[rows, 4] int8, little-endian -> [rows] int64."""
    shifts = torch.arange(0, 32, 8, dtype=torch.int64, device=b.device)
    return ((b.to(torch.int64) & 0xFF) << shifts).sum(dim=-1)


def _checksum_rows_host(packed: np.ndarray) -> np.ndarray:
    b = packed.view(np.uint8).astype(np.uint64)
    w = np.arange(packed.shape[-1], dtype=np.uint64) + 1
    return (b * w).sum(axis=-1).astype(np.uint32)


def append_checksum_host(packed: np.ndarray) -> np.ndarray:
    cs = _checksum_rows_host(packed)
    return np.concatenate([packed, cs[:, None].view(np.int8)], axis=-1)


def check_rows_host(packed: np.ndarray) -> np.ndarray:
    """[rows, w+4] int8 -> [rows] bool corruption mask (True: the
    recomputed sum disagrees with the stored one)."""
    packed = np.asarray(packed)
    body, stored = packed[:, :-4], packed[:, -4:]
    return _checksum_rows_host(np.ascontiguousarray(body)) \
        != np.ascontiguousarray(stored).view(np.uint32).reshape(-1)


def verify_rows_host(packed, where: str = "payload") -> None:
    """Raise ``ChecksumError`` when a checksummed row was corrupted (a
    tensor on any device is read back to the host)."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    bad = check_rows_host(packed)
    if bad.any():
        raise ChecksumError(
            f"coded {where}: checksum mismatch on {int(bad.sum())}/"
            f"{len(bad)} rows at decode - the payload was corrupted in "
            f"flight (bit flip / truncation); refusing to decode "
            f"silently-wrong values")


# ---------------------------------------------------------------------------
# encode / decode
# ---------------------------------------------------------------------------


def _block_scales(xb: torch.Tensor, qmax: float):
    """Per-block bf16 absmax scales with the zero/inf/NaN guards: non-finite
    values add nothing to the absmax, an all-zero block gets scale 1, and
    the bf16 rounding happens before the divide so encoder and decoder
    agree on the scale."""
    finite = torch.isfinite(xb)
    amax = torch.where(finite, xb.abs(), torch.zeros_like(xb)).amax(dim=-1)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its rounded reciprocal, which is not always the quotient
    scale = torch.where(amax > 0,
                        torch.clamp_min(amax / torch.full_like(amax, qmax),
                                        1e-30),
                        torch.ones_like(amax))
    scale_b = scale.to(torch.bfloat16)
    return scale_b, scale_b.to(torch.float32)


def encode_rows(x: torch.Tensor, codec: CollectiveCodec, profile: str,
                stochastic: bool = False) -> torch.Tensor:
    """[rows, n] floats -> [rows, packed_width(n, block)] int8, each row
    encoded on its own, on ``x``'s device."""
    rows, n = x.shape
    block = codec.block
    nb = num_blocks(n, block)
    qmax = _qmax(profile)
    if n == nb * block:
        xp = x.to(torch.float32)             # nothing to pad, nor to write
    else:
        xp = torch.zeros((rows, nb * block), dtype=torch.float32,
                         device=x.device)
        xp[:, :n] = x
    xb = xp.reshape(rows, nb, block)
    scale_b, scale_f = _block_scales(xb, qmax)
    r = xb / scale_f[..., None]
    r = torch.where(torch.isnan(r), torch.zeros_like(r), r)
    r = torch.clamp(r, -qmax, qmax)
    if profile == "int8":
        if stochastic:
            bits = xp.view(torch.int32).to(torch.int64) & _M32
            u = _hash_uniform(rows, nb * block, codec.seed, value_bits=bits)
            q = torch.floor(r + u.reshape(rows, nb, block))
        else:
            q = torch.round(r)                   # round half to even
        q = torch.clamp(q, -qmax, qmax)
        payload = q.to(torch.int8).reshape(rows, nb * block)
    elif profile == "fp8":
        payload = r.to(FP8_DTYPE).view(torch.int8).reshape(rows, nb * block)
    else:
        raise ValueError(f"cannot encode with profile {profile!r}")
    sbytes = scale_b.contiguous().view(torch.int8).reshape(rows, 2 * nb)
    packed = torch.cat([payload, sbytes], dim=-1)
    if codec.checksum:
        packed = torch.cat([packed, _u32_bytes(_checksum_rows(packed))],
                           dim=-1)
    return packed


def decode_rows(packed: torch.Tensor, n: int, codec: CollectiveCodec,
                profile: str, out_dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``encode_rows``: [rows, packed_width] int8 -> [rows, n].
    With ``codec.checksum`` the trailing 4 bytes are verified and a row
    that fails decodes to NaN (a collective cannot raise; the NaN reaches
    the loss the same step)."""
    rows = packed.shape[0]
    block = codec.block
    nb = num_blocks(n, block)
    bad = None
    if codec.checksum:
        body, stored = packed[:, :-4], packed[:, -4:]
        bad = _checksum_rows(body) != _bytes_u32(stored)
        packed = body
    payload = packed[:, :nb * block]
    sbytes = packed[:, nb * block:].contiguous().reshape(rows, nb, 2)
    scale = sbytes.view(torch.bfloat16).reshape(rows, nb).to(torch.float32)
    if profile == "int8":
        q = payload.to(torch.float32)
    elif profile == "fp8":
        q = payload.contiguous().view(FP8_DTYPE).to(torch.float32)
    else:
        raise ValueError(f"cannot decode with profile {profile!r}")
    x = (q.reshape(rows, nb, block) * scale[..., None]).reshape(
        rows, nb * block)[:, :n]
    if bad is not None:
        x = torch.where(bad[:, None], torch.full_like(x, float("nan")), x)
    return x.to(out_dtype)


# ---------------------------------------------------------------------------
# host-side encode (the weight-delivery path)
# ---------------------------------------------------------------------------


# the host encode's working set: blocks of this many elements at a time
# stay in cache through the encode's passes
_HOST_PART = 1 << 20


def encode_rows_host(x, codec: CollectiveCodec, profile: str) -> np.ndarray:
    """``encode_rows`` with round to nearest on the host: numpy or a tensor
    in, numpy int8 out, computed by torch on the CPU (so no ``ml_dtypes``
    is needed for the bf16 and fp8 casts).  Rows that are whole blocks go
    through ``encode_rows`` ``_HOST_PART`` elements at a time, one block a
    row (a few passes over data in cache instead of a dozen over the row:
    the weight delivery encodes a whole model); blocks are encoded on
    their own, so the bytes are those of one ``encode_rows`` over the row.
    The receiver decodes with the same ``decode_rows`` as the
    collectives."""
    if profile == "fp8" and FP8_DTYPE is None:
        profile = "int8"
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu")
    else:
        t = torch.from_numpy(np.ascontiguousarray(x))
    rows, n = t.shape
    block = codec.block
    if n % block:
        return encode_rows(t.to(torch.float32), codec, profile).numpy()
    bare = dataclasses.replace(codec, checksum=False)
    flat = t.contiguous().reshape(-1)
    payload = torch.empty(flat.numel(), dtype=torch.int8)
    scales = torch.empty((flat.numel() // block, 2), dtype=torch.int8)
    step = max(block, _HOST_PART // block * block)
    for a in range(0, flat.numel(), step):
        part = encode_rows(flat[a:a + step].view(-1, block), bare, profile)
        payload[a:a + step] = part[:, :block].reshape(-1)
        scales[a // block:(a + step) // block] = part[:, block:]
    packed = torch.cat([payload.view(rows, n), scales.view(rows, -1)],
                       dim=-1)
    if codec.checksum:
        packed = torch.cat([packed, _u32_bytes(_checksum_rows(packed))],
                           dim=-1)
    return packed.numpy()


def _placement_device(out_sharding) -> torch.device:
    """The device a decoded leaf goes to: ``out_sharding`` is a
    ``torch.device`` (or its name) or a one-rank ``(Mesh, PartitionSpec)``
    pair, whose block is the leaf, on the mesh's device (the current card
    for a ``cuda`` mesh, raising without one)."""
    if isinstance(out_sharding, (torch.device, str)):
        dev = torch.device(out_sharding)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"decode placement {dev}: CUDA is not "
                               f"available")
        return dev
    mesh, _ = out_sharding
    if mesh.size != 1:
        raise ValueError(f"decode placement on a mesh of {mesh.size} ranks: "
                         f"the delivery decodes one rank's leaf (place "
                         f"blocks with the reshard plan)")
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device for the decoded leaf: place it with "
            "out_sharding='cpu' or a mesh of device_type 'cpu'")
    return torch.device("cuda", torch.cuda.current_device())


def decode_jit(shape: Tuple[int, ...], dtype, codec: CollectiveCodec,
               profile: str, out_sharding=None) -> Callable:
    """A decoder of one host-encoded leaf or chunk: packed int8
    [1, packed_width] -> a tensor of ``shape``/``dtype``.  The JAX name is
    kept; here it is a plain closure and nothing is compiled.  Without
    ``out_sharding`` the leaf decodes where the packed bytes lie.  With it
    (``_placement_device``'s forms) the PACKED bytes move to the
    placement's device first and the decode runs there, so what crosses
    to the destination is the post-codec payload.  The decode is bit-equal
    on every device: one fp32 product per element and a round-to-nearest
    cast."""
    n = int(np.prod(shape)) if shape else 1
    dev = None if out_sharding is None else _placement_device(out_sharding)

    def _dec(packed) -> torch.Tensor:
        if isinstance(packed, np.ndarray):
            packed = torch.from_numpy(np.ascontiguousarray(packed))
        if dev is not None and packed.device != dev:
            packed = packed.to(dev)
        return decode_rows(packed, n, codec, profile,
                           out_dtype=dtype).reshape(shape)

    return _dec


__all__ = ["FP8_DTYPE", "INT8_QMAX", "PROFILES", "ChecksumError",
           "CollectiveCodec", "append_checksum_host", "check_rows_host",
           "decode_jit", "decode_rows", "encode_rows", "encode_rows_host",
           "num_blocks", "packed_width", "verify_rows_host", "wire_ratio"]
