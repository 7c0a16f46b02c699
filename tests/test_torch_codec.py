"""The collective codec of the port (parallel/codec.py) and the joint
memory x codec and partition x memory x overlap lattices (parallel/
memory.py, parallel/schedule.py) against the JAX package on the CPU.

The codec's contract is bit for bit: for the same input the port's packed
int8 rows equal the JAX package's, for every profile, with and without
stochastic rounding and the checksum, and for ragged last blocks; decoded
rows are equal too.  The twins of tests/test_codec.py's unit tests carry
its names.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.parallel import codec as J
from paddle_tpu_torch.parallel import codec as T

SIZES = [64, 100, 257, 1000]


def _x(n, seed=None, special=True):
    rng = np.random.RandomState(n if seed is None else seed)
    # a wide dynamic range across blocks, the case per-block scales serve
    x = (rng.randn(3, n) * np.exp(2 * rng.randn(3, n))).astype(np.float32)
    if special:
        x[0, 3] = np.nan
        x[1, 5] = np.inf
        x[2, 7] = -np.inf
        x[1, 40:] = 0.0                      # all-zero blocks
    return x


def _codecs(**kw):
    return J.CollectiveCodec(**kw), T.CollectiveCodec(**kw)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("checksum", [False, True], ids=["plain", "cs"])
@pytest.mark.parametrize("stochastic", [False, True], ids=["rn", "sr"])
@pytest.mark.parametrize("profile", ["int8", "fp8"])
def test_encode_rows_bytes_equal_jax(profile, stochastic, checksum, n):
    """``encode_rows`` packs the same bytes as the JAX package's, and
    ``decode_rows`` of them gives the same values (NaN where JAX's is)."""
    jc, tc = _codecs(block=64, checksum=checksum, seed=3)
    x = _x(n)
    want = np.asarray(J.encode_rows(jnp.asarray(x), jc, profile,
                                    stochastic=stochastic))
    got = T.encode_rows(torch.from_numpy(x), tc, profile,
                        stochastic=stochastic)
    assert got.dtype == torch.int8
    assert got.shape == (3, T.packed_width(n, 64, checksum))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        T.decode_rows(got, n, tc, profile).numpy(),
        np.asarray(J.decode_rows(jnp.asarray(want), n, jc, profile)))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("profile", ["int8", "fp8"])
def test_decode_rows_equal_jax_on_jax_bytes(profile, n):
    """The port decodes any packed bytes (random payloads, scales in a
    normal range) to JAX's values, in fp32 and cast to bf16."""
    jc, tc = _codecs(block=64)
    rng = np.random.RandomState(n)
    packed = rng.randint(-128, 128, (2, T.packed_width(n, 64))).astype(
        np.int8)
    nb = T.num_blocks(n, 64)
    # bf16 scales in [2^-31, 2): every product stays a normal fp32 (XLA's
    # CPU flushes subnormals, torch keeps them)
    packed[:, nb * 64 + 1::2] = (packed[:, nb * 64 + 1::2] & 0x0F) | 0x30
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        got = T.decode_rows(torch.from_numpy(packed), n, tc, profile,
                            out_dtype=tdt).float().numpy()
        want = np.asarray(J.decode_rows(jnp.asarray(packed), n, jc, profile,
                                        out_dtype=jdt)).astype(np.float32)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("checksum", [False, True], ids=["plain", "cs"])
@pytest.mark.parametrize("profile", ["int8", "fp8"])
def test_encode_rows_host_equals_jax(profile, checksum):
    """The host encode (torch on the CPU, no ml_dtypes) packs JAX's host
    encode's bytes, from numpy and from a tensor, and matches the device
    encode with round to nearest."""
    jc, tc = _codecs(block=128, checksum=checksum)
    x = (np.random.RandomState(7).randn(1, 777) * 10).astype(np.float32)
    want = J.encode_rows_host(x, jc, profile)
    got = T.encode_rows_host(x, tc, profile)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        T.encode_rows_host(torch.from_numpy(x), tc, profile), want)
    np.testing.assert_array_equal(
        T.encode_rows(torch.from_numpy(x), tc, profile).numpy(), want)
    dec = T.decode_jit((777,), torch.float32, tc, profile)
    np.testing.assert_array_equal(
        dec(torch.from_numpy(got)).numpy(),
        np.asarray(J.decode_jit((777,), jnp.float32, jc, profile)(
            jnp.asarray(want))))


@pytest.mark.parametrize("shape",
                         [(1, (3 << 20) + 256), (3, (1 << 20) + 256)],
                         ids=["one_row", "three_rows"])
@pytest.mark.parametrize("checksum", [False, True], ids=["plain", "cs"])
@pytest.mark.parametrize("profile", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_encode_rows_host_parts_equal_encode_rows(dtype, profile, checksum,
                                                  shape):
    """Rows of whole blocks longer than two of the host encode's parts:
    its bytes equal one ``encode_rows`` over each row, with a NaN, an inf
    and an all-zero block inside the second part and parts that straddle
    rows."""
    tc = T.CollectiveCodec(block=256, checksum=checksum)
    rows, n = shape
    assert rows * n > 2 * T._HOST_PART
    x = torch.from_numpy(
        np.random.RandomState(11).randn(rows, n).astype(np.float32) * 4)
    flat = x.view(-1)
    flat[T._HOST_PART + 5] = float("nan")
    flat[T._HOST_PART + 300] = float("inf")
    flat[T._HOST_PART + 512:T._HOST_PART + 768] = 0.0
    x = x.to(dtype)
    want = T.encode_rows(x.to(torch.float32), tc, profile).numpy()
    got = T.encode_rows_host(x, tc, profile)
    assert got.shape == (rows, T.packed_width(n, 256, checksum))
    np.testing.assert_array_equal(got, want)


ROUNDTRIP_TOLS = [("int8", False, 0.5 / 127), ("int8", True, 1.0 / 127),
                  ("fp8", False, 1.0 / 16)]


@pytest.mark.parametrize("profile,stochastic,tol", ROUNDTRIP_TOLS)
@pytest.mark.parametrize("n", SIZES)
def test_codec_roundtrip_within_block_bound(profile, stochastic, tol, n):
    """Twin of tests/test_codec.py's: each block decodes within its
    profile's bound of its absmax (2 % slack for the bf16 scale)."""
    codec = T.CollectiveCodec(block=64)
    x = _x(n, special=False)
    y = T.decode_rows(T.encode_rows(torch.from_numpy(x), codec, profile,
                                    stochastic=stochastic), n, codec,
                      profile).numpy()
    nb = -(-n // 64)
    xp = np.zeros((3, nb * 64), np.float32)
    xp[:, :n] = x
    amax = np.abs(xp.reshape(3, nb, 64)).max(-1)
    err = np.zeros_like(xp)
    err[:, :n] = np.abs(y - x)
    assert (err.reshape(3, nb, 64).max(-1) <= amax * tol * 1.02
            + 1e-12).all()


def test_codec_zero_inf_nan_guards():
    """NaN encodes to 0, +-inf saturates with its sign, an all-zero block
    decodes to exact zeros."""
    codec = T.CollectiveCodec(block=64)
    x = np.zeros((1, 130), np.float32)
    x[0, 5], x[0, 9], x[0, 12], x[0, 70] = np.nan, np.inf, -np.inf, 3.0
    for profile in ("int8", "fp8"):
        y = T.decode_rows(T.encode_rows(torch.from_numpy(x), codec, profile),
                          130, codec, profile).numpy()
        assert np.isfinite(y).all()
        assert y[0, 5] == 0.0
        assert y[0, 9] > 0 and y[0, 12] < 0
        assert (y[0, 64:70] == 0).all() and (y[0, 71:] == 0).all()
        assert abs(y[0, 70] - 3.0) <= 3.0 / 16 + 1e-6


def test_codec_wire_arithmetic():
    """Twin of tests/test_codec.py's, plus the label, json and wire bytes
    of both packages."""
    assert T.packed_width(256, 256) == 256 + 2
    assert T.packed_width(257, 256) == 512 + 4
    assert T.packed_width(257, 256, checksum=True) == 512 + 8
    assert T.wire_ratio(4096, 256) > 3.9
    with pytest.raises(ValueError):
        T.CollectiveCodec(grad_profile="int4")
    with pytest.raises(ValueError):
        T.CollectiveCodec(block=1)
    with pytest.raises(ValueError):
        T.CollectiveCodec().resolve("bias")
    c = T.CollectiveCodec(weight_profile="none")
    assert c.resolve("weight") is None
    assert c.resolve("grad") == ("int8", True)
    assert T.CollectiveCodec().resolve("weight") == ("fp8", False)
    assert T._qmax("fp8") == 448.0 and T._qmax("int8") == 127.0
    for kw in ({}, {"checksum": True, "block": 64},
               {"grad_profile": "fp8", "stochastic": False}):
        jc, tc = _codecs(**kw)
        assert tc.label() == jc.label()
        assert tc.to_json() == jc.to_json()
        for n in SIZES:
            assert tc.wire_bytes(n) == jc.wire_bytes(n)
            assert T.wire_ratio(n, tc.block) == J.wire_ratio(n, jc.block)


def test_stochastic_rounding_bitwise_deterministic():
    """Two encodes are bit-identical, a different seed draws another
    pattern, and the hash equals JAX's uint32 hash exactly (with and
    without payload bits, past 2^31 in every product)."""
    codec = T.CollectiveCodec(block=64)
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 500).astype(
        np.float32))
    p1 = T.encode_rows(x, codec, "int8", stochastic=True)
    assert torch.equal(p1, T.encode_rows(x, codec, "int8", stochastic=True))
    assert not torch.equal(p1, T.encode_rows(
        x, T.CollectiveCodec(block=64, seed=1), "int8", stochastic=True))
    bits = np.random.RandomState(1).randint(0, 2 ** 32, (3, 50),
                                            dtype=np.uint64)
    for seed in (0, 1, 2 ** 31 + 5):
        for vb in (None, bits):
            want = np.asarray(J._hash_uniform(
                3, 50, seed, None if vb is None
                else jnp.asarray(vb.astype(np.uint32))))
            got = T._hash_uniform(3, 50, seed, None if vb is None else
                                  torch.from_numpy(vb.astype(np.int64)))
            np.testing.assert_array_equal(got.numpy(), want)


def test_checksum_poisons_the_row_and_raises_on_the_host():
    """One flipped byte anywhere in a checksummed row (payload, scales or
    the sum itself) decodes exactly that row to NaN and makes
    ``verify_rows_host`` raise ``ChecksumError``; JAX's host check agrees
    on the same bytes."""
    codec = T.CollectiveCodec(block=64, checksum=True)
    x = torch.from_numpy(_x(257, special=False))
    packed = T.encode_rows(x, codec, "int8")
    T.verify_rows_host(packed)
    assert not T.check_rows_host(packed.numpy()).any()
    width = packed.shape[1]
    for col in (0, 200, width - 6, width - 1):
        bad = packed.clone()
        bad[1, col] ^= 0x10
        dec = T.decode_rows(bad, 257, codec, "int8")
        assert torch.isnan(dec[1]).all()
        assert not torch.isnan(dec[[0, 2]]).any()
        np.testing.assert_array_equal(T.check_rows_host(bad.numpy()),
                                      J.check_rows_host(bad.numpy()))
        with pytest.raises(T.ChecksumError, match="1/3 rows"):
            T.verify_rows_host(bad)
    host = T.append_checksum_host(packed[:, :-4].numpy())
    np.testing.assert_array_equal(host, packed.numpy())


# ------------------------------------------------------- the joint lattices


def test_joint_codec_lattice_autotune(monkeypatch):
    """Twin of tests/test_codec.py's: with a DCN wire budget only the codec
    points meet, the walk lands on the first codec-on point of the
    cheapest memory config; without one, on the first point.  The port's
    meter runs each step on the card; on the CPU it is replaced by a fixed
    reading, so the walk's order and budgets are what is held."""
    from paddle_tpu.parallel import memory as JM
    from paddle_tpu.parallel.overlap import OverlapConfig as JOC
    from paddle_tpu_torch.parallel import memory as M
    from paddle_tpu_torch.parallel.overlap import OverlapConfig

    base = OverlapConfig(hierarchical="on", slice_map=(0, 0, 1, 1))
    lattice = M.joint_memory_codec_lattice(
        base, memory_lattice=M.MEMORY_LATTICE[:2])
    jlat = JM.joint_memory_codec_lattice(
        JOC(hierarchical="on", slice_map=(0, 0, 1, 1)),
        memory_lattice=JM.MEMORY_LATTICE[:2])
    assert len(lattice) == 6
    assert all(isinstance(c, M.JointConfig) for c in lattice)
    assert [c.label() for c in lattice] == [c.label() for c in jlat]
    assert [c.to_json() for c in lattice] == [c.to_json() for c in jlat]
    assert lattice[0].overlap.codec is None
    assert lattice[1].overlap.codec.grad_profile == "int8"
    assert lattice[2].overlap.codec.grad_profile == "fp8"
    monkeypatch.setattr(M, "measure_step_memory", lambda fn, *a: {
        "argument_bytes": 0, "peak_bytes": 1024, "temp_bytes": 1024,
        "output_bytes": 0})

    def builder(cfg):
        return (lambda v: v * 2.0), (torch.ones(8),)

    def dcn_bytes(cfg, fn, args):
        return 1024 if cfg.overlap.codec is None else 272

    chosen, records = M.tune_memory_config(
        builder, 1 << 62, lattice=lattice, dcn_wire_bytes=512,
        dcn_bytes_fn=dcn_bytes)
    assert chosen is lattice[1]
    assert records[0]["fits"] is False and records[1]["fits"] is True
    assert records[0]["dcn_wire_bytes"] == 1024
    chosen2, _ = M.tune_memory_config(builder, 1 << 62, lattice=lattice)
    assert chosen2 is lattice[0]
    with pytest.raises(ValueError, match="dcn_bytes_fn"):
        M.tune_memory_config(builder, 1, lattice=lattice, dcn_wire_bytes=1)


def _points(mod):
    return (mod.PartitionPoint("flat", (("dp", 2), ("sharding", 2))),
            mod.PartitionPoint("hier", (("dp", 1), ("sharding", 4)),
                               slice_map=(0, 0, 1, 1)),
            mod.PartitionPoint("ep", (("dp", 1), ("ep", 4)),
                               slice_map=(0, 0, 1, 1), dcn_axis="ep"))


def test_joint_schedule_lattice_equals_jax():
    """The partition x memory x codec lattice: the same points in the same
    order as JAX's (labels, json, the overlap configs' fields), codecs only
    under slice-spanning points; the points' labels, dcn axes and meshes."""
    from paddle_tpu.parallel import memory as JM
    from paddle_tpu.parallel import schedule as JS
    from paddle_tpu_torch.parallel import memory as M
    from paddle_tpu_torch.parallel import schedule as S

    for mem in (None, (M.MemoryConfig(remat="none"),)):
        jmem = None if mem is None else (JM.MemoryConfig(remat="none"),)
        lat = S.joint_schedule_lattice(_points(S), memory_lattice=mem)
        jlat = JS.joint_schedule_lattice(_points(JS), memory_lattice=jmem)
        assert [c.label() for c in lat] == [c.label() for c in jlat]
        assert [c.to_json() for c in lat] == [c.to_json() for c in jlat]
        for c, jc in zip(lat, jlat):
            got = dataclasses.asdict(c.overlap)
            want = dataclasses.asdict(jc.overlap)
            assert got == want
    for p, jp in zip(_points(S), _points(JS)):
        assert (p.label(), p.dcn_axes(), p.to_json()) == \
            (jp.label(), jp.dcn_axes(), jp.to_json())
    mesh = _points(S)[1].mesh(8)
    assert dict(mesh.shape) == {"dp": 1, "sharding": 4}
    with pytest.raises(ValueError, match="wants 4 devices"):
        _points(S)[1].mesh(2)


def _seeded_records():
    """tests/test_schedule.py's synthetic cost model of the fake-2-slice
    joint lattice, cheapest first."""
    return [
        {"label": "hybrid4/off", "peak_bytes": 3_600_000,
         "dcn_wire_bytes": 450_000},
        {"label": "hybrid4/on", "peak_bytes": 3_580_000,
         "dcn_wire_bytes": 150_000},
        {"label": "tp8/off", "peak_bytes": 3_040_000,
         "dcn_wire_bytes": 226_000},
        {"label": "tp8/on", "peak_bytes": 3_040_128,
         "dcn_wire_bytes": 76_000},
    ]


def test_choose_joint_config_equals_jax():
    """The same index as JAX's under every pair of budgets on its seeded
    records (the single-budget and joint picks, monotone, None when
    nothing fits); the tuner's DCN budget and predicted walk raise citing
    ROADMAP A7."""
    from paddle_tpu.parallel import schedule as JS
    from paddle_tpu_torch.parallel import schedule as S

    recs = _seeded_records()
    hbms = [None, 1, 3_000_000, 3_040_000, 3_300_000, 3_580_000,
            3_600_000, 1 << 62]
    dcns = [None, 1, 76_000, 150_000, 172_000, 226_000, 450_000]
    for h in hbms:
        for d in dcns:
            assert S.choose_joint_config(recs, hbm_bytes=h,
                                         dcn_wire_bytes=d) == \
                JS.choose_joint_config(recs, hbm_bytes=h, dcn_wire_bytes=d)
    assert recs[S.choose_joint_config(
        recs, hbm_bytes=3_300_000, dcn_wire_bytes=172_000)]["label"] \
        == "tp8/on"
    for kw in ({"dcn_wire_bytes": 1}, {"predict": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP queue A7"):
            S.tune_schedule_config(None, 0, (), **kw)
