"""Sequence parallelism of the port (paddle_tpu_torch/parallel/
ring_attention.py and sep.py) against the JAX package on the CPU.

One gloo gang of 4 ranks on a ("sep",) mesh (``seq4``, spawned once per
test run as in tests/test_torch_mesh_train.py: a ``FileStore`` rendezvous,
ranks that import torch and paddle_tpu_torch only, results as npz, under
xdist the first worker runs it and the others read its results) runs
``ring_flash_attention`` and ``ulysses_attention`` at the shapes of
tests/test_parallel.py (b 2, s 256, h 4, d 32; kv heads 2 and 4, causal and
not), forward and the q/k/v gradients under a seeded cotangent, each rank
on its sequence block.  Each test holds the joined blocks against fresh
JAX outputs: the JAX functions under ``shard_map`` on the conftest's
virtual CPU devices (Pallas in interpret mode) and ``jax.vjp``, within
fp32 1e-5 of the largest magnitude.  The JAX ring costs seconds per case
here, so tier 1 keeps one causal GQA ring case and one Ulysses case; the
rest ride ``-m slow`` (their tier-1 home named at each).
"""

from __future__ import annotations

import math
import os

import numpy as np
import pytest
import torch
from torch_gang import file_store, run_gang

TOL = 1e-5
B, S, H, D = 2, 256, 4, 32
P_SEP = 4
RING_CASES = [(True, 2), (True, 4), (False, 2), (False, 4)]
ULYSSES_CASES = [(True, 4), (False, 4)]


def _inputs(kind, causal, kvh):
    seed = {"ring": 0, "ulysses": 1}[kind] * 10 + 2 * kvh + int(causal)
    rng = np.random.RandomState(seed)
    q = rng.randn(B, S, H, D).astype(np.float32) * 0.3
    k = rng.randn(B, S, kvh, D).astype(np.float32) * 0.3
    v = rng.randn(B, S, kvh, D).astype(np.float32) * 0.3
    w = rng.randn(B, S, H, D).astype(np.float32)
    return q, k, v, w


def _case_name(kind, causal, kvh):
    return f"{kind}.{'causal' if causal else 'full'}.kv{kvh}"


# --------------------------------------------------------------- the gang

def _seq_rank(rank, world, root):
    """Every ring and Ulysses case on this rank's sequence block."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import (init_mesh, ring_flash_attention,
                                           ulysses_attention)

    mesh = init_mesh("cpu", (world,), ("sep",), store=file_store(root, world),
                     rank=rank, world_size=world)
    sl = S // world
    blk = slice(rank * sl, (rank + 1) * sl)
    out = {}
    for kind, fn, cases in (("ring", ring_flash_attention, RING_CASES),
                            ("ulysses", ulysses_attention, ULYSSES_CASES)):
        for causal, kvh in cases:
            q, k, v, w = (torch.from_numpy(a[:, blk].copy())
                          for a in _inputs(kind, causal, kvh))
            q, k, v = (t.requires_grad_() for t in (q, k, v))
            o = fn(q, k, v, axis="sep", causal=causal, mesh=mesh)
            dq, dk, dv = torch.autograd.grad(o, (q, k, v), w)
            name = _case_name(kind, causal, kvh)
            for key, t in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
                out[f"{name}.{key}"] = t.detach().numpy()
    np.savez(os.path.join(root, f"seq.{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def seq4(tmp_path_factory):
    return run_gang("seq_gang4", _seq_rank, P_SEP, tmp_path_factory)


# --------------------------------------------------------------- JAX side

def _jax_case(kind, causal, kvh):
    """(o, dq, dk, dv) of JAX's function under shard_map over 4 virtual
    CPU devices, the cotangent ``w``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from paddle_tpu.common.jax_compat import shard_map
    from paddle_tpu.parallel import ring_flash_attention, ulysses_attention

    fn = ring_flash_attention if kind == "ring" else ulysses_attention
    mesh = Mesh(np.asarray(jax.devices()[:P_SEP], dtype=object), ("sep",))
    spec = P(None, "sep", None, None)
    body = shard_map(lambda q, k, v: fn(q, k, v, axis="sep", causal=causal),
                     mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                     check_vma=False)

    @jax.jit
    def run(q, k, v, w):
        o, vjp = jax.vjp(body, q, k, v)
        return (o,) + vjp(w)

    return [np.asarray(a) for a in run(*map(jnp.asarray,
                                            _inputs(kind, causal, kvh)))]


def _joined(root, name, key):
    return np.concatenate([np.load(root / f"seq.{r}.npz")[f"{name}.{key}"]
                           for r in range(P_SEP)], axis=1)


def _check(root, kind, causal, kvh):
    want = _jax_case(kind, causal, kvh)
    name = _case_name(kind, causal, kvh)
    for key, w in zip(("o", "dq", "dk", "dv"), want):
        got = _joined(root, name, key)
        assert got.shape == w.shape, (key, got.shape, w.shape)
        err = np.abs(got - w).max()
        assert err <= TOL * np.abs(w).max(), (name, key, err,
                                             np.abs(w).max())


@pytest.mark.parametrize("causal,kvh", [
    (True, 2),
    # tier-1 home of the rest: the causal GQA case above
    pytest.param(True, 4, marks=pytest.mark.slow),
    pytest.param(False, 2, marks=pytest.mark.slow),
    pytest.param(False, 4, marks=pytest.mark.slow),
])
def test_ring_attention_matches_jax(seq4, causal, kvh):
    """The ring over 4 ranks: forward and the q/k/v gradients equal JAX's
    ``ring_flash_attention`` under shard_map (interpret-mode Pallas per
    hop) within fp32 1e-5."""
    _check(seq4, "ring", causal, kvh)


@pytest.mark.parametrize("causal", [
    True,
    # tier-1 home: the causal case above
    pytest.param(False, marks=pytest.mark.slow),
])
def test_ulysses_attention_matches_jax(seq4, causal):
    """Ulysses over 4 ranks (kv heads 4): forward and gradients equal
    JAX's ``ulysses_attention`` within fp32 1e-5."""
    _check(seq4, "ulysses", causal, 4)


def test_ulysses_refuses_indivisible_heads():
    """kv heads 2 over a sep axis of 4: the ValueError of sep.py:40-41,
    raised before any collective (an abstract mesh suffices)."""
    from paddle_tpu_torch.parallel import Mesh, ulysses_attention

    q = torch.zeros(1, 8, 4, 8)
    kv = torch.zeros(1, 8, 2, 8)
    with pytest.raises(ValueError, match="must divide sep degree 4"):
        ulysses_attention(q, kv, kv, mesh=Mesh((4,), ("sep",)))


@pytest.mark.parametrize("kvh", [1, 4])
def test_one_rank_ring_and_ulysses_are_flash(kvh):
    """At sep 1 the ring is one diagonal hop of the masked flash kernels
    (B5/B6; within fp32 rounding of ``flash_attention``'s route) and
    Ulysses' exchanges are the identity (bit-equal to
    ``flash_attention``), forward and gradients."""
    from paddle_tpu_torch.incubate.nn.attention import flash_attention
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel import (Mesh, ring_flash_attention,
                                           ulysses_attention)

    mesh = Mesh((1,), ("sep",))
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(2, 64, h, 16).astype(np.float32))
               for h in (4, kvh, kvh))
    w = torch.from_numpy(rng.randn(2, 64, 4, 16).astype(np.float32))

    def run(fn):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        o = fn(*ins)
        return [o.detach()] + list(torch.autograd.grad(o, ins, w))

    want = run(lambda a, b, c: flash_attention(a, b, c, causal=True))
    fa.reset_launches()
    uly = run(lambda a, b, c: ulysses_attention(a, b, c, mesh=mesh))
    assert all(torch.equal(x, y) for x, y in zip(uly, want))
    ring = run(lambda a, b, c: ring_flash_attention(a, b, c, mesh=mesh))
    for x, y in zip(ring, want):
        assert (x - y).abs().max().item() <= TOL * y.abs().max().item()
    assert math.isfinite(float(ring[0].sum()))
