"""The port's memory engine (parallel/memory.py and the remat and
host-resident paths of models/llama.py build_train_step) against the JAX
package on the CPU.

- Every ``MEMORY_LATTICE`` point: two fp32 AdamW steps of the port's
  ``build_train_step(memory=point)`` against JAX's on the debug Llama from
  the same weights and flat state.  The JAX reference runs the point's
  remat policy with the state on the device: on this JAX version's CPU
  backend its host placements fail inside the step ("memory_space of all
  inputs passed to `add` must be the same"), and JAX's own contract is
  that residency and activation offload change where bytes live, not the
  numbers.  The port's host points are held bit for bit to its device
  points, and its offloaded update to its ``apply_flat``.
- One point on the masked (segment-id) step; ``stream_bucket_plan`` and
  the ``MemoryConfig`` tables equal JAX's; the gather round trip; the
  validation; the plain flash functions' call counts per policy (one
  forward per layer without remat, two under every checkpointed policy,
  one backward); what each policy keeps.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxConfig
from paddle_tpu.models import LlamaForCausalLM as JaxModel
from paddle_tpu.models import build_train_step as jax_build_train_step
from paddle_tpu.models import llama as jllama
from paddle_tpu.optimizer.optimizer import AdamW as JaxAdamW
from paddle_tpu.parallel import memory as JM
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     build_train_step, llama_decay_mask,
                                     params_from_jax)
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import memory as M

LR = 1e-3
CFG = dict(vocab=128, hidden=32, layers=2, heads=4, kv_heads=2, inter=64,
           max_pos=64)


@pytest.fixture(scope="module")
def pair():
    """A JAX debug Llama and its port twin with the same weights."""
    state = paddle.get_rng_state()
    paddle.seed(20260810)
    jm = JaxModel(JaxConfig.debug(**CFG))
    paddle.set_rng_state(state)
    jstate = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    model = LlamaForCausalLM(LlamaConfig.debug(**CFG), device="cpu")
    model.load_functional_state(params_from_jax(jstate, "cpu"))
    return jm, jstate, model


def _batch(accum, seed=7):
    rng = np.random.default_rng(seed)
    shape = (accum, 2, 16) if accum > 1 else (2, 16)
    return (rng.integers(0, CFG["vocab"], shape).astype(np.int32),
            rng.integers(0, CFG["vocab"], shape).astype(np.int32))


def _port_state(opt, params, mask, mc):
    if mc.optimizer_residency == "host":
        return M.init_offloaded_state(opt, params, decay_mask=mask,
                                      bucket_bytes=mc.stream_bucket_bytes)
    return opt.init_flat_state(params, decay_mask=mask)


def _run_port(model, mc, ids, lab, accum=1, steps=2, seg=None):
    opt = AdamW(learning_rate=LR)
    step = build_train_step(model, opt, compute_dtype=torch.float32,
                            accum_steps=accum, memory=mc)
    params = {k: v.clone() for k, v in model.functional_state().items()}
    state = _port_state(opt, params, llama_decay_mask(model), mc)
    kw = {} if seg is None else {"attention_mask": torch.from_numpy(seg)}
    losses = []
    for i in range(steps):
        loss, params, state = step(params, state, i, LR,
                                   torch.from_numpy(ids),
                                   torch.from_numpy(lab), **kw)
        losses.append(float(loss))
    return losses, params, state


def _run_jax(jm, jstate, remat, ids, lab, accum=1, steps=2, seg=None):
    opt = JaxAdamW(learning_rate=LR, parameters=jm.parameters())
    step = jax_build_train_step(jm, opt, compute_dtype=jnp.float32,
                                accum_steps=accum,
                                memory=JM.MemoryConfig(remat=remat))
    params = {k: jnp.asarray(v) for k, v in jstate.items()}
    state = opt.init_flat_state({k: jnp.asarray(v)
                                 for k, v in jstate.items()},
                                decay_mask=jllama.llama_decay_mask(jm))
    kw = {} if seg is None else {"attention_mask": jnp.asarray(seg)}
    losses = []
    for i in range(steps):
        loss, params, state = step(params, state, i, LR, ids, lab, **kw)
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in params.items()}


def _assert_params(tparams, jparams):
    """The established step tolerance (tests/test_torch_training.py):
    Adam moves a weight by about lr whatever its gradient's size, so an
    element whose near-zero gradient the two summation orders sign
    differently lands up to 2 lr apart; all others within 1e-5 + 1e-6
    relative."""
    for k, want in jparams.items():
        got = tparams[k].detach().numpy()
        diff = np.abs(got - want)
        assert diff.max() <= 2 * 2 * LR + 1e-6, k
        assert np.mean(diff > 1e-5 + 1e-6 * np.abs(want)) < 1e-3, k


@pytest.fixture(scope="module")
def jax_refs(pair):
    """The JAX two-step reference of a remat policy at an accumulation
    depth, computed once per module."""
    jm, jstate, _ = pair
    memo = {}

    def ref(remat, accum):
        if (remat, accum) not in memo:
            ids, lab = _batch(accum)
            memo[remat, accum] = _run_jax(jm, jstate, remat, ids, lab, accum)
        return memo[remat, accum]

    return ref


@pytest.fixture(scope="module")
def port_device(pair):
    """The port's two-step run at each device-residency remat policy."""
    model = pair[2]
    out = {}
    for remat in M.REMAT_POLICIES:
        ids, lab = _batch(1)
        out[remat] = _run_port(model, M.MemoryConfig(remat=remat), ids, lab)
    return out


@pytest.mark.parametrize("mc", M.MEMORY_LATTICE,
                         ids=[m.label() for m in M.MEMORY_LATTICE])
def test_lattice_point_matches_jax(pair, jax_refs, port_device, mc):
    """Losses within 1e-5 relative of JAX's and params within the step
    tolerance after two steps (small stream buckets so every group
    splits); a host point equals the port's device point of its remat
    policy bit for bit, its state stays offloaded."""
    mc = M.MemoryConfig(**{**mc.to_json(), "stream_bucket_bytes": 8 << 10})
    ids, lab = _batch(1)
    losses, params, state = _run_port(pair[2], mc, ids, lab)
    jl, jp = jax_refs(mc.remat, 1)
    np.testing.assert_allclose(losses, jl, rtol=1e-5)
    _assert_params(params, jp)
    dl, dp, _ = port_device[mc.remat]
    assert losses == dl
    assert all(torch.equal(params[k], dp[k]) for k in dp)
    assert M.state_is_offloaded(state) == (mc.optimizer_residency == "host")


@pytest.mark.parametrize("label", ["names/host", "full/host"])
def test_lattice_point_with_accumulation_matches_jax(pair, jax_refs, label):
    mc = next(m for m in M.MEMORY_LATTICE if m.label() == label)
    mc = M.MemoryConfig(**{**mc.to_json(), "stream_bucket_bytes": 8 << 10})
    ids, lab = _batch(2)
    losses, params, _ = _run_port(pair[2], mc, ids, lab, accum=2)
    jl, jp = jax_refs(mc.remat, 2)
    np.testing.assert_allclose(losses, jl, rtol=1e-5)
    _assert_params(params, jp)


def test_masked_step_lattice_point_matches_jax(pair):
    """offload/host on the token-weighted masked step (packed segment ids
    with padding, accum 2; the masked kernels' plain versions)."""
    jm, jstate, model = pair
    ids, lab = _batch(2, seed=11)
    seg = np.zeros((2, 2, 16), np.int32)
    seg[:, 0, :9], seg[:, 0, 9:14] = 1, 2
    seg[:, 1, :16] = 1
    seg[1, 1, 12:] = 0
    mc = M.MemoryConfig(remat="offload", optimizer_residency="host",
                        stream_bucket_bytes=8 << 10)
    losses, params, _ = _run_port(model, mc, ids, lab, accum=2, seg=seg)
    jl, jp = _run_jax(jm, jstate, "offload", ids, lab, accum=2, seg=seg)
    np.testing.assert_allclose(losses, jl, rtol=1e-5)
    _assert_params(params, jp)


def _mixed_params(seed=0):
    """bf16 weights (an fp32 master each) and fp32 norms, odd sizes."""
    rng = np.random.default_rng(seed)
    p = {"a.w": rng.standard_normal((37, 29)),
         "b.w": rng.standard_normal((301,)),
         "c.norm.weight": rng.standard_normal((53,)),
         "d.w": rng.standard_normal((11, 7, 3))}
    return {k: torch.from_numpy(v.astype(np.float32)).to(
        torch.float32 if "norm" in k else torch.bfloat16)
        for k, v in p.items()}


@pytest.mark.parametrize("bucket_bytes", [4 << 20, 1000, 4 * 97, 0])
def test_offloaded_update_equals_apply_flat_bit_for_bit(bucket_bytes):
    """Three steps of ``apply_flat_offloaded`` (in place) against
    ``apply_flat``: bf16 params with fp32 masters from unrounded values, an
    fp32 group without a master, a decay mask, buckets with odd tails (one
    bucket per group at cap 0): params, masters and moments bit for bit."""
    opt = AdamW(learning_rate=LR, weight_decay=0.05)
    p = _mixed_params()
    p32 = {k: v.float() + 1e-3 for k, v in p.items()}
    mask = {k: "norm" not in k for k in p}
    flat = opt.init_flat_state(p, decay_mask=mask, master_from=p32)
    off = M.init_offloaded_state(opt, {k: v.clone() for k, v in p.items()},
                                 decay_mask=mask, master_from=p32,
                                 bucket_bytes=bucket_bytes)
    ref, cur = dict(p), {k: v.clone() for k, v in p.items()}
    for step in range(1, 4):
        rng = np.random.default_rng(step)
        g = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(
            np.float32)).to(v.dtype) for k, v in p.items()}
        ref, flat = opt.apply_flat(ref, g, flat, LR, step, decay_mask=mask)
        storage = {k: v.data_ptr() for k, v in cur.items()}
        cur, off = M.apply_flat_offloaded(opt, cur, g, off, LR, step,
                                          decay_mask=mask)
        assert {k: v.data_ptr() for k, v in cur.items()} == storage
        for k in p:
            assert torch.equal(cur[k], ref[k]), (k, step)
    back = M.gather_offloaded_state(off)["__flat__"]
    for name, gs in flat["__flat__"].items():
        assert set(back[name]) == set(gs)
        for key, val in gs.items():
            assert torch.equal(back[name][key], val), (name, key)


def test_offloaded_update_guards():
    opt = AdamW(learning_rate=LR)
    p = _mixed_params(1)
    off = M.init_offloaded_state(opt, p, bucket_bytes=512)
    g = {k: torch.zeros_like(v) for k, v in p.items()}
    with pytest.raises(ValueError, match="init_offloaded_state"):
        M.apply_flat_offloaded(opt, p, g, opt.init_flat_state(p), LR, 1)
    with pytest.raises(ValueError, match="missing"):
        M.apply_flat_offloaded(opt, p, {k: g[k] for k in list(g)[1:]}, off,
                               LR, 1)
    with pytest.raises(ValueError, match="groups"):
        M.apply_flat_offloaded(opt, p, g, off, LR, 1,
                               decay_mask={"a.w": False})
    # the shard-major layout is ported: anything else is refused
    with pytest.raises(TypeError, match="FlatUpdateLayout"):
        M.apply_flat_offloaded(opt, p, g, off, LR, 1, flat_layout=object())


def test_stream_bucket_plan_equals_jax():
    for n, item, cap in [(0, 4, 1024), (1, 4, 1024), (1000, 4, 1024),
                         (1024, 4, 1024), (1025, 4, 1024), (999, 2, 64),
                         (10, 4, 0), (10, 4, -5), (7, 4, 3), (4 << 20, 4,
                                                              4 << 20)]:
        assert M.stream_bucket_plan(n, item, cap) == \
            JM.stream_bucket_plan(n, item, cap), (n, item, cap)


def test_offload_gather_round_trip_and_init_equality():
    """offload_flat_state then gather is the identity; init_offloaded_state
    equals offload_flat_state(init_flat_state(...)) bit for bit; the
    bucket sizes follow the plan."""
    opt = AdamW(learning_rate=LR)
    p = _mixed_params(2)
    p32 = {k: v.float() * 1.001 for k, v in p.items()}
    flat = opt.init_flat_state(p, master_from=p32)
    off = M.offload_flat_state(flat, bucket_bytes=256)
    built = M.init_offloaded_state(opt, p, master_from=p32, bucket_bytes=256)
    assert M.state_is_offloaded(off) and not M.state_is_offloaded(flat)
    back = M.gather_offloaded_state(off)["__flat__"]
    for name, gs in flat["__flat__"].items():
        for key, val in gs.items():
            assert torch.equal(back[name][key], val)
            sizes = [b.numel() for b in off["__offload__"][name][key]]
            assert sizes == [s for _, s in
                             M.stream_bucket_plan(val.numel(), 4, 256)]
            for a, b in zip(off["__offload__"][name][key],
                            built["__offload__"][name][key]):
                assert torch.equal(a, b)
    assert M.offloaded_bytes(off) == sum(
        v.numel() * 4 for gs in flat["__flat__"].values() for v in gs.values())
    with pytest.raises(ValueError, match="init_flat_state"):
        M.offload_flat_state({"a": 1})
    with pytest.raises(ValueError, match="offloaded"):
        M.gather_offloaded_state(flat)


def test_memory_config_matches_jax():
    """Validation, labels, JSON, the keep and recompute tables, the lattice
    order and resolve_remat's checkpoint flag, point by point."""
    for bad in (dict(remat="selective"), dict(optimizer_residency="nvme")):
        with pytest.raises(ValueError):
            M.MemoryConfig(**bad)
        with pytest.raises(ValueError):
            JM.MemoryConfig(**bad)
    assert M.SAVEABLE_NAMES == JM.SAVEABLE_NAMES
    assert M.REMAT_POLICIES == JM.REMAT_POLICIES
    assert M.RESIDENCIES == JM.RESIDENCIES
    assert [m.to_json() for m in M.MEMORY_LATTICE] == \
        [m.to_json() for m in JM.MEMORY_LATTICE]
    for mt, mj in zip(M.MEMORY_LATTICE, JM.MEMORY_LATTICE):
        assert mt.label() == mj.label()
        assert mt.act_keep_factor() == mj.act_keep_factor()
        assert mt.recompute_fwd_passes() == mj.recompute_fwd_passes()
        assert mt.resolve_remat()[0] == mj.resolve_remat()[0]
    for act in (False, True):
        for remat in M.REMAT_POLICIES:
            mc = M.MemoryConfig(remat=remat, activation_offload=act)
            use, pol = mc.resolve_remat()
            assert use == JM.MemoryConfig(
                remat=remat, activation_offload=act).resolve_remat()[0]
            if pol is not None:
                assert pol.dots == (remat in ("none", "dots"))
                assert bool(pol.offload) == (act or remat == "offload")
                assert bool(pol.names) == (remat == "names" and not act)
    assert M.MemoryConfig(remat="full").resolve_remat() == (True, None)
    assert M.MemoryConfig().resolve_remat() == (False, None)


def test_meter_tuner_and_joint_lattice():
    """The meter reads the CUDA allocator and raises without a card (so
    does the tuner, through it); choose_memory_config equals JAX's; the
    joint memory x codec lattice is ported (A5.2): its points equal JAX's
    (tests/test_torch_codec.py walks it), and a DCN wire budget without
    its measuring function raises, as in JAX."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            M.measure_step_memory(lambda: None)
        with pytest.raises(RuntimeError, match="CUDA"):
            M.tune_memory_config(lambda cfg: (lambda: None, ()), 1 << 30)
    recs = [{"peak_bytes": b} for b in (900, 700, 500, 300)]
    for budget in (100, 300, 650, 800, 1000):
        assert M.choose_memory_config(recs, budget) == \
            JM.choose_memory_config(recs, budget)
    from paddle_tpu.parallel.overlap import OverlapConfig as JOC
    from paddle_tpu_torch.parallel.overlap import OverlapConfig

    assert M.JointConfig(M.MemoryConfig()).label() == \
        JM.JointConfig(JM.MemoryConfig()).label()
    assert [c and c.to_json() for c in M.codec_lattice_points()] == \
        [c and c.to_json() for c in JM.codec_lattice_points()]
    assert [c.label() for c in M.joint_memory_codec_lattice(
        OverlapConfig())] == [c.label() for c in
                              JM.joint_memory_codec_lattice(JOC())]
    with pytest.raises(ValueError, match="dcn_bytes_fn"):
        M.tune_memory_config(lambda c: None, 1, dcn_wire_bytes=1)


def _count_plain(monkeypatch, names):
    calls = dict.fromkeys(names, 0)
    for n in names:
        real = getattr(fa, n)

        def counted(*a, _n=n, _real=real, **kw):
            calls[_n] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(fa, n, counted)
    return calls


@pytest.mark.parametrize("remat", M.REMAT_POLICIES)
def test_plain_flash_calls_per_policy(pair, monkeypatch, remat):
    """A step makes one forward call per layer without remat and two under
    every checkpointed policy (the recomputation runs the attention
    again: no policy keeps its output, as no JAX policy keeps the Pallas
    output), and one backward call per layer; on the card each is a kernel
    launch, counted the same way."""
    model = pair[2]
    layers = model.cfg.num_hidden_layers
    calls = _count_plain(monkeypatch, ("hb_flash_forward_plain",
                                       "hb_flash_backward_plain",
                                       "flash_forward_plain",
                                       "flash_backward_plain"))
    ids, lab = _batch(1)
    _run_port(model, M.MemoryConfig(remat=remat), ids, lab, steps=1)
    fwd = layers * (1 if remat == "none" else 2)
    assert calls == {"hb_flash_forward_plain": fwd,
                     "hb_flash_backward_plain": layers,
                     "flash_forward_plain": 0, "flash_backward_plain": 0}
    seg = np.ones((2, 16), np.int32)
    seg[1, 10:] = 0
    for k in calls:
        calls[k] = 0
    _run_port(model, M.MemoryConfig(remat=remat), ids, lab, steps=1, seg=seg)
    assert calls == {"hb_flash_forward_plain": 0,
                     "hb_flash_backward_plain": 0,
                     "flash_forward_plain": fwd,
                     "flash_backward_plain": layers}


@pytest.mark.parametrize("label,kept", [
    # per layer: the 7 projections (the attention is one registered
    # operator, B1, on the CPU as on the card: no matmul of it is seen)
    ("dots/device", {"device": 7}),
    ("names/device", {"device": 2}),
    ("offload/host", {"host": 2}),
    ("none/host/act_offload", {"device": 7, "host": 2}),
    ("full/host", {})])
def test_policies_keep_what_they_name(pair, monkeypatch, label, kept):
    """Per layer and micro-step, a policy parks in the forward what it
    names: every matmul output under dots, the two tags under names (on
    the device) or offload (in host memory).  The recomputation takes them
    back instead of running their ops, up to the layer's last saved tensor
    (the down projection's input): so the attention tag comes back from
    host memory once a layer, and the MLP tag is never needed."""
    parked, replayed = [], []
    real_park, real_unpark = M._park, M._unpark
    monkeypatch.setattr(M, "_park", lambda out, where: (
        parked.append(where), real_park(out, where))[1])
    monkeypatch.setattr(M, "_unpark", lambda k: (
        replayed.append(k[1] is not None), real_unpark(k))[1])
    mc = next(m for m in M.MEMORY_LATTICE if m.label() == label)
    model = pair[2]
    ids, lab = _batch(1)
    _run_port(model, mc, ids, lab, steps=1)
    layers = model.cfg.num_hidden_layers
    want = {w: n * layers for w, n in kept.items()}
    assert {w: parked.count(w) for w in set(parked)} == want
    assert replayed.count(True) == (layers if "host" in kept else 0)
    assert (len(replayed) > 0) == bool(kept)
    assert len(replayed) <= len(parked)
