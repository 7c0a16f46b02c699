"""The MoE stack of the PyTorch port against the JAX package on the CPU:
the gates and their masks (paddle_tpu_torch/incubate/distributed/models/
moe/gate.py), ``MoELayer`` on its capacity and dropless paths
(moe_layer.py), ``ClipGradForMOEByGlobalNorm`` (grad_clip.py), the
pipelined blocks' single-device reference (pipelined.py), ``fused_moe``
(incubate/nn/fused.py) and the capacity half of parallel/expert.py at an
expert-parallel degree of 1.

Inputs come from numpy seeds; a port ``MoELayer`` starts bit-equal to a
JAX one (the same ``RandomState(0)`` draws), and gate weights are set on
both.  On the CPU the dropless op runs the grouped-matmul kernels' plain
versions.  Tolerances: fp32 1e-5 of the output's largest magnitude (the
same fp32 arithmetic in another order), bf16 2e-2 (an ulp of either side);
masks, counts and capacities exactly.  The legs mirror
tests/test_gpt_moe.py's MoELayer, dropless and fused_moe legs,
tests/test_expert_parallel.py's capacity legs, tests/test_moe_dropless.py's
step-0 and grad legs and tests/test_parallel.py's MoE clip legs.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as S
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu.incubate.distributed.models import moe as jmoe
from paddle_tpu.incubate.distributed.models.moe import gate as jgate
from paddle_tpu.incubate.distributed.models.moe import moe_layer as jlayer
from paddle_tpu.incubate.distributed.models.moe import pipelined as jpipe
from paddle_tpu.incubate.nn import fused_moe as jfused_moe
from paddle_tpu.incubate.nn.fused import _fused_moe_op
from paddle_tpu.parallel import expert as jexp
from paddle_tpu_torch.incubate.distributed.models import moe as pmoe
from paddle_tpu_torch.incubate.distributed.models.moe import gate as pgate
from paddle_tpu_torch.incubate.distributed.models.moe import \
    moe_layer as player
from paddle_tpu_torch.incubate.distributed.models.moe import \
    pipelined as ppipe
from paddle_tpu_torch.incubate.nn.fused import fused_moe
from paddle_tpu_torch.optimizer.clip import GradClipBase
from paddle_tpu_torch.parallel import expert as pexp

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    den = np.abs(want).max()
    return float(np.abs(got - want).max() / (den if den > 0 else 1.0))


def _t(x, dt="float32", grad=False):
    t = torch.from_numpy(np.ascontiguousarray(x)).to(TDT[dt])
    return t.requires_grad_() if grad else t


def _np(t):
    return t.detach().float().numpy()


def _op_args(g, m, h, e, seed, bias=0.1, w=0.3):
    rng = np.random.RandomState(seed)
    return [rng.randn(g, m).astype(np.float32),
            rng.randn(m, e).astype(np.float32),
            (rng.randn(e, m, h) * w).astype(np.float32),
            (rng.randn(e, h) * bias).astype(np.float32),
            (rng.randn(e, h, m) * w).astype(np.float32),
            (rng.randn(e, m) * bias).astype(np.float32)]


# ------------------------------------------------------------------- gates

@pytest.mark.parametrize("tokens,topk,e,cf", [
    (16, 2, 4, 1.2), (8192, 2, 8, 1.2), (64, 1, 4, 0.25), (37, 3, 5, 2.4),
    (100, 2, 8, 8.0)])
def test_moe_capacity_matches_jax(tokens, topk, e, cf):
    assert pgate.moe_capacity(tokens, topk, e, cf) == \
        jgate.moe_capacity(tokens, topk, e, cf)


def _probs(kind, g, e, seed):
    rng = np.random.RandomState(seed)
    if kind == "uniform":           # the zero-init gate: every prob ties
        return np.full((g, e), 1.0 / e, np.float32)
    if kind == "underflow":         # one prob 1, the rest underflowed to 0:
        # round 2 takes the argmax of zeros, expert 0, even where expert 0
        # was round 1's pick (its combine weight then counts twice)
        return np.eye(e, dtype=np.float32)[rng.randint(0, e, g)]
    logits = rng.randn(g, e).astype(np.float32)
    if kind == "skewed":            # most tokens at expert 1
        logits[:, 1] += 4.0
    return S.softmax(logits, axis=-1).astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "uniform", "skewed", "underflow"])
@pytest.mark.parametrize("topk,capacity", [(1, 3), (2, 5), (2, 40), (3, 4)])
def test_top_k_masks_with_drops_exact(kind, topk, capacity):
    """Combine, dispatch and the drop count equal JAX's exactly: the same
    argmax ties (lowest index), slots and refusals."""
    probs = _probs(kind, 24, 4, 1)
    jc, jd, jdrop = jgate.top_k_masks_with_drops(jnp.asarray(probs), topk,
                                                 capacity)
    pc, pd, pdrop = pgate.top_k_masks_with_drops(torch.from_numpy(probs),
                                                 topk, capacity)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    assert pdrop.dtype == torch.int32 and int(pdrop) == int(jdrop)
    c2, d2 = pgate.top_k_masks(torch.from_numpy(probs), topk, capacity)
    assert torch.equal(c2, pc) and torch.equal(d2, pd)
    if kind == "skewed" and capacity < 24:
        assert int(pdrop) > 0


def test_aux_losses_match_jax():
    probs = _probs("random", 32, 6, 2)
    want = jgate.load_balance_aux_loss(jnp.asarray(probs))
    got = pgate.load_balance_aux_loss(torch.from_numpy(probs))
    assert _rel(got.numpy(), want) <= 1e-6
    zero = pgate.zero_aux_loss(torch.from_numpy(probs))
    assert zero.dtype == torch.float32 and float(zero) == 0.0


@pytest.mark.parametrize("name", ["naive", "gshard", "switch"])
def test_gates_match_jax(name):
    """Zero weights of shape [m, E * world_size]; switch forces top-1;
    capacity and the aux-loss choice as JAX's."""
    cls = {"naive": "NaiveGate", "gshard": "GShardGate",
           "switch": "SwitchGate"}[name]
    jg = getattr(jgate, cls)(8, 4, world_size=2, topk=2)
    pg = getattr(pgate, cls)(8, 4, world_size=2, topk=2, device="cpu")
    assert pg.topk == jg.topk == (1 if name == "switch" else 2)
    assert pg.num_expert == jg.num_expert == 8
    np.testing.assert_array_equal(pg.weight.detach().numpy(),
                                  np.asarray(jg.weight._value))
    assert pg.capacity(50, 1.2) == jg.capacity(50, 1.2)
    probs = _probs("random", 10, 8, 3)
    np.testing.assert_allclose(
        pg.aux_loss_fn(torch.from_numpy(probs)).numpy(),
        np.asarray(type(jg).aux_loss_fn(jnp.asarray(probs))), rtol=1e-6)


# ------------------------------------------------------------------ MoELayer

def _layer_pair(gate, dropless=False, cf=1.2, seed=None, topk=2, m=8, h=16,
                e=4):
    """A JAX and a port MoELayer, equal from construction; with ``seed`` a
    random gate weight set on both."""
    jl = jmoe.MoELayer(d_model=m, d_hidden=h, num_expert=e, gate=gate,
                       top_k=topk, capacity_factor=cf, dropless=dropless)
    pl = pmoe.MoELayer(d_model=m, d_hidden=h, num_expert=e, gate=gate,
                       top_k=topk, capacity_factor=cf, dropless=dropless,
                       device="cpu")
    if seed is not None:
        gw = np.random.RandomState(seed).randn(m, e).astype(np.float32)
        jl.gate.weight.set_value(jnp.asarray(gw))
        with torch.no_grad():
            pl.gate.weight.copy_(torch.from_numpy(gw))
    return jl, pl


def test_moe_layer_init_bit_equal_to_jax():
    jl, pl = _layer_pair("gshard")
    jnames = [n for n, _ in jl.named_parameters()]
    assert [n for n, _ in pl.named_parameters()] == jnames
    for (n, jp), (_, pp) in zip(jl.named_parameters(),
                                pl.named_parameters()):
        np.testing.assert_array_equal(pp.detach().numpy(),
                                      np.asarray(jp._value), err_msg=n)
        assert getattr(pp, "is_expert", False) == \
            getattr(jp, "is_expert", False), n
    assert pl.w_up.is_expert and not getattr(pl.gate.weight, "is_expert",
                                             False)


@pytest.mark.parametrize("gate_seed", [None, 4])
@pytest.mark.parametrize("gate", ["naive", "gshard", "switch"])
@pytest.mark.parametrize("dropless", [False, True])
def test_moe_layer_forward_matches_jax(dropless, gate, gate_seed):
    """y, l_aux and tokens_dropped against JAX in fp32, at the zero-init
    gate (every probability ties: tokens go to experts 0 then 1) and a
    random one; capacity factor 1.0 drops on the capacity path."""
    jl, pl = _layer_pair(gate, dropless, cf=1.0, seed=gate_seed)
    x = np.random.RandomState(5).randn(2, 12, 8).astype(np.float32)
    jy = jl(paddle.to_tensor(x))
    py = pl(_t(x))
    assert py.shape == (2, 12, 8)
    assert _rel(_np(py), np.asarray(jy._value)) <= TOL["float32"]
    assert abs(float(pl.l_aux) - float(jl.l_aux)) <= 1e-6
    assert pl.tokens_dropped.dtype == torch.float32
    assert float(pl.tokens_dropped) == float(jl.tokens_dropped)
    if not dropless and gate_seed is None:
        # 24 tokens, top-2 to experts 0 and 1, capacity 13 (top-1 7)
        assert float(pl.tokens_dropped) > 0


def _jax_op(dropless, args, topk, capacity, aux=True, activation="gelu"):
    kw = dict(topk=topk, activation=activation,
              aux_fn=jgate.load_balance_aux_loss if aux else None)
    if dropless:
        return jlayer._moe_dropless_op.raw_fn(*args, **kw)
    return jlayer._moe_forward_op.raw_fn(*args, capacity=capacity, **kw)


def _port_op(dropless, args, topk, capacity, aux=True, activation="gelu"):
    kw = dict(topk=topk, activation=activation,
              aux_fn=pgate.load_balance_aux_loss if aux else None)
    if dropless:
        return player._moe_dropless_op(*args, **kw)
    return player._moe_forward_op(*args, capacity=capacity, **kw)


@pytest.mark.parametrize("activation", ["gelu", "relu", "swiglu"])
@pytest.mark.parametrize("dropless", [False, True])
def test_moe_ops_grads_match_jax(dropless, activation):
    """Gradients of every input of the op (x, gate, banks, biases) against
    ``jax.grad`` of the same loss, fp32: the capacity path at a capacity
    that drops (the router's gradient flows through the combine weights
    and the aux loss), the dropless path through the plain B7/B8."""
    h = 32 if activation == "swiglu" else 16
    args = _op_args(20, 8, h, 4, 6)
    if activation == "swiglu":
        args[4] = args[4][:, :16]
    cap = 8

    def jloss(*a):
        y, aux, _ = _jax_op(dropless, a, 2, cap, activation=activation)
        return (y ** 2).sum() + 0.5 * aux

    want = jax.grad(jloss, argnums=tuple(range(6)))(
        *[jnp.asarray(a) for a in args])
    leaves = [_t(a, grad=True) for a in args]
    y, aux, dropped = _port_op(dropless, leaves, 2, cap,
                               activation=activation)
    ((y ** 2).sum() + 0.5 * aux).backward()
    assert not dropped.requires_grad
    for i, (leaf, w) in enumerate(zip(leaves, want)):
        assert _rel(_np(leaf.grad), w) <= TOL["float32"], i


@pytest.mark.parametrize("dropless", [False, True])
def test_moe_ops_bf16_match_jax(dropless):
    """bf16 inputs and weights (the train step's cast): y within the bf16
    gate of JAX's; the router runs in fp32 on the bf16 weights."""
    args = _op_args(32, 16, 32, 4, 7)
    jy, jaux, jd = _jax_op(dropless, [jnp.asarray(a, jnp.bfloat16)
                                      for a in args], 2, 20)
    py, paux, pd = _port_op(dropless, [_t(a, "bfloat16") for a in args], 2,
                            20)
    assert py.dtype == torch.bfloat16
    assert _rel(_np(py), np.asarray(jy, np.float32)) <= TOL["bfloat16"]
    assert abs(float(paux) - float(jaux)) <= 1e-6
    assert float(pd) == float(jd)


# ----------------------------------- tests/test_gpt_moe.py's dropless legs

def _moe_loop_reference(x2d, gate_w, w_up, b_up, w_down, b_down, topk):
    """Per-token float64 loop (capacity infinite), the experts' gelu in its
    tanh form (jax.nn.gelu's default), raw-probability combine."""
    logits = x2d.astype(np.float64) @ gate_w.astype(np.float64)
    probs = S.softmax(logits, axis=-1)
    y = np.zeros(x2d.shape, np.float64)
    for t in range(x2d.shape[0]):
        for e in np.argsort(-probs[t], kind="stable")[:topk]:
            h = x2d[t].astype(np.float64) @ w_up[e] + b_up[e]
            h = 0.5 * h * (1 + np.tanh(np.sqrt(2 / np.pi)
                                       * (h + 0.044715 * h ** 3)))
            y[t] += probs[t, e] * (h @ w_down[e] + b_down[e])
    return y


def test_dropless_matches_loop_reference():
    args = _op_args(12, 8, 16, 4, 0)
    y, _, _ = player._moe_dropless_op(*[_t(a) for a in args], topk=2)
    np.testing.assert_allclose(_np(y), _moe_loop_reference(*args, 2),
                               rtol=2e-4, atol=2e-5)
    jy, _, _ = jlayer._moe_dropless_op.raw_fn(
        *[jnp.asarray(a) for a in args], topk=2)
    assert _rel(_np(y), jy) <= TOL["float32"]


def test_dropless_matches_capacity_path_when_no_drops():
    args = [_t(a) for a in _op_args(16, 8, 12, 4, 1)]
    yd, _, dd = player._moe_dropless_op(*args, topk=2)
    yc, _, dc = player._moe_forward_op(*args, topk=2, capacity=16)
    assert float(dc) == 0.0 and float(dd) == 0.0
    assert _rel(_np(yd), _np(yc)) <= TOL["float32"]


def test_dropless_processes_skewed_routing():
    """Every token to expert 1: the capacity path at factor 1.2 drops most
    of them, the dropless path processes all (loop reference)."""
    g, m, h, e = 16, 8, 12, 4
    rng = np.random.RandomState(2)
    gate_w = np.zeros((m, e), np.float32)
    gate_w[:, 1] = 1.0
    x2d = np.abs(rng.randn(g, m)).astype(np.float32)
    w_up = (rng.randn(e, m, h) * 0.3).astype(np.float32)
    w_down = (rng.randn(e, h, m) * 0.3).astype(np.float32)
    zb_up, zb_down = np.zeros((e, h), np.float32), np.zeros((e, m),
                                                             np.float32)
    args = [x2d, gate_w, w_up, zb_up, w_down, zb_down]
    y, _, _ = player._moe_dropless_op(*[_t(a) for a in args], topk=1)
    np.testing.assert_allclose(_np(y), _moe_loop_reference(*args, 1),
                               rtol=2e-4, atol=2e-5)
    assert np.abs(_np(y)).sum() > 0
    cap = pgate.moe_capacity(g, 1, e, 1.2)
    _, _, dropped = player._moe_forward_op(*[_t(a) for a in args], topk=1,
                                           capacity=cap)
    assert float(dropped) == g - cap


def test_dropless_grads():
    """Finite, nonzero gradients for x, w_up and w_down, equal to
    ``jax.grad``'s (fp32)."""
    args = _op_args(8, 4, 8, 3, 3)
    args[3][:] = 0.0
    args[5][:] = 0.0

    def jloss(x, wu, wd):
        y, _, _ = jlayer._moe_dropless_op.raw_fn(
            x, jnp.asarray(args[1]), wu, jnp.asarray(args[3]), wd,
            jnp.asarray(args[5]), topk=2)
        return (y ** 2).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(args[0]), jnp.asarray(args[2]), jnp.asarray(args[4]))
    leaves = [_t(a, grad=i in (0, 2, 4)) for i, a in enumerate(args)]
    y, _, _ = player._moe_dropless_op(*leaves, topk=2)
    (y ** 2).sum().backward()
    for name, leaf, w in zip(("x", "w_up", "w_down"),
                             (leaves[0], leaves[2], leaves[4]), want):
        g = _np(leaf.grad)
        assert np.isfinite(g).all() and np.abs(g).sum() > 0, name
        assert _rel(g, w) <= TOL["float32"], name


def test_moe_layer_dropless_flag():
    torch.manual_seed(0)
    moe = pmoe.MoELayer(d_model=8, d_hidden=16, num_expert=4, gate="gshard",
                        dropless=True, device="cpu")
    out = moe(torch.rand(2, 6, 8))
    assert tuple(out.shape) == (2, 6, 8)
    assert torch.isfinite(out).all()
    assert moe.l_aux is not None and float(moe.tokens_dropped) == 0.0


def test_moe_layer_surfaces_dropped_tokens():
    """Skewed routing under a tight capacity factor reports a nonzero
    ``tokens_dropped`` (JAX's count); ample capacity reports 0."""
    x = np.abs(np.random.RandomState(0).randn(2, 8, 8)).astype(np.float32)
    jt, tight = _layer_pair("switch", cf=0.25)
    gw = np.zeros((8, 4), np.float32)
    gw[:, 1] = 1.0
    jt.gate.weight.set_value(jnp.asarray(gw))
    with torch.no_grad():
        tight.gate.weight.copy_(torch.from_numpy(gw))
    jt(paddle.to_tensor(x))
    tight(_t(x))
    assert float(tight.tokens_dropped) > 0
    assert float(tight.tokens_dropped) == float(jt.tokens_dropped)
    ample = pmoe.MoELayer(d_model=8, d_hidden=16, num_expert=4,
                          gate="gshard", capacity_factor=4.0, device="cpu")
    ample(_t(x))
    assert float(ample.tokens_dropped) == 0.0


# ------------------------------------------------------------------ fused_moe

def _fused_args(seed, shape=(2, 6, 8), h=16, e=4):
    rng = np.random.default_rng(seed)
    m = shape[-1]
    return [rng.standard_normal(shape).astype("float32"),
            rng.standard_normal((m, e)).astype("float32"),
            (rng.standard_normal((e, m, h)) * 0.1).astype("float32"),
            (rng.standard_normal((e, h, m)) * 0.1).astype("float32"),
            (rng.standard_normal((e, h)) * 0.01).astype("float32"),
            (rng.standard_normal((e, m)) * 0.01).astype("float32")]


@pytest.mark.parametrize("norm", [True, False])
def test_fused_moe_matches_manual_topk_and_jax(norm):
    """Dense no-drop evaluation against a per-token loop (the JAX leg's
    golden, with the experts' tanh gelu) and against JAX's fused_moe."""
    x, gw, w1, w2, b1, b2 = _fused_args(0)
    out = fused_moe(*[_t(a) for a in (x, gw, w1, w2, b1, b2)], moe_topk=2,
                    norm_topk_prob=norm)
    x2 = x.reshape(-1, 8)
    probs = S.softmax(x2.astype(np.float64) @ gw, axis=-1)
    want = np.zeros(x2.shape)
    for g in range(x2.shape[0]):
        idx = np.argsort(-probs[g], kind="stable")[:2]
        wts = probs[g][idx] / (probs[g][idx].sum() if norm else 1.0)
        for wi, e in zip(wts, idx):
            hh = x2[g] @ w1[e] + b1[e]
            hh = 0.5 * hh * (1 + np.tanh(np.sqrt(2 / np.pi)
                                         * (hh + 0.044715 * hh ** 3)))
            want[g] += wi * (hh @ w2[e] + b2[e])
    np.testing.assert_allclose(_np(out).reshape(-1, 8), want, atol=2e-5,
                               rtol=1e-4)
    jout = jfused_moe(*[paddle.to_tensor(a) for a in (x, gw, w1, w2, b1,
                                                      b2)],
                      moe_topk=2, norm_topk_prob=norm)
    assert _rel(_np(out), np.asarray(jout._value)) <= TOL["float32"]


@pytest.mark.parametrize("activation", ["gelu", "relu", "swiglu"])
def test_fused_moe_grads_flow_and_match_jax(activation):
    x, gw, w1, w2, _, _ = _fused_args(1, (1, 4, 8), h=16)
    if activation == "swiglu":
        w2 = w2[:, :8]

    want = jax.grad(lambda x, w1: (_fused_moe_op.raw_fn(
        x, jnp.asarray(gw), w1, jnp.asarray(w2), moe_topk=2,
        activation=activation) ** 2).sum(), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(w1))
    tx, tw1 = _t(x, grad=True), _t(w1, grad=True)
    (fused_moe(tx, _t(gw), tw1, _t(w2), moe_topk=2,
               activation=activation) ** 2).sum().backward()
    assert tx.grad is not None and tw1.grad is not None
    assert _rel(_np(tx.grad), want[0]) <= TOL["float32"]
    assert _rel(_np(tw1.grad), want[1]) <= TOL["float32"]


def test_fused_moe_refuses_unknown_activation():
    x, gw, w1, w2, _, _ = _fused_args(2)
    with pytest.raises(ValueError, match="unsupported activation"):
        fused_moe(*[_t(a) for a in (x, gw, w1, w2)], activation="tanh")


# ---------------------------------------------------------------- grad clip

def test_moe_grad_clip_global_norm_matches_jax():
    """Expert and dense norms combine into one global norm (the JAX leg's
    checks), and the clipped grads and both norms equal JAX's clip on the
    same gradients."""
    paddle.seed(7)
    jl = jmoe.MoELayer(d_model=8, d_hidden=16, num_expert=2, gate="gshard",
                       capacity_factor=2.0)
    dense = paddle.nn.Linear(8, 8)
    jparams = list(jl.parameters()) + list(dense.parameters())
    y = dense(jl(paddle.rand([2, 4, 8])))
    ((y ** 2).mean() + 0.01 * jl.l_aux).backward()
    jgrads = [p.grad for p in jparams]
    jclip = jmoe.ClipGradForMOEByGlobalNorm(clip_norm=1e-4)
    jclipped = jclip(jparams, jgrads)

    pl = pmoe.MoELayer(d_model=8, d_hidden=16, num_expert=2, gate="gshard",
                       capacity_factor=2.0, device="cpu")
    pparams = list(pl.parameters()) + [torch.nn.Parameter(torch.zeros(8, 8)),
                                       torch.nn.Parameter(torch.zeros(8))]
    assert [p.shape for p in pparams] == [tuple(p.shape) for p in jparams]
    grads = [None if g is None else _t(np.asarray(g._value))
             for g in jgrads]
    clip = pmoe.ClipGradForMOEByGlobalNorm(clip_norm=1e-4)
    assert isinstance(clip, GradClipBase)
    clipped = clip(pparams, grads)
    total = sum(float((np.asarray(g._value, np.float64) ** 2).sum())
                for g in jgrads if g is not None)
    np.testing.assert_allclose(clip.last_global_norm, math.sqrt(total),
                               rtol=1e-4)
    assert clip.last_moe_norm < clip.last_global_norm
    np.testing.assert_allclose(clip.last_global_norm,
                               jclip.last_global_norm, rtol=1e-6)
    np.testing.assert_allclose(clip.last_moe_norm, jclip.last_moe_norm,
                               rtol=1e-6)
    for c, jc in zip(clipped, jclipped):
        if c is None:
            assert jc is None
            continue
        np.testing.assert_allclose(c.numpy(), np.asarray(jc._value),
                                   rtol=1e-6, atol=1e-12)
    clipped_norm = math.sqrt(sum(float((c.double() ** 2).sum())
                                 for c in clipped if c is not None))
    np.testing.assert_allclose(clipped_norm, 1e-4, rtol=1e-4)


def test_moe_grad_clip_respects_need_clip():
    p1 = torch.nn.Parameter(torch.ones(4))
    p2 = torch.nn.Parameter(torch.ones(4))
    p2.need_clip = False
    g1 = torch.full((4,), 10.0)
    g2 = torch.full((4,), 10.0)
    clip = pmoe.ClipGradForMOEByGlobalNorm(clip_norm=1.0)
    c1, c2 = clip([p1, p2], [g1, g2])
    assert float(c1.abs().max()) < 1.0
    np.testing.assert_allclose(c2.numpy(), 10.0)
    assert clip.last_moe_norm == 0.0
    np.testing.assert_allclose(clip.last_global_norm, 20.0, rtol=1e-6)


# ------------------------------------------------------- pipelined reference

def _one_device_mesh(names):
    return Mesh(np.asarray(jax.devices("cpu")[:1], dtype=object).reshape(
        (1,) * len(names)), names)


def test_pipelined_reference_matches_jax():
    """``init_pipelined_moe_params`` (no mesh) draws what JAX draws;
    ``moe_block`` and ``sequential_moe_forward`` match JAX's fp32."""
    jp = jpipe.init_pipelined_moe_params(
        _one_device_mesh(("pp", "ep", "mp")), num_layers=2, num_expert=4,
        d_model=8, d_hidden=16)
    pp = ppipe.init_pipelined_moe_params(None, num_layers=2, num_expert=4,
                                         d_model=8, d_hidden=16,
                                         device="cpu")
    assert sorted(pp) == sorted(jp)
    for k in jp:
        np.testing.assert_array_equal(pp[k].numpy(), np.asarray(jp[k]))
    x = np.random.RandomState(0).randn(2, 8, 8).astype(np.float32)
    host = {k: jnp.asarray(np.asarray(v)) for k, v in jp.items()}
    want = jpipe.sequential_moe_forward(host, jnp.asarray(x))
    got = ppipe.sequential_moe_forward(pp, _t(x))
    assert _rel(_np(got), want) <= TOL["float32"]
    lp = {k: v[0] for k, v in pp.items()}
    blk = ppipe.moe_block(lp, _t(x[0]))
    jblk = jpipe.moe_block({k: v[0] for k, v in host.items()},
                           jnp.asarray(x[0]))
    assert _rel(_np(blk), jblk) <= TOL["float32"]


# ------------------------------------------ capacity EP block, degree 1

_CFG = dict(d_model=8, d_hidden=16, num_expert=4, top_k=2,
            capacity_factor=8.0, aux_weight=0.01)


def _ep_mesh1():
    return _one_device_mesh(("dp", "sharding", "ep"))


def _data(g=64, m=8, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(g, m).astype(np.float32),
            rng.randn(g, m).astype(np.float32))


def _port_params(cfg):
    return pexp.init_moe_ep_params(cfg, device="cpu")


def test_ep_capacity_uses_moe_capacity():
    cfg = pexp.MoEEPConfig(**_CFG)
    jcfg = jexp.MoEEPConfig(**_CFG)
    for g in (1, 17, 64, 8192):
        assert cfg.ep_capacity(g) == jcfg.ep_capacity(g) == \
            pgate.moe_capacity(g, 2, 4, 8.0)
    pinned = pexp.MoEEPConfig(**dict(_CFG, capacity=5))
    assert pinned.ep_capacity(1000) == 5


def test_ep_forward_matches_dense_and_jax_no_drops():
    """The capacity EP forward at degree 1 against the dense capacity op
    (nothing dropped, as the JAX leg) and against JAX's EP forward on a
    one-device mesh: y, aux, dropped, load."""
    cfg = pexp.MoEEPConfig(**_CFG)
    params = _port_params(cfg)
    x2d, _ = _data()
    y, aux, dropped, load = pexp.build_moe_ep_forward(cfg)(params, _t(x2d))
    yd, auxd, dd = player._moe_forward_op(
        _t(x2d), params["gate_w"], params["w_up"], params["b_up"],
        params["w_down"], params["b_down"], topk=2, capacity=64,
        aux_fn=pgate.load_balance_aux_loss)
    assert float(dropped) == 0.0 and float(dd) == 0.0
    assert _rel(_np(y), _np(yd)) <= 1e-6
    np.testing.assert_allclose(float(aux), float(auxd), rtol=1e-6)
    np.testing.assert_allclose(float(load.sum()), 1.0, rtol=1e-6)
    jcfg = jexp.MoEEPConfig(**_CFG)
    mesh = _ep_mesh1()
    jy, jaux, jdrop, jload = jax.jit(jexp.build_moe_ep_forward(jcfg, mesh))(
        jexp.init_moe_ep_params(jcfg, mesh), jnp.asarray(x2d))
    assert _rel(_np(y), jy) <= TOL["float32"]
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    np.testing.assert_array_equal(load.numpy(), np.asarray(jload))
    assert float(jdrop) == 0.0


def test_ep_grads_match_dense():
    """Every leaf's EP gradient equals the dense capacity op's (the JAX
    grad-sync leg at degree 1: no exchange, so this pins the dispatch and
    combine einsums' transposes) and JAX's EP gradient."""
    cfg = pexp.MoEEPConfig(**_CFG)
    x2d, tgt = _data()
    fwd = pexp.build_moe_ep_forward(cfg)

    def port_grads(forward):
        leaves = {k: v.clone().requires_grad_()
                  for k, v in _port_params(cfg).items()}
        y, aux = forward(leaves)[:2]
        total, at = pexp._moe_loss(y, _t(x2d), _t(tgt), aux, cfg.aux_weight)
        (total / 64 + at).backward()
        return {k: v.grad for k, v in leaves.items()}

    eg = port_grads(lambda p: fwd(p, _t(x2d)))
    dg = port_grads(lambda p: player._moe_forward_op(
        _t(x2d), p["gate_w"], p["w_up"], p["b_up"], p["w_down"],
        p["b_down"], topk=2, capacity=64,
        aux_fn=pgate.load_balance_aux_loss))
    jcfg = jexp.MoEEPConfig(**_CFG)
    mesh = _ep_mesh1()
    jfwd = jexp.build_moe_ep_forward(jcfg, mesh)

    def jloss(p):
        y, aux, _, _ = jfwd(p, jnp.asarray(x2d))
        total, at = jexp._moe_loss(y, jnp.asarray(x2d), jnp.asarray(tgt),
                                   aux, jcfg.aux_weight)
        return total / 64 + at

    jg = jax.jit(jax.grad(jloss))(jexp.init_moe_ep_params(jcfg, mesh))
    for k in sorted(eg):
        np.testing.assert_allclose(eg[k].numpy(), dg[k].numpy(), rtol=2e-5,
                                   atol=2e-6, err_msg=k)
        assert _rel(_np(eg[k]), jg[k]) <= TOL["float32"], k


def test_ep_train_loss_parity_vs_dense_and_jax():
    """The capacity EP step against the dense reference step (shards 8)
    over 5 steps (nothing drops) and against JAX's EP step: losses and
    final params."""
    cfg = pexp.MoEEPConfig(**_CFG)
    jcfg = jexp.MoEEPConfig(**_CFG)
    mesh = _ep_mesh1()
    x2d, tgt = _data()
    params, host = _port_params(cfg), _port_params(cfg)
    jparams = jexp.init_moe_ep_params(jcfg, mesh)
    step = pexp.build_moe_ep_train_step(cfg)
    dstep = pexp.build_moe_dense_train_step(cfg, shards=8)
    jstep = jexp.build_moe_ep_train_step(jcfg, mesh)
    for i in range(5):
        loss, aux, dropped, load, out = step(params, _t(x2d), _t(tgt))
        assert out is params
        dloss, daux, ddropped, _ = dstep(host, _t(x2d), _t(tgt))
        jloss, jaux, jdrop, jload, jparams = jstep(
            jparams, jnp.asarray(x2d), jnp.asarray(tgt))
        assert float(dropped) == 0.0 == float(ddropped)
        np.testing.assert_allclose(float(loss), float(dloss), rtol=1e-5)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(params[k].numpy(), host[k].numpy(),
                                   rtol=1e-4, atol=1e-5)
        assert _rel(params[k].numpy(), jparams[k]) <= TOL["float32"], k


def test_ep_capacity_overflow_surfaces():
    """Forced skew under a tight capacity factor: the EP forward reports
    the drops (JAX's count) and stays finite."""
    cfg = pexp.MoEEPConfig(d_model=8, d_hidden=16, num_expert=4, top_k=1,
                           capacity_factor=0.25, aux_weight=0.01)
    params = _port_params(cfg)
    params["gate_w"] = torch.zeros_like(params["gate_w"])
    params["gate_w"][:, 1] = 4.0
    x2d = np.abs(_data()[0])
    y, aux, dropped, load = pexp.build_moe_ep_forward(cfg)(params, _t(x2d))
    assert float(dropped) > 0 and torch.isfinite(y).all()
    jcfg = jexp.MoEEPConfig(d_model=8, d_hidden=16, num_expert=4, top_k=1,
                            capacity_factor=0.25, aux_weight=0.01)
    mesh = _ep_mesh1()
    jp = jexp.init_moe_ep_params(jcfg, mesh)
    jp["gate_w"] = jnp.zeros_like(jp["gate_w"]).at[:, 1].set(4.0)
    _, _, jdrop, _ = jax.jit(jexp.build_moe_ep_forward(jcfg, mesh))(
        jp, jnp.asarray(x2d))
    assert float(dropped) == float(jdrop)


# ---------------------- tests/test_moe_dropless.py at ample capacity

def _ample_cfg(m=16, h=32, e=8, g=64):
    return pexp.MoEEPConfig(d_model=m, d_hidden=h, num_expert=e, top_k=2,
                            capacity=g * 2, aux_weight=0.01)


def _ample_data(g, m, seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((g, m)).astype(np.float32),
            rng.standard_normal((g, m)).astype(np.float32))


def test_dropless_step0_equals_capacity_at_ample_capacity():
    """Dropless and capacity compute one function when nothing can drop:
    step-0 loss and aux within fp32 rounding (JAX holds its two engines
    bit-equal; here the capacity path sums over all E x C slots in an
    einsum and the dropless one scatter-adds two copies, so they agree to
    one ulp), both dropped 0, and each equal to JAX's step 0."""
    cfg = _ample_cfg()
    x2d, tgt = _ample_data(64, cfg.d_model)
    lc, ac, dc, _, _ = pexp.build_moe_ep_train_step(cfg)(
        _port_params(cfg), _t(x2d), _t(tgt))
    ld, ad, dd, _, _ = pexp.build_moe_ep_dropless_train_step(cfg)(
        _port_params(cfg), _t(x2d), _t(tgt))
    assert float(dc) == 0.0 and float(dd) == 0.0
    np.testing.assert_allclose(float(lc), float(ld), rtol=1e-6)
    assert float(ac) == float(ad)
    jcfg = jexp.MoEEPConfig(d_model=16, d_hidden=32, num_expert=8, top_k=2,
                            capacity=128, aux_weight=0.01)
    mesh = _ep_mesh1()
    jl, ja, _, _, _ = jexp.build_moe_ep_train_step(jcfg, mesh)(
        jexp.init_moe_ep_params(jcfg, mesh), jnp.asarray(x2d),
        jnp.asarray(tgt))
    np.testing.assert_allclose(float(lc), float(jl), rtol=1e-6)
    np.testing.assert_allclose(float(ac), float(ja), rtol=1e-6)


def test_dropless_grads_match_capacity():
    """Per-leaf gradient parity of the two engines at ample capacity,
    within 2e-7 absolute (JAX's bound)."""
    cfg = _ample_cfg(16, 32, 8)
    x2d, tgt = _ample_data(64, 16)

    def grads(fwd):
        leaves = {k: v.clone().requires_grad_()
                  for k, v in _port_params(cfg).items()}
        y, aux = fwd(leaves, _t(x2d))[:2]
        tot, at = pexp._moe_loss(y, _t(x2d), _t(tgt), aux, cfg.aux_weight)
        (tot / 64 + at).backward()
        return {k: v.grad for k, v in leaves.items()}

    gc = grads(pexp.build_moe_ep_forward(cfg))
    gd = grads(pexp.build_moe_ep_dropless_forward(cfg))
    for k in gc:
        diff = (gc[k].double() - gd[k].double()).abs().max().item()
        assert diff <= 2e-7, (k, diff)


def test_dropless_step_lr_1e2_at_width_4096_grows_as_jax():
    """ROADMAP check C.1 (the MoE train cell's learning rate): JAX's own
    dropless step at d_model 4096 and its default lr 1e-2 diverges, and the
    port's step follows it.  On 32 tokens and two experts of d_hidden 4096
    the JAX loss grows 9957 -> 38261 -> 4.6e6 over three steps; the port's
    losses are within 1e-5 of JAX's at each step."""
    jcfg = jexp.MoEEPConfig(d_model=4096, d_hidden=4096, num_expert=2)
    cfg = pexp.MoEEPConfig(d_model=4096, d_hidden=4096, num_expert=2)
    mesh = _ep_mesh1()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 4096)).astype(np.float32)
    t = rng.standard_normal((32, 4096)).astype(np.float32)
    jp = jexp.init_moe_ep_params(jcfg, mesh)
    jstep = jexp.build_moe_ep_dropless_train_step(jcfg, mesh, lr=1e-2)
    params = pexp.init_moe_ep_params(cfg, device="cpu")
    step = pexp.build_moe_ep_dropless_train_step(cfg, lr=1e-2)
    jlosses, losses = [], []
    for _ in range(3):
        jl, _, _, _, jp = jstep(jp, jnp.asarray(x), jnp.asarray(t))
        jlosses.append(float(jl))
        losses.append(float(step(params, _t(x), _t(t))[0]))
    assert jlosses[0] < jlosses[1] < jlosses[2] and jlosses[2] > 100 * \
        jlosses[0], jlosses
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)


# ------------------------------------------- the multi-GPU pieces' guards

def _two_devices():
    return types.SimpleNamespace(shape=(2,))


def _overlap_config():
    from paddle_tpu_torch.parallel.overlap import OverlapConfig

    return OverlapConfig()


# since expert parallelism and the pipelined MoE blocks are ported, a mesh
# must be a live parallel.specs.Mesh (an object that is not one is refused
# by type); the pipelined forwards run in tests/test_torch_pipeline.py
@pytest.mark.parametrize("call,exc,match", [
    (lambda: pmoe.MoELayer(8, 16, 4, mesh=_two_devices(), device="cpu"),
     TypeError, "parallel.specs.Mesh"),
    (lambda: ppipe.init_pipelined_moe_params(_two_devices(), 2, 4, 8, 16,
                                             device="cpu"),
     TypeError, "parallel.specs.Mesh"),
    (lambda: ppipe.pipelined_moe_forward({}, None, None),
     TypeError, "parallel.specs.Mesh"),
    (lambda: ppipe.moe_block_ep({}, None),
     TypeError, "parallel.specs.Mesh"),
    (lambda: ppipe.pipelined_moe_forward_ep({}, None, None),
     TypeError, "parallel.specs.Mesh"),
    (lambda: pexp.build_moe_ep_forward(pexp.MoEEPConfig(**_CFG),
                                       _two_devices()),
     TypeError, "parallel.specs.Mesh"),
    (lambda: pexp.build_moe_ep_forward(pexp.MoEEPConfig(**_CFG),
                                       _two_devices(),
                                       oc=_overlap_config()),
     TypeError, "parallel.specs.Mesh"),
    (lambda: pexp.build_moe_ep_train_step(pexp.MoEEPConfig(**_CFG),
                                          _two_devices()),
     TypeError, "parallel.specs.Mesh"),
    (lambda: pexp.build_moe_ep_dropless_forward(pexp.MoEEPConfig(**_CFG),
                                                _two_devices()),
     TypeError, "parallel.specs.Mesh"),
], ids=["moe_layer_mesh", "init_pipelined_mesh", "pipelined_forward",
        "moe_block_ep", "pipelined_forward_ep", "ep_forward_mesh",
        "ep_forward_overlap", "ep_train_step_mesh", "dropless_mesh"])
def test_multi_gpu_pieces_raise_citing_a5(call, exc, match):
    with pytest.raises(exc, match=match):
        call()
