"""The port's optimizer package (optimizer/optimizer.py, optimizer/clip.py,
regularizer.py) against the JAX package's on the CPU.

Every optimizer takes the same seeded numpy parameters and gradients in both
packages, five functional ``apply`` steps and five eager ``step()``s (the
JAX ``Parameter._grad`` against the port's ``torch.nn.Parameter.grad``), and
the parameters and states must agree in fp32 within 1e-5 of the largest
magnitude (the same fp32 arithmetic in another order).  Then the decay
rules (regularizer precedence, ``no_weight_decay``, ``lr_ratio``,
``apply_decay_param_fun``), the three clips and the functional clip,
``need_clip``, ``state_dict`` round trips, ``LBFGS`` with a closure and
``lazy_mode``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu.optimizer import clip as jclip
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.optimizer import clip as tclip

TOL = 1e-5
SHAPES = {"w": (4, 3), "b": (5,), "s": (2, 2, 2)}

# (name, constructor kwargs, learning rate)
CASES = [
    ("SGD", dict(weight_decay=0.01), 0.1),
    ("Momentum", dict(momentum=0.9, use_nesterov=True, weight_decay=0.01),
     0.05),
    ("Adam", dict(weight_decay=0.01), 0.01),
    ("AdamW", dict(weight_decay=0.05), 0.01),
    ("Adagrad", dict(weight_decay=0.01, initial_accumulator_value=0.1), 0.1),
    ("RMSProp", dict(momentum=0.5, centered=True, weight_decay=0.01), 0.01),
    ("Adamax", dict(weight_decay=0.01), 0.01),
    ("Lamb", dict(lamb_weight_decay=0.01), 0.01),
    ("LarsMomentum", dict(), 0.1),
    ("Adadelta", dict(rho=0.9, epsilon=1e-2, weight_decay=0.01), 1.0),
    ("ASGD", dict(batch_num=3, weight_decay=0.01), 0.1),
    ("Rprop", dict(learning_rate_range=(1e-4, 1.0)), 0.01),
    ("NAdam", dict(weight_decay=0.01), 0.01),
    ("RAdam", dict(weight_decay=0.01), 0.01),
    ("LBFGS", dict(history_size=3), 0.1),
]
IDS = [c[0] for c in CASES]


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    den = np.abs(want).max()
    return float(np.abs(got - want).max() / (den if den > 0 else 1.0))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(getattr(x, "_value", x))


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(step, seed=1):
    rng = np.random.default_rng(seed * 100 + step)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


TARGET = _params(99)


def _step_grads(name, step, params):
    """The gradients of one step: seeded noise, or for LBFGS, whose
    curvature pairs (s, y) are differences of iterates and gradients, those
    of the quadratic ||x - TARGET||^2 at the port's current params (random
    gradients would make s.y cancel to noise)."""
    if name != "LBFGS":
        return _grads(step)
    return {k: (2.0 * (np.asarray(params[k], np.float32) - TARGET[k])
                ).astype(np.float32) for k in SHAPES}


def _assert_states(tstate, jstate, what):
    assert set(tstate) == set(jstate), what
    for k, v in jstate.items():
        if isinstance(v, dict):
            _assert_states(tstate[k], v, f"{what}.{k}")
        else:
            assert _rel(_np(tstate[k]), _np(v)) <= TOL, (what, k)


@pytest.mark.parametrize("name,kw,lr", CASES, ids=IDS)
def test_apply_matches_jax(name, kw, lr):
    """Five functional steps; a decay mask exempts ``b``."""
    jo = getattr(jopt, name)(learning_rate=lr, parameters=[], **kw)
    to = getattr(topt, name)(learning_rate=lr, **kw)
    p0 = _params()
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jo.init_state(jp), to.init_state(tp)
    mask = {"w": True, "b": False, "s": True}
    for t in range(1, 6):
        g = _step_grads(name, t, {k: _np(v) for k, v in tp.items()})
        jp, js = jo.apply(jp, {k: jnp.asarray(v) for k, v in g.items()}, js,
                          lr, t, decay_mask=mask)
        tp, ts = to.apply(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                          ts, lr, t, decay_mask=mask)
    for k in p0:
        assert _rel(_np(tp[k]), _np(jp[k])) <= TOL, (name, k)
    _assert_states(ts, js, name)


def _eager_pair(name, kw, lr, p0, jax_setup=None, torch_setup=None):
    jps = [paddle.nn.Parameter(v.copy(), name=k) for k, v in p0.items()]
    tps = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in p0.values()]
    for setup, ps in ((jax_setup, jps), (torch_setup, tps)):
        if setup is not None:
            setup(ps)
    jo = getattr(jopt, name)(learning_rate=lr, parameters=jps, **kw)
    # the port takes names from named_parameters()-style pairs
    to = getattr(topt, name)(learning_rate=lr, parameters=list(zip(p0, tps)),
                             **kw)
    return jo, to, jps, tps


def _eager_steps(jo, to, jps, tps, keys, steps=range(1, 6), name=""):
    for t in steps:
        g = _step_grads(name, t, {k: _np(p) for k, p in zip(keys, tps)})
        for jp, tp, k in zip(jps, tps, keys):
            jp._grad = paddle.to_tensor(g[k])
            tp.grad = torch.from_numpy(g[k])
        jo.step()
        to.step()
        jo.clear_grad()
        to.clear_grad()


@pytest.mark.parametrize("name,kw,lr", CASES, ids=IDS)
def test_eager_step_matches_jax(name, kw, lr):
    """Five eager steps over Parameters; the port's update is in place."""
    p0 = _params(2)
    jo, to, jps, tps = _eager_pair(name, kw, lr, p0)
    storage = [p.data_ptr() for p in tps]
    _eager_steps(jo, to, jps, tps, list(p0), name=name)
    assert [p.data_ptr() for p in tps] == storage
    assert all(p.grad is None for p in tps)
    for jp, tp, k in zip(jps, tps, p0):
        assert _rel(_np(tp), jp.numpy()) <= TOL, (name, k)
        _assert_states(to._state[id(tp)], jo._state[id(jp)], f"{name}.{k}")


def test_frozen_and_gradless_parameters_are_left_alone():
    p0 = _params(3)
    jo, to, jps, tps = _eager_pair("Adam", {}, 0.1, p0)
    tps[0].requires_grad_(False)
    tps[0].grad = torch.ones_like(tps[0])
    to.step()                                   # frozen w, no grad for b, s
    for tp, v in zip(tps, p0.values()):
        assert np.array_equal(_np(tp), v)
    assert to._state == {}


def test_regularizer_precedence_apply_matches_jax():
    """Optimizer-level L2Decay, a per-parameter L1Decay override (which
    also drops the float decay) and a masked parameter (no decay at all),
    on the coupled Adam and on SGD."""
    for cls in ("Adam", "SGD"):
        jo = getattr(jopt, cls)(0.1, parameters=[],
                                weight_decay=jreg.L2Decay(0.1))
        to = getattr(topt, cls)(0.1, weight_decay=treg.L2Decay(0.1))
        p0 = _params(4)
        jp = {k: jnp.asarray(v) for k, v in p0.items()}
        tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        js, ts = jo.init_state(jp), to.init_state(tp)
        for t in range(1, 4):
            g = _grads(t)
            jp, js = jo.apply(jp, {k: jnp.asarray(v) for k, v in g.items()},
                              js, 0.1, t, decay_mask={"b": False},
                              regularizers={"s": jreg.L1Decay(0.2)})
            tp, ts = to.apply(tp, {k: torch.from_numpy(v)
                                   for k, v in g.items()},
                              ts, 0.1, t, decay_mask={"b": False},
                              regularizers={"s": treg.L1Decay(0.2)})
        for k in p0:
            assert _rel(_np(tp[k]), _np(jp[k])) <= TOL, (cls, k)
    adam = topt.Adam(0.1, weight_decay=treg.L2Decay(0.1))
    with pytest.raises(NotImplementedError, match="per-param"):
        adam.apply_flat(tp, tp, adam.init_flat_state(tp), 0.1, 1)


def test_regularizer_attributes_eager_match_jax():
    """Eager: ``p.regularizer`` overrides the optimizer's L2Decay and the
    float decay; ``no_weight_decay`` turns every decay off."""
    def setup(ps):
        ps[0].regularizer = (jreg if isinstance(ps[0], paddle.nn.Parameter)
                             else treg).L1Decay(0.3)
        ps[1].no_weight_decay = True

    p0 = _params(5)
    jo, to, jps, tps = _eager_pair("Momentum", dict(weight_decay=0.05), 0.1,
                                   p0, setup, setup)
    _eager_steps(jo, to, jps, tps, list(p0))
    for jp, tp in zip(jps, tps):
        assert _rel(_np(tp), jp.numpy()) <= TOL
    jo = jopt.SGD(0.1, parameters=[paddle.nn.Parameter(p0["w"])],
                  weight_decay=jreg.L2Decay(0.2))
    tw = torch.nn.Parameter(torch.from_numpy(p0["w"].copy()))
    to = topt.SGD(0.1, parameters=[tw], weight_decay=treg.L2Decay(0.2))
    jo._parameters[0]._grad = paddle.to_tensor(_grads(1)["w"])
    tw.grad = torch.from_numpy(_grads(1)["w"])
    jo.step()
    to.step()
    assert _rel(_np(tw), jo._parameters[0].numpy()) <= TOL


def test_adamw_lr_ratio_and_apply_decay_param_fun_match_jax():
    p0 = _params(6)
    kw = dict(weight_decay=0.1, apply_decay_param_fun=lambda n: n != "b")
    jo, to, jps, tps = _eager_pair("AdamW", kw, 0.05, p0)
    # lr_ratio gets the parameter: halve the first one's rate in both
    jo._lr_ratio_fn = lambda p: 0.5 if p is jps[0] else 1.0
    to._lr_ratio_fn = lambda p: 0.5 if p is tps[0] else 1.0
    _eager_steps(jo, to, jps, tps, list(p0))
    for jp, tp, k in zip(jps, tps, p0):
        assert _rel(_np(tp), jp.numpy()) <= TOL, k
    assert getattr(tps[1], "no_weight_decay", False)
    assert not getattr(tps[0], "no_weight_decay", False)


def test_lamb_exclude_fn_matches_jax():
    p0 = _params(7)
    kw = dict(lamb_weight_decay=0.1)
    jo, to, jps, tps = _eager_pair("Lamb", kw, 0.05, p0)
    jo._exclude_fn = lambda p: p is jps[2]
    to._exclude_fn = lambda p: p is tps[2]
    _eager_steps(jo, to, jps, tps, list(p0))
    for jp, tp in zip(jps, tps):
        assert _rel(_np(tp), jp.numpy()) <= TOL


@pytest.mark.parametrize("clip", ["value", "norm", "global"])
def test_clips_match_jax(clip):
    """The three clips on the same gradients (one None, one parameter with
    need_clip False), then an eager SGD step clipped by each."""
    make = {"value": lambda m: m.ClipGradByValue(0.5, -0.3),
            "norm": lambda m: m.ClipGradByNorm(1.0),
            "global": lambda m: m.ClipGradByGlobalNorm(1.5)}[clip]
    p0, g = _params(8), _grads(1)
    jps = [paddle.nn.Parameter(v) for v in p0.values()]
    tps = [torch.nn.Parameter(torch.from_numpy(v.copy()))
           for v in p0.values()]
    jps[2].need_clip = False
    tps[2].need_clip = False
    jg = [paddle.to_tensor(g["w"]), None, paddle.to_tensor(g["s"])]
    tg = [torch.from_numpy(g["w"]), None, torch.from_numpy(g["s"])]
    jout = make(jclip)(jps, jg)
    tout = make(tclip)(tps, tg)
    assert tout[1] is None and jout[1] is None
    for got, want in ((tout[0], jout[0]), (tout[2], jout[2])):
        assert _rel(_np(got), _np(want)) <= TOL
    if clip == "global":
        assert torch.equal(tout[2], tg[2])      # need_clip False: untouched
    jo, to, jps, tps = _eager_pair("SGD", dict(grad_clip=make(jclip)), 1.0,
                                   p0)
    to._grad_clip = make(tclip)
    jps[0].need_clip = tps[0].need_clip = False
    _eager_steps(jo, to, jps, tps, list(p0), steps=[1])
    for jp, tp in zip(jps, tps):
        assert _rel(_np(tp), jp.numpy()) <= TOL


def test_clip_grads_functional_matches_jax():
    g = _grads(3)
    jc, jn = jclip.clip_grads_functional(
        {k: jnp.asarray(v) for k, v in g.items()}, 2.0)
    tc, tn = tclip.clip_grads_functional(
        {k: torch.from_numpy(v) for k, v in g.items()}, 2.0)
    assert _rel(_np(tn), _np(jn)) <= TOL
    for k in g:
        assert _rel(_np(tc[k]), _np(jc[k])) <= TOL
    big = {k: torch.from_numpy(v) * 0.01 for k, v in g.items()}
    same, _ = tclip.clip_grads_functional(big, 2.0)   # under the norm
    assert all(torch.equal(same[k], big[k]) for k in g)


@pytest.mark.parametrize("name,kw,lr", [CASES[2], CASES[10], CASES[14]],
                         ids=["Adam", "ASGD", "LBFGS"])
def test_state_dict_round_trip(name, kw, lr):
    """Three eager steps, a state_dict into a fresh optimizer, two more
    steps: equal to five uninterrupted ones, and the keys are JAX's."""
    p0 = _params(9)
    jo, to, jps, tps = _eager_pair(name, kw, lr, p0)
    _eager_steps(jo, to, jps, tps, list(p0), steps=range(1, 4))
    sd = to.state_dict()
    assert set(sd) == set(jo.state_dict())
    fresh = getattr(topt, name)(learning_rate=lr, parameters=tps, **kw)
    fresh.set_state_dict(sd)
    assert fresh._global_step == 3
    _eager_steps(jo, fresh, jps, tps, list(p0), steps=range(4, 6))
    for jp, tp in zip(jps, tps):
        assert _rel(_np(tp), jp.numpy()) <= TOL


def test_scheduler_learning_rate_and_state_dict():
    """A scheduler as learning_rate: get_lr follows it, state_dict carries
    it, set_lr replaces it; the eager steps match JAX's."""
    p0 = _params(10)
    jsched = jopt.lr.StepDecay(0.1, step_size=2, gamma=0.5)
    tsched = topt.lr.StepDecay(0.1, step_size=2, gamma=0.5)
    jps = [paddle.nn.Parameter(v) for v in p0.values()]
    tps = [torch.nn.Parameter(torch.from_numpy(v.copy()))
           for v in p0.values()]
    jo = jopt.Momentum(jsched, parameters=jps)
    to = topt.Momentum(tsched, parameters=tps)
    for t in range(1, 6):
        assert to.get_lr() == jo.get_lr()
        _eager_steps(jo, to, jps, tps, list(p0), steps=[t])
        jsched.step()
        tsched.step()
    for jp, tp in zip(jps, tps):
        assert _rel(_np(tp), jp.numpy()) <= TOL
    assert to.state_dict()["LR_Scheduler"] == jo.state_dict()["LR_Scheduler"]
    to.set_lr(0.25)
    assert to.get_lr() == 0.25


def test_lbfgs_closure_matches_jax():
    """LBFGS.step(closure) on a least-squares problem: the closure
    re-evaluates the loss and its gradient each inner iteration."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal((6, 3)).astype(np.float32)
    y = rng.standard_normal(6).astype(np.float32)
    w0 = np.zeros(3, np.float32)
    jw = paddle.nn.Parameter(w0.copy())
    tw = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    ja, jy = paddle.to_tensor(a), paddle.to_tensor(y)
    ta, ty = torch.from_numpy(a), torch.from_numpy(y)
    jo = jopt.LBFGS(learning_rate=0.05, max_iter=8, history_size=4,
                    parameters=[jw])
    to = topt.LBFGS(learning_rate=0.05, max_iter=8, history_size=4,
                    parameters=[tw])

    def jclosure():
        loss = ((paddle.matmul(ja, jw) - jy) ** 2).sum()
        loss.backward()
        return loss

    def tclosure():
        loss = ((ta @ tw - ty) ** 2).sum()
        loss.backward()
        return loss

    jl = to_l = None
    for _ in range(3):
        jl, to_l = jo.step(jclosure), to.step(tclosure)
    assert _rel(_np(tw), jw.numpy()) <= TOL
    assert abs(float(to_l.detach()) - float(jl.numpy())) \
        <= TOL * abs(float(jl.numpy()))


def test_adam_lazy_mode_is_accepted_and_ignored():
    """JAX's Adam accepts lazy_mode and ignores it: the port's update with
    lazy_mode=True equals its own without it and JAX's with it."""
    p0, g = _params(12), _grads(1)
    jo = jopt.Adam(0.01, parameters=[], lazy_mode=True)
    lazy = topt.Adam(0.01, lazy_mode=True)
    dense = topt.Adam(0.01)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    jnew, _ = jo.apply(jp, jg, jo.init_state(jp), 0.01, 1)
    lnew, _ = lazy.apply(tp, tg, lazy.init_state(tp), 0.01, 1)
    dnew, _ = dense.apply(tp, tg, dense.init_state(tp), 0.01, 1)
    for k in p0:
        assert torch.equal(lnew[k], dnew[k])
        assert _rel(_np(lnew[k]), _np(jnew[k])) <= TOL


def test_minimize_runs_backward_step_and_clear():
    p0 = _params(13)
    tw = torch.nn.Parameter(torch.from_numpy(p0["w"].copy()))
    jw = paddle.nn.Parameter(p0["w"].copy())
    to = topt.SGD(0.1, parameters=[tw])
    jo = jopt.SGD(0.1, parameters=[jw])
    to.minimize((tw * tw).sum())
    jo.minimize((jw * jw).sum())
    assert tw.grad is None
    assert _rel(_np(tw), jw.numpy()) <= TOL


def test_optimizer_exports_match_jax():
    want = {"ASGD", "Adadelta", "Adagrad", "Adam", "Adamax", "AdamW",
            "ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
            "LBFGS", "Lamb", "LarsMomentum", "Momentum", "NAdam",
            "Optimizer", "RAdam", "RMSProp", "Rprop", "SGD", "lr"}
    assert want <= set(dir(jopt))
    assert want <= set(dir(topt))
