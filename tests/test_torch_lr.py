"""The port's learning-rate schedulers (optimizer/lr.py) against the JAX
package's: host-side Python over floats, so 50 steps of each must give
values equal to JAX's, not merely close, and a ``state_dict`` carried into
a fresh scheduler must continue the same sequence."""

import pytest

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 50

# (name, args, kwargs); a scheduler argument is built in its own package
CASES = [
    ("NoamDecay", (512, 10), dict(learning_rate=2.0)),
    ("PiecewiseDecay", ([5, 20, 30], [0.1, 0.05, 0.01, 0.001]), {}),
    ("NaturalExpDecay", (0.1, 0.05), {}),
    ("ExponentialDecay", (0.1, 0.9), {}),
    ("InverseTimeDecay", (0.1, 0.2), {}),
    ("PolynomialDecay", (0.1, 20), dict(end_lr=0.001, power=2.0)),
    ("PolynomialDecay", (0.1, 15), dict(end_lr=0.001, power=1.5,
                                         cycle=True)),
    ("LinearWarmup", (0.1, 10, 0.0, 0.1), {}),
    ("LinearWarmup", (("CosineAnnealingDecay", (0.1, 20), {}), 10, 0.01,
                      0.1), {}),
    ("CosineAnnealingDecay", (0.1, 15), dict(eta_min=0.001)),
    ("StepDecay", (0.1, 7), dict(gamma=0.5)),
    ("MultiStepDecay", (0.1, [10, 25, 40]), dict(gamma=0.3)),
    ("LambdaDecay", (0.1, lambda e: 0.95 ** e), {}),
    ("OneCycleLR", (0.1, 40), dict(phase_pct=0.25)),
    ("OneCycleLR", (0.1, 30), dict(divide_factor=10.0,
                                   end_learning_rate=1e-5)),
    ("CyclicLR", (0.01, 0.1, 6), dict(step_size_down=4)),
    ("CyclicLR", (0.01, 0.1, 5), dict(mode="triangular2")),
    ("CyclicLR", (0.01, 0.1, 5), dict(mode="exp_range", gamma=0.97)),
]
IDS = [f"{c[0]}-{i}" for i, c in enumerate(CASES)]


def _build(mod, name, args, kwargs):
    args = tuple(_build(mod, *a) if isinstance(a, tuple) and len(a) == 3
                 and isinstance(a[0], str) else a for a in args)
    return getattr(mod, name)(*args, **kwargs)


@pytest.mark.parametrize("name,args,kwargs", CASES, ids=IDS)
def test_scheduler_equals_jax(name, args, kwargs):
    j, t = _build(jlr, name, args, kwargs), _build(tlr, name, args, kwargs)
    for _ in range(STEPS):
        assert t() == j() and t.last_epoch == j.last_epoch
        j.step()
        t.step()
    assert t.state_dict() == j.state_dict()


@pytest.mark.parametrize("name,args,kwargs", CASES, ids=IDS)
def test_scheduler_state_dict_round_trip(name, args, kwargs):
    j, t = _build(jlr, name, args, kwargs), _build(tlr, name, args, kwargs)
    for _ in range(STEPS // 2):
        j.step()
        t.step()
    fresh = _build(tlr, name, args, kwargs)
    fresh.set_state_dict(t.state_dict())
    for _ in range(STEPS // 2):
        j.step()
        fresh.step()
        assert fresh() == j()


def test_step_with_epoch_equals_jax():
    j = jlr.CosineAnnealingDecay(0.1, 15)
    t = tlr.CosineAnnealingDecay(0.1, 15)
    for e in (3, 40, 7, 0):
        j.step(e)
        t.step(e)
        assert t() == j()


def test_reduce_on_plateau_equals_jax():
    """Metrics that fall, stall and rise: the same cuts at the same steps
    (patience, cooldown, threshold, min_lr); no metric, no step."""
    for mode in ("min", "max"):
        j = jlr.ReduceOnPlateau(0.1, mode=mode, factor=0.5, patience=2,
                                threshold=1e-3, cooldown=1, min_lr=0.01)
        t = tlr.ReduceOnPlateau(0.1, mode=mode, factor=0.5, patience=2,
                                threshold=1e-3, cooldown=1, min_lr=0.01)
        metrics = [1.0, 0.9, 0.9, 0.9, 0.9, 0.95, 0.8, 0.8, 0.8, 0.8, 0.8,
                   0.8, 0.8, 0.8, 0.8, 0.8, 0.7, 0.7, 0.7, 0.7]
        for i in range(STEPS):
            m = metrics[i % len(metrics)] * (1 + i // len(metrics))
            j.step(m)
            t.step(m)
            assert t() == j() and t.num_bad == j.num_bad
        t.step()
        assert t() == j()
        assert t.state_dict() == j.state_dict()


def test_scheduler_classes_match_jax():
    names = {n for n in dir(jlr) if isinstance(getattr(jlr, n), type)
             and issubclass(getattr(jlr, n), jlr.LRScheduler)}
    assert len(names) == 15
    for n in names:
        assert issubclass(getattr(tlr, n), tlr.LRScheduler), n
