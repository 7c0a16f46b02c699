"""The hybrid-parallel Llama train step of the port (paddle_tpu_torch/
models/llama_hybrid.py: pp x dp x sharding x sep x mp, the gpipe and the
schedule-explicit bodies, the stacked state and its converters) against
the JAX package's ``build_hybrid_train_step`` on the CPU.

Gangs as tests/test_torch_mesh_train.py's: one ``torch.multiprocessing``
spawn of 8 gloo ranks per gang and test run, a ``FileStore`` rendezvous,
ranks that import torch and paddle_tpu_torch only, npz results; the
pytest process draws the weights (the JAX debug model, seeded) and the
batch of tests/test_llama_hybrid.py:34-95 (vocab 128, hidden 32, 2
layers, 4 heads over 2 kv heads, batch 4 x 16).  ``hyb8`` runs the two
bodies tier 1 keeps, gpipe and 1F1B on (pp 2, sep 2, mp 2) with Ulysses;
``hyb8_slow`` the breadth of JAX's slow legs (ring, remat, VPP, ZBV,
ZBH1, pp x dp x sharding on both bodies, sep 4).

Each case takes one fp32 AdamW step (lr 1e-3), as the JAX tests do: the
loss within 1e-5 relative of JAX's, the updated params within JAX's own
gate (atol 5e-4, rtol 2e-3: where Adam's second moment is ~0 the update is
the gradient's sign, so a 1e-6 wobble moves a weight by ~lr/2), and the
completed gradients within 1e-5 of the largest magnitude of the port's
meshless step's (``build_train_step(mesh=None).accumulate``), which AdamW's
scale invariance would not show.  The JAX init_hybrid_state tree crosses
to each rank's blocks by ``params_from_jax(..., mesh=)``, equal to the
shards JAX places at the rank's coordinate, and back by ``gather_params``.
"""

from __future__ import annotations

import ast
import json
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_gang import file_store, run_gang

LR = 1e-3
TOL = 1e-5
CFG2 = dict(vocab=128, hidden=32, layers=2, heads=4, kv_heads=2, inter=64,
            max_pos=64)
CFG4 = dict(CFG2, layers=4)
CFG_SEP4 = dict(CFG2, heads=8, kv_heads=8)
PSM = dict(pp=2, sep=2, mp=2)

# case -> (config, mesh degrees, build_hybrid_train_step kwargs)
CASES = {
    "gpipe": (CFG2, PSM, {}),
    "1F1B": (CFG2, PSM, {"schedule": "1F1B"}),
}
SLOW_CASES = {
    "ring": (CFG2, PSM, {"sep_attn": "ring"}),
    "remat": (CFG2, PSM, {"remat": True}),
    "ZBH1": (CFG2, PSM, {"schedule": "ZBH1"}),
    "VPP": (CFG4, PSM, {"schedule": "VPP", "virtual_chunks": 2}),
    "ZBV": (CFG4, PSM, {"schedule": "ZBV"}),
    "dp_sharding": (CFG2, dict(pp=2, dp=2, sharding=2), {}),
    "dp_sharding_1F1B": (CFG2, dict(pp=2, dp=2, sharding=2),
                         {"schedule": "1F1B"}),
    "sep4": (CFG_SEP4, dict(pp=2, sep=4), {}),
}


def _cfg_name(cfg_kw):
    return "c" + "_".join(f"{v}" for v in cfg_kw.values())


def _batch(vocab):
    rng = np.random.RandomState(0)
    ids = rng.randint(0, vocab, (4, 16)).astype(np.int32)
    labels = rng.randint(0, vocab, (4, 16)).astype(np.int32)
    return ids, labels


def _jax_model(cfg_kw):
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM

    state = paddle.get_rng_state()
    paddle.seed(20261018)
    jm = LlamaForCausalLM(LlamaConfig.debug(**cfg_kw))
    paddle.set_rng_state(state)
    return jm


def _prepare(root, cases):
    from paddle_tpu.models.llama_hybrid import stack_llama_state

    for cfg_kw in {json.dumps(c[0]) for c in cases.values()}:
        cfg_kw = json.loads(cfg_kw)
        jm = _jax_model(cfg_kw)
        state = {k: np.asarray(v) for k, v in jm.functional_state().items()}
        stacked = {k: np.asarray(v) for k, v in stack_llama_state(
            state, cfg_kw["layers"]).items()}
        np.savez(root / f"{_cfg_name(cfg_kw)}.init.npz", **state)
        np.savez(root / f"{_cfg_name(cfg_kw)}.stacked.npz", **stacked)


# --------------------------------------------------------------- the gang

def _hybrid_rank(rank, world, root, cases):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from paddle_tpu_torch.models import (LlamaConfig,
                                         build_hybrid_train_step,
                                         gather_params, hybrid_mesh,
                                         params_from_jax)
    from paddle_tpu_torch.optimizer import AdamW

    store = file_store(root, world)
    meshes = {}
    ids, labels = _batch(CFG2["vocab"])
    for name, (cfg_kw, degrees, kw) in cases.items():
        key = tuple(sorted(degrees.items()))
        if key not in meshes:
            meshes[key] = hybrid_mesh("cpu", **degrees, store=store,
                                      rank=rank, world_size=world)
        mesh = meshes[key]
        cfg = LlamaConfig.debug(**cfg_kw)
        stacked = dict(np.load(os.path.join(
            root, f"{_cfg_name(cfg_kw)}.stacked.npz")))
        params = params_from_jax(stacked, "cpu", mesh=mesh)
        out = {f"rest/{k}": v.local.numpy() for k, v in params.items()}
        back = gather_params(params)
        out["round_trip"] = np.array(all(
            np.array_equal(back[k].numpy(), v) for k, v in stacked.items()))
        opt = AdamW(learning_rate=LR)
        step = build_hybrid_train_step(cfg, opt, mesh, num_microbatches=2,
                                       compute_dtype=torch.float32, **kw)
        loss, grads = step.gradients(params, ids, labels)
        full = gather_params({k: params[k].with_local(g)
                              for k, g in grads.items()})
        out.update({f"grad/{k}": v.numpy() for k, v in full.items()})
        loss2, new, _ = step(params, opt.init_state(params), 0, LR, ids,
                             labels)
        out["loss"] = loss.numpy()
        out["loss_step"] = loss2.numpy()
        out.update({f"new/{k}": v.numpy()
                    for k, v in gather_params(new).items()})
        np.savez(os.path.join(root, f"{name}.{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def hyb8(tmp_path_factory):
    return run_gang("hybrid_gang8", _hybrid_rank, 8, tmp_path_factory,
                    args=(CASES,), prepare=lambda r: _prepare(r, CASES))


@pytest.fixture(scope="module")
def hyb8_slow(tmp_path_factory):
    return run_gang("hybrid_gang8_slow", _hybrid_rank, 8, tmp_path_factory,
                    args=(SLOW_CASES,),
                    prepare=lambda r: _prepare(r, SLOW_CASES))


# --------------------------------------------------------------- JAX side

def _jax_step(cfg_kw, degrees, kw):
    """JAX's one hybrid step on the same weights and batch: (loss, the
    updated stacked params, the JAX mesh, the placed initial state)."""
    import jax
    import jax.numpy as jnp
    import paddle_tpu as paddle
    from paddle_tpu.models.llama_hybrid import (build_hybrid_train_step,
                                                hybrid_mesh,
                                                shard_hybrid_state,
                                                stack_llama_state)

    jm = _jax_model(cfg_kw)
    cfg = jm.cfg
    mesh = hybrid_mesh(jax.devices("cpu"), **degrees)
    state0 = {k: np.asarray(v) for k, v in jm.functional_state().items()}
    hstate = shard_hybrid_state(stack_llama_state(
        {k: v.copy() for k, v in state0.items()}, cfg.num_hidden_layers),
        mesh)
    placed = {k: v for k, v in shard_hybrid_state(stack_llama_state(
        state0, cfg.num_hidden_layers), mesh).items()}
    opt = paddle.optimizer.AdamW(learning_rate=LR,
                                 parameters=jm.parameters())
    opt_state = opt.init_state(hstate)
    step = build_hybrid_train_step(cfg, opt, mesh, num_microbatches=2,
                                   compute_dtype=jnp.float32, **kw)
    ids, labels = _batch(cfg.vocab_size)
    loss, new, _ = step(hstate, opt_state, 0, LR, ids, labels)
    return (float(loss), {k: np.asarray(v) for k, v in new.items()}, mesh,
            placed, state0)


def _meshless_grads(cfg_kw, state0):
    """The port's meshless step's gradients, stacked."""
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         build_train_step, params_from_jax,
                                         stack_llama_state)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = LlamaConfig.debug(**cfg_kw)
    model = LlamaForCausalLM(cfg, device="cpu")
    params = params_from_jax(state0, "cpu")
    step = build_train_step(model, AdamW(LR), compute_dtype=torch.float32)
    ids, labels = _batch(cfg.vocab_size)
    loss, grads = step.accumulate(params, torch.from_numpy(ids),
                                  torch.from_numpy(labels))
    return float(loss), stack_llama_state(grads, cfg.num_hidden_layers)


def _check(root, name, cases):
    cfg_kw, degrees, kw = cases[name]
    jloss, jnew, mesh, placed, state0 = _jax_step(cfg_kw, degrees, kw)
    mloss, mgrads = _meshless_grads(cfg_kw, state0)
    dev_of = {d.id: i for i, d in enumerate(mesh.devices.flat)}
    for r in range(8):
        got = dict(np.load(root / f"{name}.{r}.npz"))
        assert bool(got["round_trip"]), r
        for k, v in placed.items():
            shard = next(s for s in v.addressable_shards
                         if dev_of[s.device.id] == r)
            np.testing.assert_array_equal(got[f"rest/{k}"],
                                          np.asarray(shard.data), err_msg=k)
        for key in ("loss", "loss_step"):
            assert abs(float(got[key]) - jloss) <= TOL * abs(jloss), \
                (name, r, key, float(got[key]), jloss)
        assert abs(float(got["loss"]) - mloss) <= TOL * abs(mloss)
        for k, g in mgrads.items():
            err = np.abs(got[f"grad/{k}"] - g.numpy()).max()
            assert err <= TOL * np.abs(g.numpy()).max(), (name, r, k, err)
        for k, w in jnew.items():
            np.testing.assert_allclose(got[f"new/{k}"], w, atol=5e-4,
                                       rtol=2e-3, err_msg=f"{name} {r} {k}")


@pytest.mark.parametrize("name", list(CASES))
def test_hybrid_step_matches_jax(hyb8, name):
    """gpipe and 1F1B on (pp 2, sep 2, mp 2) with Ulysses: loss, updated
    params and the completed gradients (see the module docstring), on
    every rank; the stacked state's blocks and round trip."""
    _check(hyb8, name, CASES)


@pytest.mark.slow
@pytest.mark.parametrize("name", list(SLOW_CASES))
def test_hybrid_breadth_matches_jax(hyb8_slow, name):
    """JAX's slow hybrid legs on the port: ring, remat, ZBH1, VPP (4
    layers, 2 chunks a rank), ZBV, pp x dp x sharding (gpipe and 1F1B) and
    sep 4 (8 q and kv heads).  Tier-1 home: test_hybrid_step_matches_jax
    (the gpipe and 1F1B bodies) and tests/test_torch_sequence_parallel.py
    (the ring)."""
    _check(hyb8_slow, name, SLOW_CASES)


# --------------------------------------------------------------- in-process

def test_stack_unstack_round_trip():
    """``stack_llama_state`` / ``unstack_llama_state`` equal JAX's names and
    values, and invert each other."""
    from paddle_tpu.models.llama_hybrid import stack_llama_state as jstack

    from paddle_tpu_torch.models import stack_llama_state, \
        unstack_llama_state

    state = {k: np.asarray(v) for k, v in
             _jax_model(CFG2).functional_state().items()}
    got = stack_llama_state({k: torch.from_numpy(v.copy()) for k, v in
                             state.items()}, CFG2["layers"])
    want = jstack(state, CFG2["layers"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    back = unstack_llama_state(got, CFG2["layers"])
    assert set(back) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k].numpy(), v)


def test_hybrid_param_spec_equals_jax():
    """The at-rest spec of every stacked leaf on every mesh the gangs use
    equals JAX's ``hybrid_param_spec`` (abstract meshes)."""
    import jax
    from jax.sharding import Mesh as JMesh

    from paddle_tpu.models.llama_hybrid import hybrid_param_spec as jspec
    from paddle_tpu.models.llama_hybrid import stack_llama_state as jstack

    from paddle_tpu_torch.models import HYBRID_AXES, hybrid_param_spec
    from paddle_tpu_torch.parallel import Mesh

    state = jstack({k: np.asarray(v) for k, v in
                    _jax_model(CFG2).functional_state().items()}, 2)
    for degrees in ({**{a: 1 for a in HYBRID_AXES}, **PSM},
                    {**{a: 1 for a in HYBRID_AXES}, "pp": 2, "dp": 2,
                     "sharding": 2}):
        shape = tuple(degrees[a] for a in HYBRID_AXES)
        jm = JMesh(np.asarray(jax.devices()[:8], dtype=object).reshape(
            shape), HYBRID_AXES)
        for k, v in state.items():
            want = tuple(jspec(k, tuple(v.shape), jm))
            got = tuple(hybrid_param_spec(k, tuple(v.shape),
                                          Mesh(shape, HYBRID_AXES)))
            want += (None,) * (len(got) - len(want))
            got += (None,) * (len(want) - len(got))
            assert got == want, (k, degrees, got, want)


def test_one_rank_hybrid_step_is_the_meshless_step():
    """On the mesh of one rank (no process group), every schedule's
    gradients equal the meshless step's within fp32 1e-5 and its loss is
    the same."""
    from paddle_tpu_torch.models import (build_hybrid_train_step,
                                         hybrid_mesh, init_hybrid_state,
                                         params_from_jax,
                                         unstack_llama_state)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    state0 = {k: np.asarray(v) for k, v in
              _jax_model(CFG2).functional_state().items()}
    mloss, mgrads = _meshless_grads(CFG2, state0)
    cfg = LlamaConfig.debug(**CFG2)
    model = LlamaForCausalLM(cfg, device="cpu")
    model.load_functional_state(params_from_jax(state0, "cpu"))
    mesh = hybrid_mesh("cpu")
    ids, labels = _batch(cfg.vocab_size)
    for sched in ("gpipe", "1F1B", "FThenB", "ZBH1"):
        step = build_hybrid_train_step(cfg, AdamW(LR), mesh,
                                       num_microbatches=2,
                                       compute_dtype=torch.float32,
                                       schedule=sched)
        loss, grads = step.gradients(init_hybrid_state(model, mesh), ids,
                                     labels)
        assert abs(float(loss) - mloss) <= TOL * abs(mloss), sched
        for k, g in mgrads.items():
            err = (grads[k] - g).abs().max().item()
            assert err <= TOL * g.abs().max().item(), (sched, k, err)
        assert set(unstack_llama_state(grads, 2)) == set(state0)


def test_hybrid_options_raise():
    """``health=`` takes a HealthConfig (tests/test_torch_health.py holds
    the probed step); a mesh without the five axes, a tied
    head on the schedule executor, an unknown ``cpu_bf16`` mode and
    virtual chunks on gpipe raise as JAX's do."""
    from paddle_tpu_torch.models import (LlamaConfig,
                                         build_hybrid_train_step,
                                         hybrid_mesh)
    from paddle_tpu_torch.parallel import Mesh

    cfg = LlamaConfig.debug(**CFG2)
    mesh = hybrid_mesh("cpu")
    with pytest.raises(TypeError, match="health"):
        build_hybrid_train_step(cfg, None, mesh, health=object())
    with pytest.raises(ValueError, match="must carry axis"):
        build_hybrid_train_step(cfg, None, Mesh((1, 1, 1),
                                                ("dp", "sharding", "mp")))
    tied = LlamaConfig.debug(**CFG2)
    tied.tie_word_embeddings = True
    with pytest.raises(NotImplementedError, match="untied lm_head"):
        build_hybrid_train_step(tied, None, mesh, schedule="1F1B")
    with pytest.raises(ValueError, match="cpu_bf16"):
        build_hybrid_train_step(cfg, None, mesh, cpu_bf16="nope")
    with pytest.raises(ValueError, match="virtual_chunks"):
        build_hybrid_train_step(cfg, None, mesh, virtual_chunks=2)


def test_no_stale_a5_pointers():
    """The port cites neither A5.4 nor A5.5 in a NotImplementedError or a
    docstring, and ``_needs_a5`` is gone (an AST scan of every module of
    the package)."""
    root = Path(__file__).resolve().parent.parent / "paddle_tpu_torch"
    pat = re.compile(r"A5\.[45]\b")
    hits = []
    # _build/ holds build outputs (and unpacked checkouts), not the package
    for path in sorted(p for p in root.rglob("*.py")
                       if "_build" not in p.relative_to(root).parts):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef) and node.name == "_needs_a5":
                hits.append(f"{path}: def _needs_a5")
            if isinstance(node, (ast.Module, ast.FunctionDef,
                                 ast.AsyncFunctionDef, ast.ClassDef)):
                doc = ast.get_docstring(node)
                if doc and pat.search(doc):
                    hits.append(f"{path}: docstring of "
                                f"{getattr(node, 'name', 'module')}")
            if isinstance(node, ast.Raise) and node.exc is not None:
                text = ast.get_source_segment(path.read_text(), node.exc) \
                    or ""
                if "NotImplementedError" in text and pat.search(text):
                    hits.append(f"{path}:{node.lineno}")
            if isinstance(node, ast.Name) and node.id == "_needs_a5":
                hits.append(f"{path}:{node.lineno} uses _needs_a5")
    assert not hits, hits


def test_no_stale_a6_pointers():
    """Since both halves of ROADMAP A6 are in (A6.1 training resilience,
    A6.2 the serving fleet), no port line (a raise, a docstring, a comment)
    names A6 as work to come: none names A6 bare, and no
    NotImplementedError names A6 at all."""
    root = Path(__file__).resolve().parent.parent / "paddle_tpu_torch"
    hits = []
    for path in sorted(p for p in root.rglob("*.py")
                       if "_build" not in p.relative_to(root).parts):
        text = path.read_text()
        for i, line in enumerate(text.splitlines()):
            if re.search(r"\bA6\b(?!\.[12]\b)", line):
                hits.append(f"{path.name}:{i + 1}: {line.strip()}")
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.Raise) and node.exc is not None:
                src = ast.get_source_segment(text, node.exc) or ""
                if "NotImplementedError" in src and "A6" in src:
                    hits.append(f"{path.name}:{node.lineno}: {src}")
    assert not hits, hits
