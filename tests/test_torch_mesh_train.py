"""The mesh train step of the port (models/llama.py ``build_train_step(mesh=
...)``, parallel/specs.py, parallel/schedule.py, parallel/compat.py, the
optimizer's shard-major flat state and the offloaded state) against the
JAX package's GSPMD step on the CPU.

Each gang is one ``torch.multiprocessing`` spawn of gloo ranks per module
run (``_gang``), rendezvousing through a ``FileStore``; its ranks import
torch and paddle_tpu_torch only (this module imports JAX inside the tests,
never at the top).  The pytest process draws the weights and the batches
from seeds, the ranks run every configuration and write numpy results, and
each test holds one configuration against ``paddle_tpu``'s
``build_train_step(model, opt, mesh)`` on the conftest's 8 virtual CPU
devices, with the at-rest blocks against the shards JAX places on the
device at the same mesh coordinate.  Under xdist the first worker that
needs a gang runs it; the others wait on its lock file and read its
results.  Tolerances are stated where they are used.
"""

from __future__ import annotations

import fcntl
import json
import math
import os
import time
import traceback

import numpy as np
import pytest
import torch

LR = 1e-3
STEPS = 3
SEQ = 16

# mesh (dp, sharding, mp) -> the configurations run on it.  Modes:
# adamw: per-tensor AdamW; flat: the shard-major flat state; accum4: flat
# state, accum_steps 4 (fp32 carry); masked1 / masked3: flat state,
# segment ids, accum 1 / accum 3 whose middle micro-batch is all padding;
# host: the offloaded flat state (held to the flat run bit for bit); b2:
# flat state with a global batch of 2, which sharding does not split;
# remat: flat state under MemoryConfig(remat="full") (each layer's
# recompute gathers its weights again).  "tie" ties the LM head to the
# embedding (vocab-parallel lookup and head on one block).
MESHES4 = {
    "dp2_sh2": ((2, 2, 1), {}, ("adamw", "flat", "accum4", "masked1",
                                "host", "b2")),
    "sh2_mp2": ((1, 2, 2), {}, ("adamw", "flat", "masked3", "host",
                                "remat")),
    "sh2_mp2_tie": ((1, 2, 2), {"tie": True}, ("flat",)),
    "sh4": ((1, 4, 1), {}, ("adamw", "flat", "accum4", "host")),
    # kv width 2 heads x 16 on mp 4: half a head per rank, the gather route
    "mp4_kv2": ((1, 1, 4), {"kv_heads": 2}, ("adamw", "flat", "masked3",
                                             "accum4")),
}
MESHES8 = {
    "dp2_sh2_mp2": ((2, 2, 2), {}, ("flat", "masked3")),
}
CASES4 = [(m, mode) for m, (_, _, modes) in MESHES4.items() for mode in modes
          if mode != "host"]
CASES8 = [(m, mode) for m, (_, _, modes) in MESHES8.items() for mode in modes]


def _config(cls, cfg_kw):
    kw = dict(cfg_kw)
    tie = kw.pop("tie", False)
    cfg = cls.debug(**kw)
    cfg.tie_word_embeddings = tie
    return cfg


def _accum(mode):
    return {"accum4": 4, "masked3": 3}.get(mode, 1)


def _documents(rng, rows, seq, pad):
    seg = np.zeros((rows, seq), np.int32)
    for r in range(rows):
        pos, n_doc = 0, 0
        while pos < seq - pad:
            n = min(int(rng.integers(3, 9)), seq - pad - pos)
            n_doc += 1
            seg[r, pos:pos + n] = n_doc
            pos += n
    return seg


def _batch(mode, vocab, seed):
    """(ids, labels, segment ids or None) of one configuration."""
    rng = np.random.default_rng(seed)
    acc, b = _accum(mode), (2 if mode == "b2" else 4)
    shape = (acc, b, SEQ) if acc > 1 else (b, SEQ)
    ids = rng.integers(0, vocab, shape).astype(np.int32)
    lab = rng.integers(0, vocab, shape).astype(np.int32)
    seg = None
    if mode.startswith("masked"):
        seg = _documents(rng, acc * b, SEQ, 3).reshape(shape)
        if acc > 1:
            seg[1] = 0                       # an all-padding micro-batch
    return ids, lab, seg


# ------------------------------------------------------------ the gang ranks

COMPAT_OPS = ("all_gather", "psum_scatter", "psum", "pbroadcast",
              "ppermute", "all_to_all", "all_to_all_untiled", "dp_gather")


def _compat_x(rank):
    return np.arange(24, dtype=np.float32).reshape(4, 6) + 100 * rank


def _compat_w(shape, rank):
    return (np.arange(np.prod(shape), dtype=np.float32).reshape(shape) * 0.5
            + 10 * rank)


def _compat_checks(rank, mesh, root):
    """Each collective of parallel/compat.py over ``mp`` (and the size-1
    ``dp``) on this rank's input, with its gradient under a rank-dependent
    cotangent."""
    from paddle_tpu_torch.parallel import compat

    ops = {
        "all_gather": lambda x: compat.all_gather(x, "mp", axis=1,
                                                  mesh=mesh),
        "psum_scatter": lambda x: compat.psum_scatter(x, "mp", mesh=mesh),
        "psum": lambda x: compat.psum(x, "mp", mesh=mesh),
        "pbroadcast": lambda x: compat.pbroadcast(x, "mp", mesh=mesh),
        "ppermute": lambda x: compat.ppermute(x, "mp", [(0, 1), (1, 0)],
                                              mesh=mesh),
        "all_to_all": lambda x: compat.all_to_all(x, "mp", 0, 1, tiled=True,
                                                  mesh=mesh),
        "all_to_all_untiled": lambda x: compat.all_to_all(x[:2], "mp", 0, 1,
                                                          mesh=mesh),
        "dp_gather": lambda x: compat.all_gather(x, "dp", mesh=mesh),
    }
    out = {}
    for name in COMPAT_OPS:
        x = torch.from_numpy(_compat_x(rank)).requires_grad_()
        y = ops[name](x)
        (gx,) = torch.autograd.grad(
            y, x, torch.from_numpy(_compat_w(tuple(y.shape), rank)))
        out[name + ".y"], out[name + ".g"] = y.detach().numpy(), gx.numpy()
    np.savez(os.path.join(root, f"compat.{rank}.npz"), **out)


def _converter_round_trip(glob, state, mode, layout):
    """opt_state_from_jax on the global buffers (in the JAX package's flat
    or bucketed form) gives this rank's blocks back exactly."""
    from paddle_tpu_torch.models import opt_state_from_jax
    from paddle_tpu_torch.parallel.memory import gather_offloaded_state

    src = {"__flat__": {g: {k: v.numpy() for k, v in gs.items()}
                        for g, gs in glob["__flat__"].items()}}
    if mode == "host":
        src = {"__offload__": {g: {k: tuple(np.array_split(v, 3))
                                   for k, v in gs.items()}
                               for g, gs in src["__flat__"].items()}}
    back = opt_state_from_jax(src, "cpu", flat_layout=layout,
                              bucket_bytes=2 << 10)
    if mode == "host":
        back, state = (gather_offloaded_state(back),
                       gather_offloaded_state(state))
    return all(torch.equal(back["__flat__"][g][k], v)
               for g, gs in state["__flat__"].items() for k, v in gs.items())


def _rank_main(rank, world, root, meshes):
    """One gloo rank: every configuration of ``meshes``, results as npz."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         apply_llama_sharding,
                                         build_train_step, gather_opt_state,
                                         gather_params, llama_decay_mask,
                                         params_from_jax)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import PartitionSchedule, init_mesh
    from paddle_tpu_torch.parallel.memory import (MemoryConfig,
                                                  init_offloaded_state)

    store = dist.FileStore(os.path.join(root, "store"), world)
    for mname, (shape, cfg_kw, modes) in meshes.items():
        mesh = init_mesh("cpu", shape, ("dp", "sharding", "mp"), store=store,
                         rank=rank, world_size=world)
        if mname == "sh2_mp2":
            _compat_checks(rank, mesh, root)
        init = dict(np.load(os.path.join(root, f"{mname}.init.npz")))
        cfg = _config(LlamaConfig, cfg_kw)
        for mode in modes:
            model = LlamaForCausalLM(cfg, device="cpu")
            model.load_functional_state(params_from_jax(init, "cpu"))
            sched = PartitionSchedule.from_model(model, mesh)
            apply_llama_sharding(model, mesh, schedule=sched)
            params = model.functional_state()
            if mode == "adamw":
                np.savez(os.path.join(root, f"{mname}.rest.{rank}.npz"),
                         **{k: v.local.numpy() for k, v in params.items()})
                # the global JAX arrays cut into this rank's blocks
                cut = params_from_jax(init, "cpu", mesh=mesh, schedule=sched)
                converted = all(torch.equal(cut[k].local, v.local)
                                for k, v in params.items())
            opt = AdamW(learning_rate=LR, multi_precision=True)
            memory = MemoryConfig(remat="full") if mode == "remat" else None
            step = build_train_step(model, opt, mesh=mesh,
                                    compute_dtype=torch.float32,
                                    accum_steps=_accum(mode), memory=memory)
            mask = llama_decay_mask(model)
            if mode == "adamw":
                state = opt.init_state(params)
            elif mode == "host":
                state = init_offloaded_state(opt, params, decay_mask=mask,
                                             bucket_bytes=2 << 10,
                                             flat_layout=step.flat_layout)
            else:
                state = opt.init_flat_state(params, decay_mask=mask,
                                            flat_layout=step.flat_layout)
            data = np.load(os.path.join(root, f"{mname}.{mode}.data.npz"))
            seg = data["seg"] if "seg" in data.files else None
            out = {}
            for i in range(STEPS):
                loss, params, state = step(params, state, i, LR,
                                           data["ids"], data["labels"],
                                           attention_mask=seg)
                out[f"loss{i}"] = loss.numpy()
                # copies: the host state's step updates params in place
                for k, v in gather_params(params).items():
                    out[f"p{i}/{k}"] = v.numpy().copy()
            st = gather_opt_state(state, step.flat_layout)
            if mode == "adamw":
                out["converter_ok"] = np.array(converted)
            if mode in ("flat", "host"):
                out["converter_ok"] = np.array(_converter_round_trip(
                    st, state, mode, step.flat_layout))
            if "__flat__" in st:
                for g, gs in st["__flat__"].items():
                    for key, v in gs.items():
                        out[f"st/{g}/{key}"] = v.numpy()
            else:
                for k, s in st.items():
                    for key, v in s.items():
                        out[f"st/{k}/{key}"] = v.numpy()
            if rank == 0:
                np.savez(os.path.join(root, f"{mname}.{mode}.npz"), **out)
        if rank == 0 and "flat" in modes:
            # a state of another wire format fails on its group names
            bad = {"__flat__": {k.replace("sm[", "sm[pp4."): v for k, v in
                                opt.init_flat_state(
                                    params, decay_mask=mask,
                                    flat_layout=step.flat_layout)
                                ["__flat__"].items()}}
            try:
                opt.apply_flat(params, params, bad, LR, 1, decay_mask=mask,
                               flat_layout=step.flat_layout)
                msg = "accepted"
            except ValueError as e:
                msg = str(e)
            with open(os.path.join(root, f"{mname}.mismatch.txt"), "w") as f:
                f.write(msg)
        dist.barrier()


def _gang(name, meshes, world, tmp_path_factory):
    """Run (once per test run, whatever the xdist worker) the gang over
    ``meshes``; return its results directory."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    base = tmp_path_factory.getbasetemp()
    root = (base.parent / f"{name}-{uid}") if uid else (base / name)
    root.mkdir(parents=True, exist_ok=True)
    with open(root / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (root / "failed").exists():
            raise RuntimeError("the gang failed in another worker:\n"
                               + (root / "failed").read_text())
        if not (root / "done").exists():
            try:
                _prepare(root, meshes)
                t0 = time.time()
                torch.multiprocessing.spawn(
                    _rank_main, args=(world, str(root), meshes),
                    nprocs=world, join=True)
                (root / "done").write_text(json.dumps(
                    {"seconds": time.time() - t0}))
            except BaseException:
                (root / "failed").write_text(traceback.format_exc())
                raise
    return root


def _jax_model(cfg_kw):
    """The JAX debug Llama of a mesh's configurations (seeded)."""
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig as JaxConfig
    from paddle_tpu.models import LlamaForCausalLM as JaxModel

    state = paddle.get_rng_state()
    paddle.seed(20261017)
    jm = JaxModel(_config(JaxConfig, cfg_kw))
    paddle.set_rng_state(state)
    return jm


def _prepare(root, meshes):
    for mname, (_, cfg_kw, modes) in meshes.items():
        jm = _jax_model(cfg_kw)
        np.savez(root / f"{mname}.init.npz",
                 **{k: np.asarray(v) for k, v in jm.functional_state().items()})
        for mode in modes:
            # the host state runs the flat state's batches
            seed = 100 + modes.index("flat" if mode == "host" else mode)
            ids, lab, seg = _batch(mode, jm.cfg.vocab_size, seed)
            kw = {"ids": ids, "labels": lab}
            if seg is not None:
                kw["seg"] = seg
            np.savez(root / f"{mname}.{mode}.data.npz", **kw)


@pytest.fixture(scope="module")
def gang4(tmp_path_factory):
    return _gang("mesh_gang4", MESHES4, 4, tmp_path_factory)


@pytest.fixture(scope="module")
def gang8(tmp_path_factory):
    return _gang("mesh_gang8", MESHES8, 8, tmp_path_factory)


# ---------------------------------------------------------------- JAX side

def _jax_mesh(shape):
    import jax
    from jax.sharding import Mesh

    devs = np.asarray(jax.devices()[:math.prod(shape)], dtype=object)
    return Mesh(devs.reshape(shape), ("dp", "sharding", "mp"))


def _jax_run(meshes, mname, mode, root):
    """JAX's build_train_step on the same weights and batches: per step the
    loss and the params, and the final optimizer state."""
    import jax
    import jax.numpy as jnp
    import paddle_tpu as paddle
    from paddle_tpu.models import apply_llama_sharding, build_train_step
    from paddle_tpu.models.llama import llama_decay_mask
    from paddle_tpu.parallel.schedule import PartitionSchedule

    shape, cfg_kw, modes = meshes[mname]
    jm = _jax_model(cfg_kw)
    mesh = _jax_mesh(shape)
    sched = PartitionSchedule.from_model(jm, mesh)
    apply_llama_sharding(jm, mesh, schedule=sched)
    params = {k: jnp.array(v, copy=True)
              for k, v in jm.functional_state().items()}
    opt = paddle.optimizer.AdamW(learning_rate=LR,
                                 parameters=jm.parameters())
    from paddle_tpu.parallel.memory import MemoryConfig

    memory = MemoryConfig(remat="full") if mode == "remat" else None
    step = build_train_step(jm, opt, mesh=mesh, compute_dtype=jnp.float32,
                            accum_steps=_accum(mode), schedule=sched,
                            memory=memory)
    if mode == "adamw":
        state = opt.init_state(params)
    else:
        state = opt.init_flat_state(
            params, decay_mask=llama_decay_mask(jm),
            flat_layout=sched.flat_update_layout())
    data = np.load(root / f"{mname}.{mode}.data.npz")
    kw = {}
    if "seg" in data.files:
        kw["attention_mask"] = data["seg"]
    out = {}
    for i in range(STEPS):
        loss, params, state = step(params, state, i, LR, data["ids"],
                                   data["labels"], **kw)
        out[f"loss{i}"] = np.asarray(loss)
        for k, v in params.items():
            out[f"p{i}/{k}"] = np.asarray(v)
    flat = state.get("__flat__", state)
    for g, gs in flat.items():
        for key, v in gs.items():
            out[f"st/{g}/{key}"] = np.asarray(v)
    return out, jm, mesh


def _close_params(got, want, steps):
    """Params after ``steps`` fp32 AdamW steps: Adam moves a weight by about
    lr whatever its gradient's size, so an element whose near-zero gradient
    the two summation orders give opposite signs may move up to 2 lr apart
    a step; all but 1e-3 of the elements agree to 1e-5 + 1e-5 relative."""
    diff = np.abs(got - want)
    assert diff.max() <= 2 * LR * steps + 1e-6
    assert np.mean(diff > 1e-5 + 1e-5 * np.abs(want)) < 1e-3


def _check(meshes, mname, mode, root):
    got = dict(np.load(root / f"{mname}.{mode}.npz"))
    # rank 0's converters: params_from_jax(mesh=) cut the JAX arrays into
    # its blocks; opt_state_from_jax(flat_layout=) the global flat state
    if "converter_ok" in got:
        assert bool(got.pop("converter_ok"))
    want, jm, mesh = _jax_run(meshes, mname, mode, root)
    # losses: the same fp32 sums in another order (1e-5 relative)
    for i in range(STEPS):
        np.testing.assert_allclose(got[f"loss{i}"], want[f"loss{i}"],
                                   rtol=1e-5, err_msg=f"loss step {i}")
    assert float(got[f"loss{STEPS - 1}"]) < float(got["loss0"])
    for i in range(STEPS):
        for k in [k for k in want if k.startswith(f"p{i}/")]:
            _close_params(got[k], want[k], i + 1)
    # the optimizer state: the same names (the flat groups carry the
    # layout's signature) and, for the shard-major groups, the JAX buffers
    # element for element: signed moments to 1e-5 relative of the largest
    # moment, but for the 1e-3 share of elements whose near-zero gradient
    # the two summation orders give opposite signs (as _close_params)
    st_got = {k for k in got if k.startswith("st/")}
    st_want = {k for k in want if k.startswith("st/")}
    assert st_got == st_want
    for k in st_want:
        g, w = got[k], want[k]
        assert g.shape == w.shape, k
        if k.endswith("/master"):
            _close_params(g, w, STEPS)
        else:
            scale = np.abs(w).max() or 1.0
            assert np.mean(np.abs(g - w) > 1e-5 * scale) < 1e-3, k
    return jm, mesh


@pytest.mark.parametrize("mname,mode", CASES4,
                         ids=[f"{m}-{mode}" for m, mode in CASES4])
def test_mesh_step_matches_jax(gang4, mname, mode):
    """3 fp32 steps of the port's mesh step on a 4-rank gloo gang vs JAX's
    GSPMD step on the same mesh: losses, gathered params after every step
    and the optimizer state (per tensor, or the shard-major flat buffers)."""
    _check(MESHES4, mname, mode, gang4)


@pytest.mark.parametrize("mname,mode", CASES8,
                         ids=[f"{m}-{mode}" for m, mode in CASES8])
def test_full_composition_matches_jax(gang8, mname, mode):
    """The dp 2 x sharding 2 x mp 2 composition on an 8-rank gang."""
    _check(MESHES8, mname, mode, gang8)


@pytest.mark.parametrize("mname", [m for m, (_, _, modes) in MESHES4.items()
                                   if "adamw" in modes])
def test_at_rest_blocks_are_jax_shards(gang4, mname):
    """After apply_llama_sharding each rank holds exactly the shard JAX
    places on the device at its mesh coordinate."""
    import jax.numpy as jnp
    from paddle_tpu.models import apply_llama_sharding

    shape, cfg_kw, _ = MESHES4[mname]
    jm = _jax_model(cfg_kw)
    mesh = _jax_mesh(shape)
    apply_llama_sharding(jm, mesh)
    ranks = [dict(np.load(gang4 / f"{mname}.rest.{r}.npz"))
             for r in range(math.prod(shape))]
    for k, v in jm.functional_state().items():
        arr = jnp.asarray(v)
        for sh in arr.addressable_shards:
            coord = tuple(int(c) for c in
                          np.argwhere(mesh.devices == sh.device)[0])
            rank = int(np.ravel_multi_index(coord, shape))
            np.testing.assert_array_equal(ranks[rank][k], np.asarray(sh.data),
                                          err_msg=f"{k} rank {rank}")


@pytest.mark.parametrize("mname", [m for m, (_, _, modes) in MESHES4.items()
                                   if "host" in modes])
def test_host_state_equals_device_state(gang4, mname):
    """The offloaded (host-resident, 2 KiB buckets) shard-major state gives
    the device flat state's losses, params and state bit for bit."""
    host = dict(np.load(gang4 / f"{mname}.host.npz"))
    dev = dict(np.load(gang4 / f"{mname}.flat.npz"))
    assert bool(host.pop("converter_ok")) and bool(dev.pop("converter_ok"))
    assert set(host) == set(dev)
    for k in dev:
        np.testing.assert_array_equal(host[k], dev[k], err_msg=k)


@pytest.mark.parametrize("mname", list(MESHES4))
def test_mismatched_layout_raises(gang4, mname):
    """A flat state whose group names name another layout is refused, as
    JAX refuses it (tests/test_schedule.py ::
    test_apply_flat_rejects_mismatched_wire_format)."""
    msg = (gang4 / f"{mname}.mismatch.txt").read_text()
    assert "different flat layout" in msg


def test_compat_collectives_and_transposes(gang4):
    """parallel/compat.py on the (1, 2, 2) mesh, over mp (ranks 2s and
    2s + 1 for sharding coordinate s): each collective's value and its
    gradient (the transposed collective) against numpy, exactly."""
    got = [dict(np.load(gang4 / f"compat.{r}.npz")) for r in range(4)]
    for r in range(4):
        pair = [2 * (r // 2), 2 * (r // 2) + 1]
        me = r % 2
        xs = [_compat_x(j) for j in pair]

        def w(name, j):
            return _compat_w(got[j][name + ".y"].shape, j)

        want = {
            "all_gather": (np.concatenate(xs, 1),
                           sum(w("all_gather", j)[:, 6 * me:6 * me + 6]
                               for j in pair)),
            "psum_scatter": (sum(x[2 * me:2 * me + 2] for x in xs),
                             np.concatenate([w("psum_scatter", j)
                                             for j in pair], 0)),
            "psum": (sum(xs), w("psum", r)),
            "pbroadcast": (xs[me], sum(w("pbroadcast", j) for j in pair)),
            "ppermute": (xs[1 - me], w("ppermute", pair[1 - me])),
            "all_to_all": (np.concatenate([x[2 * me:2 * me + 2] for x in xs],
                                          1),
                           np.concatenate([w("all_to_all", j)[:, 6 * me:
                                                              6 * me + 6]
                                           for j in pair], 0)),
            "all_to_all_untiled": (
                np.stack([x[me] for x in xs], 1),
                np.concatenate([np.stack([w("all_to_all_untiled", j)[:, me]
                                          for j in pair], 0),
                                np.zeros((2, 6), np.float32)], 0)),
            "dp_gather": (xs[me], w("dp_gather", r)),
        }
        for name in COMPAT_OPS:
            y, g = want[name]
            np.testing.assert_array_equal(got[r][name + ".y"], y,
                                          err_msg=f"{name} rank {r}")
            np.testing.assert_array_equal(got[r][name + ".g"], g,
                                          err_msg=f"{name} grad rank {r}")


def test_host_update_streams_leaf_by_leaf(monkeypatch):
    """A mesh rank's offloaded update (ShardedTensor params; here on the
    one-rank mesh) makes each leaf's rows as the bucket stream reaches it
    and drops them once the stream has passed it: with buckets smaller
    than every leaf, at most the two leaves around a bucket boundary are
    live at once.  Params and state equal the device-resident flat update
    bit for bit.  The shard-major host state of global (plain) params is
    refused: it is per rank."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import memory as M
    from paddle_tpu_torch.parallel.schedule import FlatUpdateLayout
    from paddle_tpu_torch.parallel.specs import Mesh, NamedSharding, P

    axes = ("dp", "sharding", "mp")
    mesh = Mesh((1, 1, 1), axes, device_type="cpu")
    rng = np.random.default_rng(0)
    shapes = {"a.w": (8, 16), "b.w": (32,), "c.w": (16, 8), "d.w": (64,)}

    def draw():
        return {k: torch.from_numpy(rng.standard_normal(sh).astype(
            np.float32)).to(torch.bfloat16) for k, sh in shapes.items()}

    params, grads = draw(), draw()

    def cut(tree):
        return {k: NamedSharding(mesh, P("sharding")).shard(v)
                for k, v in tree.items()}

    opt = AdamW(LR, multi_precision=True)
    want_p, want_st = opt.apply_flat(params, grads,
                                     opt.init_flat_state(params), LR, 1)
    live = []
    real = M._LeafRows.param

    def param(self, k):
        row = real(self, k)
        live.append(len(self.rows_p))
        return row

    monkeypatch.setattr(M._LeafRows, "param", param)
    sh_params = cut(params)
    state = M.init_offloaded_state(opt, sh_params, bucket_bytes=64)
    assert len(state["__offload__"]["decay|bfloat16"]["moment1"]) == 22
    M.apply_flat_offloaded(opt, sh_params, cut(grads), state, LR, 1)
    assert live and max(live) <= 2
    for k, want in want_p.items():
        assert torch.equal(sh_params[k].local, want), k
    got = M.gather_offloaded_state(state)["__flat__"]
    for g, gs in want_st["__flat__"].items():
        for key, v in gs.items():
            assert torch.equal(got[g][key], v), (g, key)
    layout = FlatUpdateLayout(Mesh((1, 2, 1), axes), lambda n, s: P())
    with pytest.raises(ValueError, match="ShardedTensor"):
        M.init_offloaded_state(opt, params, flat_layout=layout)
