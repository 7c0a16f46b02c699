"""Distributed checkpoints of the port (paddle_tpu_torch/distributed/
checkpoint: the manifest-committed saver, the verified loader with
reshard-on-load, the retention manager) on the CPU.

- The manifest, ``device_count`` aside, equal to JAX's ``build_manifest``
  for the same named state: paths, shapes, dtype names (bf16 included),
  crc32 and source specs, exactly; on one rank (host values, no ``src``)
  and in the ``reshard4`` gang of 4 gloo ranks (tests/torch_fault_injection
  .py ``reshard_gang_rank``: sharded leaves, the crc of the assembled leaf).
- Atomic commit (no temp directory left, a directory without a manifest is
  not complete) and decommit on overwrite (a crash mid-swap leaves no
  manifest).
- A corrupt leaf raises ``CheckpointCorruptError``; the manager degrades
  to the previous complete checkpoint, and to nothing when all are
  corrupt.
- An async save snapshots the state before it returns: the state updated
  in place right after still restores to the saved values (one rank, and
  across the gang's ranks on a store barrier); saves to one path
  serialise.
- Save on mesh A, load on mesh B equals the direct reshard, bit for bit
  (the gang's three pairs, the 4 -> 2 shrink among them).
- The crcs are of the values saved: a block that reaches the disk other
  than its writer saved it (rank 1's, in the gang) fails the save on
  every rank and leaves the checkpoint at the path as it was; an async
  save's failure is raised by ``wait_save``.
- A restore onto a mesh with no device type and no ``device=`` goes to
  the card (and raises where there is none).
"""

import json
import os
import shutil
import sys
import zlib

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from paddle_tpu_torch.distributed.checkpoint import (  # noqa: E402
    CheckpointCorruptError, CheckpointManager, load_state_dict,
    read_manifest, restore_arrays, save_state_dict, wait_save)
from paddle_tpu_torch.parallel.specs import Mesh, P, ShardedTensor  # noqa
from torch_gang import run_gang  # noqa: E402

FIELDS = ("path", "shape", "dtype", "crc32", "src")


def _state():
    rng = np.random.RandomState(3)
    return {
        "w": torch.from_numpy(rng.rand(32, 8).astype(np.float32)),
        "opt": {"m": torch.from_numpy(rng.rand(32, 8).astype(np.float32)),
                "master": torch.from_numpy(
                    rng.randn(16).astype(np.float32)).to(torch.bfloat16)},
        "ids": torch.arange(10, dtype=torch.int32),
        "step": 7, "lr": 0.05,
    }


def _jax_tree(state):
    import jax.numpy as jnp

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, torch.Tensor):
            if v.dtype == torch.bfloat16:
                return jnp.asarray(v.float().numpy(), jnp.bfloat16)
            return np.asarray(v.numpy())
        return v

    return conv(state)


def _fields(manifest):
    return {e["path"]: {k: e.get(k) for k in FIELDS}
            for e in manifest["leaves"]}


def test_manifest_matches_jax_on_one_rank(tmp_path):
    from paddle_tpu.distributed.checkpoint.save_state_dict import \
        build_manifest

    state = _state()
    save_state_dict(state, str(tmp_path / "c"))
    man = read_manifest(str(tmp_path / "c"))
    want = build_manifest(_jax_tree(state))
    assert man["format"] == want["format"] and man["device_count"] == 1
    assert _fields(man) == _fields(want)
    assert [e["path"] for e in man["leaves"]] == \
        [e["path"] for e in want["leaves"]]
    assert not [n for n in os.listdir(tmp_path / "c")
                if n.startswith(".state.tmp")]
    got = restore_arrays(str(tmp_path / "c"))
    assert torch.equal(got["opt"]["master"], state["opt"]["master"])
    assert torch.equal(got["w"], state["w"]) and got["step"] == 7
    assert got["lr"] == 0.05 and isinstance(got["step"], int)


def test_decommit_on_overwrite(tmp_path, monkeypatch):
    """An overwrite removes the manifest before it touches the old tree:
    a crash mid-swap leaves the directory without a manifest (not
    complete), never complete but torn."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(_state(), 4)
    mgr.save(_state(), 8)
    real = shutil.rmtree

    def boom(path, *a, **kw):
        if os.path.basename(str(path)) == "state":
            raise OSError("crash mid-swap")
        return real(path, *a, **kw)

    monkeypatch.setattr(shutil, "rmtree", boom)
    with pytest.raises(OSError, match="mid-swap"):
        save_state_dict(_state(), mgr.step_path(8))
    monkeypatch.setattr(shutil, "rmtree", real)
    assert read_manifest(mgr.step_path(8)) is None
    assert mgr.complete_steps() == [4]
    state, step, degraded = mgr.restore_latest()
    assert step == 4 and degraded == []


def _corrupt(path):
    files = sorted(os.listdir(os.path.join(path, "state")))
    with open(os.path.join(path, "state", files[0]), "r+b") as f:
        f.seek(8)
        f.write(b"\xff" * 16)


def test_corrupt_leaf_raises_and_the_manager_degrades(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    for s in (4, 8, 12):
        st = _state()
        st["step"] = s
        mgr.save(st, s)
    _corrupt(mgr.step_path(12))
    with pytest.raises(CheckpointCorruptError, match="crc32"):
        restore_arrays(mgr.step_path(12))
    state, step, degraded = mgr.restore_latest()
    assert (step, degraded, state["step"]) == (8, [12], 8)
    mesh = Mesh((1,), ("dp",), device_type="cpu")
    state, step, degraded = mgr.restore_latest(mesh, {"w": P("dp")})
    assert (step, degraded) == (8, [12])
    assert torch.equal(state["w"], _state()["w"])
    for s in (4, 8):
        _corrupt(mgr.step_path(s))
    assert mgr.restore_latest() == (None, 0, [12, 8, 4])
    # an unreadable manifest is an incomplete checkpoint
    with open(os.path.join(mgr.step_path(4), "manifest.json"), "w") as f:
        f.write("{not json")
    assert mgr.complete_steps() == [8, 12]
    with pytest.raises(CheckpointCorruptError, match="manifest"):
        read_manifest(mgr.step_path(4))


def test_async_save_snapshots_before_returning(tmp_path):
    """The state is updated in place as soon as the async save returns;
    the checkpoint holds the values of the save, and their crcs."""
    state = _state()
    want = {k: v.clone() for k, v in [("w", state["w"]),
                                      ("m", state["opt"]["m"])]}
    want_crc = zlib.crc32(want["w"].numpy().tobytes())
    save_state_dict(state, str(tmp_path / "a"), async_save=True)
    state["w"].add_(1.0)
    state["opt"]["m"].mul_(3.0)
    state["opt"]["master"].zero_()
    wait_save()
    got = restore_arrays(str(tmp_path / "a"))
    assert torch.equal(got["w"], want["w"])
    assert torch.equal(got["opt"]["m"], want["m"])
    man = read_manifest(str(tmp_path / "a"))
    assert {e["path"]: e["crc32"] for e in man["leaves"]}["w"] == want_crc


def test_saves_to_one_path_serialise(tmp_path):
    a, b = _state(), _state()
    b["w"] = b["w"] + 1
    save_state_dict(a, str(tmp_path / "p"), async_save=True)
    save_state_dict(b, str(tmp_path / "p"), async_save=True)
    wait_save()
    got = restore_arrays(str(tmp_path / "p"))
    assert torch.equal(got["w"], b["w"])
    assert not [n for n in os.listdir(tmp_path / "p")
                if n.startswith(".state.tmp")]


def test_load_state_dict_in_place_on_one_rank(tmp_path):
    mesh = Mesh((1,), ("dp",), device_type="cpu")
    src = _state()
    src["blk"] = ShardedTensor(torch.arange(12.0).reshape(4, 3), (4, 3),
                               P("dp"), mesh)
    save_state_dict(src, str(tmp_path / "l"))
    dst = {"w": torch.zeros(32, 8), "opt": {"m": torch.zeros(32, 8),
                                            "master": torch.zeros(
                                                16, dtype=torch.bfloat16)},
           "ids": torch.zeros(10, dtype=torch.int32), "step": 0, "lr": 0.0,
           "blk": ShardedTensor(torch.zeros(4, 3), (4, 3), P("dp"), mesh)}
    load_state_dict(dst, str(tmp_path / "l"))
    assert torch.equal(dst["w"], src["w"])
    assert torch.equal(dst["opt"]["master"], src["opt"]["master"])
    assert torch.equal(dst["blk"].local, src["blk"].local)
    assert dst["step"] == 7 and dst["lr"] == 0.05
    with pytest.raises(KeyError, match="missing"):
        load_state_dict({"nope": torch.zeros(1)}, str(tmp_path / "l"))


def test_async_save_failure_raises_at_wait_save(tmp_path, monkeypatch):
    import importlib

    S = importlib.import_module(
        "paddle_tpu_torch.distributed.checkpoint.save_state_dict")

    def fail(path):
        raise OSError("disk gone")

    monkeypatch.setattr(S, "_fsync_dir", fail)
    save_state_dict(_state(), str(tmp_path / "f"), async_save=True)
    with pytest.raises(OSError, match="disk gone"):
        wait_save()
    wait_save()                         # raised once
    assert read_manifest(str(tmp_path / "f")) is None


def test_restore_without_a_device_goes_to_the_card(tmp_path):
    """A one-rank mesh built without a device type is live, and a restore
    onto it reads no source tensor: its blocks go to the card unless the
    caller passes device='cpu'."""
    from paddle_tpu_torch.distributed.checkpoint.load_state_dict import \
        restore_to_mesh

    save_state_dict(_state(), str(tmp_path / "d"))
    mesh = Mesh((1,), ("dp",))
    tree, _ = restore_to_mesh(str(tmp_path / "d"), mesh, {"w": P("dp")},
                              device="cpu")
    assert tree["w"].device.type == "cpu"
    assert torch.equal(tree["w"], _state()["w"])
    mgr = CheckpointManager(str(tmp_path / "m"))
    mgr.save(_state(), 4)
    if torch.cuda.is_available():
        state, _, _ = mgr.restore_latest(mesh, {"w": P("dp")})
        assert state["w"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore_to_mesh(str(tmp_path / "d"), mesh, {"w": P("dp")})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mgr.restore_latest(mesh, {"w": P("dp")})


# ---------------------------------------------------------------------------
# the reshard4 gang: sharded saves, reshard-on-load, manifests vs JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reshard4(tmp_path_factory):
    from torch_fault_injection import reshard_gang_rank

    root = run_gang("reshard4", reshard_gang_rank, 4, tmp_path_factory)
    return root, [json.loads((root / f"report.{r}.json").read_text())
                  for r in range(4)]


@pytest.mark.parametrize("name", ["dp_to_sharding3", "sharding3_to_tp",
                                  "shrink_4_to_2"])
def test_gang_save_on_a_load_on_b_matches_direct_reshard(name, reshard4):
    _, reports = reshard4
    for rep in reports:
        assert rep[name]["restore"] == [3, []]
        assert rep[name]["load_equals_direct"], name


@pytest.mark.parametrize("name", ["dp_to_sharding3", "sharding3_to_tp",
                                  "shrink_4_to_2"])
def test_gang_manifest_matches_jax(name, reshard4):
    import importlib

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    from paddle_tpu.distributed.checkpoint.save_state_dict import \
        build_manifest
    from torch_fault_injection import RESHARD_PAIRS, pair_state

    jr = importlib.import_module("paddle_tpu.parallel.reshard")
    root, _ = reshard4
    (sa, na, spa), _ = RESHARD_PAIRS[name]
    jmesh = JMesh(np.asarray(jax.devices()[:4], dtype=object).reshape(sa),
                  na)
    tree = {}
    for k, v in pair_state().items():
        if not isinstance(v, np.ndarray):
            tree[k] = v
            continue
        arr = jnp.asarray(v, jnp.bfloat16 if k.startswith("bf.")
                          else jnp.float32)
        tree[k] = jax.device_put(arr, NamedSharding(
            jmesh, jr.fit_spec(JP(*tuple(spa.get(k, P()))), jmesh,
                               v.shape)))
    want = build_manifest(tree)
    got = read_manifest(str(root / f"ckpt_{name}" / "step_00000003"))
    assert got["device_count"] == 4
    assert _fields(got) == _fields(json.loads(json.dumps(want)))


def test_gang_async_save_over_ranks(reshard4):
    _, reports = reshard4
    assert all(rep["async"] for rep in reports)


def test_gang_torn_write_fails_the_save_everywhere(reshard4):
    _, reports = reshard4
    torn = [rep["torn"] for rep in reports]
    assert "reads back with crc32" in torn[0]["raised"], torn[0]
    for t in torn[1:]:
        assert "failed on rank 0" in t["raised"], t
    assert all(t["kept"] for t in torn), torn
