"""Distributed checkpoint save, with a manifest as the commit record.

Port of ``paddle_tpu/distributed/checkpoint/save_state_dict.py``.  The JAX
saver writes through Orbax; the port has its own on-disk format:

- every rank writes the blocks it holds (``ShardedTensor`` leaves), each
  replicated block once, by the lowest rank that holds it; a plain tensor,
  a numpy array or a Python scalar is one block written by rank 0.  A
  block is one file of raw C-order bytes under ``<path>/state/``;
- ``<path>/manifest.json`` is written last (temp + fsync + rename) with
  the fields of JAX's ``build_manifest``: ``format``, ``device_count``
  (the world size) and per leaf ``path``, ``shape``, ``dtype`` (numpy's
  names: ``"bfloat16"``, ``"float32"``), ``crc32`` (``zlib.crc32`` over
  the assembled leaf's host bytes, so it equals JAX's for the same values)
  and ``src`` (``{mesh: {axis_names, shape}, spec}``), plus the port's
  own: ``keys`` (the key path in the tree) and ``blocks`` (file, start,
  shape and crc32 of each block, which the loader reads by range);
- the write is atomic: the blocks go to a temp directory, an existing
  checkpoint is decommitted (its manifest removed) before its tree is
  swapped out, and the manifest commits.  A directory without a manifest
  is incomplete;
- every crc32 is of the values saved, not of what reached the disk: each
  writing rank takes its blocks' crcs from its host snapshot before it
  writes them and hands them to rank 0 (``crc32.<rank>.json`` beside the
  blocks); rank 0 reads back the blocks it does not hold, requires each
  to match its writer's crc, and builds each leaf's crc from them.  A
  mismatch fails the save on every rank (``CheckpointCorruptError``) and
  leaves an existing checkpoint at ``path`` committed.

``async_save=True`` copies this rank's blocks to host memory before it
returns (so a later in-place update of the state cannot reach the
writer), then writes on a thread; ``wait_save()`` joins, and raises the
first error of a save that failed on its thread.  Saves to one path are
serialised: a new save first waits for the one in flight.

Every rank of the live group calls ``save_state_dict`` with the same tree.
With more than one rank the ranks meet at barriers (the default process
group's, or with ``async_save`` those of ``store``, a
``torch.distributed`` store, since a writer thread must not run
collectives beside the training step).
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

MANIFEST_NAME = "manifest.json"
MANIFEST_FORMAT = 1

# one condition variable guards the in-flight table: a writer to a path
# waits until no save of that path is in flight, then claims the slot
_cv = threading.Condition()
_inflight: Dict[str, object] = {}
_save_seq: Dict[str, int] = {}
# errors of async saves, raised by the next wait_save
_failed: List[BaseException] = []

# numpy stand-ins for the dtypes numpy lacks: the bytes ride a same-width
# integer view
_VIEW_AS = {torch.bfloat16: torch.int16}


class CheckpointCorruptError(RuntimeError):
    """The checkpoint is incomplete (no manifest) or fails verification
    (missing leaf or block, checksum mismatch), or a save's written bytes
    differ from the values it was given."""


def dtype_name(dtype) -> str:
    """numpy's name of a torch dtype."""
    from ...parallel.specs import _dtype_name

    return _dtype_name(dtype)


def host_bytes(t: torch.Tensor) -> np.ndarray:
    """A contiguous host numpy view of a tensor's bytes (bf16 through an
    int16 view)."""
    t = t.detach()
    if t.dtype in _VIEW_AS:
        t = t.view(_VIEW_AS[t.dtype])
    return np.ascontiguousarray(t.cpu().numpy())


def leaf_checksum(value) -> int:
    """crc32 over a leaf's host bytes (shape and dtype are recorded
    apart, so a crc match with shape and dtype pins the value)."""
    if isinstance(value, torch.Tensor):
        arr = host_bytes(value)
    else:
        arr = np.ascontiguousarray(np.asarray(value))
    return _crc(arr) & 0xFFFFFFFF


def _buf(arr: np.ndarray):
    """The bytes of a C-contiguous array, without a copy."""
    arr = np.ascontiguousarray(arr)
    return memoryview(arr).cast("B") if arr.size else b""


def _crc(arr: np.ndarray, crc: int = 0) -> int:
    return zlib.crc32(_buf(arr), crc)


# ---------------------------------------------------------------------------
# the snapshot: this rank's blocks on the host
# ---------------------------------------------------------------------------


class _Block:
    __slots__ = ("file", "start", "shape", "data", "crc32")

    def __init__(self, file, start, shape, data=None):
        self.file, self.start, self.shape = file, start, shape
        self.data = data              # host bytes, on the writing rank
        self.crc32: Optional[int] = None


class _Leaf:
    __slots__ = ("keys", "path", "shape", "dtype", "src", "blocks",
                 "scalar")

    def __init__(self, keys, path, shape, dtype, src=None, scalar=None):
        self.keys, self.path, self.shape, self.dtype = keys, path, shape, \
            dtype
        self.src, self.scalar = src, scalar
        self.blocks: List[_Block] = []


def _spec_to_json(x) -> Optional[Dict[str, Any]]:
    """{mesh: {axis_names, shape}, spec: [None | axis | [axes]]} of a
    ``ShardedTensor``'s placement."""
    entries = []
    for e in tuple(x.spec):
        if e is None:
            entries.append(None)
        elif isinstance(e, tuple):
            entries.append([str(a) for a in e])
        else:
            entries.append(str(e))
    mesh = x.mesh
    return {"mesh": {"axis_names": [str(a) for a in mesh.axis_names],
                     "shape": [int(mesh.shape[a]) for a in mesh.axis_names]},
            "spec": entries}


def _walk(tree: Dict[str, Any], keys=()) -> List[Tuple[Tuple[str, ...], Any]]:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.extend(_walk(v, keys + (str(k),)))
        else:
            out.append((keys + (str(k),), v))
    return out


def _world() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _snapshot(state_dict: Dict[str, Any], rank: int) -> List[_Leaf]:
    """Every leaf's record, with this rank's blocks copied to the host
    (a fresh copy: nothing the caller does later reaches it)."""
    from ...parallel.reshard import _is_owner, block_slices
    from ...parallel.specs import ShardedTensor

    leaves = []
    for i, (keys, v) in enumerate(_walk(state_dict)):
        path = ".".join(keys)
        if isinstance(v, ShardedTensor):
            if v.partial:
                raise ValueError(f"{path}: a partial ShardedTensor cannot "
                                 f"be saved; complete it first")
            leaf = _Leaf(keys, path, tuple(v.shape), dtype_name(v.dtype),
                         src=_spec_to_json(v))
            mesh = v.mesh
            for r in range(mesh.size):
                if not _is_owner(v.spec, mesh, r):
                    continue
                box = block_slices(v.spec, v.shape, mesh, r)
                b = _Block(f"{i:05d}.{r:05d}.bin",
                           [s.start for s in box],
                           [s.stop - s.start for s in box])
                if r == (mesh.rank if mesh.size > 1 else 0):
                    b.data = host_bytes(v.local).copy() \
                        if v.local.device.type == "cpu" \
                        else host_bytes(v.local)
                leaf.blocks.append(b)
            leaves.append(leaf)
            continue
        if isinstance(v, (bool, int, float)) or (
                isinstance(v, np.generic)):
            arr = np.asarray(v)
            leaf = _Leaf(keys, path, (), str(arr.dtype), scalar=type(
                v).__name__ if isinstance(v, (bool, int, float)) else None)
        elif isinstance(v, torch.Tensor):
            arr = host_bytes(v)
            if v.device.type == "cpu":
                arr = arr.copy()
            leaf = _Leaf(keys, path, tuple(v.shape), dtype_name(v.dtype))
        elif isinstance(v, np.ndarray):
            arr = np.array(v, copy=True, order="C")
            leaf = _Leaf(keys, path, tuple(v.shape), str(v.dtype))
        else:
            raise TypeError(f"{path}: cannot checkpoint a "
                            f"{type(v).__name__}")
        b = _Block(f"{i:05d}.00000.bin", [0] * arr.ndim, list(arr.shape),
                   arr if rank == 0 else None)
        leaf.blocks.append(b)
        leaves.append(leaf)
    return leaves


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _write_file(path: str, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(_buf(arr))
        f.flush()
        os.fsync(f.fileno())


def _np_dtype(name: str):
    return np.dtype("int16") if name == "bfloat16" else np.dtype(name)


def _read_block(tmp: str, leaf: _Leaf, b: _Block) -> np.ndarray:
    return np.fromfile(os.path.join(tmp, b.file),
                       dtype=_np_dtype(leaf.dtype)).reshape(b.shape)


def _leaf_crc(tmp: str, leaf: _Leaf) -> int:
    """The crc32 of the assembled leaf: rank 0's blocks from its snapshot,
    the others read back, each required to match its writer's crc (taken
    from the writer's snapshot before the write)."""
    blocks = []
    for b in leaf.blocks:
        arr = b.data
        if arr is None:
            arr = _read_block(tmp, leaf, b)
            got = _crc(arr) & 0xFFFFFFFF
            if got != b.crc32:
                raise CheckpointCorruptError(
                    f"leaf {leaf.path!r}: block {b.file} reads back with "
                    f"crc32 {got:#010x}, its writer saved {b.crc32:#010x}")
        blocks.append((b, arr))
    if len(blocks) == 1:
        return blocks[0][0].crc32
    full = np.empty(leaf.shape, dtype=_np_dtype(leaf.dtype))
    for b, arr in blocks:
        full[tuple(slice(s, s + n) for s, n in zip(b.start, b.shape))] = arr
    return _crc(full) & 0xFFFFFFFF


def _crc_file(tmp: str, rank: int) -> str:
    return os.path.join(tmp, f"crc32.{rank}.json")


def _take_crcs(tmp: str, world: int, leaves: List[_Leaf]) -> None:
    """Rank 0: the other ranks' block crcs, from their files (removed,
    so they do not join the committed tree)."""
    theirs: Dict[str, int] = {}
    for r in range(1, world):
        with open(_crc_file(tmp, r)) as f:
            theirs.update(json.load(f))
        os.remove(_crc_file(tmp, r))
    for leaf in leaves:
        for b in leaf.blocks:
            if b.data is None:
                if b.file not in theirs:
                    raise CheckpointCorruptError(
                        f"leaf {leaf.path!r}: no rank reported block "
                        f"{b.file}")
                b.crc32 = theirs[b.file]


def _manifest(leaves: List[_Leaf], world: int,
              crcs: Dict[str, int]) -> Dict[str, Any]:
    out = []
    for leaf in leaves:
        entry: Dict[str, Any] = {
            "path": leaf.path, "shape": [int(s) for s in leaf.shape],
            "dtype": leaf.dtype, "crc32": crcs[leaf.path]}
        if leaf.src is not None:
            entry["src"] = leaf.src
        entry["keys"] = list(leaf.keys)
        entry["blocks"] = [{"file": b.file, "start": b.start,
                            "shape": b.shape, "crc32": b.crc32}
                           for b in leaf.blocks]
        if leaf.scalar is not None:
            entry["scalar"] = leaf.scalar
        out.append(entry)
    return {"format": MANIFEST_FORMAT, "device_count": world, "leaves": out}


@contextlib.contextmanager
def atomic_write(path: str, suffix: str = ".tmp"):
    """Write a temp file, fsync it, rename it over ``path``; on error the
    temp is removed and ``path`` is left as it was."""
    tmp = f"{path}{suffix}.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            yield f
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise


def write_manifest(path: str, manifest: Dict[str, Any]) -> None:
    """temp + fsync + rename: the manifest is the commit record, so it
    never exists half-written."""
    with atomic_write(os.path.join(path, MANIFEST_NAME)) as f:
        f.write(json.dumps(manifest, indent=1).encode())


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class _Barrier:
    """The ranks' meeting points of one save."""

    def __init__(self, rank: int, world: int, store, key: str):
        self.rank, self.world, self.store, self.key, self.n = \
            rank, world, store, key, 0

    def __call__(self):
        if self.world <= 1:
            return
        self.n += 1
        if self.store is not None:
            from ..store import store_barrier

            store_barrier(self.store, f"{self.key}/{self.n}", self.world,
                          timeout=600.0)
        else:
            import torch.distributed as dist

            dist.barrier()

    def verdict(self, error: Optional[str]) -> Optional[str]:
        """The last meeting point: rank 0's outcome (None: committed, else
        its error) at every rank."""
        if self.world <= 1:
            return error
        if self.store is not None:
            key = f"{self.key}/verdict"
            if self.rank == 0:
                self.store.set(key, (error or "").encode())
            self()
            return self.store.get(key).decode() or None
        import torch.distributed as dist

        box = [error]
        dist.broadcast_object_list(box, src=0)
        return box[0]


def save_state_dict(state_dict: Dict[str, Any], path: str,
                    async_save: bool = False, store=None,
                    timings: Optional[Dict[str, float]] = None) -> None:
    """Save a (possibly sharded) state dict to the directory ``path`` (see
    the module docstring); the default process group's ranks write and
    rank 0 commits.  ``timings`` (a dict) receives the seconds spent
    copying to the host (``d2h_s``), in crc32 (``crc_s``) and writing
    (``write_s``, fsyncs included)."""
    import time

    path = os.path.abspath(path)
    rank, world = _world()
    if async_save and world > 1 and store is None:
        raise ValueError("an async save over several ranks needs store= "
                         "(a torch.distributed store for its barriers)")
    with _cv:
        while path in _inflight:
            _cv.wait()
        _inflight[path] = object()      # claim the slot
        seq = _save_seq.get(path, 0)
        _save_seq[path] = seq + 1
    try:
        t0 = time.perf_counter()
        leaves = _snapshot(state_dict, rank)
        if timings is not None:
            timings["d2h_s"] = time.perf_counter() - t0
    except BaseException:
        _release(path)
        raise
    barrier = _Barrier(rank, world, store if async_save else None,
                       f"ckpt{path}/{seq}")

    def _do():
        final = os.path.join(path, "state")
        tmp = os.path.join(path, f".state.tmp.{seq}")
        if rank == 0:
            os.makedirs(path, exist_ok=True)
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        barrier()
        try:
            mine = [b for lf in leaves for b in lf.blocks
                    if b.data is not None]
            t1 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=8) as pool:
                for b, c in zip(mine, pool.map(lambda b: _crc(b.data),
                                               mine)):
                    b.crc32 = c & 0xFFFFFFFF
            t_crc = time.perf_counter() - t1
            t1 = time.perf_counter()
            with ThreadPoolExecutor(max_workers=8) as pool:
                list(pool.map(lambda b: _write_file(
                    os.path.join(tmp, b.file), b.data), mine))
            if rank != 0:
                with atomic_write(_crc_file(tmp, rank)) as f:
                    f.write(json.dumps({b.file: b.crc32 for b in mine})
                            .encode())
            t_write = time.perf_counter() - t1
            barrier()
            if rank != 0:
                error = barrier.verdict(None)
                if error is not None:
                    raise CheckpointCorruptError(
                        f"checkpoint {path}: the save failed on rank 0: "
                        f"{error}")
                return
            try:
                t2 = time.perf_counter()
                _take_crcs(tmp, world, leaves)
                with ThreadPoolExecutor(max_workers=8) as pool:
                    crcs = dict(zip([lf.path for lf in leaves],
                                    pool.map(lambda lf: _leaf_crc(tmp, lf),
                                             leaves)))
                t_crc += time.perf_counter() - t2
                t3 = time.perf_counter()
                _fsync_dir(tmp)
                if os.path.exists(final):
                    # overwrite: DECOMMIT first (remove the manifest before
                    # touching the old tree), so a crash mid-swap leaves
                    # the directory visibly incomplete, never complete but
                    # corrupt
                    mpath = os.path.join(path, MANIFEST_NAME)
                    if os.path.exists(mpath):
                        os.remove(mpath)
                    shutil.rmtree(final)
                os.replace(tmp, final)
                write_manifest(path, _manifest(leaves, world, crcs))
                _fsync_dir(path)
                t_write += time.perf_counter() - t3
            except BaseException as e:
                barrier.verdict(repr(e))
                raise
            barrier.verdict(None)
            if timings is not None:
                timings["crc_s"] = t_crc
                timings["write_s"] = t_write
        finally:
            if rank == 0 and os.path.exists(tmp):
                shutil.rmtree(tmp, ignore_errors=True)

    def _run():
        try:
            _do()
        except BaseException as e:
            if not async_save:
                raise
            with _cv:
                _failed.append(e)
        finally:
            _release(path)

    if async_save:
        threading.Thread(target=_run, daemon=True).start()
    else:
        _run()


def _release(path: str) -> None:
    with _cv:
        _inflight.pop(path, None)
        _cv.notify_all()


def wait_save() -> None:
    """Block until no async save is in flight; then raise the first error
    of an async save that failed since the last call."""
    with _cv:
        while _inflight:
            _cv.wait()
        errors = _failed[:]
        _failed.clear()
    if errors:
        raise errors[0]


# async writers are daemon threads: flush them at interpreter exit so a
# dispatched checkpoint is never cut mid-write
atexit.register(wait_save)
