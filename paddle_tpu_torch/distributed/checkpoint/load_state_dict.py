"""Distributed checkpoint load, verified, with reshard-on-load.

Port of ``paddle_tpu/distributed/checkpoint/load_state_dict.py`` over the
port's format (``save_state_dict.py``).  ``read_manifest`` reads the
commit record; ``restore_arrays`` reads a checkpoint whole to host values
and ``verify_restored`` checks every leaf's crc32 against the manifest
(``CheckpointCorruptError`` on a mismatch, a missing leaf or block, or an
unreadable manifest).

``load_state_dict`` fills a destination tree in place, each leaf at its
current placement, and ``restore_to_mesh`` builds a tree on a new mesh:
both route through one reshard plan per destination mesh
(``parallel.reshard.plan_reshard`` over the manifest's shapes and dtypes,
``_group_reshard``), and each rank reads, chunk by chunk, only the byte
ranges of the blocks its destination block needs (a memory map of each
block file), staged through pinned host memory to a CUDA destination.
With ``verify`` every block a rank reads is first checked against its
crc32 in the manifest, read once whole in 64 MiB pieces.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .save_state_dict import (MANIFEST_NAME, CheckpointCorruptError,
                              _np_dtype, leaf_checksum)

_VERIFY_PIECE = 64 << 20
_DEFAULT_CAP = 64 << 20     # parallel.reshard.DEFAULT_TRANSIENT_BYTES


def read_manifest(path: str) -> Optional[Dict[str, Any]]:
    """The checkpoint's commit record, or None when there is none.  A
    manifest present but unreadable is corruption."""
    mpath = os.path.join(os.path.abspath(path), MANIFEST_NAME)
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath, "rb") as f:
            return json.loads(f.read().decode())
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"unreadable manifest at {mpath}: {e!r}") from e


def _torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name) if name != "bool" else torch.bool


def _to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _block_file(path: str, blk: Dict[str, Any]) -> str:
    return os.path.join(path, "state", blk["file"])


def _map_block(path: str, entry: Dict[str, Any], blk: Dict[str, Any]):
    """A read-only memory map of one block (nothing is read until
    sliced)."""
    f = _block_file(path, blk)
    dt = _np_dtype(entry["dtype"])
    shape = tuple(blk["shape"])
    want = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
    try:
        size = os.path.getsize(f)
    except OSError as e:
        raise CheckpointCorruptError(
            f"checkpoint {path} leaf {entry['path']!r}: block {blk['file']} "
            f"is missing") from e
    if size != want:
        raise CheckpointCorruptError(
            f"checkpoint {path} leaf {entry['path']!r}: block {blk['file']} "
            f"holds {size} bytes, not {want}")
    if want == 0:
        return np.zeros(shape, dt)
    return np.memmap(f, dtype=dt, mode="r", shape=shape)


def _verify_block(path: str, entry: Dict[str, Any],
                  blk: Dict[str, Any]) -> None:
    """Read a block file whole, in pieces, and check its crc32."""
    want = blk.get("crc32")
    if want is None:
        return
    crc = 0
    try:
        with open(_block_file(path, blk), "rb") as f:
            while True:
                piece = f.read(_VERIFY_PIECE)
                if not piece:
                    break
                crc = zlib.crc32(piece, crc)
    except OSError as e:
        raise CheckpointCorruptError(
            f"checkpoint {path} leaf {entry['path']!r}: block {blk['file']} "
            f"unreadable: {e!r}") from e
    if crc & 0xFFFFFFFF != want:
        raise CheckpointCorruptError(
            f"checkpoint {path} leaf {entry['path']!r}: block {blk['file']} "
            f"crc32 {crc & 0xFFFFFFFF:#010x} != recorded {want:#010x} "
            f"(bit rot / torn write)")


def _nest(items: List[Tuple[List[str], Any]]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for keys, v in items:
        d = out
        for k in keys[:-1]:
            d = d.setdefault(k, {})
        d[keys[-1]] = v
    return out


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + str(k) + "."))
        else:
            out[prefix + str(k)] = v
    return out


def _scalar(entry, arr: np.ndarray):
    kind = entry.get("scalar")
    if kind is None:
        return None
    return {"bool": bool, "int": int, "float": float}[kind](arr.item())


def _read_leaf(path: str, entry: Dict[str, Any]):
    """One leaf assembled whole on the host."""
    dt = _np_dtype(entry["dtype"])
    full = np.empty(tuple(entry["shape"]), dtype=dt)
    for blk in entry["blocks"]:
        box = tuple(slice(s, s + n) for s, n in zip(blk["start"],
                                                    blk["shape"]))
        full[box] = _map_block(path, entry, blk)
    s = _scalar(entry, full)
    return s if s is not None else _to_tensor(full, entry["dtype"])


def verify_restored(restored: Dict[str, Any],
                    manifest: Dict[str, Any], path: str = "") -> None:
    """Every manifest leaf is present with the recorded shape, dtype and
    crc32."""
    flat = _flatten(restored)
    for entry in manifest.get("leaves", ()):
        lpath = entry["path"]
        if lpath not in flat:
            raise CheckpointCorruptError(
                f"checkpoint {path} is missing leaf {lpath!r}")
        if entry.get("opaque") or "crc32" not in entry:
            continue
        v = flat[lpath]
        if isinstance(v, torch.Tensor):
            shape = list(v.shape)
            dtype = str(v.dtype).rsplit(".", 1)[-1]
        else:
            arr = np.asarray(v)
            shape, dtype = list(arr.shape), str(arr.dtype)
        if shape != entry["shape"] or dtype != entry["dtype"]:
            raise CheckpointCorruptError(
                f"checkpoint {path} leaf {lpath!r}: shape/dtype "
                f"{shape}/{dtype} != recorded {entry['shape']}/"
                f"{entry['dtype']}")
        got = leaf_checksum(v)
        if got != entry["crc32"]:
            raise CheckpointCorruptError(
                f"checkpoint {path} leaf {lpath!r}: crc32 {got:#010x} != "
                f"recorded {entry['crc32']:#010x} (bit rot / torn write)")


def _manifest_of(path: str) -> Dict[str, Any]:
    manifest = read_manifest(path)
    if manifest is None:
        raise CheckpointCorruptError(f"checkpoint {path} has no manifest "
                                     f"(an incomplete write)")
    return manifest


def restore_arrays(path: str, verify: bool = True) -> Dict[str, Any]:
    """The checkpoint's whole value tree on the host (CPU tensors, Python
    scalars as saved), verified against the manifest."""
    path = os.path.abspath(path)
    manifest = _manifest_of(path)
    try:
        restored = _nest([(e["keys"], _read_leaf(path, e))
                          for e in manifest["leaves"]])
    except CheckpointCorruptError:
        raise
    except (OSError, ValueError, KeyError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {path} failed to restore: {e!r}") from e
    if verify:
        verify_restored(restored, manifest, path)
    return restored


# ---------------------------------------------------------------------------
# reshard-on-load: ranges of blocks into destination blocks
# ---------------------------------------------------------------------------


def _stub(entry: Dict[str, Any]):
    """A stand-in leaf of the entry's shape and dtype for the planner (a
    meta tensor: no memory), or the scalar's value."""
    if entry.get("scalar") is not None:
        return {"bool": False, "int": 0, "float": 0.0}[entry["scalar"]]
    return torch.empty(tuple(entry["shape"]),
                       dtype=_torch_dtype(entry["dtype"]), device="meta")


def _load_leaf(path, entry, lp, dst_mesh, rank, device, verify, staging):
    """This rank's destination block of one leaf, read chunk by chunk
    from the byte ranges it needs."""
    from ...parallel.reshard import (_chunk_box, _dst_device, _intersect,
                                     _place, _relative, block_slices)

    if entry.get("scalar") is not None:
        blk = entry["blocks"][0]
        if verify:
            _verify_block(path, entry, blk)
        return _scalar(entry, np.asarray(_map_block(path, entry, blk)))
    if rank is None and dst_mesh.size == 1:
        rank = 0
    if rank is None:
        return None
    dev = _dst_device(None, dst_mesh, device)
    shape = tuple(entry["shape"])
    mine = block_slices(lp.dst_spec, shape, dst_mesh, rank)
    dst = torch.empty(tuple(s.stop - s.start for s in mine),
                      dtype=_torch_dtype(entry["dtype"]), device=dev)
    srcs = []
    for blk in entry["blocks"]:
        bbox = tuple(slice(s, s + n) for s, n in zip(blk["start"],
                                                     blk["shape"]))
        if shape and _intersect(mine, bbox) is None:
            continue
        if verify:
            _verify_block(path, entry, blk)
        srcs.append((bbox, _map_block(path, entry, blk)))
    if not shape:
        dst.copy_(_to_tensor(np.asarray(srcs[0][1]), entry["dtype"]))
        return _place(lp, dst, dst_mesh)
    for a, b in lp.chunks:
        box = _intersect(mine, _chunk_box(lp, a, b))
        if box is None:
            continue
        for bbox, mm in srcs:
            part = _intersect(box, bbox)
            if part is None:
                continue
            piece = _to_tensor(np.array(mm[_relative(part, bbox)]),
                               entry["dtype"])
            dst[_relative(part, mine)] = staging(piece, dev)
    return _place(lp, dst, dst_mesh)


def restore_to_mesh(path: str, dst_mesh, dst_specs=None, *,
                    max_transient_bytes=_DEFAULT_CAP, verify: bool = True,
                    rank: Optional[int] = None, device=None,
                    entries: Optional[List[Dict[str, Any]]] = None):
    """The checkpoint's tree laid out on ``dst_mesh`` per ``dst_specs``
    (the reshard planner's forms), through one reshard plan: (tree, plan).
    ``rank``: this process's rank on ``dst_mesh`` (default the mesh's
    own); ``entries`` restricts the load to those manifest leaves.
    ``max_transient_bytes``: the planner's cap (None: unbounded)."""
    from ...parallel.reshard import _Staging, plan_reshard

    path = os.path.abspath(path)
    manifest = _manifest_of(path)
    entries = entries if entries is not None else manifest["leaves"]
    if rank is None and dst_mesh._rank is not None:
        rank = dst_mesh.rank
    stubs = {e["path"]: _stub(e) for e in entries}
    plan = plan_reshard(stubs, dst_mesh, dst_specs,
                        max_transient_bytes=max_transient_bytes)
    by_path = {lp.path: lp for lp in plan.leaf_plans}
    staging = _Staging()
    try:
        out = [(e["keys"], _load_leaf(path, e, by_path[e["path"]], dst_mesh,
                                      rank, device, verify, staging))
               for e in entries]
    except CheckpointCorruptError:
        raise
    except (OSError, ValueError, KeyError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {path} failed to restore: {e!r}") from e
    return _nest(out), plan


def _group_reshard(path: str, assign, verify: bool) -> None:
    """``assign``: (manifest entry, destination ShardedTensor, setter).
    The leaves bound for one mesh load through one reshard plan."""
    by_mesh: Dict[int, list] = {}
    for item in assign:
        by_mesh.setdefault(id(item[1].mesh), []).append(item)
    for items in by_mesh.values():
        mesh = items[0][1].mesh
        specs = {e["path"]: d.spec for e, d, _ in items}
        tree, _ = restore_to_mesh(path, mesh, specs, verify=verify,
                                  entries=[e for e, _, _ in items],
                                  device=items[0][1].local.device)
        flat = _flatten(tree)
        for e, _, setter in items:
            setter(flat[".".join(e["keys"])])


def load_state_dict(state_dict: Dict[str, Any], path: str,
                    verify: bool = True) -> None:
    """In place: fill ``state_dict``'s leaves from ``path``, each
    ``ShardedTensor`` at its current placement (reshard-on-load, blocks
    read by range), a plain tensor whole, a Python scalar replaced.  Every
    rank of the live group calls it."""
    from ...parallel.specs import ShardedTensor

    path = os.path.abspath(path)
    manifest = _manifest_of(path)
    by_keys = {tuple(e["keys"]): e for e in manifest["leaves"]}
    assign = []

    def walk(dst: Dict[str, Any], keys=()):
        for k, v in dst.items():
            kk = keys + (str(k),)
            if isinstance(v, dict):
                walk(v, kk)
                continue
            e = by_keys.get(kk)
            if e is None:
                raise KeyError(f"checkpoint missing key {'.'.join(kk)!r}")
            if isinstance(v, ShardedTensor):
                if list(v.shape) != e["shape"]:
                    raise ValueError(f"{'.'.join(kk)}: destination shape "
                                     f"{v.shape} != saved {e['shape']}")
                assign.append((e, v, lambda t, v=v: v.local.copy_(
                    t.local if isinstance(t, ShardedTensor) else t)))
            elif isinstance(v, torch.Tensor):
                blk = _read_leaf_verified(path, e, verify)
                v.copy_(blk)
            else:
                dst[k] = _read_leaf_verified(path, e, verify)

    walk(state_dict)
    if assign:
        _group_reshard(path, assign, verify)


def _read_leaf_verified(path, entry, verify):
    if verify:
        for blk in entry["blocks"]:
            _verify_block(path, entry, blk)
    return _read_leaf(path, entry)


__all__ = ["CheckpointCorruptError", "load_state_dict", "read_manifest",
           "restore_arrays", "restore_to_mesh", "verify_restored"]
