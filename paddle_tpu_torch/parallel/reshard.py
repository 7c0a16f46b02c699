"""Size-capped redistribution of a state tree from one mesh to another.

Port of ``paddle_tpu/parallel/reshard.py``.  ``plan_reshard`` takes a tree
placed for mesh A (``ShardedTensor`` leaves; plain tensors, numpy arrays
and Python scalars too) and plans moving the same values to mesh B laid
out per destination specs, in steps whose transient bytes stay under a
declared cap: leaves are bucketed into steps by the overlap engine's one
bucketing rule (``overlap.split_by_bytes``), and a leaf whose own transit
would pass the cap is cut into chunks along an axis the destination
placement allows.  The plan math is host-only and equals JAX's
(``ReshardPlan.summary()``).

Three routes per leaf:

- ``noop``: already laid out for mesh B (or a scalar);
- ``device``: meshes A and B address the same ranks (a live
  re-partitioning): each chunk is assembled over its source axes by
  ``compat``'s collectives (a byte-wise sum in which every rank of an axis
  line adds its own block) and cut to this rank's destination block;
- ``host``: the rank sets differ (an elastic shrink or grow, a restore
  from host values): each chunk is assembled over the live process group
  that holds both meshes' ranks (the lowest holder of each source block
  adds it), staged through pinned host memory, and cut to the destination
  block.  A host value (numpy, a tensor on one rank) needs no collective.

Either way a rank holds, beyond its source and destination blocks, one
assembled chunk and its staging copy: the 2 x chunk the plan prices.

Destinations are ``ShardedTensor`` blocks on mesh B, plain tensors when B
has one rank (a block is then the whole tensor).  ``execute(tree,
rank=r)`` plans for a mesh B whose process group does not exist yet (the
elastic shrink reshards before the old group is torn down):
``bind_mesh`` moves the blocks onto the live mesh afterwards.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .overlap import split_by_bytes
from .specs import Mesh, P, ShardedTensor, _entry_axes, mesh_device_ids

# default per-step transient cap: two copies (transit + destination) of at
# most this many bytes are live beyond the source/destination residency
DEFAULT_TRANSIENT_BYTES = 64 << 20


# ---------------------------------------------------------------------------
# tree <-> (path, leaf)
# ---------------------------------------------------------------------------


def path_leaves(tree) -> Tuple[List[Tuple[str, Any]], Any]:
    """Flatten nested dicts (keys sorted, as JAX flattens them), lists and
    tuples to dotted-path leaves (``{"a": {"b": x}}`` -> ``[("a.b", x)]``),
    plus the structure ``unflatten`` rebuilds; None is an empty subtree."""
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix):
        if isinstance(node, dict):
            return ("dict", [(k, walk(node[k], f"{prefix}{k}."))
                             for k in sorted(node)])
        if isinstance(node, (list, tuple)):
            return (type(node), [walk(v, f"{prefix}{i}.")
                                 for i, v in enumerate(node)])
        if node is None:
            return ("none", None)
        out.append((prefix[:-1], node))
        return ("leaf", len(out) - 1)

    return out, walk(tree, "")


def unflatten(treedef, leaves: Sequence[Any]):
    """The tree of ``treedef`` (from ``path_leaves``) over ``leaves``."""
    kind, body = treedef
    if kind == "dict":
        return {k: unflatten(d, leaves) for k, d in body}
    if kind == "none":
        return None
    if kind == "leaf":
        return leaves[body]
    return kind(unflatten(d, leaves) for d in body)


def _resolve_spec(specs, path: str, leaf) -> P:
    """One destination spec for ``path``: ``specs`` is a dict of dotted
    paths (missing: replicated), a callable ``(path, leaf) -> P``, one P
    for every leaf, None (replicate everything) or a
    ``PartitionSchedule`` (its ``reshard_spec`` rule)."""
    if specs is None:
        return P()
    if hasattr(specs, "reshard_spec"):
        specs = specs.reshard_spec
    if isinstance(specs, P):
        return specs
    if isinstance(specs, dict):
        got = specs.get(path)
        return P(*got) if got is not None else P()
    if callable(specs):
        got = specs(path, leaf)
        return P(*got) if got is not None else P()
    raise TypeError(f"dst_specs must be dict/callable/P/None, got "
                    f"{type(specs)}")


def _axis_product(entry, mesh: Mesh) -> int:
    return int(np.prod([mesh.shape[a] for a in _entry_axes(entry)]))


def fit_spec(spec: P, mesh: Mesh, shape: Sequence[int]) -> P:
    """Drop spec entries whose axes are absent or of size 1 on ``mesh`` or
    do not divide the dim: a spec written for mesh A degrades to a valid
    mesh-B placement (replication is always correct), never an error."""
    names = set(mesh.axis_names)
    entries = list(tuple(spec))[:len(shape)]
    entries += [None] * (len(shape) - len(entries))
    out: List[Any] = []
    for i, e in enumerate(entries):
        if e is None:
            out.append(None)
            continue
        kept = tuple(a for a in _entry_axes(e)
                     if a in names and mesh.shape[a] > 1)
        if not kept or shape[i] % _axis_product(kept, mesh) != 0:
            out.append(None)
            continue
        out.append(kept if len(kept) > 1 else kept[0])
    return P(*out)


# ---------------------------------------------------------------------------
# blocks of a placement
# ---------------------------------------------------------------------------


def block_slices(spec: P, shape: Sequence[int], mesh: Mesh, rank: int
                 ) -> Tuple[slice, ...]:
    """The block of global ``shape`` that ``rank`` of ``mesh`` holds under
    ``spec`` (the row-major block index over each entry's axes)."""
    coords = dict(zip(mesh.axis_names,
                      np.unravel_index(int(rank), mesh.devices.shape)))
    out = []
    for i, dim in enumerate(shape):
        axes = _entry_axes(tuple(spec)[i]) if i < len(spec) else ()
        axes = tuple(a for a in axes if mesh.shape.get(a, 1) > 1)
        ways = math.prod(int(mesh.shape[a]) for a in axes) if axes else 1
        idx = 0
        for a in axes:
            idx = idx * int(mesh.shape[a]) + int(coords[a])
        blk = int(dim) // ways
        out.append(slice(idx * blk, (idx + 1) * blk))
    return tuple(out)


def _is_owner(spec: P, mesh: Mesh, rank: int) -> bool:
    """True when ``rank`` is the lowest rank holding its block: coordinate
    0 on every axis the spec does not cut."""
    used = {a for e in tuple(spec) for a in _entry_axes(e)}
    coords = np.unravel_index(int(rank), mesh.devices.shape)
    return all(c == 0 for a, c in zip(mesh.axis_names, coords)
               if a not in used and mesh.shape[a] > 1)


def _same_layout(src: ShardedTensor, dst_spec: P, dst_mesh: Mesh) -> bool:
    """The source placement cuts every rank's block as ``dst_spec`` on
    ``dst_mesh`` does (JAX's ``is_equivalent_to``)."""
    if mesh_device_ids(src.mesh) != mesh_device_ids(dst_mesh):
        return False
    return all(block_slices(src.spec, src.shape, src.mesh, r)
               == block_slices(dst_spec, src.shape, dst_mesh, r)
               for r in range(dst_mesh.size))


def _intersect(a: Tuple[slice, ...], b: Tuple[slice, ...]
               ) -> Optional[Tuple[slice, ...]]:
    out = []
    for x, y in zip(a, b):
        lo, hi = max(x.start, y.start), min(x.stop, y.stop)
        if hi <= lo:
            return None
        out.append(slice(lo, hi))
    return tuple(out)


def _relative(box: Tuple[slice, ...], origin: Tuple[slice, ...]
              ) -> Tuple[slice, ...]:
    return tuple(slice(b.start - o.start, b.stop - o.start)
                 for b, o in zip(box, origin))


# ---------------------------------------------------------------------------
# plan data model
# ---------------------------------------------------------------------------


@dataclass
class LeafPlan:
    """Redistribution recipe of one leaf."""

    path: str
    shape: Tuple[int, ...]
    dtype: Any
    dst_spec: P
    route: str                       # "noop" | "device" | "host"
    chunk_axis: Optional[int]        # None = whole-leaf move
    chunks: List[Tuple[int, int]]    # [start, stop) spans on chunk_axis
    nbytes: int
    transient_bytes: int             # peak transit of the worst chunk
    dcn: bool = False                # crosses a slice-spanning dst axis

    @property
    def moved(self) -> bool:
        return self.route != "noop"


@dataclass
class ReshardStep:
    """One bounded step: the leaves moved together; their summed worst-
    chunk transit is the step's transient footprint."""

    leaves: List[LeafPlan]
    transient_bytes: int


class ReshardPlan:
    """The planned redistribution; ``execute`` applies it.  ``telemetry``
    counts the executions and the bytes their host-route chunks staged
    toward the destination (``staged_bytes`` over all executions,
    ``last_staged_bytes`` of the latest): raw bytes for a plain chunk, the
    packed bytes for a coded one (``execute_encoded``)."""

    def __init__(self, dst_mesh: Mesh, steps: List[ReshardStep],
                 leaf_plans: List[LeafPlan],
                 transient_budget: Optional[int]):
        self.dst_mesh = dst_mesh
        self.steps = steps
        self.leaf_plans = leaf_plans
        self.transient_budget = transient_budget
        self.telemetry: Dict[str, int] = {
            "executions": 0, "staged_bytes": 0, "last_staged_bytes": 0}

    @property
    def total_bytes(self) -> int:
        return sum(lp.nbytes for lp in self.leaf_plans)

    @property
    def moved_bytes(self) -> int:
        return sum(lp.nbytes for lp in self.leaf_plans if lp.moved)

    @property
    def dcn_bytes(self) -> int:
        return sum(lp.nbytes for lp in self.leaf_plans if lp.dcn)

    @property
    def max_step_transient(self) -> int:
        return max((s.transient_bytes for s in self.steps), default=0)

    def summary(self) -> Dict[str, Any]:
        return {
            "leaves": len(self.leaf_plans),
            "moved": sum(1 for lp in self.leaf_plans if lp.moved),
            "steps": len(self.steps),
            "total_bytes": self.total_bytes,
            "moved_bytes": self.moved_bytes,
            "dcn_bytes": self.dcn_bytes,
            "max_step_transient": self.max_step_transient,
            "transient_budget": self.transient_budget,
            "dst_mesh": {"axis_names": list(self.dst_mesh.axis_names),
                         "shape": [int(self.dst_mesh.shape[a])
                                   for a in self.dst_mesh.axis_names]},
        }

    def execute(self, tree, *, rank: Optional[int] = None,
                device=None, _leaf_fn=None):
        """Apply the plan to ``tree`` (the structure and shapes it was
        planned for): the same values laid out on the destination mesh,
        bit for bit.  Every rank of the live group calls it (the chunks
        are assembled by collectives).  ``rank``: this process's rank on
        the destination mesh (default: the mesh's own; None on a rank that
        leaves the new mesh, whose moved leaves come back None).
        ``device``: where destination blocks go (default: the destination
        mesh's device type, else the source leaf's device)."""
        if rank is None and self.dst_mesh._rank is not None:
            rank = self.dst_mesh.rank
        flat, treedef = path_leaves(tree)
        by_path = {lp.path: lp for lp in self.leaf_plans}
        staging = _Staging()
        out = []
        for path, val in flat:
            lp = by_path.get(path)
            if lp is None:
                raise KeyError(f"leaf {path!r} was not in the planned tree")
            fn = _leaf_fn or _execute_leaf
            out.append(fn(lp, val, self.dst_mesh, rank, device, staging))
        self.telemetry["executions"] += 1
        self.telemetry["staged_bytes"] += staging.bytes
        self.telemetry["last_staged_bytes"] = staging.bytes
        return unflatten(treedef, out)

    def __repr__(self):
        s = self.summary()
        return (f"ReshardPlan(leaves={s['leaves']}, moved={s['moved']}, "
                f"steps={s['steps']}, moved_bytes={s['moved_bytes']}, "
                f"max_step_transient={s['max_step_transient']})")


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------


def _is_array(val) -> bool:
    return isinstance(val, (ShardedTensor, torch.Tensor, np.ndarray))


def _leaf_meta(val) -> Tuple[Tuple[int, ...], Any, int]:
    """(global shape, dtype, itemsize) of an array leaf."""
    if isinstance(val, ShardedTensor):
        return tuple(val.shape), val.dtype, val.local.element_size()
    if isinstance(val, torch.Tensor):
        return tuple(int(s) for s in val.shape), val.dtype, \
            val.element_size()
    return tuple(int(s) for s in val.shape), val.dtype, val.dtype.itemsize


def _spec_entry(spec: P, i: int):
    t = tuple(spec)
    return t[i] if i < len(t) else None


def _choose_chunk_axis(shape: Sequence[int], dst_spec: P, mesh: Mesh,
                       want: int) -> Optional[Tuple[int, int]]:
    """(axis, unit) to chunk along, or None when unchunkable.  ``unit`` is
    the granule chunk boundaries respect so that every chunk stays
    divisible by the destination sharding on that axis (1 for unsharded
    axes).  Preference: an axis with at least ``want`` granules, a
    destination-unsharded axis over a sharded one, then the most
    granules."""
    best = None
    for i, n in enumerate(shape):
        e = _spec_entry(dst_spec, i)
        unit = 1 if e is None else _axis_product(e, mesh)
        granules = n // unit
        if granules <= 1:
            continue
        key = (granules >= want, e is None, granules)
        if best is None or key > best[0]:
            best = (key, i, unit)
    return (best[1], best[2]) if best else None


def _chunk_spans(n: int, unit: int, want: int) -> List[Tuple[int, int]]:
    """Split [0, n) into at most ``want`` spans with boundaries at
    multiples of ``unit`` (numpy's ``array_split`` over the granules)."""
    granules = n // unit
    k = max(1, min(want, granules))
    sizes = [len(part) for part in np.array_split(np.arange(granules), k)]
    spans, start = [], 0
    for s in sizes:
        stop = start + s * unit
        spans.append((start, stop))
        start = stop
    spans[-1] = (spans[-1][0], n)      # absorb any non-granular tail
    return spans


def _src_route(val, spec: P, dst_mesh: Mesh, dst_ids) -> str:
    """"noop", "device" or "host" for an array leaf."""
    if isinstance(val, ShardedTensor):
        if val.partial:
            raise ValueError(f"a partial ShardedTensor (over {val.partial}) "
                             f"cannot be resharded; complete it first")
        if _same_layout(val, spec, dst_mesh):
            return "noop"
        return "device" if mesh_device_ids(val.mesh) == dst_ids else "host"
    if isinstance(val, torch.Tensor) and dst_mesh.size == 1 \
            and val.device.type != "meta" \
            and dst_mesh.device_type in (None, val.device.type):
        return "noop"   # a plain tensor is the one rank's whole block
    return "host"       # host values (and stand-ins of stored ones) stage in


def plan_reshard(tree, dst_mesh: Mesh, dst_specs=None, *,
                 max_transient_bytes: Optional[int] = DEFAULT_TRANSIENT_BYTES,
                 slice_map: Optional[Dict[str, Sequence[int]]] = None
                 ) -> ReshardPlan:
    """Plan redistributing ``tree`` onto ``dst_mesh`` laid out per
    ``dst_specs`` (``_resolve_spec``'s forms, ``fit_spec``-degraded).
    ``max_transient_bytes`` caps each step's transit (two copies of the
    data in flight); None plans one unbounded step of whole leaves.
    ``slice_map`` (axis -> slice index per position) declares the slice
    topology for the DCN accounting."""
    from ..distributed import topology as topo

    dst_ids = mesh_device_ids(dst_mesh)
    slice_map = slice_map or {}
    dcn_axes = {a for a in dst_mesh.axis_names
                if topo.mesh_spans_slices(dst_mesh, a, slice_map.get(a))}

    flat, _ = path_leaves(tree)
    cap = max_transient_bytes
    leaf_plans: List[LeafPlan] = []
    for path, val in flat:
        if not _is_array(val):
            # Python scalars and opaque leaves ride along untouched
            leaf_plans.append(LeafPlan(
                path=path, shape=(), dtype=None, dst_spec=P(),
                route="noop", chunk_axis=None, chunks=[(0, 0)], nbytes=0,
                transient_bytes=0))
            continue
        shape, dtype, itemsize = _leaf_meta(val)
        nbytes = int(np.prod(shape, dtype=np.int64)) * itemsize \
            if shape else itemsize
        spec = fit_spec(_resolve_spec(dst_specs, path, val), dst_mesh, shape)
        route = _src_route(val, spec, dst_mesh, dst_ids)
        if route == "noop":
            leaf_plans.append(LeafPlan(
                path=path, shape=shape, dtype=dtype, dst_spec=spec,
                route="noop", chunk_axis=None, chunks=[(0, 0)],
                nbytes=nbytes, transient_bytes=0))
            continue

        chunk_axis, chunks = None, [(0, shape[0] if shape else 1)]
        transit = 2 * nbytes
        if cap is not None and transit > cap and shape:
            want = math.ceil(transit / cap)
            picked = _choose_chunk_axis(shape, spec, dst_mesh, want)
            if picked is not None:
                chunk_axis, unit = picked
                chunks = _chunk_spans(shape[chunk_axis], unit, want)
                row = nbytes // shape[chunk_axis]
                transit = 2 * max((b - a) for a, b in chunks) * row
            # an unchunkable leaf: its step carries the overrun
        dcn = bool(dcn_axes) and any(
            set(_entry_axes(e)) & dcn_axes for e in tuple(spec)
            if e is not None)
        leaf_plans.append(LeafPlan(
            path=path, shape=shape, dtype=dtype, dst_spec=spec,
            route=route, chunk_axis=chunk_axis, chunks=chunks,
            nbytes=nbytes, transient_bytes=transit, dcn=dcn))

    # bucket the moved leaves into steps by the overlap engine's rule: the
    # cap splits, never reorders; an over-cap leaf gets its own step
    moved = [lp for lp in leaf_plans if lp.moved]
    by_path = {lp.path: lp for lp in moved}
    if cap is None:
        groups = [[lp.path for lp in moved]] if moved else []
    else:
        groups = split_by_bytes([lp.path for lp in moved],
                                lambda p: by_path[p].transient_bytes, cap)
    steps = [ReshardStep(
        leaves=[by_path[p] for p in g],
        transient_bytes=sum(by_path[p].transient_bytes for p in g))
        for g in groups]
    return ReshardPlan(dst_mesh, steps, leaf_plans, cap)


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), dtype)).dtype


def _dst_device(val, dst_mesh: Mesh, device) -> torch.device:
    """Where a destination block goes: ``device`` when given, else the
    mesh's device type, else the source tensor's device, else the current
    card (the CPU only when the caller asks for it)."""
    if device is not None:
        return torch.device(device)
    if dst_mesh.device_type == "cpu":
        return torch.device("cpu")
    if dst_mesh.device_type is None:
        if isinstance(val, ShardedTensor):
            return val.local.device
        if isinstance(val, torch.Tensor):
            return val.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device for the destination blocks: pass device='cpu' "
            "or build the mesh with device_type='cpu'")
    return torch.device("cuda", torch.cuda.current_device())


def _chunk_box(lp: LeafPlan, a: int, b: int) -> Tuple[slice, ...]:
    return tuple(slice(a, b) if i == lp.chunk_axis else slice(0, n)
                 for i, n in enumerate(lp.shape))


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def _assemble(lp: LeafPlan, val, box: Tuple[slice, ...]) -> torch.Tensor:
    """The global values of ``box`` on this rank (every rank of the live
    group calls it for a distributed source)."""
    if not isinstance(val, ShardedTensor) or val.mesh.size == 1:
        src = val.local if isinstance(val, ShardedTensor) else val
        if isinstance(src, np.ndarray):
            src = torch.from_numpy(np.ascontiguousarray(src))
        return src[box] if box else src
    import torch.distributed as dist

    from . import compat

    mesh = val.mesh
    rank = mesh.rank
    buf = torch.zeros(tuple(s.stop - s.start for s in box),
                      dtype=val.dtype, device=val.local.device)
    mine = block_slices(val.spec, val.shape, mesh, rank)
    part = _intersect(mine, box)
    if lp.route == "device":
        # every rank adds its block along the source axes' lines
        if part is not None:
            buf[_relative(part, box)] = val.local[_relative(part, mine)]
        raw = _bytes_of(buf)
        for a in sorted({a for e in tuple(val.spec) for a in _entry_axes(e)
                         if mesh.shape.get(a, 1) > 1},
                        key=mesh.axis_names.index):
            raw = compat.all_reduce_raw(raw, a, mesh)
        return raw.view(val.dtype).reshape(buf.shape)
    # host route: the ranks differ, so the live default group (which holds
    # both meshes' ranks) sums, and only each block's lowest holder adds
    if part is not None and _is_owner(val.spec, mesh, rank):
        buf[_relative(part, box)] = val.local[_relative(part, mine)]
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.all_reduce(_bytes_of(buf))
    return buf


class _Staging:
    """The pinned host buffer host-route chunks pass through on their way
    to a CUDA destination: one per execution, grown to the largest chunk
    (a pinned allocation costs more than its copy).  ``bytes`` counts what
    it staged, whatever the destination."""

    def __init__(self):
        self.buf: Optional[torch.Tensor] = None
        self.bytes = 0

    def __call__(self, piece: torch.Tensor, dev: torch.device
                 ) -> torch.Tensor:
        n = piece.numel() * piece.element_size()
        self.bytes += n
        if dev.type != "cuda":
            return piece.to(dev)
        if self.buf is None or self.buf.numel() < n:
            self.buf = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        host = self.buf[:n].view(piece.dtype).view(piece.shape)
        host.copy_(piece)
        return host.to(dev)


def _place(lp: LeafPlan, local: torch.Tensor, dst_mesh: Mesh):
    """A destination block in the callers' form."""
    if dst_mesh.size == 1:
        return local
    return ShardedTensor(local, lp.shape, lp.dst_spec, dst_mesh)


def _execute_leaf(lp: LeafPlan, val, dst_mesh: Mesh, rank, device,
                  staging: _Staging, transform=None):
    """One leaf's destination block.  ``transform(piece, chunk_index, dev,
    staging)`` replaces a host chunk's staging: it returns the chunk's
    values on ``dev`` (the codec's packed route)."""
    if not lp.moved:
        if isinstance(val, ShardedTensor) and dst_mesh.live \
                and val.mesh is not dst_mesh:
            return ShardedTensor(val.local, val.shape, lp.dst_spec,
                                 dst_mesh, val.partial)
        return val
    if rank is None and dst_mesh.size == 1:
        rank = 0
    dev = _dst_device(val, dst_mesh, device)
    mine = None if rank is None else block_slices(
        lp.dst_spec, lp.shape, dst_mesh, rank)
    dst = None if mine is None else torch.empty(
        tuple(s.stop - s.start for s in mine), dtype=_torch_dtype(lp.dtype),
        device=dev)
    for ci, (a, b) in enumerate(lp.chunks if lp.shape else [(0, 1)]):
        box = _chunk_box(lp, a, b) if lp.shape else ()
        piece = _assemble(lp, val, box)
        if transform is not None:
            piece = transform(piece, ci, dev, staging)
        if dst is None:
            continue
        if not lp.shape:
            dst.copy_(piece.to(dst.dtype).reshape(()))
            continue
        part = _intersect(mine, box)
        if part is None:
            continue
        piece = piece[_relative(part, box)]
        if lp.route == "host" and transform is None:
            piece = staging(piece, dev)
        dst[_relative(part, mine)] = piece.to(dev, dst.dtype)
    return None if dst is None else _place(lp, dst, dst_mesh)


def bind_mesh(tree, mesh: Mesh):
    """Move every ``ShardedTensor`` block of ``tree`` onto ``mesh`` (the
    live mesh of the same shape and axis names that a plan executed with
    ``rank=`` was made for)."""
    flat, treedef = path_leaves(tree)
    out = []
    for _, v in flat:
        if isinstance(v, ShardedTensor):
            if tuple(v.mesh.shape.items()) != tuple(mesh.shape.items()):
                raise ValueError(f"a block of {v.mesh} cannot move onto "
                                 f"{mesh}")
            v = ShardedTensor(v.local, v.shape, v.spec, mesh, v.partial)
        out.append(v)
    return unflatten(treedef, out)


# ---------------------------------------------------------------------------
# coded execution: host-route float leaves as block-scaled payloads
# ---------------------------------------------------------------------------


def _leaf_codec_applies(lp: LeafPlan) -> bool:
    """The codec streams host-route float leaves only: a device-route step
    is a live relayout on the same ranks (no slow wire to save), and
    integer leaves have no block-scaled form."""
    return (lp.moved and lp.route == "host" and lp.dtype is not None
            and _torch_dtype(lp.dtype).is_floating_point)


def execute_encoded(plan: ReshardPlan, tree, codec, *, corrupt=None,
                    rank: Optional[int] = None, device=None):
    """Execute ``plan`` with host-route float leaves streamed as
    block-scaled packed payloads (``parallel/codec.py``, round to nearest
    on the host): each chunk is encoded on the host, its PACKED int8 bytes
    pass through the pinned staging buffer to the destination device, and
    ``decode_jit(out_sharding=device)`` decodes them there, so a coded
    leaf stages ``plan_wire_bytes``' wire bytes, not its raw ones
    (``plan.telemetry["last_staged_bytes"]``).  Lossy by construction,
    the error bounded by absmax/qmax per block; the decoded values equal a
    CPU decode of the same bytes bit for bit.  Device-route, noop and
    integer leaves take the bit-exact path; ``codec.weight_profile ==
    "none"`` is ``plan.execute`` exactly.  With ``codec.checksum`` every
    packed chunk is verified before it is staged (``ChecksumError``);
    ``corrupt(packed, path, chunk) -> packed`` is the fault harness's
    wire-corruption hook, applied between encode and verification."""
    from .codec import decode_jit, encode_rows_host, verify_rows_host

    rp = codec.resolve("weight")

    def leaf_fn(lp, val, dst_mesh, r, dev, staging):
        if rp is None or not _leaf_codec_applies(lp):
            return _execute_leaf(lp, val, dst_mesh, r, dev, staging)
        profile = rp[0]

        def coded(piece, ci, dst_dev, stage):
            packed = encode_rows_host(piece.reshape(1, -1), codec, profile)
            if corrupt is not None:
                packed = corrupt(packed, lp.path, ci)
            if codec.checksum:
                verify_rows_host(packed, where=f"{lp.path}[{ci}]")
            dec = decode_jit(tuple(piece.shape), _torch_dtype(lp.dtype),
                             codec, profile, out_sharding=dst_dev)
            return dec(stage(torch.from_numpy(packed), dst_dev))

        return _execute_leaf(lp, val, dst_mesh, r, dev, staging,
                             transform=coded)

    return plan.execute(tree, rank=rank, device=device, _leaf_fn=leaf_fn)


def plan_wire_bytes(plan: ReshardPlan, codec=None) -> Dict[str, Any]:
    """Bytes on the wire of a plan's moved leaves: a codec'd host-route
    float leaf moves its packed width per chunk (payload and scale
    sidecar, ``packed_width``), every other moved leaf its raw bytes.
    Plan arithmetic only."""
    from .codec import packed_width

    rp = codec.resolve("weight") if codec is not None else None
    raw = wire = 0
    for lp in plan.leaf_plans:
        if not lp.moved:
            continue
        raw += lp.nbytes
        if rp is None or not _leaf_codec_applies(lp):
            wire += lp.nbytes
            continue
        itemsize = torch.empty((), dtype=_torch_dtype(lp.dtype)) \
            .element_size()
        if lp.chunk_axis is None:
            wire += packed_width(lp.nbytes // itemsize, codec.block,
                                 codec.checksum)
        else:
            per_row = (lp.nbytes // itemsize) // lp.shape[lp.chunk_axis]
            wire += sum(packed_width((b - a) * per_row, codec.block,
                                     codec.checksum)
                        for a, b in lp.chunks)
    return {"raw_bytes": int(raw), "wire_bytes": int(wire),
            "ratio": (raw / wire) if wire else 1.0}


def reshard(tree, dst_mesh: Mesh, dst_specs=None, *,
            max_transient_bytes: Optional[int] = DEFAULT_TRANSIENT_BYTES,
            slice_map: Optional[Dict[str, Sequence[int]]] = None):
    """Plan and execute in one call: (new tree, plan)."""
    plan = plan_reshard(tree, dst_mesh, dst_specs,
                        max_transient_bytes=max_transient_bytes,
                        slice_map=slice_map)
    return plan.execute(tree), plan


def check_reshard_budget(plan: ReshardPlan, tree, **kwargs):
    """The Graph Doctor's MEM001 pricing of a plan step (the JAX
    ``check_reshard_budget``) needs the graph doctor, which the port does
    not have yet (its Concurrency Doctor is in ``analysis/``)."""
    raise NotImplementedError(
        "check_reshard_budget is the Graph Doctor's MEM001 pass, ROADMAP "
        "queue A7")


__all__ = ["DEFAULT_TRANSIENT_BYTES", "LeafPlan", "ReshardPlan",
           "ReshardStep", "bind_mesh", "block_slices",
           "check_reshard_budget", "execute_encoded", "fit_spec",
           "path_leaves", "plan_reshard", "plan_wire_bytes", "reshard",
           "unflatten"]
