"""Graph Doctor core: the capture and the pass framework.

Port of ``paddle_tpu/analysis/core.py``.  ``check(fn, *args)`` captures
``fn`` once as an FX graph on fake tensors (``capture``: ``make_fx`` in
fake mode, nothing allocated, no kernel launched; DESIGN.md says why), hands
it to every registered ``AnalysisPass`` and returns a typed findings
``Report``.  The graph is the joint program one call runs: the forward, the
backward ``torch.autograd.grad`` takes and the update, with in-place ops
kept, each node stamped with the Python frames that issued it
(``node_where``).  A capture that fails is the error finding MEM000.

The walkers the passes share read the graph's nodes (``call_nodes``), the
tensors a node produces and reads (``node_tensors``, ``input_tensors``),
their storages (``storage_key``) and what an op writes in place
(``written_inputs``); ``static_peak`` is the live device bytes over the
graph in execution order with the caller-held inputs counted, the port's
``compiled.memory_analysis()``.

Above one rank (the counterpart of JAX tracing a ``shard_map`` body over a
mesh): ``fake_ranks(world_size, rank)`` starts a ``"fake"`` default
process group (``FakeStore``: no peer, every collective returns at once)
and always destroys it; ``fake_mesh`` builds the port's ``Mesh`` over
``init_device_mesh`` on it.  A capture then records this rank's ``c10d``
collectives as nodes, and ``capture`` annotates each with a
``Collective`` (``collectives``): its kind, its group's global ranks, the
mesh axis the group belongs to, the peer of a send or a recv, and the
payload's bytes and dtype.  One rank's capture shows only that rank's
collectives: a check that needs the whole program captures every rank of
a group (``capture_ranks``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import itertools
import math
import operator
import os
import sys
import time
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, \
    Tuple

import torch
import torch.utils._pytree as pytree

from .exemptions import apply_exemptions
from .findings import Finding, Report

_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__)) + os.sep
_STDLIB_DIR = os.path.dirname(os.path.abspath(os.__file__)) + os.sep
_THIS = os.path.abspath(__file__)
#: the CUDA caching allocator's block size: every allocation rounds up to it
ALLOC_BLOCK = 512


# ---------------------------------------------------------------- provenance

def _user_frames(frame) -> Tuple[Tuple[str, int, str, str], ...]:
    """(file, line, function, qualified name) of the frames from ``frame``
    outwards, innermost first, outside PyTorch, the standard library and
    this module."""
    out = []
    while frame is not None:
        fname = frame.f_code.co_filename
        if not (fname.startswith(_TORCH_DIR) or fname.startswith(_STDLIB_DIR)
                or fname == _THIS or fname.startswith("<")):
            code = frame.f_code
            out.append((fname, frame.f_lineno, code.co_name,
                        getattr(code, "co_qualname", code.co_name)))
        frame = frame.f_back
    return tuple(out)


def _provenance_mode(deaths: Dict[int, Any], finalizers: List[Any]):
    """A dispatch mode pushed inside the traced function: each op goes on
    to the proxy mode, which records its node(s); the new nodes get the
    op's user frames (``meta["pt_frames"]``).  It also watches the tensors
    the op hands back to the Python code: when the code drops the last
    reference to one, ``deaths`` gets the graph's last node for its
    storage (the eager lifetime, which a local variable may stretch past
    the tensor's last use in the graph)."""
    from torch.fx.experimental.proxy_tensor import get_proxy_mode
    from torch.utils._python_dispatch import TorchDispatchMode

    def died(key, graph):
        deaths[key] = graph._root.prev

    class _Provenance(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            mode = get_proxy_mode()
            graph = mode.tracer.graph if mode is not None else None
            last = graph._root.prev if graph is not None else None
            out = func(*args, **(kwargs or {}))
            if graph is not None and graph._root.prev is not last:
                frames = _user_frames(sys._getframe(1))
                node = graph._root.prev
                while node is not last and node is not graph._root:
                    node.meta.setdefault("pt_frames", frames)
                    node = node.prev
                for t in pytree.tree_leaves(out):
                    if isinstance(t, torch.Tensor):
                        finalizers.append(weakref.finalize(
                            t, died, storage_key(t), graph))
            return out

    return _Provenance()


def node_where(node, skip: Sequence[str] = ()
               ) -> Tuple[Optional[str], Dict[str, Any]]:
    """(where-string, data) of a node from its frames, for Finding fields
    (mirror of ``format_where``): ``data["stack_functions"]`` is the whole
    user stack, innermost first; exemptions match on it.  The where is the
    innermost frame whose file contains none of ``skip`` (the collective
    transport: the frame that asked for the collective)."""
    frames = node.meta.get("pt_frames") or ()
    if not frames:
        return None, {}
    at = next((f for f in frames if not any(k in f[0] for k in skip)),
              frames[0])
    fname, line, func = at[:3]
    short = os.path.join(*fname.split(os.sep)[-2:]) if os.sep in fname \
        else fname
    return f"{short}:{line} ({func})", {
        "function": func, "file": fname, "line": line,
        "stack_functions": tuple(f[2] for f in frames)}


def fn_where(fn) -> Tuple[Optional[str], Dict[str, Any]]:
    """(where, data) naming the entry point itself: its source file, its
    first line and its name (argument-level findings have no op)."""
    inner = inspect.unwrap(fn)
    try:
        fname = inspect.getsourcefile(inner) or ""
        line = inspect.getsourcelines(inner)[1]
    except (TypeError, OSError):
        return None, {}
    name = getattr(inner, "__name__", repr(inner))
    short = os.path.join(*fname.split(os.sep)[-2:]) if os.sep in fname \
        else fname
    return f"{short}:{line} ({name})", {
        "function": name, "file": fname, "line": line,
        "stack_functions": (name,)}


# ------------------------------------------------------------------ capture

def resolve_device(device) -> torch.device:
    """The capture device: ``cuda`` unless the caller passes another; a
    ``cuda`` capture without a card raises before anything is traced."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the Graph Doctor captures on the card by default "
                           "and no CUDA device is available: pass "
                           "device='cpu'")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no capture on {dev}")
    return dev


@dataclasses.dataclass
class Placeholder:
    node: Any
    path: str               # key path into (args, kwargs)
    label: str              # "arg0", "kwarg 'kv_scales'"
    argnum: Optional[int]   # top-level positional index, None for kwargs
    host: bool              # host memory kind (MEM002)
    #: the global bytes of a ``ShardedTensor`` argument (this rank's
    #: block is the placeholder), None for a plain tensor
    global_bytes: Optional[int] = None


@dataclasses.dataclass
class Captured:
    """One captured call: the graph, its inputs with their argument paths,
    its tensor outputs, the capture device and the wall seconds taken."""

    gm: Any
    placeholders: List[Placeholder]
    outputs: List[Any]                     # fake tensors the call returns
    device: torch.device
    seconds: float
    #: storage -> the graph's last node when the Python code dropped a
    #: tensor on it (its eager lifetime)
    deaths: Dict[int, Any] = dataclasses.field(default_factory=dict)
    #: this rank's global rank and the world size (0 and 1 without a
    #: process group)
    rank: int = 0
    world_size: int = 1
    #: the collectives in program order (``annotate_collectives``)
    collectives: List["Collective"] = dataclasses.field(
        default_factory=list)

    @property
    def nodes(self) -> List[Any]:
        return list(self.gm.graph.nodes)


def _label(path) -> Tuple[str, Optional[int]]:
    """("arg<i>" or "kwarg '<k>'", positional index) of a key path into
    (args, kwargs)."""
    first = path[0].idx if path else None
    if first == 0 and len(path) > 1:
        return f"arg{path[1].idx}", path[1].idx
    if first == 1 and len(path) > 1:
        return f"kwarg {path[1].key!r}", None
    return "args", None


def _is_host_leaf(keystr: str, t: torch.Tensor, dev: torch.device) -> bool:
    """The host memory kind: a CPU tensor on a card capture, or (one
    memory on a CPU capture) a leaf of the memory engine's host-resident
    state, which lives under ``__offload__``."""
    if dev.type == "cuda":
        return t.device.type == "cpu"
    return "__offload__" in keystr


def capture(fn: Callable, args: Sequence = (), kwargs: Optional[Dict] = None,
            device=None, mesh=None) -> Captured:
    """``make_fx`` of ``fn(*args, **kwargs)`` on fake tensors.  Tensor
    leaves become fakes of themselves (``FakeTensorMode.from_tensor``:
    nothing allocated, aliasing kept) and the graph's placeholders (a
    ``ShardedTensor``'s local block too, rewrapped for the call); every
    other leaf (numpy arrays, Python scalars, configs) is a constant of the
    trace, read as the eager call reads it (a numpy batch becomes a tensor
    where the step converts it).  Its collective nodes are annotated while
    the process group is alive (``annotate_collectives``; ``mesh`` names
    their axes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    from ..parallel.specs import ShardedTensor

    dev = resolve_device(device)
    kwargs = dict(kwargs or {})
    with_path, spec = pytree.tree_flatten_with_path((tuple(args), kwargs))
    leaves = [v for _, v in with_path]
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    tensor_pos, fakes, meta, blocks = [], [], [], {}
    for i, (path, v) in enumerate(with_path):
        if isinstance(v, ShardedTensor):
            # a block at rest: its local tensor is the input, rewrapped
            # inside the trace
            blocks[i] = v
            v = v.local
        if not isinstance(v, torch.Tensor):
            continue
        v = fake_mode.from_tensor(v)
        tensor_pos.append(i)
        fakes.append(v)
        key = pytree.keystr(path)
        label, argnum = _label(path)
        whole = (math.prod(blocks[i].shape) * v.element_size()
                 if i in blocks else None)
        meta.append((key, label, argnum, _is_host_leaf(key, v, dev), whole))
    deaths: Dict[int, Any] = {}
    finalizers: List[Any] = []

    def flat_fn(*ts):
        full = list(leaves)
        for i, t in zip(tensor_pos, ts):
            full[i] = blocks[i].with_local(t, blocks[i].partial) \
                if i in blocks else t
        a, kw = pytree.tree_unflatten(full, spec)
        with _provenance_mode(deaths, finalizers):
            out = fn(*a, **kw)
        return [x for x in pytree.tree_leaves(out)
                if isinstance(x, torch.Tensor)]

    t0 = time.perf_counter()
    try:
        gm = make_fx(flat_fn, tracing_mode="fake",
                     _allow_non_fake_inputs=True)(*fakes)
    finally:
        for f in finalizers:        # no callback once the trace is over
            f.detach()
    seconds = time.perf_counter() - t0
    phs = [n for n in gm.graph.nodes if n.op == "placeholder"]
    placeholders = [Placeholder(n, *m) for n, m in zip(phs, meta)]
    out_node = next(n for n in gm.graph.nodes if n.op == "output")
    outs = [n.meta.get("val") for n in pytree.tree_leaves(out_node.args)
            if hasattr(n, "meta")]
    cap = Captured(gm, placeholders, [o for o in outs
                                      if isinstance(o, torch.Tensor)],
                   dev, seconds, deaths)
    annotate_collectives(cap, mesh)
    return cap


# ------------------------------------------------------------------ walkers

def call_nodes(cap: Captured) -> Iterator[Any]:
    for n in cap.gm.graph.nodes:
        if n.op == "call_function":
            yield n


def _tensors(val) -> List[torch.Tensor]:
    return [x for x in pytree.tree_leaves(val) if isinstance(x, torch.Tensor)]


def node_tensors(node) -> List[torch.Tensor]:
    """The tensors a node produces (its ``meta["val"]``)."""
    return _tensors(node.meta.get("val"))


def input_tensors(node) -> List[torch.Tensor]:
    """The tensors a node reads (its input nodes' values)."""
    out = []
    for n in node.all_input_nodes:
        out.extend(node_tensors(n))
    return out


def arg_values(node):
    """The node's positional arguments with nodes replaced by their
    values (for the kernels' scratch functions)."""
    def val(a):
        if hasattr(a, "meta") and hasattr(a, "op"):
            return a.meta.get("val")
        if isinstance(a, (list, tuple)):
            return type(a)(val(x) for x in a)
        return a
    return [val(a) for a in node.args]


def storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def storage_bytes(t: torch.Tensor) -> int:
    return int(t.untyped_storage().nbytes())


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def written_inputs(node) -> List[torch.Tensor]:
    """The input tensors the node's op writes in place (the schema's
    ``Tensor(a!)`` arguments)."""
    target = node.target
    if not isinstance(target, torch._ops.OpOverload):
        return []
    out = []
    for i, arg in enumerate(target._schema.arguments):
        ai = arg.alias_info
        if ai is None or not ai.is_write:
            continue
        a = node.args[i] if i < len(node.args) else node.kwargs.get(arg.name)
        if a is None:
            continue
        for n in (a if isinstance(a, (list, tuple)) else (a,)):
            if hasattr(n, "meta"):
                out.extend(node_tensors(n))
    return out


def _rounded(n: int, dev: torch.device) -> int:
    if dev.type != "cuda" or n == 0:
        return n
    return -(-n // ALLOC_BLOCK) * ALLOC_BLOCK


def static_peak(cap: Captured, donated: Sequence[str] = ()
                ) -> Dict[str, int]:
    """The live device bytes over the graph in execution order:
    ``argument_bytes`` (every input storage, held by the caller, and the
    trace's constants), ``output_bytes`` (new storages the call returns),
    ``peak_bytes`` the most live at once (a new storage counts from the
    node that makes it to the last node that reads any tensor on it, or
    to the end when returned; a kernel node adds its scratch, the
    ``ops/_registry.SCRATCH`` of its operator, while it runs).  On a card
    capture only ``cuda`` storages count, each rounded to the allocator's
    512-byte blocks; on a CPU capture every storage counts but the host
    memory kind's inputs (``Placeholder.host``).  ``donated``
    names argument labels (``"arg0"``) whose storages the caller is taken
    to hand over: they are freed after their last use, as a donated
    buffer is (the peak without DON001's double residency)."""
    from ..ops import _registry

    dev = cap.device
    nodes = cap.nodes

    def counts(t):
        return dev.type != "cuda" or t.device.type == "cuda"

    size: Dict[int, int] = {}
    start: set = set()
    pinned: set = set()
    born: Dict[int, List[int]] = {}
    last: Dict[int, int] = {}
    handed = {storage_key(t) for ph in cap.placeholders
              if ph.label in donated for t in node_tensors(ph.node)}
    host = {storage_key(t) for ph in cap.placeholders if ph.host
            for t in node_tensors(ph.node)}
    for i, n in enumerate(nodes):
        if n.op in ("placeholder", "get_attr"):
            for t in node_tensors(n):
                if counts(t) and storage_key(t) not in host:
                    k = storage_key(t)
                    size.setdefault(k, _rounded(storage_bytes(t), dev))
                    start.add(k)
                    if k not in handed:
                        pinned.add(k)
            continue
        if n.op == "output":
            for m in n.all_input_nodes:
                for t in node_tensors(m):
                    pinned.add(storage_key(t))
            continue
        for t in input_tensors(n):
            last[storage_key(t)] = i
        for t in node_tensors(n):
            if not counts(t):
                continue
            k = storage_key(t)
            if k not in size:
                size[k] = _rounded(storage_bytes(t), dev)
                born.setdefault(i, []).append(k)
            last[k] = max(last.get(k, i), i)
    index = {n: i for i, n in enumerate(nodes)}
    end = len(nodes) - 1
    for k in handed:
        last.setdefault(k, 0)
    for k in (k for ks in born.values() for k in ks):
        # a storage lives to its last use in the graph or to the last
        # node before the Python code dropped it, whichever is later; a
        # storage never dropped during the trace lives to the end
        d = cap.deaths.get(k)
        last[k] = max(last.get(k, 0), index.get(d, end) if d is not None
                      else end)
    frees: Dict[int, List[int]] = {}
    for k, i in last.items():
        if k in size and k not in pinned:
            frees.setdefault(i, []).append(k)
    live = sum(size[k] for k in start)
    arg_bytes, peak, peak_at = live, live, None
    for i, n in enumerate(nodes):
        if n.op != "call_function":
            continue
        live += sum(size[k] for k in born.get(i, ()))
        scratch = 0
        name = _registry.kernel_op(n.target)
        if name in _registry.SCRATCH:
            scratch = _rounded(int(_registry.SCRATCH[name](*arg_values(n))),
                               dev)
        if live + scratch > peak:
            peak, peak_at = live + scratch, i
        live -= sum(size[k] for k in frees.get(i, ()))
    out_bytes = sum(size[k] for k in pinned
                    if k in size and k not in start and k not in host)
    return {"peak_bytes": int(peak), "argument_bytes": int(arg_bytes),
            "output_bytes": int(out_bytes), "peak_node": peak_at}


def collective_kind(node) -> Optional[str]:
    """The collective class of a ``c10d`` / ``_c10d_functional`` node (the
    kinds of JAX's HLO scan), or None."""
    target = node.target
    if not isinstance(target, torch._ops.OpOverload):
        return None
    ns, _, name = target._schema.name.partition("::")
    if ns not in ("c10d", "_c10d_functional", "c10d_functional"):
        return None
    name = name.strip("_")
    for key, kind in (("all_to_all", "alltoall"), ("alltoall", "alltoall"),
                      ("reduce_scatter", "reducescatter"),
                      ("allgather", "allgather"), ("all_gather", "allgather"),
                      ("allreduce", "allreduce"), ("all_reduce", "allreduce"),
                      ("send", "collectivepermute"),
                      ("recv", "collectivepermute"),
                      ("broadcast", "broadcast")):
        if key in name:
            return kind
    return None if name in ("wait_tensor", "barrier") else name


# ------------------------------------------------------- above one rank

@contextlib.contextmanager
def fake_ranks(world_size: int, rank: int):
    """A ``"fake"`` default process group at ``(world_size, rank)`` for the
    body of the ``with``: collectives issue and return at once, nothing
    moves.  The group is destroyed on the way out, on error too, so no
    group outlives the capture.  Refuses to start over a live group (the
    default group is global per process)."""
    import torch.distributed as dist
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_ranks: a process group is already live in "
                           "this process; a capture above one rank needs "
                           "its own (check_ranks isolates one in a child "
                           "process)")
    dist.init_process_group("fake", store=FakeStore(), rank=int(rank),
                            world_size=int(world_size))
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device_type: str = "cpu"):
    """The port's live ``Mesh`` over ``init_device_mesh`` on the fake group
    of ``fake_ranks`` (``parallel.specs.init_mesh`` keeps refusing any
    backend but gloo or NCCL for real runs)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..parallel.specs import Mesh

    if not dist.is_initialized() or dist.get_backend() != "fake":
        raise RuntimeError("fake_mesh needs the group of fake_ranks")
    dm = init_device_mesh(device_type, tuple(int(n) for n in shape),
                          mesh_dim_names=tuple(axis_names))
    return Mesh(shape, axis_names, device_mesh=dm, device_type=device_type)


@dataclasses.dataclass
class Collective:
    """One collective node of a rank's capture: its kind (the kinds of
    ``collective_kind``; a send and a recv are ``collectivepermute``), the
    op's name, the global ranks of its group (ascending), the mesh axes
    the group spans (``"+"``-joined; None when no mesh was given or the
    group is no line of it), the peer's global rank of a send or a recv,
    the payload (the input of a gather, a scatter or an exchange, the
    buffer of a reduction, a send or a recv) in bytes and its dtype, and
    the index of the permute a send or a recv belongs to (the sends and
    recvs of one ``batch_isend_irecv`` share it)."""

    node: Any
    kind: str
    op: str
    group: Tuple[int, ...]
    axis: Optional[str]
    peer: Optional[int]
    nbytes: int
    dtype: str
    shape: Tuple[int, ...]
    permute: Optional[int] = None

    @property
    def is_p2p(self) -> bool:
        return self.op in ("send", "recv")


def _group_ranks(gm, arg) -> Optional[Tuple[int, ...]]:
    import torch.distributed as dist

    obj = getattr(gm, arg.target, None) if getattr(arg, "op", None) \
        == "get_attr" else arg
    if obj is None:
        return None
    try:
        pg = dist.ProcessGroup.unbox(obj) \
            if isinstance(obj, torch.ScriptObject) else obj
        return tuple(sorted(dist.get_process_group_ranks(pg)))
    except Exception:  # noqa: BLE001 - not a process group
        return None


def _axes_of_group(mesh, ranks: Tuple[int, ...], me: int,
                   peer: Optional[int]) -> Optional[str]:
    """The mesh axes whose sub-grid through ``me`` holds the group (for a
    send or a recv: the axes where ``me`` and ``peer`` differ)."""
    if mesh is None:
        return None
    import numpy as np

    names = mesh.axis_names
    coords = dict(zip(names, np.unravel_index(me, mesh.devices.shape)))
    if peer is not None:
        pc = dict(zip(names, np.unravel_index(peer, mesh.devices.shape)))
        diff = [a for a in names if pc[a] != coords[a]]
        return "+".join(diff) if diff else None
    want = set(ranks)
    for n in range(1, len(names) + 1):
        for axes in itertools.combinations(names, n):
            sub = mesh.devices[tuple(slice(None) if a in axes
                                     else int(coords[a]) for a in names)]
            line = {int(r) for r in np.asarray(sub).reshape(-1)}
            if want <= line:
                return "+".join(axes)
    return None


def annotate_collectives(cap: Captured, mesh=None) -> None:
    """Fill ``cap.collectives`` (and each node's ``meta["pt_coll"]``) from
    the capture's ``c10d`` nodes; the process group must be live."""
    import torch.distributed as dist

    live = dist.is_available() and dist.is_initialized()
    cap.rank = dist.get_rank() if live else 0
    cap.world_size = dist.get_world_size() if live else 1
    out: List[Collective] = []
    permute, last_p2p = -1, None
    nodes = cap.nodes
    for i, n in enumerate(nodes):
        kind = collective_kind(n)
        if kind is None or n.op != "call_function":
            continue
        op = n.target._schema.name.partition("::")[2].strip("_")
        group, peer, payload = None, None, None
        for a in n.args:
            if getattr(a, "op", None) == "get_attr":
                group = group or _group_ranks(cap.gm, a)
        ts = [t for a in n.args[:2] for t in _arg_tensors(a)]
        if op in ("allgather_base", "reduce_scatter_base", "alltoall_base",
                  "all_gather_into_tensor", "reduce_scatter_tensor",
                  "all_to_all_single"):
            payload = ts[1:2] if len(ts) > 1 else ts[:1]
        else:
            payload = _arg_tensors(n.args[0]) if n.args else []
        if op in ("send", "recv"):
            kind = "collectivepermute"
            r = next((a for a in n.args[2:] if isinstance(a, int)), None)
            if group is not None and r is not None and r < len(group):
                peer = group[r]
            # the sends and recvs of one batch_isend_irecv sit side by
            # side: only group handles and getitems between them
            between = nodes[last_p2p + 1:i] if last_p2p is not None else ()
            if last_p2p is None or any(
                    m.op == "call_function"
                    and m.target is not operator.getitem for m in between):
                permute += 1
            last_p2p = i
        nbytes = sum(tensor_bytes(t) for t in payload)
        dt = str(payload[0].dtype).rsplit(".", 1)[-1] if payload else ""
        shape = tuple(payload[0].shape) if payload else ()
        c = Collective(node=n, kind=kind, op=op, group=group or (),
                       axis=_axes_of_group(mesh, group or (), cap.rank,
                                           peer) if group else None,
                       peer=peer, nbytes=int(nbytes), dtype=dt, shape=shape,
                       permute=permute if op in ("send", "recv") else None)
        n.meta["pt_coll"] = c
        out.append(c)
    cap.collectives = out


def _arg_tensors(a) -> List[torch.Tensor]:
    if isinstance(a, (list, tuple)):
        return [t for x in a for t in _arg_tensors(x)]
    if hasattr(a, "meta"):
        return node_tensors(a)
    return []


def _capture_each(build, world_size, ranks, device):
    caps: Dict[int, Captured] = {}
    entries = {}
    for r in (range(world_size) if ranks is None else ranks):
        with fake_ranks(world_size, r):
            fn, args, kwargs, mesh = build(r)
            caps[r] = capture(fn, args, kwargs, device, mesh=mesh)
            entries[r] = (fn, args, kwargs, mesh)
    return caps, entries


def capture_ranks(build: Callable, world_size: int, ranks=None,
                  device=None) -> Dict[int, Captured]:
    """Capture one program at every rank of ``ranks`` (default: all of
    ``world_size``): for each, inside ``fake_ranks(world_size, rank)``,
    ``build(rank)`` returns ``(fn, args, kwargs, mesh)`` (built on that
    rank's group: ``fake_mesh`` and the step), and ``fn`` is captured with
    its collectives annotated against ``mesh``."""
    return _capture_each(build, world_size, ranks, device)[0]


def check_ranks(build: Callable, world_size: int, ranks=None,
                device=None, **check_kw) -> Report:
    """``check`` over a program captured at every rank of ``ranks``
    (``capture_ranks``'s ``build``): the report is the first rank's, with
    the other ranks' captures in ``ctx.ranks`` for the collective-order
    checks; its mesh names the axes.  ``options`` may be a function of
    the first rank's ``(fn, args, mesh)`` (a budget that reads the built
    step's layout).

    When a process group is live here (a rank of a running job checking
    its own step, over which ``fake_ranks`` cannot start), the captures
    and the check run in a child process started with ``spawn``, which
    returns the report: the live group stays out of the child.  Then
    ``build`` and the keywords cross the process boundary by pickle: a
    module-level function, or a ``functools.partial`` of one
    (``self_check._llama_build`` and its siblings), not a closure."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        import concurrent.futures
        import multiprocessing

        with concurrent.futures.ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn")) as pool:
            return pool.submit(_check_ranks_here, build, world_size, ranks,
                               device, check_kw).result()
    return _check_ranks_here(build, world_size, ranks, device, check_kw)


def _check_ranks_here(build, world_size, ranks, device, check_kw) -> Report:
    caps, entries = _capture_each(build, world_size, ranks, device)
    first = min(caps)
    fn, args, kwargs, mesh = entries[first]
    if callable(check_kw.get("options")):
        check_kw["options"] = check_kw["options"](fn, args, mesh)
    return check(fn, *args, kwargs=kwargs, device=device, graph=caps[first],
                 mesh=mesh, ranks=caps, **check_kw)


# ------------------------------------------------------------------ context

class AnalysisContext:
    """Everything a pass may ask for about one (fn, args) target, built
    lazily and cached: the captured graph (``graph``), its static peak,
    and the per-pass options."""

    def __init__(self, fn, args, kwargs, target: str = "",
                 declared_dtype=None, options: Optional[Dict] = None,
                 device=None, graph: Optional[Captured] = None, mesh=None,
                 ranks: Optional[Dict[int, Captured]] = None):
        self.fn = fn
        self.args = tuple(args)
        self.kwargs = kwargs or {}
        self.target = target or getattr(fn, "__name__", repr(fn))
        self.declared_dtype = declared_dtype
        self.options = options or {}
        self.device = device
        self._graph = graph
        self._peak = None
        self.mesh = mesh
        #: captures of the same program at other ranks (``capture_ranks``)
        #: for the checks that need the whole group; this rank's is
        #: ``graph``
        self.ranks = dict(ranks or {})

    def opt(self, pass_name: str, key: str, default=None):
        return self.options.get(pass_name, {}).get(key, default)

    @property
    def graph(self) -> Captured:
        if self._graph is None:
            self._graph = capture(self.fn, self.args, self.kwargs,
                                  self.device, mesh=self.mesh)
        return self._graph

    def all_ranks(self) -> Dict[int, Captured]:
        """Every capture of the program: ``ranks`` with this one's."""
        out = dict(self.ranks)
        out.setdefault(self.graph.rank, self.graph)
        return out

    @property
    def peak(self) -> Dict[str, int]:
        if self._peak is None:
            self._peak = static_peak(self.graph)
        return self._peak


# ------------------------------------------------------ pass base + registry

PASS_REGISTRY: Dict[str, type] = {}


def register_pass(cls):
    PASS_REGISTRY[cls.name] = cls
    return cls


class AnalysisPass:
    """A graph pass: ``run(ctx)`` reads ``ctx.graph`` (the capture) and
    returns its findings."""

    name: str = ""
    codes: Tuple[str, ...] = ()

    def run(self, ctx: AnalysisContext) -> List[Finding]:
        raise NotImplementedError

    def finding(self, code, message, severity="error", **kw) -> Finding:
        return Finding(code=code, message=message, severity=severity,
                       pass_name=self.name, **kw)


class SkipPass(Exception):
    """A pass raises this when its preconditions do not hold for the
    target (no declared budget) - recorded on the report, never a pass."""


def resolve_passes(passes=None) -> List[AnalysisPass]:
    """None -> every registered pass; names, classes or instances."""
    import importlib

    from .passes import GRAPH_PASSES

    for mod in GRAPH_PASSES:        # each module registers its pass
        importlib.import_module(f"{__package__}.passes.{mod}")

    if passes is None:
        return [cls() for cls in PASS_REGISTRY.values()]
    out = []
    for p in passes:
        if isinstance(p, str):
            if p not in PASS_REGISTRY:
                raise KeyError(f"unknown pass {p!r}; registered: "
                               f"{sorted(PASS_REGISTRY)}")
            out.append(PASS_REGISTRY[p]())
        elif isinstance(p, type):
            out.append(p())
        else:
            out.append(p)
    return out


def capture_error(ctx: AnalysisContext, err: BaseException) -> Finding:
    """MEM000: the capture failed, so no graph pass can run and the step,
    as captured, does not trace (a gate red, never a skip)."""
    return Finding(
        code="MEM000", pass_name="capture",
        message=(f"{ctx.target}: capture failed, the graph passes and the "
                 f"memory checks are moot: {err!r}")[:600],
        data={"error": repr(err)[:300]})


def check(fn, *args, passes: Optional[Sequence] = None, target: str = "",
          declared_dtype=None, options: Optional[Dict] = None,
          exemptions=None, kwargs: Optional[Dict] = None,
          device=None, graph: Optional[Captured] = None, mesh=None,
          ranks: Optional[Dict[int, Captured]] = None) -> Report:
    """Run the Graph Doctor over one entry point.

    ``fn`` the function to analyse; ``args``/``kwargs`` example arguments
    at the real shapes and dtypes (tensors, numpy arrays or other
    constants); ``passes`` names/instances (None = all registered);
    ``declared_dtype`` the declared compute dtype (None: the lowest
    precision any matmul runs in); ``options`` per-pass knobs,
    ``{"donation": {"persistent": (0,)}}``; ``exemptions`` the table
    (None = the standing ``EXEMPTIONS``, ``()`` = none); ``device`` the
    capture device (``cuda`` unless ``"cpu"`` is passed); ``graph`` a
    ``capture`` of this same call, to reuse instead of capturing again;
    ``mesh`` the live mesh the call runs on (its collectives are named by
    its axes); ``ranks`` captures of the same program at other ranks
    (``capture_ranks``), for the collective-order checks.

    Returns a Report; ``report.ok`` is the gate.  A failed capture is the
    finding MEM000."""
    ctx = AnalysisContext(fn, args, kwargs, target=target,
                          declared_dtype=declared_dtype, options=options,
                          device=device, graph=graph, mesh=mesh, ranks=ranks)
    instances = resolve_passes(passes)
    findings: List[Finding] = []
    skipped: Dict[str, str] = {}
    try:
        ctx.graph
    except Exception as e:  # noqa: BLE001 - gate red, never skip
        active, suppressed = apply_exemptions([capture_error(ctx, e)],
                                              exemptions)
        return Report(target=ctx.target, findings=active,
                      suppressed=suppressed,
                      passes_run=tuple(p.name for p in instances),
                      skipped={p.name: "capture failed" for p in instances})
    for p in instances:
        try:
            findings.extend(p.run(ctx))
        except SkipPass as e:
            skipped[p.name] = str(e)
    active, suppressed = apply_exemptions(findings, exemptions)
    return Report(target=ctx.target, findings=active, suppressed=suppressed,
                  passes_run=tuple(p.name for p in instances),
                  skipped=skipped)


__all__ = ["ALLOC_BLOCK", "AnalysisContext", "AnalysisPass", "Captured",
           "Collective", "annotate_collectives", "capture_ranks",
           "check_ranks",
           "fake_mesh", "fake_ranks",
           "PASS_REGISTRY", "Placeholder", "SkipPass", "arg_values",
           "call_nodes", "capture", "capture_error", "check",
           "collective_kind", "fn_where", "input_tensors", "node_tensors",
           "node_where", "register_pass", "resolve_device",
           "resolve_passes", "static_peak", "storage_bytes", "storage_key",
           "tensor_bytes", "written_inputs"]
