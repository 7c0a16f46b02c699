"""Lock-discipline static analysis of the host-side control plane (the
Concurrency Doctor's static half: RACE001-004).

Port of ``paddle_tpu/analysis/passes/lock_discipline.py``; the pass reads
Python source only, so the port's copy is the JAX package's, line for line
in its analysis, and gives the same findings on the same files.  The
control plane (serving engine tick, fleet and disaggregated routers,
watchdog, store helpers, checkpoint writer) is ordinary threaded Python,
and it has shipped real lock/flag races before (the watchdog's
handler/flag race).  A per-module AST walk that

1. discovers the module's LOCKS — attributes or globals bound to
   ``threading.Lock/RLock/Condition/Semaphore`` constructors, plus any
   ``with``-target whose name looks lock-ish (``*_lock``, ``_cv``,
   ``*_mutex``) — and tracks the held-lock set through ``with`` bodies;
2. infers each field's GUARDING lock from the writes observed under
   locks (a field written under ``self._lock`` anywhere is treated as
   ``_lock``-guarded module-wide — deliberately name-based, so a
   ``CommTask`` flag written under the manager's lock in one method and
   mutated lock-free elsewhere still correlates);
3. reports typed findings:

   - **RACE001** — a guarded field is WRITTEN both under its inferred
     lock and outside any lock (``__init__``-family constructors are
     exempt: construction is single-threaded by definition).
   - **RACE002** — lock-order inversion: a cycle in the inter-lock
     acquisition graph (edges from every held lock to each newly
     acquired one, including locks acquired transitively through
     ``self.helper()`` calls made while holding a lock).
   - **RACE003** — a blocking call while holding a lock (``time.sleep``,
     socket recv/accept, ``subprocess.run``, fsync, barrier,
     jit/lower/compile, ``block_until_ready`` …): a latency or deadlock
     hazard inside a serving tick.  Calls on the held lock itself
     (``cv.wait()`` — which RELEASES the lock) are excluded.
   - **RACE004** — check-then-act: an ``if``/``while`` TEST reads a
     guarded field while NOT holding its guard, and the same function
     then acquires that guard — exactly the shipped watchdog bug's
     shape (completion checked ``task.timed_out`` outside the manager
     lock, then committed the terminal transition under it).

Scope notes (documented limitations, not bugs): ``lock.acquire()`` /
``.release()`` call pairs are NOT tracked as held regions (the repo's
style is ``with``; raw pairs belong to the dynamic sanitizer), and the
guard inference is name-based per module — a false pair is silenced via
``concurrency_allowlist.txt`` with a written justification, never by
weakening the pass.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from ..findings import Finding

PASS_NAME = "lock_discipline"
CODES = ("RACE001", "RACE002", "RACE003", "RACE004")

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}
# with-target names that are locks even without a visible constructor
_LOCK_NAME_RE = re.compile(r"(?:^|_)(?:lock|cv|cond|mutex)$", re.I)
_INIT_FUNCS = {"__init__", "__new__", "__post_init__"}
# attribute-method calls that mutate their receiver in place
_MUTATORS = {"append", "extend", "insert", "pop", "popitem", "remove",
             "clear", "update", "setdefault", "add", "discard",
             "appendleft", "popleft", "sort", "reverse"}
# leaf call names that block (only flagged while a lock is held)
_BLOCKING_LEAVES = {"sleep", "recv", "recvfrom", "recv_into", "accept",
                    "fsync", "barrier", "block_until_ready",
                    "device_put", "wait_save", "check_call",
                    "check_output", "communicate", "getaddrinfo",
                    "wait", "jit", "lower"}
# dotted chains that block (module.func — catches the generic leaves we
# cannot safely match by name alone, e.g. ``subprocess.run``)
_BLOCKING_CHAINS = {("subprocess", "run"), ("time", "sleep"),
                    ("os", "fsync")}


def _dotted(node: ast.AST) -> Optional[str]:
    """'self._lock' / '_cv' / 'os.path.join' for Name/Attribute chains,
    None for anything dynamic (subscripts, calls)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _Lock:
    """One discovered lock: a scoped identity for the order graph and a
    bare name for guard matching."""

    __slots__ = ("scoped", "bare", "expr")

    def __init__(self, scoped: str, bare: str, expr: str):
        self.scoped = scoped      # "CommTaskManager._lock" | "_cv"
        self.bare = bare          # "_lock" | "_cv"
        self.expr = expr          # source expr: "self._lock" | "_cv"


class _Access:
    __slots__ = ("attr", "kind", "held", "qual", "line", "in_init")

    def __init__(self, attr, kind, held, qual, line, in_init):
        self.attr = attr          # field name (attr or module global)
        self.kind = kind          # "read" | "write"
        self.held = held          # tuple of bare lock names held
        self.qual = qual
        self.line = line
        self.in_init = in_init


class _ModuleAnalysis:
    """One file's walk state + finding synthesis."""

    def __init__(self, tree: ast.Module, rel: str):
        self.tree = tree
        self.rel = rel
        self.lock_names: Set[str] = set()       # bare names known locks
        self.module_globals: Set[str] = set()
        self.accesses: List[_Access] = []
        # lock-order graph: scoped -> {scoped: (qual, line)}
        self.edges: Dict[str, Dict[str, Tuple[str, int]]] = {}
        # per (class, method): scoped locks acquired directly
        self.method_acquires: Dict[Tuple[str, str], Set[str]] = {}
        # deferred self-calls made while holding locks:
        # (class, method_called, held scoped tuple, qual, line)
        self.pending_calls: List[Tuple[str, str, Tuple[str, ...],
                                       str, int]] = []
        # blocking calls observed under locks
        self.blocking: List[Tuple[str, str, str, int]] = []
        # (chain, held bare names, qual, line)
        # check-then-act candidates:
        # (field, held bares, locks acquired in function, qual, line)
        self.checks: List[Tuple[str, Tuple[str, ...], Set[str],
                                str, int]] = []

    # -- phase 1: lock discovery ------------------------------------------
    def discover(self):
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Assign):
                v = node.value
                if (isinstance(v, ast.Call)
                        and isinstance(v.func, (ast.Attribute, ast.Name))):
                    leaf = (v.func.attr if isinstance(v.func, ast.Attribute)
                            else v.func.id)
                    if leaf in _LOCK_CTORS:
                        for tgt in node.targets:
                            name = _dotted(tgt)
                            if name:
                                self.lock_names.add(name.split(".")[-1])
            if isinstance(node, ast.With):
                for item in node.items:
                    name = _dotted(item.context_expr)
                    if name and _LOCK_NAME_RE.search(name.split(".")[-1]):
                        self.lock_names.add(name.split(".")[-1])
        for stmt in self.tree.body:
            if isinstance(stmt, ast.Assign):
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name):
                        self.module_globals.add(tgt.id)
            elif isinstance(stmt, (ast.AnnAssign,)) \
                    and isinstance(stmt.target, ast.Name):
                self.module_globals.add(stmt.target.id)

    # -- phase 2: the main walk -------------------------------------------
    def _as_lock(self, expr: ast.AST, cls: Optional[str]) -> Optional[_Lock]:
        name = _dotted(expr)
        if name is None:
            return None
        bare = name.split(".")[-1]
        if bare not in self.lock_names:
            return None
        root = name.split(".")[0]
        if root in ("self", "cls") and cls:
            return _Lock(f"{cls}.{bare}", bare, name)
        return _Lock(bare, bare, name)

    def walk(self):
        for stmt in self.tree.body:
            self._walk_stmt(stmt, cls=None, func=None, qual="<module>",
                            held=[], fn_acquires=None, global_decls=set())

    def _walk_stmt(self, node, *, cls, func, qual, held, fn_acquires,
                   global_decls):
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                self._walk_stmt(sub, cls=node.name, func=None,
                                qual=node.name, held=[],
                                fn_acquires=None, global_decls=set())
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            q = f"{cls}.{node.name}" if cls else node.name
            acquires = self._fn_lock_bares(node, cls)
            gdecls = {n for sub in ast.walk(node)
                      if isinstance(sub, ast.Global) for n in sub.names}
            if cls is not None:
                self.method_acquires.setdefault(
                    (cls, node.name),
                    self._fn_lock_scoped(node, cls))
            for sub in node.body:
                self._walk_stmt(sub, cls=cls, func=node.name, qual=q,
                                held=[], fn_acquires=acquires,
                                global_decls=gdecls)
            return
        if isinstance(node, ast.With):
            new_locks = []
            for item in node.items:
                lk = self._as_lock(item.context_expr, cls)
                if lk is not None:
                    # self-edges are skipped: re-entering an RLock is
                    # legal, and no swept module nests a plain Lock on
                    # itself (the sanitizer catches that at runtime)
                    for h in held:
                        if h.scoped != lk.scoped:
                            self.edges.setdefault(
                                h.scoped, {}).setdefault(
                                lk.scoped, (qual, node.lineno))
                    new_locks.append(lk)
                else:
                    # a non-lock context manager: its expr may still
                    # contain calls/reads
                    self._walk_expr(item.context_expr, cls=cls, qual=qual,
                                    held=held, func=func,
                                    fn_acquires=fn_acquires,
                                    global_decls=global_decls)
            inner = held + new_locks
            for sub in node.body:
                self._walk_stmt(sub, cls=cls, func=func, qual=qual,
                                held=inner, fn_acquires=fn_acquires,
                                global_decls=global_decls)
            return
        if isinstance(node, (ast.If, ast.While)):
            self._record_check(node.test, cls=cls, func=func, qual=qual,
                               held=held, fn_acquires=fn_acquires)
            self._walk_expr(node.test, cls=cls, qual=qual, held=held,
                            func=func, fn_acquires=fn_acquires,
                            global_decls=global_decls)
            for sub in node.body + node.orelse:
                self._walk_stmt(sub, cls=cls, func=func, qual=qual,
                                held=held, fn_acquires=fn_acquires,
                                global_decls=global_decls)
            return
        if isinstance(node, (ast.For, ast.AsyncFor)):
            self._record_store_target(node.target, cls, qual, held, func,
                                      global_decls)
            self._walk_expr(node.iter, cls=cls, qual=qual, held=held,
                            func=func, fn_acquires=fn_acquires,
                            global_decls=global_decls)
            for sub in node.body + node.orelse:
                self._walk_stmt(sub, cls=cls, func=func, qual=qual,
                                held=held, fn_acquires=fn_acquires,
                                global_decls=global_decls)
            return
        if isinstance(node, (ast.Try,)):
            for sub in (node.body + node.orelse + node.finalbody
                        + [s for h in node.handlers for s in h.body]):
                self._walk_stmt(sub, cls=cls, func=func, qual=qual,
                                held=held, fn_acquires=fn_acquires,
                                global_decls=global_decls)
            return
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                self._record_store_target(tgt, cls, qual, held, func,
                                          global_decls)
            self._walk_expr(node.value, cls=cls, qual=qual, held=held,
                            func=func, fn_acquires=fn_acquires,
                            global_decls=global_decls)
            return
        if isinstance(node, ast.AugAssign):
            self._record_store_target(node.target, cls, qual, held, func,
                                      global_decls)
            self._walk_expr(node.value, cls=cls, qual=qual, held=held,
                            func=func, fn_acquires=fn_acquires,
                            global_decls=global_decls)
            return
        if isinstance(node, ast.AnnAssign):
            if node.value is not None:
                self._record_store_target(node.target, cls, qual, held,
                                          func, global_decls)
                self._walk_expr(node.value, cls=cls, qual=qual, held=held,
                                func=func, fn_acquires=fn_acquires,
                                global_decls=global_decls)
            return
        if isinstance(node, ast.Delete):
            for tgt in node.targets:
                self._record_store_target(tgt, cls, qual, held, func,
                                          global_decls)
            return
        # generic statement: walk its expressions
        for sub in ast.iter_child_nodes(node):
            if isinstance(sub, ast.stmt):
                self._walk_stmt(sub, cls=cls, func=func, qual=qual,
                                held=held, fn_acquires=fn_acquires,
                                global_decls=global_decls)
            elif isinstance(sub, ast.expr):
                self._walk_expr(sub, cls=cls, qual=qual, held=held,
                                func=func, fn_acquires=fn_acquires,
                                global_decls=global_decls)

    # -- helpers ----------------------------------------------------------
    def _fn_lock_bares(self, fn, cls) -> Set[str]:
        out = set()
        for sub in ast.walk(fn):
            if isinstance(sub, ast.With):
                for item in sub.items:
                    lk = self._as_lock(item.context_expr, cls)
                    if lk is not None:
                        out.add(lk.bare)
        return out

    def _fn_lock_scoped(self, fn, cls) -> Set[str]:
        out = set()
        for sub in ast.walk(fn):
            if isinstance(sub, ast.With):
                for item in sub.items:
                    lk = self._as_lock(item.context_expr, cls)
                    if lk is not None:
                        out.add(lk.scoped)
        return out

    def _held_bares(self, held) -> Tuple[str, ...]:
        return tuple(h.bare for h in held)

    def _field_of_target(self, tgt) -> Optional[str]:
        """Field name written by an assignment target: the attribute for
        ``self.x = / self.x[i] =``, the global name for module-global
        stores; None for plain locals."""
        node = tgt
        while isinstance(node, (ast.Subscript, ast.Starred)):
            node = node.value
        if isinstance(node, ast.Attribute):
            return node.attr
        if isinstance(node, ast.Name):
            return node.id if node.id in self.module_globals else None
        if isinstance(node, (ast.Tuple, ast.List)):
            return None               # handled element-wise by caller
        return None

    def _record_store_target(self, tgt, cls, qual, held, func,
                             global_decls):
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._record_store_target(el, cls, qual, held, func,
                                          global_decls)
            return
        node = tgt
        while isinstance(node, (ast.Subscript, ast.Starred)):
            if isinstance(node, ast.Subscript):
                # index expression may itself read/call
                pass
            node = node.value
        field = None
        if isinstance(node, ast.Attribute):
            field = node.attr
        elif isinstance(node, ast.Name) and (
                node.id in global_decls or (func is None
                                            and node.id
                                            in self.module_globals)):
            # a bare-name store is a module-global write only under an
            # explicit ``global`` declaration (or at module level)
            field = node.id
        if field is None or field in self.lock_names \
                or field.startswith("__"):
            return
        self.accesses.append(_Access(
            field, "write", self._held_bares(held), qual,
            getattr(tgt, "lineno", 0), func in _INIT_FUNCS or func is None))

    def _record_check(self, test, *, cls, func, qual, held, fn_acquires):
        if func is None or not fn_acquires:
            return
        held_bares = set(self._held_bares(held))
        for sub in ast.walk(test):
            field = None
            if isinstance(sub, ast.Attribute) \
                    and isinstance(sub.ctx, ast.Load):
                field = sub.attr
            elif isinstance(sub, ast.Name) \
                    and isinstance(sub.ctx, ast.Load) \
                    and sub.id in self.module_globals:
                field = sub.id
            if field is None or field in self.lock_names:
                continue
            self.checks.append((field, tuple(held_bares),
                                set(fn_acquires), qual,
                                getattr(sub, "lineno", test.lineno)))

    def _walk_expr(self, node, *, cls, qual, held, func, fn_acquires,
                   global_decls):
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            chain = _dotted(sub.func)
            if chain is None:
                continue
            parts = chain.split(".")
            leaf = parts[-1]
            # mutating receiver call: ``self.timed_out.append(t)`` is a
            # WRITE of ``timed_out``; ``_inflight.pop(...)`` of the
            # module global ``_inflight``
            if leaf in _MUTATORS and len(parts) >= 2:
                base_leaf = parts[-2]
                is_field = (len(parts) >= 3
                            or base_leaf in self.module_globals)
                if is_field and base_leaf not in self.lock_names:
                    self.accesses.append(_Access(
                        base_leaf, "write", self._held_bares(held), qual,
                        sub.lineno,
                        func in _INIT_FUNCS or func is None))
            if held:
                # blocking call under a held lock?  calls on the held
                # lock object itself (cv.wait releases it) are fine
                base = ".".join(parts[:-1])
                held_exprs = {h.expr for h in held}
                if base in held_exprs or chain in held_exprs:
                    continue
                if (leaf in _BLOCKING_LEAVES
                        or tuple(parts[-2:]) in _BLOCKING_CHAINS):
                    self.blocking.append((chain,
                                          ",".join(self._held_bares(held)),
                                          qual, sub.lineno))
                # helper-method call while holding: collect for the
                # transitive lock-order edges
                if (cls is not None and len(parts) == 2
                        and parts[0] == "self"):
                    self.pending_calls.append(
                        (cls, leaf, tuple(h.scoped for h in held), qual,
                         sub.lineno))

    # -- phase 3: findings -------------------------------------------------
    def findings(self) -> List[Finding]:
        out: List[Finding] = []
        guards = self._guard_map()

        # RACE001: guarded field written lock-free
        for field, (lock, guarded_site) in sorted(guards.items()):
            bad = [a for a in self.accesses
                   if a.attr == field and a.kind == "write"
                   and not a.held and not a.in_init]
            if not bad:
                continue
            b = bad[0]
            out.append(Finding(
                code="RACE001", pass_name=PASS_NAME,
                message=(f"field '{field}' is written under lock "
                         f"'{lock}' (at {self.rel}:{guarded_site}) but "
                         f"also written lock-free in {b.qual}"),
                where=f"{self.rel}:{b.line} ({b.qual})",
                data={"field": field, "lock": lock, "qual": b.qual,
                      "guarded_line": guarded_site,
                      "unguarded_line": b.line}))

        # RACE002: resolve deferred helper calls, then find cycles
        self._close_call_edges()
        for cycle, (qual, line) in self._cycles():
            out.append(Finding(
                code="RACE002", pass_name=PASS_NAME,
                message=("lock-order inversion: acquisition cycle "
                         + " -> ".join(cycle + (cycle[0],))),
                where=f"{self.rel}:{line} ({qual})",
                data={"cycle": list(cycle), "qual": qual}))

        # RACE003: blocking call while holding a lock
        for chain, held, qual, line in self.blocking:
            out.append(Finding(
                code="RACE003", pass_name=PASS_NAME,
                message=(f"blocking call '{chain}(...)' while holding "
                         f"lock(s) {held} — latency/deadlock hazard in "
                         f"the control-plane tick"),
                where=f"{self.rel}:{line} ({qual})",
                data={"call": chain, "held": held, "qual": qual}))

        # RACE004: check-then-act on a guarded field
        seen = set()
        for field, held_bares, fn_locks, qual, line in self.checks:
            g = guards.get(field)
            if g is None:
                continue
            lock = g[0]
            if lock in held_bares or lock not in fn_locks:
                continue
            key = (field, qual, line)
            if key in seen:
                continue
            seen.add(key)
            out.append(Finding(
                code="RACE004", pass_name=PASS_NAME,
                message=(f"check-then-act: '{field}' (guarded by "
                         f"'{lock}') is tested OUTSIDE the lock, then "
                         f"{qual} acquires '{lock}' — the guarded state "
                         f"can change between the check and the act "
                         f"(the watchdog handler/flag race shape)"),
                where=f"{self.rel}:{line} ({qual})",
                data={"field": field, "lock": lock, "qual": qual}))
        return out

    def _guard_map(self) -> Dict[str, Tuple[str, int]]:
        """field -> (bare guard lock, example guarded-write line):
        inferred from writes observed under held locks."""
        guards: Dict[str, Dict[str, int]] = {}
        for a in self.accesses:
            if a.kind != "write" or not a.held:
                continue
            guards.setdefault(a.attr, {}).setdefault(a.held[-1], a.line)
        out = {}
        for field, locks in guards.items():
            # innermost lock of the FIRST guarded write wins; multiple
            # candidate guards for one field are rare and allowlistable
            lock, line = next(iter(locks.items()))
            out[field] = (lock, line)
        return out

    def _close_call_edges(self):
        # transitive closure of per-method direct acquisitions over the
        # intra-class self-call graph
        callgraph: Dict[Tuple[str, str], Set[str]] = {}
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for fn in node.body:
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                callees = set()
                for sub in ast.walk(fn):
                    if isinstance(sub, ast.Call):
                        chain = _dotted(sub.func)
                        if chain and chain.startswith("self.") \
                                and chain.count(".") == 1:
                            callees.add(chain.split(".")[1])
                callgraph[(node.name, fn.name)] = callees
        closed: Dict[Tuple[str, str], Set[str]] = {
            k: set(v) for k, v in self.method_acquires.items()}

        def acq(key, seen):
            if key in seen:
                return set()
            seen.add(key)
            base = set(closed.get(key, set()))
            for callee in callgraph.get(key, ()):
                base |= acq((key[0], callee), seen)
            return base

        for cls, method, held_scoped, qual, line in self.pending_calls:
            for target in acq((cls, method), set()):
                for h in held_scoped:
                    if target != h:
                        self.edges.setdefault(h, {}).setdefault(
                            target, (qual, line))

    def _cycles(self):
        """Yield each acquisition-graph cycle once, as (node tuple,
        example edge site)."""
        seen_cycles = set()
        for start in sorted(self.edges):
            stack = [(start, (start,))]
            while stack:
                node, path = stack.pop()
                for nxt in sorted(self.edges.get(node, {})):
                    if nxt == start:
                        canon = tuple(sorted(path))
                        if canon in seen_cycles:
                            continue
                        seen_cycles.add(canon)
                        yield path, self.edges[node][nxt]
                    elif nxt not in path and len(path) < 8:
                        stack.append((nxt, path + (nxt,)))


def analyze_source(source: str, rel: str) -> List[Finding]:
    """Run the lock-discipline analysis over one module's source.
    Returns raw findings (no allowlist applied — that is
    ``analysis.concurrency``'s job)."""
    tree = ast.parse(source)
    mod = _ModuleAnalysis(tree, rel)
    mod.discover()
    if not mod.lock_names:
        return []                    # lock-free module: nothing to guard
    mod.walk()
    return mod.findings()


def analyze_file(path: str, rel: Optional[str] = None) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as f:
        return analyze_source(f.read(), rel or path)


def guarded_write_map(source: str, rel: str) -> Dict[str, Dict[str, list]]:
    """The inferred static lock map, for the dynamic sanitizer's
    cross-check: {lock_bare_name: {field: [qualname, ...]}} over the
    module's under-lock writes.  The lock sanitizer's hammer compares
    this against the functions it OBSERVED acquiring each instrumented
    lock at runtime."""
    tree = ast.parse(source)
    mod = _ModuleAnalysis(tree, rel)
    mod.discover()
    if not mod.lock_names:
        return {}
    mod.walk()
    out: Dict[str, Dict[str, list]] = {}
    for a in mod.accesses:
        if a.kind != "write" or not a.held:
            continue
        quals = out.setdefault(a.held[-1], {}).setdefault(a.attr, [])
        if a.qual not in quals:
            quals.append(a.qual)
    return out
