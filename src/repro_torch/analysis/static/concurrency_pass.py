"""Pass 3 — AST lock-discipline lint over the serving/engine threads.

Port of ``repro.analysis.static.concurrency_pass``: the same analysis,
scoped to the port's ``serving``, ``engine`` and ``obs`` packages, with
the port's lock hierarchy (the reference's, plus ``Engine._tune_lock``,
which ``Engine.autotune`` holds while it applies a winner to the
executor caches).

The serving stack runs user threads (the public `Engine`/`RequestQueue`
API) concurrently with internal worker threads (`RequestQueue._worker`,
`DispatchPipeline._stage_worker`/`_drain_worker`). This pass statically
re-derives the locking discipline those threads must follow:

1. **Field races** — it builds a per-class field-access map by walking
   every method's AST with the lexically-held lock set (``with
   self._lock:`` blocks, `Condition` objects aliased to their backing
   lock), then computes the *transitive* access closure from two entry
   sets: worker-thread entry methods (any ``threading.Thread(target=
   self.X)``) and the public methods of the entry classes. Cross-class
   calls are followed through attribute types resolved from constructor
   assignments (``self.stats = ServerStats()``) plus a small hint table
   for untyped parameters. An attribute **written** in worker context
   and **read** in public context with no common held lock is a
   ``field-race`` error — unless either line carries a
   ``# lint: racy-ok(<reason>)`` waiver.
2. **Lock order** — every nested acquisition produces an edge
   ``outer -> inner``; edges are checked against the declared hierarchy
   (`LOCK_ORDER`). A reversed edge is a ``lock-order`` error (a real
   inversion: two threads taking the pair in opposite orders can
   deadlock); an undeclared lock in any edge is a warning.

Accesses in ``__init__`` are ignored (construction happens-before any
thread starts). Known blind spots, by design: container *item*
mutations (``self.d[k] = v``) count as writes, but mutations through
container methods (``self.d.pop(k)``) only as reads of the attribute;
dynamic ``getattr`` targets are not followed.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from repro_torch.analysis.static.report import Finding, scan_waivers

# Default scope (relative to the repo root). Directory entries glob
# ``*.py``; a ``.py`` entry names one file explicitly (replicas.py,
# chaos.py, and resilience.py are both covered by their directory AND
# pinned by name, so a future scope reshuffle cannot silently drop the
# router or the failure-containment layer from the lint).
SCOPE_DIRS = ("src/repro_torch/serving",
              "src/repro_torch/serving/replicas.py",
              "src/repro_torch/serving/chaos.py",
              "src/repro_torch/serving/resilience.py",
              "src/repro_torch/engine", "src/repro_torch/obs")

# Classes whose non-underscore methods constitute the user-thread API.
ENTRY_CLASSES = frozenset({"Engine", "RequestQueue", "ReplicaSet"})

# Types of attributes the AST cannot infer (assigned from parameters).
ATTR_TYPE_HINTS = {
    ("RequestQueue", "engine"): "Engine",
    ("RequestQueue", "replica_set"): "ReplicaSet",
    ("DispatchPipeline", "engine"): "Engine",
    ("DispatchPipeline", "latency"): "LatencyModel",
    ("DispatchPipeline", "stats"): "ServerStats",
    ("ReplicaSet", "stats"): "ServerStats",
    ("Engine", "_frontend"): "RequestQueue",
    ("Engine", "_lifecycle"): "LifecycleManager",
    ("LifecycleManager", "engine"): "Engine",
    ("LifecycleManager", "_frontend"): "RequestQueue",
}

# The declared acquisition hierarchy: a thread may only take a lock to
# the RIGHT of every lock it already holds. Mirrors the docstrings in
# frontend/pipeline/replicas ("lock order is always _lock ->
# _dispatch_gate", queue lock outermost, the ReplicaSet router lock
# between the frontend and the per-replica pipelines it routes into).
LOCK_ORDER = (
    "RequestQueue._lock",
    "RequestQueue._dispatch_gate",
    "ReplicaSet._lock",
    "DispatchPipeline._lock",
    # Resilience layer (docs/ROBUSTNESS.md): the coordinator's handler
    # runs from the pipeline's failure path, so its lock nests inside
    # the pipeline's; watchdog and brownout are self-contained leaves
    # on their side of the engine boundary.
    "ResilienceCoordinator._lock",
    "DispatchWatchdog._lock",
    "BrownoutController._lock",
    # Engine.autotune holds the tuner lock while it applies the winner to
    # every executor cache, so it nests outside the cache lock.
    "Engine._tune_lock",
    "Engine._stack_lock",
    "ExecutorCache._lock",
    # Chaos polls fire inside the executor-cache miss path (compile
    # site), so the injector lock nests inside the cache lock and
    # wraps nothing.
    "ChaosInjector._lock",
    "LatencyModel._lock",
    # Metric primitives are leaves: any component may update a Counter/
    # Histogram while holding its own lock, so these come last and must
    # never wrap a component lock.
    "MetricsRegistry._lock",
    "Counter._lock",
    "Gauge._lock",
    "Histogram._lock",
    "CounterFamily._lock",
    "GaugeFamily._lock",
    "Tracer._lock",
)

_MAX_DEPTH = 16


@dataclasses.dataclass
class Access:
    cls: str                  # owning class of the attribute
    attr: str
    kind: str                 # "read" | "write"
    held: FrozenSet[str]      # locks lexically held at the access
    file: str
    line: int


@dataclasses.dataclass
class MethodInfo:
    cls: str
    name: str
    accesses: List[Access] = dataclasses.field(default_factory=list)
    # (target cls, target method, locks lexically held at call, line)
    calls: List[Tuple[str, str, FrozenSet[str], int]] = \
        dataclasses.field(default_factory=list)
    # (qualified lock, locks lexically held at acquisition, file, line)
    acquisitions: List[Tuple[str, FrozenSet[str], str, int]] = \
        dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ClassInfo:
    name: str
    file: str
    locks: set = dataclasses.field(default_factory=set)
    lock_alias: Dict[str, str] = dataclasses.field(default_factory=dict)
    attr_types: Dict[str, str] = dataclasses.field(default_factory=dict)
    methods: Dict[str, MethodInfo] = dataclasses.field(default_factory=dict)
    method_nodes: Dict[str, ast.FunctionDef] = \
        dataclasses.field(default_factory=dict)
    properties: set = dataclasses.field(default_factory=set)
    thread_entries: set = dataclasses.field(default_factory=set)


def _self_chain(node) -> Optional[List[str]]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name) and node.id == "self":
        parts.reverse()
        return parts
    return None


def _call_class_name(call: ast.Call) -> Optional[str]:
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _ann_names(node):
    if isinstance(node, ast.Name):
        yield node.id
    elif isinstance(node, ast.Subscript):
        yield from _ann_names(node.slice)
        yield from _ann_names(node.value)
    elif isinstance(node, (ast.Tuple, ast.List)):
        for e in node.elts:
            yield from _ann_names(e)
    elif isinstance(node, ast.Constant) and isinstance(node.value, str):
        yield node.value


class Registry:
    """All scoped classes plus the cross-class resolution tables."""

    def __init__(self, hints: Optional[dict] = None):
        self.classes: Dict[str, ClassInfo] = {}
        self.hints = dict(ATTR_TYPE_HINTS if hints is None else hints)

    # ------------------------------------------------------ phase A -----
    def parse(self, paths: Sequence[Path]) -> Dict[str, Dict[int, str]]:
        waivers: Dict[str, Dict[int, str]] = {}
        for path in paths:
            text = Path(path).read_text()
            waivers[str(path)] = scan_waivers(str(path), text)
            tree = ast.parse(text, filename=str(path))
            for node in tree.body:
                if isinstance(node, ast.ClassDef):
                    self._scan_class(node, str(path))
        return waivers

    def _scan_class(self, cnode: ast.ClassDef, file: str) -> None:
        ci = self.classes.setdefault(cnode.name,
                                     ClassInfo(cnode.name, file))
        for node in cnode.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ci.method_nodes[node.name] = node
                if any(isinstance(d, ast.Name) and d.id == "property"
                       for d in node.decorator_list):
                    ci.properties.add(node.name)
            elif isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name):
                self._note_annotation(ci, node.target.id, node.annotation)
        for node in ast.walk(cnode):
            if isinstance(node, ast.Assign):
                self._scan_assign(ci, node)
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                tgt = _self_chain(node.target)
                if tgt and len(tgt) == 1:
                    self._note_annotation(ci, tgt[0], node.annotation)
                    self._note_value(ci, tgt[0], node.value)
            elif isinstance(node, ast.Call):
                self._scan_thread(ci, node)

    def _note_annotation(self, ci: ClassInfo, attr: str, ann) -> None:
        for name in _ann_names(ann):
            if name in self.classes or name in {
                    v for v in self.hints.values()}:
                ci.attr_types.setdefault(attr, name)

    def _scan_assign(self, ci: ClassInfo, node: ast.Assign) -> None:
        for tgt in node.targets:
            chain = _self_chain(tgt)
            if chain and len(chain) == 1:
                self._note_value(ci, chain[0], node.value)

    def _note_value(self, ci: ClassInfo, attr: str, value) -> None:
        if isinstance(value, ast.IfExp):
            self._note_value(ci, attr, value.body)
            self._note_value(ci, attr, value.orelse)
            return
        if not isinstance(value, ast.Call):
            return
        name = _call_class_name(value)
        if name in ("Lock", "RLock"):
            ci.locks.add(attr)
        elif name == "Condition":
            if value.args:
                backing = _self_chain(value.args[0])
                if backing and len(backing) == 1:
                    ci.lock_alias[attr] = backing[0]
            else:
                ci.locks.add(attr)
        elif name is not None:
            ci.attr_types.setdefault(attr, name)

    def _scan_thread(self, ci: ClassInfo, call: ast.Call) -> None:
        if _call_class_name(call) != "Thread":
            return
        for kw in call.keywords:
            if kw.arg == "target":
                chain = _self_chain(kw.value)
                if chain and len(chain) == 1:
                    ci.thread_entries.add(chain[0])

    # --------------------------------------------------- resolution -----
    def canonical_lock(self, cls: str, attr: str) -> Optional[str]:
        ci = self.classes.get(cls)
        if ci is None:
            return None
        attr = ci.lock_alias.get(attr, attr)
        return f"{cls}.{attr}" if attr in ci.locks else None

    def attr_type(self, cls: str, attr: str) -> Optional[str]:
        ci = self.classes.get(cls)
        if ci is not None and attr in ci.attr_types:
            return ci.attr_types[attr]
        return self.hints.get((cls, attr))

    def method(self, cls: str, name: str) -> Optional[MethodInfo]:
        ci = self.classes.get(cls)
        return None if ci is None else ci.methods.get(name)


class _MethodScanner(ast.NodeVisitor):
    """Phase B: extract one method's accesses/calls/acquisitions with
    the lexically-held lock set."""

    def __init__(self, reg: Registry, ci: ClassInfo, mi: MethodInfo):
        self.reg = reg
        self.ci = ci
        self.mi = mi
        self.held: FrozenSet[str] = frozenset()

    # -- lock scoping ----------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        acquired: List[str] = []
        for item in node.items:
            chain = _self_chain(item.context_expr)
            lock = (self.reg.canonical_lock(self.ci.name, chain[0])
                    if chain and len(chain) == 1 else None)
            if lock is not None:
                self.mi.acquisitions.append(
                    (lock, self.held | frozenset(acquired),
                     self.ci.file, item.context_expr.lineno))
                acquired.append(lock)
            else:
                self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        prev = self.held
        self.held = self.held | frozenset(acquired)
        for stmt in node.body:
            self.visit(stmt)
        self.held = prev

    # -- accesses --------------------------------------------------------
    def _record_chain(self, parts: List[str], kind: str, line: int,
                      is_call: bool = False) -> None:
        cls = self.ci.name
        for depth, attr in enumerate(parts):
            ci = self.reg.classes.get(cls)
            if ci is None:
                return
            if attr in ci.locks or attr in ci.lock_alias:
                return               # lock plumbing, not data
            last = depth == len(parts) - 1
            if last and is_call and attr in ci.method_nodes:
                self.mi.calls.append((cls, attr, self.held, line))
                return
            self.mi.accesses.append(Access(
                cls, attr, kind if last else "read", self.held,
                self.ci.file, line))
            if last:
                return
            cls = self.reg.attr_type(cls, attr)
            if cls is None:
                return

    def visit_Attribute(self, node: ast.Attribute) -> None:
        chain = _self_chain(node)
        if chain is None:
            self.generic_visit(node)
            return
        kind = "write" if isinstance(node.ctx, (ast.Store, ast.Del)) \
            else "read"
        self._record_chain(chain, kind, node.lineno)

    def visit_Call(self, node: ast.Call) -> None:
        chain = _self_chain(node.func)
        if chain is not None:
            self._record_chain(chain, "read", node.lineno, is_call=True)
        else:
            self.visit(node.func)
        for arg in node.args:
            self.visit(arg)
        for kw in node.keywords:
            self.visit(kw.value)

    def _visit_container_store(self, tgt) -> None:
        """``self.d[k] = v`` / ``del self.d[k]`` mutate the container —
        record a write on the attribute itself."""
        if isinstance(tgt, ast.Subscript):
            chain = _self_chain(tgt.value)
            if chain is not None:
                self._record_chain(chain, "write", tgt.lineno)
            else:
                self.visit(tgt.value)
            self.visit(tgt.slice)
            return True
        return False

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            if not self._visit_container_store(tgt):
                self.visit(tgt)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        chain = _self_chain(node.target) if \
            not isinstance(node.target, ast.Subscript) else None
        if chain is not None:
            self._record_chain(chain, "read", node.lineno)
            self._record_chain(chain, "write", node.lineno)
        elif not self._visit_container_store(node.target):
            self.visit(node.target)
        self.visit(node.value)

    def visit_Delete(self, node: ast.Delete) -> None:
        for tgt in node.targets:
            if not self._visit_container_store(tgt):
                self.visit(tgt)


def _extract_methods(reg: Registry) -> None:
    for ci in reg.classes.values():
        for name, node in ci.method_nodes.items():
            mi = MethodInfo(ci.name, name)
            ci.methods[name] = mi
            if name == "__init__":
                continue    # happens-before any thread exists
            scanner = _MethodScanner(reg, ci, mi)
            for stmt in node.body:
                scanner.visit(stmt)


# ------------------------------------------------------ phase C: closure ----

def _closure(reg: Registry, entries: List[Tuple[str, str]],
             edges: list) -> List[Tuple[Access, FrozenSet[str]]]:
    """Transitive (access, effective-held-locks) set reachable from the
    entry methods; nested acquisition edges are appended to ``edges``."""
    out: List[Tuple[Access, FrozenSet[str]]] = []
    visited = set()

    def visit(cls: str, meth: str, held: FrozenSet[str], depth: int):
        if depth > _MAX_DEPTH:
            return
        mi = reg.method(cls, meth)
        if mi is None:
            return
        key = (cls, meth, held)
        if key in visited:
            return
        visited.add(key)
        for acc in mi.accesses:
            eff = held | acc.held
            out.append((acc, eff))
            owner = reg.classes.get(acc.cls)
            if owner is not None and acc.attr in owner.properties:
                visit(acc.cls, acc.attr, eff, depth + 1)
        for tcls, tmeth, call_held, _line in mi.calls:
            visit(tcls, tmeth, held | call_held, depth + 1)
        for lock, lex_held, file, line in mi.acquisitions:
            for outer in held | lex_held:
                if outer != lock:
                    edges.append((outer, lock, file, line))

    for cls, meth in entries:
        visit(cls, meth, frozenset(), 0)
    return out


def _data_attr(reg: Registry, acc: Access) -> bool:
    ci = reg.classes.get(acc.cls)
    if ci is None:
        return False
    if acc.attr in ci.locks or acc.attr in ci.lock_alias:
        return False
    if acc.attr in ci.method_nodes:      # method/property reference
        return False
    return True


def analyze_paths(paths: Sequence, *, entry_classes=ENTRY_CLASSES,
                  hints: Optional[dict] = None,
                  lock_order: Sequence[str] = LOCK_ORDER) -> List[Finding]:
    """Run the full concurrency lint over ``paths`` (python files)."""
    reg = Registry(hints)
    waivers = reg.parse([Path(p) for p in paths])
    _extract_methods(reg)

    worker_entries = [(ci.name, m) for ci in reg.classes.values()
                      for m in sorted(ci.thread_entries)]
    public_entries = [(ci.name, m) for ci in reg.classes.values()
                      if ci.name in entry_classes
                      for m in sorted(ci.method_nodes)
                      if not m.startswith("_")]
    edges: list = []
    worker = _closure(reg, worker_entries, edges)
    public = _closure(reg, public_entries, edges)

    findings: List[Finding] = []

    # ---- field races ---------------------------------------------------
    writes: Dict[Tuple[str, str], list] = {}
    for acc, eff in worker:
        if acc.kind == "write" and _data_attr(reg, acc):
            writes.setdefault((acc.cls, acc.attr), []).append((acc, eff))
    reads: Dict[Tuple[str, str], list] = {}
    for acc, eff in public:
        if acc.kind == "read" and _data_attr(reg, acc):
            reads.setdefault((acc.cls, acc.attr), []).append((acc, eff))

    def waiver_for(acc: Access) -> Optional[str]:
        return waivers.get(acc.file, {}).get(acc.line)

    for key in sorted(set(writes) & set(reads)):
        cls, attr = key
        racy = [(w, we, r, re_) for w, we in writes[key]
                for r, re_ in reads[key] if not (we & re_)]
        if not racy:
            continue
        # a finding is waived only if EVERY racy pair carries a waiver
        # on at least one side; report the first unwaived pair so the
        # cited sites are the ones that still need attention
        reason = None
        w, r = racy[0][0], racy[0][2]
        for wa, _, ra, _ in racy:
            reason = waiver_for(wa) or waiver_for(ra)
            if reason is None:
                w, r = wa, ra
                break
        findings.append(Finding(
            "concurrency", "field-race",
            "error", f"{r.file}:{r.line}",
            f"{cls}.{attr} written from worker thread at "
            f"{Path(w.file).name}:{w.line} and read from public API at "
            f"{Path(r.file).name}:{r.line} with no common lock held",
            waived=reason is not None, waive_reason=reason or ""))

    # ---- lock order ----------------------------------------------------
    rank = {name: i for i, name in enumerate(lock_order)}
    seen_edges = set()
    for outer, inner, file, line in edges:
        if (outer, inner) in seen_edges:
            continue
        seen_edges.add((outer, inner))
        if outer not in rank or inner not in rank:
            findings.append(Finding(
                "concurrency", "lock-order", "warn", f"{file}:{line}",
                f"acquisition edge {outer} -> {inner} involves a lock "
                f"outside the declared hierarchy"))
        elif rank[outer] > rank[inner]:
            findings.append(Finding(
                "concurrency", "lock-order", "error", f"{file}:{line}",
                f"lock-order inversion: {inner} acquired while holding "
                f"{outer}, but the declared hierarchy is "
                f"{' -> '.join(lock_order)}"))
    return findings


def run_concurrency_pass(root=None) -> List[Finding]:
    """Repo-level entry: lint the serving and engine packages."""
    root = Path(root) if root is not None else _repo_root()
    scoped = set()
    for d in SCOPE_DIRS:
        target = root / d
        if d.endswith(".py"):
            scoped.add(target)  # explicit file entry
        else:
            scoped.update(target.glob("*.py"))
    paths = sorted(scoped)
    return analyze_paths(paths)


def _repo_root() -> Path:
    here = Path(__file__).resolve()
    for parent in here.parents:
        if (parent / "pyproject.toml").exists():
            return parent
    return Path.cwd()
