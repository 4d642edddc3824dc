"""Static may-acquire-under graph extraction + cycle (deadlock) detection.

For every function in the analyzed modules we record which locks it acquires
(``with self._lock`` / ``with b.cond``) and which calls happen while a lock is
held.  Method summaries are closed over the name-resolved call graph to a
fixpoint, so ``EngineLoop.submit`` holding ``EngineLoop._lock`` while calling
something that eventually takes ``Trace._lock`` yields the edge
``EngineLoop._lock -> Trace._lock`` even across modules.

Edges mean "may acquire B while holding A".  A cycle in that graph is a
potential deadlock; a self-edge on a *non-reentrant* Lock is a guaranteed one.
Self-edges on RLocks (the engine's coarse step lock) are recorded but legal.

Call resolution is by bare method name across the analyzed set -- deliberately
over-approximate for a lint (ambiguity widens the graph, never narrows it).
Container/stdlib method names (``get``/``pop``/``append``...) are excluded so
dict traffic can't alias onto our classes and fabricate cycles.

Module-level locks (``_lock = threading.Lock()`` at module scope, see
``locklint``) are nodes named ``<module>.<name>`` (``_build._count_lock``);
they are resolved before any class attribute, so ``_build._lock`` never
aliases ``StraightLineRouter._lock``.  Module-level functions are keyed by
their file's dotted path (every ``ops.py`` apart) and still resolve by
their bare name; a call ``X.f(...)`` on a module ``X`` bound by ``import X``
and not analyzed (``subprocess.run``) resolves to nothing.

**Device dispatch.**  The engines call the model through names that resolve
to nothing in the analyzed set (``self.model.decode(...)``).  Such a call,
when its name is a device dispatch (``locklint.DEVICE_DISPATCH``), may
launch any kernel: it resolves to every function of the *dispatch sources*
(the kernel wrappers, ``kernels/*/ops.py``), whose launches take
``_build``'s locks.  So the engine's step lock gets its edges to
``_build._count_lock`` without analyzing the model code in between.

The graph is emitted as JSON + Graphviz dot (``docs/lock_order_torch.*``)
and doubles as the documentation of the runtime's lock hierarchy;
``witness.py`` checks recorded runtime orders against it.  Suppress an
edge's source line with ``# lockorder: ok <reason>``.
"""

from __future__ import annotations

import ast
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .common import Finding, SourceFile, suppression_reason, unparse
from .locklint import (
    DEVICE_DISPATCH,
    ClassLocks,
    LockDecl,
    class_families,
    collect_lock_decls,
    collect_module_locks,
    family_lock_decls,
    module_name,
)

TOOL = "lockorder"

#: attr names never resolved to our methods: ubiquitous container/stdlib verbs
#: that would alias dict/list/deque traffic onto analyzed classes.
IGNORED_CALLEES = {
    "get", "set", "pop", "popleft", "append", "appendleft", "add", "discard",
    "update", "items", "keys", "values", "clear", "extend", "insert", "remove",
    "count", "index", "sort", "copy", "join", "split", "strip", "format",
    "read", "write", "flush", "close", "encode", "setdefault", "acquire",
    "release", "notify", "notify_all", "is_set", "put", "load", "dump",
    # threading.Condition/Event verbs: .wait() on a held condition is the
    # documented release-and-sleep, not an acquisition of someone's `wait`
    "wait",
}


@dataclass
class Edge:
    src: str
    dst: str
    path: str
    line: int
    via: str          # "nested-with" | "call:<name>"

    def key(self) -> Tuple[str, str]:
        return (self.src, self.dst)


@dataclass
class _FuncInfo:
    qname: str                   # "Class.method" or "module.func"
    src: SourceFile
    cls_name: str = ""           # owning class ("" for module functions)
    dispatch: bool = False       # a function of the dispatch sources
    acquires: Set[str] = field(default_factory=set)
    # (held lock ids at the call, callee bare name, line, is self.X() call)
    calls: List[Tuple[Tuple[str, ...], str, int, bool]] = field(default_factory=list)
    nested: List[Edge] = field(default_factory=list)


class _FuncScanner(ast.NodeVisitor):
    def __init__(self, graph: "LockOrder", info: _FuncInfo, cls: Optional[ClassLocks]):
        self.g = graph
        self.info = info
        self.cls = cls
        self.held: List[str] = []
        self.foreign = graph.foreign_modules(info.src)

    def visit_With(self, node: ast.With) -> None:
        pushed = 0
        for item in node.items:
            lock_id = self.g.lock_id(item.context_expr, self.cls, self.info.src)
            if lock_id is not None:
                self.info.acquires.add(lock_id)
                for h in self.held:
                    self.info.nested.append(Edge(
                        src=h, dst=lock_id, path=self.info.src.path,
                        line=item.context_expr.lineno, via="nested-with"))
                self.held.append(lock_id)
                pushed += 1
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(pushed):
            self.held.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        return  # nested defs run later; scanned as their own functions

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def visit_Call(self, node: ast.Call) -> None:
        self.generic_visit(node)
        name: Optional[str] = None
        selfcall = False
        if isinstance(node.func, ast.Attribute):
            name = node.func.attr
            base = node.func.value
            selfcall = (isinstance(base, ast.Name) and base.id == "self") or (
                isinstance(base, ast.Call) and isinstance(base.func, ast.Name)
                and base.func.id == "super")
            if isinstance(base, ast.Name) and base.id in self.foreign:
                return    # subprocess.run(...): a library's function, not ours
        elif isinstance(node.func, ast.Name):
            name = node.func.id
        if not name or name in IGNORED_CALLEES or name.startswith("__"):
            return
        self.info.calls.append((tuple(self.held), name, node.lineno, selfcall))


class LockOrder:
    def __init__(self, sources: Sequence[SourceFile],
                 dispatch_sources: Sequence[SourceFile] = ()):
        self.dispatch_sources = list(dispatch_sources)
        self.sources = list(sources) + self.dispatch_sources
        self.classes = collect_lock_decls(self.sources)
        self.modules = collect_module_locks(self.sources)
        self.families = class_families(self.classes)
        self.decls: Dict[str, LockDecl] = {}
        for info in self.classes.values():
            for decl in info.locks.values():
                self.decls[f"{self._family_owner(info.name, decl.attr)}.{decl.attr}"] = decl
        for mod in self.modules.values():
            for decl in mod.locks.values():
                self.decls[f"{mod.name}.{decl.attr}"] = decl
        self.stems = {module_name(s) for s in self.sources}
        self._foreign: Dict[str, Set[str]] = {}
        self.funcs: Dict[str, _FuncInfo] = {}
        self.edges: List[Edge] = []
        self.findings: List[Finding] = []

    def foreign_modules(self, src: SourceFile) -> Set[str]:
        """Names ``src`` binds with ``import X`` / ``import X as Y`` that
        are not analyzed modules: a call ``X.f(...)`` goes to a library
        (``subprocess.run``), never to an analyzed function named ``f``."""
        if src.path not in self._foreign:
            names = set()
            for node in ast.walk(src.tree):
                if isinstance(node, ast.Import):
                    for alias in node.names:
                        names.add(alias.asname or alias.name.split(".")[0])
            self._foreign[src.path] = names - self.stems
        return self._foreign[src.path]

    # -- lock identity ------------------------------------------------------
    def _family_owner(self, cls_name: str, attr: str) -> str:
        """Canonical owner name for a lock attr: when several classes in one
        inheritance family declare it (both engines create ``self.lock``),
        collapse onto their common analyzed base so the graph has one node."""
        family = self.families.get(cls_name, {cls_name})
        declaring = [m for m in sorted(family)
                     if attr in self.classes.get(m, ClassLocks(m)).locks]
        if len(declaring) <= 1:
            return declaring[0] if declaring else cls_name
        for m in sorted(family):
            info = self.classes.get(m)
            if info is not None and all(
                m in self.classes.get(d, ClassLocks(d)).bases or m == d
                for d in declaring
            ):
                return m
        return declaring[0]

    def lock_id(self, expr: ast.AST, cls: Optional[ClassLocks],
                src: Optional[SourceFile] = None) -> Optional[str]:
        module_id = self._module_lock_id(expr, src)
        if module_id is not None:
            return module_id
        if not isinstance(expr, ast.Attribute):
            return None
        attr = expr.attr
        base = unparse(expr.value)
        owner: Optional[ClassLocks] = None
        if base == "self" and cls is not None:
            decls = family_lock_decls(self.classes, self.families, cls.name, attr)
            if decls:
                owner = self.classes[decls[0].cls]
        if owner is None:
            owners = [c for c in self.classes.values() if attr in c.locks]
            if len(owners) == 1:
                owner = owners[0]
        if owner is None:
            return None
        decl = owner.locks[attr]
        # a Condition and its base lock are one mutex: canonicalize on the
        # condition attr if one exists, else the lock attr.
        return self._canonical(owner, decl)

    def _canonical(self, owner: ClassLocks, decl: LockDecl) -> str:
        name = self._family_owner(owner.name, decl.attr)
        if decl.cond_base is not None:
            return f"{name}.{decl.attr}"
        for other in owner.locks.values():
            if other.cond_base == decl.attr:
                return f"{self._family_owner(owner.name, other.attr)}.{other.attr}"
        return f"{name}.{decl.attr}"

    def _module_lock_id(self, expr: ast.AST, src: Optional[SourceFile]) -> Optional[str]:
        """``<module>.<name>`` for a module-level lock (``_lock`` in its own
        module, ``mod._lock`` from another), a Condition's base lock
        canonicalized onto the condition as for class locks."""
        mod = None
        if isinstance(expr, ast.Name) and src is not None:
            mod = self.modules.get(module_name(src))
            name = expr.id
        elif isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
            mod = self.modules.get(expr.value.id)
            name = expr.attr
        if mod is None or name not in mod.locks:
            return None
        decl = mod.locks[name]
        if decl.cond_base is None:
            for other in mod.locks.values():
                if other.cond_base == name:
                    return f"{mod.name}.{other.attr}"
        return f"{mod.name}.{name}"

    def node_kind(self, lock_id: str) -> str:
        decl = self.decls.get(lock_id)
        if decl is None:
            return "Lock"
        if decl.cond_base is not None:
            base = self.decls.get(f"{decl.cls}.{decl.cond_base}")
            return base.kind if base is not None else "Lock"
        return decl.kind

    # -- extraction ---------------------------------------------------------
    def scan(self) -> None:
        for src in self.sources:
            dispatch = any(src is d for d in self.dispatch_sources)
            for node in src.tree.body:
                if isinstance(node, ast.ClassDef):
                    cls = self.classes.get(node.name)
                    for child in node.body:
                        if isinstance(child, ast.FunctionDef):
                            self._scan_func(src, child, cls, f"{node.name}.{child.name}", dispatch)
                elif isinstance(node, ast.FunctionDef):
                    self._scan_func(src, node, None, f"{_module_key(src)}.{node.name}", dispatch)

    def _scan_func(self, src: SourceFile, fn: ast.FunctionDef,
                   cls: Optional[ClassLocks], qname: str, dispatch: bool = False) -> None:
        info = _FuncInfo(qname=qname, src=src, cls_name=cls.name if cls else "",
                         dispatch=dispatch)
        scanner = _FuncScanner(self, info, cls)
        for stmt in fn.body:
            scanner.visit(stmt)
        self.funcs[qname] = info
        # nested defs (worker closures) as standalone functions
        for stmt in ast.walk(fn):
            if isinstance(stmt, ast.FunctionDef) and stmt is not fn:
                self._scan_func(src, stmt, cls, f"{qname}.<{stmt.name}>", dispatch)

    # -- summaries + edges --------------------------------------------------
    def _resolve(self, name: str, cls_name: str = "", selfcall: bool = False) -> List[_FuncInfo]:
        """Callees for a bare name.  ``self.X()`` resolves only within the
        caller's inheritance family when the family defines X -- otherwise the
        engine's ``self.submit`` would alias onto the router's and fabricate
        cross-stack edges."""
        if selfcall and cls_name:
            family = self.families.get(cls_name, {cls_name})
            scoped = [f for q, f in self.funcs.items()
                      if f.cls_name in family and q.rsplit(".", 1)[-1] == name]
            if scoped:
                return scoped
        found = [f for q, f in self.funcs.items()
                 if q == name or q.rsplit(".", 1)[-1] == name
                 or q.rsplit(".", 1)[-1] == f"<{name}>"]
        if not found and DEVICE_DISPATCH.match(name):
            found = [f for f in self.funcs.values() if f.dispatch]
        return found

    def build(self) -> List[Edge]:
        self.scan()
        # transitive acquires to a fixpoint over name-resolved calls
        summary: Dict[str, Set[str]] = {q: set(f.acquires) for q, f in self.funcs.items()}
        changed = True
        while changed:
            changed = False
            for q, f in self.funcs.items():
                for _, callee, _, selfcall in f.calls:
                    for target in self._resolve(callee, f.cls_name, selfcall):
                        extra = summary[target.qname] - summary[q]
                        if extra:
                            summary[q] |= extra
                            changed = True
        edges: Dict[Tuple[str, str], Edge] = {}
        for f in self.funcs.values():
            for e in f.nested:
                edges.setdefault(e.key(), e)
            for held, callee, line, selfcall in f.calls:
                if not held:
                    continue
                acquired: Set[str] = set()
                for target in self._resolve(callee, f.cls_name, selfcall):
                    acquired |= summary[target.qname]
                for h in held:
                    for lock in acquired:
                        e = Edge(src=h, dst=lock, path=f.src.path, line=line,
                                 via=f"call:{callee}")
                        edges.setdefault(e.key(), e)
        # reasoned suppressions drop the edge (and record nothing)
        kept = []
        for e in edges.values():
            src_file = next(s for s in self.sources if s.path == e.path)
            reason = suppression_reason(src_file, e.line, TOOL)
            if reason:
                continue
            kept.append(e)
        self.edges = sorted(kept, key=lambda e: (e.src, e.dst))
        return self.edges

    # -- cycle detection ----------------------------------------------------
    def check(self) -> List[Finding]:
        if not self.edges:
            self.build()
        adj: Dict[str, List[Edge]] = {}
        for e in self.edges:
            if e.src == e.dst:
                kind = self.node_kind(e.src)
                if kind != "RLock":
                    self.findings.append(Finding(
                        tool=TOOL, path=e.path, line=e.line, code="self-deadlock",
                        message=f"{e.src} ({kind}) may be re-acquired while already "
                                f"held (via {e.via}); only an RLock survives that"))
                continue
            adj.setdefault(e.src, []).append(e)
        for cycle in _find_cycles(adj):
            first = cycle[0]
            path = " -> ".join([e.src for e in cycle] + [cycle[0].src])
            self.findings.append(Finding(
                tool=TOOL, path=first.path, line=first.line, code="lock-cycle",
                message=f"lock-order cycle (potential deadlock): {path}"))
        return self.findings

    # -- artifacts ----------------------------------------------------------
    def to_json(self) -> dict:
        nodes = sorted({e.src for e in self.edges} | {e.dst for e in self.edges}
                       | set(self.decls.keys() - {
                           # conditions are canonicalized onto their own id;
                           # hide base-lock aliases from the node list
                           f"{d.cls}.{d.cond_base}" for d in self.decls.values()
                           if d.cond_base is not None}))
        return {
            "nodes": [{"id": n, "kind": self.node_kind(n)} for n in nodes],
            "edges": [{"src": e.src, "dst": e.dst, "path": e.path,
                       "line": e.line, "via": e.via}
                      for e in sorted(self.edges, key=lambda e: (e.src, e.dst))],
        }

    def to_dot(self) -> str:
        doc = self.to_json()
        lines = ["digraph lock_order {", '  rankdir=LR;',
                 '  node [shape=box, fontname="monospace"];']
        for n in doc["nodes"]:
            style = ' style=rounded' if n["kind"] == "RLock" else ""
            lines.append(f'  "{n["id"]}" [label="{n["id"]}\\n({n["kind"]})"{style}];')
        for e in doc["edges"]:
            lines.append(f'  "{e["src"]}" -> "{e["dst"]}" '
                         f'[label="{e["via"]}\\n{e["path"].rsplit("/", 1)[-1]}:{e["line"]}"];')
        lines.append("}")
        return "\n".join(lines) + "\n"


def _module_key(src: SourceFile) -> str:
    """A module's dotted path (``src.repro_torch.kernels.rmsnorm.ops``), so
    module functions of like-named files (every ``ops.py``) keep apart."""
    path = src.path[:-3] if src.path.endswith(".py") else src.path
    return path.replace("/", ".").replace("\\", ".")


def _find_cycles(adj: Dict[str, List[Edge]]) -> List[List[Edge]]:
    """Distinct simple cycles via DFS back-edge detection (one per back edge)."""
    cycles: List[List[Edge]] = []
    seen_cycles: Set[Tuple[str, ...]] = set()
    state: Dict[str, int] = {}  # 0/absent=white, 1=gray, 2=black
    stack: List[Edge] = []

    def dfs(node: str) -> None:
        state[node] = 1
        for e in adj.get(node, []):
            if state.get(e.dst, 0) == 1:
                idx = next(i for i, se in enumerate(stack) if se.src == e.dst)
                cyc = stack[idx:] + [e]
                key = tuple(sorted(se.src for se in cyc))
                if key not in seen_cycles:
                    seen_cycles.add(key)
                    cycles.append(cyc)
            elif state.get(e.dst, 0) == 0:
                stack.append(e)
                dfs(e.dst)
                stack.pop()
        state[node] = 2

    for node in list(adj):
        if state.get(node, 0) == 0:
            dfs(node)
    return cycles


def analyze_files(paths: Sequence[str]) -> Tuple[LockOrder, List[Finding]]:
    graph = LockOrder([SourceFile.load(p) for p in paths])
    graph.build()
    return graph, graph.check()


def load_static_edges(graph_json_path: str) -> Set[Tuple[str, str]]:
    """Edge set from a committed lock_order.json, for the runtime witness."""
    with open(graph_json_path) as f:
        doc = json.load(f)
    return {(e["src"], e["dst"]) for e in doc["edges"]}
