"""Lock-discipline linter (stdlib-ast) for the port's concurrent runtime.

Two rules, both scoped by lightweight in-source declarations:

1. **Guarded fields.**  A field declared ``# guarded by: _lock`` on its
   assignment line (or listed in a class-level ``_GUARDED`` dict) may only be
   touched lexically inside ``with self._lock`` (holding the Condition built
   on a lock counts as holding the lock).  Exemptions: ``__init__`` /
   ``__post_init__`` (happens-before publication), methods named ``*_locked``
   (documented caller-holds-the-lock helpers), and reasoned inline
   suppressions.  Cross-object accesses (``b.queue`` from the router) are
   checked too when the field name is unambiguous across analyzed classes.

2. **No blocking under a strict lock.**  While a lock is held, calls that can
   block -- ``Condition.wait`` (on a *different* primitive), ``Future.result``,
   ``Thread.join``, ``Popen.communicate``, ``subprocess.run``,
   ``time.sleep`` -- and device dispatch (``step``/``generate``/
   ``prefill*``/``decode*``/``verify*``, and the host-device syncs
   ``synchronize``/``item``/``tolist``/``cpu``/``numpy``) are findings.
   This is what makes the engine's "never block the step-loop registry
   lock" rule and ``capacity_now()``'s lock-free-snapshot contract
   machine-checked.  A lock whose *contract* is to be held across device
   work (the engine's coarse step RLock: one stepper owns the cache) opts
   out once, visibly, at its declaration with
   ``# locklint: blocking-ok <reason>``.

**Module-level locks.**  A ``name = threading.Lock()`` at module scope is a
lock of its module, taken as ``with name:`` there (or ``with mod.name:``
from another analyzed module).  Module globals declared
``# guarded by: name`` are checked like guarded fields, and a module-level
``_GUARDED = {"attr": "name"}`` guards ``<any object>.attr`` inside that
module's functions (the kernel wrappers' launch counters).  The declaration
takes the same ``blocking-ok`` opt-out.  Under a strict module lock, a call
to a function of the same module counts as the blocking calls that function
(transitively) makes: a module lock is typically held across a module-local
helper (``library()`` around ``build()``).

Suppress a single site with ``# locklint: ok <reason>``.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .common import (
    Finding,
    SourceFile,
    apply_suppression,
    dotted_name,
    guarded_decl,
    unparse,
)

TOOL = "locklint"

LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
#: attribute names treated as lock-like even without a visible declaration
LOCKISH = re.compile(r"(^|_)(lock|cond|mutex)$")
BLOCKING_ATTRS = {"wait", "join", "result", "communicate"}
#: blocking calls spelled as a dotted module function
BLOCKING_FUNCS = {"time.sleep", "subprocess.run"}
#: device dispatch: the names the serving stack uses for model calls, and
#: the calls that wait for the card (host-device syncs)
DEVICE_DISPATCH = re.compile(
    r"^(step|step_once|generate|block_until_ready|device_put"
    r"|synchronize|item|tolist|cpu|numpy"
    r"|_?prefill\w*|_?decode\w*|_?verify\w*|_install_carry|_copy_fork)$"
)


def module_name(src: SourceFile) -> str:
    """A source's module name for lock ids: its file stem (``_build``)."""
    return Path(src.path).stem


@dataclass
class LockDecl:
    cls: str               # owning class name (the module's name for module-level)
    attr: str              # attribute (or global) name
    kind: str              # Lock | RLock | Condition | ...
    line: int
    policy: str = "strict"          # strict | blocking-ok
    policy_reason: str = ""
    cond_base: Optional[str] = None  # for Condition(self.X) / Condition(X): X


@dataclass
class ClassLocks:
    name: str
    bases: List[str] = field(default_factory=list)
    locks: Dict[str, LockDecl] = field(default_factory=dict)
    guarded: Dict[str, str] = field(default_factory=dict)  # field -> lock attr

    def lock_group(self, attr: str) -> Set[str]:
        """All attr names equivalent to holding ``attr`` (a Condition and its
        base lock are the same underlying mutex)."""
        group = {attr}
        decl = self.locks.get(attr)
        if decl and decl.cond_base:
            group.add(decl.cond_base)
        for other in self.locks.values():
            if other.cond_base and other.cond_base in group:
                group.add(other.attr)
        return group


@dataclass
class ModuleLocks(ClassLocks):
    """A module's own locks: ``guarded`` maps module globals to their lock,
    ``guarded_attrs`` maps attribute names (any object's, inside this
    module's functions) to theirs, ``funcs`` holds the module-level defs."""
    guarded_attrs: Dict[str, str] = field(default_factory=dict)
    funcs: Dict[str, ast.FunctionDef] = field(default_factory=dict)


def collect_lock_decls(sources: Sequence[SourceFile]) -> Dict[str, ClassLocks]:
    """First pass over all modules: lock declarations, policies, guarded
    fields.  Keyed by class name (assumed unique across the analyzed set --
    true for this repo, and ambiguity would only widen checks)."""
    classes: Dict[str, ClassLocks] = {}
    for src in sources:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            info = classes.setdefault(node.name, ClassLocks(node.name))
            for b in node.bases:
                base = dotted_name(b)
                if base:
                    info.bases.append(base.split(".")[-1])
            _collect_class(src, node, info)
    return classes


def collect_module_locks(sources: Sequence[SourceFile]) -> Dict[str, ModuleLocks]:
    """Module-level locks, guarded globals and ``_GUARDED`` attribute maps,
    keyed by module name; modules with no lock of their own are left out,
    so a module lock never aliases a class attribute of the same name."""
    out: Dict[str, ModuleLocks] = {}
    for src in sources:
        mod = ModuleLocks(module_name(src))
        for stmt in src.tree.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                mod.funcs[stmt.name] = stmt
            if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                continue
            target = stmt.target if isinstance(stmt, ast.AnnAssign) else (
                stmt.targets[0] if len(stmt.targets) == 1 else None)
            if not isinstance(target, ast.Name):
                continue
            if target.id == "_GUARDED" and isinstance(stmt.value, ast.Dict):
                for k, v in zip(stmt.value.keys, stmt.value.values):
                    if isinstance(k, ast.Constant) and isinstance(v, ast.Constant):
                        mod.guarded_attrs[str(k.value)] = str(v.value)
                continue
            decl = _lock_factory(stmt.value)
            if decl is not None:
                kind, cond_base = decl
                mod.locks[target.id] = _declare(src, mod.name, target.id, kind,
                                                stmt.lineno, cond_base)
                continue
            lock_attr = guarded_decl(src.comment_at(stmt.lineno))
            if lock_attr:
                mod.guarded[target.id] = lock_attr
        if mod.locks:
            out[mod.name] = mod
    return out


def class_families(classes: Dict[str, ClassLocks]) -> Dict[str, Set[str]]:
    """Union-find over inheritance among analyzed classes: ``self.lock`` in a
    base class resolves against declarations made anywhere in its family
    (e.g. ``_EngineBase`` methods use the RLock its subclasses create)."""
    parent: Dict[str, str] = {n: n for n in classes}

    def find(x: str) -> str:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for name, info in classes.items():
        for b in info.bases:
            if b in classes:
                parent[find(name)] = find(b)
    families: Dict[str, Set[str]] = {}
    for name in classes:
        families.setdefault(find(name), set()).add(name)
    return {name: families[find(name)] for name in classes}


def family_lock_decls(classes: Dict[str, ClassLocks],
                      families: Dict[str, Set[str]],
                      cls_name: str, attr: str) -> List[LockDecl]:
    """All declarations of ``self.<attr>`` visible to ``cls_name`` through its
    inheritance family, declaring-class-sorted for determinism."""
    out = []
    for member in sorted(families.get(cls_name, {cls_name})):
        info = classes.get(member)
        if info is not None and attr in info.locks:
            out.append(info.locks[attr])
    return out


def _declare(src: SourceFile, owner: str, attr: str, kind: str, line: int,
             cond_base: Optional[str]) -> LockDecl:
    ld = LockDecl(cls=owner, attr=attr, kind=kind, line=line, cond_base=cond_base)
    comment = src.comment_at(line)
    if comment.startswith(f"{TOOL}: blocking-ok"):
        ld.policy = "blocking-ok"
        ld.policy_reason = comment[len(f"{TOOL}: blocking-ok"):].strip()
    return ld


def _collect_class(src: SourceFile, cls: ast.ClassDef, info: ClassLocks) -> None:
    for stmt in cls.body:
        # class-level _GUARDED = {"field": "_lock"}
        if isinstance(stmt, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "_GUARDED" for t in stmt.targets
        ):
            if isinstance(stmt.value, ast.Dict):
                for k, v in zip(stmt.value.keys, stmt.value.values):
                    if isinstance(k, ast.Constant) and isinstance(v, ast.Constant):
                        info.guarded[str(k.value)] = str(v.value)
        # dataclass field line: queue: Deque = field(...)  # guarded by: cond
        if isinstance(stmt, (ast.AnnAssign, ast.Assign)):
            target = stmt.target if isinstance(stmt, ast.AnnAssign) else (
                stmt.targets[0] if stmt.targets else None
            )
            if isinstance(target, ast.Name):
                lock_attr = guarded_decl(src.comment_at(stmt.lineno))
                if lock_attr:
                    info.guarded[target.id] = lock_attr

    for fn in [n for n in ast.walk(cls) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
        for stmt in ast.walk(fn):
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                target = stmt.target if isinstance(stmt, ast.AnnAssign) else (
                    stmt.targets[0] if len(getattr(stmt, "targets", [])) == 1 else None
                )
                if not (
                    isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"
                ):
                    continue
                attr = target.attr
                value = stmt.value
                decl = _lock_factory(value)
                if decl is not None:
                    kind, cond_base = decl
                    info.locks[attr] = _declare(src, info.name, attr, kind, stmt.lineno, cond_base)
                else:
                    lock_attr = guarded_decl(src.comment_at(stmt.lineno))
                    if lock_attr:
                        info.guarded[attr] = lock_attr


def _lock_factory(value: Optional[ast.AST]) -> Optional[Tuple[str, Optional[str]]]:
    """(kind, condition_base) when ``value`` constructs a threading
    primitive, else None. The base is ``X`` of ``Condition(self.X)`` or of a
    module-level ``Condition(X)``."""
    if not isinstance(value, ast.Call):
        return None
    name = dotted_name(value.func) or ""
    leaf = name.split(".")[-1]
    if leaf not in LOCK_FACTORIES:
        return None
    cond_base = None
    if leaf == "Condition" and value.args:
        arg = value.args[0]
        if (isinstance(arg, ast.Attribute) and isinstance(arg.value, ast.Name)
                and arg.value.id == "self"):
            cond_base = arg.attr
        elif isinstance(arg, ast.Name):
            cond_base = arg.id
    return leaf, cond_base


@dataclass
class _Held:
    expr: str            # source text of the with item, e.g. "self._lock", "b.cond", "_lock"
    base: str            # "self" / "b" / the module's name for a module lock
    attr: str            # "_lock" / "cond"
    policy: str          # strict | blocking-ok
    module: bool = False  # a module-level lock


def _local_names(fn: ast.FunctionDef) -> Set[str]:
    """Names a function binds itself (parameters and assignments, less
    those it declares ``global``): these shadow module globals."""
    names = {a.arg for a in fn.args.args + fn.args.kwonlyargs + fn.args.posonlyargs}
    for extra in (fn.args.vararg, fn.args.kwarg):
        if extra is not None:
            names.add(extra.arg)
    declared: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Global):
            declared.update(node.names)
        elif isinstance(node, ast.Name) and isinstance(node.ctx, (ast.Store, ast.Del)):
            names.add(node.id)
    return names - declared


class _FunctionLinter(ast.NodeVisitor):
    """Walks one method body tracking the lexically-held lock set."""

    def __init__(self, analyzer: "LockLint", src: SourceFile,
                 cls: Optional[ClassLocks], fn: ast.FunctionDef):
        self.a = analyzer
        self.src = src
        self.cls = cls
        self.fn = fn
        self.mod = analyzer.modules.get(module_name(src))
        self.locals = _local_names(fn) if self.mod is not None else set()
        self.held: List[_Held] = []
        self.reported: Set[Tuple[int, str]] = set()
        self.exempt_guarded = (
            fn.name in ("__init__", "__post_init__")
            or fn.name.endswith("_locked")
        )

    # -- lock scope tracking ------------------------------------------------
    def visit_With(self, node: ast.With) -> None:
        pushed = 0
        for item in node.items:
            held = self.a.as_lock(item.context_expr, self.cls, self.src)
            if held is not None:
                self.held.append(held)
                pushed += 1
        for stmt in node.body:
            self.visit(stmt)
        for _ in range(pushed):
            self.held.pop()

    visit_AsyncWith = visit_With  # pragma: no cover - no async in the stack

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # a nested def runs later, outside this lexical lock scope
        saved, self.held = self.held, []
        for stmt in node.body:
            self.visit(stmt)
        self.held = saved

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        saved, self.held = self.held, []
        self.visit(node.body)
        self.held = saved

    # -- rule 1: guarded fields --------------------------------------------
    def visit_Attribute(self, node: ast.Attribute) -> None:
        self.generic_visit(node)
        base = unparse(node.value)
        lock_attr, owner = self.a.guard_for(base, node.attr, self.cls)
        if lock_attr is not None and not self.exempt_guarded:
            group = owner.lock_group(lock_attr)
            if not any(h.base == base and h.attr in group for h in self.held):
                self._guard_finding(node.lineno, f"{base}.{node.attr}",
                                    f"{base}.{node.attr} is guarded by {base}.{lock_attr} "
                                    f"(declared on {owner.name})", f"`with {base}.{lock_attr}`")
        self._module_attr_guard(node, base)

    def visit_Name(self, node: ast.Name) -> None:
        mod = self.mod
        if mod is None or self.exempt_guarded or node.id in self.locals:
            return
        lock = mod.guarded.get(node.id)
        if lock is not None:
            self._module_guard(node.lineno, mod, node.id, lock, node.id)

    def _module_attr_guard(self, node: ast.Attribute, base: str) -> None:
        """``<object>.attr`` under a module's ``_GUARDED`` map, and
        ``<module>.<global>`` from another analyzed module."""
        if self.exempt_guarded:
            return
        if self.mod is not None and node.attr in self.mod.guarded_attrs:
            self._module_guard(node.lineno, self.mod, f"{base}.{node.attr}",
                               self.mod.guarded_attrs[node.attr], f"{base}.{node.attr}")
        other = self.a.modules.get(base)
        if other is not None and other is not self.mod and node.attr in other.guarded:
            self._module_guard(node.lineno, other, f"{base}.{node.attr}",
                               other.guarded[node.attr], f"{base}.{node.attr}")

    def _module_guard(self, line: int, mod: ModuleLocks, what: str, lock: str, key: str) -> None:
        group = mod.lock_group(lock)
        if any(h.module and h.base == mod.name and h.attr in group for h in self.held):
            return
        self._guard_finding(line, key, f"{what} is guarded by {mod.name}.{lock} "
                                       f"(module-level)", f"`with {lock}`")

    def _guard_finding(self, line: int, key: str, what: str, with_: str) -> None:
        k = (line, f"guard:{key}")
        if k in self.reported:
            return
        self.reported.add(k)
        self.a.report(self.src, line, "guarded-field",
                      f"{what} but accessed outside {with_} in {self._where()}")

    # -- rule 2: blocking under a strict lock ------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        self.generic_visit(node)
        strict = [h for h in self.held if h.policy == "strict"]
        if not strict:
            return
        label = blocking_label(node, [h.expr for h in self.held])
        if label is None and any(h.module for h in strict):
            label = self._through_module_helper(node)
        if label is None:
            return
        key = (node.lineno, f"block:{label}")
        if key in self.reported:
            return
        self.reported.add(key)
        held_desc = ", ".join(h.expr for h in strict)
        self.a.report(
            self.src, node.lineno, "blocking-under-lock",
            f"{label} while holding {held_desc} in {self._where()}; "
            f"a strict lock must never be held across blocking or device work",
        )

    def _through_module_helper(self, node: ast.Call) -> Optional[str]:
        """A module-local function called under a strict module lock, that
        blocks itself or through other module-local functions."""
        if not (isinstance(node.func, ast.Name) and self.mod is not None):
            return None
        hit = self.a.module_blocking(self.mod, node.func.id, set())
        if hit is None:
            return None
        return f"{node.func.id}() reaching {hit[0]} (line {hit[1]})"

    def _where(self) -> str:
        owner = f"{self.cls.name}." if self.cls else ""
        return f"{owner}{self.fn.name}"


def blocking_label(node: ast.Call, held_exprs: Sequence[str]) -> Optional[str]:
    """What makes ``node`` a blocking call, or None. A ``.wait()`` on a held
    condition releases it: the one legal blocking wait under a lock."""
    func = node.func
    if isinstance(func, ast.Name):
        return "time.sleep(...)" if func.id == "sleep" else None
    if not isinstance(func, ast.Attribute):
        return None
    dotted = dotted_name(func) or ""
    if dotted in BLOCKING_FUNCS:
        return f"{dotted}(...)"
    attr = func.attr
    if attr in BLOCKING_ATTRS:
        if attr == "wait" and unparse(func.value) in held_exprs:
            return None
        if attr == "join" and (dotted == "os.path.join" or isinstance(func.value, ast.Constant)):
            return None    # a path or a string, not a thread
        return f"blocking call .{attr}(...)"
    if DEVICE_DISPATCH.match(attr):
        return f"device dispatch .{attr}(...)"
    return None


class LockLint:
    def __init__(self, sources: Sequence[SourceFile]):
        self.sources = list(sources)
        self.classes = collect_lock_decls(self.sources)
        self.modules = collect_module_locks(self.sources)
        self.families = class_families(self.classes)
        # field name -> owning ClassLocks, for cross-object checks; ambiguous
        # names (declared guarded in >1 class) are dropped rather than guessed.
        counts: Dict[str, List[ClassLocks]] = {}
        for info in self.classes.values():
            for f in info.guarded:
                counts.setdefault(f, []).append(info)
        self.global_guarded = {f: owners[0] for f, owners in counts.items()
                               if len(owners) == 1}
        self.findings: List[Finding] = []
        self._blocking_memo: Dict[Tuple[str, str], Optional[Tuple[str, int]]] = {}

    # -- declaration lookups ------------------------------------------------
    def as_lock(self, expr: ast.AST, cls: Optional[ClassLocks],
                src: Optional[SourceFile] = None) -> Optional[_Held]:
        """Classify a with-item as a held lock, resolving its policy."""
        module_decl = self.module_lock(expr, src)
        if module_decl is not None:
            mod, decl = module_decl
            return _Held(expr=unparse(expr), base=mod.name, attr=decl.attr,
                         policy=decl.policy, module=True)
        if not isinstance(expr, ast.Attribute):
            return None
        base = unparse(expr.value)
        attr = expr.attr
        decls: List[LockDecl] = []
        if base == "self" and cls is not None:
            decls = family_lock_decls(self.classes, self.families, cls.name, attr)
        if not decls:
            owners = [c.locks[attr] for c in self.classes.values() if attr in c.locks]
            if len(owners) == 1:
                decls = owners
        if not decls and not LOCKISH.search(attr):
            return None
        # a lock is only blocking-ok if every declaration in scope says so
        policy = ("blocking-ok"
                  if decls and all(d.policy == "blocking-ok" for d in decls)
                  else "strict")
        return _Held(expr=unparse(expr), base=base, attr=attr, policy=policy)

    def module_lock(self, expr: ast.AST,
                    src: Optional[SourceFile]) -> Optional[Tuple[ModuleLocks, LockDecl]]:
        """(module, declaration) when ``expr`` names a module-level lock:
        ``_lock`` in its own module, ``mod._lock`` from another."""
        if isinstance(expr, ast.Name) and src is not None:
            mod = self.modules.get(module_name(src))
            if mod is not None and expr.id in mod.locks:
                return mod, mod.locks[expr.id]
        if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name):
            mod = self.modules.get(expr.value.id)
            if mod is not None and expr.attr in mod.locks:
                return mod, mod.locks[expr.attr]
        return None

    def guard_for(self, base: str, attr: str,
                  cls: Optional[ClassLocks]) -> Tuple[Optional[str], Optional[ClassLocks]]:
        if base == "self" and cls is not None:
            for member in sorted(self.families.get(cls.name, {cls.name})):
                info = self.classes.get(member)
                if info is not None and attr in info.guarded:
                    return info.guarded[attr], info
            return None, None
        owner = self.global_guarded.get(attr)
        if owner is not None and owner is not cls:
            return owner.guarded[attr], owner
        return None, None

    def module_blocking(self, mod: ModuleLocks, name: str,
                        seen: Set[str]) -> Optional[Tuple[str, int]]:
        """(label, line) of the first blocking call that module function
        ``name`` makes, itself or through module-local calls; None if none."""
        key = (mod.name, name)
        if key in self._blocking_memo:
            return self._blocking_memo[key]
        fn = mod.funcs.get(name)
        if fn is None or name in seen:
            return None
        seen = seen | {name}
        hit = None
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            label = blocking_label(node, ())
            if label is not None:
                hit = (label, node.lineno)
            elif isinstance(node.func, ast.Name):
                hit = self.module_blocking(mod, node.func.id, seen)
            if hit is not None:
                break
        self._blocking_memo[key] = hit
        return hit

    # -- driving ------------------------------------------------------------
    def run(self) -> List[Finding]:
        for src in self.sources:
            self._lint_module(src)
        return self.findings

    def _lint_module(self, src: SourceFile) -> None:
        for node in src.tree.body:
            self._lint_node(src, node, cls=None)

    def _lint_node(self, src: SourceFile, node: ast.AST, cls: Optional[ClassLocks]) -> None:
        if isinstance(node, ast.ClassDef):
            info = self.classes.get(node.name)
            for child in node.body:
                self._lint_node(src, child, cls=info)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            linter = _FunctionLinter(self, src, cls, node)
            for stmt in node.body:
                linter.visit(stmt)

    def report(self, src: SourceFile, line: int, code: str, message: str) -> None:
        f = Finding(tool=TOOL, path=src.path, line=line, code=code, message=message)
        self.findings.append(apply_suppression(src, f))


def lint_files(paths: Sequence[str]) -> List[Finding]:
    return LockLint([SourceFile.load(p) for p in paths]).run()
