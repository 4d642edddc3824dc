"""Kernel-family contract checker for the port's CUDA wrappers
(``src/repro_torch/kernels/*``).

The port's layout rule (``kernels/__init__``): every family ships ``ops.py``
(the model-facing wrapper: the plain version on a CPU tensor, the CUDA
kernel of ``kernels/csrc/`` on a CUDA tensor, or a raise) and ``ref.py``
(the plain PyTorch version). The wrapper calls a C entry point of the
kernel library through a module-level ``_build.Entry("rt_...")``. Around
that call the port has ground rules that type-check fine and still break
the port: a silent fallback hides a kernel that does not run, an
unchecked entry hides a refused launch, an uncounted launch hides a path
that never reached the kernel. Checked here, each under its own code:

- **missing-ref** / **empty-ref**: a family with ``ops.py`` has a
  ``ref.py`` that defines (or re-exports) its plain version.
- **missing-entry-source**: every ``_build.Entry("rt_...")`` name is an
  ``extern "C"`` function of ``kernels/csrc/*.cu``.
- **entry-no-last-error**: an ``extern "C"`` function that launches
  (``<<<``, itself or through a function of its translation unit) returns
  ``cudaGetLastError()``: every launch site is followed by a
  ``cudaGetLastError()`` in its function, or is a call to a function that
  does so whose value the caller returns or assigns.
- **entry-unchecked** / **uncounted-launch**: a Python function that calls
  an entry passes the entry's result to ``_build.check`` and calls
  ``_build.count_launch``.
- **fallback-around-kernel**: no ``try`` around an entry call (or around a
  call of a function that calls one), and no ``except`` handler that calls
  the plain version (a name imported from a ``ref`` module, or a function
  named ``*_ref`` / ``_plain*``).
- **env-switch**: no ``os.environ`` / ``os.getenv`` in an ``ops.py``: the
  device of the tensor decides, nothing else.
- **dtensor-unrefused** (``check_dtensor``, the port's rule on top of the
  contract): every public function of an ``ops.py`` that reaches a launch
  calls ``_build.refuse_dtensor`` (itself, or through a module function it
  calls by its bare name): a DTensor's storage is one rank's block, so a
  kernel handed one would compute on the wrong tensor; sharded callers
  launch on each rank's block inside ``local_map``.
- **inplace-copy**: a pool-like operand (``POOL_NAME``) reaches an entry
  only as itself: never rebound in the wrapper, never through
  ``.contiguous()``, ``.clone()`` or ``.to(...)``; a wrapper that hands a
  pool to a mutable pointer of the entry (a pool write) returns the pool
  tensors it was given.
- **missing-card-test**: ``tests/test_torch_cuda.py`` imports the family's
  ``ops``.
- **missing-jax-parity-test**: some ``tests/test_torch_*.py`` imports both
  the family's port ``ref`` (or ``ops``) and ``repro.kernels.<family>``.

Suppress a Python site with ``# kernelcheck: ok <reason>`` and a CUDA site
with ``// kernelcheck: ok <reason>`` on the offending line.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .common import Finding, SourceFile, apply_suppression, dotted_name

TOOL = "kernelcheck"

#: operand names that denote a persistent KV/state pool (updated in place)
POOL_NAME = re.compile(r"(pool|cache|_kv|kv_|scales|state)", re.IGNORECASE)
#: calls that make a new tensor of an operand
COPYING = {"contiguous", "clone", "to"}
PORT_PKG = "repro_torch.kernels"
JAX_PKG = "repro.kernels"


# ---------------------------------------------------------------------------
# CUDA sources: functions, their launches and their extern "C" entries
# ---------------------------------------------------------------------------


@dataclass
class CFunction:
    name: str
    path: str
    body: str                      # text between the braces, comments blanked
    body_offset: int               # offset of body[0] in the file
    extern_c: bool
    params: List[str] = field(default_factory=list)


_C_HEADER = re.compile(r"([A-Za-z_]\w*)\s*\(([^;{}()]*(?:\([^;{}()]*\)[^;{}()]*)*)\)\s*(?:const\s*)?\{")
_C_KEYWORDS = {"if", "for", "while", "switch", "catch", "return", "sizeof", "defined"}
_CALL = re.compile(r"\b([A-Za-z_]\w*)\s*(?:<[^;(){}<>]*(?:<[^;(){}<>]*>[^;(){}<>]*)*>)?\s*\(")
_INCLUDE = re.compile(r'#include\s+"([^"]+)"')


def _blank_comments(text: str) -> str:
    """Comments replaced by spaces (newlines kept), so offsets and line
    numbers survive; string literals are left alone."""
    out = list(text)
    i, n = 0, len(text)
    while i < n:
        if text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            out[i:j] = " " * (j - i)
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out[i:j] = [c if c == "\n" else " " for c in text[i:j]]
            i = j
        elif text[i] == '"':
            j = i + 1
            while j < n and text[j] != '"':
                j += 2 if text[j] == "\\" else 1
            i = j + 1
        else:
            i += 1
    return "".join(out)


def _match_brace(text: str, open_at: int) -> int:
    depth = 0
    for j in range(open_at, len(text)):
        if text[j] == "{":
            depth += 1
        elif text[j] == "}":
            depth -= 1
            if depth == 0:
                return j
    return len(text)


def parse_c_functions(path: str, text: str) -> List[CFunction]:
    """Function definitions of a CUDA source by a brace scan: a ``name(...)
    {`` whose name is not a keyword, at namespace scope (bodies are
    skipped once matched, so a statement inside one is never taken for a
    definition)."""
    clean = _blank_comments(text)
    funcs: List[CFunction] = []
    pos = 0
    while True:
        m = _C_HEADER.search(clean, pos)
        if m is None:
            return funcs
        name = m.group(1)
        open_at = m.end() - 1
        if name in _C_KEYWORDS:
            pos = m.end()
            continue
        close = _match_brace(clean, open_at)
        start = max(clean.rfind(";", 0, m.start()), clean.rfind("}", 0, m.start()),
                    clean.rfind("{", 0, m.start())) + 1
        prefix = clean[start:m.start()]
        params = [p.strip() for p in m.group(2).split(",") if p.strip()]
        funcs.append(CFunction(name=name, path=path, body=clean[open_at + 1:close],
                               body_offset=open_at + 1,
                               extern_c='extern "C"' in prefix, params=params))
        pos = close + 1


class CUnit:
    """One translation unit: a ``.cu`` file and the ``csrc`` headers it
    includes. Answers which functions launch and which check their
    launches."""

    def __init__(self, cu: Path):
        self.path = cu
        texts = {cu: cu.read_text()}
        todo = [cu]
        while todo:
            cur = todo.pop()
            for inc in _INCLUDE.findall(texts[cur]):
                p = cu.parent / inc
                if p.exists() and p not in texts:
                    texts[p] = p.read_text()
                    todo.append(p)
        self.text = texts[cu]
        self.funcs: Dict[str, List[CFunction]] = {}
        for p, t in texts.items():
            for f in parse_c_functions(str(p), t):
                self.funcs.setdefault(f.name, []).append(f)
        self._launches: Dict[str, bool] = {}
        self._checked: Dict[str, bool] = {}

    def launches(self, name: str, seen: frozenset = frozenset()) -> bool:
        """Whether any definition of ``name`` launches, itself or through
        a function of this unit."""
        if name in self._launches:
            return self._launches[name]
        if name in seen or name not in self.funcs:
            return False
        hit = any("<<<" in f.body or any(self.launches(c, seen | {name}) for c, _ in self.calls(f))
                  for f in self.funcs[name])
        self._launches[name] = hit
        return hit

    def calls(self, f: CFunction) -> List[Tuple[str, int]]:
        """(callee, offset in the body) of calls to functions of this unit."""
        return [(m.group(1), m.start()) for m in _CALL.finditer(f.body)
                if m.group(1) in self.funcs and m.group(1) != f.name]

    def launch_sites(self, f: CFunction) -> List[Tuple[str, int]]:
        """(what, offset) of every launch in ``f``: a ``<<<`` or a call of a
        launching function."""
        sites = [("<<<", m.start()) for m in re.finditer("<<<", f.body)]
        sites += [(c, at) for c, at in self.calls(f) if self.launches(c)]
        return sorted(sites, key=lambda s: s[1])

    def unchecked_site(self, f: CFunction, seen: frozenset = frozenset()) -> Optional[Tuple[str, int]]:
        """The first launch site of ``f`` not followed by a
        ``cudaGetLastError()`` in ``f`` and not a returned or assigned call
        of a checking function; None when every site is checked."""
        for what, at in self.launch_sites(f):
            if "cudaGetLastError()" in f.body[at:]:
                continue
            if what != "<<<" and self._value_used(f.body, at) and self.checked(what, seen | {f.name}):
                continue
            return what, at
        return None

    def checked(self, name: str, seen: frozenset = frozenset()) -> bool:
        if name in self._checked:
            return self._checked[name]
        if name in seen:
            return False
        ok = all(self.unchecked_site(f, seen) is None for f in self.funcs.get(name, []))
        self._checked[name] = ok
        return ok

    @staticmethod
    def _value_used(body: str, at: int) -> bool:
        """The call at ``at`` is returned or assigned (its statement starts
        with ``return`` or holds an ``=`` before the call)."""
        stmt = body[max(body.rfind(";", 0, at), body.rfind("{", 0, at), body.rfind("}", 0, at)) + 1:at]
        return bool(re.search(r"\breturn\b", stmt) or re.search(r"(?<![=!<>])=(?!=)", stmt))

    def entries(self) -> List[CFunction]:
        return [f for fs in self.funcs.values() for f in fs
                if f.extern_c and f.path == str(self.path)]


def _c_suppressed(text: str, line: int) -> Optional[str]:
    """The reason of a ``// kernelcheck: ok <reason>`` on ``line``; "" when
    the reason is missing; None when there is no such comment."""
    lines = text.splitlines()
    if not 1 <= line <= len(lines):
        return None
    m = re.search(r"//\s*kernelcheck:\s*ok\b(.*)$", lines[line - 1])
    return None if m is None else m.group(1).strip()


# ---------------------------------------------------------------------------
# Python wrappers
# ---------------------------------------------------------------------------


def _ref_exports(src: SourceFile) -> Set[str]:
    """What a family's ref.py offers: local defs, re-exports and public
    assignments."""
    out: Set[str] = set()
    for node in src.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.update(alias.asname or alias.name for alias in node.names)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name) and not t.id.startswith("_"))
    return out


def _imports(src: SourceFile) -> Set[str]:
    """Every module a file imports, anywhere in it, ``from a import b``
    counted as both ``a`` and ``a.b`` (b may be a submodule)."""
    out: Set[str] = set()
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Import):
            out.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
            out.update(f"{node.module}.{alias.name}" for alias in node.names)
    return out


def _entries(src: SourceFile) -> Dict[str, Tuple[str, int]]:
    """Module-level ``NAME = _build.Entry("rt_...", ...)``: NAME -> (C name, line)."""
    out = {}
    for node in src.tree.body:
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name) and isinstance(node.value, ast.Call)):
            continue
        callee = dotted_name(node.value.func) or ""
        if callee.split(".")[-1] == "Entry" and node.value.args and isinstance(
                node.value.args[0], ast.Constant) and isinstance(node.value.args[0].value, str):
            out[node.targets[0].id] = (node.value.args[0].value, node.lineno)
    return out


def _entry_call(node: ast.AST, entries: Dict[str, Tuple[str, int]]) -> Optional[str]:
    """The entry a call invokes (``(E.fn or E.resolve())(...)``,
    ``E.fn(...)``, ``E.resolve()(...)``), or None. ``E.resolve()`` alone
    is not a launch."""
    if not isinstance(node, ast.Call):
        return None
    func = node.func
    if isinstance(func, ast.Attribute) and func.attr == "resolve":
        return None
    for sub in ast.walk(func):
        if isinstance(sub, ast.Name) and sub.id in entries:
            return sub.id
    return None


def _callee_leaf(call: ast.Call) -> str:
    return (dotted_name(call.func) or "").split(".")[-1]


def _plain_names(src: SourceFile) -> Set[str]:
    """The plain versions a wrapper module can reach: names imported from a
    ``ref`` module, and its own functions named ``*_ref`` or ``_plain*``."""
    out: Set[str] = set()
    for node in src.tree.body:
        if isinstance(node, ast.ImportFrom) and node.module and node.module.split(".")[-1] == "ref":
            out.update(alias.asname or alias.name for alias in node.names)
        elif isinstance(node, ast.FunctionDef) and (
                node.name.endswith("_ref") or node.name.startswith("_plain")):
            out.add(node.name)
    return out


class KernelCheck:
    def __init__(self, kernels_root: str, tests_root: str):
        self.kernels_root = Path(kernels_root)
        self.csrc = self.kernels_root / "csrc"
        self.tests_root = Path(tests_root)
        self.findings: List[Finding] = []

    def run(self) -> List[Finding]:
        units = [CUnit(p) for p in sorted(self.csrc.glob("*.cu"))] if self.csrc.is_dir() else []
        exported = {f.name: (u, f) for u in units for f in u.entries()}
        for u in units:
            self._check_unit(u)
        tests = {p.name: SourceFile.load(p) for p in sorted(self.tests_root.glob("test_torch_*.py"))}
        test_imports = {name: _imports(src) for name, src in tests.items()}
        for name in families(str(self.kernels_root)):
            self._check_family(self.kernels_root / name, exported, test_imports)
        return self.findings

    # -- CUDA entries -------------------------------------------------------
    def _check_unit(self, unit: CUnit) -> None:
        for f in unit.entries():
            if not unit.launches(f.name):
                continue
            bad = unit.unchecked_site(f)
            if bad is None:
                continue
            what, at = bad
            line = unit.text.count("\n", 0, f.body_offset + at) + 1
            site = "a <<< launch" if what == "<<<" else f"the launch through {what}()"
            self._c_report(unit, line, "entry-no-last-error",
                           f"extern \"C\" {f.name}: {site} is not followed by cudaGetLastError() "
                           f"nor returned from a function that checks it; a refused launch "
                           f"would go unreported")

    def _c_report(self, unit: CUnit, line: int, code: str, message: str) -> None:
        f = Finding(tool=TOOL, path=str(unit.path), line=line, code=code, message=message)
        reason = _c_suppressed(unit.text, line)
        if reason == "":
            f.code = "bad-suppression"
            f.message += " (suppression comment present but missing a reason)"
        elif reason is not None:
            f.suppressed, f.reason = True, reason
        self.findings.append(f)

    # -- families -----------------------------------------------------------
    def _check_family(self, fam: Path, exported: Dict[str, Tuple[CUnit, CFunction]],
                      test_imports: Dict[str, Set[str]]) -> None:
        name = fam.name
        ops = SourceFile.load(fam / "ops.py")
        ref_py = fam / "ref.py"
        if not ref_py.exists():
            self._report(ops, 1, "missing-ref",
                         f"family {name} has no ref.py: its plain version is missing")
        else:
            rsrc = SourceFile.load(ref_py)
            if not _ref_exports(rsrc):
                self._report(rsrc, 1, "empty-ref", f"family {name}: ref.py defines no plain version")

        entries = _entries(ops)
        for var, (cname, line) in sorted(entries.items()):
            if cname not in exported:
                self._report(ops, line, "missing-entry-source",
                             f"{var} = Entry(\"{cname}\"): no extern \"C\" {cname} in "
                             f"{self.csrc.name}/*.cu")
        self._check_env(ops)
        plain = _plain_names(ops)
        fns = [n for n in ops.tree.body if isinstance(n, ast.FunctionDef)]
        direct = {n.name for n in fns if any(_entry_call(c, entries) for c in ast.walk(n))}
        reaching = _reaching(fns, direct)
        for fn in fns:
            self._check_fallback(ops, fn, entries, reaching, plain)
            if fn.name in direct:
                self._check_wrapper(ops, fn, entries, exported)

        port_side = {f"{PORT_PKG}.{name}.ops", f"{PORT_PKG}.{name}.ref"}
        card = test_imports.get("test_torch_cuda.py", set())
        if f"{PORT_PKG}.{name}.ops" not in card:
            self._report(ops, 1, "missing-card-test",
                         f"family {name}: tests/test_torch_cuda.py does not import its ops")
        jax_mod = f"{JAX_PKG}.{name}"
        if not any(port_side & imps and any(m == jax_mod or m.startswith(jax_mod + ".") for m in imps)
                   for imps in test_imports.values()):
            self._report(ops, 1, "missing-jax-parity-test",
                         f"family {name}: no tests/test_torch_*.py imports both its port ref/ops "
                         f"and {jax_mod}")

    def _check_env(self, src: SourceFile) -> None:
        for node in ast.walk(src.tree):
            name = None
            if isinstance(node, ast.Attribute) and dotted_name(node) in ("os.environ", "os.getenv"):
                name = dotted_name(node)
            elif isinstance(node, ast.ImportFrom) and node.module == "os" and any(
                    a.name in ("environ", "getenv") for a in node.names):
                name = "from os import environ/getenv"
            if name:
                self._report(src, node.lineno, "env-switch",
                             f"{name} in a wrapper: an environment switch can route a card "
                             f"tensor around its kernel")

    def _check_fallback(self, src: SourceFile, fn: ast.FunctionDef,
                        entries: Dict[str, Tuple[str, int]], launching: Set[str],
                        plain: Set[str]) -> None:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Try):
                continue
            guarded = any(_entry_call(c, entries) or (
                isinstance(c, ast.Call) and _callee_leaf(c) in launching)
                for stmt in node.body for c in ast.walk(stmt))
            if guarded:
                self._report(src, node.lineno, "fallback-around-kernel",
                             f"{fn.name}: a try around a kernel launch; a failed launch must raise")
            for handler in node.handlers:
                for c in ast.walk(handler):
                    if isinstance(c, ast.Call) and _callee_leaf(c) in plain:
                        self._report(src, c.lineno, "fallback-around-kernel",
                                     f"{fn.name}: the except handler calls the plain version "
                                     f"{_callee_leaf(c)}(); a card tensor must take its kernel or raise")

    def _check_wrapper(self, src: SourceFile, fn: ast.FunctionDef,
                       entries: Dict[str, Tuple[str, int]],
                       exported: Dict[str, Tuple[CUnit, CFunction]]) -> None:
        calls = [c for c in ast.walk(fn) if isinstance(c, ast.Call)]
        results: Set[str] = set()
        inline_checked = False
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and _entry_call(node.value, entries):
                results.update(t.id for t in node.targets if isinstance(t, ast.Name))
        for c in calls:
            if _callee_leaf(c) == "check" and c.args:
                arg = c.args[0]
                if isinstance(arg, ast.Name) and arg.id in results or _entry_call(arg, entries):
                    inline_checked = True
        first = min((c for c in calls if _entry_call(c, entries)), key=lambda c: c.lineno)
        if not inline_checked:
            self._report(src, first.lineno, "entry-unchecked",
                         f"{fn.name}: the entry's result never reaches _build.check; a refused "
                         f"launch would pass silently")
        if not any(_callee_leaf(c) == "count_launch" for c in calls):
            self._report(src, first.lineno, "uncounted-launch",
                         f"{fn.name}: launches without _build.count_launch; the smoke run "
                         f"cannot show the path went through the kernel")
        self._check_pools(src, fn, calls, entries, exported)

    def _check_pools(self, src: SourceFile, fn: ast.FunctionDef, calls: List[ast.Call],
                     entries: Dict[str, Tuple[str, int]],
                     exported: Dict[str, Tuple[CUnit, CFunction]]) -> None:
        params = {a.arg for a in fn.args.args + fn.args.kwonlyargs}
        pools = {p for p in params if POOL_NAME.search(p)}
        written: List[str] = []
        for c in calls:
            var = _entry_call(c, entries)
            if var is None:
                continue
            cfn = exported.get(entries[var][0], (None, None))[1]
            for i, arg in enumerate(c.args):
                ptr = _data_ptr_of(arg)
                if ptr is None:
                    continue
                if isinstance(ptr, ast.Call) and _callee_leaf(ptr) in COPYING:
                    inner = dotted_name(ptr.func.value) if isinstance(ptr.func, ast.Attribute) else None
                    if inner in pools:
                        self._report(src, arg.lineno, "inplace-copy",
                                     f"{fn.name}: pool {inner} reaches the entry through "
                                     f".{_callee_leaf(ptr)}(); the kernel would write a copy")
                    continue
                if isinstance(ptr, ast.Name) and ptr.id in pools:
                    if cfn is not None and i < len(cfn.params) and "*" in cfn.params[i] \
                            and "const" not in cfn.params[i]:
                        written.append(ptr.id)
        used = {p for p in pools if any(isinstance(n, ast.Name) and n.id == p for c in calls
                                        if _entry_call(c, entries) for n in ast.walk(c))}
        for node in ast.walk(fn):
            targets = node.targets if isinstance(node, ast.Assign) else (
                [node.target] if isinstance(node, (ast.AugAssign, ast.AnnAssign)) else [])
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name) and n.id in used:
                        self._report(src, node.lineno, "inplace-copy",
                                     f"{fn.name}: pool {n.id} is rebound before the launch; "
                                     f"the kernel must write the caller's tensor")
        if written:
            last = fn.body[-1]
            got = set()
            if isinstance(last, ast.Return) and last.value is not None:
                vals = last.value.elts if isinstance(last.value, ast.Tuple) else [last.value]
                got = {v.id for v in vals if isinstance(v, ast.Name)}
            missing = sorted(set(written) - got)
            if missing:
                self._report(src, getattr(last, "lineno", fn.lineno), "inplace-copy",
                             f"{fn.name}: a pool write must return the pools it was given; "
                             f"{missing} not returned")

    def _report(self, src: SourceFile, line: int, code: str, message: str) -> None:
        f = Finding(tool=TOOL, path=src.path, line=line, code=code, message=message)
        self.findings.append(apply_suppression(src, f))


def _reaching(fns: Sequence[ast.FunctionDef], direct: Set[str]) -> Set[str]:
    """The module's functions that launch, themselves or through another
    module function called by its bare name."""
    out = set(direct)
    changed = True
    while changed:
        changed = False
        for fn in fns:
            if fn.name not in out and any(
                    isinstance(c, ast.Call) and isinstance(c.func, ast.Name) and c.func.id in out
                    for c in ast.walk(fn)):
                out.add(fn.name)
                changed = True
    return out


def _data_ptr_of(arg: ast.AST) -> Optional[ast.AST]:
    """``X`` of an argument ``X.data_ptr()`` (also inside a conditional
    expression), else None."""
    for node in ast.walk(arg):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "data_ptr"):
            return node.func.value
    return None


def check(kernels_root: str, tests_root: str) -> List[Finding]:
    return KernelCheck(kernels_root, tests_root).run()


def check_dtensor(kernels_root: str) -> List[Finding]:
    """**dtensor-unrefused** over every family of ``kernels_root``: each
    public function of its ``ops.py`` that reaches a launch calls
    ``_build.refuse_dtensor``, itself or through a module function it
    calls by its bare name. The port's own rule on top of the wrapper
    contract (``KernelCheck``), run over the port's kernels by ``python -m
    repro_torch.analysis``."""
    out: List[Finding] = []
    for name in families(kernels_root):
        ops = SourceFile.load(Path(kernels_root) / name / "ops.py")
        entries = _entries(ops)
        fns = [n for n in ops.tree.body if isinstance(n, ast.FunctionDef)]
        reaching = _reaching(fns, {n.name for n in fns if any(_entry_call(c, entries) for c in ast.walk(n))})
        refusing = _reaching(fns, {n.name for n in fns if any(
            isinstance(c, ast.Call) and _callee_leaf(c) == "refuse_dtensor" for c in ast.walk(n))})
        for fn in fns:
            if fn.name in reaching and not fn.name.startswith("_") and fn.name not in refusing:
                f = Finding(tool=TOOL, path=ops.path, line=fn.lineno, code="dtensor-unrefused",
                            message=f"{fn.name}: reaches a launch without _build.refuse_dtensor; a DTensor "
                                    f"would launch on one rank's block as if it were the tensor")
                out.append(apply_suppression(ops, f))
    return out


def families(kernels_root: str) -> Sequence[str]:
    """The kernel families under ``kernels_root``: folders with an ``ops.py``."""
    return sorted(d.name for d in Path(kernels_root).iterdir()
                  if d.is_dir() and (d / "ops.py").exists())
