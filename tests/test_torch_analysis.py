"""The port's static-analysis tier (``repro_torch.analysis``) against the JAX
package's tools and on seeded defects.

- Parity: on the JAX package's six concurrency modules and on the lock
  snippets of ``tests/test_analysis.py`` (copied here), the port's locklint
  and lockorder give the JAX tools' findings and edges, codes, lines and
  messages equal.
- The rules the port adds: module-level locks (guarded globals and
  attributes, blocking under a strict module lock, ``blocking-ok``), the
  host-device syncs and subprocess calls as blocking calls, module lock
  nodes and device-dispatch resolution in the graph, and every kernelcheck
  code on a seeded ``tmp_path`` family, beside the real kernels being clean.
- The tree: ``run_all`` gives 0 unsuppressed findings, the committed
  ``docs/lock_order_torch.json`` equals the fresh graph, and every module of
  the port that creates a lock is in ``CONCURRENCY_MODULES``.
- Import hygiene: the tier and its CLI load neither JAX nor the JAX package.
"""
import ast
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.analysis import locklint as jax_locklint  # noqa: E402
from repro.analysis import lockorder as jax_lockorder  # noqa: E402
from repro.analysis.common import SourceFile as JaxSource  # noqa: E402
from repro_torch.analysis import kernelcheck  # noqa: E402
from repro_torch.analysis.__main__ import (  # noqa: E402
    CONCURRENCY_MODULES,
    build_graph,
    main,
    repo_root,
    run_all,
)
from repro_torch.analysis.common import SourceFile, unsuppressed  # noqa: E402
from repro_torch.analysis.locklint import LockLint  # noqa: E402
from repro_torch.analysis.lockorder import LockOrder  # noqa: E402

ROOT = repo_root()
JAX_MODULES = (
    "src/repro/core/router.py",
    "src/repro/core/telemetry.py",
    "src/repro/core/tracing.py",
    "src/repro/serving/scheduler.py",
    "src/repro/serving/engine.py",
    "src/repro/serving/prefix_cache.py",
)


def lint(text, path="mem.py"):
    return LockLint([SourceFile.from_text(path, textwrap.dedent(text))]).run()


def order(*texts, dispatch=()):
    srcs = [SourceFile.from_text(p, textwrap.dedent(t)) for p, t in texts]
    disp = [SourceFile.from_text(p, textwrap.dedent(t)) for p, t in dispatch]
    graph = LockOrder(srcs, disp)
    graph.build()
    return graph, graph.check()


def codes(findings):
    return [f.code for f in unsuppressed(findings)]


def edges(graph):
    return {(e.src, e.dst) for e in graph.edges}


def _both(texts):
    """(JAX findings + graph, port findings + graph) on in-memory sources."""
    jax_srcs = [JaxSource.from_text(p, t) for p, t in texts]
    port_srcs = [SourceFile.from_text(p, t) for p, t in texts]
    jl = [f.to_json() for f in jax_locklint.LockLint(jax_srcs).run()]
    pl = [f.to_json() for f in LockLint(port_srcs).run()]
    jg = jax_lockorder.LockOrder(jax_srcs)
    jg.build()
    pg = LockOrder(port_srcs)
    pg.build()
    return (jl, jg, [f.to_json() for f in jg.check()]), (pl, pg, [f.to_json() for f in pg.check()])


def _edge_rows(graph):
    return [(e.src, e.dst, e.path, e.line, e.via) for e in graph.edges]


# ---------------------------------------------------------------------------
# parity with the JAX tools
# ---------------------------------------------------------------------------


def test_parity_on_the_jax_concurrency_modules():
    texts = [(rel, (ROOT / rel).read_text()) for rel in JAX_MODULES]
    (jl, jg, jc), (pl, pg, pc) = _both(texts)
    assert pl == jl and jl, "locklint findings differ from the JAX tool's"
    assert _edge_rows(pg) == _edge_rows(jg) and jg.edges
    assert pg.to_json() == jg.to_json()
    assert pc == jc
    committed = json.loads((ROOT / "docs/lock_order.json").read_text())
    assert pg.to_json() == committed


GUARDED = """
    import threading

    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self.items = []  # guarded by: _lock

        def good(self):
            with self._lock:
                self.items.append(1)

        def bad(self):
            self.items.append(2)
"""

INVERSION = """
    import threading

    class A:
        def __init__(self, b):
            self._lock = threading.Lock()
            self.b = b

        def one(self):
            with self._lock:
                self.b.grab()

    class B:
        def __init__(self, a):
            self._lock = threading.Lock()
            self.a = a

        def grab(self):
            with self._lock:
                pass

        def two(self):
            with self._lock:
                self.a.one()
"""

SELF_REACQUIRE = """
    import threading

    class S:
        def __init__(self):
            self._lock = threading.{factory}()

        def outer(self):
            with self._lock:
                self.inner()

        def inner(self):
            with self._lock:
                pass
"""

SNIPPETS = {
    "guarded": GUARDED,
    "guarded_clean": GUARDED.replace("""
        def bad(self):
            self.items.append(2)
""", ""),
    "locked_suffix": GUARDED.replace("def bad(self):", "def bad_locked(self):"),
    "suppressed": GUARDED.replace(
        "self.items.append(2)",
        "self.items.append(2)  # locklint: ok snapshot read, staleness is fine"),
    "reasonless": GUARDED.replace("self.items.append(2)", "self.items.append(2)  # locklint: ok"),
    "registry": """
        import threading

        class C:
            _GUARDED = {"items": "_lock"}

            def __init__(self):
                self._lock = threading.Lock()
                self.items = []

            def bad(self):
                return len(self.items)
    """,
    "join_and_sleep": """
        import threading, time

        class D:
            def __init__(self):
                self._lock = threading.Lock()

            def bad_join(self, t):
                with self._lock:
                    t.join()

            def bad_sleep(self):
                with self._lock:
                    time.sleep(0.1)
    """,
    "wait_on_held": """
        import threading

        class D:
            def __init__(self):
                self._lock = threading.Lock()
                self.cond = threading.Condition(self._lock)

            def consume(self):
                with self.cond:
                    self.cond.wait()
    """,
    "device_dispatch": """
        import threading

        class D:
            def __init__(self):
                self._lock = threading.Lock()

            def bad(self, engine):
                with self._lock:
                    engine.step_once()
    """,
    "blocking_ok": """
        import threading

        class E:
            def __init__(self):
                self.lock = threading.RLock()  # locklint: blocking-ok stepper owns the buffers

            def step(self, fut):
                with self.lock:
                    return fut.result()
    """,
    "nested_def": """
        import threading, time

        class F:
            def __init__(self):
                self._lock = threading.Lock()

            def spawn(self):
                with self._lock:
                    def later():
                        time.sleep(1.0)
                    return later
    """,
    "inversion": INVERSION,
    "one_direction": INVERSION.replace("""
        def two(self):
            with self._lock:
                self.a.one()
""", ""),
    "self_reacquire_lock": SELF_REACQUIRE.replace("{factory}", "Lock"),
    "self_reacquire_rlock": SELF_REACQUIRE.replace("{factory}", "RLock"),
    "transitive": """
        import threading

        class A:
            def __init__(self, b):
                self._lock = threading.Lock()
                self.b = b

            def top(self):
                with self._lock:
                    self.helper()

            def helper(self):
                self.b.grab()

        class B:
            def __init__(self):
                self._lock = threading.Lock()

            def grab(self):
                with self._lock:
                    pass
    """,
}


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_parity_on_the_jax_test_snippets(name):
    (jl, jg, jc), (pl, pg, pc) = _both([("mem.py", textwrap.dedent(SNIPPETS[name]))])
    assert pl == jl
    assert _edge_rows(pg) == _edge_rows(jg)
    assert pg.to_json() == jg.to_json()
    assert pc == jc


def test_parity_snippets_show_what_the_jax_tests_expect():
    """The copied snippets still plant what they planted: the parity above
    compares findings, not silence."""
    assert codes(lint(SNIPPETS["guarded"])) == ["guarded-field"]
    assert lint(SNIPPETS["guarded_clean"]) == [] and lint(SNIPPETS["locked_suffix"]) == []
    assert codes(lint(SNIPPETS["reasonless"])) == ["bad-suppression"]
    assert codes(lint(SNIPPETS["join_and_sleep"])) == ["blocking-under-lock"] * 2
    _, found = order(("mem.py", SNIPPETS["inversion"]))
    assert "lock-cycle" in codes(found)
    graph, found = order(("mem.py", SNIPPETS["one_direction"]))
    assert found == [] and edges(graph) == {("A._lock", "B._lock")}
    _, found = order(("mem.py", SNIPPETS["self_reacquire_lock"]))
    assert codes(found) == ["self-deadlock"]


# ---------------------------------------------------------------------------
# locklint: module-level locks, syncs and subprocesses
# ---------------------------------------------------------------------------


MODULE_LOCK = """
    import subprocess
    import threading
    import time

    _lock = threading.Lock(){policy}
    _count_lock = threading.Lock()
    _lib = None  # guarded by: _lock
    _GUARDED = {{"launches": "_count_lock"}}


    def good():
        global _lib
        with _lock:
            if _lib is None:
                _lib = object()
            return _lib


    def count(wrapper):
        with _count_lock:
            wrapper.launches += 1


    def {body}
"""

MODULE_CASES = {
    "guarded_global_outside_lock": ("bad():\n        return _lib", "guarded-field"),
    "guarded_attr_outside_lock": ("bad(wrapper):\n        wrapper.launches = 0", "guarded-field"),
    "sleep_under_module_lock": ("bad():\n        with _lock:\n            time.sleep(0.1)",
                                "blocking-under-lock"),
    "communicate_under_module_lock": ("bad(p):\n        with _lock:\n            p.communicate()",
                                      "blocking-under-lock"),
    "subprocess_run_under_module_lock": (
        "bad():\n        with _lock:\n            subprocess.run(['true'])", "blocking-under-lock"),
    "helper_blocks_under_module_lock": (
        "bad():\n        with _lock:\n            helper()\n\n\n    def helper():\n"
        "        subprocess.run(['true'])", "blocking-under-lock"),
}


def _module_text(body, policy=""):
    return textwrap.dedent(MODULE_LOCK.format(policy=policy, body=body))


@pytest.mark.parametrize("case", sorted(MODULE_CASES))
def test_module_lock_violation_flagged(case):
    body, code = MODULE_CASES[case]
    found = LockLint([SourceFile.from_text("_build.py", _module_text(body))]).run()
    assert codes(found) == [code]


def test_module_lock_clean_uses_pass():
    body = ("fine(wrapper):\n        with _count_lock:\n            wrapper.launches = 0\n"
            "        with _lock:\n            return _lib")
    assert LockLint([SourceFile.from_text("_build.py", _module_text(body))]).run() == []


@pytest.mark.parametrize("case", ["sleep_under_module_lock", "communicate_under_module_lock",
                                  "subprocess_run_under_module_lock",
                                  "helper_blocks_under_module_lock"])
def test_module_lock_blocking_ok_silences(case):
    body, _ = MODULE_CASES[case]
    text = _module_text(body, policy="  # locklint: blocking-ok one build a process")
    assert LockLint([SourceFile.from_text("_build.py", text)]).run() == []


def test_module_guarded_global_from_another_module():
    other = """
        from pkg import _build

        def peek():
            return _build._lib

        def fine():
            with _build._lock:
                return _build._lib
    """
    srcs = [SourceFile.from_text("_build.py", _module_text("noop():\n        pass")),
            SourceFile.from_text("user.py", textwrap.dedent(other))]
    found = unsuppressed(LockLint(srcs).run())
    assert [(f.path, f.code) for f in found] == [("user.py", "guarded-field")]
    assert "_build._lib" in found[0].message


def test_local_name_shadowing_a_guarded_global_is_not_flagged():
    body = "fine(_lib):\n        return _lib"
    assert LockLint([SourceFile.from_text("_build.py", _module_text(body))]).run() == []


def test_path_and_string_joins_are_not_blocking():
    body = ("fine(parts):\n        import os\n        with _lock:\n"
            "            return os.path.join('a', 'b') + ','.join(parts)")
    assert LockLint([SourceFile.from_text("_build.py", _module_text(body))]).run() == []


@pytest.mark.parametrize("call", ["torch.cuda.synchronize()", "x.item()", "x.tolist()",
                                  "x.cpu()", "x.numpy()"])
def test_host_device_sync_under_strict_lock_flagged(call):
    text = f"""
        import threading

        class D:
            def __init__(self):
                self._lock = threading.Lock()

            def bad(self, x, torch):
                with self._lock:
                    return {call}
    """
    found = lint(text)
    assert codes(found) == ["blocking-under-lock"]
    assert "device dispatch" in found[0].message


# ---------------------------------------------------------------------------
# lockorder: module lock nodes and device dispatch
# ---------------------------------------------------------------------------


BUILD = """
    import subprocess
    import threading

    _lock = threading.Lock()  # locklint: blocking-ok one build a process
    _count_lock = threading.Lock()


    def library():
        with _lock:
            subprocess.run(["true"])


    def count_launch(wrapper):
        with _count_lock:
            wrapper.launches += 1
"""

WRAPPER = """
    from pkg import _build


    def kernel(x):
        _build.count_launch(kernel)
        return x
"""

ENGINE = """
    import threading


    class Router:
        def __init__(self):
            self._lock = threading.Lock()

        def place(self):
            with self._lock:
                pass


    class Engine:
        def __init__(self, model):
            self.lock = threading.RLock()
            self.model = model

        def step(self):
            with self.lock:
                return self.model.decode(1)
"""


def test_module_locks_are_nodes_of_their_own():
    graph, found = order(("_build.py", BUILD), ("engine.py", ENGINE), dispatch=[("ops.py", WRAPPER)])
    assert found == []
    ids = {n["id"] for n in graph.to_json()["nodes"]}
    assert {"_build._lock", "_build._count_lock", "Router._lock", "Engine.lock"} <= ids
    # the device dispatch reaches the wrapper, whose launch takes the count lock
    assert edges(graph) == {("Engine.lock", "_build._count_lock")}


def test_device_dispatch_reaches_nothing_without_dispatch_sources():
    graph, _ = order(("_build.py", BUILD), ("engine.py", ENGINE))
    assert edges(graph) == set()


def test_module_lock_never_aliases_a_class_attribute():
    """``_lock`` on a class and at module scope are two nodes, and a
    cross-object ``b._lock`` still resolves only among classes."""
    text = """
        import threading

        _lock = threading.Lock()


        class Owner:
            def __init__(self):
                self._lock = threading.Lock()

            def nest(self):
                with self._lock:
                    with _lock:
                        pass


        def module_first(owner):
            with _lock:
                with owner._lock:
                    pass
    """
    graph, found = order(("mod.py", text))
    assert edges(graph) == {("Owner._lock", "mod._lock"), ("mod._lock", "Owner._lock")}
    assert codes(found) == ["lock-cycle"]


def test_module_lock_reacquired_through_a_helper_is_a_self_deadlock():
    text = """
        import threading

        _lock = threading.Lock()


        def outer():
            with _lock:
                inner()


        def inner():
            with _lock:
                pass
    """
    _, found = order(("mod.py", text))
    assert codes(found) == ["self-deadlock"]


def test_library_calls_do_not_alias_analyzed_functions():
    """``subprocess.run`` under a lock is a library call, not the
    launcher's nested ``run``: no edge from it."""
    lib = """
        import subprocess
        import threading

        _lock = threading.Lock()


        def build():
            with _lock:
                subprocess.run(["true"])
    """
    launcher = """
        import threading


        class Hub:
            def __init__(self):
                self._lock = threading.Lock()

            def run(self):
                with self._lock:
                    pass
    """
    graph, _ = order(("lib.py", lib), ("launcher.py", launcher))
    assert edges(graph) == set()


# ---------------------------------------------------------------------------
# kernelcheck: a seeded family per code
# ---------------------------------------------------------------------------


GOOD_CU = """\
#include <cuda_runtime.h>

namespace {

__global__ void fam_kernel(const float* x, float* y, float* pool, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    y[i] = x[i];
    pool[i] = x[i];
  }
}

void launch(const float* x, float* y, float* pool, int n, cudaStream_t s) {
  fam_kernel<<<(n + 255) / 256, 256, 0, s>>>(x, y, pool, n);
}

}  // namespace

// x: (n,) f32; y: (n,) f32; pool: (n,) f32 written in place
extern "C" int rt_fam(const void* x, void* y, void* pool, int n, void* stream) {
  launch(static_cast<const float*>(x), static_cast<float*>(y), static_cast<float*>(pool), n,
         static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
"""

GOOD_OPS = """\
import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fam.ref import fam_ref

_P = ctypes.c_void_p
_RT = _build.Entry("rt_fam", [_P, _P, _P, ctypes.c_int, _P])


def fam(x, pool_kv):
    if x.is_cpu:
        return fam_ref(x, pool_kv)
    return _launch(x, pool_kv)


def _launch(x, pool_kv):
    dev = _build.require_cuda("fam", x, pool_kv)
    y = torch.empty_like(x)
    err = (_RT.fn or _RT.resolve())(x.data_ptr(), y.data_ptr(), pool_kv.data_ptr(), x.numel(),
                                    _build.stream_ptr(dev))
    _build.count_launch(fam)
    _build.check(err, "fam")
    return y, pool_kv


fam.launches = 0
"""

GOOD_REF = """\
def fam_ref(x, pool_kv):
    pool_kv.copy_(x)
    return x.clone(), pool_kv
"""

GOOD_CARD_TEST = "from repro_torch.kernels.fam import ops as fam_ops\n"
GOOD_PARITY_TEST = ("from repro_torch.kernels.fam.ref import fam_ref\n"
                    "from repro.kernels.fam import ref as jax_ref\n")

TRY_LAUNCH = """    try:
        err = (_RT.fn or _RT.resolve())(x.data_ptr(), y.data_ptr(), pool_kv.data_ptr(), x.numel(),
                                        _build.stream_ptr(dev))
    except RuntimeError:
        raise
"""

SEEDED = {
    # code: (file, old, new)
    "missing-ref": ("ref", None, None),
    "empty-ref": ("ref", GOOD_REF, "# the plain version lives elsewhere\n"),
    "missing-entry-source": ("ops", '"rt_fam"', '"rt_fam_gone"'),
    "entry-no-last-error": ("cu", "return static_cast<int>(cudaGetLastError());", "return 0;"),
    "entry-unchecked": ("ops", '    _build.check(err, "fam")\n', ""),
    "uncounted-launch": ("ops", "    _build.count_launch(fam)\n", ""),
    "fallback-around-kernel[try]": ("ops", """    err = (_RT.fn or _RT.resolve())(x.data_ptr(), y.data_ptr(), pool_kv.data_ptr(), x.numel(),
                                    _build.stream_ptr(dev))
""", TRY_LAUNCH),
    "fallback-around-kernel[handler]": ("ops", """        return fam_ref(x, pool_kv)
    return _launch(x, pool_kv)""", """        return fam_ref(x, pool_kv)
    try:
        return _launch(x, pool_kv)
    except RuntimeError:
        return fam_ref(x.cpu(), pool_kv.cpu())"""),
    "env-switch": ("ops", "    if x.is_cpu:", "    import os\n    if x.is_cpu or os.environ.get('FAM_PLAIN'):"),
    "inplace-copy[contiguous]": ("ops", "pool_kv.data_ptr(), x.numel()",
                                 "pool_kv.contiguous().data_ptr(), x.numel()"),
    "inplace-copy[rebound]": ("ops", '    dev = _build.require_cuda("fam", x, pool_kv)\n',
                              '    pool_kv = pool_kv.to(torch.float32)\n'
                              '    dev = _build.require_cuda("fam", x, pool_kv)\n'),
    "inplace-copy[not-returned]": ("ops", "    return y, pool_kv\n", "    return y\n"),
    "missing-card-test": ("card", GOOD_CARD_TEST, "import torch\n"),
    "missing-jax-parity-test": ("parity", GOOD_PARITY_TEST,
                                "from repro_torch.kernels.fam.ref import fam_ref\n"),
}


def make_family(tmp_path, edit=None):
    files = {"cu": GOOD_CU, "ops": GOOD_OPS, "ref": GOOD_REF, "card": GOOD_CARD_TEST,
             "parity": GOOD_PARITY_TEST}
    if edit is not None:
        which, old, new = edit
        if old is None:
            files[which] = None
        else:
            assert old in files[which], old
            files[which] = files[which].replace(old, new)
    kernels = tmp_path / "kernels"
    (kernels / "csrc").mkdir(parents=True)
    (kernels / "fam").mkdir()
    (kernels / "build").mkdir()               # a folder without ops.py is no family
    tests = tmp_path / "tests"
    tests.mkdir()
    (kernels / "csrc" / "fam.cu").write_text(files["cu"])
    (kernels / "fam" / "ops.py").write_text(files["ops"])
    if files["ref"] is not None:
        (kernels / "fam" / "ref.py").write_text(files["ref"])
    (tests / "test_torch_cuda.py").write_text(files["card"])
    (tests / "test_torch_fam.py").write_text(files["parity"])
    return str(kernels), str(tests)


def test_kernelcheck_good_family_is_clean(tmp_path):
    assert kernelcheck.check(*make_family(tmp_path)) == []


@pytest.mark.parametrize("case", sorted(SEEDED))
def test_kernelcheck_seeded_violation_flagged(tmp_path, case):
    found = codes(kernelcheck.check(*make_family(tmp_path, SEEDED[case])))
    assert found and set(found) == {case.split("[")[0]}, found


@pytest.mark.parametrize("code", sorted({c.split("[")[0] for c in SEEDED}))
def test_kernelcheck_real_kernels_clean_of_each_code(code):
    found = kernelcheck.check(str(ROOT / "src/repro_torch/kernels"), str(ROOT / "tests"))
    assert [f.format() for f in unsuppressed(found) if f.code == code] == []


def test_kernelcheck_real_kernels_hold_every_family():
    """The real tree is clean because the checks saw it: seven entry
    points, five families, each entry's C function found."""
    root = ROOT / "src/repro_torch/kernels"
    assert kernelcheck.families(str(root)) == [
        "decode_attention", "flash_attention", "mlstm_chunk", "paged_attention", "rmsnorm"]
    units = [kernelcheck.CUnit(p) for p in sorted((root / "csrc").glob("*.cu"))]
    launching = {f.name for u in units for f in u.entries() if u.launches(f.name)}
    assert launching == {"rt_rmsnorm", "rt_paged_prefill_write", "rt_paged_prefill_write_quant",
                         "rt_paged_attention", "rt_flash_attention", "rt_decode_attention",
                         "rt_mlstm_chunkwise"}


def test_kernelcheck_suppressions(tmp_path):
    ops = GOOD_OPS.replace("    _build.count_launch(fam)\n", "").replace(
        "    err = (_RT.fn or _RT.resolve())(",
        "    err = (_RT.fn or _RT.resolve())(  # kernelcheck: ok counted by the caller\n        ")
    found = kernelcheck.check(*make_family(tmp_path / "py", ("ops", GOOD_OPS, ops)))
    assert unsuppressed(found) == [] and [f.reason for f in found] == ["counted by the caller"]
    cu = GOOD_CU.replace("  return static_cast<int>(cudaGetLastError());", "  return 0;").replace(
        "  launch(", "  launch(  // kernelcheck: ok the caller synchronizes\n      ", 1)
    found = kernelcheck.check(*make_family(tmp_path / "cu", ("cu", GOOD_CU, cu)))
    assert unsuppressed(found) == [] and [f.reason for f in found] == ["the caller synchronizes"]
    bare = cu.replace("ok the caller synchronizes", "ok")
    found = kernelcheck.check(*make_family(tmp_path / "bare", ("cu", GOOD_CU, bare)))
    assert codes(found) == ["bad-suppression"]


def test_kernelcheck_launch_checked_through_a_returned_helper(tmp_path):
    """An entry that returns a helper's checked result needs no
    cudaGetLastError() of its own (the paged decode's dispatch chain)."""
    cu = GOOD_CU.replace("""void launch(const float* x, float* y, float* pool, int n, cudaStream_t s) {
  fam_kernel<<<(n + 255) / 256, 256, 0, s>>>(x, y, pool, n);
}""", """int launch(const float* x, float* y, float* pool, int n, cudaStream_t s) {
  fam_kernel<<<(n + 255) / 256, 256, 0, s>>>(x, y, pool, n);
  return static_cast<int>(cudaGetLastError());
}""").replace("""  launch(static_cast<const float*>(x)""", """  return launch(static_cast<const float*>(x)""").replace(
        "  return static_cast<int>(cudaGetLastError());\n}\n", "}\n")
    cu = cu.replace("}\n\n}  // namespace", "  return static_cast<int>(cudaGetLastError());\n}\n\n}  // namespace")
    roots = make_family(tmp_path, ("cu", GOOD_CU, cu))
    assert kernelcheck.check(*roots) == []
    unchecked = cu.replace("  fam_kernel<<<(n + 255) / 256, 256, 0, s>>>(x, y, pool, n);\n"
                           "  return static_cast<int>(cudaGetLastError());",
                           "  fam_kernel<<<(n + 255) / 256, 256, 0, s>>>(x, y, pool, n);\n  return 0;")
    roots = make_family(tmp_path / "bad", ("cu", GOOD_CU, unchecked))
    assert codes(kernelcheck.check(*roots)) == ["entry-no-last-error"]


# ---------------------------------------------------------------------------
# the tree
# ---------------------------------------------------------------------------


def test_real_tree_is_clean():
    findings, _ = run_all(ROOT, ["locklint", "lockorder", "kernelcheck"])
    loud = unsuppressed(findings)
    assert loud == [], "unexplained findings:\n" + "\n".join(f.format() for f in loud)
    assert all(f.reason for f in findings if f.suppressed)


def test_committed_graph_is_fresh():
    doc = json.dumps(build_graph(ROOT).to_json(), indent=2, sort_keys=True) + "\n"
    assert (ROOT / "docs/lock_order_torch.json").read_text() == doc


def test_real_tree_graph_shape():
    got = edges(build_graph(ROOT))
    # the JAX graph's edges, under the same names
    assert {("StraightLineRouter._lock", "FrequencyEstimator._lock"),
            ("_EngineBase.lock", "Trace._lock")} <= got
    # every launch under the engine's step lock takes the count lock; the
    # first builds the library under the build lock
    assert {("_EngineBase.lock", "_build._count_lock"), ("_EngineBase.lock", "_build._lock")} <= got


def test_concurrency_module_list_is_complete():
    """Every module of the port that creates a threading lock is analyzed."""
    factories = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
    missing = []
    for p in sorted((ROOT / "src/repro_torch").rglob("*.py")):
        rel = str(p.relative_to(ROOT))
        if rel.startswith("src/repro_torch/analysis/"):
            continue          # the witness's own bookkeeping lock
        tree = ast.parse(p.read_text())
        creates = any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                      and isinstance(n.func.value, ast.Name) and n.func.value.id == "threading"
                      and n.func.attr in factories for n in ast.walk(tree))
        if creates and rel not in CONCURRENCY_MODULES:
            missing.append(rel)
    assert missing == []
    assert all((ROOT / rel).exists() for rel in CONCURRENCY_MODULES)


def test_cli_check_graph_and_stale_artifact(tmp_path, capsys):
    assert main(["--check-graph", str(ROOT / "docs/lock_order_torch.json")]) == 0
    stale = tmp_path / "lock_order_torch.json"
    stale.write_text("{}\n")
    assert main(["--only", "lockorder", "--check-graph", str(stale)]) == 1
    assert main(["--only", "lockorder", "--emit-graph", str(tmp_path / "out")]) == 0
    assert (tmp_path / "out" / "lock_order_torch.json").read_text() == \
        (ROOT / "docs/lock_order_torch.json").read_text()
    assert (tmp_path / "out" / "lock_order_torch.dot").read_text() == \
        (ROOT / "docs/lock_order_torch.dot").read_text()


def test_import_and_cli_load_no_jax():
    code = ("import sys, runpy\n"
            "sys.argv = ['repro_torch.analysis', '--json']\n"
            "try:\n"
            "    runpy.run_module('repro_torch.analysis', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))"
            " or m in ('repro', 'torch'))\n"
            "assert not bad, bad\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout) and all(f["suppressed"] for f in json.loads(out.stdout))
