"""The port's runtime lock-order witness (``repro_torch.analysis.witness``).

The wrapper unit tests (edge recording, inversion detection, RLock
reentrancy, the Condition wait dance) run on the port's copy; then the
runtime's locks are witnessed during the concurrency soaks: the router with
fake backends, an ``EngineLoop`` over a smollm-360m SMOKE paged engine on
the CPU (prefix cache off and on), and ``launch/serve_hybrid.main`` with six
submitter threads. The observed acquisition orders must be acyclic on their
own and combined with the port's static lock-order graph.

The engine-backed soaks carry "engine" in their names so the fast
``scripts/ci_torch.sh analyze`` gate can deselect them with
``-k "not engine"`` while the full run still exercises them. On the CPU the
kernel wrappers take their plain versions and count no launch, so the
edge from the engine's step lock to ``_build._count_lock`` is seen only on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.witness import (  # noqa: E402
    LockWitness,
    base_name,
    instrument_build,
    instrument_loop,
    instrument_router,
)
from repro_torch.core import Request, StraightLinePolicy, Thresholds, Tier  # noqa: E402
from repro_torch.core.router import Backend, StraightLineRouter  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402


def static_edges():
    from repro_torch.analysis.__main__ import build_graph, repo_root

    return {(e.src, e.dst) for e in build_graph(repo_root()).edges}


REENTRANT = {"_EngineBase.lock"}


# ---------------------------------------------------------------------------
# Wrapper unit tests
# ---------------------------------------------------------------------------


def test_nested_acquire_records_edge():
    w = LockWitness()
    a, b = w.wrap("A"), w.wrap("B")
    with a:
        with b:
            pass
    assert w.edge_set() == {("A", "B")}
    w.assert_consistent()                          # one direction: fine


def test_inversion_detected_without_deadlocking():
    """A-under-B and B-under-A observed in sequence (never concurrently, so
    the run itself cannot deadlock) must still fail the consistency check."""
    w = LockWitness()
    a, b = w.wrap("A"), w.wrap("B")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    with pytest.raises(AssertionError, match="cycle"):
        w.assert_consistent()


def test_rlock_reentry_records_no_self_edge():
    w = LockWitness()
    r = w.wrap("R", reentrant=True)
    with r:
        with r:
            with r:
                pass
    assert w.edge_set() == set()
    w.assert_consistent()


def test_non_reentrant_self_edge_fails():
    w = LockWitness()
    w.on_acquired("L")
    w.on_acquired("L")                             # simulated re-acquire while held
    with pytest.raises(AssertionError, match="re-acquired while held"):
        w.assert_consistent()
    w.assert_consistent(reentrant=["L"])           # declared reentrant: legal


def test_observed_edge_inverting_static_graph_fails():
    w = LockWitness()
    b, a = w.wrap("B"), w.wrap("A")
    with b:
        with a:
            pass
    w.assert_consistent()                          # acyclic on its own
    with pytest.raises(AssertionError, match="static"):
        w.assert_consistent(static_edges={("A", "B")})


def test_instance_suffixes_distinguish_locks_but_strip_for_static():
    w = LockWitness()
    c1, c2 = w.wrap("Backend.cond[FLASK]"), w.wrap("Backend.cond[DOCKER]")
    with c1:
        with c2:
            pass
    with c2:
        with c1:
            pass
    assert base_name("Backend.cond[FLASK]") == "Backend.cond"
    # two instances of one static node taken in both orders is a real
    # ordering hazard: full instance names participate in cycle detection
    with pytest.raises(AssertionError, match="cycle"):
        w.assert_consistent()


def test_condition_wait_releases_and_reacquires_through_witness():
    """Condition.wait's release/re-acquire dance must route through the
    wrapper: while the consumer sleeps in wait() it holds nothing, so a
    producer acquiring other locks records no edge from the condition."""
    w = LockWitness()
    lk = w.wrap("C.cond")
    cond = threading.Condition(lk)
    other = w.wrap("C.other")
    ready = []

    def consumer():
        with cond:
            while not ready:
                cond.wait(5)

    t = threading.Thread(target=consumer)
    t.start()
    time.sleep(0.05)                               # consumer is inside wait()
    with other:                                    # no lock held by this thread
        pass
    with cond:
        ready.append(1)
        cond.notify()
    t.join(5)
    assert not t.is_alive()
    assert w.edge_set() == set()                   # no ordering was ever observed
    w.assert_consistent()


def test_unknown_edges_reports_unpredicted_orderings():
    w = LockWitness()
    with w.wrap("X[1]"):
        with w.wrap("Y"):
            pass
    assert w.unknown_edges({("A", "B")}) == {("X", "Y")}
    assert w.unknown_edges({("X", "Y")}) == set()


def test_instrument_build_witnesses_the_count_lock_and_restores():
    """``instrument_build`` swaps ``_build``'s two module locks in place: a
    launch counted under a witnessed step lock records the edge the static
    graph predicts, and ``restore`` puts the original locks back."""
    w = LockWitness()
    saved = (_build._lock, _build._count_lock)

    def wrapper():
        pass

    wrapper.launches = 0
    wrapper.leg_launches = {"flat": 0}
    restore = instrument_build(w)
    try:
        step_lock = w.wrap("_EngineBase.lock", reentrant=True)
        with step_lock:
            _build.count_launch(wrapper, "flat")
        _build.reset_launches(wrapper)
    finally:
        restore()
    assert (_build._lock, _build._count_lock) == saved
    assert wrapper.launches == 0 and wrapper.leg_launches == {"flat": 0}
    assert w.edge_set() == {("_EngineBase.lock", "_build._count_lock")}
    assert w.acquire_counts() == {"_EngineBase.lock": 1, "_build._count_lock": 2}
    static = static_edges()
    assert w.unknown_edges(static) == set()
    w.assert_consistent(static, reentrant=REENTRANT)


# ---------------------------------------------------------------------------
# Router soak under the witness (fake backends: fast, no engine)
# ---------------------------------------------------------------------------


def test_router_soak_under_witness():
    """The fake-backend router soak, with the registry lock and every
    backend condition witnessed: whatever interleavings the workers and
    the hedge monitor produce, the observed lock orders must stay
    consistent with the port's static graph."""
    w = LockWitness()

    def flask_run(req):
        time.sleep(0.001)
        if req.rid % 7 == 3:
            raise RuntimeError("flask flake")
        return f"f:{req.rid}"

    router = StraightLineRouter(
        {
            Tier.FLASK: Backend(Tier.FLASK, flask_run, capacity=4, queue_cap=400),
            Tier.DOCKER: Backend(Tier.DOCKER, lambda req: f"d:{req.rid}", capacity=4, queue_cap=400),
            Tier.SERVERLESS: Backend(Tier.SERVERLESS, lambda req: f"s:{req.rid}", capacity=8, queue_cap=400),
        },
        policy=StraightLinePolicy(Thresholds(F=1e9, D=1e6)),
        hedge_after_s=0.005,
        results_cap=500,
    )
    instrument_router(router, w)
    router.start(4)

    def submitter(base):
        for i in range(20):
            router.submit(Request(rid=base + i, arrival_t=0.0, data_size=100.0, timeout_s=60.0))

    threads = [threading.Thread(target=submitter, args=(k * 1000,)) for k in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    router.drain(timeout=60)
    router.stop()

    assert router.metrics.total == 120
    counts = w.acquire_counts()
    assert counts.get("StraightLineRouter._lock", 0) > 0
    assert any(base_name(k) == "Backend.cond" and v > 0 for k, v in counts.items())
    w.assert_consistent(static_edges(), reentrant=REENTRANT)


# ---------------------------------------------------------------------------
# Engine-backed soaks (smollm-360m SMOKE on the CPU; deselect with -k "not engine")
# ---------------------------------------------------------------------------

PROMPT, NEW, MAXLEN, PS = 5, 3, 64, 16


@pytest.fixture(scope="module")
def cfg():
    from repro_torch.configs.registry import get_config

    return get_config("smollm-360m", smoke=True).replace(attn_chunk=64)


def _paged(cfg, prefix_cache=False):
    from repro_torch.serving.engine import PagedEngineConfig, PagedInferenceEngine

    return PagedInferenceEngine(
        cfg,
        PagedEngineConfig(page_size=PS, num_pages=1 + 2 * MAXLEN // PS,
                          max_slots=2, max_seq_len=MAXLEN, max_new_tokens=NEW,
                          prefix_cache=prefix_cache),
        device="cpu",
    )


@pytest.mark.parametrize("prefix_cache", [False, True], ids=["cache_off", "cache_on"])
def test_engine_loop_soak_under_witness(cfg, prefix_cache):
    """The continuous-batching soak under the witness: the EngineLoop
    registry lock, the engine's coarse step RLock and ``_build``'s two
    locks witnessed while submitter threads run the admit->resolve cycle,
    with and without the prefix cache in the admission path."""
    import numpy as np

    from repro_torch.serving.scheduler import EngineLoop

    w = LockWitness()
    eng = _paged(cfg, prefix_cache=prefix_cache)
    loop = EngineLoop(eng)
    instrument_loop(loop, w)
    restore = instrument_build(w)

    prompts = [
        [int(t) for t in np.random.default_rng(i).integers(1, cfg.vocab_size, PROMPT)]
        for i in range(4)
    ]
    prompts.append(list(prompts[0]))               # shared prefix: cache hit path
    outs = [None] * len(prompts)
    try:
        with loop:
            def worker(i):
                outs[i] = loop.wait(loop.submit(prompts[i]), 120).out

            threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            assert not any(t.is_alive() for t in threads)
    finally:
        restore()

    assert all(len(o) == NEW for o in outs)
    assert outs[4] == outs[0]                      # prefix reuse must not change tokens
    counts = w.acquire_counts()
    assert counts.get("EngineLoop._lock", 0) > 0
    assert counts.get("_EngineBase.lock", 0) > 0
    assert counts.get("_build._count_lock", 0) == 0     # the CPU runs the plain versions
    w.assert_consistent(static_edges(), reentrant=REENTRANT)
    if prefix_cache:
        eng.prefix_cache.check_invariants()


def test_serve_hybrid_engine_burst_under_witness(tmp_path, monkeypatch):
    """``launch/serve_hybrid.main`` on the CPU with the witness and six
    submitter threads: the router, its backends' conditions, the three
    loops and their engines, the tracer, the sampler and ``_build``'s
    locks witnessed; 0 failures and the same greedy outputs as the
    unwitnessed single-submitter burst, whose engines have the same
    shapes; observed orders consistent with the static graph. Each step
    gets the 50 ms floor of ``test_torch_core``'s burst, so its hedge
    assertion holds on the CPU."""
    from repro_torch.launch import serve_hybrid
    from repro_torch.serving.engine import PagedInferenceEngine

    step = PagedInferenceEngine.step

    def floored_step(self):
        with self.lock:
            time.sleep(0.05)
            return step(self)

    monkeypatch.setattr(PagedInferenceEngine, "step", floored_step)
    plain = serve_hybrid.main(device="cpu", smoke=True, out_dir=str(tmp_path / "plain"), verbose=False)
    w = LockWitness()
    restore = instrument_build(w)
    try:
        r = serve_hybrid.main(device="cpu", smoke=True, out_dir=str(tmp_path / "witnessed"),
                              params=plain["params"], verbose=False, witness=w, submitters=6)
    finally:
        restore()
    m = r["metrics"]
    assert m.total == serve_hybrid.N and m.failure_rate == 0.0
    assert r["results"] == plain["results"]
    counts = w.acquire_counts()
    for name in ("StraightLineRouter._lock", "EngineLoop._lock", "_EngineBase.lock",
                 "Tracer._lock", "MonitorSampler._lock"):
        assert counts.get(name, 0) > 0, (name, counts)
    assert {base_name(k) for k in counts} >= {"Backend.cond"}
    w.assert_consistent(static_edges(), reentrant=REENTRANT)
