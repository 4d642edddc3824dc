"""Online StraightLine router — concurrent runtime fronting *real* backends.

The simulator (simulator.py) validates policies at scale; this router runs
the same Algorithm-1 logic against live backends (e.g. the JAX serving
engine or the Xception classifier in examples/). Two execution modes share
one placement/accounting core:

* **Concurrent runtime** (``start(workers_per_tier)``): per-tier worker
  pools pull from the deque queues, ``Backend`` accounting is lock-guarded,
  and completion is futures-based — callers block on ``result(rid,
  timeout)``. Hedging is *real*: past the hedge deadline a duplicate of the
  request races the original on the elastic tier; the first finisher wins,
  the loser's result is discarded, and the request's metrics are recorded
  exactly once. ``stop()`` joins the pools.

* **Serial fallback** (``poll()`` / ``drain()`` without ``start()``): the
  original single-threaded event loop, kept as the benchmark baseline
  (benchmarks/router_concurrency.py) and for deterministic fake-clock
  tests. Serial hedging *moves* a straggler to the elastic tier instead of
  racing a duplicate (there is no parallelism to race with).

Thread-safety contract: ``submit``/``result``/``drain`` may be called from
any number of threads. Placement reads (``Backend.free()``, warm-up stats)
are instantaneous snapshots — two concurrent submits may both see the same
free slot; the bounded queues absorb the race. Lock order: a backend
condition may be taken while holding nothing; the router registry lock
(``_lock``) is innermost and never held across a backend run or an engine
call.

Trace context contract: with a ``tracer`` attached, ``submit`` begins a
``core.tracing.Trace`` and carries it on ``req.trace`` for the request's
whole lifetime. The router records the *placement* span with Algorithm 1's
actual inputs (f_t, S_F/S_D free counts, the warm-up snapshot consumed,
chosen tier + reason), an ``enqueued`` event per enqueue, a ``queue_wait``
span and an ``execute`` span per execution copy, and events for deflection,
retry-spill, hedging (``hedge_fired`` / ``hedge_discarded``) and failure.
Each execution copy records on its own *lane* (tier name; ``*-hedge`` /
``*-retry`` for duplicates) — a hedged request's racing copies therefore
render as parallel tracks. Downstream components extend the SAME trace:
``Backend.submit_fn`` should forward ``req.trace`` into
``EngineLoop.submit(prompt, trace=...)`` so engine-side spans (chunked
prefill, preemption, per-token decode) land in it. The trace is finished
(moved into the tracer's ring) exactly once, when the rid settles. All of
this is skipped at a single ``is None`` check per site when no tracer is
attached. Router-side counters/histograms (requests, failures, hedges,
queue-wait, response time) land in a ``telemetry.MetricsRegistry``
(``default_registry()`` unless one is injected).

Fault tolerance: per-request deadline, retry-once on a different tier on
error, hedging for stragglers. Completed results are popped on retrieval
and evicted past ``results_cap`` so a long-running router cannot grow its
result map without bound.
"""
from __future__ import annotations

import copy
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional

from repro_torch.core.placing import StraightLinePolicy, place_compat, takes_warmup
from repro_torch.core.request import Request, Tier
from repro_torch.core.telemetry import (
    FrequencyEstimator,
    Metrics,
    MetricsRegistry,
    default_registry,
    warm_fraction,
)
from repro_torch.core.tracing import Tracer


class RequestFailed(RuntimeError):
    """Raised by ``result()`` when the request finished in failure."""

    def __init__(self, rid: int, reason: str):
        super().__init__(f"request {rid} failed: {reason}")
        self.rid = rid
        self.reason = reason


@dataclass
class Backend:
    """A live tier: run(req) executes synchronously and returns the result.

    ``capacity_fn`` is an optional live probe (e.g. the paged engine's
    ``admission_capacity``): when set, the placer sees the tier's measured
    free capacity instead of the static ``capacity`` constant.
    ``stats_fn`` is an optional richer snapshot (``engine.capacity_now`` or
    ``EngineLoop.capacity_now``) from which the router derives warm-up state
    (compile_events vs total_buckets, weighted by the measured
    ``compile_ema_s``) and batch occupancy for placement.

    ``submit_fn``/``wait_fn`` select the continuous-batching execution path:
    ``submit_fn(req)`` enqueues the request into a shared engine step loop
    (``serving.scheduler.EngineLoop``) and returns a ticket; ``wait_fn(
    ticket, timeout)`` blocks until it finishes. The worker thread sleeps on
    a future while the loop batches the sequence with every other in-flight
    request on that engine — set ``capacity`` to the engine's ``max_slots``
    so the pool keeps the batch fed. When unset, ``run(req)`` executes
    synchronously (lock-holding ``generate``; the serialized baseline).
    """

    tier: Tier
    run: Callable[[Request], object]
    capacity: int = 1            # concurrent requests the tier accepts
    queue_cap: int = 64
    inflight: int = 0                                     # guarded by: cond
    queue: Deque[Request] = field(default_factory=deque)  # guarded by: cond
    capacity_fn: Optional[Callable[[], int]] = None
    stats_fn: Optional[Callable[[], dict]] = None
    submit_fn: Optional[Callable[[Request], object]] = None
    wait_fn: Optional[Callable[[object, Optional[float]], object]] = None

    def __post_init__(self):
        # cond shares the lock: enqueue/dequeue and inflight accounting are
        # guarded together, and workers sleep on the same primitive
        self.lock = threading.Lock()
        self.cond = threading.Condition(self.lock)

    def free(self) -> int:
        """Free capacity for Algorithm 1's availability check. A live probe
        reports requests admittable NOW (already net of running work — e.g.
        the paged engine's admission_capacity), so it is used as-is; the
        static constant must have in-flight work subtracted. Queue headroom
        is NOT availability (a tier with every worker busy is busy, however
        long its backlog may be). A probe returning None (e.g. a
        CapacityGauge whose source unregistered) falls back to the static
        constant."""
        if self.capacity_fn is not None:
            live = self.capacity_fn()
            if live is not None:
                return max(0, int(live))
        return max(0, self.capacity - self.inflight)  # locklint: ok lock-free placement snapshot; a stale int read only skews a heuristic

    def try_push(self, req: Request) -> bool:
        """Enqueue within queue_cap (atomically) and wake a worker."""
        with self.cond:
            if len(self.queue) >= self.queue_cap:
                return False
            self.queue.append(req)
            self.cond.notify()
        return True


class _Completion:
    """Per-rid completion record: the future the caller waits on, plus the
    bookkeeping that makes hedged execution exactly-once. ``live`` is the
    number of in-flight copies of the request (1, or 2 once a hedge fires)
    and is decremented on EVERY per-copy terminal path — win, recorded
    failure, absorbed failure, discarded loser. A success wins immediately;
    a failure only records once the last live copy has failed. A record may
    be evicted/reaped only at ``live == 0`` — earlier, a still-running copy
    could resurrect the rid and record its metrics twice. ``pending``
    stashes a failure absorbed while a sibling copy was believed live, so
    it can still become the rid's outcome if that sibling evaporates (a
    hedge whose enqueue ultimately fails)."""

    __slots__ = ("request", "event", "value", "failure", "done", "live", "retrieved", "pending")

    def __init__(self, request: Optional[Request] = None):
        self.request = request
        self.event = threading.Event()
        self.value: object = None
        self.failure: Optional[str] = None
        self.done = False
        self.live = 1
        self.retrieved = False
        self.pending: Optional[tuple] = None   # (req, failure) absorbed, unrecorded


class StraightLineRouter:
    def __init__(
        self,
        backends: Dict[Tier, Backend],
        policy: Optional[StraightLinePolicy] = None,
        window_s: float = 180.0,
        clock: Callable[[], float] = time.monotonic,
        hedge_after_s: Optional[float] = None,
        retry_on_failure: bool = True,
        results_cap: int = 1024,
        tracer: Optional[Tracer] = None,
        registry: Optional[MetricsRegistry] = None,
    ):
        self.backends = backends
        self.policy = policy or StraightLinePolicy()
        self.freq = FrequencyEstimator(window_s=window_s)
        self.clock = clock
        self.metrics = Metrics()
        self.tracer = tracer
        self.registry = registry if registry is not None else default_registry()
        self.hedge_after_s = hedge_after_s
        self.retry_on_failure = retry_on_failure
        self.results_cap = results_cap
        self.results: "OrderedDict[int, object]" = OrderedDict()  # guarded by: _lock
        self._lock = threading.Lock()          # guards freq, results, _completions
        self._completions: Dict[int, _Completion] = {}  # guarded by: _lock
        self._done_order: Deque[int] = deque()  # guarded by: _lock -- completed rids, oldest first
        self._threads: List[threading.Thread] = []
        self._stop_flag = False
        self._monitor_stop = threading.Event()   # hedge-monitor pacing/stop
        self._policy_takes_warmup = takes_warmup(self.policy)

    # -- lifecycle (concurrent runtime) --------------------------------------
    @property
    def running(self) -> bool:
        return bool(self._threads)

    def start(self, workers_per_tier: int = 4) -> "StraightLineRouter":
        """Launch the worker pools: per tier, min(workers_per_tier, capacity)
        threads (capacity is the tier's concurrent-acceptance limit — more
        workers than capacity would not add admissible parallelism). When
        hedging is enabled a monitor thread fires duplicates for stragglers."""
        if self._threads:
            raise RuntimeError("router already started")
        self._stop_flag = False
        self._monitor_stop.clear()
        for b in self.backends.values():
            n = max(1, min(workers_per_tier, b.capacity))
            for i in range(n):
                t = threading.Thread(
                    target=self._worker, args=(b,), daemon=True,
                    name=f"router-{b.tier.name.lower()}-{i}",
                )
                t.start()
                self._threads.append(t)
        if self.hedge_after_s is not None:
            t = threading.Thread(target=self._hedge_monitor, daemon=True, name="router-hedge")
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        """Stop the pools; queued-but-unstarted work stays queued.

        Idempotent and re-entrancy-safe: the thread list is swapped out under
        ``_lock`` so concurrent stops join each worker at most once, the
        joins run with no lock held (workers take ``_lock`` to settle), and a
        worker calling ``stop`` itself skips the self-join."""
        self._stop_flag = True
        self._monitor_stop.set()     # wakes the hedge monitor immediately
        for b in self.backends.values():
            with b.cond:
                b.cond.notify_all()
        with self._lock:
            threads, self._threads = self._threads, []
        me = threading.current_thread()
        for t in threads:
            if t is not me:
                t.join()

    def __enter__(self) -> "StraightLineRouter":
        if not self._threads:
            self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- placement ------------------------------------------------------------
    def _free(self, t: Tier) -> int:
        return self.backends[t].free()

    def _warmup_snapshot(self) -> Optional[Dict[Tier, object]]:
        """Per-tier warm-up state for warm-up-aware placement; None when no
        backend exports any (keeps Algorithm 1 byte-faithful). A tier whose
        snapshot carries a measured ``compile_ema_s`` gets a rich entry
        ({"warmth", "compile_cost_s"}) so the policy can weigh the warmth
        gap against the actual cost of a cold bucket; otherwise the bare
        warm fraction (cost unknown -> policy keeps the plain preference)."""
        snap: Dict[Tier, object] = {}
        for t, b in self.backends.items():
            if b.stats_fn is None:
                continue
            stats = b.stats_fn()
            w = warm_fraction(stats)
            if w is None:
                continue
            cost = (stats or {}).get("compile_ema_s") or 0.0
            snap[t] = {"warmth": w, "compile_cost_s": cost} if cost > 0.0 else w
        return snap or None

    def submit(self, req: Request) -> Tier:
        now = self.clock()
        req.arrival_t = now
        tr = (
            self.tracer.begin(req.rid, t0=now, data_size=req.data_size, model=req.model)
            if self.tracer is not None
            else None
        )
        req.trace = tr
        with self._lock:
            self.freq.observe(now)
            f_t = self.freq.frequency(now)
        # availability snapshots + the warm-up state actually consumed are
        # Algorithm 1's inputs — captured into the placement span so a trace
        # answers "why this tier"
        flask_free, docker_free = self._free(Tier.FLASK), self._free(Tier.DOCKER)
        warm_seen: Dict[str, object] = {}

        def warm_fn():
            w = self._warmup_snapshot()
            warm_seen["w"] = w
            return w

        d = place_compat(
            self.policy, req, f_t, flask_free, docker_free, warm_fn,
            self._policy_takes_warmup,
        )
        tier = d.tier
        if tr is not None:
            warm = warm_seen.get("w")
            tr.add_span(
                "placement", now, self.clock(),
                f_t=f_t, flask_free=flask_free, docker_free=docker_free,
                tier=tier.name, reason=d.reason,
                warmth={
                    t.name: (v["warmth"] if isinstance(v, dict) else v)
                    for t, v in warm.items()
                } if warm else None,
            )
        self.registry.counter("router_requests_total", {"tier": tier.name.lower()}).inc()
        # Registration happens after the fallible placement/probe calls (a
        # raising probe must not leak a forever-pending completion) but
        # before the enqueue, so a worker can never finish a request the
        # registry has not seen.
        with self._lock:
            self._completions[req.rid] = _Completion(req)
        # Admission control (queue_cap): the enqueue is atomic (try_push),
        # so a full backlog — whether seen up front or raced in by another
        # submitter — deflects to the elastic serverless tier instead of
        # growing without bound; if even serverless refuses, the request is
        # rejected outright — a fast failure the client can retry, not an
        # unbounded queueing delay.
        req.tier = tier
        if self._push_traced(self.backends[tier], req):
            return tier
        sls = self.backends.get(Tier.SERVERLESS)
        if tier != Tier.SERVERLESS and sls is not None:
            req.tier = Tier.SERVERLESS
            if tr is not None:
                tr.event("deflected", t=self.clock(),
                         from_tier=tier.name, to_tier=Tier.SERVERLESS.name)
            self.registry.counter("router_deflections_total").inc()
            if self._push_traced(sls, req):
                return Tier.SERVERLESS
        self._fail(req, "queue-full")
        return req.tier

    def _push_traced(self, b: Backend, req: Request) -> bool:
        """try_push + the trace bookkeeping every enqueue path shares: stamp
        the enqueue time (the queue_wait span's start) and record the
        ``enqueued`` event on the copy's lane."""
        t = self.clock()
        req._enq_t = t
        if not b.try_push(req):
            return False
        tr = req.trace
        if tr is not None:
            tr.event("enqueued", lane=self._lane(req), t=t, tier=b.tier.name)
        return True

    @staticmethod
    def _lane(req: Request) -> str:
        """Trace lane for one execution copy: its tier, suffixed for
        hedge/retry duplicates (set where the duplicate is created)."""
        lane = getattr(req, "_lane_tag", None)
        if lane is not None:
            return lane
        return req.tier.name.lower() if req.tier is not None else "router"

    # -- completion registry (exactly-once) -----------------------------------
    def _completion_for(self, req: Request) -> _Completion:
        """Look up (or lazily create, for requests injected straight into a
        backend queue without submit()) the rid's completion record."""
        with self._lock:
            c = self._completions.get(req.rid)
            if c is None:
                c = _Completion(req)
                self._completions[req.rid] = c
            return c

    def _settle(self, c: _Completion, req: Request, value: object, failure: Optional[str]) -> bool:
        """One copy of the request reached a terminal state. Record the
        rid's outcome exactly once; returns False when this copy lost the
        race (result discarded, no metrics)."""
        with self._lock:
            c.live -= 1
            if c.done:
                return False           # a sibling copy already won
            if failure is not None and c.live > 0:
                # stash it: if the believed-live sibling never materializes
                # (hedge enqueue fails), this failure must still settle the rid
                c.pending = (req, failure)
                return False           # a hedged copy is still in flight
            c.done = True
            c.value = value
            c.failure = failure
            if failure is None:
                self.results[req.rid] = value
            self._done_order.append(req.rid)
            self._evict_locked()
        self.metrics.record(req)
        self._record_outcome(req, failure)
        c.event.set()
        return True

    def _record_outcome(self, req: Request, failure: Optional[str]) -> None:
        """Final per-rid observability: outcome counters, the response-time
        histogram, and the trace hand-off into the tracer ring (exactly
        once — losing hedge copies never reach here)."""
        tier = req.tier.name.lower() if req.tier is not None else "none"
        if failure is None:
            self.registry.counter("router_completions_total", {"tier": tier}).inc()
            if req.response_s is not None:
                self.registry.histogram("router_response_seconds", {"tier": tier}).observe(
                    req.response_s
                )
        else:
            self.registry.counter("router_failures_total", {"reason": failure}).inc()
        if req.trace is not None and self.tracer is not None:
            self.tracer.finish(
                req.trace, tier=req.tier.name if req.tier is not None else None,
                failed=failure is not None, fail_reason=failure or "",
                response_s=req.response_s, hedged=req.hedged,
            )

    def _evict_locked(self) -> None:
        """Bound results + completion-registry growth (caller holds _lock).
        A record whose rid still has a live copy is rotated to the back
        instead of reaped — reaping it would let the copy resurrect the rid
        via _completion_for and record its metrics a second time."""
        excess = len(self._done_order) - self.results_cap
        spins = len(self._done_order)
        while excess > 0 and spins > 0:
            spins -= 1
            old = self._done_order.popleft()
            c = self._completions.get(old)
            if c is not None and c.live > 0:
                self._done_order.append(old)
                continue
            self.results.pop(old, None)
            self._completions.pop(old, None)
            excess -= 1

    def _complete(self, req: Request, out: object) -> bool:
        return self._settle(self._completion_for(req), req, out, None)

    def _fail(self, req: Request, reason: str) -> None:
        req.failed = True
        req.fail_reason = reason
        req.finish_t = self.clock()
        if req.trace is not None:
            req.trace.event("failed", lane=self._lane(req), t=req.finish_t, reason=reason)
        self._settle(self._completion_for(req), req, None, reason)

    def result(self, rid: int, timeout: Optional[float] = None) -> object:
        """Block until ``rid`` finishes and return its result, popping it
        from the result map (a second call raises KeyError). Raises
        ``RequestFailed`` if the request failed, ``TimeoutError`` if it does
        not finish within ``timeout`` seconds."""
        with self._lock:
            c = self._completions.get(rid)
            if c is None or c.retrieved:
                raise KeyError(f"unknown or already-retrieved rid {rid}")
        if not c.event.wait(timeout):
            raise TimeoutError(f"request {rid} not finished within {timeout}s")
        with self._lock:
            if c.retrieved:                # raced another retriever of this rid
                raise KeyError(f"unknown or already-retrieved rid {rid}")
            c.retrieved = True
            self.results.pop(rid, None)
            if c.live == 0:            # all copies terminal: reap eagerly
                self._completions.pop(rid, None)
                try:
                    self._done_order.remove(rid)
                except ValueError:
                    pass
            # else: a losing copy is still running — leave the record for
            # the eviction pass to reap once it goes quiet
        if c.failure is not None:
            raise RequestFailed(rid, c.failure)
        return c.value

    # -- execution ------------------------------------------------------------
    def _spill_to_serverless(self, req: Request) -> bool:
        """Move a retried/hedged request to the serverless queue — but only
        within its queue_cap; admission control must hold on every enqueue
        path, not just submit(), or a flapping tier grows it without bound."""
        b = self.backends.get(Tier.SERVERLESS)
        if b is None:
            return False
        prev_tier = req.tier
        prev_lane = getattr(req, "_lane_tag", None)
        req.hedged = True
        req.tier = Tier.SERVERLESS     # metrics must attribute the execution here
        req._lane_tag = "serverless-retry"
        if self._push_traced(b, req):
            if req.trace is not None:
                req.trace.event("retry_spill", t=self.clock(), from_tier=prev_tier.name)
            self.registry.counter("router_retry_spills_total").inc()
            return True
        req.hedged = False             # spill refused: keep the request retryable
        req.tier = prev_tier
        req._lane_tag = prev_lane
        return False

    def _execute(self, b: Backend, req: Request) -> None:
        """Run one dequeued request to a terminal state (or hand it to the
        retry path). Called with no locks held.

        Continuous-batching backends (``submit_fn``/``wait_fn``) execute in
        two phases: submit into the engine's shared step loop, then block on
        the per-request future — the engine interleaves this request with
        every other in-flight one instead of serializing on its lock.
        Hedging and exactly-once settlement are unchanged: either way this
        worker owns one copy of the request until it reaches a terminal
        state."""
        c = self._completion_for(req)
        tr = req.trace
        lane = self._lane(req)
        if c.done:
            with self._lock:
                c.live -= 1            # hedge race already won — discard copy
            if tr is not None:
                tr.event("hedge_discarded", lane=lane, t=self.clock())
            return
        now = self.clock()
        enq_t = getattr(req, "_enq_t", req.arrival_t)
        if tr is not None:
            tr.add_span("queue_wait", enq_t, now, lane=lane, tier=b.tier.name)
        self.registry.histogram(
            "router_queue_wait_seconds", {"tier": b.tier.name.lower()}
        ).observe(max(0.0, now - enq_t))
        if now - req.arrival_t > req.timeout_s:
            self._fail(req, "timeout-in-queue")
            return
        req.start_t = now
        try:
            if b.submit_fn is not None and b.wait_fn is not None:
                ticket = b.submit_fn(req)
                left = max(0.0, req.timeout_s - (self.clock() - req.arrival_t))
                out = b.wait_fn(ticket, left)
            else:
                out = b.run(req)
        except TimeoutError:
            # the engine loop outlived the request's deadline: the deadline
            # verdict is final — retrying elsewhere cannot beat a clock that
            # already ran out
            if tr is not None:
                tr.add_span("execute", now, self.clock(), lane=lane,
                            tier=b.tier.name, outcome="timeout")
            self._fail(req, "timeout")
            return
        except Exception as e:  # tier failure
            if tr is not None:
                tr.add_span("execute", now, self.clock(), lane=lane,
                            tier=b.tier.name, outcome=f"error:{type(e).__name__}")
            retryable = (
                self.retry_on_failure and not req.hedged and req.tier != Tier.SERVERLESS
            )
            if not (retryable and self._spill_to_serverless(req)):
                self._fail(req, f"error:{type(e).__name__}")
            return
        req.finish_t = self.clock()
        if tr is not None:
            tr.add_span("execute", now, req.finish_t, lane=lane,
                        tier=b.tier.name, outcome="ok")
        if req.finish_t - req.arrival_t > req.timeout_s:
            self._fail(req, "timeout")
        else:
            self._complete(req, out)

    def _worker(self, b: Backend) -> None:
        """Worker-pool loop: block for queued work, execute outside the lock."""
        while True:
            with b.cond:
                while not b.queue and not self._stop_flag:
                    b.cond.wait(0.1)
                if self._stop_flag:
                    return                 # prompt shutdown: queued work stays queued
                req = b.queue.popleft()
                b.inflight += 1
            try:
                self._execute(b, req)
            finally:
                with b.cond:
                    b.inflight -= 1

    # -- hedging (concurrent runtime) -----------------------------------------
    def _fire_hedge(self, req: Request) -> None:
        """Race a duplicate of a straggler on the elastic tier. The copy
        shares the rid (and therefore the completion record): first finisher
        wins, the loser is discarded by the done-check in _settle/_execute."""
        b = self.backends.get(Tier.SERVERLESS)
        if b is None:
            return
        with self._lock:
            c = self._completions.get(req.rid)
            if c is None or c.done or req.hedged:
                return
            req.hedged = True          # never hedge the same request twice
            c.live += 1
        if req.trace is not None:
            req.trace.event("hedge_fired", t=self.clock(), original_tier=req.tier.name)
        self.registry.counter("router_hedges_total").inc()
        clone = copy.copy(req)         # shares req.trace: both copies record
        clone.hedged = True
        clone.tier = Tier.SERVERLESS
        clone._lane_tag = "serverless-hedge"
        if not self._push_traced(b, clone):
            # hedge target saturated — no duplicate. req.hedged stays True:
            # a request gets one hedge opportunity, not a retry loop that
            # hammers a saturated elastic tier every monitor tick.
            with self._lock:
                c.live -= 1
                orphan = self._adopt_pending_locked(c)
            if orphan is not None:
                # the original failed inside the live+=1/try_push window and
                # was absorbed against this never-enqueued duplicate — its
                # failure is the rid's outcome, settled here exactly once
                self.metrics.record(orphan)
                self._record_outcome(orphan, c.failure)
                c.event.set()

    def _adopt_pending_locked(self, c: _Completion) -> Optional[Request]:
        """Caller holds _lock. If every copy is gone, nothing won, and a
        failure was absorbed on the promise of a live sibling, promote that
        failure to the rid's outcome; returns the request to record."""
        if c.done or c.live > 0 or c.pending is None:
            return None
        req, failure = c.pending
        c.done = True
        c.failure = failure
        self._done_order.append(req.rid)
        self._evict_locked()
        return req

    def _hedge_scan(self) -> int:
        """One staleness pass over the in-flight completions against the
        INJECTED clock; fires a hedge per straggler found and returns how
        many fired. Extracted from the monitor loop so fake-clock tests can
        advance ``self.clock`` and drive hedging deterministically — no
        monitor thread, no wall-clock sleep in the loop's way."""
        now = self.clock()
        with self._lock:
            stale = [
                c.request
                for c in self._completions.values()
                if not c.done
                and c.request is not None
                and not c.request.hedged
                and c.request.tier not in (None, Tier.SERVERLESS)
                and now - c.request.arrival_t > self.hedge_after_s
            ]
        for req in stale:
            self._fire_hedge(req)
        return len(stale)

    def _hedge_monitor(self) -> None:
        assert self.hedge_after_s is not None
        tick = min(max(self.hedge_after_s / 4.0, 0.001), 0.05)
        # pace on a stop Event, not time.sleep: stop() returns immediately
        # instead of blocking up to a full tick behind a sleeping monitor
        while not self._monitor_stop.wait(tick):
            self._hedge_scan()

    # -- serial fallback (benchmark baseline) ----------------------------------
    def poll(self) -> int:
        """Serial mode only: drain one waiting request per tier (round-robin
        -ish); returns the number executed. The concurrent runtime's worker
        pools replace this loop — do not mix the two."""
        ran = 0
        for b in self.backends.values():
            # dispatch paces on the static concurrency limit, NOT the live
            # probe: placement (free()) may refuse NEW work when a probe
            # reports 0, but work already queued here must still drain —
            # a probe stuck at 0 must never strand queued requests
            while b.queue and b.inflight < b.capacity:  # locklint: ok serial mode: no workers started, single-threaded by contract
                req = b.queue.popleft()  # locklint: ok serial mode: no workers started, single-threaded by contract
                if (
                    self.hedge_after_s is not None
                    and not req.hedged
                    and self.clock() - req.arrival_t > self.hedge_after_s
                    and b.tier != Tier.SERVERLESS
                    # serverless backlog full -> keep the straggler here
                    # rather than stack it onto an already-saturated tier
                    and self._spill_to_serverless(req)
                ):
                    continue
                b.inflight += 1  # locklint: ok serial mode: no workers started, single-threaded by contract
                try:
                    self._execute(b, req)
                finally:
                    b.inflight -= 1  # locklint: ok serial mode: no workers started, single-threaded by contract
                ran += 1
        return ran

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted request reaches a terminal state.
        Serial mode runs the poll loop; the concurrent runtime waits on the
        outstanding completion futures."""
        if not self._threads:
            while any(b.queue for b in self.backends.values()):  # locklint: ok serial mode: guarded by the `not self._threads` branch above
                if self.poll() == 0:
                    break
            return
        deadline = None if timeout is None else self.clock() + timeout
        while True:
            with self._lock:
                pending = [c for c in self._completions.values() if not c.done]
            if not pending:
                return
            for c in pending:
                left = None if deadline is None else max(0.0, deadline - self.clock())
                if not c.event.wait(left):
                    raise TimeoutError(f"drain: request still pending after {timeout}s")
