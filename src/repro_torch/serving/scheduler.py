"""Continuous-batching engine loop: submit -> shared step thread -> futures.

``EngineLoop`` turns an engine (dense ``InferenceEngine`` or
``PagedInferenceEngine``) from a synchronous ``generate``-per-caller device
into a shared continuous-batching service. Callers from any number of
threads ``submit(prompt)`` and block on ``wait(sid)``; ONE background step
thread owns all device stepping — each iteration admits pending sequences
under the engine lock, runs one batched ``step()`` across every active slot,
and resolves finished sequences into per-sid futures. Concurrent requests
therefore interleave inside a single decode batch instead of serializing
whole generations on the engine lock (the pre-loop ``generate`` contract),
so a tier's usable capacity really is ``max_slots``, not 1. With chunked
prefill enabled on the engine (``chunk_tokens``), each iteration further
interleaves budgeted prefill CHUNK work with the decode batch inside
``engine.step()`` — a long prompt is absorbed over many loop iterations
while decoding slots emit a token every iteration, and the remaining
``prefill_backlog_tokens`` is exported through ``capacity_now()``.

The router integration is two-phase: ``Backend.submit_fn`` enqueues into the
loop and returns a ticket, ``Backend.wait_fn`` blocks on it — the router
worker sleeps on a future while the loop batches its sequence with everyone
else's. ``capacity_now()`` re-exports the engine snapshot plus the loop's
occupancy telemetry (``active_slots`` / ``batch_occupancy`` /
``queue_depth``) so the placer sees true interleaved capacity — including,
for engines with a cross-request prefix cache, ``cached_pages`` /
``evictable_pages`` / ``prefix_hit_rate`` (evictable cache counts as
reclaimable free capacity; see serving/prefix_cache.py). Finished
sequences additionally record ``prefix_matched_tokens`` /
``prefix_cache_hit_ratio`` into the metrics registry.

Failure contract: an exception escaping ``engine.step()`` poisons the loop —
every pending and future waiter gets the error (wrapped in RuntimeError),
and subsequent submits raise. ``stop()`` joins the thread and unblocks
pending waiters with a "loop stopped" error; sequences already inside the
engine stay there (matching the router's stop() contract of leaving queued
work queued).

Trace context contract: ``submit(prompt, trace=...)`` forwards a
``core.tracing.Trace`` into the engine (carried on the ``Sequence``), so
engine-side spans — chunked-prefill chunks, preemption/resume, per-token
decode instants — land in the request's router-begun trace on a per-sid
lane (``engine-sid<N>``; a hedged request's two sids give two lanes). At
resolve time the loop copies the sequence's per-token timestamps into the
trace and derives TTFT / inter-token-latency observations into the
``ttft_seconds`` / ``itl_seconds`` histograms of its metrics registry
(``telemetry.default_registry()`` unless injected), labeled with the
loop's ``name``. All tracing work is guarded on ``trace is not None`` —
untraced submits pay one branch.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from repro_torch.core.telemetry import MetricsRegistry, default_registry, log_buckets
from repro_torch.core.tracing import Trace, trace_now
from repro_torch.serving.engine import Sequence


class _SeqFuture:
    """Per-sid completion future the submitting thread blocks on."""

    __slots__ = ("event", "seq", "error")

    def __init__(self):
        self.event = threading.Event()
        self.seq: Optional[Sequence] = None
        self.error: Optional[BaseException] = None


class EngineLoop:
    """Background continuous-batching step loop over one engine.

    Lock order: ``engine.lock`` (taken by engine entry points) and the loop's
    registry ``_lock`` are never held together *nested the wrong way round*:
    ``submit`` takes engine.lock (inside ``engine.submit``) then ``_lock``;
    the step thread calls ``engine.step()`` (engine.lock inside) and only
    takes ``_lock`` after the step returns. A sequence finishing between
    ``engine.submit`` and the future registration is parked in
    ``_unclaimed`` and claimed at registration — no completion is lost.
    """

    def __init__(
        self,
        engine,
        idle_wait_s: float = 0.02,
        name: str = "engine",
        registry: Optional[MetricsRegistry] = None,
    ):
        self.engine = engine
        self.idle_wait_s = idle_wait_s
        self.name = name
        self.registry = registry if registry is not None else default_registry()
        self._lock = threading.Lock()
        self._futures: Dict[int, _SeqFuture] = {}    # guarded by: _lock
        self._unclaimed: Dict[int, Sequence] = {}    # guarded by: _lock
        self._abandoned: set = set()    # guarded by: _lock -- timed-out sids: discard on finish
        self._work = threading.Event()
        self._stop_flag = False
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.steps = 0          # batched step() iterations executed
        # deltas for windowed metrics: engine tokens-per-step gauge and the
        # prefix-cache hit-ratio gauge (cumulative counters stay cumulative;
        # the gauges report what happened SINCE the last observation so a
        # long-running engine's gauges never go inert)
        self._tokens_seen = 0
        self._pc_queries_seen = 0
        self._pc_hits_seen = 0

    # -- lifecycle -----------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "EngineLoop":
        with self._lock:
            if self._thread is not None:
                raise RuntimeError("engine loop already started")
            self._stop_flag = False
            t = self._thread = threading.Thread(
                target=self._run, daemon=True, name="engine-loop")
        t.start()
        return self

    def stop(self) -> None:
        """Join the step thread; waiters still pending are failed (the loop
        that would have finished them is gone). Unclaimed completions and
        abandoned sids are dropped too: their waiters have been failed (or
        timed out and left), so nothing will ever claim them — a
        stopped-then-restarted loop (``stop()`` resets ``_thread``, so
        ``start()`` is allowed again) must begin with a clean registry
        instead of carrying orphaned results forever.

        Idempotent and re-entrancy-safe: the thread handle is swapped out
        under ``_lock`` so of N racing stops exactly one joins, and the join
        runs with no lock held — the step thread takes ``_lock`` in
        ``_resolve``, so joining it under the lock would deadlock."""
        self._stop_flag = True
        self._work.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None and t is not threading.current_thread():
            t.join()
        self._fail_pending(RuntimeError("engine loop stopped"))
        with self._lock:
            self._unclaimed.clear()
            self._abandoned.clear()

    def __enter__(self) -> "EngineLoop":
        if self._thread is None:
            self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- submission / completion ----------------------------------------------
    def submit(self, prompt: List[int], trace: Optional[Trace] = None) -> int:
        """Enqueue a prompt for continuous batching; returns its sid. The
        engine admits it at the next step with free capacity. ``trace``
        rides the Sequence so engine-side spans land in the request's
        lifecycle trace."""
        if self._error is not None:
            raise RuntimeError(f"engine loop failed: {self._error!r}") from self._error
        sid = self.engine.submit(prompt, trace=trace)
        with self._lock:
            fut = _SeqFuture()
            seq = self._unclaimed.pop(sid, None)
            if seq is not None:        # finished before registration (tiny race)
                fut.seq = seq
                fut.event.set()
            elif self._error is not None or self._stop_flag:
                # the loop died/stopped between the entry check and this
                # registration — nothing will ever resolve the future; fail
                # it here so the waiter can't hang forever
                fut.error = self._error or RuntimeError("engine loop stopped")
                fut.event.set()
            self._futures[sid] = fut
        self._work.set()
        return sid

    def wait(self, sid: int, timeout: Optional[float] = None) -> Sequence:
        """Block until ``sid`` finishes; returns its Sequence (popping the
        future — one wait per sid). Raises TimeoutError past ``timeout``,
        RuntimeError if the loop failed or stopped under it. A timed-out sid
        is ABANDONED: its future is reaped and the eventual result discarded
        (the caller has moved on — the deadline verdict is final), so
        timed-out requests cannot grow the registry without bound."""
        with self._lock:
            fut = self._futures.get(sid)
        if fut is None:
            raise KeyError(f"unknown or already-waited sid {sid}")
        if not fut.event.wait(timeout):
            with self._lock:
                if not fut.event.is_set():     # lost no race: truly unfinished
                    self._futures.pop(sid, None)
                    self._abandoned.add(sid)
                    raise TimeoutError(f"sequence {sid} not finished within {timeout}s")
        with self._lock:
            self._futures.pop(sid, None)
        if fut.error is not None:
            raise RuntimeError(f"engine loop failed: {fut.error!r}") from fut.error
        return fut.seq

    def generate(self, prompts: List[List[int]], timeout: Optional[float] = None) -> List[Sequence]:
        """Drop-in for ``engine.generate``: submit all, wait all — but through
        the shared step loop, so concurrent callers interleave. ``timeout``
        is ONE overall deadline for the whole batch, shared across the
        per-sid waits (waiting a full ``timeout`` per sid would make the
        effective deadline N x the argument)."""
        sids: List[int] = []
        try:
            for p in prompts:
                sids.append(self.submit(p))
        except Exception:
            # a rejected prompt (e.g. too long for the engine) fails the
            # whole batch: reap the siblings already registered, or their
            # futures would sit in the registry forever (only wait() pops)
            with self._lock:
                for s in sids:
                    fut = self._futures.pop(s, None)
                    if fut is not None and not fut.event.is_set():
                        self._abandoned.add(s)
                    self._unclaimed.pop(s, None)
            raise
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        for idx, s in enumerate(sids):
            left = None if deadline is None else max(0.0, deadline - time.monotonic())
            try:
                out.append(self.wait(s, left))
            except Exception:
                # a failed batch is final for the WHOLE batch (shared
                # deadline expired, loop poisoned or stopped): abandon the
                # sids never waited on too, so their eventual results are
                # discarded instead of growing the registry forever
                with self._lock:
                    for rest in sids[idx + 1 :]:
                        fut = self._futures.pop(rest, None)
                        if fut is not None and not fut.event.is_set():
                            self._abandoned.add(rest)   # discard on finish
                        self._unclaimed.pop(rest, None)
                raise
        return out

    # -- stepping --------------------------------------------------------------
    def step_once(self) -> List[Sequence]:
        """One loop iteration, synchronously (deterministic tests drive this
        instead of ``start()``): admit + batched step + resolve. Returns the
        sequences finished this step. Per-step speculation observability
        lands here: the ``engine_tokens_per_step`` gauge (delta of the
        engine's cumulative token counter — >1 per decoding slot when
        speculation is accepting) and the ``spec_accepted_run`` histogram
        (one observation per verify pass, the number of proposal tokens
        accepted)."""
        labels = {"engine": self.name}
        finished = self.engine.step()
        self.steps += 1
        self.registry.counter("engine_loop_steps_total", labels).inc()
        emitted = getattr(self.engine, "tokens_emitted", None)
        if emitted is not None:
            self.registry.gauge("engine_tokens_per_step", labels).set(
                emitted - self._tokens_seen
            )
            self._tokens_seen = emitted
        runs = getattr(self.engine, "spec_runs", None)
        if runs:
            hist = self.registry.histogram(
                "spec_accepted_run", labels, bounds=log_buckets(1.0, 2.0, 8)
            )
            for r in runs:
                hist.observe(float(r))
        if finished:
            self._resolve(finished)
        return finished

    def _busy(self) -> bool:
        """Lock-free activity snapshot (drives only the idle sleep; the step
        itself re-checks everything under the engine lock)."""
        eng = self.engine
        return bool(eng.waiting) or any(s is not None for s in eng.slot_seq)

    def _run(self) -> None:
        while not self._stop_flag:
            self._work.clear()
            if not self._busy():
                # cleared BEFORE the busy check: a submit landing after the
                # check sets the event and the wait returns immediately
                self._work.wait(self.idle_wait_s)
                continue
            try:
                self.step_once()
            except Exception as e:          # poison: device/step failure
                self._error = e
                self._fail_pending(e)
                return

    def _resolve(self, seqs: List[Sequence]) -> None:
        for seq in seqs:
            self._observe_finished(seq)
        with self._lock:
            for seq in seqs:
                if seq.sid in self._abandoned:     # waiter timed out and left
                    self._abandoned.discard(seq.sid)
                    continue
                fut = self._futures.get(seq.sid)
                if fut is None:
                    self._unclaimed[seq.sid] = seq
                else:
                    fut.seq = seq
                    fut.event.set()

    def _observe_finished(self, seq: Sequence) -> None:
        """Per-sequence terminal observability: TTFT / inter-token-latency
        histogram observations from the engine-stamped token times, token
        throughput counters, prefix-cache metrics (engines with a prefix
        cache: per-sequence matched tokens into the ``prefix_matched_tokens``
        histogram — misses observe 0 so the hit ratio is derivable — plus
        the cache-wide hit-ratio gauge), and the trace hand-off (per-token
        instants onto the sequence's engine lane)."""
        labels = {"engine": self.name}
        times = seq.token_times
        if times:
            self.registry.histogram("ttft_seconds", labels).observe(
                max(0.0, times[0] - seq.submit_t)
            )
            itl = self.registry.histogram("itl_seconds", labels)
            for a, b in zip(times, times[1:]):
                itl.observe(max(0.0, b - a))
        self.registry.counter("engine_tokens_total", labels).inc(len(seq.out))
        pc = getattr(self.engine, "prefix_cache", None)
        if pc is not None:
            self.registry.histogram(
                "prefix_matched_tokens", labels, bounds=log_buckets(1.0, 2.0, 16)
            ).observe(float(seq.cached_tokens))
            self.registry.counter(
                "prefix_cached_tokens_total", labels
            ).inc(seq.cached_tokens)
            # the hit-ratio gauge is WINDOWED: hits/queries since the last
            # observation, not the lifetime-cumulative ``pc.hit_rate`` (which
            # goes inert on a long-running engine — millions of old queries
            # drown any behavior change). The cumulative counts stay
            # available as counters for rate() -style consumers.
            dq = pc.queries - self._pc_queries_seen
            dh = pc.hits - self._pc_hits_seen
            if dq > 0:
                self.registry.gauge("prefix_cache_hit_ratio", labels).set(dh / dq)
                self.registry.counter("prefix_cache_queries_total", labels).inc(dq)
                self.registry.counter("prefix_cache_hits_total", labels).inc(dh)
                self._pc_queries_seen = pc.queries
                self._pc_hits_seen = pc.hits
        if seq.trace is not None:
            lane = f"engine-sid{seq.sid}"
            seq.trace.add_tokens(lane, times)
            seq.trace.event(
                "resolved", lane=lane, t=trace_now(), sid=seq.sid,
                n_out=len(seq.out), preemptions=seq.preemptions, engine=self.name,
            )

    def _fail_pending(self, err: BaseException) -> None:
        with self._lock:
            for fut in self._futures.values():
                if not fut.event.is_set():
                    fut.error = err
                    fut.event.set()

    # -- capacity telemetry ------------------------------------------------------
    def capacity_now(self) -> dict:
        """Engine snapshot plus loop occupancy: ``active_slots`` (sequences
        interleaved in the current decode batch — PREFILLING slots, which
        occupy capacity but do not decode yet, are counted separately via
        the engine's ``prefilling_slots``), ``batch_occupancy`` (their
        fraction of ``num_slots``), ``queue_depth`` (admitted-but-waiting),
        ``loop_steps``, and the engine's ``prefill_backlog_tokens`` — prompt
        tokens not yet absorbed by the budgeted chunk phase, the signal that
        a tier is digesting a long prompt. Lock-free, instantaneous — same
        staleness contract as ``engine.capacity_now``."""
        snap = self.engine.capacity_now()
        # one default for num_slots everywhere, clamped once: a sparse
        # snapshot (free_slots without num_slots, or the reverse) reports
        # zero occupancy instead of a negative slot count
        total = max(1, snap.get("num_slots", 1))
        occupied = min(total, max(0, total - snap.get("free_slots", total)))
        # PREFILLING slots occupy capacity but are not decoding yet — they
        # are reported via prefilling_slots, not inside the decode batch
        active = max(0, occupied - snap.get("prefilling_slots", 0))
        snap["active_slots"] = active
        snap["batch_occupancy"] = active / total
        snap["queue_depth"] = snap.get("waiting", 0)
        snap["loop_steps"] = self.steps
        snap.setdefault("prefill_backlog_tokens", 0)
        return snap

    def admission_capacity(self, est_tokens: int = 0) -> int:
        return self.engine.admission_capacity(est_tokens)
