"""Per-request lifecycle tracing: spans, events, per-token timelines.

The paper's headline claims (lower response time / failure rate from
resource-aware placement) were measured as end-of-run aggregates; a trace
answers *why one request was slow*. Each submitted request carries a
``Trace`` (on ``Request.trace`` / ``Sequence.trace``) from
``StraightLineRouter.submit`` through placement, backend queueing, worker
execution (including hedge races — the duplicate copy shares the original's
trace and records on its own *lane*), the ``EngineLoop`` admit→resolve
cycle, and the engines' chunked-prefill / preemption / per-token decode
machinery. Prefix-cache engines add instants on the sequence's engine lane:
``prefix_hit`` / ``prefix_miss`` at admission (with ``matched_tokens``, so
a Perfetto view shows exactly how much prefill was skipped) and
``prefix_evict`` when cold cached leaves are reclaimed to cover an
allocation (with ``freed_pages``). Speculating engines add one instant per
verify step on the same lane: ``spec_accept`` when at least one drafted
token survived verification, ``spec_reject`` when the whole draft was
thrown away (both carry ``slot`` / ``proposed`` / ``accepted``, so a trace
shows exactly where the n-gram proposer paid off). The result is a bounded
ring of finished traces exportable two ways:

* ``Tracer.traces()`` — structured dicts (the test/forecaster surface);
* ``Tracer.chrome_trace()`` / ``export_chrome(path)`` — Chrome trace-event
  JSON, loadable in Perfetto / ``chrome://tracing`` (one *process* per
  request, one *thread* per lane, so a hedged request renders as two racing
  execution tracks under one request group).

Zero-cost when disabled: a ``Tracer(enabled=False)`` (or no tracer at all)
makes ``begin()`` return None, and every instrumentation site in the
router/scheduler/engines is guarded by ``if trace is not None`` — the only
residual work is that branch. ``benchmarks/observability_overhead.py``
gates this in CI.

Timestamp contract: every span/event/token time is ``time.monotonic()``
(`trace_now`), the same clock the router uses — timestamps from different
components of one trace are directly comparable. The simulator records
sim-time traces instead; a trace is internally consistent, never mix the
two bases within one tracer.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Deque, Dict, List, Optional

trace_now = time.monotonic


class Trace:
    """One request's lifecycle: spans (named intervals), events (named
    instants), and per-lane token timelines. A *lane* is one execution
    track — "router" for placement/bookkeeping, a tier name for a worker
    execution, a per-sid lane for engine-side work — and becomes a thread
    row in the Chrome export, so a hedged request's racing copies render
    side by side. Appends are lock-guarded: hedged copies and the engine
    step thread record concurrently."""

    __slots__ = ("rid", "attrs", "spans", "events", "tokens", "t0", "_lock", "finished")

    def __init__(self, rid: int, t0: Optional[float] = None, **attrs):
        self.rid = rid
        self.attrs = dict(attrs)
        self.t0 = trace_now() if t0 is None else t0
        self.spans: List[tuple] = []      # (name, lane, t0, t1, attrs)
        self.events: List[tuple] = []     # (name, lane, t, attrs)
        self.tokens: Dict[str, List[float]] = {}   # lane -> token timestamps
        self._lock = threading.Lock()
        self.finished = False

    # -- recording -----------------------------------------------------------
    def add_span(self, name: str, t0: float, t1: float, lane: str = "router", **attrs) -> None:
        with self._lock:
            self.spans.append((name, lane, t0, t1, attrs))

    @contextmanager
    def span(self, name: str, lane: str = "router", **attrs):
        t0 = trace_now()
        try:
            yield self
        finally:
            self.add_span(name, t0, trace_now(), lane=lane, **attrs)

    def event(self, name: str, lane: str = "router", t: Optional[float] = None, **attrs) -> None:
        with self._lock:
            self.events.append((name, lane, trace_now() if t is None else t, attrs))

    def add_tokens(self, lane: str, times: List[float]) -> None:
        """Attach a finished execution's per-token decode timestamps (one
        lane per engine-side sequence; a hedged request contributes two)."""
        with self._lock:
            self.tokens.setdefault(lane, []).extend(times)

    # -- derived / export ------------------------------------------------------
    def lanes(self) -> List[str]:
        with self._lock:
            seen = dict.fromkeys(
                [lane for _, lane, *_ in self.spans]
                + [lane for _, lane, *_ in self.events]
                + list(self.tokens)
            )
        return list(seen)

    def ttft_s(self, lane: Optional[str] = None) -> Optional[float]:
        """First-token latency from trace start for ``lane`` (earliest lane
        with tokens when None) — None until a token lands."""
        with self._lock:
            pools = [self.tokens[lane]] if lane else list(self.tokens.values())
        firsts = [ts[0] for ts in pools if ts]
        return min(firsts) - self.t0 if firsts else None

    def itl_s(self, lane: Optional[str] = None) -> List[float]:
        """Inter-token gaps for ``lane`` (all lanes when None)."""
        with self._lock:
            pools = [self.tokens.get(lane, [])] if lane else list(self.tokens.values())
        out: List[float] = []
        for ts in pools:
            out.extend(b - a for a, b in zip(ts, ts[1:]))
        return out

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "rid": self.rid,
                "t0": self.t0,
                "attrs": dict(self.attrs),
                "spans": [
                    {"name": n, "lane": lane, "t0": a, "t1": b, "attrs": dict(at)}
                    for n, lane, a, b, at in self.spans
                ],
                "events": [
                    {"name": n, "lane": lane, "t": t, "attrs": dict(at)}
                    for n, lane, t, at in self.events
                ],
                "tokens": {lane: list(ts) for lane, ts in self.tokens.items()},
            }


class Tracer:
    """Thread-safe bounded ring of request traces.

    ``begin(rid)`` hands out a live ``Trace`` (or None when disabled — the
    zero-cost path); ``finish(trace)`` stamps summary attrs and moves it
    into the ring, evicting the oldest past ``capacity``. Export any time:
    finished traces are immutable-by-convention (late events from a losing
    hedge copy may still land; they simply appear in the export)."""

    def __init__(self, capacity: int = 4096, enabled: bool = True):
        self.capacity = capacity
        self.enabled = enabled
        self._lock = threading.Lock()
        self._ring: Deque[Trace] = deque(maxlen=capacity)  # guarded by: _lock
        self._closed = False            # guarded by: _lock

    def begin(self, rid: int, **attrs) -> Optional[Trace]:
        if not self.enabled:
            return None
        return Trace(rid, **attrs)

    def finish(self, trace: Optional[Trace], **attrs) -> None:
        if trace is None:
            return
        trace.attrs.update(attrs)
        with self._lock:
            if trace.finished or self._closed:
                return               # exactly-once: hedge copies both settle
            trace.finished = True
            self._ring.append(trace)

    def close(self) -> None:
        """Idempotent shutdown: disable ``begin`` and stop accepting late
        ``finish`` calls, so in-flight losers of a hedge race settling after
        shutdown cannot grow the ring. Finished traces stay exportable;
        calling ``close`` any number of times (from any thread) is safe."""
        self.enabled = False
        with self._lock:
            self._closed = True

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def traces(self) -> List[dict]:
        """Finished traces as structured dicts, oldest first."""
        with self._lock:
            ring = list(self._ring)
        return [t.to_dict() for t in ring]

    def drain(self) -> List[dict]:
        with self._lock:
            ring = list(self._ring)
            self._ring.clear()
        return [t.to_dict() for t in ring]

    # -- Chrome trace-event export ---------------------------------------------
    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON (Perfetto-loadable): one pid per request,
        one tid per lane (named via thread_name metadata), spans as complete
        ("X") events, instants as "i", tokens as named instants on their
        execution lane. Timestamps are microseconds on the shared monotonic
        base."""
        out: List[dict] = []
        for t in self.traces():
            pid = t["rid"]
            tids = {lane: i for i, lane in enumerate(
                dict.fromkeys(
                    [s["lane"] for s in t["spans"]]
                    + [e["lane"] for e in t["events"]]
                    + list(t["tokens"])
                )
            )}
            out.append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": f"request {pid}"},
            })
            for lane, tid in tids.items():
                out.append({
                    "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                    "args": {"name": lane},
                })
            for s in t["spans"]:
                out.append({
                    "ph": "X", "name": s["name"], "pid": pid, "tid": tids[s["lane"]],
                    "ts": s["t0"] * 1e6, "dur": max(0.0, (s["t1"] - s["t0"]) * 1e6),
                    "args": s["attrs"],
                })
            for e in t["events"]:
                out.append({
                    "ph": "i", "s": "t", "name": e["name"], "pid": pid,
                    "tid": tids[e["lane"]], "ts": e["t"] * 1e6, "args": e["attrs"],
                })
            for lane, ts in t["tokens"].items():
                for k, tk in enumerate(ts):
                    out.append({
                        "ph": "i", "s": "t", "name": "token", "pid": pid,
                        "tid": tids[lane], "ts": tk * 1e6, "args": {"i": k},
                    })
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


NULL_TRACER = Tracer(enabled=False)
"""Shared disabled tracer: ``begin()`` always returns None, so components
that want an always-present tracer attribute can default to this without
paying for tracing."""
