"""Request-frequency estimation, live capacity feedback, metrics aggregation,
and the fleet observability plane (metrics registry + gauge time series).

The paper's Algorithm 1 consumes f_t — "request frequency at time t" — and
the availability sets S_F / S_D. We estimate f_t two ways (selectable): a
sliding count window (matches the paper's 'requests per 180 s' load metric)
and an EWMA of instantaneous rate (smoother under bursts). ``CapacityGauge``
closes the availability side of the loop: serving engines register live
probes (``free_pages()`` / ``capacity_now()`` from the paged engine) and the
router/tier models pull through the gauge, so S_F/S_D reflect the machine
rather than static capacity constants. Percentile aggregation serves the
evaluation figures.

Beyond the per-run aggregates, two continuous surfaces:

* ``MetricsRegistry`` — counters / gauges / fixed-log-bucket histograms
  (mergeable across threads), with a Prometheus-style text exposition
  (``prometheus_text``). The router, EngineLoop and launchers record into
  one shared ``default_registry()`` instead of ad-hoc counters, so every
  run exposes requests/failures/hedges per tier plus TTFT and inter-token
  latency histograms in one scrape.

* ``MonitorSampler`` — a background thread sampling every registered
  ``CapacityGauge`` stats probe at a fixed interval into per-tier
  ring-buffer time series (occupancy, free pages, queue depth, prefill
  backlog, warmth). ``window(tier, last_s)`` reads a recent slice — this
  is the resource-usage depository the predictive placer (ROADMAP item 5)
  forecasts from.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, Iterable, List, Optional, Sequence, Tuple


def batch_occupancy(stats: Optional[dict]) -> Optional[float]:
    """Decode-batch occupancy in [0, 1] from a ``capacity_now()``-style
    snapshot: active sequences / ``num_slots``. With a continuous-batching
    step loop (serving/scheduler.py) this is the fraction of the shared
    decode batch actually interleaving work — the utilization the placer's
    capacity feedback ultimately buys. Returns None when the snapshot is
    missing or exports no slot total."""
    if not stats:
        return None
    total = stats.get("num_slots") or 0
    if total <= 0:
        return None
    active = stats.get("active_slots")
    if active is None:
        free = stats.get("free_slots")
        if free is None:
            return None
        active = total - free
    return min(1.0, max(0.0, active / total))


def queue_depth(stats: Optional[dict]) -> Optional[int]:
    """Admitted-but-waiting sequences from a ``capacity_now()``-style
    snapshot (``queue_depth`` from an EngineLoop, else the engine's raw
    ``waiting``), or None when unknown."""
    if not stats:
        return None
    d = stats.get("queue_depth", stats.get("waiting"))
    return None if d is None else int(d)


def prefill_backlog(stats: Optional[dict]) -> Optional[int]:
    """Prompt tokens not yet absorbed by the engine's (chunked) prefill
    phase from a ``capacity_now()``-style snapshot, or None when the
    snapshot is missing or predates the chunked-prefill export."""
    if not stats:
        return None
    b = stats.get("prefill_backlog_tokens")
    return None if b is None else int(b)


def warm_fraction(stats: Optional[dict]) -> Optional[float]:
    """Bucket-compilation progress in [0, 1] from a ``capacity_now()``-style
    snapshot: ``compile_events / total_buckets``. Returns None when the
    snapshot is missing or exports no bucket total (unbucketed engines,
    static tiers) — callers treat unknown warm-up as "always warm"."""
    if not stats:
        return None
    total = stats.get("total_buckets") or 0
    if total <= 0:
        return None
    return min(1.0, max(0.0, stats.get("compile_events", 0) / total))


def cached_pages(stats: Optional[dict]) -> Optional[int]:
    """Pages held warm by the engine's cross-request prefix cache from a
    ``capacity_now()``-style snapshot, or None when the snapshot is missing
    or the engine runs without a prefix cache (the key is then absent)."""
    if not stats:
        return None
    c = stats.get("cached_pages")
    return None if c is None else int(c)


def prefix_hit_rate(stats: Optional[dict]) -> Optional[float]:
    """Fraction of admissions whose prompt matched >= 1 cached page, from a
    ``capacity_now()``-style snapshot; None when no prefix cache exports."""
    if not stats:
        return None
    r = stats.get("prefix_hit_rate")
    return None if r is None else min(1.0, max(0.0, float(r)))


def kv_bytes_per_token(stats: Optional[dict]) -> Optional[float]:
    """KV-cache bytes per cached token from a ``capacity_now()``-style
    snapshot (values + scales for int8 pools) — lets the placer convert an
    engine's free-token headroom into bytes regardless of storage format.
    None when the snapshot is missing or the engine predates the export."""
    if not stats:
        return None
    b = stats.get("kv_bytes_per_token")
    return None if b is None else float(b)


def kv_cache_dtype(stats: Optional[dict]) -> Optional[str]:
    """The engine's KV-cache storage dtype name ("int8", "bfloat16", ...),
    or None when the snapshot is missing or the key is absent."""
    if not stats:
        return None
    d = stats.get("kv_cache_dtype")
    return None if d is None else str(d)


def spec_acceptance(stats: Optional[dict]) -> Optional[float]:
    """Speculative-decode acceptance rate — accepted draft tokens over
    proposed draft tokens — from a ``capacity_now()``-style snapshot. None
    when speculation is off or the engine has proposed nothing yet (no
    signal beats a fake 0.0 during warm-up)."""
    if not stats:
        return None
    proposed = stats.get("spec_proposed")
    if not proposed:
        return None
    return min(1.0, max(0.0, stats.get("spec_accepted", 0) / proposed))


def reclaimable_pages(stats: Optional[dict]) -> Optional[int]:
    """The placer's free-ish page view: truly free pages plus evictable
    (unpinned) prefix-cache pages, which the engine reclaims before ever
    preempting a live sequence. Falls back to plain ``free_pages`` when the
    engine has no prefix cache; None when the snapshot exports neither."""
    if not stats:
        return None
    free = stats.get("free_pages")
    if free is None:
        return None
    return int(free) + int(stats.get("evictable_pages") or 0)


class FrequencyEstimator:
    """Thread-safe f_t estimator: ``observe``/``frequency`` may be called
    from any thread (the concurrent router's workers observe while the
    placer reads). Both paths mutate ``_times`` — ``frequency`` prunes the
    window on the read side — so both hold the estimator's own lock."""

    def __init__(self, window_s: float = 180.0, mode: str = "window", halflife_s: float = 5.0):
        self.window_s = window_s
        self.mode = mode
        self.halflife_s = halflife_s
        self._times: Deque[float] = deque()
        self._rate = 0.0
        self._last_t: Optional[float] = None
        self._lock = threading.Lock()

    def observe(self, t: float) -> None:
        with self._lock:
            self._times.append(t)
            cutoff = t - self.window_s
            while self._times and self._times[0] < cutoff:
                self._times.popleft()
            if self._last_t is not None:
                dt = max(t - self._last_t, 1e-9)
                inst = 1.0 / dt
                alpha = 1.0 - 0.5 ** (dt / self.halflife_s)
                self._rate += alpha * (inst - self._rate)
            self._last_t = t

    def frequency(self, t: float) -> float:
        """f_t: requests per window (paper's unit: sessions / 180 s)."""
        with self._lock:
            if self.mode == "ewma":
                return self._rate * self.window_s
            cutoff = t - self.window_s
            while self._times and self._times[0] < cutoff:
                self._times.popleft()
            return float(len(self._times))


class CapacityGauge:
    """Registry of live per-tier capacity probes.

    A probe is a zero-arg callable returning "requests admittable right now"
    (e.g. ``lambda: engine.admission_capacity(est_tokens)`` — slots bounded
    by free KV pages for the paged engine). The router's ``Backend`` and the
    simulator's ``TierSim`` consult the gauge when a probe is registered and
    fall back to their static models otherwise, so Algorithm 1's S_F / S_D
    availability checks track the actual cache state of the serving tier.
    """

    def __init__(self):
        self._probes: Dict[str, Callable[[], int]] = {}
        self._stats: Dict[str, Callable[[], dict]] = {}

    def register(self, name: str, probe: Callable[[], int]) -> None:
        self._probes[name] = probe

    def register_stats(self, name: str, probe: Callable[[], dict]) -> None:
        """Bind a rich snapshot probe (``engine.capacity_now``) so consumers
        can read warm-up state, not just a free-capacity integer."""
        self._stats[name] = probe

    def unregister(self, name: str) -> None:
        self._probes.pop(name, None)
        self._stats.pop(name, None)

    def free(self, name: str) -> Optional[int]:
        """Live free capacity for ``name``, or None when no probe is bound."""
        probe = self._probes.get(name)
        if probe is None:
            return None
        return max(0, int(probe()))

    def stats(self, name: str) -> Optional[dict]:
        probe = self._stats.get(name)
        return probe() if probe is not None else None

    def stat_names(self) -> List[str]:
        """Tiers with a rich stats probe bound — what ``MonitorSampler``
        sweeps."""
        return list(self._stats)

    def warmth(self, name: str) -> Optional[float]:
        """Warm-up fraction for ``name`` (compile progress), or None."""
        return warm_fraction(self.stats(name))

    def occupancy(self, name: str) -> Optional[float]:
        """Decode-batch occupancy for ``name`` (continuous-batching
        interleaving), or None when the stats probe exports no slots."""
        return batch_occupancy(self.stats(name))

    def queue_depth(self, name: str) -> Optional[int]:
        """Admitted-but-waiting depth behind ``name``'s step loop, or None."""
        return queue_depth(self.stats(name))

    def prefill_backlog(self, name: str) -> Optional[int]:
        """Unabsorbed prompt tokens behind ``name``'s chunked prefill, or
        None when the stats probe does not export a backlog."""
        return prefill_backlog(self.stats(name))

    def cached_pages(self, name: str) -> Optional[int]:
        """Prefix-cache pages held warm by ``name``, or None (no cache)."""
        return cached_pages(self.stats(name))

    def prefix_hit_rate(self, name: str) -> Optional[float]:
        """Prefix-cache hit rate for ``name``, or None (no cache)."""
        return prefix_hit_rate(self.stats(name))

    def reclaimable_pages(self, name: str) -> Optional[int]:
        """Free + evictable-cache pages for ``name`` — the capacity view
        that counts cold prefix-cache leaves as reclaimable."""
        return reclaimable_pages(self.stats(name))

    def spec_acceptance(self, name: str) -> Optional[float]:
        """Speculative-decode acceptance rate for ``name``, or None when
        speculation is off or nothing has been proposed yet."""
        return spec_acceptance(self.stats(name))

    def kv_bytes_per_token(self, name: str) -> Optional[float]:
        """KV-cache bytes per cached token for ``name``, or None."""
        return kv_bytes_per_token(self.stats(name))

    def kv_cache_dtype(self, name: str) -> Optional[str]:
        """KV-cache storage dtype name for ``name``, or None."""
        return kv_cache_dtype(self.stats(name))

    def snapshot(self) -> Dict[str, int]:
        return {name: max(0, int(p())) for name, p in self._probes.items()}


def percentile(xs: Sequence[float], p: float) -> float:
    if not xs:
        return float("nan")
    s = sorted(xs)
    k = min(len(s) - 1, max(0, int(math.ceil(p / 100.0 * len(s))) - 1))
    return s[k]


@dataclass
class Metrics:
    """Aggregates matching the paper's figures: failed rate, session length,
    response time (median/p95), per-tier breakdowns. ``record`` is atomic
    (lock-guarded) so the concurrent router's workers can report from any
    thread; the read-side properties take instantaneous snapshots."""

    completed: List = field(default_factory=list)
    failed: List = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    def record(self, req) -> None:
        with self._lock:
            (self.failed if req.failed else self.completed).append(req)

    @property
    def total(self) -> int:
        with self._lock:
            return len(self.completed) + len(self.failed)

    @property
    def failure_rate(self) -> float:
        with self._lock:
            total = len(self.completed) + len(self.failed)
            return len(self.failed) / total if total else 0.0

    def response_times(self, tier=None) -> List[float]:
        with self._lock:
            completed = list(self.completed)
        return [
            r.response_s
            for r in completed
            if r.response_s is not None and (tier is None or r.tier == tier)
        ]

    def summary(self) -> Dict[str, float]:
        rts = self.response_times()
        with self._lock:
            total = len(self.completed) + len(self.failed)
            n_failed = len(self.failed)
        return {
            "total": total,
            "failed": n_failed,
            "failure_rate": round(n_failed / total, 4) if total else 0.0,
            "median_response_s": round(percentile(rts, 50), 4) if rts else float("nan"),
            "p95_response_s": round(percentile(rts, 95), 4) if rts else float("nan"),
            "p99_response_s": round(percentile(rts, 99), 4) if rts else float("nan"),
            "mean_response_s": round(sum(rts) / len(rts), 4) if rts else float("nan"),
        }


# ---------------------------------------------------------------------------
# Metrics registry: counters / gauges / histograms + Prometheus exposition
# ---------------------------------------------------------------------------


class Counter:
    """Monotonic counter; ``inc`` is lock-guarded so any thread may record."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins instantaneous value (e.g. a sampled occupancy)."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


def log_buckets(start: float = 1e-4, factor: float = 2.0, count: int = 24) -> Tuple[float, ...]:
    """Fixed log-spaced histogram bounds: ``start * factor**i``. The default
    spans 100 µs … ~28 min — TTFT, inter-token gaps, queue waits and whole
    responses all land inside it with ~2x resolution."""
    return tuple(start * factor**i for i in range(count))


class Histogram:
    """Fixed-bucket histogram (log-spaced by default), mergeable across
    threads: every instance with the same bounds can ``merge`` into another
    by adding bucket counts — no rebinning, no loss. ``bucket_counts`` are
    non-cumulative (the Prometheus exposition cumulates them); the implicit
    +Inf bucket catches overflow."""

    __slots__ = ("bounds", "counts", "total", "sum", "_lock")

    def __init__(self, bounds: Optional[Iterable[float]] = None):
        self.bounds = tuple(bounds) if bounds is not None else log_buckets()
        self.counts = [0] * (len(self.bounds) + 1)    # last = +Inf overflow
        self.total = 0
        self.sum = 0.0
        self._lock = threading.Lock()

    def _index(self, x: float) -> int:
        lo, hi = 0, len(self.bounds)
        while lo < hi:                  # first bound >= x (le semantics)
            mid = (lo + hi) // 2
            if self.bounds[mid] >= x:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def observe(self, x: float) -> None:
        i = self._index(x)
        with self._lock:
            self.counts[i] += 1
            self.total += 1
            self.sum += x

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other``'s counts into self (same bounds required)."""
        if other.bounds != self.bounds:
            raise ValueError("cannot merge histograms with different bounds")
        with other._lock:
            counts, total, s = list(other.counts), other.total, other.sum
        with self._lock:
            for i, c in enumerate(counts):
                self.counts[i] += c
            self.total += total
            self.sum += s
        return self

    def percentile(self, p: float) -> float:
        """Approximate percentile: upper bound of the bucket holding the
        p-th observation (NaN when empty; +Inf overflow reports the top
        bound)."""
        with self._lock:
            total, counts = self.total, list(self.counts)
        if total == 0:
            return float("nan")
        target = max(1, math.ceil(p / 100.0 * total))
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= target:
                return self.bounds[i] if i < len(self.bounds) else self.bounds[-1]
        return self.bounds[-1]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "bounds": self.bounds,
                "counts": list(self.counts),
                "total": self.total,
                "sum": self.sum,
            }


def _label_key(labels: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((labels or {}).items()))


def _label_str(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class MetricsRegistry:
    """Get-or-create registry of named, labeled instruments with a
    Prometheus-style text exposition. One shared ``default_registry()``
    replaces the ad-hoc counters scattered across router/scheduler/engine;
    tests may construct private registries."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, str], Dict[Tuple, object]] = {}

    def _get(self, kind: str, name: str, labels: Optional[Dict[str, str]], make):
        with self._lock:
            fam = self._metrics.setdefault((kind, name), {})
            key = _label_key(labels)
            inst = fam.get(key)
            if inst is None:
                inst = fam[key] = make()
            return inst

    def counter(self, name: str, labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(
        self,
        name: str,
        labels: Optional[Dict[str, str]] = None,
        bounds: Optional[Iterable[float]] = None,
    ) -> Histogram:
        return self._get("histogram", name, labels, lambda: Histogram(bounds))

    def merged_histogram(self, name: str) -> Optional[Histogram]:
        """All label-series of ``name`` merged into one fresh histogram
        (None when the family does not exist) — the cross-tier view."""
        with self._lock:
            fam = self._metrics.get(("histogram", name))
            insts = list(fam.values()) if fam else []
        if not insts:
            return None
        out = Histogram(insts[0].bounds)
        for h in insts:
            out.merge(h)
        return out

    def snapshot(self) -> Dict[str, dict]:
        """{"kind:name{labels}": value-or-histogram-snapshot} for tests."""
        with self._lock:
            fams = {k: dict(v) for k, v in self._metrics.items()}
        out: Dict[str, dict] = {}
        for (kind, name), fam in sorted(fams.items()):
            for key, inst in sorted(fam.items()):
                label = _label_str(key)
                if kind == "histogram":
                    out[f"{kind}:{name}{label}"] = inst.snapshot()
                else:
                    out[f"{kind}:{name}{label}"] = {"value": inst.value}
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format v0.0.4: counters/gauges as
        plain samples, histograms as cumulative ``_bucket{le=...}`` series
        plus ``_sum``/``_count``."""
        lines: List[str] = []
        with self._lock:
            fams = {k: dict(v) for k, v in self._metrics.items()}
        for (kind, name), fam in sorted(fams.items()):
            lines.append(f"# TYPE {name} {kind}")
            for key, inst in sorted(fam.items()):
                if kind != "histogram":
                    lines.append(f"{name}{_label_str(key)} {inst.value:g}")
                    continue
                snap = inst.snapshot()
                cum = 0
                for bound, c in zip(snap["bounds"], snap["counts"]):
                    cum += c
                    bkey = key + (("le", f"{bound:g}"),)
                    lines.append(f"{name}_bucket{_label_str(bkey)} {cum}")
                bkey = key + (("le", "+Inf"),)
                lines.append(f"{name}_bucket{_label_str(bkey)} {snap['total']}")
                lines.append(f"{name}_sum{_label_str(key)} {snap['sum']:g}")
                lines.append(f"{name}_count{_label_str(key)} {snap['total']}")
        return "\n".join(lines) + "\n"


_DEFAULT_REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry the router/scheduler/launchers record into
    when not handed a private one."""
    return _DEFAULT_REGISTRY


# ---------------------------------------------------------------------------
# MonitorSampler: per-tier gauge time series (the resource-usage depository)
# ---------------------------------------------------------------------------


class MonitorSampler:
    """Background sampler over a ``CapacityGauge``'s stats probes.

    Every ``interval_s`` it snapshots each registered rich probe
    (``capacity_now``-style dicts) into a bounded per-tier ring buffer of
    ``{"t", "occupancy", "free_pages", "free_slots", "queue_depth",
    "prefill_backlog", "warmth", "cached_pages", "prefix_hit_rate"}``
    samples — the time series ROADMAP item
    5's short-horizon forecaster consumes. ``window(tier, last_s)`` returns
    the recent slice; reads and the sampling thread share a lock, so
    windows are consistent under concurrent sampling. When a registry is
    attached, each sample also updates ``tier_*`` gauges so the series'
    current point rides the Prometheus exposition."""

    def __init__(
        self,
        gauge: CapacityGauge,
        interval_s: float = 0.05,
        capacity: int = 4096,
        registry: Optional[MetricsRegistry] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.gauge = gauge
        self.interval_s = interval_s
        self.capacity = capacity
        self.registry = registry
        self.clock = clock
        self._lock = threading.Lock()
        self._series: Dict[str, Deque[dict]] = {}  # guarded by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples_taken = 0

    # -- lifecycle -----------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "MonitorSampler":
        with self._lock:
            if self._thread is not None:
                raise RuntimeError("monitor sampler already started")
            self._stop.clear()
            t = self._thread = threading.Thread(
                target=self._run, daemon=True, name="monitor-sampler")
        t.start()
        return self

    def stop(self) -> None:
        """Idempotent and re-entrancy-safe: the thread handle is swapped out
        under the ring lock, so of N concurrent stops exactly one joins (the
        rest see None); the join itself runs with no lock held — a stop
        racing a mid-sweep ``sample_once`` must never wait on a thread that
        is about to take the lock we hold. Safe to call from the sampler
        thread itself (a probe that stops its own sampler cannot self-join)."""
        self._stop.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None and t is not threading.current_thread():
            t.join()

    def __enter__(self) -> "MonitorSampler":
        if self._thread is None:
            self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        while not self._stop.is_set():
            self.sample_once()
            self._stop.wait(self.interval_s)

    # -- sampling -------------------------------------------------------------
    def sample_once(self, t: Optional[float] = None) -> Dict[str, dict]:
        """One synchronous sweep over every stats probe (tests drive this
        instead of ``start()``); returns {tier: sample}. A probe that raises
        is skipped for this tick — a flapping tier must not kill the
        sampler."""
        now = self.clock() if t is None else t
        out: Dict[str, dict] = {}
        for tier in self.gauge.stat_names():
            try:
                stats = self.gauge.stats(tier)
            except Exception:
                continue
            if stats is None:
                continue
            sample = {
                "t": now,
                "occupancy": batch_occupancy(stats),
                "free_pages": stats.get("free_pages"),
                "free_slots": stats.get("free_slots"),
                "queue_depth": queue_depth(stats),
                "prefill_backlog": prefill_backlog(stats),
                "warmth": warm_fraction(stats),
                "cached_pages": cached_pages(stats),
                "prefix_hit_rate": prefix_hit_rate(stats),
                # storage format rides along so a dashboard can annotate the
                # byte-capacity series; the dtype STRING stays out of the
                # numeric registry loop below
                "kv_bytes_per_token": kv_bytes_per_token(stats),
                "kv_cache_dtype": kv_cache_dtype(stats),
            }
            with self._lock:
                ring = self._series.get(tier)
                if ring is None:
                    ring = self._series[tier] = deque(maxlen=self.capacity)
                ring.append(sample)
                self.samples_taken += 1
            out[tier] = sample
            if self.registry is not None:
                labels = {"tier": tier}
                for key in ("occupancy", "queue_depth", "prefill_backlog", "warmth",
                            "free_pages", "free_slots", "cached_pages",
                            "prefix_hit_rate", "kv_bytes_per_token"):
                    v = sample[key]
                    if v is not None:
                        self.registry.gauge(f"tier_{key}", labels).set(float(v))
        return out

    # -- reads ----------------------------------------------------------------
    def tiers(self) -> List[str]:
        with self._lock:
            return list(self._series)

    def series(self, tier: str) -> List[dict]:
        with self._lock:
            ring = self._series.get(tier)
            return list(ring) if ring else []

    def latest(self, tier: str) -> Optional[dict]:
        with self._lock:
            ring = self._series.get(tier)
            return ring[-1] if ring else None

    def window(self, tier: str, last_s: float) -> List[dict]:
        """Samples for ``tier`` within the trailing ``last_s`` seconds
        (consistent snapshot under concurrent sampling)."""
        cutoff = self.clock() - last_s
        with self._lock:
            ring = self._series.get(tier)
            return [s for s in ring if s["t"] >= cutoff] if ring else []
