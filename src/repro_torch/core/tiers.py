"""Execution-tier models for the simulator and router.

Tier semantics mirror the paper's testbed (§III.A):

  * InteractiveTier (Flask/IIS): single-threaded service, bounded accept
    queue, 50 s timeout. Fastest per-request at low load; collapses past the
    saturation knee (paper Fig 4: ~1200-1300 sessions/180 s).
  * BatchTier (Docker/RESTful): k container workers, per-request activation
    overhead, larger queue. Best for large payloads (latency-tolerant).
  * ElasticTier (AWS Lambda): per-request instances with cold start, a warm
    pool with expiry, a concurrency ceiling and a memory class; failures
    rise when demand crosses the ceiling and fall with bigger memory
    (paper Fig 5a: 2 GB vs 3 GB).
"""
from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, List, Optional

from repro_torch.core.estimator import AppProfile, LatencyEstimator, SliceProfile, transfer_time
from repro_torch.core.request import Request, Tier
from repro_torch.core.telemetry import warm_fraction


@dataclass
class TierConfig:
    tier: Tier
    slice_: SliceProfile
    n_workers: int = 1
    queue_cap: int = 64
    activation_s: float = 0.0        # per-request container/batch overhead
    warm_expiry_s: float = 60.0      # elastic: warm-instance lifetime
    concurrency_limit: int = 10**9   # elastic: hard throttle ceiling
    net_bw: float = 50e6             # payload upload bandwidth to this tier
    freq_capacity: float = 1e12      # elastic: sessions/window before resource
                                      # contention sets in (memory class, Fig 5a)
    overload_fail_slope: float = 0.0 # elastic: P(fail) growth past 80% of capacity


class TierSim:
    """Server-pool state used by the discrete-event simulator.

    ``capacity_probe`` optionally binds a live capacity source (e.g. a
    ``CapacityGauge`` probe fed by a real serving engine's ``free_pages()``)
    so hybrid sim/real testbeds place against measured state instead of the
    queue-model constants. ``stats_probe`` optionally binds the richer
    ``capacity_now()`` snapshot from which ``warm_fraction()`` derives the
    tier's bucket-compilation progress for warm-up-aware placement.
    """

    def __init__(
        self,
        cfg: TierConfig,
        app: AppProfile,
        rng,
        capacity_probe: Optional[Callable[[], int]] = None,
        stats_probe: Optional[Callable[[], dict]] = None,
    ):
        self.cfg = cfg
        self.app = app
        self.rng = rng
        self.busy = 0
        self.queue: Deque[Request] = deque()
        self.warm_instances: List[float] = []   # elastic: free-at times
        self.inflight = 0
        self.served = 0
        self.busy_time = 0.0
        self.capacity_probe = capacity_probe
        self.stats_probe = stats_probe

    # -- availability (Algorithm 1's S_F / S_D) -----------------------------
    def free_slots(self) -> int:
        if self.capacity_probe is not None:
            live = self.capacity_probe()
            if live is not None:      # probe gone dark -> static queue model
                return max(0, int(live))
        if self.cfg.tier == Tier.SERVERLESS:
            return max(0, self.cfg.concurrency_limit - self.inflight)
        return max(0, self.cfg.n_workers - self.busy) + max(
            0, self.cfg.queue_cap - len(self.queue)
        )

    def worker_free(self) -> bool:
        return self.busy < self.cfg.n_workers

    def warm_fraction(self) -> Optional[float]:
        """Bucket-compilation progress of the live engine backing this tier
        (None when no stats probe is bound — the queue-model tiers have no
        warm-up phase)."""
        if self.stats_probe is None:
            return None
        return warm_fraction(self.stats_probe())

    # -- service model -------------------------------------------------------
    def service_time(self, req: Request, now: float) -> float:
        base = LatencyEstimator.service_time(self.app, req.work_units, self.cfg.slice_)
        t = base + transfer_time(req.data_size, self.cfg.net_bw) + self.cfg.activation_s
        if self.cfg.tier == Tier.SERVERLESS:
            # reuse a warm instance if one is free, else pay cold start
            self.warm_instances = [w for w in self.warm_instances if w > now - self.cfg.warm_expiry_s]
            free_warm = sum(1 for w in self.warm_instances if w <= now)
            if free_warm == 0:
                t += LatencyEstimator.cold_start(self.app, self.cfg.slice_)
        return t

    def admission_failure(self, now: float, f_t: float = 0.0) -> Optional[str]:
        """Elastic-tier throttling/contention failures (paper Fig 5a): the
        failure rate rises once the request frequency crosses ~80% of the
        memory class's capacity — the 2 GB class saturates earlier."""
        if self.cfg.tier != Tier.SERVERLESS:
            return None
        if self.inflight >= self.cfg.concurrency_limit:
            return "throttled"
        util = f_t / self.cfg.freq_capacity
        if util > 0.8 and self.cfg.overload_fail_slope > 0:
            p = min(0.95, self.cfg.overload_fail_slope * (util - 0.8))
            if self.rng.random() < p:
                return "resource-contention"
        return None
