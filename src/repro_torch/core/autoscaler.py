"""Elastic-tier autoscaling (paper future-work §3, implemented here).

Keeps a warm-instance pool sized to the observed arrival rate so bursts do
not pay cold starts: warm_target = ceil(rate * (avg_service + cold_start)),
Little's-law style, with hysteresis to avoid thrash.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.estimator import LatencyEstimator
from repro_torch.core.request import Tier


@dataclass
class Autoscaler:
    headroom: float = 1.2
    max_warm: int = 4096
    _last_target: int = 0

    def step(self, sim, now: float, f_t: float) -> int:
        tier = sim.tiers[Tier.SERVERLESS]
        rate = f_t / sim.cfg.window_s
        cold = LatencyEstimator.cold_start(tier.app, tier.cfg.slice_)
        avg_svc = LatencyEstimator.service_time(tier.app, 1.0, tier.cfg.slice_)
        target = min(self.max_warm, math.ceil(rate * (avg_svc + cold) * self.headroom))
        # hysteresis: shrink slowly
        if target < self._last_target:
            target = max(target, int(self._last_target * 0.9))
        self._last_target = target
        warm_now = len(tier.warm_instances)
        if target > warm_now:
            # pre-warm: instances become usable after one cold start
            tier.warm_instances.extend([now + cold] * (target - warm_now))
        return target
