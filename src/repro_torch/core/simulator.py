"""Discrete-event simulation of the hybrid serving estate.

Reproduces the paper's testbed methodology: a load generator (workload.py,
the Artillery analogue) emits requests; the placing policy routes each one at
arrival; tiers model service, queuing, cold starts, timeouts, throttling.
Outputs the paper's metrics (failed rate, session length, response time).

Also implements beyond-paper fault tolerance: hedged requests (straggler
mitigation — a copy is fired at the elastic tier if the primary hasn't
finished by the hedge deadline; first finish wins) and retry-on-failure.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.placing import StraightLinePolicy, place_compat, takes_warmup
from repro_torch.core.request import Request, Tier
from repro_torch.core.telemetry import FrequencyEstimator, Metrics
from repro_torch.core.tiers import TierSim
from repro_torch.core.tracing import Tracer


@dataclass
class SimConfig:
    hedge_after_s: Optional[float] = None     # straggler mitigation
    retry_failed_on_elastic: bool = False     # retry-once fault tolerance
    autoscaler: Optional[object] = None       # core.autoscaler.Autoscaler
    window_s: float = 180.0


class Simulation:
    def __init__(self, policy, tiers: Dict[Tier, TierSim], cfg: SimConfig = SimConfig(),
                 tracer: Optional[Tracer] = None):
        self.policy = policy
        self.tiers = tiers
        self.cfg = cfg
        self.freq = FrequencyEstimator(window_s=cfg.window_s)
        self.metrics = Metrics()
        # optional lifecycle tracing; trace timestamps here are SIM time
        # (seconds on the event-queue clock), never wall time — a trace is
        # internally consistent, do not mix the two bases in one tracer
        self.tracer = tracer
        self._events: List = []
        self._seq = itertools.count()
        self._done: Dict[int, bool] = {}
        self._f_t = 0.0
        self._takes_warmup = takes_warmup(policy)

    def _warmup(self) -> Optional[Dict[Tier, float]]:
        """Per-tier warm-up fractions when any tier binds a live stats probe
        (hybrid sim/real testbeds); None keeps placement purely paper-faithful."""
        snap = {
            t: w for t, sim in self.tiers.items() if (w := sim.warm_fraction()) is not None
        }
        return snap or None

    # -- event plumbing -----------------------------------------------------
    def _push(self, t: float, kind: str, payload) -> None:
        heapq.heappush(self._events, (t, next(self._seq), kind, payload))

    # -- tier execution -----------------------------------------------------
    def _start_service(self, req: Request, tier: TierSim, now: float) -> None:
        svc = tier.service_time(req, now)
        req.start_t = now
        if req.trace is not None:
            req.trace.add_span("service", now, now + svc,
                               lane=tier.cfg.tier.name.lower(), service_s=svc)
        if tier.cfg.tier == Tier.SERVERLESS:
            tier.inflight += 1
            tier.warm_instances.append(now + svc)
        else:
            tier.busy += 1
        tier.busy_time += svc
        self._push(now + svc, "finish", (req, tier))

    def _submit(self, req: Request, tier_id: Tier, now: float) -> None:
        tier = self.tiers[tier_id]
        req.tier = tier_id
        fail = tier.admission_failure(now, self._f_t)
        if fail is not None:
            self._fail(req, now, fail)
            return
        if tier.cfg.tier == Tier.SERVERLESS or tier.worker_free():
            self._start_service(req, tier, now)
        elif len(tier.queue) < tier.cfg.queue_cap:
            tier.queue.append(req)
            if req.trace is not None:
                req.trace.event("enqueued", lane=tier_id.name.lower(), t=now,
                                depth=len(tier.queue))
        else:
            self._fail(req, now, "queue-overflow")

    def _fail(self, req: Request, now: float, reason: str) -> None:
        if self._done.get(req.rid):
            return
        if self.cfg.retry_failed_on_elastic and not req.hedged and req.tier != Tier.SERVERLESS:
            req.hedged = True
            if req.trace is not None:
                req.trace.event("retry_spill", t=now, reason=reason)
            self._submit(req, Tier.SERVERLESS, now)
            return
        self._done[req.rid] = True
        req.failed = True
        req.fail_reason = reason
        req.finish_t = now
        self.metrics.record(req)
        if req.trace is not None:
            req.trace.event("failed", t=now, reason=reason)
            self._finish_trace(req)

    def _finish(self, req: Request, tier: TierSim, now: float) -> None:
        if tier.cfg.tier == Tier.SERVERLESS:
            tier.inflight -= 1
        else:
            tier.busy -= 1
            if tier.queue:
                nxt = tier.queue.popleft()
                if now - nxt.arrival_t > nxt.timeout_s:
                    self._fail(nxt, now, "timeout-in-queue")
                else:
                    self._start_service(nxt, tier, now)
        if self._done.get(req.rid):
            return
        if now - req.arrival_t > req.timeout_s:
            self._fail(req, now, "timeout")
            return
        self._done[req.rid] = True
        req.finish_t = now
        tier.served += 1
        self.metrics.record(req)
        self._finish_trace(req)

    def _finish_trace(self, req: Request) -> None:
        if self.tracer is not None and req.trace is not None:
            self.tracer.finish(
                req.trace,
                tier=req.tier.name if req.tier is not None else None,
                failed=req.failed, fail_reason=req.fail_reason,
                response_s=req.response_s, hedged=req.hedged,
            )

    # -- main loop ------------------------------------------------------------
    def run(self, requests: List[Request]) -> Metrics:
        for r in requests:
            self._push(r.arrival_t, "arrival", r)
        last_scale = 0.0
        while self._events:
            now, _, kind, payload = heapq.heappop(self._events)
            if kind == "arrival":
                req: Request = payload
                self.freq.observe(now)
                f_t = self.freq.frequency(now)
                self._f_t = f_t
                flask_free = self.tiers[Tier.FLASK].free_slots()
                docker_free = self.tiers[Tier.DOCKER].free_slots()
                d = place_compat(
                    self.policy,
                    req,
                    f_t,
                    flask_free,
                    docker_free,
                    self._warmup,
                    self._takes_warmup,
                )
                if self.tracer is not None:
                    req.trace = self.tracer.begin(
                        req.rid, t0=now, data_size=req.data_size, model=req.model
                    )
                    if req.trace is not None:
                        req.trace.add_span(
                            "placement", now, now, f_t=f_t, flask_free=flask_free,
                            docker_free=docker_free, tier=d.tier.name, reason=d.reason,
                        )
                self._submit(req, d.tier, now)
                if self.cfg.hedge_after_s is not None and d.tier != Tier.SERVERLESS:
                    self._push(now + self.cfg.hedge_after_s, "hedge", req)
                if self.cfg.autoscaler is not None and now - last_scale > 1.0:
                    self.cfg.autoscaler.step(self, now, f_t)
                    last_scale = now
            elif kind == "finish":
                req, tier = payload
                self._finish(req, tier, now)
            elif kind == "hedge":
                req = payload
                if not self._done.get(req.rid) and req.start_t is None:
                    # still queued somewhere: fire a copy at the elastic tier
                    req.hedged = True
                    if req.trace is not None:
                        req.trace.event("hedge_fired", t=now)
                    self._submit(req, Tier.SERVERLESS, now)
        return self.metrics

    # -- introspection ---------------------------------------------------------
    def tier_stats(self) -> Dict[str, dict]:
        out = {}
        for t, sim in self.tiers.items():
            out[t.name.lower()] = {
                "served": sim.served,
                "busy_time_s": round(sim.busy_time, 2),
            }
        return out
