"""Empirical Dynamic Placing Algorithm (paper Algorithm 1) + variants.

Faithful control flow::

    if f_t > F and r_d < D:   serverless     # burst of small payloads
    elif r_d > D:             docker         # large payload, latency-tolerant
    elif S_F available:       flask          # moderate -> lowest latency
    elif S_D available:       docker
    else:                     serverless

Variants (paper §IV future work, implemented here as beyond-paper features):
  * SLOAwarePolicy        — picks argmin estimated-completion subject to SLO
  * AdaptiveThresholds    — F/D re-fit online from telemetry + tier models
  * placing_batch_torch   — vectorized torch version for high-rate routers
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.request import PlacementDecision, Request, Tier


@dataclass
class Thresholds:
    F: float = 1200.0   # requests / window — the paper's interactive-tier knee
    D: float = 1.0e6    # bytes — payloads above this go to the batch tier


def takes_warmup(policy) -> bool:
    """Whether ``policy.place`` accepts the ``warmup`` kwarg. Only policies
    that *consume* warm-up state declare it (StraightLinePolicy); the
    warmup-blind ones keep the 4-arg signature so ``place_compat`` skips
    the stats probes entirely for them."""
    try:
        return "warmup" in inspect.signature(policy.place).parameters
    except (TypeError, ValueError):
        return False


def place_compat(
    policy,
    req: Request,
    f_t: float,
    flask_free: int,
    docker_free: int,
    warmup_fn: Callable[[], Optional[dict]],
    warmup_capable: bool,
) -> PlacementDecision:
    """The one placement call site shared by the router and the simulator:
    passes warm-up state only when the policy accepts it (``warmup_capable``
    is the cached ``takes_warmup(policy)``), evaluating ``warmup_fn`` lazily
    so warmup-blind policies never pay for stats probes."""
    if warmup_capable:
        return policy.place(req, f_t, flask_free, docker_free, warmup=warmup_fn())
    return policy.place(req, f_t, flask_free, docker_free)


def _warm_info(warmup: Optional[dict], tier: Tier):
    """(warm_fraction, compile_cost_s) for a tier. Entries may be a bare
    float (cost unknown) or a dict {"warmth": f, "compile_cost_s": s} built
    from the engine's measured compile-time EMA. Tiers without warm-up state
    (static backends, no probe) are treated as fully warm."""
    if warmup is None:
        return 1.0, None
    v = warmup.get(tier)
    if v is None:
        return 1.0, None
    if isinstance(v, dict):
        return float(v.get("warmth", 1.0)), v.get("compile_cost_s")
    return float(v), None


class StraightLinePolicy:
    """Algorithm 1, line-for-line — plus warm-up-aware availability.

    ``warmup`` (optional) maps tiers to their bucket-compilation progress in
    [0, 1] (``compile_events / total_buckets`` from ``capacity_now()``) —
    either bare, or wrapped with the engine's measured per-compile cost
    (``{"warmth": f, "compile_cost_s": s}`` from the ``compile_ema_s`` EMA).
    While a tier is still compiling its prefill buckets, a request routed
    there may hit an XLA compile instead of a warm kernel; when both
    interactive and batch tiers are available, the policy therefore prefers
    the *warmer* one — but only when the detour is worth it: with a measured
    compile cost, the expected cold penalty ``(1 - warmth) *
    compile_cost_s`` must exceed ``hop_cost_s`` (the latency price of
    hopping interactive -> batch) or the warmth gap is ignored (a one-bucket
    gap on a tiny model is not worth a tier hop). The faithful lines 3/6
    (burst and large-payload) and the fall-through order are untouched; with
    ``warmup=None`` the decision is byte-identical to the paper's
    Algorithm 1."""

    name = "straightline"

    def __init__(self, thresholds: Thresholds = Thresholds(), hop_cost_s: float = 0.05):
        self.th = thresholds
        self.hop_cost_s = hop_cost_s

    def place(
        self,
        req: Request,
        f_t: float,
        flask_free: int,
        docker_free: int,
        warmup: Optional[dict] = None,
    ) -> PlacementDecision:
        th = self.th
        if f_t > th.F and req.data_size < th.D:                      # line 3
            return PlacementDecision(req.rid, Tier.SERVERLESS, "f_t>F and r_d<D")
        if req.data_size > th.D:                                     # line 6
            return PlacementDecision(req.rid, Tier.DOCKER, "r_d>D")
        if flask_free > 0:                                           # line 10
            wf, cf = _warm_info(warmup, Tier.FLASK)
            wd, _ = _warm_info(warmup, Tier.DOCKER)
            if docker_free > 0 and wd > wf and self._hop_pays(wf, cf):
                # both available but flask is still compiling its buckets
                # (and the expected compile stall outweighs the tier hop):
                # route to the warmer batch tier until flask catches up
                return PlacementDecision(
                    req.rid, Tier.DOCKER, f"S_F cold (warm {wf:.2f}<{wd:.2f}), S_D warmer"
                )
            return PlacementDecision(req.rid, Tier.FLASK, "S_F non-empty")
        if docker_free > 0:                                          # line 14
            return PlacementDecision(req.rid, Tier.DOCKER, "S_F empty, S_D non-empty")
        return PlacementDecision(req.rid, Tier.SERVERLESS, "all busy")  # line 18

    def _hop_pays(self, warmth: float, compile_cost_s: Optional[float]) -> bool:
        """Is detouring off the interactive tier worth its remaining warm-up?
        With no measured compile cost the gap alone decides (original
        behavior); with one, the expected stall of a cold bucket —
        ``(1 - warmth) * compile_cost_s`` — must exceed the tier-hop price."""
        if compile_cost_s is None:
            return True
        return (1.0 - warmth) * float(compile_cost_s) > self.hop_cost_s

    def place_all(
        self,
        reqs: Sequence[Request],
        f_t: float,
        flask_free: int,
        docker_free: int,
        warmup: Optional[dict] = None,
    ):
        """Paper's batch form: place a waiting queue R, consuming availability.
        Every docker placement consumes docker availability — including the
        unconditional large-payload path — keyed on the decision tier."""
        out: List[PlacementDecision] = []
        ff, df = flask_free, docker_free
        for r in reqs:
            d = self.place(r, f_t, ff, df, warmup=warmup)
            if d.tier == Tier.FLASK:
                ff -= 1
            elif d.tier == Tier.DOCKER:
                df -= 1
            out.append(d)
        return out


class StaticPolicy:
    """Everything to one tier — the paper's per-platform evaluation curves."""

    def __init__(self, tier: Tier):
        self.tier = tier
        self.name = f"static-{tier.name.lower()}"

    def place(self, req, f_t, flask_free, docker_free):
        return PlacementDecision(req.rid, self.tier, "static")


class RoundRobinPolicy:
    name = "round-robin"

    def __init__(self):
        self._i = 0

    def place(self, req, f_t, flask_free, docker_free):
        t = Tier(self._i % 3)
        self._i += 1
        return PlacementDecision(req.rid, t, "rr")


class RandomPolicy:
    name = "random"

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def place(self, req, f_t, flask_free, docker_free):
        return PlacementDecision(req.rid, Tier(int(self.rng.integers(0, 3))), "random")


class SLOAwarePolicy:
    """Beyond-paper (paper future-work §2): choose the cheapest tier whose
    estimated completion meets the request SLO; fall back to fastest."""

    name = "slo-aware"

    def __init__(self, tier_models, cost=(1.0, 0.6, 0.3)):
        self.tier_models = tier_models  # Tier -> callable(req, f_t) -> est seconds
        self.cost = cost                 # relative $ cost per tier

    def place(self, req, f_t, flask_free, docker_free):
        free = {Tier.FLASK: flask_free > 0, Tier.DOCKER: docker_free > 0, Tier.SERVERLESS: True}
        ests = {t: m(req, f_t) for t, m in self.tier_models.items()}
        slo = req.slo_s if req.slo_s is not None else req.timeout_s
        ok = [t for t in Tier if free[t] and ests[t] <= slo]
        if ok:
            pick = min(ok, key=lambda t: self.cost[int(t)])
            return PlacementDecision(req.rid, pick, f"slo est={ests[pick]:.3f}s")
        pick = min([t for t in Tier if free[t]], key=lambda t: ests[t])
        return PlacementDecision(req.rid, pick, "slo-miss fastest")


class AdaptiveThresholds:
    """Beyond-paper (paper future-work §3): re-fit F to the observed
    interactive-tier saturation knee and D to the tier crossover point."""

    def __init__(self, base: Thresholds, interactive_capacity_rps: float, window_s: float = 180.0):
        self.th = Thresholds(base.F, base.D)
        self.cap = interactive_capacity_rps
        self.window_s = window_s
        self._ewma_util = 0.0

    def update(self, interactive_utilization: float, docker_service_s: float, flask_service_s: float, link_bw: float = 10e6):
        # F: keep interactive below ~85% utilization of its measured capacity.
        self._ewma_util = 0.9 * self._ewma_util + 0.1 * interactive_utilization
        self.th.F = max(10.0, 0.85 * self.cap * self.window_s * (1.5 - self._ewma_util))
        # D: payload size where upload time starts to dominate the service gap.
        self.th.D = max(1e4, (docker_service_s - flask_service_s) * link_bw)
        return self.th


def placing_batch_torch(
    f_t,                     # () or (N,) requests/window: a number, or a tensor on r_d's device
    r_d: torch.Tensor,       # (N,) data sizes
    flask_free,              # int, or 0-d int tensor on r_d's device — availability snapshot
    docker_free,
    F: float,
    D: float,
) -> torch.Tensor:
    """Vectorized Algorithm 1 (availability consumed in arrival order):
    returns int32 tier ids (N,) on ``r_d``'s device, the twin of the JAX
    package's ``placing_batch_jax``. Rates and sizes are float32, and torch
    compares them with F and D rounded to float32, as JAX's weak typing
    does. Issues device work only: nothing here waits for the device."""
    N = r_d.shape[0]
    dev = r_d.device
    r_d = r_d.to(torch.float32)
    if isinstance(f_t, torch.Tensor):
        f_t = f_t.to(device=dev, dtype=torch.float32).expand(N)
    else:
        f_t = torch.full((N,), float(f_t), dtype=torch.float32, device=dev)
    # ranks are int32 and below N: a larger int pool is as good as N, and
    # would wrap if compared as int32
    if isinstance(flask_free, int):
        flask_free = min(flask_free, N)
    if isinstance(docker_free, int):
        docker_free = min(docker_free, N)
    burst = (f_t > F) & (r_d < D)
    big = r_d > D
    # availability is consumed by earlier requests in the batch
    want_flask = ~burst & ~big
    flask_rank = torch.cumsum(want_flask, 0, dtype=torch.int32) - 1
    got_flask = want_flask & (flask_rank < flask_free)
    want_docker2 = want_flask & ~got_flask
    # docker availability is consumed by every docker placement — large
    # payloads included. A docker2 candidate succeeds iff prior docker
    # consumers (bigs + earlier candidates, all of which succeed until the
    # pool is dry and none after) leave headroom.
    docker_rank = torch.cumsum(big | want_docker2, 0, dtype=torch.int32) - 1
    got_docker2 = want_docker2 & (docker_rank < docker_free)
    serverless = torch.full((N,), int(Tier.SERVERLESS), dtype=torch.int32, device=dev)
    return torch.where(
        burst,
        int(Tier.SERVERLESS),
        torch.where(
            big,
            int(Tier.DOCKER),
            torch.where(
                got_flask,
                int(Tier.FLASK),
                torch.where(got_docker2, int(Tier.DOCKER), serverless),
            ),
        ),
    )
