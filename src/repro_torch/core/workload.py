"""Artillery-analog workload generation (paper §III.C).

The paper drives each platform with ramps of "total sessions per 180 s" from
10 up to 7000. ``ramp()`` reproduces that: N arrivals over the window with a
linearly increasing instantaneous rate. Payload sizes model the image
requests (299x299 JPEGs around ~180 KB) or LM prompts; a bimodal option
exercises Algorithm 1's D threshold.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.request import Request


def _sizes(rng, n: int, dist: str) -> np.ndarray:
    if dist == "image":          # ~299x299 JPEG payloads
        return np.clip(rng.lognormal(np.log(180e3), 0.35, n), 20e3, 2e6)
    if dist == "image-hires":    # the paper's medical-image example
        return np.clip(rng.lognormal(np.log(6e6), 0.4, n), 2e6, 40e6)
    if dist == "bimodal":        # small + large mix across threshold D
        small = rng.lognormal(np.log(150e3), 0.3, n)
        large = rng.lognormal(np.log(8e6), 0.4, n)
        pick = rng.random(n) < 0.8
        return np.where(pick, small, large)
    if dist == "tokens":         # LM prompts: bytes ~ 4x token count
        toks = np.clip(rng.lognormal(np.log(600), 0.8, n), 16, 32768)
        return toks * 4.0
    raise ValueError(dist)


def ramp(
    total_sessions: int,
    duration_s: float = 180.0,
    dist: str = "image",
    model: str = "xception",
    timeout_s: float = 50.0,
    seed: int = 0,
    start_rate_frac: float = 0.1,
) -> List[Request]:
    """N sessions over the window with linearly increasing rate (Artillery
    ramp phase). start_rate_frac sets rate(0) relative to rate(duration)."""
    rng = np.random.default_rng(seed)
    n = int(total_sessions)
    # inverse-CDF sampling of a linear rate profile
    u = np.sort(rng.random(n))
    a = start_rate_frac
    t = duration_s * (np.sqrt(a * a + (1 - a * a) * u) - a) / (1 - a) if a != 1 else u * duration_s
    sizes = _sizes(rng, n, dist)
    out = []
    for i in range(n):
        out.append(
            Request(
                rid=i,
                arrival_t=float(t[i]),
                data_size=float(sizes[i]),
                model=model,
                work_units=float(max(1.0, sizes[i] / 180e3)),
                timeout_s=timeout_s,
            )
        )
    return out


def poisson(
    rate_per_s: float,
    duration_s: float = 180.0,
    dist: str = "image",
    model: str = "xception",
    timeout_s: float = 50.0,
    seed: int = 0,
) -> List[Request]:
    rng = np.random.default_rng(seed)
    t = 0.0
    out: List[Request] = []
    i = 0
    while True:
        t += rng.exponential(1.0 / rate_per_s)
        if t > duration_s:
            break
        size = float(_sizes(rng, 1, dist)[0])
        out.append(
            Request(rid=i, arrival_t=t, data_size=size, model=model,
                    work_units=max(1.0, size / 180e3), timeout_s=timeout_s)
        )
        i += 1
    return out


def burst(
    background_rate: float,
    burst_rate: float,
    burst_at_s: float,
    burst_len_s: float,
    duration_s: float = 180.0,
    dist: str = "image",
    seed: int = 0,
) -> List[Request]:
    """Steady background + a hard burst — the elastic tier's reason to exist."""
    base = poisson(background_rate, duration_s, dist=dist, seed=seed)
    extra = poisson(burst_rate, burst_len_s, dist=dist, seed=seed + 1)
    for r in extra:
        r.arrival_t += burst_at_s
    reqs = sorted(base + extra, key=lambda r: r.arrival_t)
    for i, r in enumerate(reqs):
        r.rid = i
    return reqs
