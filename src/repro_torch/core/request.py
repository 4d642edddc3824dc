"""Request / placement types for the StraightLine scheduler."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional


class Tier(enum.IntEnum):
    """Execution tiers. Names follow the paper; the TPU-pod analogue is in
    parentheses (DESIGN.md §2)."""

    FLASK = 0       # local web server  (interactive slice)
    DOCKER = 1      # container/RESTful (batch slice, continuous batching)
    SERVERLESS = 2  # AWS Lambda        (elastic on-demand slices)


@dataclass
class Request:
    rid: int
    arrival_t: float
    data_size: float             # bytes of input payload (paper's r_d)
    model: str = "xception"      # which deployed model this request targets
    work_units: float = 1.0      # estimator cost units (e.g. tokens, pixels)
    timeout_s: float = 50.0      # paper: 50 s on both web server and Lambda
    slo_s: Optional[float] = None  # optional SLO target (beyond-paper policies)

    # filled by the router/simulator
    tier: Optional[Tier] = None
    start_t: Optional[float] = None
    finish_t: Optional[float] = None
    failed: bool = False
    fail_reason: str = ""
    hedged: bool = False
    # lifecycle trace context (core/tracing.Trace), set by the router when a
    # tracer is attached; a hedged copy (copy.copy) SHARES it — both racing
    # executions record onto the same trace, on distinct lanes
    trace: Optional[object] = field(default=None, repr=False, compare=False)

    @property
    def wait_s(self) -> float:
        return (self.start_t - self.arrival_t) if self.start_t is not None else 0.0

    @property
    def response_s(self) -> Optional[float]:
        """Paper's 'response time' (and 'session length' = time in system)."""
        return (self.finish_t - self.arrival_t) if self.finish_t is not None else None


@dataclass
class PlacementDecision:
    rid: int
    tier: Tier
    reason: str = ""
