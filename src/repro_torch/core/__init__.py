"""StraightLine core: the paper's primary contribution.

Empirical Dynamic Placing (Algorithm 1), telemetry, tracing and the online
router — copies of the JAX package's JAX-free modules with their imports
rewritten. The simulator, tier models and ``placing_batch_jax`` are not
ported yet.
"""
from repro_torch.core.placing import (
    AdaptiveThresholds,
    RandomPolicy,
    RoundRobinPolicy,
    SLOAwarePolicy,
    StaticPolicy,
    StraightLinePolicy,
    Thresholds,
)
from repro_torch.core.request import PlacementDecision, Request, Tier
from repro_torch.core.telemetry import (
    CapacityGauge,
    Counter,
    FrequencyEstimator,
    Gauge,
    Histogram,
    Metrics,
    MetricsRegistry,
    MonitorSampler,
    batch_occupancy,
    default_registry,
    log_buckets,
    prefill_backlog,
    queue_depth,
    warm_fraction,
)
from repro_torch.core.tracing import NULL_TRACER, Trace, Tracer, trace_now

__all__ = [
    "AdaptiveThresholds",
    "CapacityGauge",
    "Counter",
    "FrequencyEstimator",
    "Gauge",
    "Histogram",
    "Metrics",
    "MetricsRegistry",
    "MonitorSampler",
    "NULL_TRACER",
    "PlacementDecision",
    "RandomPolicy",
    "Request",
    "RoundRobinPolicy",
    "SLOAwarePolicy",
    "StaticPolicy",
    "StraightLinePolicy",
    "Thresholds",
    "Tier",
    "Trace",
    "Tracer",
    "batch_occupancy",
    "default_registry",
    "log_buckets",
    "prefill_backlog",
    "queue_depth",
    "trace_now",
    "warm_fraction",
]
