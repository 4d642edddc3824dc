"""StraightLine core: the paper's primary contribution.

Empirical Dynamic Placing (Algorithm 1) and its vectorized torch form,
telemetry, tracing, the tier models, the discrete-event hybrid-infrastructure
simulator and the online router — copies of the JAX package's JAX-free
modules with their imports rewritten. The estimator carries one H100 card's
rates; the paper testbed's tiers keep the paper machines' calibrated rates.
"""
from repro_torch.core.placing import (
    AdaptiveThresholds,
    RandomPolicy,
    RoundRobinPolicy,
    SLOAwarePolicy,
    StaticPolicy,
    StraightLinePolicy,
    Thresholds,
    placing_batch_torch,
)
from repro_torch.core.request import PlacementDecision, Request, Tier
from repro_torch.core.simulator import SimConfig, Simulation
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
from repro_torch.core.tiers import TierConfig, TierSim
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
    "SimConfig",
    "Simulation",
    "StaticPolicy",
    "StraightLinePolicy",
    "Thresholds",
    "Tier",
    "TierConfig",
    "TierSim",
    "Trace",
    "Tracer",
    "batch_occupancy",
    "default_registry",
    "log_buckets",
    "placing_batch_torch",
    "prefill_backlog",
    "queue_depth",
    "trace_now",
    "warm_fraction",
]
