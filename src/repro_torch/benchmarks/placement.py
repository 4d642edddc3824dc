"""The scheduler table: StraightLine (Algorithm 1) vs static / round-robin /
random / SLO-aware / adaptive-thresholds under the mixed bimodal ramp.

The two decision-latency rows time the Python loop on the host and
``placing_batch_torch`` at N 1024 on ``--device`` (default the card, which
raises without one)."""
from __future__ import annotations

import argparse

import torch

from repro_torch.benchmarks.common import emit, timeit_us
from repro_torch.core import (
    RandomPolicy,
    Request,
    RoundRobinPolicy,
    SimConfig,
    Simulation,
    SLOAwarePolicy,
    StaticPolicy,
    StraightLinePolicy,
    Thresholds,
    Tier,
)
from repro_torch.core.estimator import LatencyEstimator, transfer_time
from repro_torch.core.placing import placing_batch_torch
from repro_torch.core.testbed import paper_tiers
from repro_torch.core.workload import ramp
from repro_torch.models.common import resolve_device

LOADS = [1000, 3000, 6000]


def slo_policy(tiers):
    models = {
        t: (lambda sim: (lambda r, f: LatencyEstimator.service_time(sim.app, r.work_units, sim.cfg.slice_)
             + transfer_time(r.data_size, sim.cfg.net_bw) + sim.cfg.activation_s))(sim)
        for t, sim in tiers.items()
    }
    return SLOAwarePolicy(models)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="device of the vectorized placer (default: the card)")
    dev = resolve_device(ap.parse_args(argv).device)
    for load in LOADS:
        tiers0 = paper_tiers(seed=1)
        policies = [
            StraightLinePolicy(),
            StaticPolicy(Tier.FLASK),
            StaticPolicy(Tier.DOCKER),
            StaticPolicy(Tier.SERVERLESS),
            RoundRobinPolicy(),
            RandomPolicy(),
            slo_policy(tiers0),
        ]
        for pol in policies:
            sim = Simulation(pol, paper_tiers(seed=1), SimConfig())
            s = sim.run(ramp(load, dist="bimodal", seed=load)).summary()
            emit(
                f"placement.{pol.name}.load{load}",
                s["median_response_s"] * 1e6,
                f"fail_rate={s['failure_rate']:.3f};p95_s={s['p95_response_s']:.2f}",
            )

    # decision-latency microbenches (router hot path)
    pol = StraightLinePolicy(Thresholds())
    r = Request(rid=0, arrival_t=0.0, data_size=2e5)
    us = timeit_us(lambda: pol.place(r, 900.0, 1, 1), n=5000)
    emit("placement.decide.python", us, "single-request Algorithm 1")

    sizes = torch.full((1024,), 1e5, dtype=torch.float32, device=dev)

    def batch():
        placing_batch_torch(900.0, sizes, 4, 8, F=1200.0, D=1e6)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    us = timeit_us(batch, n=200)
    emit("placement.decide.torch_batch1024", us, f"per_req_ns={us/1024*1000:.1f};device={dev.type}")


if __name__ == "__main__":
    main()
