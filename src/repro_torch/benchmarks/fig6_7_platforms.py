"""Paper Figs 6-7: failure-rate comparison across compute platforms as the
session count grows — serverless degrades gracefully, fixed tiers collapse."""
from __future__ import annotations

from repro_torch.benchmarks.common import emit
from repro_torch.core import SimConfig, Simulation, StaticPolicy, StraightLinePolicy, Tier
from repro_torch.core.testbed import paper_tiers
from repro_torch.core.workload import ramp

LOADS = [500, 1300, 2500, 4000, 6000]


def main() -> None:
    policies = [
        ("flask", StaticPolicy(Tier.FLASK), "3GB"),
        ("docker", StaticPolicy(Tier.DOCKER), "3GB"),
        ("serverless2GB", StaticPolicy(Tier.SERVERLESS), "2GB"),
        ("serverless3GB", StaticPolicy(Tier.SERVERLESS), "3GB"),
        ("straightline", StraightLinePolicy(), "3GB"),
    ]
    for load in LOADS:
        for name, pol, mem in policies:
            sim = Simulation(pol, paper_tiers(seed=1, elastic_mem=mem), SimConfig())
            s = sim.run(ramp(load, seed=load)).summary()
            emit(
                f"fig6_7.{name}.load{load}",
                s["median_response_s"] * 1e6,
                f"fail_rate={s['failure_rate']:.3f}",
            )


if __name__ == "__main__":
    main()
