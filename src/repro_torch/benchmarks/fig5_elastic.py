"""Paper Fig 5: elastic tier with 2 GB vs 3 GB memory classes. Claims:
failed rate drops with provisioned memory; median response ~flat in load."""
from __future__ import annotations

from repro_torch.benchmarks.common import emit
from repro_torch.core import SimConfig, Simulation, StaticPolicy, Tier
from repro_torch.core.testbed import paper_tiers
from repro_torch.core.workload import ramp

LOADS = [500, 2000, 4000, 6000]


def main() -> None:
    for mem in ("2GB", "3GB"):
        for load in LOADS:
            sim = Simulation(
                StaticPolicy(Tier.SERVERLESS), paper_tiers(seed=1, elastic_mem=mem), SimConfig()
            )
            s = sim.run(ramp(load, seed=load)).summary()
            emit(
                f"fig5.elastic.{mem}.load{load}",
                s["median_response_s"] * 1e6,
                f"fail_rate={s['failure_rate']:.3f};p95_s={s['p95_response_s']:.2f}",
            )


if __name__ == "__main__":
    main()
