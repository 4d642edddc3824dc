"""Paper Fig 8: response-time comparison — Flask (local) fastest at low
load; Docker/serverless pay activation overhead."""
from __future__ import annotations

from repro_torch.benchmarks.common import emit
from repro_torch.core import SimConfig, Simulation, StaticPolicy, Tier
from repro_torch.core.testbed import paper_tiers
from repro_torch.core.workload import ramp


def main() -> None:
    for name, tier in (("flask", Tier.FLASK), ("docker", Tier.DOCKER), ("serverless", Tier.SERVERLESS)):
        sim = Simulation(StaticPolicy(tier), paper_tiers(seed=1), SimConfig())
        m = sim.run(ramp(400, seed=42))
        s = m.summary()
        emit(
            f"fig8.response.{name}",
            s["median_response_s"] * 1e6,
            f"mean_s={s['mean_response_s']:.3f};p95_s={s['p95_response_s']:.3f}",
        )


if __name__ == "__main__":
    main()
