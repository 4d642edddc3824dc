"""Paper Fig 4: Flask (interactive tier) failure rate + session length under
a 10 -> 2000 sessions/180 s ramp. Claim: knee at ~1200-1300."""
from __future__ import annotations

from repro_torch.benchmarks.common import emit
from repro_torch.core import SimConfig, Simulation, StaticPolicy, Tier
from repro_torch.core.telemetry import percentile
from repro_torch.core.testbed import paper_tiers
from repro_torch.core.workload import ramp

LOADS = [10, 200, 600, 1000, 1200, 1300, 1400, 1700, 2000]


def main() -> None:
    for load in LOADS:
        sim = Simulation(StaticPolicy(Tier.FLASK), paper_tiers(seed=1), SimConfig())
        m = sim.run(ramp(load, seed=load))
        s = m.summary()
        session_p95 = percentile(m.response_times(), 95) if m.completed else float("nan")
        emit(
            f"fig4.interactive.load{load}",
            s["median_response_s"] * 1e6,
            f"fail_rate={s['failure_rate']:.3f};session_p95_s={session_p95:.2f}",
        )


if __name__ == "__main__":
    main()
