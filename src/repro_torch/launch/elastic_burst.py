"""Elastic scaling under a traffic burst: autoscaler pre-warming + adaptive
thresholds (the paper's future-work items, implemented) — the twin of
``examples/elastic_burst.py``, through the port's simulator.

    PYTHONPATH=src python -m repro_torch.launch.elastic_burst
"""
from repro_torch.core import SimConfig, Simulation, StraightLinePolicy, Thresholds
from repro_torch.core.autoscaler import Autoscaler
from repro_torch.core.placing import AdaptiveThresholds
from repro_torch.core.testbed import paper_tiers
from repro_torch.core.workload import burst

WL = dict(background_rate=2.0, burst_rate=150.0, burst_at_s=60, burst_len_s=20, seed=11)


def main() -> None:
    print("burst: 2 rps background, 150 rps for 20 s at t=60")
    for name, sim_cfg in [
        ("no autoscaler", SimConfig()),
        ("with autoscaler", SimConfig(autoscaler=Autoscaler())),
        ("autoscaler + hedging", SimConfig(autoscaler=Autoscaler(), hedge_after_s=3.0)),
    ]:
        sim = Simulation(StraightLinePolicy(), paper_tiers(seed=4), sim_cfg)
        s = sim.run(burst(**WL)).summary()
        print(f"  {name:22s} fail={s['failure_rate']:.3f} median={s['median_response_s']:.3f}s p95={s['p95_response_s']:.2f}s")

    # adaptive thresholds re-fit F to the interactive tier's measured capacity
    at = AdaptiveThresholds(Thresholds(), interactive_capacity_rps=1.0 / 0.15)
    th = at.update(interactive_utilization=0.95, docker_service_s=0.8, flask_service_s=0.15)
    print(f"\nadaptive thresholds under saturation: F={th.F:.0f} sessions/window, D={th.D/1e6:.1f} MB")


if __name__ == "__main__":
    main()
