"""The port's simulator tier (``core/workload``, ``estimator``, ``tiers``,
``testbed``, ``autoscaler``, ``simulator``) and its paper-figure twins
against the JAX package on the CPU: the load generators bit for bit, tier
service and cold-start times to 1e-12 relative, every simulated request's
tier, failure and response time under the five figure modules' policies and
loads and under hedging, retry and the autoscaler, with their summaries
and traces; each figure twin's rows string for string (timing rows aside).
The port's estimator carries one H100 card's rates; the testbed's tiers
keep the paper machines' rates, so every simulated number survives that."""
import contextlib
import importlib
import io
import json
import math
import runpy
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.core import simulator as j_simulator  # noqa: E402
from repro.core import estimator as j_est  # noqa: E402
from repro.core import placing as j_placing  # noqa: E402
from repro.core import request as j_request  # noqa: E402
from repro.core import testbed as j_testbed  # noqa: E402
from repro.core import tracing as j_tracing  # noqa: E402
from repro.core import workload as j_wl  # noqa: E402
from repro.core.autoscaler import Autoscaler as JAutoscaler  # noqa: E402
from repro_torch.core import simulator as t_simulator  # noqa: E402
from repro_torch.core import estimator as t_est  # noqa: E402
from repro_torch.core import placing as t_placing  # noqa: E402
from repro_torch.core import request as t_request  # noqa: E402
from repro_torch.core import testbed as t_testbed  # noqa: E402
from repro_torch.core import tracing as t_tracing  # noqa: E402
from repro_torch.core import workload as t_wl  # noqa: E402
from repro_torch.core.autoscaler import Autoscaler as TAutoscaler  # noqa: E402
from repro_torch.core.telemetry import CapacityGauge  # noqa: E402
from repro_torch.launch import quickstart  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RESPONSE_TOL_S = 1e-9
SERVICE_RTOL = 1e-12
FIGURES = ["fig4_interactive", "fig5_elastic", "fig6_7_platforms", "fig8_response", "placement"]
TIMING_ROWS = "placement.decide."


def _fields(reqs):
    return [(r.rid, r.arrival_t, r.data_size, r.work_units, r.model, r.timeout_s) for r in reqs]


GENERATORS = {
    "ramp": lambda wl, dist, seed: wl.ramp(700, dist=dist, seed=seed),
    "poisson": lambda wl, dist, seed: wl.poisson(12.0, duration_s=60.0, dist=dist, seed=seed),
    "burst": lambda wl, dist, seed: wl.burst(2.0, 60.0, burst_at_s=20, burst_len_s=5,
                                             duration_s=60.0, dist=dist, seed=seed),
}


@pytest.mark.parametrize("seed", [0, 1, 17])
@pytest.mark.parametrize("dist", ["image", "image-hires", "bimodal", "tokens"])
@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_workload_generators_match_jax_bit_for_bit(gen, dist, seed):
    j = GENERATORS[gen](j_wl, dist, seed)
    t = GENERATORS[gen](t_wl, dist, seed)
    assert len(t) > 0 and _fields(t) == _fields(j)


def test_estimator_carries_the_h100_constants():
    assert (t_est.PEAK_FLOPS, t_est.HBM_BW, t_est.LINK_BW) == (989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("mem", ["2GB", "3GB"])
def test_tier_service_and_cold_start_match_jax(mem):
    """Each testbed tier's service time (work units 1-40, payloads from 20 KB
    to 40 MB) and cold start, to 1e-12 relative: the tiers keep the paper
    machines' effective FLOP/s, and Xception stays compute-bound at the
    card's ridge as at the old one."""
    jt = j_testbed.paper_tiers(seed=3, elastic_mem=mem)
    tt = t_testbed.paper_tiers(seed=3, elastic_mem=mem)
    assert [t.name for t in tt] == [t.name for t in jt]
    for tier in jt:
        js, ts = jt[tier], tt[t_request.Tier[tier.name]]
        jsl, tsl = js.cfg.slice_, ts.cfg.slice_
        assert math.isclose(tsl.speed_factor * t_est.PEAK_FLOPS, jsl.speed_factor * j_est.PEAK_FLOPS,
                            rel_tol=SERVICE_RTOL)
        for wu in (1.0, 2.5, 40.0):
            assert math.isclose(t_est.LatencyEstimator.service_time(ts.app, wu, tsl),
                                j_est.LatencyEstimator.service_time(js.app, wu, jsl),
                                rel_tol=SERVICE_RTOL)
        assert math.isclose(t_est.LatencyEstimator.cold_start(ts.app, tsl),
                            j_est.LatencyEstimator.cold_start(js.app, jsl), rel_tol=SERVICE_RTOL)
        for rid, size in enumerate((20e3, 180e3, 6e6, 40e6)):
            wu = max(1.0, size / 180e3)
            jr = j_request.Request(rid, 0.0, size, work_units=wu)
            tr = t_request.Request(rid, 0.0, size, work_units=wu)
            for now in (0.0, 30.0):            # the elastic tier's cold then warm pool
                assert math.isclose(ts.service_time(tr, now), js.service_time(jr, now),
                                    rel_tol=SERVICE_RTOL)
            js.warm_instances.append(0.0)
            ts.warm_instances.append(0.0)


def test_lm_profile_is_memory_bound_on_the_card_rates():
    """``lm_profile`` is memory-bound (50 FLOP/B), so its service time moves
    with the card's HBM rate: a difference from the JAX package on purpose."""
    n = 360e6
    app = t_est.lm_profile("smollm-360m", n, 2 * n)
    s = t_est.SliceProfile(chips=1)
    t = t_est.LatencyEstimator.service_time(app, 128.0, s)
    assert t == app.base_overhead_s + app.bytes_per_unit * 128.0 / t_est.HBM_BW
    assert t != j_est.LatencyEstimator.service_time(j_est.lm_profile("smollm-360m", n, 2 * n), 128.0,
                                                    j_est.SliceProfile(chips=1))


def test_estimator_monotonicity():
    app = t_est.xception_profile()
    s1, s8 = t_est.SliceProfile(chips=1), t_est.SliceProfile(chips=8)
    t1 = t_est.LatencyEstimator.service_time(app, 4.0, s1)
    assert t_est.LatencyEstimator.service_time(app, 4.0, s8) < t1
    assert t_est.LatencyEstimator.service_time(app, 8.0, s1) > t1
    assert t_est.LatencyEstimator.cold_start(app, s1) > 0.5   # ~110 MB at 150 MB/s


def test_estimator_reads_dryrun_records(tmp_path):
    """The dry-run reader keeps ``status: ok`` records of ``single__*.json``
    and skips others and unreadable files; ``step_time`` is the largest
    roofline term, compute and memory scaled to the slice's share."""
    rec = {"arch": "glm4-9b", "shape": "decode_32k", "status": "ok",
           "roofline": {"compute_s": 0.002, "memory_s": 0.004, "collective_s": 0.001}}
    (tmp_path / "single__glm4-9b__decode_32k.json").write_text(json.dumps(rec))
    (tmp_path / "single__glm4-9b__train_4k.json").write_text(
        json.dumps({**rec, "shape": "train_4k", "status": "oom"}))
    (tmp_path / "single__broken.json").write_text("{not json")
    (tmp_path / "multi__glm4-9b__decode_32k.json").write_text(json.dumps({**rec, "shape": "x"}))
    est = t_est.LatencyEstimator(str(tmp_path))
    assert list(est.records) == [("glm4-9b", "decode_32k")]
    assert est.step_time("glm4-9b", "decode_32k") == 0.004
    assert est.step_time("glm4-9b", "decode_32k", chips_frac=0.5) == 0.008
    assert est.step_time("glm4-9b", "train_4k") is None
    assert t_est.LatencyEstimator(None).records == {}
    assert t_est.LatencyEstimator(str(tmp_path / "absent")).records == {}


def test_tiersim_free_slots_follows_capacity_probe():
    gauge = CapacityGauge()
    live = {"n": 5}
    gauge.register("flask", lambda: live["n"])
    tier = t_testbed.paper_tiers(seed=0)[t_request.Tier.FLASK]
    static = tier.free_slots()
    tier.capacity_probe = lambda: gauge.free("flask")
    assert tier.free_slots() == 5                 # live probe wins
    live["n"] = 0
    assert tier.free_slots() == 0
    gauge.unregister("flask")
    assert tier.free_slots() == static            # probe gone dark -> queue model


# ---------------------------------------------------------------------------
# The simulator, request by request
# ---------------------------------------------------------------------------


def _close(a, b, path="") -> None:
    """Equal structures, floats within RESPONSE_TOL_S."""
    if isinstance(a, float) and isinstance(b, float):
        assert (math.isnan(a) and math.isnan(b)) or abs(a - b) <= RESPONSE_TOL_S, (path, a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def _outcomes(reqs) -> list:
    return [(r.rid, None if r.tier is None else r.tier.name, r.failed, r.fail_reason, r.hedged,
             r.response_s) for r in reqs]


def assert_same_runs(j_runs, t_runs) -> None:
    """Per request: tier, failure, reason and hedge flag equal, response
    time within 1e-9 s; the summaries equal."""
    assert len(t_runs) == len(j_runs) > 0
    for (jr, jm), (tr, tm) in zip(j_runs, t_runs):
        assert len(tr) == len(jr) > 0
        _close(_outcomes(jr), _outcomes(tr))
        assert tm.summary() == jm.summary()


@pytest.fixture
def captured(monkeypatch):
    """Every ``Simulation.run`` of both packages while the test runs: its
    request list and its metrics, in call order."""
    runs = {"jax": [], "torch": []}
    for key, cls in (("jax", j_simulator.Simulation), ("torch", t_simulator.Simulation)):
        def run(self, requests, _orig=cls.run, _key=key):
            m = _orig(self, requests)
            runs[_key].append((list(requests), m))
            return m
        monkeypatch.setattr(cls, "run", run)
    return runs


def _rows(main, *args) -> list:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(*args)
    return out.getvalue().splitlines()


@pytest.mark.parametrize("fig", FIGURES)
def test_figure_twin_matches_jax(fig, captured, monkeypatch):
    """The figure twin prints the JAX module's ``name,us,derived`` rows string
    for string (the decision-timing rows by name only), and every simulation
    behind them agrees request by request."""
    monkeypatch.syspath_prepend(str(ROOT))
    j_main = importlib.import_module(f"benchmarks.{fig}").main
    t_main = importlib.import_module(f"repro_torch.benchmarks.{fig}").main
    j_rows = _rows(j_main)
    t_rows = _rows(t_main, *([["--device", "cpu"]] if fig == "placement" else []))
    keep = lambda rows: [r for r in rows if not r.startswith(TIMING_ROWS)]  # noqa: E731
    assert keep(t_rows) == keep(j_rows) and len(keep(t_rows)) >= 3
    timing = [r.split(",")[0] for r in t_rows if r.startswith(TIMING_ROWS)]
    if fig == "placement":
        assert timing == ["placement.decide.python", "placement.decide.torch_batch1024"]
    assert_same_runs(captured["jax"], captured["torch"])


def _sim(pkg, policy, load=None, seed=1, mem="3GB", wl=None, tracer=None, **cfg):
    """One run through ``pkg``'s simulator at ``tests/test_system.py``'s
    loads: a ramp of ``load`` sessions or the burst ``wl``."""
    core, testbed, workload, autoscaler = pkg
    sim_cfg = dict(cfg)
    if sim_cfg.pop("autoscale", False):
        sim_cfg["autoscaler"] = autoscaler()
    sim = core.Simulation(policy, testbed.paper_tiers(seed=seed, elastic_mem=mem),
                          core.SimConfig(**sim_cfg), tracer=tracer)
    reqs = workload.ramp(load, seed=load) if wl is None else workload.burst(**wl)
    return sim, sim.run(reqs)


J = (j_simulator, j_testbed, j_wl, JAutoscaler)
T = (t_simulator, t_testbed, t_wl, TAutoscaler)
BURST7 = dict(background_rate=2.0, burst_rate=120.0, burst_at_s=60, burst_len_s=20, seed=7)
BURST9 = dict(background_rate=1.0, burst_rate=80.0, burst_at_s=90, burst_len_s=15, seed=9)
BURST11 = dict(background_rate=2.0, burst_rate=150.0, burst_at_s=60, burst_len_s=20, seed=11)
CONFIGS = {
    "hedge": dict(policy=("StraightLinePolicy",), load=3000, hedge_after_s=2.0),
    "retry": dict(policy=("StaticPolicy", "FLASK"), load=2500, retry_failed_on_elastic=True),
    "autoscaler": dict(policy=("StaticPolicy", "SERVERLESS"), wl=BURST9, seed=2, autoscale=True),
    "burst": dict(policy=("StraightLinePolicy",), wl=BURST7, seed=0),
    "all_three": dict(policy=("StraightLinePolicy",), wl=BURST11, seed=4, autoscale=True,
                      hedge_after_s=3.0, retry_failed_on_elastic=True),
}


def _policy(placing, request, spec):
    if spec[0] == "StaticPolicy":
        return placing.StaticPolicy(request.Tier[spec[1]])
    return getattr(placing, spec[0])()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_simulation_options_match_jax(name, captured):
    """Hedging, retry-on-elastic and the autoscaler, alone and together,
    each with a tracer: per request, the summary, each tier's final state
    (warm pool included), the autoscaler's target and every trace's spans
    and events (simulated time) agree with the JAX simulator."""
    spec = dict(CONFIGS[name])
    pol = spec.pop("policy")
    j_tr, t_tr = j_tracing.Tracer(capacity=1 << 16), t_tracing.Tracer(capacity=1 << 16)
    jsim, _ = _sim(J, _policy(j_placing, j_request, pol), tracer=j_tr, **spec)
    tsim, _ = _sim(T, _policy(t_placing, t_request, pol), tracer=t_tr, **spec)
    assert_same_runs(captured["jax"], captured["torch"])
    assert tsim.tier_stats() == jsim.tier_stats()
    for tier, js in jsim.tiers.items():          # pools, queues and the autoscaler's prewarming
        ts = tsim.tiers[t_request.Tier[tier.name]]
        _close((js.busy, js.inflight, js.served, js.busy_time, js.warm_instances, len(js.queue)),
               (ts.busy, ts.inflight, ts.served, ts.busy_time, ts.warm_instances, len(ts.queue)))
    if spec.get("autoscale"):
        assert tsim.cfg.autoscaler._last_target == jsim.cfg.autoscaler._last_target > 0
    jt, tt = j_tr.traces(), t_tr.traces()
    assert len(tt) == len(captured["torch"][0][0])
    _close(jt, tt)
    if spec.get("hedge_after_s") is not None:
        assert any(t["attrs"]["hedged"] for t in tt)


def test_elastic_burst_twin_prints_the_examples_lines(capsys):
    runpy.run_path(str(ROOT / "examples" / "elastic_burst.py"), run_name="__main__")
    j_out = capsys.readouterr().out
    importlib.import_module("repro_torch.launch.elastic_burst").main()
    t_out = capsys.readouterr().out
    assert t_out == j_out and "autoscaler + hedging" in t_out


def test_quickstart_twin_on_the_cpu(capsys):
    """The quickstart on the CPU: section 1's training loss equal to the
    JAX model's ``loss`` on the same batch and weights (the port's, carried
    across) at f32 2e-5; two greedy tokens per step in the vocabulary,
    Algorithm 1's burst decision, and the ramp's summary equal to the JAX
    simulator's."""
    import jax
    import numpy as np

    from repro.configs.registry import get_config as j_get_config
    from repro.models import get_model as j_get_model
    from repro_torch.models.bridge import params_to_numpy

    r = quickstart.main(["--device", "cpu"])
    j_model = j_get_model(j_get_config("glm4-9b", smoke=True))
    j_params = jax.tree.map(jax.numpy.asarray, params_to_numpy(r["params"]))
    j_loss, _ = j_model.loss(None, j_params, {k: jax.numpy.asarray(v) for k, v in r["batch"].items()})
    assert np.isfinite(r["loss"]) and abs(r["loss"] - float(j_loss)) <= 2e-5 * max(1.0, abs(float(j_loss)))
    vocab = quickstart.get_config("glm4-9b", smoke=True).vocab_size
    for toks in (r["tokens"], r["next_tokens"]):
        assert len(toks) == 2 and all(0 <= t < vocab for t in toks)
    assert r["decision"].tier == t_request.Tier.SERVERLESS
    j_pol = j_placing.StraightLinePolicy(j_placing.Thresholds(F=1200, D=1e6))
    j_sum = j_simulator.Simulation(j_pol, j_testbed.paper_tiers(seed=0),
                                   j_simulator.SimConfig()).run(j_wl.ramp(2000, seed=0)).summary()
    assert r["summary"] == j_sum
    out = capsys.readouterr().out
    assert "2000-session ramp through StraightLine" in out
    assert f"glm4-9b (smoke) train loss: {r['loss']:.3f}" in out
