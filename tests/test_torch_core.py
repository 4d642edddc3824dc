"""The port's scheduler core and entry points on the CPU: Algorithm 1
(``StraightLinePolicy``) decides as the JAX package's does on a seeded
request stream; ``launch/serve_hybrid.main(device="cpu", smoke=True)``
passes its own asserts; the launcher ``launch/serve.main`` serves its burst
on dense engines with 0 failures in each of its modes; and importing the
port loads neither JAX nor any module of the JAX package."""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import placing as j_placing  # noqa: E402
from repro.core import request as j_request  # noqa: E402
from repro_torch.core import placing as t_placing  # noqa: E402
from repro_torch.core import request as t_request  # noqa: E402
from repro_torch.launch import serve, serve_hybrid  # noqa: E402
from repro_torch.serving.engine import PagedInferenceEngine  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"


def _stream(seed: int, n: int):
    """Seeded requests with Algorithm 1's inputs: payloads on both sides of
    D, rates on both sides of F, scarce availability, and warm-up states
    bare, with a measured compile cost, or absent."""
    rng = np.random.default_rng(seed)
    for rid in range(n):
        warm = None
        if rng.random() < 0.5:
            warm = {}
            for tier in ("FLASK", "DOCKER"):
                w = float(rng.choice([0.0, 0.25, 0.5, 1.0]))
                warm[tier] = ({"warmth": w, "compile_cost_s": float(rng.choice([0.01, 0.2, 1.0]))}
                              if rng.random() < 0.5 else w)
        yield (rid, float(rng.choice([100.0, 4096.0, 5000.0, 2e6])),
               float(rng.choice([0.0, 10.0, 11.0, 2000.0])),
               int(rng.integers(0, 3)), int(rng.integers(0, 3)), warm)


def _warm(warm, tier_enum):
    return None if warm is None else {tier_enum[k]: v for k, v in warm.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_straightline_policy_matches_jax(seed):
    th = dict(F=10.0, D=4096.0)
    jp = j_placing.StraightLinePolicy(j_placing.Thresholds(**th))
    tp = t_placing.StraightLinePolicy(t_placing.Thresholds(**th))
    decisions = []
    for rid, size, f_t, ff, df, warm in _stream(seed, 400):
        jd = jp.place(j_request.Request(rid, 0.0, size), f_t, ff, df,
                      warmup=_warm(warm, j_request.Tier.__members__))
        td = tp.place(t_request.Request(rid, 0.0, size), f_t, ff, df,
                      warmup=_warm(warm, t_request.Tier.__members__))
        assert (td.rid, td.tier.name, td.reason) == (jd.rid, jd.tier.name, jd.reason)
        decisions.append(td.tier.name)
    assert set(decisions) == {"FLASK", "DOCKER", "SERVERLESS"}
    # the batch form consumes availability as it goes
    reqs = [(rid, size) for rid, size, *_ in _stream(seed + 10, 30)]
    jall = jp.place_all([j_request.Request(r, 0.0, s) for r, s in reqs], 5.0, 3, 4)
    tall = tp.place_all([t_request.Request(r, 0.0, s) for r, s in reqs], 5.0, 3, 4)
    assert [(d.tier.name, d.reason) for d in tall] == [(d.tier.name, d.reason) for d in jall]


STEP_FLOOR_S = 0.05


def test_serve_hybrid_main_passes_its_asserts(tmp_path, monkeypatch):
    """24 requests through the router onto three paged tiers on the CPU:
    ``main`` asserts 0 failures, one trace per request with a hedged,
    dual-execution trace among them, Prometheus histograms and a sampler
    series per tier. The smoke model steps on the CPU far faster than the
    full model steps on the card, so no request would outlast the 0.25 s
    hedge deadline: each engine step is given a floor of 50 ms, which makes
    every request on the interactive and batch tiers a straggler and the
    hedge assertion deterministic."""
    step = PagedInferenceEngine.step

    def floored_step(self):
        with self.lock:
            time.sleep(STEP_FLOOR_S)
            return step(self)

    monkeypatch.setattr(PagedInferenceEngine, "step", floored_step)
    r = serve_hybrid.main(device="cpu", smoke=True, out_dir=str(tmp_path), verbose=False)
    m = r["metrics"]
    assert m.total == serve_hybrid.N and m.failure_rate == 0.0
    assert r["hedged"] > 0
    assert sorted(r["results"]) == list(range(serve_hybrid.N))
    assert all(len(out) == serve_hybrid.NEW for out in r["results"].values())
    assert os.path.getsize(r["trace_path"]) > 0
    assert "ttft_seconds_bucket" in Path(r["metrics_path"]).read_text()
    assert {"flask", "docker"} <= set(r["sampler_tiers"])


@pytest.mark.parametrize("extra", [[], ["--serialized"], ["--chunk-tokens", "0"]],
                         ids=["loops", "serialized", "whole_prompt"])
def test_launcher_serves_every_request(extra, tmp_path):
    """The launcher twin on the CPU at smoke size: 8 requests through the
    router's workers onto the dense tiers, each with 8 new tokens, 0
    failures, traces and the metrics registry written."""
    trace, prom = tmp_path / "trace.json", tmp_path / "metrics.prom"
    r = serve.main(["--smoke", "--device", "cpu", "--requests", "8", "--workers", "2",
                    "--prewarm", "--trace-out", str(trace), "--metrics-interval", "0.02",
                    "--metrics-out", str(prom), *extra])
    m = r["metrics"]
    assert m.total == 8 and m.failure_rate == 0.0, m.summary()
    assert sorted(r["results"]) == list(range(8))
    assert all(len(out) == 8 for out in r["results"].values())
    assert sum(r["by_tier"].values()) == 8
    assert trace.stat().st_size > 0 and "router_requests_total" in prom.read_text()


def test_launcher_serves_weights_int8():
    """``--weights-int8`` on the CPU: every tier serves the one quantized
    tree (int8 values, bf16 scales), 8 requests, 0 failures."""
    r = serve.main(["--smoke", "--device", "cpu", "--weights-int8", "--requests", "8"])
    m = r["metrics"]
    assert m.total == 8 and m.failure_rate == 0.0, m.summary()
    assert all(len(out) == 8 for out in r["results"].values())
    assert r["cfg"].weights_int8
    w1 = r["params"]["blocks"]["l0_ffn"]["w1"]
    assert w1["q"].dtype == torch.int8 and w1["s"].dtype == torch.bfloat16


def test_launcher_serves_granite():
    r = serve.main(["--arch", "granite-8b", "--smoke", "--device", "cpu", "--requests", "8"])
    m = r["metrics"]
    assert r["cfg"].name == "granite-8b" and m.total == 8 and m.failure_rate == 0.0, m.summary()
    assert all(len(out) == 8 for out in r["results"].values())


def test_import_loads_no_jax():
    """``import repro_torch`` and every submodule, in a fresh interpreter:
    neither ``jax`` nor any module of the JAX package ``repro`` is loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(names), bad)\n"
        "need = {'repro_torch.launch.serve', 'repro_torch.models.quant',\n"
        "        'repro_torch.serving.prefix_cache', 'repro_torch.core.simulator',\n"
        "        'repro_torch.core.testbed', 'repro_torch.benchmarks.placement',\n"
        "        'repro_torch.configs.granite_8b', 'repro_torch.models.vlm',\n"
        "        'repro_torch.models.whisper', 'repro_torch.configs.qwen2_vl_2b',\n"
        "        'repro_torch.configs.whisper_large_v3', 'repro_torch.models.moe',\n"
        "        'repro_torch.configs.dbrx_132b', 'repro_torch.configs.llama4_maverick',\n"
        "        'repro_torch.configs.jamba_15_large', 'repro_torch.models.xception',\n"
        "        'repro_torch.benchmarks.fig3_training', 'repro_torch.launch.train_small',\n"
        "        'repro_torch.configs.shapes', 'repro_torch.launch.flops', 'repro_torch.launch.cost',\n"
        "        'repro_torch.launch.dryrun', 'repro_torch.benchmarks.roofline'}\n"
        "sys.exit(1 if bad or len(names) < 91 or not need <= set(names) else 0)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
