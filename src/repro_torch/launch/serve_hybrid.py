"""End-to-end example (the paper's kind: serving): a burst of requests through
the StraightLine router onto three tiers of paged PyTorch engines — the twin
of ``examples/serve_hybrid.py``, with the same tiers, traffic and asserts.

Tiers:
  interactive (flask)  — 1-slot paged engine, tiny page pool
  batch (docker)       — 8-slot paged engine over a shared KV page pool
  elastic (serverless) — an engine spun up on demand (cold start)

Each engine is owned by an ``EngineLoop``; Algorithm 1's S_F/S_D checks read
each engine's live ``admission_capacity()``; every request carries a trace,
the metrics registry is dumped as Prometheus text, and a MonitorSampler
records each tier's capacity series. ``main`` asserts 0 failures, one trace
per request (with at least one hedged, dual-execution trace), the Prometheus
histograms and a sampler series per tier.

    PYTHONPATH=src python -m repro_torch.launch.serve_hybrid            # FULL, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve_hybrid --smoke --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core import (
    CapacityGauge,
    MetricsRegistry,
    MonitorSampler,
    Request,
    StraightLinePolicy,
    Thresholds,
    Tier,
    Tracer,
)
from repro_torch.core.router import Backend, StraightLineRouter
from repro_torch.models import get_model
from repro_torch.models.common import resolve_device
from repro_torch.serving.engine import PagedEngineConfig, PagedInferenceEngine
from repro_torch.serving.scheduler import EngineLoop

MAXLEN, NEW, PROMPT = 96, 8, 8
PS = 16
N = 24


def prompt_for(rid: int, vocab_size: int):
    return [int(t) for t in np.random.default_rng(rid).integers(1, vocab_size, PROMPT)]


def main(device=None, smoke: bool = False, chunk_tokens: int = 32, out_dir: Optional[str] = None,
         seed: int = 0, params=None, verbose: bool = True, witness=None,
         submitters: int = 1) -> dict:
    """Serve the burst and check its outputs. ``params`` (the port's tree on
    ``device``) defaults to random weights from ``torch.Generator(device)``
    seeded with ``seed``. ``submitters`` threads share the burst (request i
    from thread i % submitters; the same requests and payloads at any
    count). With a ``LockWitness`` (``repro_torch.analysis.witness``), the
    router and its backends' conditions, every loop and its engine, the
    tracer and the sampler are witnessed before they start. Returns the
    router metrics, each request's prompt and output tokens, the weights,
    and the trace and Prometheus paths."""
    dev = resolve_device(device)
    cfg = get_config("smollm-360m", smoke=smoke)
    if smoke:
        cfg = cfg.replace(attn_chunk=64)
    out_dir = out_dir or tempfile.mkdtemp(prefix="serve_hybrid_")
    os.makedirs(out_dir, exist_ok=True)
    trace_out = os.path.join(out_dir, "serve_hybrid_trace.json")
    metrics_out = os.path.join(out_dir, "serve_hybrid_metrics.prom")
    log = print if verbose else (lambda *a, **k: None)

    def pcfg(num_pages, slots):
        return PagedEngineConfig(page_size=PS, num_pages=num_pages, max_slots=slots,
                                 max_seq_len=MAXLEN, max_new_tokens=NEW, chunk_tokens=chunk_tokens)

    t0 = time.time()
    if params is None:
        params = get_model(cfg).init(torch.Generator(dev).manual_seed(seed))
    interactive = PagedInferenceEngine(cfg, pcfg(1 + MAXLEN // PS, 1), params=params, device=dev)
    batch_tier = PagedInferenceEngine(cfg, pcfg(1 + 4 * MAXLEN // PS, 8), params=params, device=dev)
    log(f"tiers ready in {time.time() - t0:.1f}s")

    # pre-warm every prefill bucket on this thread: on the card the first
    # call also builds the kernel library, before any loop thread exists
    for eng in (interactive, batch_tier):
        eng.prewarm()
    log(f"batch tier: {batch_tier.capacity_now()}")

    if witness is not None:
        from repro_torch.analysis import witness as wit

    def started(loop):
        if witness is not None:
            wit.instrument_loop(loop, witness)
        return loop.start()

    registry = MetricsRegistry()
    interactive_loop = started(EngineLoop(interactive, name="flask", registry=registry))
    batch_loop = started(EngineLoop(batch_tier, name="docker", registry=registry))
    gauge = CapacityGauge()
    gauge.register("flask", lambda: interactive.admission_capacity(PROMPT + NEW))
    gauge.register("docker", lambda: batch_tier.admission_capacity(PROMPT + NEW))
    gauge.register_stats("flask", interactive_loop.capacity_now)
    gauge.register_stats("docker", batch_loop.capacity_now)
    tracer = Tracer()
    sampler = MonitorSampler(gauge, interval_s=0.02, registry=registry)
    if witness is not None:
        wit.instrument_tracer(tracer, witness)
        wit.instrument_sampler(sampler, witness)
    sampler.start()

    elastic_pool = []
    elastic_lock = threading.Lock()

    def elastic_run(req: Request):
        # cold start: a fresh engine + step loop; concurrent elastic
        # requests then batch on it too
        with elastic_lock:
            if not elastic_pool:
                t = time.time()
                eng = PagedInferenceEngine(cfg, pcfg(1 + 2 * MAXLEN // PS, 4), params=params,
                                           device=dev)
                elastic_pool.append(started(EngineLoop(eng, name="elastic", registry=registry)))
                gauge.register_stats("elastic", elastic_pool[0].capacity_now)
                log(f"  [elastic cold start: {time.time() - t:.1f}s]")
        loop = elastic_pool[0]
        prompt = prompt_for(req.rid, cfg.vocab_size)
        return loop.wait(loop.submit(prompt, trace=req.trace), req.timeout_s).out

    def loop_backend(tier, loop, capacity, queue_cap):
        name = "flask" if tier == Tier.FLASK else "docker"
        return Backend(
            tier,
            run=lambda req: loop.wait(loop.submit(prompt_for(req.rid, cfg.vocab_size)),
                                      req.timeout_s).out,
            capacity=capacity, queue_cap=queue_cap,
            capacity_fn=lambda: gauge.free(name),
            stats_fn=lambda: gauge.stats(name),
            submit_fn=lambda req: loop.submit(prompt_for(req.rid, cfg.vocab_size), trace=req.trace),
            wait_fn=lambda sid, timeout: loop.wait(sid, timeout).out,
        )

    router = StraightLineRouter(
        {
            Tier.FLASK: loop_backend(Tier.FLASK, interactive_loop, 1, 8),
            Tier.DOCKER: loop_backend(Tier.DOCKER, batch_loop, 8, 64),
            Tier.SERVERLESS: Backend(Tier.SERVERLESS, elastic_run, capacity=16),
        },
        policy=StraightLinePolicy(Thresholds(F=10, D=4096)),   # scaled-down thresholds
        window_s=10.0,
        hedge_after_s=0.25,              # straggler mitigation: slow copies race a
        tracer=tracer,                   # duplicate on the elastic tier
        registry=registry,
    )

    if witness is not None:
        wit.instrument_router(router, witness)
    rng = np.random.default_rng(0)
    sizes = [float(rng.choice([512.0, 16384.0], p=[0.8, 0.2])) for _ in range(N)]   # bimodal payloads

    def submit(first: int) -> None:
        for i in range(first, N, submitters):
            router.submit(Request(rid=i, arrival_t=0.0, data_size=sizes[i], timeout_s=120.0))

    t_serve = time.perf_counter()
    router.start(16)
    threads = [threading.Thread(target=submit, args=(k,)) for k in range(submitters)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    router.drain()
    router.stop()
    serve_s = time.perf_counter() - t_serve

    m = router.metrics
    log(f"\n{N} requests in {serve_s:.3f}s: {m.summary()}")
    by_tier = {t.name: sum(1 for r in m.completed if r.tier == t) for t in Tier}
    log("placement:", by_tier)
    log("batch tier occupancy gauge:", gauge.occupancy("docker"), "steps:", batch_loop.steps,
        "prefill backlog:", gauge.prefill_backlog("docker"))
    for loop in [interactive_loop, batch_loop] + elastic_pool:
        loop.stop()
    sampler.stop()
    assert m.total == N and m.failure_rate == 0.0, m.summary()

    # (a) lifecycle traces: one per request, each with Algorithm 1's inputs;
    # hedged requests race on parallel lanes
    traces = tracer.traces()
    assert len(traces) == N, (len(traces), N)
    for t in traces:
        placement = next(s for s in t["spans"] if s["name"] == "placement")
        assert {"f_t", "flask_free", "docker_free", "tier"} <= set(placement["attrs"])
    hedged = [t for t in traces if any(e["name"] == "hedge_fired" for e in t["events"])]
    dual = [t for t in hedged
            if sum(1 for s in t["spans"] if s["name"] == "execute") >= 2
            and any(s["name"] == "queue_wait" for s in t["spans"])
            and any(ts for ts in t["tokens"].values())]
    log(f"traces: {len(traces)} total, {len(hedged)} hedged, {len(dual)} dual-execution")
    assert hedged, "burst produced no hedged request"
    assert dual, "no hedged trace shows both racing executions"
    tracer.export_chrome(trace_out)
    with open(trace_out) as f:
        chrome = json.load(f)
    assert chrome["traceEvents"], "empty Chrome trace"

    # (b) Prometheus text: latency histograms from the engine loops + router
    prom = registry.prometheus_text()
    with open(metrics_out, "w") as f:
        f.write(prom)
    assert "ttft_seconds_bucket" in prom and "itl_seconds_bucket" in prom, prom[:400]
    assert "router_requests_total" in prom and "router_queue_wait_seconds_bucket" in prom

    # (c) MonitorSampler: a time series for every tier that served traffic
    live_tiers = {"elastic" if name == "SERVERLESS" else name.lower()
                  for name, n in by_tier.items() if n > 0}
    live_tiers |= {"flask", "docker"}
    assert live_tiers <= set(sampler.tiers()), (live_tiers, sampler.tiers())
    for tier in sorted(sampler.tiers()):
        assert sampler.series(tier), tier
    log(f"wrote {trace_out} ({len(chrome['traceEvents'])} events), "
        f"{metrics_out} ({len(prom.splitlines())} lines)")

    with router._lock:                 # the field's lock, though stop() has joined every worker
        results = {rid: list(out) for rid, out in router.results.items()}
    return {
        "metrics": m,
        "serve_s": serve_s,
        "by_tier": by_tier,
        "hedged": len(hedged),
        "results": results,
        "prompts": {rid: prompt_for(rid, cfg.vocab_size) for rid in range(N)},
        "params": params,
        "cfg": cfg,
        "trace_path": trace_out,
        "metrics_path": metrics_out,
        "sampler_tiers": sorted(sampler.tiers()),
    }


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--chunk-tokens", type=int, default=32)
    ap.add_argument("--out-dir", default=None)
    a = ap.parse_args()
    main(device=a.device, smoke=a.smoke, chunk_tokens=a.chunk_tokens, out_dir=a.out_dir)
