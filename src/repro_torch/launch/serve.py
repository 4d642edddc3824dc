"""Serving launcher: the StraightLine router over live dense-engine tiers (the
twin of ``repro/launch/serve.py``, every flag kept).

    PYTHONPATH=src python -m repro_torch.launch.serve                    # FULL, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
        --requests 8 --workers 2

Tiers: interactive (flask) and batch (docker) ``InferenceEngine``s of 1 and
4 slots, and an elastic (serverless) 2-slot engine started on demand, all
with ``max_len`` 96. The traffic: ``--requests`` requests with 8-token
prompts from ``default_rng(rid)`` and payloads of 512 or 16384 bytes
(p = 0.8 / 0.2), placed by Algorithm 1 under ``Thresholds(F, D)``.

``--workers N`` runs the concurrent router runtime (N worker threads per
tier); 0 keeps the serial poll loop. ``--chunk-tokens N`` turns on chunked
prefill on every tier (0 = whole-prompt prefill). Engine tiers serve through
continuous-batching step loops (``serving.scheduler.EngineLoop``);
``--serialized`` restores the lock-holding ``generate`` path. ``--prewarm``
runs every prefill bucket at start-up. ``--trace-out`` writes the requests'
lifecycle traces as Chrome trace-event JSON, ``--metrics-interval`` samples
every tier's ``capacity_now`` into time series, ``--metrics-out`` dumps the
metrics registry as Prometheus text.

Where the JAX launcher always serves the smoke configuration, this one
serves the FULL model (bf16) unless ``--smoke`` is given; ``--device``
defaults to the card. ``--weights-int8`` (weight-only int8) raises: it is
not ported yet.
"""
from __future__ import annotations

import argparse
import threading
import time
from typing import List, Optional

ROADMAP_WEIGHTS_INT8 = "weight-only int8 (--weights-int8) is not ported yet (ROADMAP Queue 1 item 8)"


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--F", type=float, default=10.0, help="frequency threshold")
    ap.add_argument("--D", type=float, default=4096.0, help="data-size threshold (bytes)")
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--weights-int8", action="store_true")
    ap.add_argument("--hedge-after", type=float, default=None)
    ap.add_argument("--workers", type=int, default=0,
                    help="worker threads per tier (0 = serial poll loop)")
    ap.add_argument("--prewarm", action="store_true",
                    help="run every prefill bucket before accepting traffic")
    ap.add_argument("--serialized", action="store_true",
                    help="bypass the engine step loops (lock-holding generate baseline)")
    ap.add_argument("--chunk-tokens", type=int, default=32,
                    help="chunked prefill chunk size in tokens (0 = whole-prompt prefill)")
    ap.add_argument("--step-budget", type=int, default=0,
                    help="per-step prefill+decode token budget (0 = auto)")
    ap.add_argument("--trace-out", default=None,
                    help="write per-request Chrome trace-event JSON here")
    ap.add_argument("--metrics-interval", type=float, default=0.0,
                    help="MonitorSampler period in seconds (0 = off)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics registry as Prometheus text here")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configuration instead of the FULL model")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None, params=None) -> dict:
    """Serve the burst. ``params`` (the port's tree on the device) defaults
    to random weights from ``torch.Generator(device)`` seeded with 0, as
    the JAX launcher seeds its own. Returns the router metrics with the
    placement per tier, the wall time, each request's prompt and output
    tokens, the weights and the config."""
    args = parse_args(argv)
    if args.weights_int8:
        raise NotImplementedError(ROADMAP_WEIGHTS_INT8)

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core import (
        CapacityGauge,
        MonitorSampler,
        Request,
        StraightLinePolicy,
        Thresholds,
        Tier,
        Tracer,
        default_registry,
    )
    from repro_torch.core.router import Backend, StraightLineRouter
    from repro_torch.models import get_model
    from repro_torch.models.common import resolve_device
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    from repro_torch.serving.scheduler import EngineLoop

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke).replace(attn_chunk=64)

    def ecfg(slots):
        return EngineConfig(
            max_slots=slots, max_len=96, max_new_tokens=args.max_new_tokens,
            chunk_tokens=args.chunk_tokens, step_token_budget=args.step_budget,
        )

    t0 = time.time()
    if params is None:
        params = get_model(cfg).init(torch.Generator(dev).manual_seed(0))
    interactive = InferenceEngine(cfg, ecfg(1), params=params, device=dev)
    batch_tier = InferenceEngine(cfg, ecfg(4), params=params, device=dev)
    print(f"tiers ready in {time.time()-t0:.1f}s ({cfg.name}, {'smoke' if args.smoke else 'FULL'}, "
          f"{str(cfg.compute_dtype).replace('torch.', '')}, {dev})")
    if dev.type == "cuda":
        from repro_torch.kernels import _build

        _build.library()          # build on this thread, before any worker starts

    if args.prewarm:
        t = time.time()
        for name, eng in (("interactive", interactive), ("batch", batch_tier)):
            warmed = eng.prewarm()
            snap = eng.capacity_now()
            print(f"  prewarmed {name}: buckets {warmed} "
                  f"({snap['compile_events']}/{snap['total_buckets']} shapes warm)")
        print(f"  prewarm took {time.time()-t:.1f}s")

    tracer = Tracer() if args.trace_out else None
    gauge = CapacityGauge()
    sampler = None
    if args.metrics_interval > 0:
        sampler = MonitorSampler(gauge, interval_s=args.metrics_interval, registry=default_registry())

    elastic: list = []
    elastic_lock = threading.Lock()

    def prompt_for(rid):
        return [int(t) for t in np.random.default_rng(rid).integers(1, cfg.vocab_size, 8)]

    def run_on(engine):
        def run(req):
            return engine.generate([prompt_for(req.rid)])[0].out
        return run

    def elastic_run(req):
        with elastic_lock:             # one cold start even under concurrency
            if not elastic:
                t = time.time()
                eng = InferenceEngine(cfg, ecfg(2), params=params, device=dev)
                elastic.append(eng if args.serialized else EngineLoop(eng, name="elastic").start())
                gauge.register_stats(
                    "elastic", eng.capacity_now if args.serialized else elastic[0].capacity_now)
                print(f"  [elastic cold start {time.time()-t:.1f}s]")
        if args.serialized:
            return run_on(elastic[0])(req)
        loop = elastic[0]
        return loop.wait(loop.submit(prompt_for(req.rid), trace=req.trace), req.timeout_s).out

    loops: list = []

    def engine_backend(tier, engine, capacity, queue_cap):
        """Continuous-batching backend: workers submit into the engine's
        shared step loop and block on futures; --serialized keeps the
        lock-holding generate path."""
        name = tier.name.lower()
        if args.serialized:
            gauge.register_stats(name, engine.capacity_now)
            return Backend(tier, run_on(engine), capacity=capacity, queue_cap=queue_cap,
                           stats_fn=engine.capacity_now)
        loop = EngineLoop(engine, name=name).start()
        loops.append(loop)
        gauge.register_stats(name, loop.capacity_now)
        return Backend(
            tier, run_on(engine), capacity=capacity, queue_cap=queue_cap,
            stats_fn=loop.capacity_now,
            submit_fn=lambda req: loop.submit(prompt_for(req.rid), trace=req.trace),
            wait_fn=lambda sid, timeout: loop.wait(sid, timeout).out,
        )

    router = StraightLineRouter(
        {
            Tier.FLASK: engine_backend(Tier.FLASK, interactive, 1, 8),
            Tier.DOCKER: engine_backend(Tier.DOCKER, batch_tier, 4, 64),
            Tier.SERVERLESS: Backend(Tier.SERVERLESS, elastic_run, capacity=16),
        },
        policy=StraightLinePolicy(Thresholds(F=args.F, D=args.D)),
        window_s=10.0,
        hedge_after_s=args.hedge_after,
        tracer=tracer,
    )
    if sampler is not None:
        sampler.start()
    if args.workers > 0:
        router.start(args.workers)
    rng = np.random.default_rng(0)
    t0 = time.time()
    try:
        for i in range(args.requests):
            size = float(rng.choice([512.0, 16384.0], p=[0.8, 0.2]))
            router.submit(Request(rid=i, arrival_t=0.0, data_size=size, timeout_s=300.0))
        router.drain()
        wall = time.time() - t0
    finally:
        if args.workers > 0:
            router.stop()
        for lp in loops + [e for e in elastic if isinstance(e, EngineLoop)]:
            lp.stop()
        if sampler is not None:
            sampler.stop()
    if sampler is not None:
        covered = {t: len(sampler.series(t)) for t in sampler.tiers()}
        print(f"monitor: {sampler.samples_taken} samples across tiers {covered}")
    if tracer is not None:
        tracer.export_chrome(args.trace_out)
        print(f"wrote {len(tracer)} traces to {args.trace_out} (open in Perfetto / chrome://tracing)")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(default_registry().prometheus_text())
        print(f"wrote metrics registry to {args.metrics_out}")
    m = router.metrics
    by_tier = {t.name: sum(1 for r in m.completed if r.tier == t) for t in Tier}
    mode = f"{args.workers} workers/tier" if args.workers > 0 else "serial poll loop"
    batching = "serialized generate" if args.serialized else "continuous-batching loops"
    prefill = f"chunked prefill ({args.chunk_tokens} tok)" if args.chunk_tokens else "whole-prompt prefill"
    print(f"{args.requests} requests in {wall:.1f}s ({mode}, {batching}, {prefill}): {m.summary()}")
    print(f"placement: {by_tier}")
    return {
        "metrics": m,
        "by_tier": by_tier,
        "wall_s": wall,
        "results": {rid: list(out) for rid, out in router.results.items()},
        "prompts": {rid: prompt_for(rid) for rid in range(args.requests)},
        "params": params,
        "cfg": cfg,
    }


if __name__ == "__main__":
    main()
