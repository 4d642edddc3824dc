#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py              # from the root of a checkout

Phases, one line (or a few) each; any failure exits non-zero before the
result line:
  1. device  — torch's device name; the card's name and power limit
  2. build   — nvcc builds every kernel of kernels/csrc/ for sm_90a
  3. kernels — each kernel against its plain PyTorch version on the card at
               the serving path's shapes (edge cases included), then timed
               with CUDA events beside the plain version, the one PyTorch
               call that computes the same function (where there is one) and
               the card's bound for the work; device-only times from
               torch.profiler beside the CUDA-event times
  4. serve   — launch/serve_hybrid.main() at FULL smollm-360m width in bf16
               (random weights from a seeded generator): 24 requests through
               the StraightLine router, chunked prefill; then again with
               whole-prompt prefill. Launch counts are read per run. Then
               launches per prefill and per decode step, a batch-8 decode
               step's time and the device's busy share over a few steps.
  5. parity  — served requests re-run teacher-forced through the port's
               plain path on the CPU in f32 on the same weights
  6. summary — the kernels JSON line, then the result line.
Writes its longer outputs (build log, traces, metrics) under chip_smoke_out/.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chip_smoke_out"
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_S = 3.35e12       # H100 SXM device memory rate
F32_FLOPS_S = 67e12         # H100 SXM f32 outside the tensor cores
BF16_FLOPS_S = 989e12       # H100 SXM dense bf16 tensor cores
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py:17
FLIP_BOUND = 0.25           # max CPU-f32 logit lead over a GPU token that differs


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, reps: int = 25) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls,
    by CUDA events, after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_ms(fn, n: int = 50):
    """Device time of one call: the time torch.profiler records on the card
    over ``n`` calls, divided by ``n`` (None if it records none).
    Unlike ``time_ms`` it leaves out the gaps in which the host is still
    issuing the next launch."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in device_events(prof))
    return us / n / 1e3 if us > 0 else None


def device_events(prof):
    """The profiler's averaged events that ran on the card (kernels, copies,
    sets). The CPU ops that launched them report the same device time again,
    so only these are summed."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]


def bound(nbytes: float, ops: float, peak_ops: float):
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / peak_ops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_tol(name: str, e: float, dtype) -> None:
    tol = TOL[str(dtype).replace("torch.", "")]
    log(f"  {name}: max_abs_err {e:.3e} (tol {tol:g})")
    if not e <= tol:
        raise AssertionError(f"{name}: error {e} above {tol}")


def phase_kernels(torch, dev):
    from torch.nn import functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref, paged_prefill_write_ref
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    g = torch.Generator(dev).manual_seed(1234)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=g, device=dev, dtype=f32).to(dtype)

    # -- rmsnorm: every norm of the path (D = 960), plus a ragged D ----------
    errs = []
    for (R, D, dt) in [(8, 960, bf16), (32, 960, bf16), (1, 960, bf16), (5, 997, bf16),
                       (3, 997, f32), (8, 960, f32)]:
        x = randn(R, D, dtype=dt)
        w = torch.linspace(0.5, 1.5, D, device=dev).to(dt)
        e = err(rms_ops.rmsnorm(x, w), rmsnorm_ref(x, w))
        torch.cuda.synchronize()
        check_tol(f"rmsnorm R={R} D={D} {dt}", e, dt)
        errs.append(e)
    R, D = 8, 960
    x = randn(R, D)
    w = torch.linspace(0.5, 1.5, D, device=dev).to(bf16)
    b_ms, b_by = bound(2 * (2 * R * D + D), 4 * R * D, F32_FLOPS_S)
    rows.append({
        "name": "rmsnorm", "route": "cuda", "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm/kernel.py:25",
        "shape": f"x ({R}, {D}) bf16", "max_abs_err": max(errs),
        "fns": (lambda x=x, w=w: rms_ops.rmsnorm(x, w), lambda x=x, w=w: rmsnorm_ref(x, w)),
        "library_ms": time_ms(lambda: F.rms_norm(x, (D,), w, 1e-6)),
        "bound_ms": b_ms, "bound_by": b_by,
    })

    # -- paged prefill write: exact, untouched pages preserved ---------------
    NP, KV, ps, hd, P = 25, 5, 16, 64, 6
    for (Lp, off, dt) in [(32, 0, bf16), (32, 32, bf16), (16, 64, bf16), (96, 0, f32),
                          (20, 0, bf16), (64, 32, f32)]:
        pool_k, pool_v = randn(NP, KV, ps, hd, dtype=dt), randn(NP, KV, ps, hd, dtype=dt)
        k, v = randn(1, Lp, KV, hd, dtype=dt), randn(1, Lp, KV, hd, dtype=dt)
        row = torch.tensor([9, 3, 17, 4, 22, 0], dtype=torch.int32, device=dev)
        ck, cv = pool_k.clone(), pool_v.clone()
        rk, rv = pool_k.clone(), pool_v.clone()
        pa_ops.paged_prefill_write(ck, cv, k, v, row, offset=off)
        paged_prefill_write_ref(rk, rv, k, v, pa_ops._shift_row(row, off, ps))
        torch.cuda.synchronize()
        touched = {int(p) for p in pa_ops._shift_row(row, off, ps)[: -(-Lp // ps)]}
        for p in range(1, NP):               # page 0 absorbs pad writes: never compared
            if not (torch.equal(ck[p], rk[p]) and torch.equal(cv[p], rv[p])):
                raise AssertionError(f"paged_prefill_write Lp={Lp} off={off}: page {p} differs")
            if p not in touched and not (torch.equal(ck[p], pool_k[p]) and torch.equal(cv[p], pool_v[p])):
                raise AssertionError(f"paged_prefill_write touched page {p} outside the row")
        log(f"  paged_prefill_write Lp={Lp} offset={off} {dt}: exact, untouched pages preserved")
    Lp = 16                                 # an 8-token prompt's chunk, bucketed to a page
    pool_k, pool_v = randn(NP, KV, ps, hd), randn(NP, KV, ps, hd)
    k, v = randn(1, Lp, KV, hd), randn(1, Lp, KV, hd)
    row = torch.tensor([9, 3, 17, 4, 22, 0], dtype=torch.int32, device=dev)
    t = torch.arange(Lp, device=dev)
    at = (row.long()[t // ps][:, None], torch.arange(KV, device=dev)[None, :], (t % ps)[:, None])

    def index_put():
        pool_k.index_put_(at, k[0])
        pool_v.index_put_(at, v[0])

    b_ms, b_by = bound(2 * 2 * 2 * Lp * KV * hd + 4 * P, 0, F32_FLOPS_S)
    rows.append({
        "name": "paged_prefill_write", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:233",
        "shape": f"k/v (1, {Lp}, {KV}, {hd}) bf16 into ({NP}, {KV}, {ps}, {hd})",
        "max_abs_err": 0.0,
        "fns": (lambda a=(pool_k, pool_v, k, v, row): pa_ops.paged_prefill_write(*a),
                lambda a=(pool_k, pool_v, k, v, row): paged_prefill_write_ref(*a)),
        "library_ms": time_ms(index_put), "library_call": "index_put_ (k and v)",
        "bound_ms": b_ms, "bound_by": b_by,
    })

    # -- paged decode: dead slots, page-boundary lengths, a full row, softcap -
    B, G = 8, 3
    gen_tab = torch.Generator().manual_seed(7)
    tab = torch.stack([torch.randperm(NP - 1, generator=gen_tab)[:P] + 1 for _ in range(B)])
    lens = torch.tensor([1, 16, 17, 32, 96, 5, 48, 1], dtype=torch.int32)
    tab[0] = 0                                   # dead slots: null row, length 0 + 1
    tab[7] = 0
    tab, lens = tab.to(torch.int32).to(dev), lens.to(dev)
    errs = []
    for (dt, cap) in [(bf16, 0.0), (f32, 0.0), (bf16, 30.0)]:
        q = randn(B, 1, G * KV, hd, dtype=dt)
        pk, pv = randn(NP, KV, ps, hd, dtype=dt), randn(NP, KV, ps, hd, dtype=dt)
        out = pa_ops.paged_attention(q, pk, pv, tab, lens, softcap=cap)
        ref = paged_attention_ref(q[:, 0].reshape(B, KV, G, hd), pk, pv, tab, lens, softcap=cap)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("paged_attention: non-finite output")
        e = err(out.reshape(B, KV, G, hd), ref)
        check_tol(f"paged_attention B={B} lens={lens.tolist()} softcap={cap} {dt}", e, dt)
        errs.append(e)
    lens_t = torch.arange(9, 17, dtype=torch.int32, device=dev)     # 8 live, one page each
    q = randn(B, 1, G * KV, hd)
    pk, pv = randn(NP, KV, ps, hd), randn(NP, KV, ps, hd)
    qg = q[:, 0].reshape(B, KV, G, hd)
    pages = sum(-(-int(n) // ps) for n in lens_t)
    nbytes = 2 * pages * 2 * KV * ps * hd + 2 * 2 * B * KV * G * hd + 4 * B * (P + 1)
    b_ms, b_by = bound(nbytes, 4 * KV * G * hd * int(lens_t.sum()), F32_FLOPS_S)
    rows.append({
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:167",
        "shape": f"q ({B}, {KV}, {G}, {hd}) bf16, lengths {lens_t.tolist()}",
        "max_abs_err": max(errs),
        "fns": (lambda a=(q, pk, pv, tab, lens_t): pa_ops.paged_attention(*a),
                lambda a=(qg, pk, pv, tab, lens_t): paged_attention_ref(*a)),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
    })

    # -- flash attention: the prompt buckets, a ragged S, f32 ---------------
    H = G * KV
    errs = []
    for (S, dt) in [(16, bf16), (32, bf16), (40, bf16), (96, bf16), (40, f32), (96, f32)]:
        q, k, v = randn(1, H, S, hd, dtype=dt), randn(1, KV, S, hd, dtype=dt), randn(1, KV, S, hd, dtype=dt)
        e = err(fa_ops.flash_attention_bhsd(q, k, v), attention_ref(q, k, v))
        torch.cuda.synchronize()
        check_tol(f"flash_attention S={S} {dt}", e, dt)
        errs.append(e)
    S = 16
    q, k, v = randn(1, H, S, hd), randn(1, KV, S, hd), randn(1, KV, S, hd)
    b_ms, b_by = bound(2 * (2 * H + 2 * KV) * S * hd, 4 * H * hd * S * (S + 1) // 2, BF16_FLOPS_S)
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:83",
        "shape": f"q (1, {H}, {S}, {hd}) bf16, k/v (1, {KV}, {S}, {hd})",
        "max_abs_err": max(errs),
        "fns": (lambda a=(q, k, v): fa_ops.flash_attention_bhsd(*a),
                lambda a=(q, k, v): attention_ref(*a)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)),
        "bound_ms": b_ms, "bound_by": b_by,
    })
    for r in rows:
        kernel, plain = r.pop("fns")
        r["ms"], r["plain_ms"] = time_ms(kernel), time_ms(plain)
        r["device_ms"], r["plain_device_ms"] = device_ms(kernel), device_ms(plain)
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.5f}"
        log(f"  time {r['name']} [{r['shape']}]: kernel {r['ms']:.5f} ms (device {r['device_ms']}), "
            f"plain {r['plain_ms']:.5f} ms (device {r['plain_device_ms']}), library {lib} ms, "
            f"bound {r['bound_ms']:.6f} ms ({r['bound_by']})")
    return rows


def counters():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops

    return {"rmsnorm": rms_ops.rmsnorm, "paged_prefill_write": pa_ops.paged_prefill_write,
            "paged_attention": pa_ops.paged_attention, "flash_attention": fa_ops.flash_attention_bhsd}


def serve_leg(torch, chunk_tokens: int, params):
    from repro_torch.launch import serve_hybrid

    wrappers = counters()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    r = serve_hybrid.main(device="cuda", smoke=False, chunk_tokens=chunk_tokens,
                          out_dir=str(OUT / f"serve_chunk{chunk_tokens}"), seed=0, params=params,
                          verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {n: w.launches for n, w in wrappers.items()}
    m = r["metrics"].summary()
    log(f"  chunk_tokens={chunk_tokens}: {m['total']} requests, {m['failed']} failed, "
        f"serve {r['serve_s']:.3f} s (wall {wall:.3f} s incl. tier set-up), placement {r['by_tier']}, "
        f"{r['hedged']} hedged, median response {m['median_response_s']} s, "
        f"p99 {m['p99_response_s']} s; launches {counts}")
    return r, counts


def phase_step(torch, cfg, params, dev):
    """Launches per prefill and per decode step, a batch-8 decode step's
    time on the host clock (synchronized), and the device's busy share over
    those steps from torch.profiler."""
    from repro_torch.launch.serve_hybrid import MAXLEN, PROMPT, PS, prompt_for
    from repro_torch.serving.engine import PagedEngineConfig, PagedInferenceEngine

    wrappers = counters()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def snap():
        return {n: w.launches for n, w in wrappers.items()}

    def delta(a, b, k=1):
        return {n: (b[n] - a[n]) / k for n in a}

    B, STEPS = 8, 20
    per = {}
    for chunk in (32, 0):
        eng = PagedInferenceEngine(cfg, PagedEngineConfig(
            page_size=PS, num_pages=1 + B * MAXLEN // PS, max_slots=B, max_seq_len=MAXLEN,
            max_new_tokens=MAXLEN - PROMPT, chunk_tokens=chunk), params=params, device=dev)
        a = snap()
        eng.prewarm([PS])                    # one prefill of one 16-token bucket
        per[f"prefill(chunk_tokens={chunk})"] = delta(a, snap())
        if chunk:
            continue
        for i in range(B):
            eng.submit(prompt_for(i, cfg.vocab_size))
        while eng.waiting or any(eng._chunking):
            eng.step()
        eng.step()
        sync()
        a = snap()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            eng.step()
        sync()
        step_ms = (time.perf_counter() - t0) * 1e3 / STEPS
        per["decode step"] = delta(a, snap(), STEPS)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                eng.step()
            sync()
            wall_us = (time.perf_counter() - t0) * 1e6
        top = sorted(device_events(prof), key=lambda e: -e.self_device_time_total)
        dev_us = sum(e.self_device_time_total for e in top)
    for k, v in per.items():
        log(f"  launches per {k}: {v}")
    busy = (f"{dev_us / wall_us:.4f} ({dev_us:.1f} us of {wall_us:.1f} us over 5 steps, "
            f"{sum(e.count for e in top) / 5:g} device operations per step)"
            if dev_us > 0 else "not measured (the profiler saw no device time)")
    log(f"  decode step, batch {B}, {cfg.name} {cfg.n_layers}L d_model {cfg.d_model} "
        f"{str(cfg.compute_dtype).replace('torch.', '')}: {step_ms:.3f} ms (host clock, "
        f"synchronized, mean of {STEPS}); device busy share {busy}")
    for e in top[:10]:
        log(f"    device {e.self_device_time_total / 5:10.1f} us/step  x{e.count / 5:g}/step  {e.key[:90]}")


def phase_parity(torch, legs):
    """Teacher-forced parity of served tokens against the CPU f32 plain path."""
    from repro_torch.models import get_model

    cfg = legs[0]["cfg"]
    cfg32 = cfg.replace(param_dtype=torch.float32, compute_dtype=torch.float32)
    params = legs[0]["params"]

    def to_cpu(t):
        return {k: to_cpu(v) for k, v in t.items()} if isinstance(t, dict) else t.float().cpu()

    p32 = to_cpu(params)
    model = get_model(cfg32)
    steps = flips = 0
    worst = 0.0
    for r, rids in zip(legs, ([0, 1, 5, 12, 23], [3, 18])):
        for rid in rids:
            prompt, out = r["prompts"][rid], r["results"][rid]
            ctx = prompt + out[:-1]
            with torch.no_grad():
                lg = model.logits(p32, model.hidden(p32, [ctx]))[0]
            for j, tok in enumerate(out):
                row = lg[len(prompt) - 1 + j]
                top = int(torch.argmax(row))
                steps += 1
                if top != tok:
                    lead = float(row[top] - row[tok])
                    flips += 1
                    worst = max(worst, lead)
                    log(f"  flip rid={rid} step={j}: gpu {tok} cpu {top}, cpu lead {lead:.4f}")
                    if lead > FLIP_BOUND:
                        raise AssertionError(f"rid {rid} step {j}: CPU lead {lead} above {FLIP_BOUND}")
    log(f"  {steps} teacher-forced steps, {flips} flips, largest CPU lead {worst:.4f} "
        f"(bound {FLIP_BOUND})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    OUT.mkdir(exist_ok=True)

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"phase 1 device: torch {torch.__version__} cuda {torch.version.cuda}; {kind}")
    log(smi)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    (OUT / "kernel_build.log").write_text(str(_build.build_info.get("log", "")))
    ptx = [ln.strip() for ln in str(_build.build_info.get("log", "")).splitlines()
           if "registers" in ln or "spill" in ln]
    log(f"phase 2 build: nvcc sm_90a, {_build.build_info['seconds']:.3f} s "
        f"(load {time.perf_counter() - t0:.3f} s); ptxas: {' | '.join(ptx)}")

    # 3. kernels
    log("phase 3 kernels:")
    rows = phase_kernels(torch, dev)

    # 4. serve
    log("phase 4 serve: smollm-360m FULL bf16, 24 requests through StraightLineRouter")
    chunked, c_counts = serve_leg(torch, 32, None)
    whole, w_counts = serve_leg(torch, 0, chunked["params"])
    for name in ("rmsnorm", "paged_prefill_write", "paged_attention"):
        if c_counts[name] <= 0:
            raise AssertionError(f"{name} was not launched in the chunked serve")
    if w_counts["flash_attention"] <= 0:
        raise AssertionError("flash_attention was not launched in the whole-prompt serve")
    phase_step(torch, chunked["cfg"], chunked["params"], dev)

    # 5. parity
    log("phase 5 parity: teacher-forced CPU f32 plain path on the same weights")
    phase_parity(torch, [chunked, whole])

    # 6. summary
    for r in rows:
        r["launches"] = (w_counts if r["name"] == "flash_attention" else c_counts)[r["name"]]
        r["launches_by_leg"] = {"chunk32": c_counts[r["name"]], "whole_prompt": w_counts[r["name"]]}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    extra = ("shape", "device_ms", "plain_device_ms", "launches_by_leg")
    print(json.dumps({"kernels": [{k: r[k] for k in keys + extra} for r in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
