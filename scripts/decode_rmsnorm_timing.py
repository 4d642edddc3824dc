#!/usr/bin/env python3
"""Times the port's rmsnorm and dense decode_attention wrappers on an NVIDIA
card, through their public entry points only, so that two checkouts can be
compared in one run on one card:

    python scripts/decode_rmsnorm_timing.py --src path/to/checkout/src --tag NAME

Shapes: rmsnorm x (8, 960) bf16 beside F.rms_norm; decode_attention q (4, 1,
15, 64) bf16 over a (4, 96, 5, 64) cache, lengths 1, 9, 57, 96 (the
launcher's), and over a (4, 4096, 5, 64) cache, lengths 1024, 2048, 3072,
4096. For each: CUDA events over back-to-back calls (host time included),
the device time torch.profiler records per call (in all and per kernel), and
CUDA events around calls queued behind a device sleep. Prints the card's name and power limit, then
one JSON line."""
import argparse
import json
import statistics
import subprocess
import sys


def events_ms(torch, fn, iters=20, reps=25):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def profiler_ms(torch, fn, n=50):
    """(device ms per call, {kernel name: device ms per call}) from
    torch.profiler; (None, {}) if it records no device time."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]
    us = sum(e.self_device_time_total for e in events)
    by_kernel = {e.key: e.self_device_time_total / n / 1e3 for e in events}
    return (us / n / 1e3 if us > 0 else None), by_kernel


def stalled_ms(torch, fn, n=50, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default="src")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    from torch.nn import functional as F

    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops

    if not torch.cuda.is_available():
        print("decode_rmsnorm_timing: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    bf16 = torch.bfloat16
    x = torch.randn(8, 960, generator=g, device=dev).to(bf16)
    w = torch.linspace(0.5, 1.5, 960, device=dev).to(bf16)
    calls = {"rmsnorm (8, 960)": lambda: rms_ops.rmsnorm(x, w),
             "F.rms_norm (8, 960)": lambda: F.rms_norm(x, (960,), w, 1e-6)}
    for T, lens in ((96, [1, 9, 57, 96]), (4096, [1024, 2048, 3072, 4096])):
        q = torch.randn(4, 1, 15, 64, generator=g, device=dev).to(bf16)
        cache = torch.randn(2, 4, T, 5, 64, generator=g, device=dev).to(bf16)
        lt = torch.tensor(lens, dtype=torch.int32, device=dev)
        calls[f"decode_attention T={T}"] = (
            lambda q=q, c=cache, lt=lt: da_ops.decode_attention(q, c[0], c[1], lt))
    out = {"tag": args.tag, "src": args.src, "rows": {}}
    for name, fn in calls.items():
        device, by_kernel = profiler_ms(torch, fn)
        row = {"events_ms": events_ms(torch, fn), "device_ms": device, "by_kernel": by_kernel,
               "stalled_ms": stalled_ms(torch, fn)}
        out["rows"][name] = row
        kernels = "; ".join(f"{k[:60]} {v:.7f}" for k, v in by_kernel.items())
        print(f"  [{args.tag}] {name}: events {row['events_ms']:.7f} ms, device {row['device_ms']} "
              f"({kernels}), stalled events {row['stalled_ms']:.7f} ms", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
