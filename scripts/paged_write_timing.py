#!/usr/bin/env python3
"""Times the port's two page-pool writes (``paged_prefill_write`` and
``paged_prefill_write_quant``) on an NVIDIA card, through their public entry
points only, so that two checkouts can be compared in one run on one card:

    python scripts/paged_write_timing.py --src path/to/checkout/src --tag NAME

Run it on two checkouts in the order parent, change, change, parent.

Shapes: bf16 k/v (1, Lp, 5, 64), smollm-360m's KV heads and head width, into
a (257, 5, 16, 64) pool through a 160-entry row, at Lp 16 (the main path's
chunk), 256 (the pools phase's bucket) and 2048; each without an offset (a
whole prompt) and with offset 32 (a chunk two pages in). For each: the
device time torch.profiler records per call (in all and per kernel) and the
device operations of one call, CUDA events over back-to-back calls (host
time included), CUDA events around calls queued behind a device sleep, and
the bytes bound: each input read once and each output written once at 3.35
TB/s. Prints the card's name and power limit, one line per case, then one
JSON line."""
import argparse
import json
import statistics
import subprocess
import sys

HBM_BYTES_S = 3.35e12       # H100 SXM device memory rate


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
    """(device ms per call, {kernel name: device ms per call}, device
    operations per call) from torch.profiler; None if it records no device
    time."""
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
    return (us / n / 1e3 if us > 0 else None), by_kernel, sum(e.count for e in events) / n


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

    from repro_torch.kernels.paged_attention import ops as pa_ops

    if not torch.cuda.is_available():
        print("paged_write_timing: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    NP, KV, ps, hd, P = 257, 5, 16, 64, 160
    row = (torch.randperm(NP - 1, generator=torch.Generator().manual_seed(1))[:P] + 1).to(
        torch.int32).to(dev)
    pools = [torch.zeros(NP, KV, ps, hd, dtype=torch.bfloat16, device=dev) for _ in range(2)]
    qpools = [torch.zeros(NP, KV, ps, hd, dtype=torch.int8, device=dev) for _ in range(2)]
    qpools += [torch.zeros(NP, KV, ps, 1, dtype=torch.bfloat16, device=dev) for _ in range(2)]
    out = {"tag": args.tag, "src": args.src, "rows": {}}
    for Lp in (16, 256, 2048):
        k, v = (torch.randn(1, Lp, KV, hd, generator=g, device=dev).to(torch.bfloat16)
                for _ in range(2))
        table = 4 * -(-Lp // ps)
        # bytes: k and v read in bf16; written as bf16, or as int8 values
        # and a bf16 scale per (token, head); the row's entries read
        cases = {"write": (pa_ops.paged_prefill_write, pools, 2 * 2 * 2 * Lp * KV * hd + table),
                 "write_quant": (pa_ops.paged_prefill_write_quant, qpools,
                                 2 * (2 * Lp * KV * hd + Lp * KV * (hd + 2)) + table)}
        for name, (wrapper, dst, nbytes) in cases.items():
            for off in (None, 32):
                fn = (lambda w=wrapper, a=(*dst, k, v, row), o=off: w(*a, offset=o))
                device, by_kernel, ops = profiler_ms(torch, fn)
                r = {"Lp": Lp, "offset": off, "device_ms": device, "by_kernel": by_kernel,
                     "device_ops_per_call": ops, "events_ms": events_ms(torch, fn),
                     "stalled_ms": stalled_ms(torch, fn), "bytes": nbytes,
                     "bound_ms": nbytes / HBM_BYTES_S * 1e3}
                out["rows"][f"{name} Lp={Lp} offset={off}"] = r
                print(f"  [{args.tag}] {name} (1, {Lp}, {KV}, {hd}) bf16 offset {off}: device "
                      f"{device} ms ({'; '.join(f'{k_[:40]} {t:.7f}' for k_, t in by_kernel.items())}), "
                      f"{ops:g} device operations a call, events {r['events_ms']:.7f} ms, stalled "
                      f"events {r['stalled_ms']:.7f} ms, bound {r['bound_ms']:.7f} ms (bytes)", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
