#!/usr/bin/env python3
"""Times the port's chunkwise mLSTM wrapper (``mlstm_chunkwise_bh``) on an
NVIDIA card, through its public entry point only, so that two checkouts can
be compared in one run on one card:

    python scripts/mlstm_timing.py --src path/to/checkout/src --tag NAME

Run it on two checkouts in the order parent, change, change, parent.

Shapes: xlstm-350m FULL's head width, 4 heads of one sequence (BH 4, DH
512), bf16 q/k/v from a zero carry, at S 8, 16, 32 and 96 (one chunk, L =
S) and S 256 (four chunks of L 64): the lengths the xLSTM serving paths give
the kernel. For each: the device time torch.profiler records per call (in
all and per kernel), CUDA events over back-to-back calls (host time
included) and CUDA events around calls queued behind a device sleep. Prints
the card's name and power limit, one line per shape, then one JSON line."""
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
    torch.profiler; None if it records no device time."""
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
    return (us / n / 1e3 if us > 0 else None), {e.key: e.self_device_time_total / n / 1e3
                                                 for e in events}


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

    from repro_torch.kernels.mlstm_chunk import ops as mk_ops
    from repro_torch.kernels.mlstm_chunk.ref import chunk_len

    if not torch.cuda.is_available():
        print("mlstm_timing: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    BH, DH = 4, 512
    carry = (torch.zeros(BH, DH, DH, device=dev), torch.zeros(BH, DH, device=dev),
             torch.zeros(BH, device=dev))
    out = {"tag": args.tag, "src": args.src, "rows": {}}
    for S in (8, 16, 32, 96, 256):
        q = (torch.randn(BH, S, DH, generator=g, device=dev) * DH ** -0.5).to(torch.bfloat16)
        k = torch.randn(BH, S, DH, generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn(BH, S, DH, generator=g, device=dev).to(torch.bfloat16)
        i = torch.randn(BH, S, generator=g, device=dev)
        lf = torch.nn.functional.logsigmoid(torch.randn(BH, S, generator=g, device=dev) + 2.0)
        fn = (lambda a=(q, k, v, i, lf, *carry): mk_ops.mlstm_chunkwise_bh(*a, chunk=64))
        device, by_kernel = profiler_ms(torch, fn)
        row = {"L": chunk_len(S, 64), "device_ms": device, "by_kernel": by_kernel,
               "events_ms": events_ms(torch, fn), "stalled_ms": stalled_ms(torch, fn)}
        out["rows"][f"S={S}"] = row
        print(f"  [{args.tag}] mlstm_chunkwise (BH {BH}, S {S}, DH {DH}) bf16, L {row['L']}: device "
              f"{device} ms ({'; '.join(f'{k[:40]} {v:.7f}' for k, v in by_kernel.items())}), "
              f"events {row['events_ms']:.7f} ms, stalled events {row['stalled_ms']:.7f} ms",
              flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
