#!/usr/bin/env python3
"""Times the port's flash attention and paged decode wrappers on an NVIDIA
card, through their public entry points only, so that two checkouts can be
compared in one run on one card:

    python scripts/flash_paged_timing.py --src path/to/checkout/src --tag NAME

Run it on two checkouts in the order parent, change, change, parent.

Shapes: flash_attention on the model's (1, S, 15, 64) bf16 layout at S 16
(an 8-token prompt's bucket) and 2048, flash_attention_bhsd on (1, 15, 16,
64), and SDPA (causal, enable_gqa) beside each; the paged decode's four legs
(flat, int8, chained, int8 + chained; bf16 q, 5 KV heads, G 3, 16-token
pages) at the pools shape (B 8, lengths 120-208, 16-entry rows) and at a long
row (B 4, lengths 1024-4096, 256-entry rows), and the flat leg at the serve
path's lengths 9-16. For each: CUDA events over back-to-back calls (host time
included), the device time torch.profiler records per call (in all and per
kernel), CUDA events around calls queued behind a device sleep, and the
device operations of one call. Prints the card's name and power limit, then
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


def tables(torch, lens, num_pages, ps, P, tpp, gen):
    """Flat rows (B, P) of distinct pages, ceil(len / ps) live each, and the
    chained tables (l1, l2) that encode them (l2 row 0 null)."""
    perm = (torch.randperm(num_pages - 1, generator=gen) + 1).tolist()
    tab = torch.zeros(len(lens), P, dtype=torch.int32)
    for b, n in enumerate(lens):
        k = -(-n // ps)
        tab[b, :k] = torch.tensor(perm[:k], dtype=torch.int32)
        perm = perm[k:]
    B, W1 = len(lens), P // tpp
    l1 = torch.zeros(B, W1, dtype=torch.int32)
    l2 = torch.zeros(1 + B * W1, tpp, dtype=torch.int32)
    for b in range(B):
        for j in range(W1):
            if bool(tab[b, j * tpp:(j + 1) * tpp].ne(0).any()):
                l1[b, j] = 1 + b * W1 + j
                l2[1 + b * W1 + j] = tab[b, j * tpp:(j + 1) * tpp]
    return tab, l1, l2


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default="src")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    from torch.nn import functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops

    if not torch.cuda.is_available():
        print("flash_paged_timing: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    gen = torch.Generator().manual_seed(0)
    bf16 = torch.bfloat16
    H, KV, G, hd, ps = 15, 5, 3, 64, 16

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    calls = {}
    for S in (16, 2048):
        q, k, v = randn(1, S, H, hd), randn(1, S, KV, hd), randn(1, S, KV, hd)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        calls[f"flash_attention S={S}"] = (
            lambda q=q, k=k, v=v, S=S: fa_ops.flash_attention(q, k, v).reshape(1, S, H * hd))
        calls[f"SDPA S={S}"] = (lambda qt=qt, kt=kt, vt=vt: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
    qh, kh, vh = randn(1, H, 16, hd), randn(1, KV, 16, hd), randn(1, KV, 16, hd)
    calls["flash_attention_bhsd S=16"] = lambda: fa_ops.flash_attention_bhsd(qh, kh, vh)

    shapes = {"pools": ([120, 128, 129, 144, 161, 176, 193, 208], 16),
              "long": ([1024, 2048, 3072, 4096], 256), "serve": (list(range(9, 17)), 6)}
    for name, (lens, P) in shapes.items():
        B = len(lens)
        NP = 1 + sum(-(-n // ps) for n in lens)
        tab, l1, l2 = (t.to(dev) for t in tables(torch, lens, NP, ps, P, 4 if P % 4 == 0 else P, gen))
        lt = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = randn(B, 1, H, hd)
        pk, pv = randn(NP, KV, ps, hd), randn(NP, KV, ps, hd)
        ik = torch.randint(-127, 128, (NP, KV, ps, hd), generator=g, device=dev).to(torch.int8)
        iv = torch.randint(-127, 128, (NP, KV, ps, hd), generator=g, device=dev).to(torch.int8)
        sk, sv = ((torch.rand(NP, KV, ps, 1, generator=g, device=dev) * 0.05).to(bf16) for _ in range(2))
        legs = {"flat": ((pk, pv, tab), {}), "int8": ((ik, iv, tab), {"pool_ks": sk, "pool_vs": sv}),
                "chained": ((pk, pv, l1), {"l2_tab": l2}),
                "int8+chained": ((ik, iv, l1), {"pool_ks": sk, "pool_vs": sv, "l2_tab": l2})}
        for leg, (a, kw) in legs.items():
            if name == "serve" and leg != "flat":
                continue
            calls[f"paged_attention[{leg}] {name}"] = (
                lambda a=a, kw=kw, q=q, lt=lt: pa_ops.paged_attention(q, a[0], a[1], a[2], lt, **kw))
    out = {"tag": args.tag, "src": args.src, "rows": {}}
    for name, fn in calls.items():
        device, by_kernel, ops = profiler_ms(torch, fn)
        row = {"events_ms": events_ms(torch, fn), "device_ms": device, "by_kernel": by_kernel,
               "device_ops": ops, "stalled_ms": stalled_ms(torch, fn)}
        out["rows"][name] = row
        kernels = "; ".join(f"{k[:50]} {v:.7f}" for k, v in by_kernel.items())
        print(f"  [{args.tag}] {name}: events {row['events_ms']:.7f} ms, device {row['device_ms']} "
              f"({ops:g} device operations: {kernels}), stalled events {row['stalled_ms']:.7f} ms",
              flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
