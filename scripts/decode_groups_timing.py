#!/usr/bin/env python3
"""Times the port's two decode kernels at glm4-9b's head grouping (32 query
heads over 2 KV heads: G = 16, hd 128, bf16) on an NVIDIA card, through
their public entry points only, so that two checkouts can be compared in
one run on one card:

    python scripts/decode_groups_timing.py --src path/to/checkout/src --tag NAME

Run it on two checkouts in the order parent, change, change, parent.

Shapes: decode_attention over the launcher's dense cache (4 slots, T 96,
lengths 1, 9, 57, 96) and a long one (T 4096, lengths 1024-4096); the paged
decode's four legs (flat, int8, chained, int8 + chained) at the pools shape
(B 8, lengths 120-208, a (129, 2, 16, 128) pool, 16-entry rows) and the
flat leg at a long row (B 4, lengths 1024-4096). For each: CUDA events over
back-to-back calls (host time included), the device time torch.profiler
records per call (in all and per kernel), CUDA events around calls queued
behind a device sleep, the device operations of one call, the splits the
wrapper plans, and the bytes bound. Prints the card's name and power limit,
then one JSON line."""
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
    by_kernel = {e.key[:60]: e.self_device_time_total / n / 1e3 for e in events}
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


def measure(torch, fn, nbytes, **extra):
    dev_ms, by_kernel, ops = profiler_ms(torch, fn)
    return {"events_ms": events_ms(torch, fn), "device_ms": dev_ms, "by_kernel": by_kernel,
            "stalled_ms": stalled_ms(torch, fn), "device_ops": ops,
            "bound_ms": nbytes / HBM_BYTES_S * 1e3, **extra}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default="src")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch

    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops

    if not torch.cuda.is_available():
        print("decode_groups_timing: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)
    gen = torch.Generator().manual_seed(0)
    bf16 = torch.bfloat16
    KV, G, hd, ps, tpp = 2, 16, 128, 16, 4

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf16)

    out = {"tag": args.tag, "src": args.src, "device": torch.cuda.get_device_name(0)}
    for name, B, T, lens_l in (("dense T=96", 4, 96, [1, 9, 57, 96]),
                               ("dense T=4096", 4, 4096, [1024, 2048, 3072, 4096])):
        q, cache = randn(B, 1, G * KV, hd), randn(2, B, T, KV, hd)
        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        nbytes = 2 * 2 * sum(lens_l) * KV * hd + 2 * 2 * B * KV * G * hd + 4 * B
        out[name] = measure(torch, lambda: da_ops.decode_attention(q, cache[0], cache[1], lens), nbytes,
                            splits=da_ops.plan_splits(B, KV, T, G))

    for shape, B, NP, P, lens_l, legs in (
            ("pools", 8, 129, 16, [120, 128, 129, 144, 161, 176, 193, 208],
             (("flat", False, False), ("int8", True, False), ("chained", False, True),
              ("int8+chained", True, True))),
            ("long", 4, 1 + (1024 + 2048 + 3072 + 4096) // 16, 256, [1024, 2048, 3072, 4096],
             (("flat", False, False),))):
        tab, l1, l2 = (t.to(dev) for t in tables(torch, lens_l, NP, ps, P, tpp, gen))
        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        q = randn(B, 1, G * KV, hd)
        pk, pv = randn(NP, KV, ps, hd), randn(NP, KV, ps, hd)
        ik = torch.randint(-127, 128, (NP, KV, ps, hd), generator=g, device=dev).to(torch.int8)
        iv = torch.randint(-127, 128, (NP, KV, ps, hd), generator=g, device=dev).to(torch.int8)
        ks = (torch.rand(NP, KV, ps, 1, generator=g, device=dev) * 0.05).to(bf16)
        vs = (torch.rand(NP, KV, ps, 1, generator=g, device=dev) * 0.05).to(bf16)
        for leg, quant, chained in legs:
            kv = (ik, iv) if quant else (pk, pv)
            kw = {"pool_ks": ks, "pool_vs": vs} if quant else {}
            if chained:
                kw["l2_tab"] = l2
            t_ = l1 if chained else tab
            row = hd + 2 if quant else 2 * hd
            nbytes = 2 * sum(lens_l) * KV * row + 2 * 2 * B * KV * G * hd + 4 * B
            out[f"paged {leg} {shape}"] = measure(
                torch, lambda a=(q, *kv, t_, lens), kw=kw: pa_ops.paged_attention(*a, **kw), nbytes,
                splits=pa_ops.plan_page_splits(B, KV, P, ps, G))
    for k, v in out.items():
        if isinstance(v, dict):
            print(f"{args.tag} {k}: device {v['device_ms']} ms, events {v['events_ms']:.5f}, stalled "
                  f"{v['stalled_ms']:.5f}, {v['device_ops']:g} device operations, {v['splits']} splits, "
                  f"bound {v['bound_ms']:.7f} ms")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
