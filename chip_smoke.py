#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py              # from the root of a checkout

Phases, one line (or a few) each; any failure exits non-zero before the
result line:
  1. device   — torch's device name; the card's name and power limit
  2. build    — nvcc builds every kernel of kernels/csrc/ for sm_90a; the
                bf16 flash and mLSTM kernels' SASS must hold tensor-core
                instructions
  3. kernels  — each kernel (and each leg of the paged decode) against its
                plain PyTorch version on the card at the serving paths'
                shapes (edge cases included), then timed with CUDA events
                beside the plain version, the one PyTorch call that computes
                the same function (where there is one) and the card's bound
                for the work; device-only times from torch.profiler beside
                the CUDA-event times, for the kernel and the library call;
                the writes also at offsets past the row's end and at long
                prompts (Lp 256, 2048), and with an offset (one device
                operation a call); the dense decode also at a long cache
                split across blocks,
                the paged decode's four legs at long rows split across
                blocks (split boundaries, determinism, chained == flat),
                flash also at a 2048-token prompt beside SDPA
  4. serve    — launch/serve_hybrid.main() at FULL smollm-360m width in bf16
                (random weights from a seeded generator): 24 requests through
                the StraightLine router onto paged engines, chunked prefill;
                then again with whole-prompt prefill. Launch counts are read
                per run. Then launches per prefill and per decode step (65
                rmsnorm and 32 paged decode), a batch-8 decode step's time
                and the device's busy share; device operations per
                whole-prompt prefill layer, against flash's earlier copying
                composition; device operations per chunked prefill layer,
                against the write through a row shifted beforehand.
  5. launcher — a batch-4 dense decode step's launches (32 decode_attention)
                and time; launch/serve.main() at FULL width in bf16: 32
                requests onto dense engines (the decode_attention kernel), 4
                router workers, prewarm, traces and metrics; chunked
                prefill, then whole-prompt prefill
  6. pools    — a FULL bf16 paged engine under an EngineLoop with an int8
                pool and chained tables, 8 prompts of 120-200 tokens; again
                with flat tables (identical streams) and with a bf16 pool on
                chained tables; bytes per cached token of each pool
  7. xlstm    — xlstm-350m FULL in bf16 (random weights from a seeded
                generator): launch/serve.main(["--arch", "xlstm-350m"]),
                32 requests on dense engines, chunked and whole-prompt; a
                paged engine serving the pools phase's 8 prompts of 120-200
                tokens whole-prompt (chunks of L = 64 in the mLSTM kernel)
                and in 32-token chunks (the carry crosses calls), 21 mLSTM
                launches per prefill or chunk call; a batch-8 decode step's
                time and the device's busy share; then the same weights in
                f32 on a dense engine at the launcher's shapes and on the
                paged engine, both prefill modes
  8. parity   — served requests re-run teacher-forced through the port's
                plain paths on the CPU in f32 on the same weights: the
                whole-sequence forward (phases 4 and 7), the dense cache
                (phase 5) and the paged int8 pool (phase 6). Every flip's
                CPU lead must stay within FLIP_BOUND, except on the bf16
                xLSTM legs, whose leads are recorded beside the CPU's own
                bf16 forward (bf16 alone moves that model's logits by more)
  9. summary  — the kernels JSON line, then the result line.
Writes its longer outputs (build log, traces, metrics) under chip_smoke_out/.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chip_smoke_out"
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_S = 3.35e12       # H100 SXM device memory rate
F32_FLOPS_S = 67e12         # H100 SXM f32 outside the tensor cores
BF16_FLOPS_S = 989e12       # H100 SXM dense bf16 tensor cores
TF32_FLOPS_S = 495e12       # H100 SXM dense TF32 tensor cores
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


def stalled_device_ms(fn, n: int = 50, reps: int = 5) -> float:
    """Device time of one call by CUDA events around ``n`` calls queued
    behind a device-side stall (``torch.cuda._sleep``): the host enqueues the
    calls while the card sleeps, so the host's gaps between launches fall
    inside the stall and not between the calls. Median over ``reps``."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)           # tens of ms: longer than issuing n calls
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def device_ops(fn, n: int = 20) -> float:
    """Device operations (kernels, copies, sets) per call, from torch.profiler."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in device_events(prof)) / n


def device_events(prof):
    """The profiler's averaged events that ran on the card (kernels, copies,
    sets). The CPU ops that launched them report the same device time again,
    so only these are summed."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]


def bound(nbytes: float, ops: float, peak_ops: float):
    return bound_mixed(nbytes, [(ops, peak_ops)])


def bound_mixed(nbytes: float, ops_at: list):
    """The larger of the bytes' time and the operations' time, where
    ``ops_at`` lists (operations, peak rate) by the unit that runs them."""
    tb, to = nbytes / HBM_BYTES_S * 1e3, sum(n / peak for n, peak in ops_at) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_tol(name: str, e: float, dtype) -> None:
    tol = TOL[str(dtype).replace("torch.", "")]
    log(f"  {name}: max_abs_err {e:.3e} (tol {tol:g})")
    if not e <= tol:
        raise AssertionError(f"{name}: error {e} above {tol}")


def paged_decode_bytes(lens, B, KV, G, hd, ps, quant: bool, tpp: int) -> int:
    """Bytes one paged decode call must move: the live tokens' K and V rows
    (a token's row of one head is hd int8 values and a bf16 scale, or hd
    bf16 values), q in and out in bf16, the lengths, and the table entries
    it reads (a page id per live page; chained tables add an l1 entry per
    table page)."""
    pages = [-(-int(n) // ps) for n in lens]
    tables = 4 * sum(pages) + (4 * sum(-(-p // tpp) for p in pages) if tpp else 0)
    row = hd + 2 if quant else 2 * hd
    return 2 * sum(int(n) for n in lens) * KV * row + 2 * 2 * B * KV * G * hd + 4 * B + tables


def pool_rows(torch, lens, num_pages: int, ps: int, P: int, gen):
    """Flat block-table rows (len(lens), P) int32 on the host: distinct
    pages across rows, ceil(len / ps) live entries each, then null pages."""
    perm = (torch.randperm(num_pages - 1, generator=gen) + 1).tolist()
    tab = torch.zeros(len(lens), P, dtype=torch.int32)
    for b, n in enumerate(lens):
        k = -(-n // ps)
        tab[b, :k] = torch.tensor(perm[:k], dtype=torch.int32)
        perm = perm[k:]
    return tab


def chain(torch, tab, tpp: int):
    """The chained tables (l1 (B, P / tpp), l2 (1 + B * P / tpp, tpp)) of
    flat rows ``tab``: l2 row 0 null, then one row per (slot, table page)
    that holds a live page."""
    B, P = tab.shape
    W1 = P // tpp
    l1 = torch.zeros(B, W1, dtype=torch.int32)
    l2 = torch.zeros(1 + B * W1, tpp, dtype=torch.int32)
    for b in range(B):
        for j in range(W1):
            if bool(tab[b, j * tpp:(j + 1) * tpp].ne(0).any()):
                l1[b, j] = 1 + b * W1 + j
                l2[1 + b * W1 + j] = tab[b, j * tpp:(j + 1) * tpp]
    return l1, l2


def int8_pools(torch, g, dev, NP, KV, ps, hd):
    """Random int8 K/V pools and their bf16 scale pools."""
    ik = torch.randint(-127, 128, (NP, KV, ps, hd), generator=g, device=dev).to(torch.int8)
    iv = torch.randint(-127, 128, (NP, KV, ps, hd), generator=g, device=dev).to(torch.int8)
    ks = (torch.rand(NP, KV, ps, 1, generator=g, device=dev) * 0.05).to(torch.bfloat16)
    vs = (torch.rand(NP, KV, ps, 1, generator=g, device=dev) * 0.05).to(torch.bfloat16)
    return ik, iv, ks, vs


def check_quant_write(torch, pa_ops, write_ref, g, dev, NP, row, Lp, off, dt):
    """One quantizing write at offset ``off`` into random int8 pools against
    the plain write through the shifted row. The int8 values may differ from
    quantize_kv only where x * 127 / amax is exactly half-way between two
    integers (found in f64, where that quotient is exact), and only by 1;
    every other byte of pages 1.. must match, and pages the chunk does not
    reach must be untouched (page 0 absorbs pad writes and writes past the
    row's end, and is never compared; ids outside the pool are dropped).
    Returns (ties in the input, int8 values differing)."""
    KV, ps, hd = 5, 16, 64
    pools = [torch.randint(-127, 128, (NP, KV, ps, hd), generator=g, device=dev).to(torch.int8)
             for _ in range(2)]
    scales = [torch.rand(NP, KV, ps, 1, generator=g, device=dev).to(torch.bfloat16) for _ in range(2)]
    k, v = (torch.randn((1, Lp, KV, hd), generator=g, device=dev).to(dt) for _ in range(2))
    shifted = pa_ops._shift_row(row, off, ps)
    got = pa_ops.paged_prefill_write_quant(*(t.clone() for t in pools + scales), k, v, row, offset=off)
    want = write_ref(*(t.clone() for t in pools + scales), k, v, shifted)
    torch.cuda.synchronize()
    t = torch.arange(Lp, device=dev)
    pages, slot = pa_ops.write_page_ids(row, off // ps, Lp, ps).long(), t % ps
    live = (pages > 0) & (pages < NP)        # the null page and dropped ids aside
    at = (pages[live][:, None], torch.arange(KV, device=dev)[None, :], slot[live][:, None])
    ties = diffs = 0
    for x, a, b in ((k, got[0], want[0]), (v, got[1], want[1])):
        xd = x[0][live].double()
        r = xd * 127 / xd.abs().amax(-1, keepdim=True).clamp_min(1e-300)
        tie = (r - torch.floor(r)) == 0.5
        d = (a[at].float() - b[at].float()).abs()
        if d.numel() and (float(d.max()) > 1 or bool((d > 0)[~tie].any())):
            raise AssertionError(f"paged_prefill_write_quant Lp={Lp} off={off}: int8 values "
                                 f"differ from quantize_kv away from a rounding tie")
        ties += int(tie.sum())
        diffs += int((d > 0).sum())
        b[at] = a[at]                        # the ties taken, every other byte must match
    untouched = torch.ones(NP, dtype=torch.bool, device=dev)
    untouched[pages[live]] = False
    untouched[0] = False
    for a, b, before in zip(got, want, pools + scales):
        if not torch.equal(a[1:], b[1:]):
            raise AssertionError(f"paged_prefill_write_quant Lp={Lp}: pages differ from the plain write")
        if not torch.equal(a[untouched], before[untouched]):
            raise AssertionError(f"paged_prefill_write_quant Lp={Lp}: touched a page outside the row")
    return ties, diffs


def mlstm_inputs(torch, g, dev, BH, S, DH, dt):
    """q (scaled by DH^-1/2 as the model scales it), k, v in ``dt``; i and
    lf = log_sigmoid(f) in f32."""
    q = (torch.randn(BH, S, DH, generator=g, device=dev) * DH ** -0.5).to(dt)
    k = torch.randn(BH, S, DH, generator=g, device=dev).to(dt)
    v = torch.randn(BH, S, DH, generator=g, device=dev).to(dt)
    i = torch.randn(BH, S, generator=g, device=dev)
    lf = torch.nn.functional.logsigmoid(torch.randn(BH, S, generator=g, device=dev) + 2.0)
    return q, k, v, i, lf


def mlstm_zero(torch, BH, DH, dev):
    return (torch.zeros(BH, DH, DH, device=dev), torch.zeros(BH, DH, device=dev),
            torch.zeros(BH, device=dev))


def mlstm_bytes(BH, S, DH, elem: int) -> int:
    """q, k, v read and h written in the input dtype, i and lf read, the
    carry C, n, m read and written in f32."""
    return 4 * BH * S * DH * elem + 2 * BH * S * 4 + 2 * 4 * BH * (DH * DH + DH + 1)


def mlstm_ops(BH, S, DH, L) -> int:
    """Operations (2 per multiply-add) of S / L chunks per head: the causal
    q k^T and s v (L (L + 1) / 2 pairs each), q C and the carry update k^T v
    (L DH^2 each), q . n and the n update (L DH each)."""
    return sum(n for n, _ in mlstm_ops_at(BH, S, DH, L))


def mlstm_ops_at(BH, S, DH, L) -> list:
    """``mlstm_ops`` by the unit the bf16 kernel runs them on: q k^T and s v
    on the bf16 tensor cores, q C in TF32, the carry update, q . n and the n
    update in f32 FMAs."""
    c = BH * (S // L)
    return [(c * 2 * DH * L * (L + 1), BF16_FLOPS_S), (c * 2 * L * DH * DH, TF32_FLOPS_S),
            (c * (2 * L * DH * DH + 4 * L * DH), F32_FLOPS_S)]


def scaled_err(a, b) -> float:
    """Largest difference, over the reference's largest magnitude where that
    is above 1 (absolute below it)."""
    b = b.float()
    return float((a.float() - b).abs().max()) / max(1.0, float(b.abs().max()))


def time_shape(kernel, plain, library, b_ms: float, b_by: str, **extra) -> dict:
    """A kernel at one shape beside its plain version, its library call (or
    None) and its bound: CUDA events, profiler device time, stalled events."""
    d = {"ms": time_ms(kernel), "device_ms": device_ms(kernel) or stalled_device_ms(kernel),
         "stalled_ms": stalled_device_ms(kernel), "plain_ms": time_ms(plain),
         "plain_device_ms": device_ms(plain), "library_ms": None, "library_device_ms": None,
         "bound_ms": b_ms, "bound_by": b_by, **extra}
    if library is not None:
        d["library_ms"] = time_ms(library)
        d["library_device_ms"] = device_ms(library) or stalled_device_ms(library)
    return d


def log_shape(name: str, shape: str, d: dict) -> None:
    lib = ("null" if d["library_ms"] is None
           else f"{d['library_ms']:.5f} (device {d['library_device_ms']:.7f})")
    log(f"  time {name} [{shape}]: kernel {d['ms']:.5f} ms (device {d['device_ms']:.7f}; stalled "
        f"events {d['stalled_ms']:.7f}), plain {d['plain_ms']:.5f} ms (device {d['plain_device_ms']}), "
        f"library {lib} ms, bound {d['bound_ms']:.7f} ms ({d['bound_by']}): "
        f"{d['device_ms'] / d['bound_ms']:.2f}x the bound")


def kernel_sass(lib_path, kernel: str, labels: dict) -> dict:
    """Tensor-core (HMMA or HGMMA) instructions in each instance of a kernel
    (each function whose mangled name holds ``kernel``), from ``cuobjdump
    -sass`` of the built library; ``labels`` maps a fragment of the mangled
    name (the template argument) to the instance's label."""
    import os
    import shutil

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                         check=True).stdout
    counts = {}
    for section in out.split("Function : ")[1:]:
        name = section.split("\n", 1)[0].strip()
        if kernel in name:
            label = next((v for k, v in labels.items() if k in name), name)
            counts[label] = section.count("HMMA") + section.count("HGMMA")
    return counts


def phase_kernels(torch, dev):
    from torch.nn import functional as F

    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_ref,
        paged_prefill_write_quant_ref,
        paged_prefill_write_ref,
    )
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    g = torch.Generator(dev).manual_seed(1234)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=g, device=dev, dtype=f32).to(dtype)

    # -- rmsnorm: every norm of the path (D = 960) on the one-warp path (also
    #    D = 2048 bf16 and 1024 f32, its widest), the general path (a ragged
    #    D, D = 4096, an unaligned row), rows 1 to 4096 -----------------------
    errs = []
    for (R, D, dt, aligned) in [(8, 960, bf16, True), (32, 960, bf16, True), (1, 960, bf16, True),
                                (4096, 960, bf16, True), (8, 2048, bf16, True), (8, 960, f32, True),
                                (3, 1024, f32, True), (5, 997, bf16, True), (3, 997, f32, True),
                                (4096, 997, bf16, True), (1, 4096, bf16, True), (8, 4096, f32, True),
                                (8, 960, bf16, False), (8, 960, f32, False)]:
        x = randn(R, D, dtype=dt) if aligned else randn(R * D + 1, dtype=dt)[1:].view(R, D)
        w = torch.linspace(0.5, 1.5, D, device=dev).to(dt)
        e = err(rms_ops.rmsnorm(x, w), rmsnorm_ref(x, w))
        torch.cuda.synchronize()
        vec = 16 // x.element_size()
        path = "one-warp" if aligned and D % vec == 0 and D // vec <= 256 else "general"
        check_tol(f"rmsnorm R={R} D={D} {dt}{'' if aligned else ' unaligned'} ({path} path)", e, dt)
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
        "library_fn": lambda x=x, w=w: F.rms_norm(x, (D,), w, 1e-6), "library_call": "F.rms_norm",
        "bound_ms": b_ms, "bound_by": b_by,
    })

    # -- paged prefill write: exact, untouched pages preserved, at offsets
    #    inside the row and past its end (the null page takes those tokens),
    #    an id outside the pool (dropped), a ragged Lp, and the long shapes --
    NP, KV, ps, hd, P = 25, 5, 16, 64, 6
    NPp = 129
    row_small = torch.tensor([9, 3, 17, 4, 22, 0], dtype=torch.int32, device=dev)
    row_long = (torch.randperm(NPp - 1, generator=torch.Generator().manual_seed(5)) + 1).to(
        torch.int32).to(dev)                  # 128 pages: a 2048-token prompt
    row_oob = torch.tensor([9, -4, 17, 31, 22, 0], dtype=torch.int32, device=dev)
    for (np_, row, Lp, off, dt) in [(NP, row_small, 32, 0, bf16), (NP, row_small, 32, 32, bf16),
                                    (NP, row_small, 16, 64, bf16), (NP, row_small, 96, 0, f32),
                                    (NP, row_small, 20, 0, bf16), (NP, row_small, 64, 32, f32),
                                    (NP, row_small, 32, 80, f32), (NP, row_small, 16, 96, bf16),
                                    (NP, row_oob, 64, 0, bf16), (NPp, row_long, 256, 0, bf16),
                                    (NPp, row_long, 2048, 0, bf16)]:
        pool_k, pool_v = randn(np_, KV, ps, hd, dtype=dt), randn(np_, KV, ps, hd, dtype=dt)
        k, v = randn(1, Lp, KV, hd, dtype=dt), randn(1, Lp, KV, hd, dtype=dt)
        ck, cv = pool_k.clone(), pool_v.clone()
        rk, rv = pool_k.clone(), pool_v.clone()
        pa_ops.paged_prefill_write(ck, cv, k, v, row, offset=off)
        paged_prefill_write_ref(rk, rv, k, v, pa_ops._shift_row(row, off, ps))
        torch.cuda.synchronize()
        untouched = torch.ones(np_, dtype=torch.bool, device=dev)
        ids = pa_ops.write_page_ids(row, off // ps, Lp, ps).long()
        untouched[ids[(ids >= 0) & (ids < np_)]] = False
        untouched[0] = False                 # page 0 absorbs pad writes: never compared
        if not (torch.equal(ck[1:], rk[1:]) and torch.equal(cv[1:], rv[1:])):
            raise AssertionError(f"paged_prefill_write Lp={Lp} off={off}: pages differ from the plain write")
        if not (torch.equal(ck[untouched], pool_k[untouched]) and torch.equal(cv[untouched], pool_v[untouched])):
            raise AssertionError(f"paged_prefill_write Lp={Lp} off={off}: touched a page outside the row")
        log(f"  paged_prefill_write pool {np_} pages Lp={Lp} offset={off} {dt} row {row.tolist()[:6]}: "
            f"exact, untouched pages preserved")

    def write_timed(Lp, row, offset=None):
        pool_k, pool_v = randn(NPp, KV, ps, hd), randn(NPp, KV, ps, hd)
        k, v = randn(1, Lp, KV, hd), randn(1, Lp, KV, hd)
        t = torch.arange(Lp, device=dev)
        at = (row.long()[t // ps][:, None], torch.arange(KV, device=dev)[None, :], (t % ps)[:, None])

        def index_put():
            pool_k.index_put_(at, k[0])
            pool_v.index_put_(at, v[0])

        b_ms, b_by = bound(2 * 2 * 2 * Lp * KV * hd + 4 * -(-Lp // ps), 0, F32_FLOPS_S)
        args = (pool_k, pool_v, k, v, row)
        return (lambda: pa_ops.paged_prefill_write(*args, offset=offset),
                lambda: paged_prefill_write_ref(*args), index_put, b_ms, b_by)

    Lp = 16                                 # an 8-token prompt's chunk, bucketed to a page
    kernel, plain, index_put, b_ms, b_by = write_timed(Lp, row_small)
    by_shape = {}
    for Lp_long in (256, 2048):
        kl, pl_, lib, bl, bb = write_timed(Lp_long, row_long)
        by_shape[f"Lp={Lp_long}"] = d = time_shape(kl, pl_, lib, bl, bb)
        log_shape("paged_prefill_write", f"k/v (1, {Lp_long}, {KV}, {hd}) bf16", d)
    chunk = write_timed(Lp, row_small, 32)[0]          # a chunk two pages into the row
    rows.append({
        "name": "paged_prefill_write", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:233",
        "shape": f"k/v (1, {Lp}, {KV}, {hd}) bf16 into ({NPp}, {KV}, {ps}, {hd})",
        "max_abs_err": 0.0, "fns": (kernel, plain), "library_fn": index_put,
        "library_call": "index_put_ (k and v)", "bound_ms": b_ms, "bound_by": b_by,
        "by_shape": by_shape, "chunk_fn": chunk,
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
    b_ms, b_by = bound(paged_decode_bytes(lens_t.tolist(), B, KV, G, hd, ps, False, 0),
                       4 * KV * G * hd * int(lens_t.sum()), F32_FLOPS_S)
    rows.append({
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:167",
        "shape": f"q ({B}, {KV}, {G}, {hd}) bf16, lengths {lens_t.tolist()}",
        "max_abs_err": max(errs),
        "fns": (lambda a=(q, pk, pv, tab, lens_t): pa_ops.paged_attention(*a),
                lambda a=(qg, pk, pv, tab, lens_t): paged_attention_ref(*a)),
        "library_fn": None, "bound_ms": b_ms, "bound_by": b_by,
    })

    # -- flash attention: the prompt buckets, a ragged S, f32, a long S; each
    #    on (B, H, S, hd) tensors and on the model's strided (B, S, H, hd)
    #    layout (views of one fused projection) ----------------------------
    H = G * KV
    errs = []
    for (S, dt) in [(16, bf16), (32, bf16), (40, bf16), (96, bf16), (40, f32), (96, f32),
                    (200, f32), (2048, bf16)]:
        q, k, v = randn(1, H, S, hd, dtype=dt), randn(1, KV, S, hd, dtype=dt), randn(1, KV, S, hd, dtype=dt)
        e = err(fa_ops.flash_attention_bhsd(q, k, v), attention_ref(q, k, v))
        qkv = randn(1, S, H + 2 * KV, hd, dtype=dt)
        qm, km, vm = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
        want = attention_ref(qm.transpose(1, 2), km.transpose(1, 2), vm.transpose(1, 2)).transpose(1, 2)
        e = max(e, err(fa_ops.flash_attention(qm, km, vm), want))
        torch.cuda.synchronize()
        check_tol(f"flash_attention S={S} {dt}, (B, H, S, hd) and strided (B, S, H, hd)", e, dt)
        errs.append(e)

    def flash_timed(S):
        """The model's entry point on (1, S, H, hd) as attention.py gives it;
        the plain version and SDPA on the (B, H, S, hd) views."""
        q, k, v = randn(1, S, H, hd), randn(1, S, KV, hd), randn(1, S, KV, hd)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        nbytes, ops = 2 * (2 * H + 2 * KV) * S * hd, 4 * H * hd * S * (S + 1) // 2
        b_ms, b_by = bound(nbytes, ops, BF16_FLOPS_S)
        return {"kernel": lambda: fa_ops.flash_attention(q, k, v),
                "plain": lambda: attention_ref(qt, kt, vt),
                "library": lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                  enable_gqa=True),
                "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": ops}

    S = 2048                    # a long prompt: where the tensor cores show
    f_long = flash_timed(S)
    fl = time_shape(f_long["kernel"], f_long["plain"], f_long["library"], f_long["bound_ms"],
                    f_long["bound_by"], shape=f"q (1, {S}, {H}, {hd}) bf16, k/v (1, {S}, {KV}, {hd})",
                    bytes=f_long["bytes"], ops=f_long["ops"])
    log_shape("flash_attention", fl["shape"], fl)
    S = 16                      # an 8-token prompt's bucket, the serve whole-prompt path
    f_short = flash_timed(S)
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:83",
        "shape": f"q (1, {S}, {H}, {hd}) bf16, k/v (1, {S}, {KV}, {hd}) (the model's layout)",
        "max_abs_err": max(errs),
        "fns": (f_short["kernel"], f_short["plain"]),
        "library_fn": f_short["library"],
        "library_call": "scaled_dot_product_attention (causal, enable_gqa)",
        "bound_ms": f_short["bound_ms"], "bound_by": f_short["bound_by"],
        "by_shape": {"S=2048": fl},
    })
    # -- dense decode: the launcher's shapes (T = 96 and 128: one split), then
    #    a T split across blocks: lengths 0, 1, split - 1, split, split + 1
    #    and T at T = 4096 and at a T that is no multiple of 32 (B = 6), every
    #    split boundary's neighbours at B = 1, the long timed shape; f32 and
    #    bf16, with and without the softcap. Every case: two calls
    #    bit-identical (the splits are combined in a fixed order), a length
    #    of 0 gives 0 ----------------------------------------------------------
    def dense_case(B, TT, lens_l, dt, cap):
        q = randn(B, 1, G * KV, hd, dtype=dt)
        cache = randn(2, B, TT, KV, hd, dtype=dt)
        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        out = da_ops.decode_attention(q, cache[0], cache[1], lens, softcap=cap)
        again = da_ops.decode_attention(q, cache[0], cache[1], lens, softcap=cap)
        ref = decode_attention_ref(q[:, 0].reshape(B, KV, G, hd), cache[0].transpose(1, 2),
                                   cache[1].transpose(1, 2), lens, softcap=cap)
        torch.cuda.synchronize()
        name = (f"decode_attention B={B} T={TT} ({da_ops.plan_splits(B, KV, TT)} splits) "
                f"lens={lens_l} softcap={cap} {dt}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: non-finite output")
        if not torch.equal(out, again):
            raise AssertionError(f"{name}: two calls differ")
        live = lens > 0
        if bool((~live).any()) and float(out[~live].float().abs().max()) != 0.0:
            raise AssertionError(f"{name}: a length of 0 must give 0")
        e = err(out.reshape(B, KV, G, hd)[live], ref[live]) if bool(live.any()) else 0.0
        check_tol(name + ", two calls bit-identical", e, dt)
        return e

    cases = [(4, 96, [1, 9, 57, 96], bf16, 0.0), (4, 96, [1, 16, 95, 96], f32, 0.0),
             (4, 96, [1, 9, 57, 96], bf16, 30.0), (4, 128, [1, 16, 95, 128], bf16, 0.0),
             (4, 96, [0, 0, 0, 0], bf16, 0.0)]
    for dt in (bf16, f32):
        for cap in (0.0, 30.0):
            for TT in (4096, 1000):
                s = da_ops.split_bounds(TT, da_ops.plan_splits(6, KV, TT))[1][0]
                cases.append((6, TT, [0, 1, s - 1, s, s + 1, TT], dt, cap))
        s = da_ops.split_bounds(4096, da_ops.plan_splits(1, KV, 4096))[1][0]
        cases += [(1, 4096, [L], dt, 0.0) for L in (1, s - 1, s, s + 1, 4096)]
        cases.append((4, 4096, [1024, 2048, 3072, 4096], dt, 0.0))
    errs = [dense_case(*c) for c in cases]

    def dense_bytes(lens, B):
        """Live K and V rows, q in and out, the lengths (bf16)."""
        return 2 * 2 * sum(lens) * KV * hd + 2 * 2 * B * KV * G * hd + 4 * B

    def dense_timed(B, T, lens_l):
        """Kernel, plain version, SDPA with a length mask, bound: one shape."""
        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        q = randn(B, 1, G * KV, hd)
        cache = randn(2, B, T, KV, hd)
        qg = q[:, 0].reshape(B, KV, G, hd)
        k_t, v_t = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
        mask = torch.arange(T, device=dev)[None, None, None, :] < lens[:, None, None, None]
        b_ms, b_by = bound(dense_bytes(lens_l, B), 4 * KV * G * hd * sum(lens_l), F32_FLOPS_S)
        return {
            "kernel": lambda: da_ops.decode_attention(q, cache[0], cache[1], lens),
            "plain": lambda: decode_attention_ref(qg, k_t, v_t, lens),
            "library": lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k_t, v_t,
                                                              attn_mask=mask, enable_gqa=True),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": dense_bytes(lens_l, B),
            "splits": da_ops.plan_splits(B, KV, T),
        }

    # timed beside its bound at a long cache, where the T axis is split
    B, T, lens_l = 4, 4096, [1024, 2048, 3072, 4096]
    t_long = dense_timed(B, T, lens_l)
    lr = time_shape(t_long["kernel"], t_long["plain"], t_long["library"], t_long["bound_ms"],
                    t_long["bound_by"], shape=f"q ({B}, 1, {G * KV}, {hd}) bf16, cache ({B}, {T}, {KV}, "
                    f"{hd}), lengths {lens_l}, {t_long['splits']} splits", splits=t_long["splits"],
                    bytes=t_long["bytes"])
    log_shape("decode_attention", lr["shape"], lr)
    B, T, lens_l = 4, 96, [1, 9, 57, 96]                  # the launcher's shape
    t_short = dense_timed(B, T, lens_l)
    rows.append({
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:94",
        "shape": f"q ({B}, 1, {G * KV}, {hd}) bf16, cache ({B}, {T}, {KV}, {hd}), lengths {lens_l}",
        "max_abs_err": max(errs),
        "fns": (t_short["kernel"], t_short["plain"]),
        "library_fn": t_short["library"],
        "library_call": "scaled_dot_product_attention (boolean length mask, enable_gqa)",
        "bound_ms": t_short["bound_ms"], "bound_by": t_short["bound_by"],
        "by_shape": {"T=4096": lr},
    })

    # -- quantized prefill write: int8 bits against quantize_kv, ties counted;
    #    the small pool above at offsets inside the row and past its end,
    #    then the compact-pool phase's 129-page pool and 16-entry rows at its
    #    whole-prompt buckets (Lp 128 and 256), and a 2048-token prompt ----
    Pp, tpp_p = 16, 4
    lens_p = [120, 128, 129, 144, 161, 176, 193, 208]      # the pools phase's decode lengths
    tab_p = pool_rows(torch, lens_p, NPp, ps, Pp, gen_tab)
    ties_total = diffs_total = 0
    for (np_, row, Lp, off, dt) in [(NP, row_small, 32, 0, bf16), (NP, row_small, 32, 32, bf16),
                                    (NP, row_small, 16, 64, bf16), (NP, row_small, 20, 0, bf16),
                                    (NP, row_small, 96, 0, f32), (NP, row_small, 64, 32, f32),
                                    (NP, row_small, 32, 80, f32), (NP, row_small, 16, 96, bf16),
                                    (NP, row_oob, 64, 0, bf16), (NPp, tab_p[0].to(dev), 128, 0, bf16),
                                    (NPp, tab_p[7].to(dev), 256, 0, bf16), (NPp, row_long, 2048, 0, bf16)]:
        ties, diffs = check_quant_write(torch, pa_ops, paged_prefill_write_quant_ref, g, dev,
                                        np_, row, Lp, off, dt)
        ties_total += ties
        diffs_total += diffs
        log(f"  paged_prefill_write_quant pool {np_} pages Lp={Lp} offset={off} {dt}: scales exact, "
            f"int8 values differing {diffs}, all at rounding ties (ties in the input {ties}), "
            f"untouched pages preserved")

    def quant_timed(Lp, row, offset=None):
        qpools = [torch.zeros(NPp, KV, ps, hd, dtype=torch.int8, device=dev) for _ in range(2)]
        qscales = [torch.zeros(NPp, KV, ps, 1, dtype=bf16, device=dev) for _ in range(2)]
        k, v = randn(1, Lp, KV, hd), randn(1, Lp, KV, hd)
        b_ms, b_by = bound(2 * (2 * Lp * KV * hd + Lp * KV * (hd + 2)) + 4 * -(-Lp // ps), 0,
                           F32_FLOPS_S)
        args = (*qpools, *qscales, k, v, row)
        return (lambda: pa_ops.paged_prefill_write_quant(*args, offset=offset),
                lambda: paged_prefill_write_quant_ref(*args), b_ms, b_by)

    Lp, row = 256, tab_p[7].to(dev)                       # 7 of the 8 pool prompts bucket to 256
    kernel, plain, b_ms, b_by = quant_timed(Lp, row)
    kl, pl_, bl, bb = quant_timed(2048, row_long)
    by_shape = {"Lp=2048": time_shape(kl, pl_, None, bl, bb)}
    log_shape("paged_prefill_write_quant", f"k/v (1, 2048, {KV}, {hd}) bf16", by_shape["Lp=2048"])
    # a chunk two pages into an 18-entry row: the kernel resolves the offset
    chunk = quant_timed(Lp, torch.cat([row, torch.zeros(2, dtype=torch.int32, device=dev)]), 32)[0]
    rows.append({
        "name": "paged_prefill_write_quant", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention/kernel.py:299",
        "shape": f"k/v (1, {Lp}, {KV}, {hd}) bf16 into int8 ({NPp}, {KV}, {ps}, {hd}) + bf16 scales",
        "max_abs_err": 0.0, "rounding_ties": ties_total, "int8_values_differing": diffs_total,
        "fns": (kernel, plain), "library_fn": None, "bound_ms": b_ms, "bound_by": b_by,
        "by_shape": by_shape, "chunk_fn": chunk,
    })

    # -- paged decode legs: int8 pools, chained tables, both; dead slots and
    #    page-boundary lengths in the small pool, then the compact-pool
    #    phase's shapes (129 pages, 16-entry rows, 4 per table page) --------
    B, G = 8, 3
    tab = torch.stack([torch.randperm(NP - 1, generator=gen_tab)[:P] + 1 for _ in range(B)])
    tab[0] = 0
    tab[7] = 0
    lens = torch.tensor([1, 16, 17, 32, 96, 5, 48, 1], dtype=torch.int32, device=dev)
    tab = tab.to(torch.int32)
    leg_errs = {"int8": [], "chained": [], "int8+chained": []}
    cases = [(NP, tab, lens, 2, dt, cap) for (dt, cap) in [(bf16, 0.0), (f32, 0.0), (bf16, 30.0)]]
    cases.append((NPp, tab_p, torch.tensor(lens_p, dtype=torch.int32, device=dev), tpp_p, bf16, 0.0))
    for (np_, tab_c, lens_c, tpp, dt, cap) in cases:
        l1, l2 = chain(torch, tab_c, tpp)
        tab_c, l1, l2 = tab_c.to(dev), l1.to(dev), l2.to(dev)
        q = randn(B, 1, G * KV, hd, dtype=dt)
        qg = q[:, 0].reshape(B, KV, G, hd)
        pk, pv = randn(np_, KV, ps, hd, dtype=dt), randn(np_, KV, ps, hd, dtype=dt)
        ik, iv, ks, vs = int8_pools(torch, g, dev, np_, KV, ps, hd)
        flat = pa_ops.paged_attention(q, pk, pv, tab_c, lens_c, softcap=cap)
        outs = {
            "chained": (pa_ops.paged_attention(q, pk, pv, l1, lens_c, softcap=cap, l2_tab=l2),
                        paged_attention_ref(qg, pk, pv, l1, lens_c, softcap=cap, l2_tab=l2), flat),
            "int8": (pa_ops.paged_attention(q, ik, iv, tab_c, lens_c, softcap=cap, pool_ks=ks, pool_vs=vs),
                     paged_attention_ref(qg, ik, iv, tab_c, lens_c, softcap=cap, pool_ks=ks, pool_vs=vs),
                     None),
        }
        outs["int8+chained"] = (
            pa_ops.paged_attention(q, ik, iv, l1, lens_c, softcap=cap, pool_ks=ks, pool_vs=vs, l2_tab=l2),
            paged_attention_ref(qg, ik, iv, l1, lens_c, softcap=cap, pool_ks=ks, pool_vs=vs, l2_tab=l2),
            outs["int8"][0])
        torch.cuda.synchronize()
        for leg, (out, ref, same_as) in outs.items():
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"paged_attention[{leg}]: non-finite output")
            if same_as is not None and not torch.equal(out, same_as):
                raise AssertionError(f"paged_attention[{leg}]: differs from the flat table's output")
            e = err(out.reshape(B, KV, G, hd), ref)
            check_tol(f"paged_attention[{leg}] pool {np_} pages, tpp {tpp}, lens={lens_c.tolist()} "
                      f"softcap={cap} {dt}" + (" (bit-identical to flat)" if same_as is not None else ""),
                      e, dt)
            leg_errs[leg].append(e)
    # timed at the compact-pool phase's shapes, each beside its twin without
    # the option it adds (int8 -> bf16 flat, chained -> bf16 flat,
    # int8+chained -> int8 flat), in the same run
    lens_t = torch.tensor(lens_p, dtype=torch.int32, device=dev)
    l1, l2 = chain(torch, tab_p, tpp_p)
    tab_t, l1, l2 = tab_p.to(dev), l1.to(dev), l2.to(dev)
    q = randn(B, 1, G * KV, hd)
    qg = q[:, 0].reshape(B, KV, G, hd)
    pk, pv = randn(NPp, KV, ps, hd), randn(NPp, KV, ps, hd)
    ik, iv, ks, vs = int8_pools(torch, g, dev, NPp, KV, ps, hd)
    flat_fns = {False: lambda: pa_ops.paged_attention(q, pk, pv, tab_t, lens_t),
                True: lambda: pa_ops.paged_attention(q, ik, iv, tab_t, lens_t, pool_ks=ks, pool_vs=vs)}
    for leg, quant, chained, twin in [("int8", True, False, "flat"), ("chained", False, True, "flat"),
                                      ("int8+chained", True, True, "int8")]:
        b_ms, b_by = bound(paged_decode_bytes(lens_p, B, KV, G, hd, ps, quant, tpp_p if chained else 0),
                           4 * KV * G * hd * sum(lens_p), F32_FLOPS_S)
        kv = (ik, iv) if quant else (pk, pv)
        kw = {"pool_ks": ks, "pool_vs": vs} if quant else {}
        t_ = l1 if chained else tab_t
        if chained:
            kw["l2_tab"] = l2
        rows.append({
            "name": f"paged_attention[{leg}]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:167",
            "shape": f"q ({B}, {KV}, {G}, {hd}) bf16, {'int8' if quant else 'bf16'} pool ({NPp}, {KV}, "
                     f"{ps}, {hd}), {f'chained (tpp {tpp_p})' if chained else 'flat'} tables, "
                     f"lengths {lens_p}",
            "max_abs_err": max(leg_errs[leg]),
            "fns": (lambda a=(q, *kv, t_, lens_t), kw=kw: pa_ops.paged_attention(*a, **kw),
                    lambda a=(qg, *kv, t_, lens_t), kw=kw: paged_attention_ref(*a, **kw)),
            "twin": (twin, flat_fns[twin == "int8"]),
            "library_fn": None, "bound_ms": b_ms, "bound_by": b_by,
        })

    # -- paged decode with the row's pages split across blocks: every leg at
    #    the split boundaries (lengths 0, 1 on the null page, split - 1,
    #    split, split + 1 and a full row at B = 6; each boundary's neighbours
    #    at B = 1) on 256-page rows, f32 and bf16, with and without the
    #    softcap: two calls bit-identical, chained bit-identical to flat, a
    #    length of 0 gives 0; then the four legs timed at B = 4, lengths
    #    1024-4096 --------------------------------------------------------------
    P_l, tpp_l = 256, 4

    def paged_case(lens_l, dt, cap, quant, dead=()):
        Bc = len(lens_l)
        NPc = 1 + sum(-(-n // ps) for n in lens_l)
        tab_c = pool_rows(torch, lens_l, NPc, ps, P_l, gen_tab)
        for b in dead:
            tab_c[b] = 0                                  # a dead slot on the null page
        l1c, l2c = chain(torch, tab_c, tpp_l)
        tab_c, l1c, l2c = tab_c.to(dev), l1c.to(dev), l2c.to(dev)
        lens_c = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        q = randn(Bc, 1, G * KV, hd, dtype=dt)
        if quant:
            ik, iv, ks, vs = int8_pools(torch, g, dev, NPc, KV, ps, hd)
            kv, kw = (ik, iv), {"pool_ks": ks, "pool_vs": vs}
        else:
            kv, kw = (randn(NPc, KV, ps, hd, dtype=dt), randn(NPc, KV, ps, hd, dtype=dt)), {}
        out = pa_ops.paged_attention(q, *kv, tab_c, lens_c, softcap=cap, **kw)
        again = pa_ops.paged_attention(q, *kv, tab_c, lens_c, softcap=cap, **kw)
        chained = pa_ops.paged_attention(q, *kv, l1c, lens_c, softcap=cap, l2_tab=l2c, **kw)
        ref = paged_attention_ref(q[:, 0].reshape(Bc, KV, G, hd), *kv, tab_c, lens_c, softcap=cap, **kw)
        torch.cuda.synchronize()
        name = (f"paged_attention[{'int8' if quant else 'flat'}, chained] B={Bc} P={P_l} "
                f"({pa_ops.plan_page_splits(Bc, KV, P_l, ps)} splits) lens={lens_l} softcap={cap} {dt}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: non-finite output")
        if not (torch.equal(out, again) and torch.equal(out, chained)):
            raise AssertionError(f"{name}: two calls, or chained and flat, differ")
        live = lens_c > 0
        if bool((~live).any()) and float(out[~live].float().abs().max()) != 0.0:
            raise AssertionError(f"{name}: a length of 0 must give 0")
        e = err(out.reshape(Bc, KV, G, hd)[live], ref[live])
        check_tol(name + ", two calls and chained bit-identical to flat", e, dt)
        return e

    split_errs = {"flat": [], "int8": []}
    for quant in (False, True):
        for dt in (bf16, f32):
            for cap in (0.0, 30.0):
                bnd = pa_ops.page_split_bounds(P_l, pa_ops.plan_page_splits(6, KV, P_l, ps))
                s = bnd[1][0] * ps
                cases = [([0, 1, s - 1, s, s + 1, P_l * ps], (1,))]
                bnd1 = pa_ops.page_split_bounds(P_l, pa_ops.plan_page_splits(1, KV, P_l, ps))
                if dt == bf16 and cap == 0.0:
                    cases += [([a_ * ps + d], ()) for a_, _ in bnd1[1:] for d in (-1, 0, 1)]
                for lens_l, dead in cases:
                    split_errs["int8" if quant else "flat"].append(paged_case(lens_l, dt, cap, quant, dead))
    # (names of their own: the legs' timed lambdas above read q, pk, pv, ...)
    B_l, lens_long = 4, [1024, 2048, 3072, 4096]
    NPl = 1 + sum(-(-n // ps) for n in lens_long)
    tab_l = pool_rows(torch, lens_long, NPl, ps, P_l, gen_tab)
    l1_l, l2_l = chain(torch, tab_l, tpp_l)
    tab_l, l1_l, l2_l = tab_l.to(dev), l1_l.to(dev), l2_l.to(dev)
    lens_lt = torch.tensor(lens_long, dtype=torch.int32, device=dev)
    q_l = randn(B_l, 1, G * KV, hd)
    qg_l = q_l[:, 0].reshape(B_l, KV, G, hd)
    pk_l, pv_l = randn(NPl, KV, ps, hd), randn(NPl, KV, ps, hd)
    i8_l = int8_pools(torch, g, dev, NPl, KV, ps, hd)
    nsplit_l = pa_ops.plan_page_splits(B_l, KV, P_l, ps)
    for leg, quant, chained in [("flat", False, False), ("int8", True, False), ("chained", False, True),
                                ("int8+chained", True, True)]:
        kv = i8_l[:2] if quant else (pk_l, pv_l)
        kw = {"pool_ks": i8_l[2], "pool_vs": i8_l[3]} if quant else {}
        if chained:
            kw["l2_tab"] = l2_l
        t_ = l1_l if chained else tab_l
        nbytes = paged_decode_bytes(lens_long, B_l, KV, G, hd, ps, quant, tpp_l if chained else 0)
        b_ms, b_by = bound(nbytes, 4 * KV * G * hd * sum(lens_long), F32_FLOPS_S)
        shape = (f"q ({B_l}, {KV}, {G}, {hd}) bf16, {'int8' if quant else 'bf16'} pool ({NPl}, {KV}, {ps}, "
                 f"{hd}), {f'chained (tpp {tpp_l})' if chained else 'flat'} tables, lengths {lens_long}, "
                 f"{nsplit_l} splits")
        d = time_shape(lambda a=(q_l, *kv, t_, lens_lt), kw=kw: pa_ops.paged_attention(*a, **kw),
                       lambda a=(qg_l, *kv, t_, lens_lt), kw=kw: paged_attention_ref(*a, **kw), None,
                       b_ms, b_by, shape=shape, bytes=nbytes, splits=nsplit_l)
        log_shape(f"paged_attention[{leg}]", shape, d)
        row = next(r for r in rows if r["name"] == ("paged_attention" if leg == "flat"
                                                     else f"paged_attention[{leg}]"))
        row["by_shape"] = {"B=4 lengths 1024-4096": d}
        row["max_abs_err"] = max(row["max_abs_err"], *split_errs["int8" if quant else "flat"])

    # -- chunkwise mLSTM: xlstm-350m FULL's head width (DH = 512), one and
    #    four sequences of 4 heads, every chunk length the serving paths give
    #    it (S 8, 16, 32, 96 with L = S; S 256 with L = 64; a ragged S 200,
    #    L = S), bf16 and f32, from zero and from a non-zero carry; then an
    #    all-pad tail must leave (C, n, m) bit-identical ------------------------
    from repro_torch.kernels.mlstm_chunk import ops as mk_ops
    from repro_torch.kernels.mlstm_chunk.ref import NEG, chunk_len, mlstm_chunkwise_bh_ref

    DH = 512
    plan = {BH: mk_ops.plan_col_tile(BH, DH) for BH in (4, 16)}
    log("  mlstm_chunkwise bf16 tile plan at DH 512: " + ", ".join(
        f"BH {BH}: TC {tc}, {BH * DH // tc} blocks" for BH, tc in plan.items()))
    if 4 * DH // plan[4] < 128:
        raise AssertionError(f"mlstm_chunkwise: {4 * DH // plan[4]} blocks at BH 4, DH 512")
    h_errs, state_errs, raw = [], [], []
    for BH in (4, 16):
        zero = mlstm_zero(torch, BH, DH, dev)
        pre = mlstm_inputs(torch, g, dev, BH, 24, DH, f32)
        carried = mlstm_chunkwise_bh_ref(*pre, *zero, chunk=64)[1:]
        for dt in (bf16, f32):
            for S in (8, 16, 32, 96, 256, 200):
                x = mlstm_inputs(torch, g, dev, BH, S, DH, dt)
                worst_h = worst_s = 0.0
                for cname, carry in (("zero", zero), ("carried", carried)):
                    got = mk_ops.mlstm_chunkwise_bh(*x, *carry, chunk=64)
                    want = mlstm_chunkwise_bh_ref(*x, *carry, chunk=64)
                    torch.cuda.synchronize()
                    if not bool(torch.isfinite(got[0].float()).all()):
                        raise AssertionError(f"mlstm_chunkwise BH={BH} S={S}: non-finite h")
                    e_h = scaled_err(got[0], want[0])
                    e_s = max(float((got[1] - want[1]).abs().max()) / float(want[1].abs().max()),
                              float((got[2] - want[2]).abs().max()) / float(want[2].abs().max()),
                              scaled_err(got[3], want[3]))
                    tol = TOL[str(dt).replace("torch.", "")]
                    if not (e_h <= tol and e_s <= TOL["float32"]):
                        raise AssertionError(f"mlstm_chunkwise BH={BH} S={S} {cname} carry {dt}: "
                                             f"h {e_h}, state {e_s}")
                    worst_h, worst_s = max(worst_h, e_h), max(worst_s, e_s)
                    state_errs.append(e_s)
                    if dt == bf16:
                        h_errs.append(e_h)
                        raw.append(err(got[0], want[0]))
                log(f"  mlstm_chunkwise BH={BH} S={S} L={chunk_len(S, 64)} {dt}, zero and carried: "
                    f"h err {worst_h:.3e} (tol {tol:g}), C/n/m err {worst_s:.3e} (tol 2e-05)")
    x = mlstm_inputs(torch, g, dev, 4, 64, DH, bf16)
    i, lf = x[3].clone(), x[4].clone()
    i[:, 32:], lf[:, 32:] = NEG, 0.0                   # a whole chunk of pad steps
    carry = [t[:4].contiguous() for t in carried]
    padded = mk_ops.mlstm_chunkwise_bh(*x[:3], i, lf, *carry, chunk=32)
    head = mk_ops.mlstm_chunkwise_bh(*(t[:, :32].contiguous() for t in (*x[:3], i, lf)), *carry,
                                     chunk=32)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(padded[1:], head[1:])):
        raise AssertionError("mlstm_chunkwise: an all-pad tail changed (C, n, m)")
    log("  mlstm_chunkwise: an all-pad chunk leaves (C, n, m) bit-identical")
    # timed at every shape of the xLSTM paths, 4 heads of one sequence, bf16
    # (S 16: an 8-token prompt's bucket in the launcher; 32: a chunk; 96: the
    # launcher's length cap; 256: a long prompt's bucket, 4 chunks of 64)
    by_shape = {}
    zero4 = mlstm_zero(torch, 4, DH, dev)
    for S in (8, 16, 32, 96, 256):
        xs = mlstm_inputs(torch, g, dev, 4, S, DH, bf16)
        L = chunk_len(S, 64)
        kfn = (lambda a=(*xs, *zero4): mk_ops.mlstm_chunkwise_bh(*a, chunk=64))
        pfn = (lambda a=(*xs, *zero4): mlstm_chunkwise_bh_ref(*a, chunk=64))
        b_ms, b_by = bound(mlstm_bytes(4, S, DH, 2), mlstm_ops(4, S, DH, L), F32_FLOPS_S)
        # the bound at the units the bf16 kernel runs each product on
        k_ms, k_by = bound_mixed(mlstm_bytes(4, S, DH, 2), mlstm_ops_at(4, S, DH, L))
        by_shape[S] = {"L": L, "ms": time_ms(kfn), "device_ms": device_ms(kfn),
                       "plain_ms": time_ms(pfn), "plain_device_ms": device_ms(pfn),
                       "bound_ms": b_ms, "bound_by": b_by,
                       "bound_kernel_rates_ms": k_ms, "bound_kernel_rates_by": k_by,
                       "bytes": mlstm_bytes(4, S, DH, 2), "ops": mlstm_ops(4, S, DH, L)}
        log(f"  time mlstm_chunkwise [q/k/v (4, {S}, {DH}) bf16, L={L}]: kernel "
            f"{by_shape[S]['ms']:.5f} ms (device {by_shape[S]['device_ms']}), plain "
            f"{by_shape[S]['plain_ms']:.5f} ms (device {by_shape[S]['plain_device_ms']}), "
            f"bound {b_ms:.6f} ms ({b_by}, f32 rate; {by_shape[S]['ops']:.3e} operations, "
            f"{by_shape[S]['bytes']:.3e} bytes), at the kernel's rates {k_ms:.6f} ms ({k_by})")
    S = 16
    xs = mlstm_inputs(torch, g, dev, 4, S, DH, bf16)
    rows.append({
        "name": "mlstm_chunkwise", "route": "cuda", "source": "src/repro_torch/kernels/csrc/mlstm_chunk.cu",
        "replaces": "src/repro/kernels/mlstm_chunk/kernel.py:101",
        "shape": f"q/k/v (4, {S}, {DH}) bf16, L={S}, zero carry", "max_abs_err": max(raw),
        "max_scaled_err_h_bf16": max(h_errs), "max_rel_err_state": max(state_errs),
        "fns": (lambda a=(*xs, *zero4): mk_ops.mlstm_chunkwise_bh(*a, chunk=64),
                lambda a=(*xs, *zero4): mlstm_chunkwise_bh_ref(*a, chunk=64)),
        "library_fn": None, "bound_ms": by_shape[S]["bound_ms"], "bound_by": by_shape[S]["bound_by"],
        "by_shape": by_shape, "tile_plan": {f"BH {BH}, DH {DH}": tc for BH, tc in plan.items()},
    })

    for r in rows:
        kernel, plain = r.pop("fns")
        r["ms"], r["plain_ms"] = time_ms(kernel), time_ms(plain)
        r["device_ms"], r["plain_device_ms"] = device_ms(kernel), device_ms(plain)
        r["stalled_ms"] = stalled_device_ms(kernel)
        r["device_source"] = "profiler"
        if r["device_ms"] is None:           # the profiler recorded no device time
            r["device_ms"], r["device_source"] = r["stalled_ms"], "stalled events"
        library = r.pop("library_fn")
        r["library_ms"] = r["library_device_ms"] = None
        lib = "null"
        if library is not None:              # the yardstick on both clocks
            r["library_ms"] = time_ms(library)
            r["library_device_ms"] = device_ms(library) or stalled_device_ms(library)
            lib = f"{r['library_ms']:.5f} (device {r['library_device_ms']:.7f})"
        chunk = ""
        if "chunk_fn" in r:                  # the same call with offset 32: a chunked write
            fn = r.pop("chunk_fn")
            r["chunk"] = {"offset": 32, "ms": time_ms(fn), "device_ms": device_ms(fn),
                          "device_ops_per_call": device_ops(fn)}
            chunk = (f", with offset 32 {r['chunk']['ms']:.5f} ms (device {r['chunk']['device_ms']}, "
                     f"{r['chunk']['device_ops_per_call']:g} device operations a call)")
            if round(r["chunk"]["device_ops_per_call"]) != 1:     # the profiler may drop an event
                raise AssertionError(f"{r['name']} with an offset: {r['chunk']['device_ops_per_call']} "
                                     f"device operations a call, not the kernel alone")
        twin = ""
        if "twin" in r:
            name, fn = r.pop("twin")
            r["twin"] = {"leg": name, "ms": time_ms(fn), "device_ms": device_ms(fn)}
            twin = f", {name} leg at the same shape {r['twin']['ms']:.5f} ms (device {r['twin']['device_ms']})"
        log(f"  time {r['name']} [{r['shape']}]: kernel {r['ms']:.5f} ms (device {r['device_ms']}, "
            f"{r['device_source']}; stalled events {r['stalled_ms']:.7f}), "
            f"plain {r['plain_ms']:.5f} ms (device {r['plain_device_ms']}), library {lib} ms, "
            f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}){chunk}{twin}")
    return rows


def counters():
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mlstm_chunk import ops as mk_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops

    return {"rmsnorm": rms_ops.rmsnorm, "paged_prefill_write": pa_ops.paged_prefill_write,
            "paged_prefill_write_quant": pa_ops.paged_prefill_write_quant,
            "paged_attention": pa_ops.paged_attention, "flash_attention": fa_ops.flash_attention_bhsd,
            "decode_attention": da_ops.decode_attention, "mlstm_chunkwise": mk_ops.mlstm_chunkwise_bh}


def reset_counts() -> None:
    from repro_torch.kernels import _build

    for w in counters().values():
        _build.reset_launches(w)


def read_counts() -> dict:
    """Launches per kernel; the paged decode's total under ``paged_attention``
    and each leg under ``paged_attention[leg]`` (the flat leg is the
    ``paged_attention`` row of the summary)."""
    out = {}
    for n, w in counters().items():
        out[n] = w.launches
        for leg, c in getattr(w, "leg_launches", {}).items():
            out[f"{n}[{leg}]"] = c
    return out


def serve_leg(torch, chunk_tokens: int, params):
    from repro_torch.launch import serve_hybrid

    reset_counts()
    t0 = time.perf_counter()
    r = serve_hybrid.main(device="cuda", smoke=False, chunk_tokens=chunk_tokens,
                          out_dir=str(OUT / f"serve_chunk{chunk_tokens}"), seed=0, params=params,
                          verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
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

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def snap():
        return read_counts()

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
        log(f"  launches per {k}: { {n: c for n, c in v.items() if c} }")
    busy = (f"{dev_us / wall_us:.4f} ({dev_us:.1f} us of {wall_us:.1f} us over 5 steps, "
            f"{sum(e.count for e in top) / 5:g} device operations per step)"
            if dev_us > 0 else "not measured (the profiler saw no device time)")
    log(f"  decode step, batch {B}, {cfg.name} {cfg.n_layers}L d_model {cfg.d_model} "
        f"{str(cfg.compute_dtype).replace('torch.', '')}: {step_ms:.3f} ms (host clock, "
        f"synchronized, mean of {STEPS}); device busy share {busy}")
    for e in top[:10]:
        log(f"    device {e.self_device_time_total / 5:10.1f} us/step  x{e.count / 5:g}/step  {e.key[:90]}")
    return per


def prefill_device_ops(torch, cfg, params, dev, chunk_tokens: int) -> int:
    """Device operations, from torch.profiler, of one prefill of a 16-token
    bucket on a fresh one-slot paged engine (whole-prompt, or chunked)."""
    from torch.autograd import DeviceType

    from repro_torch.launch.serve_hybrid import MAXLEN, PS
    from repro_torch.serving.engine import PagedEngineConfig, PagedInferenceEngine

    eng = PagedInferenceEngine(cfg, PagedEngineConfig(
        page_size=PS, num_pages=1 + MAXLEN // PS, max_slots=1, max_seq_len=MAXLEN,
        max_new_tokens=8, chunk_tokens=chunk_tokens), params=params, device=dev)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        eng.prewarm([PS])
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type != DeviceType.CPU)


def prefill_ops(torch, cfg, params, dev):
    """Device operations of one whole-prompt prefill (a 16-token bucket on a
    paged engine) per layer, from torch.profiler: through the flash wrapper
    as it is, and through the earlier composition of it (q, k and v copied
    to (B, H, S, hd) by .contiguous(), the output returned as a transposed
    view that attention.py's reshape copies), on the same engine shape."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    def count():
        return prefill_device_ops(torch, cfg, params, dev, 0)

    def copying_flash(q, k, v):
        return fa_ops.flash_attention_bhsd(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                                           v.transpose(1, 2).contiguous()).transpose(1, 2)

    count()                                     # warm-up
    now = count()
    strided = fa_ops.flash_attention
    fa_ops.flash_attention = copying_flash
    try:
        before = count()
    finally:
        fa_ops.flash_attention = strided
    n = cfg.n_layers
    log(f"  device operations per whole-prompt prefill (16-token bucket, {n} layers): {now} "
        f"({now / n:.2f} a layer) through the strided flash wrapper; {before} ({before / n:.2f} a "
        f"layer) through the copying composition; {(before - now) / n:.2f} fewer a layer")
    if now == 0 or (before - now) / n < 3:
        raise AssertionError(f"prefill device operations: {now} against {before} over {n} layers")
    return {"per_layer": now / n, "copying_per_layer": before / n}


def chunked_write_ops(torch, cfg, params, dev):
    """Device operations of one chunked prefill (a 16-token bucket on a
    paged engine with 32-token chunks) per layer, from torch.profiler:
    through the write wrapper as it is (the kernel resolves the chunk's
    offset) and through the earlier composition (the row shifted by
    ``_shift_row``'s seven device operations, then the kernel at shift 0),
    substituted in the model's write on the same engine shape."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.models import attention as attn

    def count():   # the most of three profiles: the profiler may drop an event, never add one
        return max(prefill_device_ops(torch, cfg, params, dev, 32) for _ in range(3))

    resolving = attn.paged_write_prompt

    def shifting_write(cfg, cache, k, v, tab_row, offset=None):
        if offset is not None:
            tab_row = pa_ops._shift_row(tab_row, offset, cache["k"].shape[2])
        return resolving(cfg, cache, k, v, tab_row)

    count()                                     # warm-up
    now = count()
    attn.paged_write_prompt = shifting_write
    try:
        before = count()
    finally:
        attn.paged_write_prompt = resolving
    n = cfg.n_layers
    log(f"  device operations per chunked prefill (16-token bucket, 32-token chunks, {n} layers): "
        f"{now} ({now / n:.2f} a layer) with the offset resolved in the write kernel; {before} "
        f"({before / n:.2f} a layer) through the shifted row; {(before - now) / n:.2f} fewer a layer")
    if now == 0 or (before - now) / n < 7:
        raise AssertionError(f"chunked prefill device operations: {now} against {before} over {n} layers")
    return {"per_layer": now / n, "shifted_row_per_layer": before / n}


def dense_step(torch, cfg, params, dev):
    """The launcher's dense engine shape (4 slots, max_len 96): launches per
    decode step, one decode_attention per layer, and a batch-4 decode step's
    time on the host clock (synchronized, mean of 20)."""
    from repro_torch.launch.serve_hybrid import prompt_for
    from repro_torch.serving.engine import EngineConfig, InferenceEngine

    B, STEPS = 4, 20
    eng = InferenceEngine(cfg, EngineConfig(max_slots=B, max_len=96, max_new_tokens=64),
                          params=params, device=dev)
    for i in range(B):
        eng.submit(prompt_for(i, cfg.vocab_size))
    while eng.waiting or any(eng._chunking):
        eng.step()
    eng.step()
    torch.cuda.synchronize()
    a = read_counts()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    per = {n: (c - a[n]) / STEPS for n, c in read_counts().items()}
    log(f"  dense decode step, batch {B}, {cfg.name} {cfg.n_layers}L: {step_ms:.3f} ms (host clock, "
        f"synchronized, mean of {STEPS}); launches per step { {n: c for n, c in per.items() if c} }")
    if per["decode_attention"] != cfg.n_layers:
        raise AssertionError(f"dense decode step: {per['decode_attention']} decode_attention launches, "
                             f"expected {cfg.n_layers}")
    return step_ms, per


def launcher_leg(torch, chunk_tokens: int, params, arch: str = "smollm-360m",
                 need=("decode_attention",)):
    """launch/serve.main() at FULL width in bf16 on dense engines; every
    kernel in ``need`` must have been launched."""
    from repro_torch.launch import serve

    out = OUT / f"launcher_{arch}_chunk{chunk_tokens}"
    out.mkdir(parents=True, exist_ok=True)
    argv = ["--arch", arch, "--workers", "4", "--prewarm", "--chunk-tokens", str(chunk_tokens),
            "--trace-out", str(out / "trace.json"), "--metrics-interval", "0.05",
            "--metrics-out", str(out / "metrics.prom")]
    reset_counts()
    t0 = time.perf_counter()
    r = serve.main(argv, params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    m = r["metrics"].summary()
    log(f"  launcher {arch} chunk_tokens={chunk_tokens}: {m['total']} requests, {m['failed']} failed, "
        f"serve {r['wall_s']:.3f} s (wall {wall:.3f} s incl. tier set-up and prewarm), "
        f"placement {r['by_tier']}, median response {m['median_response_s']} s, "
        f"p99 {m['p99_response_s']} s; launches {counts}")
    if m["total"] != 32 or m["failed"] != 0:
        raise AssertionError(f"launcher {arch} chunk_tokens={chunk_tokens}: {m}")
    for name in need:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched by the launcher ({arch}, chunk {chunk_tokens})")
    return r, counts


POOL_PROMPTS = [120, 131, 142, 154, 165, 177, 188, 200]


def pools_run(torch, cfg, params, dev, cache_dtype: str, chained: bool):
    """A FULL paged engine under an EngineLoop serving 8 prompts of 120-200
    tokens, 16-token pages, 4 pages per second-level table row."""
    import numpy as np

    from repro_torch.serving.engine import PagedEngineConfig, PagedInferenceEngine
    from repro_torch.serving.scheduler import EngineLoop

    prompts = [[int(t) for t in np.random.default_rng(1000 + i).integers(1, cfg.vocab_size, n)]
               for i, n in enumerate(POOL_PROMPTS)]
    eng = PagedInferenceEngine(cfg, PagedEngineConfig(
        page_size=16, num_pages=129, max_slots=8, max_seq_len=256, max_new_tokens=8,
        cache_dtype=cache_dtype, chained_tables=chained, table_page_entries=4),
        params=params, device=dev)
    eng.prewarm()
    reset_counts()
    t0 = time.perf_counter()
    with EngineLoop(eng, name=f"pools-{cache_dtype}-{'chained' if chained else 'flat'}") as loop:
        sids = [loop.submit(p) for p in prompts]
        outs = [loop.wait(sid, 300).out for sid in sids]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    snap = eng.capacity_now()
    log(f"  pools {cache_dtype} {'chained' if chained else 'flat'}: {len(outs)} requests in "
        f"{wall:.3f} s, kv_bytes_per_token {snap['kv_bytes_per_token']}, "
        f"{eng.preemptions} preemptions; launches {counts}")
    return {"prompts": prompts, "outs": outs, "counts": counts, "snap": snap, "wall_s": wall}


def phase_pools(torch, cfg, params, dev):
    """int8 pool on chained tables, on flat tables, and a bf16 pool on
    chained tables: identical int8 streams, every leg launched."""
    i8c = pools_run(torch, cfg, params, dev, "int8", True)
    i8f = pools_run(torch, cfg, params, dev, "int8", False)
    bfc = pools_run(torch, cfg, params, dev, "bf16", True)
    if i8c["outs"] != i8f["outs"]:
        raise AssertionError(f"int8 chained and flat streams differ: {i8c['outs']} vs {i8f['outs']}")
    log(f"  int8 chained == int8 flat: {len(i8c['outs'])} identical greedy streams")
    for run, key in ((i8f, "paged_prefill_write_quant"), (i8f, "paged_attention[int8]"),
                     (i8c, "paged_attention[int8+chained]"), (bfc, "paged_attention[chained]")):
        if run["counts"][key] <= 0:
            raise AssertionError(f"{key} was not launched in the compact-pool phase")
    KV, hd = cfg.n_kv_heads, cfg.hd         # 32 layers x 2 x 5 x (64 + 2) and x 64 x 2 at FULL
    want = {"int8": cfg.n_layers * 2 * KV * (hd + 2), "bf16": cfg.n_layers * 2 * KV * hd * 2}
    got = {"int8": i8c["snap"]["kv_bytes_per_token"], "bf16": bfc["snap"]["kv_bytes_per_token"]}
    log(f"  kv_bytes_per_token: int8 {got['int8']} B, bf16 {got['bf16']} B "
        f"(from the shapes: {want['int8']} and {want['bf16']})")
    if got != {k: float(v) for k, v in want.items()}:
        raise AssertionError(f"kv_bytes_per_token {got}, expected {want}")
    return {"int8_chained": i8c, "int8_flat": i8f, "bf16_chained": bfc}


def xlstm_paged_run(torch, cfg, params, dev, chunk_tokens: int):
    """A FULL xLSTM paged engine under an EngineLoop serving the pools
    phase's 8 prompts of 120-200 tokens, 16-token pages; every prefill or
    chunk call launches the mLSTM kernel once per mLSTM layer."""
    import numpy as np

    from repro_torch.serving.engine import PagedEngineConfig, PagedInferenceEngine
    from repro_torch.serving.scheduler import EngineLoop

    prompts = [[int(t) for t in np.random.default_rng(1000 + i).integers(1, cfg.vocab_size, n)]
               for i, n in enumerate(POOL_PROMPTS)]
    eng = PagedInferenceEngine(cfg, PagedEngineConfig(
        page_size=16, num_pages=129, max_slots=8, max_seq_len=256, max_new_tokens=8,
        chunk_tokens=chunk_tokens), params=params, device=dev)
    eng.prewarm()
    reset_counts()
    t0 = time.perf_counter()
    with EngineLoop(eng, name=f"xlstm-chunk{chunk_tokens}") as loop:
        sids = [loop.submit(p) for p in prompts]
        outs = [loop.wait(sid, 300).out for sid in sids]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    calls = sum(-(-n // chunk_tokens) for n in POOL_PROMPTS) if chunk_tokens else len(prompts)
    n_mlstm = sum(1 for kind in cfg.block_pattern if kind == "mlstm") * cfg.n_superblocks
    log(f"  xlstm paged {str(cfg.compute_dtype).replace('torch.', '')} chunk_tokens={chunk_tokens}: "
        f"{len(outs)} requests in {wall:.3f} s, "
        f"{eng.preemptions} preemptions, {calls} prefill calls; launches "
        f"{ {n: c for n, c in counts.items() if c} }")
    if eng.preemptions or any(len(o) != 8 for o in outs):
        raise AssertionError(f"xlstm paged chunk {chunk_tokens}: {eng.preemptions} preemptions, {outs}")
    if counts["mlstm_chunkwise"] != n_mlstm * calls or counts["rmsnorm"] <= 0:
        raise AssertionError(f"xlstm paged chunk {chunk_tokens}: {counts['mlstm_chunkwise']} mLSTM "
                             f"launches, expected {n_mlstm} x {calls}")
    return {"prompts": prompts, "outs": outs, "counts": counts, "wall_s": wall}


def xlstm_dense_run(torch, cfg, params, dev, chunk_tokens: int):
    """A dense engine at the launcher's shapes (4 slots, max_len 96, the
    launcher's 8-token prompts of requests 0-7), generate()."""
    import numpy as np

    from repro_torch.serving.engine import EngineConfig, InferenceEngine

    prompts = [[int(t) for t in np.random.default_rng(rid).integers(1, cfg.vocab_size, 8)]
               for rid in range(8)]
    eng = InferenceEngine(cfg, EngineConfig(max_slots=4, max_len=96, max_new_tokens=8,
                                            chunk_tokens=chunk_tokens), params=params, device=dev)
    reset_counts()
    t0 = time.perf_counter()
    outs = [s.out for s in eng.generate(prompts)]
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"  xlstm dense {str(cfg.compute_dtype).replace('torch.', '')} chunk_tokens={chunk_tokens}: "
        f"{len(outs)} requests in {time.perf_counter() - t0:.3f} s; launches "
        f"{ {n: c for n, c in counts.items() if c} }")
    if any(len(o) != 8 for o in outs) or counts["mlstm_chunkwise"] <= 0:
        raise AssertionError(f"xlstm dense chunk {chunk_tokens}: {outs}, {counts}")
    return {"prompts": prompts, "outs": outs, "counts": counts}


def phase_xlstm(torch, dev):
    """xlstm-350m FULL in bf16: the launcher's 32 requests (chunked and
    whole-prompt), the long prompts on a paged engine (whole-prompt and
    chunked), launches per prefill and a decode step's time."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import get_model

    cfg = get_config("xlstm-350m")
    params = get_model(cfg).init(torch.Generator(dev).manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params))
    n_mlstm = sum(1 for kind in cfg.block_pattern if kind == "mlstm") * cfg.n_superblocks
    log(f"  xlstm-350m FULL: {cfg.n_layers} layers ({n_mlstm} mLSTM), d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, {n_params} parameters in bf16")
    need = ("mlstm_chunkwise", "rmsnorm")
    l_chunk, lc_counts = launcher_leg(torch, 32, params, "xlstm-350m", need)
    l_whole, lw_counts = launcher_leg(torch, 0, params, "xlstm-350m", need)
    p_whole = xlstm_paged_run(torch, cfg, params, dev, 0)
    p_chunk = xlstm_paged_run(torch, cfg, params, dev, 32)
    same = sum(a == b for a, b in zip(p_whole["outs"], p_chunk["outs"]))
    log(f"  xlstm paged whole-prompt and chunked: {same} of {len(p_whole['outs'])} streams identical")
    per = phase_step(torch, cfg, params, dev)
    for k, v in per.items():
        if k.startswith("prefill") and v["mlstm_chunkwise"] != n_mlstm:
            raise AssertionError(f"xlstm {k}: {v['mlstm_chunkwise']} mLSTM launches, expected {n_mlstm}")
    # f32 legs on the card, the same weights upcast: there rounding moves the
    # logits by about 1e-4, so the parity bound tells a fault from noise
    cfg32 = cfg.replace(param_dtype=torch.float32, compute_dtype=torch.float32)
    params32 = _map(params, lambda t: t.float())
    f32 = {"dense": [xlstm_dense_run(torch, cfg32, params32, dev, c) for c in (32, 0)],
           "paged": [xlstm_paged_run(torch, cfg32, params32, dev, c) for c in (0, 32)]}
    return {"cfg": cfg, "params": params, "launcher": [l_chunk, l_whole],
            "paged": [p_whole, p_chunk], "f32": f32,
            "counts": {"xlstm_launcher_chunk32": lc_counts, "xlstm_launcher_whole_prompt": lw_counts,
                       "xlstm_paged_whole_prompt": p_whole["counts"],
                       "xlstm_paged_chunk32": p_chunk["counts"]}}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def teacher_forced_rows(torch, cfg, params, prompt, out, layout: str):
    """Logit rows of the port's plain path on the CPU for the prompt and
    every served token but the last, fed one decode step at a time: a dense
    cache, or a paged int8 pool on 16-token pages."""
    from repro_torch.models import attention as attn
    from repro_torch.models import get_model
    from repro_torch.models import transformer as tf
    from repro_torch.models.rotary import positions_for

    model = get_model(cfg)
    n = len(prompt) + len(out)
    if layout == "dense":
        cache = model.init_cache(1, n, "cpu")
        pidx = 0
    else:
        pages = -(-n // 16)
        cache = model.init_paged_cache(1 + pages, 16, "cpu")
        row = torch.arange(1, pages + 1, dtype=torch.int32)
        pidx = attn.PagedPrefillIndex(row, 0)
    L = len(prompt)
    h, cache = tf.forward(cfg, params, torch.tensor([prompt]), positions_for(1, L), mode="prefill",
                          cache=cache, cache_index=pidx)
    rows = [model.logits(params, h[0, -1])]
    for j, tok in enumerate(out[:-1]):
        pos = torch.tensor([L + j], dtype=torch.int32)
        idx = pos if layout == "dense" else attn.PagedIndex(pos, row[None, :])
        h, cache = tf.forward(cfg, params, torch.tensor([[tok]]), pos[:, None], mode="decode",
                              cache=cache, cache_index=idx)
        rows.append(model.logits(params, h[0, -1]))
    return rows


class Parity:
    """Teacher-forced parity of served tokens against the port's plain paths
    on the CPU in f32 on the same weights: every flip's CPU lead must stay
    within FLIP_BOUND. Tallies steps, flips and the largest lead per model."""

    def __init__(self, torch):
        self.torch = torch
        self.tally = {}

    def f32(self, cfg):
        return cfg.replace(param_dtype=self.torch.float32, compute_dtype=self.torch.float32)

    def to_cpu(self, t):
        return _map(t, lambda x: x.float().cpu())

    def check(self, name, rid, rows, out, bound=True):
        """Rows of CPU logits against the served tokens; with ``bound`` False
        the leads are recorded and not held to FLIP_BOUND."""
        t = self.tally.setdefault(name.split()[0], {"steps": 0, "flips": 0, "worst": 0.0,
                                                    "bound": bound})
        for j, tok in enumerate(out):
            row = rows[j]
            top = int(self.torch.argmax(row))
            t["steps"] += 1
            if top != tok:
                lead = float(row[top] - row[tok])
                t["flips"] += 1
                t["worst"] = max(t["worst"], lead)
                log(f"  flip {name} rid={rid} step={j}: served {tok} cpu {top}, cpu lead {lead:.4f}")
                if bound and lead > FLIP_BOUND:
                    raise AssertionError(f"{name} rid {rid} step {j}: CPU lead {lead} above {FLIP_BOUND}")

    def rows(self, model, params, prompt, out):
        """CPU logit rows of the whole-sequence forward over the prompt and
        every served token but the last, one per served token."""
        return model.logits(params, model.hidden(params, [prompt + out[:-1]]))[0, len(prompt) - 1:]

    def forced(self, model, p32, name, rid, prompt, out, bound=True):
        self.check(name, rid, self.rows(model, p32, prompt, out), out, bound)

    def report(self):
        for name, t in self.tally.items():
            held = f"bound {FLIP_BOUND}" if t["bound"] else "recorded, no bound"
            log(f"  {name}: {t['steps']} teacher-forced steps, {t['flips']} flips, largest CPU lead "
                f"{t['worst']:.4f} ({held})")


def parity_smollm(torch, par, legs, launcher, pools):
    """The whole-sequence forward for the paged serves, the dense cache for
    the launcher, the paged int8 pool for the compact-pool phase."""
    from repro_torch.models import get_model

    cfg32 = par.f32(legs[0]["cfg"])
    p32 = par.to_cpu(legs[0]["params"])
    model = get_model(cfg32)
    with torch.no_grad():
        for r, rids in zip(legs, ([0, 1, 5, 12, 23], [3, 18])):
            for rid in rids:
                par.forced(model, p32, "smollm serve_hybrid", rid, r["prompts"][rid], r["results"][rid])
        for r, rids in zip(launcher, ([0, 7, 19], [2, 30])):
            for rid in rids:
                prompt, out = r["prompts"][rid], r["results"][rid]
                par.check("smollm launcher", rid,
                          teacher_forced_rows(torch, cfg32, p32, prompt, out, "dense"), out)
        cfg8 = cfg32.replace(kv_quant=True)
        run = pools["int8_chained"]
        for i in (0, 7):
            prompt, out = run["prompts"][i], run["outs"][i]
            par.check("smollm pools int8", i,
                      teacher_forced_rows(torch, cfg8, p32, prompt, out, "paged"), out)


def parity_xlstm(torch, par, xlstm):
    """xlstm-350m against the CPU f32 whole-sequence forward (chunkwise mLSTM
    from zero state). The f32 legs on the card are held to FLIP_BOUND. The
    bf16 legs' leads are recorded: bf16 alone moves this model's logits by
    tenths (its exponential gates and head-wise norms amplify rounding, in
    the JAX package alike), which the CPU's own bf16 forward over the
    launcher's requests measures here beside them."""
    from repro_torch.models import get_model

    model = get_model(par.f32(xlstm["cfg"]))
    model16 = get_model(xlstm["cfg"])
    p32 = par.to_cpu(xlstm["params"])
    p16 = _map(xlstm["params"], lambda t: t.cpu())
    with torch.no_grad():
        for run, name in zip(xlstm["f32"]["dense"], ("chunked", "whole-prompt")):
            for i, (prompt, out) in enumerate(zip(run["prompts"], run["outs"])):
                par.forced(model, p32, f"xlstm-f32 dense {name}", i, prompt, out)
        for run, name in zip(xlstm["f32"]["paged"], ("whole-prompt", "chunked")):
            for i in (0, 3, 7):
                par.forced(model, p32, f"xlstm-f32 paged {name}", i, run["prompts"][i], run["outs"][i])
        gaps = []
        for r, rids in zip(xlstm["launcher"], ([0, 7, 19], [2, 30])):
            for rid in rids:
                prompt, out = r["prompts"][rid], r["results"][rid]
                rows = par.rows(model, p32, prompt, out)
                par.check("xlstm-bf16 launcher", rid, rows, out, bound=False)
                rows16 = par.rows(model16, p16, prompt, out).float()
                gaps.append((rows16 - rows).abs())
                par.check("cpu-bf16 launcher", rid, rows, [int(t) for t in rows16.argmax(-1)],
                          bound=False)
        for run, name in zip(xlstm["paged"], ("whole-prompt", "chunked")):
            for i in (0, 7):
                par.forced(model, p32, f"xlstm-bf16 paged {name}", i, run["prompts"][i],
                           run["outs"][i], bound=False)
    g = torch.cat([x.flatten() for x in gaps])
    log(f"  xlstm CPU bf16 vs CPU f32 logits over the launcher's requests ({len(gaps)} requests, "
        f"{g.numel()} logits): max |d| {float(g.max()):.4f}, mean |d| {float(g.mean()):.4f}")


def _map(tree, fn):
    return {k: _map(v, fn) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


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
    lib_path = _build.BUILD_DIR / _build.LIB_NAME
    for name, kernel, labels in (
            ("flash_attention", "flash_bf16_kernel", {"ILi64E": "hd<=64", "ILi128E": "hd<=128"}),
            ("mlstm_chunkwise", "mlstm_tc_kernel", {"ILi16E": "TC 16", "ILi32E": "TC 32"})):
        hmma = kernel_sass(lib_path, kernel, labels)
        log(f"  {name} bf16 kernel SASS (cuobjdump -sass): "
            + ", ".join(f"{n}: {c} HMMA/HGMMA" for n, c in sorted(hmma.items())))
        if not hmma or min(hmma.values()) == 0:
            raise AssertionError(f"the bf16 {name} kernel issues no tensor-core instruction: {hmma}")

    # 3. kernels
    log("phase 3 kernels:")
    rows = phase_kernels(torch, dev)

    # 4. serve
    log("phase 4 serve: smollm-360m FULL bf16, 24 requests through StraightLineRouter")
    chunked, c_counts = serve_leg(torch, 32, None)
    whole, w_counts = serve_leg(torch, 0, chunked["params"])
    for name in ("rmsnorm", "paged_prefill_write", "paged_attention[flat]"):
        if c_counts[name] <= 0:
            raise AssertionError(f"{name} was not launched in the chunked serve")
    if w_counts["flash_attention"] <= 0:
        raise AssertionError("flash_attention was not launched in the whole-prompt serve")
    step = phase_step(torch, chunked["cfg"], chunked["params"], dev)["decode step"]
    n_layers = chunked["cfg"].n_layers
    if step["rmsnorm"] != 2 * n_layers + 1 or step["paged_attention"] != n_layers:
        raise AssertionError(f"smollm paged decode step: {step['rmsnorm']} rmsnorm and "
                             f"{step['paged_attention']} paged decode launches, expected 65 and 32")
    prefill_ops(torch, chunked["cfg"], chunked["params"], dev)
    next(r for r in rows if r["name"] == "paged_prefill_write")["chunked_prefill_ops"] = (
        chunked_write_ops(torch, chunked["cfg"], chunked["params"], dev))

    # 5. launcher
    log("phase 5 launcher: launch/serve.main(), smollm-360m FULL bf16, 32 requests, dense engines")
    dense_step(torch, chunked["cfg"], chunked["params"], dev)
    l_chunk, lc_counts = launcher_leg(torch, 32, chunked["params"])
    l_whole, lw_counts = launcher_leg(torch, 0, chunked["params"])
    if lw_counts["flash_attention"] <= 0:
        raise AssertionError("flash_attention was not launched by the whole-prompt launcher")

    # 6. compact pools
    log("phase 6 pools: FULL bf16 paged engine, int8 pool and chained tables, prompts of 120-200 tokens")
    pools = phase_pools(torch, chunked["cfg"], chunked["params"], dev)

    # 7. xlstm
    log("phase 7 xlstm: xlstm-350m FULL bf16, the launcher's 32 requests and 8 long prompts on a paged engine")
    xlstm = phase_xlstm(torch, dev)

    # 8. parity
    log("phase 8 parity: teacher-forced CPU f32 plain paths on the same weights")
    par = Parity(torch)
    parity_smollm(torch, par, [chunked, whole], [l_chunk, l_whole], pools)
    parity_xlstm(torch, par, xlstm)
    par.report()

    # 9. summary
    runs = {"serve_chunk32": c_counts, "serve_whole_prompt": w_counts, "launcher_chunk32": lc_counts,
            "launcher_whole_prompt": lw_counts, "pools_int8_chained": pools["int8_chained"]["counts"],
            "pools_int8_flat": pools["int8_flat"]["counts"],
            "pools_bf16_chained": pools["bf16_chained"]["counts"], **xlstm["counts"]}
    main_run = {"rmsnorm": "serve_chunk32", "paged_prefill_write": "serve_chunk32",
                "paged_attention": "serve_chunk32", "flash_attention": "serve_whole_prompt",
                "decode_attention": "launcher_chunk32", "paged_prefill_write_quant": "pools_int8_flat",
                "paged_attention[int8]": "pools_int8_flat", "paged_attention[chained]": "pools_bf16_chained",
                "paged_attention[int8+chained]": "pools_int8_chained",
                "mlstm_chunkwise": "xlstm_launcher_chunk32"}
    for r in rows:
        key = "paged_attention[flat]" if r["name"] == "paged_attention" else r["name"]
        r["launches"] = runs[main_run[r["name"]]][key]
        r["main_run"] = main_run[r["name"]]
        r["launches_by_run"] = {run: c[key] for run, c in runs.items()}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    extra = ("shape", "device_ms", "device_source", "stalled_ms", "plain_device_ms",
             "library_device_ms", "main_run", "launches_by_run")
    log(f"chip_smoke wall time {time.perf_counter() - T_START:.3f} s")
    table = []
    for r in rows:
        table.append({k: r[k] for k in keys + extra})
        table[-1].update({k: r[k] for k in ("library_call", "rounding_ties", "int8_values_differing",
                                            "twin", "max_scaled_err_h_bf16", "max_rel_err_state",
                                            "by_shape", "tile_plan", "chunk",
                                            "chunked_prefill_ops") if k in r})
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
