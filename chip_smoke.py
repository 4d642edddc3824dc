#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py              # from the root of a checkout

Phases, one line (or a few) each; any failure exits non-zero before the
result line:
  1. device   — torch's device name; the card's name and power limit
  2. build    — nvcc builds every kernel of kernels/csrc/ for sm_90a; the
                bf16 flash and mLSTM kernels' SASS must hold tensor-core
                instructions (one cuobjdump -sass, run beside phase 3 and
                read after it)
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
                flash also at a 2048-token prompt beside SDPA; then the
                hd-128 models' shapes (glm4-9b's G = 16 over 2 KV heads,
                qwen1.5-32b's G = 1 over 40, granite-8b's G = 4 over 8):
                the dense decode at the launcher's cache beside SDPA, the
                paged decode's four legs at batch 8 with the pools phase's
                lengths, both page-pool writes at granite-8b's and
                qwen1.5-32b's (1, Lp, KV, 128) with offsets, flash at the
                16-token bucket over each model's heads beside SDPA,
                rmsnorm at (8, 4096) and (8, 5120) beside F.rms_norm; the
                dense decode and flash also at qwen2-vl-2b's G = 6 over 2
                KV heads (hd 128; the paged decode and the plain page-pool
                write too, flash also at S 128 and 256, rmsnorm at 8 and
                256 rows of 1536) and whisper's G = 1 over 20 (hd 64); the
                dense decode, the paged decode's four legs and flash at
                dbrx-132b's G = 6, llama4-maverick's G = 5 and
                jamba-1.5-large's G = 8 over 8 KV heads (hd 128), rmsnorm
                at (8, 6144) and (8, 8192), flash over jamba's 64 heads at
                S 16 and 256, both page-pool writes at its (1, Lp, 8, 128)
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
                and time; launch/serve.main() at FULL width in bf16 on the
                first 2 of the 32 layers (--layers): 32
                requests onto dense engines (the decode_attention kernel), 4
                router workers, prewarm, traces and metrics; chunked
                prefill, then whole-prompt prefill
  6. pools    — a FULL bf16 paged engine under an EngineLoop with an int8
                pool and chained tables, 8 prompts of 120-200 tokens; again
                with flat tables (identical streams) and with a bf16 pool on
                chained tables; bytes per cached token of each pool
  7. options  — the engines' options at FULL width in bf16 on phase 4's
                weights, each under an EngineLoop: speculative decoding (8
                motif prompts of 64 tokens, 16 new tokens, spec_tokens 4) on
                a paged engine (spec off, on, on over an int8 pool) and a
                dense one (off, on; whole-prompt, so flash runs), every
                verify pass 65 rmsnorm launches and no decode kernel; the
                prefix cache (4 conversations of 3 turns over a shared
                64-token system prefix: off, on whole-prompt, on in 32-token
                chunks), a hit's suffix written at a page offset; fork() of
                two mid-page sequences, each clone's stream equal to its
                source's; every page reclaimed after each drain
  8. xlstm    — xlstm-350m FULL in bf16 (random weights from a seeded
                generator): launch/serve.main(["--arch", "xlstm-350m"]),
                32 requests on dense engines on its first superblock (8 of
                24 layers, --layers), chunked and whole-prompt; a
                paged engine serving the pools phase's 8 prompts of 120-200
                tokens whole-prompt (chunks of L = 64 in the mLSTM kernel)
                and in 32-token chunks (the carry crosses calls), 21 mLSTM
                launches per prefill or chunk call; a batch-8 decode step's
                time and the device's busy share; then the same weights in
                f32 on a dense engine at the launcher's shapes and on the
                paged engine, both prefill modes
  9. glm4     — every earlier phase's weights moved to the host; glm4-9b
                FULL in bf16 (random weights drawn on the card from a seeded
                generator, standard-normal q/k/v biases): a batch-8 paged
                decode step (81 rmsnorm and 40 paged decode launches, its
                time and busy share), a batch-4 dense step (40
                decode_attention), launch/serve.main(["--arch", "glm4-9b"])
                with 32 requests on the first 2 layers (--layers),
                whole-prompt; the pools phase's 8 prompts
                on a paged engine in 32-token chunks on a bf16 flat pool and
                whole-prompt on an int8 chained pool, 0 failures; then 4 of
                the 40 layers at FULL width (other draws) on a dense engine
                and both paged legs, for the parity phase
 10. int8w    — weight-only int8, glm4's weights moved to the host first.
                granite-8b FULL in bf16 and with int8 weights
                (quantize_params of the same tree, its bytes against the
                reckoning; quantize_weight on the card == the CPU, and
                qeinsum one rounding from f32; the same of the batched
                product, torch.bmm, on 4 experts of jamba-1.5-large's w1
                (4, 8192, 24576)), in one run: a batch-8 paged step each (73
                rmsnorm and 36 paged decode launches, time, busy share,
                device operations, side by side), a batch-4 dense step each
                (36 decode_attention), launch/serve.main() with 32 requests
                each on the first 2 layers (--layers), whole-prompt,
                --weights-int8 on the int8 tree.
                qwen1.5-32b FULL with int8 weights drawn on the card by the
                quantized init (standard-normal q/k/v biases; its bytes and
                its peak memory against the tree): a paged step (129 + 64),
                a dense step (64), the launcher with --weights-int8 on the
                first 2 layers, the
                pools phase's 8 prompts on an int8 chained pool. Then 2 of
                the layers at FULL width (granite bf16 and int8 weights,
                qwen int8 weights) on a dense engine and an int8 chained
                pool, for the parity phase
 11. stubs    — the stub-frontend families, every earlier tree off the
                card. qwen2-vl-2b FULL in bf16 (standard-normal q/k/v
                biases): launch/serve.main() with 32 requests on the first
                7 of its 28 layers (dense, 32-token chunks), a batch-8
                paged step (57 rmsnorm and 28
                paged decode launches) and a batch-4 dense step (28
                decode_attention), each timed and profiled; the pools
                phase's 8 prompts on a paged engine, whole-prompt and in
                32-token chunks; an image prompt (B 2, S 96, an 8 x 8 image
                at 16, seeded embeddings, M-RoPE positions) through
                EmbedsLM.prefill with no flash launch, then 16 decode steps
                of 28 decode_attention, its logits apart from text-only
                positions'. whisper-large-v3 FULL in bf16 (standard-normal
                layernorm biases): seeded frames (4, 1500, 1280) and
                16-token prompts through EncDecLM.prefill (32 flash, 0
                rmsnorm), 32 decode steps of 32 decode_attention, the
                encoder's and a step's time, busy share and device
                operations, the cross-attention cache's bytes. Each tree
                then with int8 weights (quantize_params, its bytes against
                the reckoning): qwen2-vl-2b's launcher burst with
                --weights-int8 and its image prompt (no flash), whisper's
                prefill and 32 decode steps. Then 4 layers of qwen2-vl-2b
                and 4 + 4 of whisper at FULL width, in bf16 and with int8
                weights, for the parity phase
 12. moe      — the MoE family, every earlier tree off the card (the
                host's MemAvailable logged first). dbrx-132b at 4 of its
                40 layers and llama4-maverick at 2 of its 48, FULL width
                in bf16, each drawn on the card by the blocked init (its
                bytes against the reckoning, its peak below the tree + 4
                GiB) and freed before the next: a batch-8 paged step (9
                rmsnorm + 4 paged decode; 5 + 2), the share of expert
                assignments dropped in one more step, a batch-4 dense step
                (4; 2 decode_attention), launch/serve.main() with --layers
                and 32 requests (whole-prompt), the pools phase's 8
                prompts (dbrx in 32-token chunks on a bf16 flat pool,
                llama4 whole-prompt on an int8 chained pool), 0 failures.
                Each then with int8 weights drawn on the card by the
                quantized init (its bytes against the reckoning, its peak
                below the tree + 4 GiB): a batch-8 paged step, its device
                time split into the int8 -> bf16 weight copies, the
                products and the scale multiplies (each qeinsum call in a
                record_function range); llama4's peak memory during a step
                (the bf16 copy of a 128-expert leaf); dbrx's launcher burst
                with --weights-int8 --layers 4
 13. hybrid   — jamba-1.5-large-398b (Mamba + attention 7:1, MoE on every
                other layer), every earlier tree off the card (the host's
                MemAvailable logged first), at FULL width in bf16 cut to
                the first 4 layers of its superblock (Mamba, Mamba + MoE,
                Mamba, attention + MoE), drawn on the card by the blocked
                init (standard-normal conv_b, dt_bias and A_log; its bytes
                against the reckoning, its peak below the tree + 4 GiB): a
                batch-8 paged step (9 rmsnorm + 1 paged decode, time, busy
                share, device operations, the Mamba layers' share of
                them from the step's own profile), a batch-4 dense step (1
                decode_attention),
                launch/serve.main() with --layers 4 and 32 requests
                (whole-prompt), the pools phase's 8 prompts whole-prompt on
                an int8 chained pool (flash; the Mamba scan in 2 chunks at
                bucket 256) and in 32-token chunks on a bf16 flat pool (the
                Mamba carry across chunks), 0 failures. Then its whole
                first superblock (8 layers: 7 Mamba, 1 attention, 4 MoE
                FFNs) with int8 weights drawn on the card by the quantized
                init (48.7 GB; its bytes against the reckoning, its peak
                below the tree + 4 GiB): a batch-8 paged step (17 rmsnorm +
                1 paged decode) and its device split (weight copies,
                products, the 7 Mamba mixer calls), a batch-4 dense step,
                launch/serve.main() --weights-int8 --layers 8 with 32
                requests and the 8 long prompts on an int8 chained pool, 0
                failures. Then the parity legs' replays, kept on the card
                (the int8 legs' trees freed after them): a prefill of 16-token
                prompts and REPLAY_STEPS decode steps with no engine, every MoE
                call's routing recorded; jamba at its first 2 layers
                (Mamba, Mamba + MoE) with no drop possible (leg J, 4
                prompts); dbrx at 2 layers with no drop possible (leg A, 4
                prompts) and at its binding capacity (leg B, 8 prompts: C
                < T in the prefill and in every step); llama4 at 1 layer
                with no drop possible (leg C, 4 prompts); J's and A's
                prompts on quantize_params of their trees (legs J8, A8)
 14. parity   — served requests re-run teacher-forced through the port's
                plain paths on the CPU in f32 on the same weights (int8
                weight values stay int8, the products in f32): the
                whole-sequence forward (phases 4, 7, 8, 9, 10 and 11, the
                latter in bf16 and with int8 weights), the
                dense cache (phases 5 and 9) and the paged int8 pool
                (phases 6, 7, 9 and 10); every
                spec-on and warm stream of phase 7, with the first
                divergence of spec on from off and of warm from cold and
                the CPU's lead there. Every flip's
                CPU lead must stay within FLIP_BOUND, except on the bf16
                xLSTM legs, whose leads are recorded beside the CPU's own
                bf16 forward (bf16 alone moves that model's logits by more).
                Then the earlier trees are dropped from the host and the
                replayed legs run, every one of them: J, J8, C, A, B and
                A8, their f32 trees in turn in one host arena (an int8
                leg's int8 values quantized on the card and written as f32
                over its float leg's tree there), allocated once
                MemAvailable exceeds it by LEG_MARGIN (waiting up to
                HOST_WAIT_S for freed trees to come back to it), each
                replayed step by step on the CPU
                teacher-forced and its routing compared call by call: each
                decision that differs from the card's must sit at a CPU gap
                below ROUTE_GAP unless an earlier difference moved its
                inputs; rows that no difference moved are held to
                FLIP_BOUND. The 4-layer jamba stream is not held to the
                CPU (its f32 tree, 92.1 GB, exceeds the host's room); its
                attention layer's kernels are held in phase 3 at its shapes
 15. sched    — no kernel: ``placing_batch_torch`` on the card equal to the
                Python loop of ``StraightLinePolicy`` at N 1024 and at the
                paper's top ramp (N 7000, availability (0, 0), (4, 8),
                (64, 512)), its CUDA-event and device times, device
                operations and bytes bound at N 1024, 7000 and 2**20, the
                loop's host time a request; the paper's gates of
                tests/test_system.py through the port's simulator; the five
                figure twins' rows
 16. train    — training, every earlier tree off the card. (a) The three
                kernels' autograd Functions (the kernel forward, the plain
                version's backward) against the plain versions' autograd at
                training shapes, f32 and bf16: rmsnorm (8192, 960), flash
                (4, 2048, 15, 64) and a ragged S 1999, mLSTM (16, 256, 512)
                from a non-zero carry. (b) smollm-360m FULL (32 layers, bf16,
                remat full) through launch/train.main: 5 AdamW steps (f32
                states, WarmupCosine) of 4 x 2048 tokens, the loss falling
                (the later half's mean 0.5 below the first step's),
                129 rmsnorm and 64 flash launches a step (the forward's and
                the backward's recompute), a checkpoint at step 3 resumed in
                a fresh run within bf16 tolerance of the straight run; the
                step's time, tokens a second, busy share, peak memory, and
                the recompute's share of device time (remat full against
                none); 1 step each with bf16 and int8 states, their bytes
                against the reckoning. (c) xlstm-350m FULL, 2 steps of 4 x
                256 tokens, 42 mLSTM launches a step. (d) smollm at full
                width cut to 2 layers: a step's loss and every gradient leaf
                on the card in f32 (TF32 off) against the CPU in f32, and in
                bf16 (loss, cosine of every leaf) against the CPU in f32
 17. xception — no kernel: the Xception-analog classifier at the paper's
                299 px, f32, on two legs: default (width 32, 4 blocks) and
                wide (width 728, 8 blocks, Xception's middle flow). (b) The
                fig3 task for XC_STEPS SGD steps (batch 32 / 8), the later
                half's accuracy above the first half's; step time,
                images a second, peak memory against the reckoning, busy
                share. (a) The forward at batch 1 and 8: device time an
                image, device operations, busy share, channels_last against
                NCHW. (c) One step against the CPU in f32: logits and loss
                within 2e-5, each gradient leaf within 1e-4 of its largest
                (5e-4 on the wide leg, whose gradients' measured
                sensitivity to rounding-sized weight changes needs it);
                two card steps' logits, loss and every gradient but the
                conv kernels' bit-identical. 0 launches of the
                seven kernels over (a)-(c). (d) The fig3_training twin's rows,
                train_small (crash, resume) and the quickstart on the card,
                the smollm SMOKE steps at 2L + 1 rmsnorm and L flash each
 18. dryrun   — no kernel of its own: launch/dryrun.run_cell on the meta
                device for smollm-360m's four cells (long_500k a skip record),
                dbrx-132b train_4k (f32 states) and jamba-1.5-large long_500k,
                each record's bound, compute and memory ms, GB a device and
                useful ratio logged and written under chip_smoke_out/dryrun/;
                smollm-360m FULL train (4 x 2048, remat full), whole-prompt
                prefill (1 x 2048) and dense decode (batch 4 over a 2048-token
                cache) on the card under launch/cost.CostCounter: FLOPs and
                bytes equal to the meta trace of the same ShapeSpec,
                argument_bytes equal to the bytes the card holds, the
                roofline bound at most the step's device time (profiler),
                the time over the bound and the predicted peak beside
                max_memory_allocated's growth; LatencyEstimator reading the
                records back, step_time equal to each record's
 19. witness  — run right after phase 4, on its weights: the port's
                analyzers (repro_torch.analysis) on this checkout, 0
                unsuppressed findings and docs/lock_order_torch.json
                fresh; then phase 4's chunked serve again with every lock
                witnessed (the router, each backend's condition, each
                EngineLoop and engine, the tracer, the sampler, and
                kernels/_build's build and count locks), its 24 requests
                from 6 submitter threads: 0 failures, the three kernels
                of the path launched, the streams of requests served on
                the same tier as in phase 4 equal to phase 4's (others
                held to FLIP_BOUND on the CPU), observed lock orders
                consistent with the static graph and the engine's step
                lock seen taking the count lock; acquire counts, observed
                and unknown edges; the witnessed serve's time beside
                phase 4's, and a batch-8 decode step's time in
                alternating unwitnessed and witnessed legs
 20. mesh     — no kernel: the mesh path's explicit collectives on dbrx-132b's
                MoE layer at FULL width (16 experts top-4, d 6144, d_ff 10752,
                bf16, capacity factor 1.25, fsdp_experts), every earlier tree
                off the card. (a) NCCL at world size 1: moe_ffn under
                make_tier_mesh(1, 1)'s ctx equals ctx=None bit for bit on 8
                decode tokens; the compressed psum over the 1-rank axis, its
                int8 blocks equal to the CPU's (1 LSB at rounding ties).
                (b) MESH_WORLD gloo ranks spawned on the one card, a (2, 2)
                mesh over ('data', 'model'), each drawing the whole layer
                from one seed and cutting its block: the weight gather on a
                decode batch (8, 1) and a masked prefill (2, 128), the token
                gather on the decode batch, the weight gather with int8
                experts, each rank's output against the single-device layer
                on the card over its batch shard (the whole batch for the
                token gather) at bf16 2e-2, the aux at f32 2e-5, its routing
                equal to the single-device route's rows of its experts; the
                compressed all-reduce of (4, 6144 x 64) on CUDA tensors, the
                same bits on every rank and as the CPU tensors' through the
                same group, within 0.05 of the true sum. One call's host
                time and CUDA-event span per path
 21. gspmd    — the mesh path's GSPMD half on glm4-9b at FULL width (d 4096,
                32 heads over 2, d_ff 13696, vocab 151552, bf16), 2 of its
                40 layers, batch 4 x 256, every earlier tree off the card.
                (a) NCCL at world size 1: the train step under
                make_tier_mesh(1, 1)'s ctx on DTensor parameters and f32
                AdamW states equals ctx=None bit for bit (loss, gradients,
                parameters and states, rmsnorm and flash launches).
                (b) GSPMD_WORLD ranks on the one card (gloo, CUDA operands
                staged through the host: sharding/staged.py), a (2, 2) mesh
                over ('data', 'model'), param_shardings(fsdp=True): every
                leaf in its tree's placements and block shape, the loss
                within 0.05 of (a)'s and each gradient block's cosine at
                least 0.98 against it, the CE's logits blocks (2, 32,
                75776), rmsnorm and flash launched as in (a); two train
                steps, one's host time, CUDA-event span, peak memory and
                bytes staged a rank
 22. summary  — the kernels JSON line, then the result line.
Writes its longer outputs (build log, traces, metrics, and timeline.log:
every printed line behind the seconds elapsed) under chip_smoke_out/.
"""
import json
import math
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
PROFILED_STEPS = 2          # steps a serving step's profile covers (device time, busy share)
TIMED_STEPS = 3             # steps a serving step's host-clock mean covers


def log(msg: str) -> None:
    """Print ``msg``; once the output directory exists, also append it to
    chip_smoke_out/timeline.log behind the script's elapsed seconds."""
    print(msg, flush=True)
    if OUT.is_dir():
        with open(OUT / "timeline.log", "a") as f:
            f.write(f"{time.perf_counter() - T_START:9.1f}  {msg}\n")


def time_ms(fn, iters: int = 10, reps: int = 5) -> float:
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


def device_ms(fn, n: int = 20):
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


def stalled_device_ms(fn, n: int = 25, reps: int = 3) -> float:
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


def device_ops(fn, n: int = 10, tries: int = 3) -> float:
    """Device operations (kernels, copies, sets) per call, from torch.profiler.
    A window in which the profiler recorded no device event at all is no
    reading (every caller launches work on the card; CUPTI dropped one such
    window whole on the H100), so it is profiled again, up to ``tries``
    times."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ops = sum(e.count for e in device_events(prof)) / n
        if ops > 0:
            break
    return ops


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


def check_write(torch, pa_ops, write_ref, g, dev, NP, row, Lp, off, dt, KV=5, hd=64):
    """One plain write at offset ``off`` into random pools against the plain
    write through the shifted row: pages 1.. exact (page 0 absorbs pad writes
    and writes past the row's end, and is never compared), pages the chunk
    does not reach untouched, ids outside the pool dropped."""
    ps = 16

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dt)

    pool_k, pool_v = randn(NP, KV, ps, hd), randn(NP, KV, ps, hd)
    k, v = randn(1, Lp, KV, hd), randn(1, Lp, KV, hd)
    ck, cv = pool_k.clone(), pool_v.clone()
    rk, rv = pool_k.clone(), pool_v.clone()
    pa_ops.paged_prefill_write(ck, cv, k, v, row, offset=off)
    write_ref(rk, rv, k, v, pa_ops._shift_row(row, off, ps))
    torch.cuda.synchronize()
    untouched = torch.ones(NP, dtype=torch.bool, device=dev)
    ids = pa_ops.write_page_ids(row, off // ps, Lp, ps).long()
    untouched[ids[(ids >= 0) & (ids < NP)]] = False
    untouched[0] = False
    name = f"paged_prefill_write KV={KV} hd={hd} Lp={Lp} off={off}"
    if not (torch.equal(ck[1:], rk[1:]) and torch.equal(cv[1:], rv[1:])):
        raise AssertionError(f"{name}: pages differ from the plain write")
    if not (torch.equal(ck[untouched], pool_k[untouched]) and torch.equal(cv[untouched], pool_v[untouched])):
        raise AssertionError(f"{name}: touched a page outside the row")


def check_quant_write(torch, pa_ops, write_ref, g, dev, NP, row, Lp, off, dt, KV=5, hd=64):
    """One quantizing write at offset ``off`` into random int8 pools against
    the plain write through the shifted row. The int8 values may differ from
    quantize_kv only where x * 127 / amax is exactly half-way between two
    integers (found in f64, where that quotient is exact), and only by 1;
    every other byte of pages 1.. must match, and pages the chunk does not
    reach must be untouched (page 0 absorbs pad writes and writes past the
    row's end, and is never compared; ids outside the pool are dropped).
    Returns (ties in the input, int8 values differing)."""
    ps = 16
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


def sass_dump(lib_path):
    """Start ``cuobjdump -sass`` of the built library in the background, its
    output to a file, so that it runs beside phase 3; ``kernel_sass`` reads
    it."""
    import os
    import shutil

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    path = OUT / "sass.txt"
    with open(path, "w") as f:
        return subprocess.Popen([tool, "-sass", str(lib_path)], stdout=f, stderr=subprocess.STDOUT), path


def kernel_sass(dump, kernels: dict) -> dict:
    """Tensor-core (HMMA or HGMMA) instructions in each instance of each
    kernel (each function whose mangled name holds the kernel's name), from
    the ``cuobjdump -sass`` that ``sass_dump`` started. ``kernels`` maps a
    kernel to ``labels``, which maps a fragment of the mangled name (the
    template argument) to the instance's label; returns the counts by
    kernel."""
    proc, path = dump
    if proc.wait() != 0:
        raise RuntimeError(f"cuobjdump -sass exited {proc.returncode}: {path.read_text()[-2000:]}")
    out = path.read_text()
    path.unlink()
    counts = {kernel: {} for kernel in kernels}
    for section in out.split("Function : ")[1:]:
        name = section.split("\n", 1)[0].strip()
        for kernel, labels in kernels.items():
            if kernel in name:
                label = next((v for k, v in labels.items() if k in name), name)
                counts[kernel][label] = section.count("HMMA") + section.count("HGMMA")
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
        check_write(torch, pa_ops, paged_prefill_write_ref, g, dev, np_, row, Lp, off, dt)
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

    wide_shapes(torch, dev, g, rows, tab_p)

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


# (KV, G, hd) of the served models' attention; whisper-large-v3 has no paged path
WIDE = {"glm4-9b": (2, 16, 128), "qwen1.5-32b": (40, 1, 128), "granite-8b": (8, 4, 128),
        "qwen2-vl-2b": (2, 6, 128), "whisper-large-v3": (20, 1, 64), "dbrx-132b": (8, 6, 128),
        "llama4-maverick": (8, 5, 128), "jamba-1.5-large": (8, 8, 128)}
PAGED_WIDE = ("glm4-9b", "qwen1.5-32b", "granite-8b", "qwen2-vl-2b", "dbrx-132b", "llama4-maverick",
              "jamba-1.5-large")


def wide_shapes(torch, dev, g, rows, tab_p):
    """The kernels at the later served models' shapes, each checked against
    its plain version (bf16 and f32) and timed (events, profiler, stalled
    events) beside its bound, into its row's ``by_shape``: the dense decode
    at the launcher's cache (4 slots, T = 96) at glm4-9b's G = 16 (KV 2),
    qwen1.5-32b's G = 1 (KV 40), granite-8b's G = 4 (KV 8), qwen2-vl-2b's
    G = 6 (KV 2), all at hd 128, and whisper-large-v3's G = 1 (KV 20) at hd
    64, SDPA beside it; the paged decode's four legs at batch 8 with the
    pools phase's lengths at each of them but whisper's (no paged path);
    both page-pool writes at granite-8b's, qwen1.5-32b's and qwen2-vl-2b's
    (1, Lp, KV, 128), at offsets inside the row and past its end and at
    the pools phase's buckets (Lp 128 and 256), timed at the 256-token
    bucket beside ``index_put_`` (the plain write; the quantizing write not
    at qwen2-vl-2b's, served on bf16 pools only); flash at the 16-token
    bucket over each model's heads, (1, 16, 32, 128) over glm4-9b's 2 and
    granite-8b's 8 KV heads, (1, 16, 40, 128) over qwen1.5-32b's 40,
    (1, S, 12, 128) over qwen2-vl-2b's 2 at S 16, 128 and 256, (1, 16,
    20, 64) over whisper's 20, (1, 16, 48, 128) and (1, 16, 40, 128) over
    dbrx-132b's and llama4-maverick's 8, (1, 16, 64, 128) and (1, 256,
    64, 128) over jamba-1.5-large's 8, beside SDPA; rmsnorm at glm4-9b's
    and granite-8b's width (8, 4096), qwen1.5-32b's and llama4-maverick's
    (8, 5120), qwen2-vl-2b's (8 and 256 rows of 1536), dbrx-132b's (8,
    6144) and jamba-1.5-large's (8, 8192), beside F.rms_norm. The MoE
    models' decode shapes: dbrx-132b's G = 6 and llama4-maverick's G = 5,
    each over 8 KV heads, hd 128, dense and all four paged legs; and
    jamba-1.5-large's G = 8 over 8 (the 8-row head group), with both
    page-pool writes at its (1, Lp, 8, 128)."""
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

    bf16, f32 = torch.bfloat16, torch.float32
    ps, tpp = 16, 4
    row = {r["name"]: r for r in rows}

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=g, device=dev, dtype=f32).to(dtype)

    def add(name, key, d):
        row[name].setdefault("by_shape", {})[key] = d
        log_shape(name, d["shape"], d)

    for model, (KV, G, hd) in WIDE.items():
        # dense decode, the launcher's cache
        B, T, lens_l = 4, 96, [1, 9, 57, 96]
        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        for dt in (bf16, f32):
            q, cache = randn(B, 1, G * KV, hd, dtype=dt), randn(2, B, T, KV, hd, dtype=dt)
            out = da_ops.decode_attention(q, cache[0], cache[1], lens)
            again = da_ops.decode_attention(q, cache[0], cache[1], lens)
            ref = decode_attention_ref(q[:, 0].reshape(B, KV, G, hd), cache[0].transpose(1, 2),
                                       cache[1].transpose(1, 2), lens)
            torch.cuda.synchronize()
            if not (bool(torch.isfinite(out).all()) and torch.equal(out, again)):
                raise AssertionError(f"decode_attention {model}: non-finite, or two calls differ")
            e = err(out.reshape(B, KV, G, hd), ref)
            check_tol(f"decode_attention {model} G={G} KV={KV} hd={hd} B={B} T={T} {dt}", e, dt)
            row["decode_attention"]["max_abs_err"] = max(row["decode_attention"]["max_abs_err"], e)
        q, cache = randn(B, 1, G * KV, hd), randn(2, B, T, KV, hd)
        qg, k_t, v_t = q[:, 0].reshape(B, KV, G, hd), cache[0].transpose(1, 2), cache[1].transpose(1, 2)
        mask = torch.arange(T, device=dev)[None, None, None, :] < lens[:, None, None, None]
        nbytes = 2 * 2 * sum(lens_l) * KV * hd + 2 * 2 * B * KV * G * hd + 4 * B
        b_ms, b_by = bound(nbytes, 4 * KV * G * hd * sum(lens_l), F32_FLOPS_S)
        add("decode_attention", model, time_shape(
            lambda: da_ops.decode_attention(q, cache[0], cache[1], lens),
            lambda: decode_attention_ref(qg, k_t, v_t, lens),
            lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k_t, v_t, attn_mask=mask,
                                                   enable_gqa=True),
            b_ms, b_by, shape=f"q ({B}, 1, {G * KV}, {hd}) bf16, cache ({B}, {T}, {KV}, {hd}), "
            f"lengths {lens_l}", bytes=nbytes, splits=da_ops.plan_splits(B, KV, T, G),
            head_groups=da_ops.head_groups(G)))
        if model not in PAGED_WIDE:
            continue

        # paged decode, the pools phase's batch: every leg
        B, NPp, lens_l = 8, 129, [120, 128, 129, 144, 161, 176, 193, 208]
        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        l1, l2 = chain(torch, tab_p, tpp)
        tab, l1, l2 = tab_p.to(dev), l1.to(dev), l2.to(dev)
        for dt in (f32, bf16):              # the bf16 pools are then timed below
            q = randn(B, 1, G * KV, hd, dtype=dt)
            qg = q[:, 0].reshape(B, KV, G, hd)
            pools = {False: ((randn(NPp, KV, ps, hd, dtype=dt), randn(NPp, KV, ps, hd, dtype=dt)), {}),
                     True: int8_pools(torch, g, dev, NPp, KV, ps, hd)}
            pools[True] = (pools[True][:2], {"pool_ks": pools[True][2], "pool_vs": pools[True][3]})
            for quant in (False, True):
                kv, kw = pools[quant]
                flat = pa_ops.paged_attention(q, *kv, tab, lens, **kw)
                chained = pa_ops.paged_attention(q, *kv, l1, lens, l2_tab=l2, **kw)
                ref = paged_attention_ref(qg, *kv, tab, lens, **kw)
                torch.cuda.synchronize()
                if not (bool(torch.isfinite(flat).all()) and torch.equal(flat, chained)):
                    raise AssertionError(f"paged_attention {model} int8={quant}: non-finite, or "
                                         f"chained differs from flat")
                e = err(flat.reshape(B, KV, G, hd), ref)
                for leg in (("int8", "int8+chained") if quant else ("flat", "chained")):
                    name = "paged_attention" if leg == "flat" else f"paged_attention[{leg}]"
                    row[name]["max_abs_err"] = max(row[name]["max_abs_err"], e)
                check_tol(f"paged_attention[{'int8' if quant else 'flat'}, chained bit-identical] "
                          f"{model} G={G} KV={KV} hd={hd} lens={lens_l} {dt}", e, dt)
        for leg, quant, chained in [("flat", False, False), ("int8", True, False), ("chained", False, True),
                                    ("int8+chained", True, True)]:
            kv, kw = pools[quant]
            kw = dict(kw, **({"l2_tab": l2} if chained else {}))
            q = randn(B, 1, G * KV, hd)
            qg = q[:, 0].reshape(B, KV, G, hd)
            t_ = l1 if chained else tab
            nbytes = paged_decode_bytes(lens_l, B, KV, G, hd, ps, quant, tpp if chained else 0)
            b_ms, b_by = bound(nbytes, 4 * KV * G * hd * sum(lens_l), F32_FLOPS_S)
            name = "paged_attention" if leg == "flat" else f"paged_attention[{leg}]"
            add(name, model, time_shape(
                lambda a=(q, *kv, t_, lens), kw=kw: pa_ops.paged_attention(*a, **kw),
                lambda a=(qg, *kv, t_, lens), kw=kw: paged_attention_ref(*a, **kw), None, b_ms, b_by,
                shape=f"q ({B}, {KV}, {G}, {hd}) bf16, {'int8' if quant else 'bf16'} pool ({NPp}, {KV}, "
                f"{ps}, {hd}), {f'chained (tpp {tpp})' if chained else 'flat'} tables, lengths {lens_l}",
                bytes=nbytes, splits=pa_ops.plan_page_splits(B, KV, 16, ps, G),
                head_groups=da_ops.head_groups(G)))

    # both page-pool writes at granite-8b's 8, qwen1.5-32b's 40,
    # qwen2-vl-2b's 2 and jamba-1.5-large's 8 KV heads: the small pool at
    # offsets inside its 6-page row and past its end, the pools phase's
    # 129-page pool through a 16-entry row at its whole-prompt buckets (Lp
    # 128 and 256)
    NP, NPp = 25, 129
    row_small = torch.tensor([9, 3, 17, 4, 22, 0], dtype=torch.int32, device=dev)
    row_p = tab_p[7].to(dev)                                # 193 tokens: the 256-token bucket
    for model in ("granite-8b", "qwen1.5-32b", "qwen2-vl-2b", "jamba-1.5-large"):
        KV, _, hd = WIDE[model]
        cases = [(NP, row_small, 32, 0, bf16), (NP, row_small, 32, 32, bf16), (NP, row_small, 16, 96, bf16),
                 (NP, row_small, 64, 32, f32), (NPp, row_p, 128, 0, bf16), (NPp, row_p, 256, 0, bf16),
                 (NPp, row_p, 256, 0, f32), (NPp, row_p, 224, 32, bf16)]
        ties_total = diffs_total = 0
        for (np_, r, Lp, off, dt) in cases:
            check_write(torch, pa_ops, paged_prefill_write_ref, g, dev, np_, r, Lp, off, dt, KV, hd)
            ties, diffs = check_quant_write(torch, pa_ops, paged_prefill_write_quant_ref, g, dev,
                                            np_, r, Lp, off, dt, KV, hd)
            ties_total += ties
            diffs_total += diffs
        log(f"  paged_prefill_write and paged_prefill_write_quant {model} (1, Lp, {KV}, {hd}) at "
            f"(pool, Lp, offset, dtype) {[(c[0], c[2], c[3], str(c[4])) for c in cases]}: plain write "
            f"exact; quantized scales exact, int8 values differing {diffs_total}, all at rounding ties "
            f"(ties in the input {ties_total}); untouched pages preserved")
        row["paged_prefill_write_quant"]["int8_values_differing"] += diffs_total
        row["paged_prefill_write_quant"]["rounding_ties"] += ties_total

        Lp = 256
        pool_k, pool_v = randn(NPp, KV, ps, hd), randn(NPp, KV, ps, hd)
        k, v = randn(1, Lp, KV, hd), randn(1, Lp, KV, hd)
        t = torch.arange(Lp, device=dev)
        at = (row_p.long()[t // ps][:, None], torch.arange(KV, device=dev)[None, :], (t % ps)[:, None])

        def index_put(pool_k=pool_k, pool_v=pool_v, k=k, v=v, at=at):
            pool_k.index_put_(at, k[0])
            pool_v.index_put_(at, v[0])

        nbytes = 2 * 2 * 2 * Lp * KV * hd + 4 * -(-Lp // ps)
        b_ms, b_by = bound(nbytes, 0, F32_FLOPS_S)
        a = (pool_k, pool_v, k, v, row_p)
        add("paged_prefill_write", model, time_shape(
            lambda a=a: pa_ops.paged_prefill_write(*a), lambda a=a: paged_prefill_write_ref(*a), index_put,
            b_ms, b_by, shape=f"k/v (1, {Lp}, {KV}, {hd}) bf16 into ({NPp}, {KV}, {ps}, {hd})", bytes=nbytes))
        if model == "qwen2-vl-2b":                          # served on bf16 pools only
            continue
        qpools = [torch.zeros(NPp, KV, ps, hd, dtype=torch.int8, device=dev) for _ in range(2)]
        qscales = [torch.zeros(NPp, KV, ps, 1, dtype=bf16, device=dev) for _ in range(2)]
        nbytes = 2 * (2 * Lp * KV * hd + Lp * KV * (hd + 2)) + 4 * -(-Lp // ps)
        b_ms, b_by = bound(nbytes, 0, F32_FLOPS_S)
        a = (*qpools, *qscales, k, v, row_p)
        add("paged_prefill_write_quant", model, time_shape(
            lambda a=a: pa_ops.paged_prefill_write_quant(*a), lambda a=a: paged_prefill_write_quant_ref(*a),
            None, b_ms, b_by, shape=f"k/v (1, {Lp}, {KV}, {hd}) bf16 into int8 ({NPp}, {KV}, {ps}, {hd}) "
            f"+ bf16 scales", bytes=nbytes))

    # flash at the 16-token bucket over each model's heads and hd, and at
    # qwen2-vl-2b's whole-prompt buckets of the pools phase (S 128 and 256)
    for model, H, S in (("glm4-9b", 32, 16), ("granite-8b", 32, 16), ("qwen1.5-32b", 40, 16),
                        ("qwen2-vl-2b", 12, 16), ("qwen2-vl-2b", 12, 128), ("qwen2-vl-2b", 12, 256),
                        ("whisper-large-v3", 20, 16), ("dbrx-132b", 48, 16), ("llama4-maverick", 40, 16),
                        ("jamba-1.5-large", 64, 16), ("jamba-1.5-large", 64, 256)):
        KV, _, hd = WIDE[model]
        for dt in (bf16, f32):
            q, k, v = randn(1, S, H, hd, dtype=dt), randn(1, S, KV, hd, dtype=dt), randn(1, S, KV, hd, dtype=dt)
            want = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)
            e = err(fa_ops.flash_attention(q, k, v), want)
            torch.cuda.synchronize()
            check_tol(f"flash_attention {model} (1, {S}, {H}, {hd}) over {KV} KV heads {dt}", e, dt)
            row["flash_attention"]["max_abs_err"] = max(row["flash_attention"]["max_abs_err"], e)
        q, k, v = randn(1, S, H, hd), randn(1, S, KV, hd), randn(1, S, KV, hd)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        nbytes, ops = 2 * (2 * H + 2 * KV) * S * hd, 4 * H * hd * S * (S + 1) // 2
        b_ms, b_by = bound(nbytes, ops, BF16_FLOPS_S)
        add("flash_attention", model if S == 16 else f"{model} S={S}", time_shape(
            lambda a=(q, k, v): fa_ops.flash_attention(*a), lambda a=(qt, kt, vt): attention_ref(*a),
            lambda a=(qt, kt, vt): F.scaled_dot_product_attention(*a, is_causal=True, enable_gqa=True),
            b_ms, b_by, shape=f"q (1, {S}, {H}, {hd}) bf16, k/v (1, {S}, {KV}, {hd})", bytes=nbytes,
            ops=ops))

    # rmsnorm at glm4-9b's and granite-8b's width and at qwen1.5-32b's (the
    # block-per-row path), at qwen2-vl-2b's (one warp a row in bf16): a
    # decode step's 8 rows, and a 256-token prompt's rows
    for model, R, D in (("glm4-9b", 8, 4096), ("qwen1.5-32b", 8, 5120), ("qwen2-vl-2b", 8, 1536),
                        ("qwen2-vl-2b", 256, 1536), ("dbrx-132b", 8, 6144), ("jamba-1.5-large", 8, 8192)):
        for dt in (bf16, f32):
            x, w = randn(R, D, dtype=dt), torch.linspace(0.5, 1.5, D, device=dev).to(dt)
            e = err(rms_ops.rmsnorm(x, w), rmsnorm_ref(x, w))
            torch.cuda.synchronize()
            vec = 16 // x.element_size()
            path = "one-warp" if D % vec == 0 and D // vec <= 256 else "block"
            check_tol(f"rmsnorm {model} R={R} D={D} {dt} ({path} path)", e, dt)
            row["rmsnorm"]["max_abs_err"] = max(row["rmsnorm"]["max_abs_err"], e)
        x, w = randn(R, D), torch.linspace(0.5, 1.5, D, device=dev).to(bf16)
        b_ms, b_by = bound(2 * (2 * R * D + D), 4 * R * D, F32_FLOPS_S)
        add("rmsnorm", model if R == 8 else f"{model} R={R}", time_shape(
            lambda x=x, w=w: rms_ops.rmsnorm(x, w), lambda x=x, w=w: rmsnorm_ref(x, w),
            lambda x=x, w=w, D=D: F.rms_norm(x, (D,), w, 1e-6), b_ms, b_by, shape=f"x ({R}, {D}) bf16"))


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


def phase_step(torch, cfg, params, dev, after=None):
    """Launches per prefill and per decode step, a batch-8 decode step's
    time on the host clock (synchronized), and the device's busy share over
    those steps from torch.profiler. ``after(engine)``, when given, runs on
    the engine after the profiled steps; its result lands under "after"."""
    from repro_torch.launch.serve_hybrid import MAXLEN, PROMPT, PS, prompt_for
    from repro_torch.serving.engine import PagedEngineConfig, PagedInferenceEngine

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def snap():
        return read_counts()

    def delta(a, b, k=1):
        return {n: (b[n] - a[n]) / k for n in a}

    B, STEPS = 8, TIMED_STEPS
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
        timing = profiled_steps(torch, eng.step)
        extra = after(eng) if after is not None else None
    for k, v in per.items():
        log(f"  launches per {k}: { {n: c for n, c in v.items() if c} }")
    log(f"  decode step, batch {B}, {cfg.name} {cfg.n_layers}L d_model {cfg.d_model} "
        f"{str(cfg.compute_dtype).replace('torch.', '')}: {step_ms:.3f} ms (host clock, "
        f"synchronized, mean of {STEPS}); {timing['text']}")
    n = timing["n"]
    for e in timing.pop("top")[:10]:
        log(f"    device {e.self_device_time_total / n:10.1f} us/step  x{e.count / n:g}/step  {e.key[:90]}")
    per["timing"] = dict(timing, step_ms=step_ms)
    if after is not None:
        per["after"] = extra
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

    prefill_device_ops(torch, cfg, params, dev, 32)     # warm-up
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


def dense_step(torch, cfg, params, dev, chunk_tokens: int = 0):
    """The launcher's dense engine shape (4 slots, max_len 96; prefill
    whole-prompt, or in chunks of ``chunk_tokens``): launches per decode
    step, one decode_attention per attention layer, and a batch-4 decode
    step's time on the host clock (synchronized, mean of TIMED_STEPS)."""
    from repro_torch.launch.serve_hybrid import prompt_for
    from repro_torch.serving.engine import EngineConfig, InferenceEngine

    B, STEPS = 4, TIMED_STEPS
    eng = InferenceEngine(cfg, EngineConfig(max_slots=B, max_len=96, max_new_tokens=64,
                                            chunk_tokens=chunk_tokens), params=params, device=dev)
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
    timing = profiled_steps(torch, eng.step)
    timing.pop("top")
    log(f"  dense decode step, batch {B}, {cfg.name} {cfg.n_layers}L: {step_ms:.3f} ms (host clock, "
        f"synchronized, mean of {STEPS}); {timing['text']}; launches per step "
        f"{ {n: c for n, c in per.items() if c} }")
    if per["decode_attention"] != attn_layers(cfg):
        raise AssertionError(f"dense decode step: {per['decode_attention']} decode_attention launches, "
                             f"expected {attn_layers(cfg)}")
    return step_ms, per, dict(timing, step_ms=step_ms)


def profiled_steps(torch, step, n: int = PROFILED_STEPS) -> dict:
    """``n`` calls of ``step`` under torch.profiler: device time and device
    operations a call, the device's busy share of the synchronized wall
    time, and the device events by time (``top``)."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = sorted(device_events(prof), key=lambda e: -e.self_device_time_total)
    dev_us, ops = sum(e.self_device_time_total for e in events), sum(e.count for e in events) / n
    text = (f"device {dev_us / n:.1f} us, busy share {dev_us / wall_us:.4f} ({dev_us:.1f} us of {wall_us:.1f} "
            f"us over {n}), {ops:g} device operations a call" if dev_us > 0
            else "device time not measured (the profiler saw no device time)")
    return {"device_us": dev_us / n, "busy": dev_us / wall_us, "ops": ops, "text": text, "top": events,
            "n": n}


def launcher_leg(torch, chunk_tokens: int, params, arch: str = "smollm-360m",
                 need=("decode_attention",), extra=()):
    """launch/serve.main() at FULL width in bf16 on dense engines (``extra``:
    more flags, e.g. --weights-int8); every kernel in ``need`` must have
    been launched."""
    from repro_torch.launch import serve

    out = OUT / f"launcher_{arch}_chunk{chunk_tokens}{''.join(extra).replace('-', '_')}"
    out.mkdir(parents=True, exist_ok=True)
    argv = ["--arch", arch, "--workers", "4", "--prewarm", "--chunk-tokens", str(chunk_tokens),
            "--trace-out", str(out / "trace.json"), "--metrics-interval", "0.05",
            "--metrics-out", str(out / "metrics.prom"), *extra]
    reset_counts()
    t0 = time.perf_counter()
    r = serve.main(argv, params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    m = r["metrics"].summary()
    log(f"  launcher {arch} {' '.join(extra)} chunk_tokens={chunk_tokens}: {m['total']} requests, {m['failed']} failed, "
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


def pools_run(torch, cfg, params, dev, cache_dtype: str, chained: bool, chunk_tokens: int = 0):
    """A FULL paged engine under an EngineLoop serving 8 prompts of 120-200
    tokens, 16-token pages, 4 pages per second-level table row; whole-prompt
    prefill, or chunks of ``chunk_tokens``."""
    import numpy as np

    from repro_torch.serving.engine import PagedEngineConfig, PagedInferenceEngine
    from repro_torch.serving.scheduler import EngineLoop

    prompts = [[int(t) for t in np.random.default_rng(1000 + i).integers(1, cfg.vocab_size, n)]
               for i, n in enumerate(POOL_PROMPTS)]
    eng = PagedInferenceEngine(cfg, PagedEngineConfig(
        page_size=16, num_pages=129, max_slots=8, max_seq_len=256, max_new_tokens=8,
        cache_dtype=cache_dtype, chained_tables=chained, table_page_entries=4,
        chunk_tokens=chunk_tokens), params=params, device=dev)
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
    log(f"  pools {cfg.name} {cfg.n_layers}L {cache_dtype} {'chained' if chained else 'flat'} "
        f"chunk_tokens={chunk_tokens}: "
        f"{len(outs)} requests in {wall:.3f} s, kv_bytes_per_token {snap['kv_bytes_per_token']}, "
        f"{eng.preemptions} preemptions; launches {counts}")
    return {"prompts": prompts, "outs": outs, "counts": counts, "snap": snap, "wall_s": wall,
            "preemptions": eng.preemptions}


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


OPT_MOTIF, OPT_PROMPT, OPT_NEW = 16, 64, 16     # the options phase's spec traffic


def motif_prompts(vocab: int) -> list:
    """8 prompts of 64 tokens, each a seeded 16-token motif repeated four
    times (the n-gram proposer matches inside them)."""
    import numpy as np

    return [[int(t) for t in np.random.default_rng(2000 + i).integers(1, vocab, OPT_MOTIF)]
            * (OPT_PROMPT // OPT_MOTIF) for i in range(8)]


class CallCounts:
    """Launches of every kernel during each call of an engine method (a
    verify pass, a prefill chunk), read from the wrappers' counters around
    the call, and the call's host time: (positional arguments, launches,
    seconds) per call."""

    def __init__(self, eng, method: str):
        self.calls = []
        fn = getattr(eng, method)

        def counted(*args):
            before = read_counts()
            t0 = time.perf_counter()
            out = fn(*args)
            dt = time.perf_counter() - t0
            after = read_counts()
            self.calls.append((args, {n: after[n] - before[n] for n in after}, dt))
            return out

        setattr(eng, method, counted)


def options_loop(torch, eng, name: str, next_turn):
    """Serve turns of prompts through an EngineLoop on ``eng``: each turn's
    prompts are submitted together and awaited; ``next_turn(turns)`` gives
    the next turn's prompts from the turns so far (None: done). Returns
    (turns of (prompts, sequences), steps, wall s, launches)."""
    from repro_torch.serving.scheduler import EngineLoop

    reset_counts()
    turns = []
    t0 = time.perf_counter()
    with EngineLoop(eng, name=name) as loop:
        while (prompts := next_turn(turns)) is not None:
            sids = [loop.submit(p) for p in prompts]
            turns.append((prompts, [loop.wait(sid, 600) for sid in sids]))
        steps = loop.steps
    torch.cuda.synchronize()
    return turns, steps, time.perf_counter() - t0, read_counts()


def check_drained(eng, name: str) -> None:
    """Every page back in the pool once the prefix cache (if any) is
    dropped, and the allocator's and the tree's invariants hold."""
    if getattr(eng, "prefix_cache", None) is not None:
        eng.prefix_cache.check_invariants()
        eng.prefix_cache.drop()
    eng.allocator.check_invariants()
    if eng.allocator.used_pages != 0:
        raise AssertionError(f"{name}: {eng.allocator.used_pages} pages still used after the drain")


def spec_run(torch, cfg, params, dev, kind: str, spec: int, cache_dtype: str = ""):
    """The 8 motif prompts through an EngineLoop on a paged engine (16-token
    pages, 32-token chunks) or a dense one (whole-prompt admissions): OPT_NEW
    new tokens each, spec_tokens ``spec`` with a 3-gram proposer. Every verify
    pass is counted: 65 rmsnorm launches and no decode kernel."""
    import numpy as np

    from repro_torch.serving.engine import (
        EngineConfig,
        InferenceEngine,
        PagedEngineConfig,
        PagedInferenceEngine,
    )

    prompts = motif_prompts(cfg.vocab_size)
    common = dict(max_new_tokens=OPT_NEW, spec_tokens=spec, spec_ngram=3)
    if kind == "paged":
        eng = PagedInferenceEngine(cfg, PagedEngineConfig(
            page_size=16, num_pages=257, max_slots=8, max_seq_len=256, chunk_tokens=32,
            cache_dtype=cache_dtype, **common), params=params, device=dev)
    else:
        eng = InferenceEngine(cfg, EngineConfig(max_slots=4, max_len=256, chunk_tokens=0, **common),
                              params=params, device=dev)
    eng.prewarm()
    passes = CallCounts(eng, "_verify")
    name = f"{kind}-spec{spec}{'-' + cache_dtype if cache_dtype else ''}"
    turns, steps, wall, counts = options_loop(torch, eng, name,
                                              lambda turns: None if turns else prompts)
    outs = [s.out for s in turns[0][1]]
    if len(outs) != 8 or any(len(o) != OPT_NEW for o in outs):
        raise AssertionError(f"options {name}: {[len(o) for o in outs]} tokens served, expected 8 x {OPT_NEW}")
    want = 2 * cfg.n_layers + 1
    for _, c, _ in passes.calls:
        if (c["rmsnorm"], c["paged_attention"], c["decode_attention"]) != (want, 0, 0):
            raise AssertionError(f"options {name}: a verify pass launched {c}, expected {want} "
                                 "rmsnorm and no decode kernel")
    if spec and not passes.calls:
        raise AssertionError(f"options {name}: no verify pass ran")
    if kind == "paged":
        check_drained(eng, name)
    elif min(counts["flash_attention"], counts["decode_attention"]) <= 0:
        raise AssertionError(f"options {name}: flash and decode_attention must both launch: {counts}")
    r = {"name": name, "prompts": prompts, "outs": outs, "steps": steps, "wall_s": wall,
         "counts": counts, "verify_passes": len(passes.calls), "proposed": eng.spec_proposed,
         "accepted": eng.spec_accepted, "tokens_per_step": eng.tokens_emitted / max(1, steps)}
    cost = ""
    if spec:
        # one more pass of the same work (the gather covers the whole row or
        # stripe) on the drained engine: a null row, or free slot 0's stripe
        toks = np.zeros(spec + 1, np.int64)
        if kind == "paged":
            null_row = np.zeros(eng._row_width, np.int32)
            one = lambda: eng._verify(toks, null_row, OPT_PROMPT)  # noqa: E731
        else:
            one = lambda: eng._verify(0, toks, OPT_PROMPT)  # noqa: E731
        served = statistics.median(dt for _, _, dt in passes.calls) * 1e3
        prof = profiled_steps(torch, one, n=2)
        ops, dms = prof["ops"], (prof["device_us"] / 1e3 if prof["device_us"] > 0 else None)
        cost = (f"; a verify pass {served:.3f} ms on the host clock (median of the served ones, "
                f"synchronized), {ops:g} device operations, device time "
                f"{'not measured' if dms is None else f'{dms:.4f} ms'}")
        r.update(pass_host_ms=served, pass_ops=ops, pass_device_ms=dms)
    log(f"  {name}: 8 requests, 0 failed, {wall:.3f} s, {steps} steps, "
        f"{r['tokens_per_step']:.4f} tokens per step, {r['verify_passes']} verify passes "
        f"({want} rmsnorm, 0 decode launches each), accepted / proposed {eng.spec_accepted} / "
        f"{eng.spec_proposed}{cost}; launches {counts}")
    return r


def prefix_run(torch, cfg, params, dev, cache_on: bool, chunk: int):
    """4 conversations of 3 turns: a shared 64-token system prefix and 32
    tokens of each conversation's own, then each turn the previous prompt,
    its 16-token answer and 16 new tokens; all four conversations' turns
    submitted together to a paged engine (16-token pages)."""
    import numpy as np

    from repro_torch.serving.engine import PagedEngineConfig, PagedInferenceEngine

    def ids(seed, n):
        return [int(t) for t in np.random.default_rng(seed).integers(1, cfg.vocab_size, n)]

    system = ids(3000, 64)

    def next_turn(turns):
        if not turns:
            return [system + ids(3100 + c, 32) for c in range(4)]
        if len(turns) == 3:
            return None
        prompts, seqs = turns[-1]
        return [p + s.out + ids(3200 + 10 * c + len(turns), 16)
                for c, (p, s) in enumerate(zip(prompts, seqs))]

    eng = PagedInferenceEngine(cfg, PagedEngineConfig(
        page_size=16, num_pages=257, max_slots=4, max_seq_len=256, max_new_tokens=16,
        chunk_tokens=chunk, prefix_cache=cache_on), params=params, device=dev)
    eng.prewarm()
    chunks = CallCounts(eng, "_run_chunk_device")
    name = f"prefix-{'on' if cache_on else 'off'}-chunk{chunk}"
    turns, steps, wall, counts = options_loop(torch, eng, name, next_turn)
    n_write = sum(1 for kind in cfg.block_pattern if kind == "attn") * cfg.n_superblocks
    offset_writes = [args[2] for args, c, _ in chunks.calls
                     if args[2] > 0 and c["paged_prefill_write"] == n_write]
    snap = eng.capacity_now()
    ttft = [[s.token_times[0] - s.submit_t for s in seqs] for _, seqs in turns]
    cached = [[s.cached_tokens for s in seqs] for _, seqs in turns]
    if any(len(s.out) != 16 for _, seqs in turns for s in seqs):
        raise AssertionError(f"options {name}: a request came back short")
    if cache_on and snap["prefix_cached_tokens"] <= 0:
        raise AssertionError(f"options {name}: no prefix-cache hit")
    check_drained(eng, name)
    r = {"name": name, "turns": [(p, [s.out for s in seqs]) for p, seqs in turns], "ttft": ttft,
         "cached": cached, "wall_s": wall, "counts": counts, "offset_writes": offset_writes,
         "snap": snap, "steps": steps}
    log(f"  {name}: 12 requests, 0 failed, {wall:.3f} s, {steps} steps, cached tokens per turn "
        f"{cached}, prefix_cached_tokens {snap.get('prefix_cached_tokens', 0)}, chunk calls at a "
        f"non-zero offset writing every layer {len(offset_writes)} (offsets {sorted(set(offset_writes))}), "
        f"median TTFT turn 1 {statistics.median(ttft[0]):.4f} s, turns 2-3 "
        f"{statistics.median(ttft[1] + ttft[2]):.4f} s; launches {counts}")
    return r


def fork_run(torch, cfg, params, dev):
    """4 prompts on a paged engine (16-token pages, whole-prompt), stepped
    until every sequence sits mid-page; two of them forked, then drained:
    each clone's stream equals its source's."""
    from repro_torch.serving.engine import PagedEngineConfig, PagedInferenceEngine

    eng = PagedInferenceEngine(cfg, PagedEngineConfig(
        page_size=16, num_pages=257, max_slots=8, max_seq_len=256, max_new_tokens=32,
        chunk_tokens=0), params=params, device=dev)
    prompts = [p[:n] for p, n in zip(motif_prompts(cfg.vocab_size), (40, 45, 50, 57))]
    reset_counts()
    t0 = time.perf_counter()
    sids = [eng.submit(p) for p in prompts]
    for _ in range(40):
        eng.step()
        live = [i for i, s in enumerate(eng.slot_seq) if s is not None]
        if len(live) == 4 and all(eng.slot_len[i] % 16 for i in live):
            break
    else:
        raise AssertionError("fork: the sequences never sat mid-page together")
    clones = {sid: eng.fork(sid) for sid in sids[:2]}
    if None in clones.values():
        raise AssertionError(f"fork returned None: {clones}")
    done = {}
    for _ in range(200):
        done.update({s.sid: s.out for s in eng.step()})
        if len(done) == 6:
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    if len(done) != 6:
        raise AssertionError(f"fork: {len(done)} of 6 sequences finished")
    for sid, csid in clones.items():
        if done[csid] != done[sid]:
            raise AssertionError(f"fork: clone {csid} {done[csid]} != source {sid} {done[sid]}")
    check_drained(eng, "fork")
    log(f"  fork: 4 sequences mid-page, 2 forked, 6 drained in {wall:.3f} s; each clone's 32 tokens "
        f"equal its source's; pages reclaimed; launches {counts}")
    return {"counts": counts, "wall_s": wall}


def phase_options(torch, cfg, params, dev):
    """Speculative decoding (paged bf16 and int8 pools, dense), the prefix
    cache (off, on whole-prompt, on chunked) and fork() at FULL width."""
    spec = {"paged_off": spec_run(torch, cfg, params, dev, "paged", 0),
            "paged_on": spec_run(torch, cfg, params, dev, "paged", 4),
            "paged_int8": spec_run(torch, cfg, params, dev, "paged", 4, "int8"),
            "dense_off": spec_run(torch, cfg, params, dev, "dense", 0),
            "dense_on": spec_run(torch, cfg, params, dev, "dense", 4)}
    prefix = {"off": prefix_run(torch, cfg, params, dev, False, 0),
              "on_chunk0": prefix_run(torch, cfg, params, dev, True, 0),
              "on_chunk32": prefix_run(torch, cfg, params, dev, True, 32)}
    if not prefix["on_chunk0"]["offset_writes"]:
        raise AssertionError("no prefix hit wrote its suffix through paged_prefill_write at an offset")
    if spec["paged_int8"]["counts"]["paged_prefill_write_quant"] <= 0:
        raise AssertionError("the int8 spec leg launched no quantizing write")
    for a, b in (("paged_off", "paged_on"), ("dense_off", "dense_on")):
        same = sum(x == y for x, y in zip(spec[a]["outs"], spec[b]["outs"]))
        log(f"  {b} vs {a}: {same} of 8 streams identical; tokens per step "
            f"{spec[b]['tokens_per_step']:.4f} against {spec[a]['tokens_per_step']:.4f}, wall "
            f"{spec[b]['wall_s']:.3f} s against {spec[a]['wall_s']:.3f} s")
    cold, warm = prefix["off"]["ttft"], prefix["on_chunk0"]["ttft"]
    log(f"  median TTFT of turns 2-3: cache off {statistics.median(cold[1] + cold[2]):.4f} s, "
        f"on (whole-prompt) {statistics.median(warm[1] + warm[2]):.4f} s, on (chunk 32) "
        f"{statistics.median(prefix['on_chunk32']['ttft'][1] + prefix['on_chunk32']['ttft'][2]):.4f} s")
    return {"cfg": cfg, "params": params, "spec": spec, "prefix": prefix,
            "fork": fork_run(torch, cfg, params, dev)}


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


def dense_run(torch, cfg, params, dev, chunk_tokens: int, need=("mlstm_chunkwise",)):
    """A dense engine at the launcher's shapes (4 slots, max_len 96, the
    launcher's 8-token prompts of requests 0-7), generate(); every kernel in
    ``need`` must have been launched."""
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
    log(f"  {cfg.name} {cfg.n_layers}L dense {str(cfg.compute_dtype).replace('torch.', '')} "
        f"chunk_tokens={chunk_tokens}: "
        f"{len(outs)} requests in {time.perf_counter() - t0:.3f} s; launches "
        f"{ {n: c for n, c in counts.items() if c} }")
    if any(len(o) != 8 for o in outs) or any(counts[n] <= 0 for n in need):
        raise AssertionError(f"{cfg.name} dense chunk {chunk_tokens}: {outs}, {counts}")
    return {"prompts": prompts, "outs": outs, "counts": counts}


def phase_xlstm(torch, dev):
    """xlstm-350m FULL in bf16: the launcher's 32 requests on its first
    superblock (chunked and whole-prompt), the long prompts on a paged
    engine (whole-prompt and
    chunked), launches per prefill and a decode step's time."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import get_model

    cfg = get_config("xlstm-350m")
    params = get_model(cfg).init(torch.Generator(dev).manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params))
    n_mlstm = sum(1 for kind in cfg.block_pattern if kind == "mlstm") * cfg.n_superblocks
    log(f"  xlstm-350m FULL: {cfg.n_layers} layers ({n_mlstm} mLSTM), d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads, {n_params} parameters in bf16")
    need, depth = ("mlstm_chunkwise", "rmsnorm"), ("--layers", str(LAUNCHER_LAYERS["xlstm-350m"]))
    l_chunk, lc_counts = launcher_leg(torch, 32, params, "xlstm-350m", need, depth)
    l_whole, lw_counts = launcher_leg(torch, 0, params, "xlstm-350m", need, depth)
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
    f32 = {"dense": [dense_run(torch, cfg32, params32, dev, c) for c in (32, 0)],
           "paged": [xlstm_paged_run(torch, cfg32, params32, dev, c) for c in (0, 32)]}
    return {"cfg": cfg, "params": params, "launcher": [l_chunk, l_whole],
            "paged": [p_whole, p_chunk], "f32": f32,
            "counts": {"xlstm_launcher_chunk32": lc_counts, "xlstm_launcher_whole_prompt": lw_counts,
                       "xlstm_paged_whole_prompt": p_whole["counts"],
                       "xlstm_paged_chunk32": p_chunk["counts"]}}


def seeded_params(torch, cfg, dev, seed: int):
    """Weights drawn on the card from a seeded CUDA generator (never on the
    CPU), through the quantized init when ``cfg.weights_int8``; every leaf
    the init sets to zeros (the q/k/v biases, the layernorm biases)
    overwritten by standard-normal draws, in the tree's order, so that it
    moves the outputs."""
    from repro_torch.models import get_model
    from repro_torch.models.common import is_def

    gen = torch.Generator(dev).manual_seed(seed)
    model = get_model(cfg)
    params = model.init(gen)

    def draw(defs, node):
        for key, d in defs.items():
            if not is_def(d):
                draw(d, node[key])
            elif d.init == "zeros":
                node[key].copy_(torch.randn(node[key].shape, generator=gen, device=dev))

    draw(model.param_defs(), params)
    return params


def check_served(name: str, run: dict, n: int = 8) -> None:
    """Every stream of a paged run complete (8 new tokens): 0 failures."""
    if any(len(o) != n for o in run["outs"]):
        raise AssertionError(f"{name}: a stream fell short of {n} tokens: {run['outs']}")


def phase_glm4(torch, dev):
    """glm4-9b FULL in bf16 on the card: a batch-8 paged decode step (81
    rmsnorm and 40 paged decode launches, its time and the device's busy
    share), a batch-4 dense step (40 decode_attention launches), the
    launcher's 32 requests on dense engines on the first 2 layers
    (whole-prompt prefill: flash and decode_attention at G = 16), the pools
    phase's 8 prompts on a paged engine in 32-token chunks on a bf16 flat
    pool and whole-prompt on an int8 chained pool, 0 failures on each. Then
    the same FULL width at 4 of the 40 layers (other seeded draws) served
    on the card for the parity phase: a dense engine, whole-prompt, and
    both paged legs."""
    import gc

    from repro_torch.configs.registry import get_config

    cfg = get_config("glm4-9b")
    params = seeded_params(torch, cfg, dev, 0)
    n_params = sum(t.numel() for t in _leaves(params))
    L = cfg.n_layers
    log(f"  glm4-9b FULL: {L} layers, d_model {cfg.d_model}, {cfg.n_heads} query heads over "
        f"{cfg.n_kv_heads} KV heads (G = {cfg.n_heads // cfg.n_kv_heads}), hd {cfg.hd}, {n_params} "
        f"parameters in bf16, {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated on the card")
    per = phase_step(torch, cfg, params, dev)["decode step"]
    if per["rmsnorm"] != 2 * L + 1 or per["paged_attention"] != L:
        raise AssertionError(f"glm4 paged decode step: {per['rmsnorm']} rmsnorm and "
                             f"{per['paged_attention']} paged decode launches, expected {2 * L + 1} and {L}")
    dense_step(torch, cfg, params, dev)
    launcher, l_counts = launcher_leg(torch, 0, params, "glm4-9b",
                                      ("decode_attention", "flash_attention", "rmsnorm"),
                                      ("--layers", str(LAUNCHER_LAYERS["glm4-9b"])))
    bf = pools_run(torch, cfg, params, dev, "bf16", False, chunk_tokens=32)
    i8 = pools_run(torch, cfg, params, dev, "int8", True)
    for name, run, keys in (("glm4 pools bf16 flat chunk32", bf, ("paged_prefill_write", "paged_attention[flat]")),
                            ("glm4 pools int8 chained", i8, ("paged_prefill_write_quant",
                                                             "paged_attention[int8+chained]"))):
        check_served(name, run)
        for key in keys:
            if run["counts"][key] <= 0:
                raise AssertionError(f"{key} was not launched in {name}")
    want = {"bf16": L * 2 * cfg.n_kv_heads * cfg.hd * 2, "int8": L * 2 * cfg.n_kv_heads * (cfg.hd + 2)}
    got = {"bf16": bf["snap"]["kv_bytes_per_token"], "int8": i8["snap"]["kv_bytes_per_token"]}
    log(f"  glm4 kv_bytes_per_token: bf16 {got['bf16']} B, int8 {got['int8']} B (from the shapes: "
        f"{want['bf16']} and {want['int8']})")
    if got != {k: float(v) for k, v in want.items()}:
        raise AssertionError(f"glm4 kv_bytes_per_token {got}, expected {want}")
    counts = {"glm4_launcher_whole_prompt": l_counts, "glm4_pools_bf16_flat_chunk32": bf["counts"],
              "glm4_pools_int8_chained": i8["counts"]}
    del params, launcher
    gc.collect()
    torch.cuda.empty_cache()

    cfg4 = cfg.replace(n_layers=4)
    p4 = seeded_params(torch, cfg4, dev, 1)
    need = ("decode_attention", "flash_attention")
    served = {"dense": dense_run(torch, cfg4, p4, dev, 0, need),
              "bf16": pools_run(torch, cfg4, p4, dev, "bf16", False, chunk_tokens=32),
              "int8": pools_run(torch, cfg4, p4, dev, "int8", True)}
    check_served("glm4 4L pools bf16", served["bf16"])
    check_served("glm4 4L pools int8", served["int8"])
    return {"cfg": cfg4, "params": p4, "served": served, "counts": counts}


# Bytes of the weight-only int8 trees, reckoned from the configs by hand
# (``int8_tree_bytes``), by configuration and depth served
INT8_TREE_BYTES = {("granite-8b", 36): 8_459_509_760, ("qwen1.5-32b", 64): 35_987_901_440,
                   ("qwen2-vl-2b", 28): 2_012_200_704, ("whisper-large-v3", 32): 1_669_907_252,
                   ("dbrx-132b", 4): 14_890_336_256, ("llama4-maverick-400b-a17b", 2): 35_455_677_056,
                   ("jamba-1.5-large-398b", 8): 48_726_167_552}


def int8_tree_bytes(cfg) -> int:
    """A weight-only int8 tree's bytes from the config's widths, never from
    a tree: int8 values of every wq, wk, wv, wo, w1, w3, w2 (the experts'
    too) and unembed with one bf16 scale per output channel; in bf16 the
    embedding, the norms (weight, and bias under layernorm), the q/k/v
    biases, the routers and the Mamba mixers' leaves (in_proj, conv_w and
    conv_b, x_proj, dt_proj and dt_bias, A_log, D, out_proj); an
    encoder-decoder's encoder stack and cross-attention included."""
    from repro_torch.models.whisper import encoder_cfg

    d = cfg.d_model

    def proj(i, o):
        return i * o + 2 * o

    def norm():
        return 2 * d * (2 if cfg.norm == "layernorm" else 1)

    def attn(c, cross=False):
        H, hd = c.n_heads, c.hd
        KV = H if cross else min(c.n_kv_heads, H)
        bias = 2 * (H + 2 * KV) * hd if c.qkv_bias else 0
        return proj(d, H * hd) + 2 * proj(d, KV * hd) + proj(H * hd, d) + bias

    def mamba(c):
        m = c.mamba
        dI, R, S = m.expand * d, m.dt_rank or math.ceil(d / 16), m.d_state
        return 2 * (d * 2 * dI + m.d_conv * dI + dI + dI * (R + 2 * S) + R * dI + dI + dI * S + dI + dI * d)

    def ffn(c, i):
        f, n_in = c.d_ff, 2 if c.gated_mlp else 1
        one = n_in * proj(d, f) + proj(f, d)
        if c.moe is not None and c.layer_has_moe(i):
            return 2 * d * c.moe.n_experts + c.moe.n_experts * one
        return one

    def stack(c):
        per = 0
        for i, kind in enumerate(c.block_pattern):
            per += norm() + (attn(c) if kind == "attn" else mamba(c))
            if c.cross_attn:
                per += norm() + attn(c, cross=True)
            if c.d_ff > 0:
                per += norm() + ffn(c, i)
        return c.n_superblocks * per + norm()

    total = 2 * cfg.vocab_size * d + (0 if cfg.tie_embeddings else proj(d, cfg.vocab_size)) + stack(cfg)
    return total + (stack(encoder_cfg(cfg)) if cfg.encoder is not None else 0)


def check_tree_bytes(name: str, cfg, params) -> int:
    got, want = sum(t.numel() * t.element_size() for t in _leaves(params)), int8_tree_bytes(cfg)
    log(f"  {name} int8-weight tree: {got} B on the card (reckoned {want} B; "
        f"{got / 1e9:.3f} GB)")
    if not got == want == INT8_TREE_BYTES[cfg.name, cfg.n_layers]:
        raise AssertionError(f"{name}: {got} B, reckoned {want}, expected "
                             f"{INT8_TREE_BYTES[cfg.name, cfg.n_layers]}")
    return got


def int8_drawn(torch, cfg, dev, seed: int = 0):
    """``cfg`` with int8 weights drawn on the card by the quantized init
    (``seeded_params``): its bytes against the reckoning, its peak below the
    tree + 4 GiB (what was allocated before included), its draw's seconds."""
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = seeded_params(torch, cfg, dev, seed)
    torch.cuda.synchronize()
    t_draw, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    tb = check_tree_bytes(f"{cfg.name} {cfg.n_layers}L", cfg, params)
    log(f"  {cfg.name} {cfg.n_layers}L int8 weights drawn and quantized on the card in {t_draw:.3f} s; "
        f"max_memory_allocated {peak} B ({peak / 2**30:.3f} GiB; {before / 2**30:.3f} GiB allocated before), "
        f"tree + 4 GiB = {(tb + 4 * 2**30) / 2**30:.3f} GiB")
    if peak >= tb + 4 * 2**30:
        raise AssertionError(f"{cfg.name} int8 init peak {peak} B, not below the tree {tb} B + 4 GiB")
    return params


def step_peak(torch, step) -> dict:
    """The card's peak memory during one call of ``step`` above what was
    allocated before it (an int8 step's bf16 weight copies live there)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return {"allocated": base, "peak": peak, "above": peak - base}


def attn_layers(cfg) -> int:
    """Attention layers of ``cfg`` (every layer but a hybrid's Mamba ones)."""
    return cfg.n_superblocks * cfg.block_pattern.count("attn")


def moe_layers(cfg) -> int:
    """Layers of ``cfg`` with the MoE FFN: MoE calls a forward pass."""
    return cfg.n_superblocks * sum(cfg.layer_has_moe(i) for i in range(len(cfg.block_pattern)))


def check_step(name: str, cfg, per) -> None:
    L, A = cfg.n_layers, attn_layers(cfg)
    if per["rmsnorm"] != 2 * L + 1 or per["paged_attention"] != A:
        raise AssertionError(f"{name} paged decode step: {per['rmsnorm']} rmsnorm and "
                             f"{per['paged_attention']} paged decode launches, expected {2 * L + 1} and {A}")


QEINSUM_ULP = 0.55     # one rounding from f32 (0.501 and 0.508 read on the H100); two give about 1


def qeinsum_gap(torch, w) -> None:
    """``quantize_weight`` of a weight leaf on the card against the CPU, bit
    for bit: a 2-D slice (granite-8b's w1 (4096, 14336)) or a 3-D expert
    leaf (E, d, f); then ``qeinsum`` of bf16 activations on it, (8, 1, d)
    against a 2-D weight (``torch.mm``) or (E, 8, d) against a 3-D one
    (``torch.bmm``, the experts' product), the card (f32 output) against
    the CPU (f32 throughout) and both against an f64 product, in bf16 units
    in the last place of each output (ulps below 2**-8 of the largest output
    counted at that floor). The card must round once, from f32: within
    QEINSUM_ULP of the f64 product (a bf16 rounding before the scale puts
    it near 1 ulp) and within 1 ulp of the CPU. Returns the seconds taken."""
    from repro_torch.models.quant import qeinsum, quantize_weight

    t0 = time.perf_counter()
    card, host = quantize_weight(w), quantize_weight(w.cpu())
    if not (torch.equal(card["q"].cpu(), host["q"])
            and torch.equal(card["s"].cpu().view(torch.int16), host["s"].view(torch.int16))):
        raise AssertionError(f"quantize_weight {tuple(w.shape)} on the card differs from the CPU")
    g = torch.Generator(w.device).manual_seed(2)
    xs = (8, 1, w.shape[0]) if w.ndim == 2 else (w.shape[0], 8, w.shape[1])
    x = torch.randn(xs, generator=g, device=w.device).to(torch.bfloat16)
    y, y_cpu = qeinsum(x, card).cpu().float(), qeinsum(x.cpu(), host).float()
    xh = x.cpu().double()
    if w.ndim == 2:
        exact = (xh @ host["q"].double()) * host["s"].double()
    else:
        exact = torch.stack([xh[e] @ host["q"][e].double() for e in range(w.shape[0])]) * host["s"].double()
    ulp = 2.0 ** (torch.floor(torch.log2(exact.abs().clamp_min(float(exact.abs().max()) / 256))) - 7)
    d = (y - y_cpu).abs()
    to_cpu, card_f64 = float((d / ulp).max()), float(((y - exact).abs() / ulp).max())
    seconds = time.perf_counter() - t0
    log(f"  quantize_weight {tuple(w.shape)} bf16 on the card == the CPU, bit for bit; qeinsum bf16 "
        f"{xs} x int8 {tuple(w.shape)} ({'torch.mm' if w.ndim == 2 else 'torch.bmm'}): card against CPU "
        f"max |d| {float(d.max()):.6g} ({int((d > 0).sum())} of {d.numel()} outputs differ, largest "
        f"{to_cpu:.3g} bf16 ulp); against f64: card {card_f64:.3g} ulp (bound {QEINSUM_ULP}), CPU "
        f"{float(((y_cpu - exact).abs() / ulp).max()):.3g} ulp; {seconds:.1f} s")
    if not (card_f64 <= QEINSUM_ULP and to_cpu <= 1.0):
        raise AssertionError(f"qeinsum on the card: {card_f64} bf16 ulp from the f64 product, {to_cpu} "
                             f"from the CPU: not one rounding from f32")
    return seconds


def expert_leaf(torch, dev, arch: str = "jamba-1.5-large-398b", n: int = 4):
    """The first ``n`` experts of ``arch``'s w1 at its FULL width, (n, d,
    d_ff) in bf16, drawn on the card from a seeded generator at the init's
    scale: the 3-D leaf of ``qeinsum_gap``."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(arch)
    g = torch.Generator(dev).manual_seed(3)
    w = torch.randn(n, cfg.d_model, cfg.d_ff, generator=g, device=dev) / cfg.d_model ** 0.5
    return w.to(torch.bfloat16)


INT8W_NEED = ("decode_attention", "flash_attention", "rmsnorm")
# depth of the launcher bursts of phases 5, 8, 9, 10 and 11 (the first layers
# of the FULL trees the phases' steps run whole), for the script's time limit
# (4 until phase 21 came; xlstm-350m keeps its one whole superblock)
LAUNCHER_LAYERS = {"smollm-360m": 2, "xlstm-350m": 8, "glm4-9b": 2, "granite-8b": 2, "qwen1.5-32b": 2,
                   "qwen2-vl-2b": 2}


def free_card(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def int8w_granite(torch, dev, counts, steps) -> None:
    """granite-8b FULL in bf16 and with int8 weights (``quantize_params`` of
    the same tree, its bytes against the reckoning), in one run: each a
    batch-8 paged decode step (73 rmsnorm and 36 paged decode launches,
    time, busy share, device operations) and a batch-4 dense step (36
    decode_attention), side by side, then the launcher's 32 requests each
    (whole-prompt; --weights-int8 for the int8 tree)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.quant import quantize_params

    cfg = get_config("granite-8b")
    params = seeded_params(torch, cfg, dev, 0)
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"  granite-8b FULL: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} query heads over "
        f"{cfg.n_kv_heads} KV heads (G = {cfg.n_heads // cfg.n_kv_heads}), hd {cfg.hd}, {n_params} "
        f"parameters, {2 * n_params} B in bf16")
    qeinsum_gap(torch, params["blocks"]["l0_ffn"]["w1"][0])
    steps["qeinsum_gap_3d_s"] = qeinsum_gap(torch, expert_leaf(torch, dev))
    free_card(torch)
    legs = {"bf16": (cfg, params), "int8w": (cfg.replace(weights_int8=True), quantize_params(params))}
    del params
    check_tree_bytes("granite-8b", cfg, legs["int8w"][1])
    log(f"  {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated on the card (both trees)")
    for name, (c, p) in legs.items():
        log(f"  granite-8b {name}:")
        per = phase_step(torch, c, p, dev)
        check_step(f"granite-8b {name}", c, per["decode step"])
        steps[name] = dict(per["timing"], dense_ms=dense_step(torch, c, p, dev)[0])
    a, b = steps["bf16"], steps["int8w"]
    log(f"  granite-8b paged step, bf16 against int8 weights (one run): {a['step_ms']:.3f} / "
        f"{b['step_ms']:.3f} ms host clock, {a['device_us']:.1f} / {b['device_us']:.1f} us device, "
        f"busy {a['busy']:.4f} / {b['busy']:.4f}, {a['ops']:g} / {b['ops']:g} device operations; "
        f"dense step {a['dense_ms']:.3f} / {b['dense_ms']:.3f} ms")
    for name, (c, p) in legs.items():
        extra = ("--weights-int8",) if c.weights_int8 else ()
        counts[f"granite_{name}_launcher_whole_prompt"] = launcher_leg(
            torch, 0, p, "granite-8b", INT8W_NEED, extra + ("--layers", str(LAUNCHER_LAYERS["granite-8b"])))[1]


def int8w_qwen(torch, dev, counts, steps) -> None:
    """qwen1.5-32b FULL with int8 weights drawn on the card by the quantized
    init (standard-normal q/k/v biases), its bytes against the reckoning and
    its peak memory against the tree: a batch-8 paged step (129 rmsnorm and
    64 paged decode launches), a batch-4 dense step (64 decode_attention),
    the launcher's 32 requests with --weights-int8 (whole-prompt), and the
    pools phase's 8 prompts on an int8 chained pool."""
    from repro_torch.configs.registry import get_config

    cfg = get_config("qwen1.5-32b").replace(weights_int8=True)
    log(f"  qwen1.5-32b FULL: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads over "
        f"{cfg.n_kv_heads} KV heads")
    params = int8_drawn(torch, cfg, dev)
    per = phase_step(torch, cfg, params, dev)
    check_step("qwen1.5-32b int8w", cfg, per["decode step"])
    steps["qwen_int8w"] = dict(per["timing"], dense_ms=dense_step(torch, cfg, params, dev)[0])
    counts["qwen_int8w_launcher_whole_prompt"] = launcher_leg(
        torch, 0, params, "qwen1.5-32b", INT8W_NEED,
        ("--weights-int8", "--layers", str(LAUNCHER_LAYERS["qwen1.5-32b"])))[1]
    i8 = pools_run(torch, cfg, params, dev, "int8", True)
    check_served("qwen int8w pools int8 chained", i8)
    for key in ("paged_prefill_write_quant", "paged_attention[int8+chained]"):
        if i8["counts"][key] <= 0:
            raise AssertionError(f"{key} was not launched in the qwen int8 chained pools run")
    want = cfg.n_layers * 2 * cfg.n_kv_heads * (cfg.hd + 2)
    log(f"  qwen kv_bytes_per_token: int8 {i8['snap']['kv_bytes_per_token']} B (from the shapes: {want})")
    if i8["snap"]["kv_bytes_per_token"] != float(want):
        raise AssertionError(f"qwen kv_bytes_per_token {i8['snap']['kv_bytes_per_token']}, expected {want}")
    counts["qwen_int8w_pools_int8_chained"] = i8["counts"]


def int8w_parity_models(torch, dev) -> dict:
    """2 of the layers at FULL width for the parity phase: granite-8b in
    bf16 and with int8 weights, qwen1.5-32b with int8 weights, each on a
    dense engine (whole-prompt) and an int8 chained pool, then moved to the
    host."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.quant import quantize_params

    g2 = get_config("granite-8b").replace(n_layers=2)
    q2 = get_config("qwen1.5-32b").replace(n_layers=2, weights_int8=True)
    p2 = seeded_params(torch, g2, dev, 1)
    served = {}
    for name, c, p in (("granite-2L-bf16", g2, p2),
                       ("granite-2L-int8w", g2.replace(weights_int8=True), quantize_params(p2)),
                       ("qwen-2L-int8w", q2, seeded_params(torch, q2, dev, 1))):
        served[name] = {"cfg": c, "params": p, "dense": dense_run(torch, c, p, dev, 0, INT8W_NEED[:2]),
                        "int8": pools_run(torch, c, p, dev, "int8", True)}
        check_served(f"{name} pools int8", served[name]["int8"])
    offload(torch, list(served.values()))
    return served


def phase_int8w(torch, dev):
    """Weight-only int8: granite-8b FULL in bf16 and with int8 weights side
    by side, qwen1.5-32b FULL with int8 weights, each tree freed before the
    next; then the 4-layer models of the parity phase."""
    counts, steps = {}, {}
    int8w_granite(torch, dev, counts, steps)
    free_card(torch)
    int8w_qwen(torch, dev, counts, steps)
    free_card(torch)
    return {"served": int8w_parity_models(torch, dev), "counts": counts, "steps": steps}


IMAGE = (2, 96, 16, 8, 8)      # the image prompt: B, S, image_start, grid_h, grid_w
IMAGE_STEPS = 16
WHISPER_B, WHISPER_PROMPT, WHISPER_STEPS = 4, 16, 32
STUB_PARAMS = {"qwen2-vl-2b": 1_777_088_000, "whisper-large-v3": 1_601_198_080}   # the FULL configs' own


def n_params(cfg) -> int:
    """Parameters of ``cfg`` reckoned from its ParamDefs (nothing drawn)."""
    from repro_torch.models import get_model

    def count(defs):
        return sum(count(v) for v in defs.values()) if isinstance(defs, dict) else math.prod(defs.shape)

    return count(get_model(cfg).param_defs())


def image_prompt(torch, cfg, params, dev) -> dict:
    """qwen2-vl-2b's image prompt: seeded inputs_embeds (B, S, d), an image
    of grid_h x grid_w tokens at image_start, positions from
    ``mrope_positions_with_image``, through ``EmbedsLM.prefill`` (no flash
    launch: the image's tokens share a temporal index, which only the plain
    path masks by) and IMAGE_STEPS decode steps at a scalar cache index (one
    decode_attention a layer each). Then the whole-sequence forward over
    the same embeddings with the image's positions and with text-only ones:
    the prefill's tokens are the first's argmax, and the two differ."""
    from repro_torch.models import get_model
    from repro_torch.models.loss import first_argmax
    from repro_torch.models.vlm import mrope_positions_with_image

    B, S, start, gh, gw = IMAGE
    L, model = cfg.n_layers, get_model(cfg)
    gen = torch.Generator(dev).manual_seed(7)
    emb = torch.randn(B, S, cfg.d_model, generator=gen, device=dev).to(cfg.compute_dtype)
    pos = mrope_positions_with_image(B, S, start, gh, gw, dev)
    reset_counts()
    t0 = time.perf_counter()
    tok, cache = model.prefill(params, {"inputs_embeds": emb, "positions": pos}, cap=S + IMAGE_STEPS)
    torch.cuda.synchronize()
    prefill_ms, pre = (time.perf_counter() - t0) * 1e3, read_counts()
    if pre["flash_attention"] != 0 or pre["rmsnorm"] != 2 * L + 1:
        raise AssertionError(f"{cfg.name} image prefill: {pre['flash_attention']} flash and {pre['rmsnorm']} "
                             f"rmsnorm launches, expected 0 and {2 * L + 1}")
    outs = [tok]
    t0 = time.perf_counter()
    for j in range(IMAGE_STEPS):
        a = read_counts()
        tok, cache = model.decode(params, cache, {"token": tok[:, None], "cache_index": S + j})
        if read_counts()["decode_attention"] - a["decode_attention"] != L:
            raise AssertionError(f"{cfg.name} image decode step {j}: not {L} decode_attention launches")
        outs.append(tok)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / IMAGE_STEPS
    outs = torch.stack(outs, 1).cpu().tolist()
    with torch.no_grad():
        l_img = model.logits(params, model.hidden(params, inputs_embeds=emb, positions=pos)[:, -1])
        l_txt = model.logits(params, model.hidden(params, inputs_embeds=emb)[:, -1])
    gap = float((l_img - l_txt).abs().max())
    same = first_argmax(l_img).cpu().tolist() == [o[0] for o in outs]
    log(f"  {cfg.name} {L}L image prompt (B {B}, S {S}, {gh} x {gw} image at {start}): prefill "
        f"{prefill_ms:.3f} ms, launches {({n: c for n, c in pre.items() if c})}; {IMAGE_STEPS} decode steps "
        f"{step_ms:.3f} ms each (host clock), {L} decode_attention each; last-position logits, image "
        f"positions against text-only, max |d| {gap:.4f}; prefill tokens == argmax of the forward: {same}")
    if not (gap > 0.05 and same):
        raise AssertionError(f"{cfg.name} image prompt: logits gap {gap} to text-only positions, "
                             f"prefill tokens equal to the forward's argmax: {same}")
    return {"emb": emb, "pos": pos, "outs": outs, "prefill_counts": pre}


def mrope_ops(torch, cfg, dev) -> None:
    """Device operations of M-RoPE against RoPE on one decode step's q
    (8, 1, H, hd) in bf16, from torch.profiler: what M-RoPE adds a layer is
    twice the difference (q and k)."""
    from repro_torch.models.rotary import apply_mrope, apply_rope, mrope_positions_for, positions_for

    q = torch.randn(8, 1, cfg.n_heads, cfg.hd, device=dev).to(cfg.compute_dtype)
    pos, pos3 = positions_for(8, 1, 100, dev), mrope_positions_for(8, 1, 100, dev)
    rope = device_ops(lambda: apply_rope(q, pos, cfg.rope_theta))
    mrope = device_ops(lambda: apply_mrope(q, pos3, cfg.rope_theta, cfg.mrope_sections))
    log(f"  device operations a call on q (8, 1, {cfg.n_heads}, {cfg.hd}): RoPE {rope:g}, M-RoPE {mrope:g}: "
        f"M-RoPE adds {2 * (mrope - rope):g} a layer (q and k)")


def stubs_qwen2_vl(torch, dev, counts, steps) -> None:
    """qwen2-vl-2b FULL in bf16 (standard-normal q/k/v biases): the
    launcher's 32 requests on the first 4 of its 28 layers (dense,
    32-token chunks: the whole-prompt dense
    prefill wants embeddings), a batch-8 paged step (57 rmsnorm and 28
    paged decode launches) and a batch-4 dense step (28 decode_attention),
    each timed and profiled; a paged engine serving the pools phase's 8
    prompts whole-prompt and in 32-token chunks; the image prompt. Then the
    same tree with int8 weights (``quantize_params``; its bytes against the
    reckoning): the launcher's 32 requests with --weights-int8 and the
    image prompt (no flash launch)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.quant import quantize_params

    cfg = get_config("qwen2-vl-2b")
    params = seeded_params(torch, cfg, dev, 0)
    n = sum(t.numel() for t in _leaves(params))
    log(f"  qwen2-vl-2b FULL: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} query heads over "
        f"{cfg.n_kv_heads} KV heads (G = {cfg.n_heads // cfg.n_kv_heads}), hd {cfg.hd}, M-RoPE sections "
        f"{cfg.mrope_sections}, {n} parameters, {2 * n} B in bf16")
    if not n == n_params(cfg) == STUB_PARAMS[cfg.name]:
        raise AssertionError(f"qwen2-vl-2b: {n} parameters, reckoned {n_params(cfg)}")
    mrope_ops(torch, cfg, dev)
    depth = ("--layers", str(LAUNCHER_LAYERS["qwen2-vl-2b"]))
    counts["qwen2vl_launcher_chunk32"] = launcher_leg(torch, 32, params, "qwen2-vl-2b",
                                                      ("decode_attention", "rmsnorm"), depth)[1]
    per = phase_step(torch, cfg, params, dev)
    check_step("qwen2-vl-2b", cfg, per["decode step"])
    steps["qwen2vl_paged"] = per["timing"]
    steps["qwen2vl_dense"] = dense_step(torch, cfg, params, dev, chunk_tokens=32)[2]
    for chunk in (0, 32):
        run = pools_run(torch, cfg, params, dev, "bf16", False, chunk_tokens=chunk)
        name = f"qwen2vl_pools_bf16_{'chunk32' if chunk else 'whole_prompt'}"
        check_served(name, run)
        for key in ("paged_prefill_write", "paged_attention[flat]") + (() if chunk else ("flash_attention",)):
            if run["counts"][key] <= 0:
                raise AssertionError(f"{key} was not launched in {name}")
        counts[name] = run["counts"]
    counts["qwen2vl_image_prefill"] = image_prompt(torch, cfg, params, dev)["prefill_counts"]
    t0 = time.perf_counter()
    cfg8 = cfg.replace(weights_int8=True)
    params = quantize_params(params)
    check_tree_bytes("qwen2-vl-2b", cfg8, params)
    counts["qwen2vl_int8_launcher_chunk32"] = launcher_leg(torch, 32, params, "qwen2-vl-2b",
                                                           ("decode_attention", "rmsnorm"),
                                                           ("--weights-int8",) + depth)[1]
    counts["qwen2vl_int8_image_prefill"] = image_prompt(torch, cfg8, params, dev)["prefill_counts"]
    log(f"  qwen2-vl-2b int8 weights (quantize_params of the same tree): {time.perf_counter() - t0:.1f} s")


def whisper_run(torch, cfg, params, dev) -> dict:
    """Seeded frames (B, n_ctx, d) and prompts of WHISPER_PROMPT tokens
    through ``EncDecLM.prefill`` (one flash launch a decoder layer, no
    rmsnorm: layernorm is plain torch, the encoder and cross-attention take
    the plain path), then WHISPER_STEPS decode steps (one decode_attention a
    layer each): the encoder's time alone, the prefill's, a decode step's
    on the host clock and under the profiler, and the cache's bytes."""
    from repro_torch.models import get_model
    from repro_torch.models import whisper as wh

    B, P, T, L = WHISPER_B, WHISPER_PROMPT, cfg.encoder.n_ctx, cfg.n_layers
    model = get_model(cfg)
    gen = torch.Generator(dev).manual_seed(8)
    frames = torch.randn(B, T, cfg.d_model, generator=gen, device=dev).to(cfg.compute_dtype)
    toks = torch.randint(1, cfg.vocab_size, (B, P), generator=gen, device=dev)
    enc_ms = []
    with torch.no_grad():
        for _ in range(2):                                  # the second without first-call costs
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wh.encode(cfg, params, frames)
            torch.cuda.synchronize()
            enc_ms.append((time.perf_counter() - t0) * 1e3)
        enc = profiled_steps(torch, lambda: wh.encode(cfg, params, frames), n=1)
    reset_counts()
    t0 = time.perf_counter()
    tok, cache = model.prefill(params, {"frames": frames, "tokens": toks}, cap=P + WHISPER_STEPS)
    torch.cuda.synchronize()
    prefill_ms, pre = (time.perf_counter() - t0) * 1e3, read_counts()
    if pre["flash_attention"] != L or pre["rmsnorm"] != 0:
        raise AssertionError(f"{cfg.name} prefill: {pre['flash_attention']} flash and {pre['rmsnorm']} rmsnorm "
                             f"launches, expected {L} and 0")
    outs, state = [tok], {"tok": tok, "cache": cache, "at": P}

    def step():
        a = read_counts()["decode_attention"]
        state["tok"], state["cache"] = model.decode(params, state["cache"],
                                                    {"token": state["tok"][:, None], "cache_index": state["at"]})
        if read_counts()["decode_attention"] - a != L:
            raise AssertionError(f"{cfg.name} decode step at {state['at']}: not {L} decode_attention launches")
        state["at"] += 1
        outs.append(state["tok"])

    n_timed = WHISPER_STEPS - PROFILED_STEPS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_timed
    timing = profiled_steps(torch, step)
    top = {"encoder": (enc.pop("top"), enc["n"]), "decode step": (timing.pop("top"), timing["n"])}
    blocks = state["cache"]["blocks"]
    cross = sum(t.numel() * t.element_size() for k, v in blocks.items() if k.endswith("_cross") for t in v.values())
    self_ = sum(t.numel() * t.element_size() for k, v in blocks.items() if k.endswith("_mixer") for t in v.values())
    cross_seq, self_tok = cross / B, self_ / (B * (P + WHISPER_STEPS))
    want = (L * 2 * T * cfg.n_heads * cfg.hd * 2, L * 2 * cfg.n_kv_heads * cfg.hd * 2)
    log(f"  {cfg.name} {L}+{cfg.encoder.n_layers}L, frames ({B}, {T}, {cfg.d_model}), prompts of {P}: encoder "
        f"{enc_ms[1]:.3f} ms (first call {enc_ms[0]:.3f}), prefill {prefill_ms:.3f} ms (launches "
        f"{ {n: c for n, c in pre.items() if c} }); decode step {step_ms:.3f} ms (host clock, synchronized, "
        f"mean of {n_timed}), {timing['text']}, {L} decode_attention each; cross-attention cache {cross_seq:.0f} B "
        f"a sequence, self-attention cache {self_tok:.0f} B a token (reckoned {want[0]} and {want[1]}); "
        f"encoder under the profiler: {enc['text']}")
    for name, (events, n) in top.items():
        for e in events[:6]:
            log(f"    {name}: device {e.self_device_time_total / n:10.1f} us  x{e.count / n:g}  {e.key[:90]}")
    if (cross_seq, self_tok) != (float(want[0]), float(want[1])):
        raise AssertionError(f"{cfg.name} cache bytes {cross_seq}, {self_tok}, reckoned {want}")
    return {"frames": frames, "prompts": toks.cpu().tolist(), "outs": torch.stack(outs, 1).cpu().tolist(),
            "prefill_counts": pre, "timing": dict(timing, step_ms=step_ms, encoder_ms=enc_ms[1],
                                                  encoder_device_us=enc["device_us"], prefill_ms=prefill_ms)}


def phase_stubs(torch, dev):
    """The two stub-frontend families, each tree freed before the next:
    qwen2-vl-2b FULL in bf16 and with int8 weights (``stubs_qwen2_vl``),
    whisper-large-v3 FULL (``whisper_run``) in bf16 and with int8 weights
    (``quantize_params`` of the same tree, its bytes against the
    reckoning); then 4 layers of qwen2-vl-2b and 4 encoder and 4 decoder
    layers of whisper at FULL width (other draws), in bf16 and with int8
    weights, served for the parity phase: the qwen dense engine's 8
    launcher prompts in 32-token chunks and its image prompt, whisper's
    prefill and decode."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models.quant import quantize_params

    counts, steps = {}, {}
    stubs_qwen2_vl(torch, dev, counts, steps)
    free_card(torch)
    cfg = get_config("whisper-large-v3")
    params = seeded_params(torch, cfg, dev, 0)
    n = sum(t.numel() for t in _leaves(params))
    log(f"  whisper-large-v3 FULL: {cfg.encoder.n_layers} encoder and {cfg.n_layers} decoder layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, hd {cfg.hd}, {cfg.encoder.n_ctx} frames, {n} parameters, "
        f"{2 * n} B in bf16")
    if not n == n_params(cfg) == STUB_PARAMS[cfg.name]:
        raise AssertionError(f"whisper-large-v3: {n} parameters, reckoned {n_params(cfg)}")
    run = whisper_run(torch, cfg, params, dev)
    counts["whisper_prefill"], steps["whisper"] = run["prefill_counts"], run["timing"]
    t0 = time.perf_counter()
    cfg8, params = cfg.replace(weights_int8=True), quantize_params(params)
    check_tree_bytes("whisper-large-v3", cfg8, params)
    run = whisper_run(torch, cfg8, params, dev)
    counts["whisper_int8_prefill"], steps["whisper_int8"] = run["prefill_counts"], run["timing"]
    log(f"  whisper-large-v3 int8 weights (quantize_params of the same tree): {time.perf_counter() - t0:.1f} s")
    del params, run
    free_card(torch)

    q4 = get_config("qwen2-vl-2b").replace(n_layers=4)
    w4 = cfg.replace(n_layers=4, encoder=dataclasses.replace(cfg.encoder, n_layers=4))
    log(f"  parity models: qwen2-vl-2b 4L {n_params(q4)} parameters, whisper 4+4L {n_params(w4)}")
    pq, pw = seeded_params(torch, q4, dev, 1), seeded_params(torch, w4, dev, 1)
    served = {}
    for tag, (qc, qp, wc, wp) in (("", (q4, pq, w4, pw)),
                                  ("_int8", (q4.replace(weights_int8=True), quantize_params(pq),
                                             w4.replace(weights_int8=True), quantize_params(pw)))):
        served["qwen" + tag] = {"cfg": qc, "params": qp, "image": image_prompt(torch, qc, qp, dev),
                                "dense": dense_run(torch, qc, qp, dev, 32, ("decode_attention",))}
        served["whisper" + tag] = {"cfg": wc, "params": wp, "run": whisper_run(torch, wc, wp, dev)}
    for r in served.values():
        for key in ("emb", "pos", "frames"):
            for part in ("image", "run"):
                if key in r.get(part, {}):
                    r[part][key] = r[part][key].cpu()
    offload(torch, list(served.values()))
    return {"served": served, "counts": counts, "steps": steps}


# ---------------------------------------------------------------------------
# MoE: dbrx-132b and llama4-maverick at FULL width, cut in depth
# ---------------------------------------------------------------------------

# layers served at FULL width, and the bf16 tree's bytes reckoned by hand
MOE_RUNS = {"dbrx-132b": (4, 28_538_941_440), "llama4-maverick-400b-a17b": (2, 68_816_783_360)}
ROUTE_GAP = 0.03     # a routing decision on the card (bf16) that differs from the CPU's (f32) is put
                     # down to bf16 routing when the CPU's gap at that decision is below this
REPLAY_STEPS = 1     # decode steps of each parity leg's replay
LEG_MARGIN = 16e9    # host bytes the replayed parity legs need free beyond their f32 arena
HOST_WAIT_S = 120.0  # the longest the replayed parity legs wait for that room


def mem_available() -> int:
    """The host's MemAvailable (/proc/meminfo), in bytes."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable line in /proc/meminfo")


def release_host() -> str:
    """Collect garbage and hand the C heap's free pages back to the system
    (``malloc_trim``); returns MemAvailable and this process's resident
    bytes, for the log."""
    import ctypes
    import gc
    import resource

    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)
    rss = int(Path("/proc/self/statm").read_text().split()[1]) * resource.getpagesize()
    return f"host MemAvailable {mem_available()} B, resident {rss} B"


def host_room(need: float) -> str:
    """Wait, at most HOST_WAIT_S, until the host's MemAvailable exceeds
    ``need`` bytes, and say how it went; raise if it never does. A tree this
    process has just freed leaves its resident set at once but comes back to
    MemAvailable only over the next seconds."""
    t0, first = time.perf_counter(), mem_available()
    avail = first
    while avail <= need:
        if time.perf_counter() - t0 > HOST_WAIT_S:
            raise AssertionError(f"host MemAvailable {avail} B after {HOST_WAIT_S} s (first {first} B), "
                                 f"not above the {need:.0f} B a parity leg needs")
        time.sleep(0.25)
        avail = mem_available()
    return (f"MemAvailable {first} B at first, {avail} B after {time.perf_counter() - t0:.2f} s, "
            f"above the {need:.0f} B needed")


class RoutingLog:
    """While on, records each ``moe_core`` call's router logits (f32, on
    the host), capacity and padding mask: the routing the port's plain
    ``moe.route`` recomputes from them."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.calls, self.orig = moe, [], moe.moe_core

    def __enter__(self):
        orig = self.orig

        def recording(cfg, x_flat, logits, w1, w3, w2, capacity, valid=None):
            self.calls.append((logits.detach().float().cpu(), capacity,
                               None if valid is None else valid.cpu()))
            return orig(cfg, x_flat, logits, w1, w3, w2, capacity, valid=valid)

        self.moe.moe_core = recording
        return self

    def __exit__(self, *exc):
        self.moe.moe_core = self.orig


def routed(torch, cfg, call):
    """The plain routing of one recorded call and its kept (expert, token)
    pairs, an (E, T) bool."""
    from repro_torch.models import moe

    logits, cap, valid = call
    r = moe.route(cfg, logits, cap, valid)
    kept = torch.zeros(r["assigned"].shape, dtype=torch.bool)
    kept.scatter_(1, r["sel_idx"], r["sel_valid"])
    return r, kept


def drop_share(torch, cfg, calls) -> dict:
    """Expert assignments made and dropped over recorded calls."""
    made = kept = 0
    for call in calls:
        r, k = routed(torch, cfg, call)
        made, kept = made + int(r["assigned"].sum()), kept + int(k.sum())
    return {"assignments": made, "dropped": made - kept, "share": (made - kept) / max(1, made)}


def swap_gap(torch, score, cpu, card):
    """Along dim 0 of masks shaped as the CPU's ``score``: the score of the
    best item the CPU took and the card did not, less that of the worst the
    card took and the CPU did not; the least change that swaps them."""
    hi = torch.where(cpu & ~card, score, -math.inf).amax(0)
    lo = torch.where(card & ~cpu, score, math.inf).amin(0)
    return hi - lo


def routing_check(torch, cfg, card_calls, cpu_calls, B: int, P: int):
    """The card's routing (bf16 hidden states) against the CPU's (f32), call
    by call, over a replay of B streams: a prefill of P tokens each, then a
    token a stream each decode step, ``moe_layers(cfg)`` MoE calls a pass.
    Every token whose kept experts differ is traced to a decision: a token's own
    top-k choice, or an expert's capacity cut (the same tokens assigned).
    Its CPU gap is the least change that swaps what the two sides chose:
    the best router probability (top-k) or gate score (capacity) the CPU
    took and the card did not, less the worst the card took and the CPU did
    not. A decision whose inputs an earlier difference already moved is
    excused; every other one must sit at a CPU gap below ROUTE_GAP, else
    this raises. A difference moves the token's stream from its position on
    in a layer below the last (attention, and a hybrid's Mamba recurrence),
    its own row alone in the last layer. Returns the (B, rows) mask of logit
    rows a difference moved, and a summary. The last MoE layer must be the
    model's last layer (dbrx, llama4 and a 2-layer jamba)."""
    L, k = moe_layers(cfg), cfg.moe.top_k
    if not cfg.layer_has_moe(len(cfg.block_pattern) - 1):
        raise ValueError(f"{cfg.name}: its last layer has no MoE FFN")
    if len(card_calls) != len(cpu_calls) or len(card_calls) % L:
        raise AssertionError(f"{len(card_calls)} MoE calls on the card, {len(cpu_calls)} on the CPU")
    n_rows = len(card_calls) // L
    attn = torch.full((B,), P + n_rows)                   # first position whose inputs are moved
    row = torch.zeros(B, P + n_rows, dtype=torch.bool)    # positions whose last-layer output alone is
    st = {"calls": 0, "decisions": 0, "excused": 0, "widest": 0.0, "first": None}
    for c, (a, b) in enumerate(zip(card_calls, cpu_calls)):
        ra, ka = routed(torch, cfg, a)
        rb, kb = routed(torch, cfg, b)
        diff = (ka != kb).any(0)                          # (T,) tokens whose kept experts differ
        if not diff.any():
            continue
        step, T = c // L, diff.numel()
        if T != (B * P if step == 0 else B):
            raise AssertionError(f"call {c}: {T} tokens, expected {B * P if step == 0 else B}")
        tok = torch.arange(T)
        bs, ps = (tok // P, tok % P) if step == 0 else (tok, torch.full((B,), P + step - 1))
        moved = ps >= attn[bs]
        own = (ra["assigned"] != rb["assigned"]).any(0)
        gaps = [swap_gap(torch, rb["probs"].T, rb["assigned"], ra["assigned"])[own & ~moved]]
        cut = ((ka != kb).any(1) & (ra["assigned"] == rb["assigned"]).all(1)
               & ~(rb["assigned"] & moved[None]).any(1))
        gaps.append(swap_gap(torch, (rb["assigned"].float() + rb["w_te"]).T, kb.T, ka.T)[cut])
        g = torch.cat(gaps)
        st["calls"] += 1
        st["decisions"] += g.numel()
        st["excused"] += int((own & moved).sum())
        st["first"] = c if st["first"] is None else st["first"]
        if g.numel():
            st["widest"] = max(st["widest"], float(g.max()))
            if float(g.max()) > ROUTE_GAP:
                raise AssertionError(f"call {c} (layer {c % L}, pass {step}): routing differs at a CPU gap "
                                     f"{float(g.max())} above {ROUTE_GAP}")
        if c % L < L - 1:
            attn.scatter_reduce_(0, bs[diff], ps[diff], "amin")
        else:
            row[bs[diff], ps[diff]] = True
    pos = P - 1 + torch.arange(n_rows)
    return (pos[None] >= attn[:, None]) | row[:, pos], st


def moe_dropped(torch, cfg, eng) -> dict:
    """One more decode step of ``eng`` (all 8 slots live), its routing
    recorded: the share of expert assignments dropped at capacity."""
    from repro_torch.models.moe import capacity_for

    with RoutingLog() as rl:
        eng.step()
    torch.cuda.synchronize()
    d = drop_share(torch, cfg, rl.calls)
    log(f"  {cfg.name} {cfg.n_layers}L decode step routing (8 tokens, top-{cfg.moe.top_k} of "
        f"{cfg.moe.n_experts}, C = {capacity_for(cfg, 8)}): {d['assignments']} expert assignments over "
        f"{len(rl.calls)} MoE layers, {d['dropped']} dropped ({d['share']:.4f})")
    return d


def moe_served(torch, dev, arch, counts, steps) -> None:
    """One MoE model at FULL width, cut to MOE_RUNS' depth, in bf16: drawn
    on the card by the blocked init (its bytes against the reckoning, its
    peak below the tree + 4 GiB), a batch-8 paged step (2L + 1 rmsnorm and
    L paged decode launches, time, busy share, device operations, the
    dropped share of one more step), a batch-4 dense step (L
    decode_attention), the launcher's 32 requests with --layers
    (whole-prompt), the pools phase's 8 prompts (dbrx in 32-token chunks on
    a bf16 flat pool, llama4 whole-prompt on an int8 chained pool), 0
    failures; then the tree is freed."""
    from repro_torch.configs.registry import get_config

    L, want = MOE_RUNS[arch]
    tag = arch.split("-")[0]
    cfg = get_config(arch).replace(n_layers=L)
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = seeded_params(torch, cfg, dev, 0)
    torch.cuda.synchronize()
    t_draw, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    tb = sum(t.numel() * t.element_size() for t in _leaves(params))
    m = cfg.moe
    log(f"  {arch} FULL width, {L} of {get_config(arch).n_layers} layers: d_model {cfg.d_model}, "
        f"{cfg.n_heads} query heads over {cfg.n_kv_heads} KV heads (G = {cfg.n_heads // cfg.n_kv_heads}), "
        f"{m.n_experts} experts top-{m.top_k}, d_ff {cfg.d_ff}; {tb} B in bf16 (reckoned {want} B), drawn "
        f"on the card in {t_draw:.3f} s; max_memory_allocated {peak} B ({peak / 2**30:.3f} GiB; "
        f"{before / 2**30:.3f} GiB allocated before), tree + 4 GiB = {(tb + 4 * 2**30) / 2**30:.3f} GiB")
    if not tb == want == 2 * n_params(cfg):
        raise AssertionError(f"{arch} {L}L: {tb} B, reckoned {want}, {n_params(cfg)} parameters")
    if peak >= tb + 4 * 2**30:
        raise AssertionError(f"{arch} init peak {peak} B, not below the tree {tb} B + 4 GiB")
    per = phase_step(torch, cfg, params, dev, after=lambda eng: moe_dropped(torch, cfg, eng))
    check_step(arch, cfg, per["decode step"])
    steps[f"{tag}_paged"] = dict(per["timing"], dropped=per["after"])
    steps[f"{tag}_dense"] = dense_step(torch, cfg, params, dev)[2]
    counts[f"{tag}_launcher_whole_prompt"] = launcher_leg(
        torch, 0, params, arch, ("decode_attention", "flash_attention", "rmsnorm"), ("--layers", str(L)))[1]
    if tag == "dbrx":
        run, name = pools_run(torch, cfg, params, dev, "bf16", False, chunk_tokens=32), "pools_bf16_flat_chunk32"
        keys = ("paged_prefill_write", "paged_attention[flat]")
    else:
        run, name = pools_run(torch, cfg, params, dev, "int8", True), "pools_int8_chained"
        keys = ("paged_prefill_write_quant", "paged_attention[int8+chained]")
    check_served(f"{tag} {name}", run)
    for key in keys:
        if run["counts"][key] <= 0:
            raise AssertionError(f"{key} was not launched in {tag} {name}")
    counts[f"{tag}_{name}"] = run["counts"]
    del params
    free_card(torch)


def ample(cfg):
    """``cfg`` with no drop possible: capacity factor n_experts / top_k, so
    capacity_for(n) = n in both packages."""
    import dataclasses

    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def moe_replay(torch, cfg, params, dev, prompts, steps: int) -> dict:
    """``DecoderLM.prefill`` of equal-length prompts on a dense cache, then
    ``steps`` greedy decode steps, no engine and no idle slot, every MoE
    call's routing recorded."""
    from repro_torch.models import get_model
    from repro_torch.models.moe import capacity_for

    model = get_model(cfg)
    B, L = len(prompts), len(prompts[0])
    cache = model.init_cache(B, L + steps + 1, dev)
    with RoutingLog() as rl:
        tok, cache = model.prefill(params, {"tokens": torch.tensor(prompts)}, cache)
        outs = [tok]
        for j in range(steps):
            tok, cache = model.decode(params, cache, {"token": tok[:, None], "cache_index": L + j})
            outs.append(tok)
    torch.cuda.synchronize()
    outs = torch.stack(outs, 1).cpu().tolist()
    n = moe_layers(cfg)
    d = {"prefill": drop_share(torch, cfg, rl.calls[:n]), "decode": drop_share(torch, cfg, rl.calls[n:])}
    log(f"  {cfg.name} {cfg.n_layers}L replay at capacity factor {cfg.moe.capacity_factor}: {B} prompts of "
        f"{L} tokens (C = {capacity_for(cfg, B * L)}), {steps} decode steps (C = {capacity_for(cfg, B)}); "
        + "; ".join(f"{k} {v['dropped']} of {v['assignments']} expert assignments dropped ({v['share']:.4f})"
                    for k, v in d.items()))
    return {"cfg": cfg, "prompts": prompts, "outs": outs, "calls": rl.calls, "dropped": d}


def int8_replay(torch, cfg, params, dev, prompts) -> dict:
    """``moe_replay`` of ``prompts`` on ``quantize_params(params)`` (int8
    weights, quantized on the card), REPLAY_STEPS steps; the int8 tree is
    freed after it (the parity phase quantizes the same tree again, on the
    card, into the host arena: ``HostArena.quantized``)."""
    from repro_torch.models.quant import quantize_params

    t0 = time.perf_counter()
    p8 = quantize_params(params)
    r = moe_replay(torch, cfg.replace(weights_int8=True), p8, dev, prompts, REPLAY_STEPS)
    del p8
    free_card(torch)
    log(f"  {cfg.name} {cfg.n_layers}L int8-weight replay: {time.perf_counter() - t0:.1f} s")
    return r


def moe_parity_models(torch, dev) -> dict:
    """The parity legs' replays on the card (``moe_replay``, REPLAY_STEPS
    steps), kept there for the parity phase (76.3 GB of bf16 trees):
    jamba-1.5-large at its first 2 layers (Mamba, then Mamba + MoE), FULL
    width, with no drop possible (leg J: 4 prompts of 16 tokens); dbrx-132b
    at 2 layers, FULL width (other draws), with no drop possible (leg A: 4
    such prompts) and at the default, binding capacity (leg B: 8 such
    prompts, so that decode binds too, C = 4 < T = 8); llama4-maverick at 1
    layer with no drop possible (leg C: 4 prompts). Legs J8 and A8 replay
    J's and A's prompts on ``quantize_params`` of the same trees
    (``int8_replay``), freed after their replays."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import first_layers

    def prompts(cfg, n):
        return [[int(t) for t in np.random.default_rng(2000 + i).integers(1, cfg.vocab_size, 16)]
                for i in range(n)]

    cfgj = first_layers(get_config("jamba-1.5-large-398b"), HYBRID_PARITY_LAYERS)
    pj = seeded_params(torch, cfgj, dev, 1)
    served = {"jamba": {"params": pj, "J": moe_replay(torch, ample(cfgj), pj, dev, prompts(cfgj, 4),
                                                      REPLAY_STEPS),
                        "J8": int8_replay(torch, ample(cfgj), pj, dev, prompts(cfgj, 4))}}
    cfg2 = get_config("dbrx-132b").replace(n_layers=2)
    p2 = seeded_params(torch, cfg2, dev, 1)
    served["dbrx"] = {"params": p2, "A": moe_replay(torch, ample(cfg2), p2, dev, prompts(cfg2, 4), REPLAY_STEPS),
                      "B": moe_replay(torch, cfg2, p2, dev, prompts(cfg2, 8), REPLAY_STEPS),
                      "A8": int8_replay(torch, ample(cfg2), p2, dev, prompts(cfg2, 4))}
    cfg1 = get_config("llama4-maverick-400b-a17b").replace(n_layers=1)
    p1 = seeded_params(torch, cfg1, dev, 1)
    served["llama4"] = {"params": p1, "C": moe_replay(torch, ample(cfg1), p1, dev, prompts(cfg1, 4), REPLAY_STEPS)}
    return served


def moe_int8(torch, dev, arch, counts, steps) -> None:
    """One MoE model at MOE_RUNS' depth with int8 weights drawn on the card
    (``int8_drawn``): a batch-8 paged step (launches, time, busy share) and
    its device split (``int8_split``); llama4 also the card's peak during a
    step, which holds the bf16 copy of a 128-expert leaf; dbrx also
    launch/serve.main() --weights-int8 --layers 4, 32 requests, 0 failures;
    then the tree is freed."""
    from repro_torch.configs.registry import get_config

    L, _ = MOE_RUNS[arch]
    tag = arch.split("-")[0]
    cfg = get_config(arch).replace(n_layers=L, weights_int8=True)
    params = int8_drawn(torch, cfg, dev)

    def after(eng):
        out = {"split": int8_split(torch, cfg, eng.step)}
        if tag == "llama4":
            out["peak"] = p = step_peak(torch, eng.step)
            w1 = cfg.moe.n_experts * cfg.d_model * cfg.d_ff * 2
            log(f"  {arch} {L}L int8 decode step: peak {p['peak']} B on the card, {p['above']} B above the "
                f"{p['allocated']} B allocated before it (one 128-expert w1 leaf in bf16: {w1} B)")
        return out

    per = phase_step(torch, cfg, params, dev, after=after)
    check_step(f"{arch} int8", cfg, per["decode step"])
    steps[f"{tag}_int8_paged"] = dict(per["timing"], **per["after"])
    if tag == "dbrx":
        counts["dbrx_int8_launcher_whole_prompt"] = launcher_leg(
            torch, 0, params, arch, ("decode_attention", "flash_attention", "rmsnorm"),
            ("--weights-int8", "--layers", str(L)))[1]
    del params
    free_card(torch)


def phase_moe(torch, dev) -> dict:
    """The MoE family, every earlier tree off the card: dbrx-132b at 4 and
    llama4-maverick at 2 of their layers, FULL width, in bf16 and then with
    int8 weights, each tree freed before the next. The parity legs' runs
    (``moe_parity_models``) come after the hybrid phase, whose tree needs
    the card to itself."""
    counts, steps = {}, {}
    for arch in MOE_RUNS:
        t0 = time.perf_counter()
        moe_served(torch, dev, arch, counts, steps)
        t1 = time.perf_counter()
        moe_int8(torch, dev, arch, counts, steps)
        log(f"  {arch}: {time.perf_counter() - t0:.1f} s (bf16 {t1 - t0:.1f} s, int8 weights "
            f"{time.perf_counter() - t1:.1f} s)")
    return {"counts": counts, "steps": steps}


# ---------------------------------------------------------------------------
# Hybrid: jamba-1.5-large at FULL width, cut to the first layers of its superblock
# ---------------------------------------------------------------------------

# layers served at FULL width (Mamba, Mamba + MoE, Mamba, attention + MoE:
# every kind of layer jamba has), and the bf16 tree's bytes reckoned by hand
# (23,021,379,584 parameters); one superblock (8 layers, 90.5 GB) does not fit
HYBRID_LAYERS, HYBRID_BYTES = 4, 46_042_759_168
HYBRID_PARITY_LAYERS = 2     # the parity leg: Mamba, then Mamba + MoE (48.7 GB in f32)
HYBRID_INT8_LAYERS = 8       # one whole superblock with int8 weights (48.7 GB on the card)


MAMBA_LABEL = "mamba_mixer"   # the record_function range around each Mamba mixer call
QEINSUM_LABEL = "qeinsum"     # and around each qeinsum call (every int8 product)
# the device operations inside the qeinsum ranges of an int8 tree, by kernel
# name: the int8 -> bf16 weight copies, the scale-and-round multiplies, and
# the rest (cuBLAS products)
INT8_PARTS = (("copies", "copy"), ("scales", "Mul"))


def install_mamba(wrap):
    """Wrap the Mamba mixer that ``transformer`` calls; returns the undo."""
    from repro_torch.models import transformer as tf

    defs, cache_defs, mixer = tf.RECURRENT["mamba"]
    tf.RECURRENT["mamba"] = (defs, cache_defs, wrap(mixer))
    return lambda: tf.RECURRENT.__setitem__("mamba", (defs, cache_defs, mixer))


def install_qeinsum(wrap):
    """Wrap ``qeinsum`` where the model modules call it; returns the undo."""
    from repro_torch.models import attention, loss, mlp, moe, quant

    mods, orig = (attention, loss, mlp, moe), quant.qeinsum
    for m in mods:
        m.qeinsum = wrap(orig)
    return lambda: [setattr(m, "qeinsum", orig) for m in mods]


def range_share(torch, step, installs: dict, n: int = PROFILED_STEPS) -> dict:
    """``n`` calls of ``step`` (a decode step), profiled, with each function
    that an ``installs`` entry wraps called inside a record_function range
    of its label: for each label the calls, device operations and device
    time a step that the CPU ops inside those ranges launched (kernels,
    copies, sets), and that device time by kernel name; beside it the
    step's own device operations and time."""
    from torch.autograd import DeviceType

    def labelled(label):
        def wrap(fn):
            def call(*args, **kw):
                with torch.profiler.record_function(label):
                    return fn(*args, **kw)
            return call
        return wrap

    def kernels(e):
        return list(e.kernels) + [k for c in e.cpu_children for k in kernels(c)]

    step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    undo = [install(labelled(label)) for label, install in installs.items()]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                step()
            torch.cuda.synchronize()
    finally:
        for u in undo:
            u()
    events = prof.events()
    on_card = [e for e in events if e.device_type != DeviceType.CPU and e.name not in installs]
    out = {"step_ops": len(on_card) / n, "step_device_us": sum(e.time_range.elapsed_us() for e in on_card) / n}
    for label in installs:
        ranges = [e for e in events if e.device_type == DeviceType.CPU and e.name == label]
        mk = [k for r in ranges for k in kernels(r)]
        by_name = {}
        for k in mk:
            by_name[k.name] = by_name.get(k.name, 0.0) + k.duration / n
        out[label] = {"calls": len(ranges) / n, "ops": len(mk) / n,
                      "device_us": sum(k.duration for k in mk) / n, "by_name": by_name}
    return out


def mamba_share(torch, step, n: int = PROFILED_STEPS) -> dict:
    """The Mamba layers' share of ``n`` calls of ``step`` (a paged decode
    step), read from those steps' own profile: each Mamba mixer call runs
    inside a record_function range, and the device operations (kernels,
    copies, sets) that the CPU ops inside those ranges launched are counted
    and timed beside all of the steps' device operations."""
    r = range_share(torch, step, {MAMBA_LABEL: install_mamba}, n)
    return dict(r[MAMBA_LABEL], step_ops=r["step_ops"], step_device_us=r["step_device_us"])


def int8_split(torch, cfg, step, n: int = PROFILED_STEPS) -> dict:
    """An int8-weight decode step's device time split, from the step's own
    profile: inside the ``qeinsum`` ranges the int8 -> bf16 weight copies,
    the products and the scale multiplies; inside the Mamba ranges (a
    hybrid) the mixers; the rest of the step (attention, norms, routing,
    the combine). Logged; returned in us a step."""
    installs = {QEINSUM_LABEL: install_qeinsum}
    if "mamba" in cfg.block_pattern:
        installs[MAMBA_LABEL] = install_mamba
    r = range_share(torch, step, installs, n)
    q = r[QEINSUM_LABEL]
    parts = {name: 0.0 for name, _ in INT8_PARTS}
    parts["products"] = 0.0
    for kname, us in q["by_name"].items():
        part = next((name for name, key in INT8_PARTS if key in kname), "products")
        parts[part] += us
    mamba = {k: v for k, v in r.get(MAMBA_LABEL, {"device_us": 0.0, "calls": 0, "ops": 0}).items()
             if k != "by_name"}
    split = dict(parts, mamba=mamba, qeinsum_calls=q["calls"], step=r["step_device_us"], step_ops=r["step_ops"],
                 rest=r["step_device_us"] - q["device_us"] - mamba["device_us"])
    top = sorted(q["by_name"].items(), key=lambda kv: -kv[1])[:3]
    log(f"  {cfg.name} {cfg.n_layers}L int8-weight decode step, device time split ({n} profiled steps, "
        f"us a step): int8 -> bf16 weight copies {parts['copies']:.1f}, products {parts['products']:.1f}, "
        f"scale multiplies {parts['scales']:.1f} ({q['calls']:g} qeinsum calls), Mamba mixers "
        f"{mamba['device_us']:.1f} ({mamba['calls']:g} calls, {mamba['ops']:g} device operations), the rest "
        f"{split['rest']:.1f}, of "
        f"{r['step_device_us']:.1f} ({r['step_ops']:g} device operations); largest in the qeinsum ranges: "
        + "; ".join(f"{us:.1f} us {k[:70]}" for k, us in top))
    if q["calls"] == 0 or parts["copies"] <= 0:
        raise AssertionError(f"{cfg.name} int8 step: no int8 product seen in the profile: {split}")
    return split


def phase_hybrid(torch, dev) -> dict:
    """jamba-1.5-large at FULL width in bf16, cut to the first HYBRID_LAYERS
    layers of its superblock, every earlier tree off the card: drawn on the
    card by the blocked init (conv_b, dt_bias and A_log standard normal; its
    bytes against the reckoning, its peak below the tree + 4 GiB); a batch-8
    paged step (2L + 1 rmsnorm and one paged decode launch), the Mamba
    layers' share of its profile (``mamba_share``); a batch-4 dense step
    (one decode_attention); launch/serve.main() with --layers and 32
    requests (whole-prompt); the pools phase's 8 prompts whole-prompt on an
    int8 chained pool (flash, the quantizing write, the Mamba scan in 2
    chunks at bucket 256) and in 32-token chunks on a bf16 flat pool (the
    Mamba carry across chunks), 0 failures; then the tree is freed."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import first_layers

    arch = "jamba-1.5-large-398b"
    full = get_config(arch)
    cfg = first_layers(full, HYBRID_LAYERS)
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = seeded_params(torch, cfg, dev, 0)
    torch.cuda.synchronize()
    t_draw, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    tb = sum(t.numel() * t.element_size() for t in _leaves(params))
    m = cfg.mamba
    log(f"  {arch} FULL width, {HYBRID_LAYERS} of {full.n_layers} layers {cfg.block_pattern}, MoE on "
        f"{[i for i in range(HYBRID_LAYERS) if cfg.layer_has_moe(i)]}: d_model {cfg.d_model}, {cfg.n_heads} "
        f"query heads over {cfg.n_kv_heads} KV heads (G = {cfg.n_heads // cfg.n_kv_heads}), hd {cfg.hd}, "
        f"d_inner {m.expand * cfg.d_model}, d_state {m.d_state}, chunk {m.chunk}, {cfg.moe.n_experts} experts "
        f"top-{cfg.moe.top_k}, d_ff {cfg.d_ff}; {n_params(cfg)} parameters, {tb} B in bf16 (reckoned "
        f"{HYBRID_BYTES} B), drawn on the card in {t_draw:.3f} s; max_memory_allocated {peak} B "
        f"({peak / 2**30:.3f} GiB; {before / 2**30:.3f} GiB allocated before), tree + 4 GiB = "
        f"{(tb + 4 * 2**30) / 2**30:.3f} GiB")
    if not tb == HYBRID_BYTES == 2 * n_params(cfg):
        raise AssertionError(f"{arch} {HYBRID_LAYERS}L: {tb} B, reckoned {HYBRID_BYTES}, {n_params(cfg)} parameters")
    if peak >= tb + 4 * 2**30:
        raise AssertionError(f"{arch} init peak {peak} B, not below the tree {tb} B + 4 GiB")
    per = phase_step(torch, cfg, params, dev, after=lambda eng: mamba_share(torch, eng.step))
    check_step(arch, cfg, per["decode step"])
    step, mamba = per["timing"], per["after"]
    n_mamba = cfg.block_pattern.count("mamba")
    if mamba["calls"] != n_mamba:
        raise AssertionError(f"{arch}: {mamba['calls']} Mamba mixer calls a paged step, expected {n_mamba}")
    linked = (f"{mamba['ops']:g} of its {mamba['step_ops']:g} device operations "
              f"({mamba['ops'] / max(mamba['step_ops'], 1):.4f}) and {mamba['device_us']:.1f} of its "
              f"{mamba['step_device_us']:.1f} us on the device "
              f"({mamba['device_us'] / max(mamba['step_device_us'], 1e-9):.4f})"
              if mamba["ops"] else "not measured (the profiler linked no device operation to the ranges)")
    log(f"  the paged step's {n_mamba} Mamba mixer calls, from the step's own profile ({PROFILED_STEPS} "
        f"steps, each call in a record_function range): {linked}")
    steps = {"paged": dict(step, mamba=mamba), "dense": dense_step(torch, cfg, params, dev)[2]}
    counts = {"jamba_launcher_whole_prompt": launcher_leg(
        torch, 0, params, arch, ("decode_attention", "flash_attention", "rmsnorm"),
        ("--layers", str(HYBRID_LAYERS)))[1]}
    for name, args, keys in (
            ("pools_int8_chained", ("int8", True, 0),
             ("flash_attention", "paged_prefill_write_quant", "paged_attention[int8+chained]")),
            ("pools_bf16_flat_chunk32", ("bf16", False, 32), ("paged_prefill_write", "paged_attention[flat]"))):
        run = pools_run(torch, cfg, params, dev, *args)
        check_served(f"jamba {name}", run)
        for key in keys:
            if run["counts"][key] <= 0:
                raise AssertionError(f"{key} was not launched in jamba {name}")
        counts[f"jamba_{name}"] = run["counts"]
    del params
    free_card(torch)
    t0 = time.perf_counter()
    hybrid_int8(torch, dev, counts, steps)
    log(f"  jamba int8 superblock leg: {time.perf_counter() - t0:.1f} s")
    return {"counts": counts, "steps": steps}


def hybrid_int8(torch, dev, counts, steps) -> None:
    """jamba-1.5-large's whole first superblock (HYBRID_INT8_LAYERS layers:
    7 Mamba, 1 attention, 4 MoE FFNs) at FULL width with int8 weights drawn
    on the card (``int8_drawn``): a batch-8 paged step (2L + 1 rmsnorm, one
    paged decode; time, busy share) and its device split (``int8_split``:
    the weight copies, the products, the 7 Mamba mixer calls), a batch-4
    dense step, launch/serve.main() --weights-int8 --layers 8 with 32
    requests (whole-prompt) and the pools phase's 8 prompts whole-prompt on
    an int8 chained pool, 0 failures; then the tree is freed."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import first_layers

    arch = "jamba-1.5-large-398b"
    cfg = first_layers(get_config(arch), HYBRID_INT8_LAYERS).replace(weights_int8=True)
    params = int8_drawn(torch, cfg, dev)
    per = phase_step(torch, cfg, params, dev, after=lambda eng: int8_split(torch, cfg, eng.step))
    check_step(f"{arch} int8", cfg, per["decode step"])
    n_mamba = cfg.block_pattern.count("mamba")
    if per["after"]["mamba"]["calls"] != n_mamba:
        raise AssertionError(f"{arch} int8: {per['after']['mamba']['calls']} Mamba mixer calls a paged step, "
                             f"expected {n_mamba}")
    steps["int8_paged"] = dict(per["timing"], split=per["after"])
    steps["int8_dense"] = dense_step(torch, cfg, params, dev)[2]
    counts["jamba_int8_launcher_whole_prompt"] = launcher_leg(
        torch, 0, params, arch, ("decode_attention", "flash_attention", "rmsnorm"),
        ("--weights-int8", "--layers", str(HYBRID_INT8_LAYERS)))[1]
    run = pools_run(torch, cfg, params, dev, "int8", True)
    check_served("jamba int8 superblock pools_int8_chained", run)
    for key in ("flash_attention", "paged_prefill_write_quant", "paged_attention[int8+chained]"):
        if run["counts"][key] <= 0:
            raise AssertionError(f"{key} was not launched in the jamba int8 superblock pools run")
    counts["jamba_int8_pools_int8_chained"] = run["counts"]
    del params
    free_card(torch)


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
    return teacher_forced_batch(torch, cfg, params, [prompt], [out], layout)[0]


def teacher_forced_batch(torch, cfg, params, prompts, outs, layout: str):
    """``teacher_forced_rows`` for streams of one prompt length and one
    output length, decoded together: a dense cache of len(prompts) slots,
    or one paged pool with a row of pages a stream (each prompt prefilled
    into its row). Returns one (len(out), V) tensor a stream."""
    from repro_torch.models import attention as attn
    from repro_torch.models import get_model
    from repro_torch.models import transformer as tf
    from repro_torch.models.rotary import positions_for

    model = get_model(cfg)
    B, L = len(prompts), len(prompts[0])
    if {len(p) for p in prompts} != {L} or len({len(o) for o in outs}) != 1:
        raise ValueError("teacher_forced_batch: streams of unequal lengths")
    n = L + len(outs[0])
    prompt_t = torch.tensor(prompts)
    if layout == "dense":
        cache = model.init_cache(B, n, "cpu")
        h, cache = tf.forward(cfg, params, prompt_t, positions_for(B, L), mode="prefill", cache=cache,
                              cache_index=0)
    else:
        pages = -(-n // 16)
        cache = model.init_paged_cache(1 + B * pages, 16, "cpu")
        rows_t = torch.arange(1, 1 + B * pages, dtype=torch.int32).view(B, pages)
        hs = []
        for b in range(B):
            h, cache = tf.forward(cfg, params, prompt_t[b:b + 1], positions_for(1, L), mode="prefill",
                                  cache=cache, cache_index=attn.PagedPrefillIndex(rows_t[b], 0))
            hs.append(h)
        h = torch.cat(hs)
    rows = [model.logits(params, h[:, -1])]
    for j in range(len(outs[0]) - 1):
        pos = torch.full((B,), L + j, dtype=torch.int32)
        idx = pos if layout == "dense" else attn.PagedIndex(pos, rows_t)
        tok = torch.tensor([[o[j]] for o in outs])
        h, cache = tf.forward(cfg, params, tok, pos[:, None], mode="decode", cache=cache, cache_index=idx)
        rows.append(model.logits(params, h[:, -1]))
    return list(torch.stack(rows, 1))


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
        """The tree on the host in f32, each leaf copied over in its own
        dtype and converted there, so that the card never holds an f32 copy
        of a leaf; int8 weight values stay int8."""
        return _map(t, lambda x: x.cpu() if x.dtype == self.torch.int8 else x.cpu().float())

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

    def batch_rows(self, model, params, prompts, outs):
        """``rows`` for many streams, those of equal prompt and output
        lengths in one forward. Returns one (len(out), V) tensor a stream."""
        res, groups = [None] * len(prompts), {}
        for i, (p, o) in enumerate(zip(prompts, outs)):
            groups.setdefault((len(p), len(o)), []).append(i)
        for (lp, _), idx in groups.items():
            h = model.hidden(params, [prompts[i] + outs[i][:-1] for i in idx])
            lg = model.logits(params, h[:, lp - 1:])
            for k, i in enumerate(idx):
                res[i] = lg[k]
        return res

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
            cfgl = par.f32(r["cfg"])             # the launcher's depth (--layers)
            for rid in rids:
                prompt, out = r["prompts"][rid], r["results"][rid]
                par.check("smollm launcher", rid,
                          teacher_forced_rows(torch, cfgl, p32, prompt, out, "dense"), out)
        cfg8 = cfg32.replace(kv_quant=True)
        run = pools["int8_chained"]
        for i in (0, 7):
            prompt, out = run["prompts"][i], run["outs"][i]
            par.check("smollm pools int8", i,
                      teacher_forced_rows(torch, cfg8, p32, prompt, out, "paged"), out)


def first_divergence(label: str, a_outs, b_outs, rows) -> None:
    """Log, per stream, the first step where two streams of one context
    part and the CPU f32 lead of the first stream's token over the other's
    there (``rows``: the first stream's teacher-forced CPU rows)."""
    same = 0
    for i, (a, b) in enumerate(zip(a_outs, b_outs)):
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            same += 1
            continue
        lead = float(rows[i][j][a[j]] - rows[i][j][b[j]])
        log(f"  divergence {label} stream {i}: step {j}, {a[j]} against {b[j]}, CPU f32 lead "
            f"of the first {lead:.4f}")
    log(f"  {label}: {same} of {len(a_outs)} streams identical")


def parity_options(torch, par, opts):
    """Every spec-on and warm stream of the options phase against the CPU f32
    forward (the int8 spec leg through a paged int8 pool, its 8 streams
    decoded together step by step),
    held to FLIP_BOUND; then the first divergence of spec on from spec off
    and of warm from cold, with the CPU's lead at that step."""
    from repro_torch.models import get_model

    cfg32 = par.f32(opts["cfg"])
    p32 = par.to_cpu(opts["params"])
    model = get_model(cfg32)
    spec, prefix = opts["spec"], opts["prefix"]
    rows = {}
    with torch.no_grad():
        for key in ("paged_on", "dense_on"):
            r = spec[key]
            rows[key] = par.batch_rows(model, p32, r["prompts"], r["outs"])
            for i, out in enumerate(r["outs"]):
                par.check(f"smollm-options {r['name']}", i, rows[key][i], out)
        r = spec["paged_int8"]
        cfg8 = cfg32.replace(kv_quant=True)
        int8_rows = teacher_forced_batch(torch, cfg8, p32, r["prompts"], r["outs"], "paged")
        for i, (rows_i, out) in enumerate(zip(int8_rows, r["outs"])):
            par.check(f"smollm-options {r['name']}", i, rows_i, out)
        for key in ("on_chunk0", "on_chunk32"):
            r = prefix[key]
            for t, (prompts, outs) in enumerate(r["turns"]):
                trows = par.batch_rows(model, p32, prompts, outs)
                rows[key, t] = trows
                for c, out in enumerate(outs):
                    par.check(f"smollm-options {r['name']}", f"c{c}t{t}", trows[c], out)
    for on, off in (("paged_on", "paged_off"), ("dense_on", "dense_off")):
        first_divergence(f"{spec[on]['name']} vs {spec[off]['name']}", spec[on]["outs"],
                         spec[off]["outs"], rows[on])
    for t, ((wp, wo), (cp, co)) in enumerate(zip(prefix["on_chunk0"]["turns"], prefix["off"]["turns"])):
        idx = [c for c in range(len(wp)) if wp[c] == cp[c]]
        first_divergence(f"warm vs cold turn {t + 1} (conversations {idx}, same prompts)",
                         [wo[c] for c in idx], [co[c] for c in idx],
                         [rows["on_chunk0", t][c] for c in idx])
    r = spec["paged_on"]
    log(f"  spec accepted / proposed: paged {r['accepted']} / {r['proposed']}, int8 "
        f"{spec['paged_int8']['accepted']} / {spec['paged_int8']['proposed']}, dense "
        f"{spec['dense_on']['accepted']} / {spec['dense_on']['proposed']}")


def parity_xlstm(torch, par, xlstm):
    """xlstm-350m against the CPU f32 whole-sequence forward (chunkwise mLSTM
    from zero state). The f32 legs on the card are held to FLIP_BOUND. The
    bf16 legs' leads are recorded: bf16 alone moves this model's logits by
    tenths (its exponential gates and head-wise norms amplify rounding, in
    the JAX package alike), which the CPU's own bf16 forward over the
    launcher's requests measures here beside them."""
    from repro_torch.models import get_model

    model = get_model(par.f32(xlstm["cfg"]))
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
            cut, cut16 = get_model(par.f32(r["cfg"])), get_model(r["cfg"])    # the launcher's depth
            for rid in rids:
                prompt, out = r["prompts"][rid], r["results"][rid]
                rows = par.rows(cut, p32, prompt, out)
                par.check("xlstm-bf16 launcher", rid, rows, out, bound=False)
                rows16 = par.rows(cut16, p16, prompt, out).float()
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


def parity_glm4(torch, par, glm4):
    """glm4-9b at FULL width, 4 layers: the dense engine's streams through
    the dense cache step by step, the bf16 chunked paged streams through the
    whole-sequence forward, the int8 chained paged streams through a paged
    int8 pool step by step, all on the CPU in f32, held to FLIP_BOUND."""
    from repro_torch.models import get_model

    cfg32 = par.f32(glm4["cfg"])
    p32 = par.to_cpu(glm4["params"])
    model = get_model(cfg32)
    served = glm4["served"]
    with torch.no_grad():
        r = served["dense"]
        for i in (0, 3, 7):
            par.check("glm4-4L dense", i, teacher_forced_rows(torch, cfg32, p32, r["prompts"][i],
                                                              r["outs"][i], "dense"), r["outs"][i])
        r = served["bf16"]
        for i, (rows, out) in enumerate(zip(par.batch_rows(model, p32, r["prompts"], r["outs"]), r["outs"])):
            par.check("glm4-4L pools bf16 chunk32", i, rows, out)
        r = served["int8"]
        cfg8 = cfg32.replace(kv_quant=True)
        for i in (0, 7):
            par.check("glm4-4L pools int8 chained", i, teacher_forced_rows(
                torch, cfg8, p32, r["prompts"][i], r["outs"][i], "paged"), r["outs"][i])


def parity_int8w(torch, par, int8w):
    """granite-8b (bf16 and int8 weights) and qwen1.5-32b (int8 weights) at
    FULL width, 2 layers: the dense engine's 8 streams through the
    whole-sequence forward, the first int8 chained paged stream (a
    120-token prompt) through a paged int8 pool step by step, on the CPU in
    f32 (``qeinsum`` in f32 on the int8 values), held to FLIP_BOUND."""
    from repro_torch.models import get_model

    with torch.no_grad():
        for name, r in int8w["served"].items():
            cfg32 = par.f32(r["cfg"])
            p32 = par.to_cpu(r["params"])
            model = get_model(cfg32)
            d = r["dense"]
            for i, (rows, out) in enumerate(zip(par.batch_rows(model, p32, d["prompts"], d["outs"]),
                                                d["outs"])):
                par.check(f"{name} dense", i, rows, out)
            d = r["int8"]
            par.check(f"{name} pools int8 chained", 0, teacher_forced_rows(
                torch, cfg32.replace(kv_quant=True), p32, d["prompts"][0], d["outs"][0], "paged"),
                d["outs"][0])


def parity_stubs(torch, par, stubs):
    """qwen2-vl-2b at 4 layers and whisper at 4 + 4 layers, FULL width, in
    bf16 and with int8 weights, on the CPU in f32 (``qeinsum`` in f32 on the
    int8 values): the qwen dense engine's 8 streams and its image prompt's
    two streams (the prompt's embeddings and positions, then each served
    token's embedding at the next cache index in all three streams) through
    the whole-sequence forward, whisper's 4 streams through the encoder and
    the decoder's whole-sequence forward; held to FLIP_BOUND."""
    from repro_torch.models import get_model

    with torch.no_grad():
        for tag in ("", "_int8"):
            t0 = time.perf_counter()
            q, w = stubs["served"]["qwen" + tag], stubs["served"]["whisper" + tag]
            label = "-int8w" if tag else ""
            cfg32, p32 = par.f32(q["cfg"]), par.to_cpu(q["params"])
            model = get_model(cfg32)
            d = q["dense"]
            for i, (rows, out) in enumerate(zip(par.batch_rows(model, p32, d["prompts"], d["outs"]), d["outs"])):
                par.check(f"qwen2vl-4L{label} dense chunk32", i, rows, out)
            im = q["image"]
            B, S = im["emb"].shape[:2]
            outs = torch.tensor(im["outs"])
            n = outs.shape[1] - 1
            emb = torch.cat([im["emb"].float(), p32["embedding"][outs[:, :-1]]], 1)
            pos = torch.cat([im["pos"], torch.arange(S, S + n, dtype=torch.int32)[None, None].expand(3, B, n)], 2)
            rows = model.logits(p32, model.hidden(p32, inputs_embeds=emb, positions=pos)[:, S - 1:])
            for b in range(B):
                par.check(f"qwen2vl-4L{label} image", b, rows[b], im["outs"][b])
            cfg32, p32, r = par.f32(w["cfg"]), par.to_cpu(w["params"]), w["run"]
            model = get_model(cfg32)
            P = len(r["prompts"][0])
            h = model.hidden(p32, [p + o[:-1] for p, o in zip(r["prompts"], r["outs"])], r["frames"].float())
            rows = model.logits(p32, h[:, P - 1:])
            for b, out in enumerate(r["outs"]):
                par.check(f"whisper-4+4L{label}", b, rows[b], out)
            log(f"  parity stubs, {'int8 weights' if tag else 'bf16'}: {time.perf_counter() - t0:.1f} s")


def moe_replay_parity(torch, par, p32, r, name: str) -> None:
    """One parity leg: the CPU replays the card's prefill and decode steps
    teacher-forced (``teacher_forced_batch``, a dense cache), its routing
    recorded and held to the card's by ``routing_check``. Rows that no
    routing difference moved are held to FLIP_BOUND; the others are
    recorded without the bound."""
    cfg32 = par.f32(r["cfg"])
    with RoutingLog() as rl:
        rows = teacher_forced_batch(torch, cfg32, p32, r["prompts"], r["outs"], "dense")
    moved, st = routing_check(torch, cfg32, r["calls"], rl.calls, len(r["prompts"]), len(r["prompts"][0]))
    d = drop_share(torch, cfg32, rl.calls)
    card = sum(v["dropped"] for v in r["dropped"].values())
    log(f"  {name}: {len(rl.calls)} MoE calls, CPU {d['dropped']} of {d['assignments']} assignments dropped "
        f"(card {card}); routing differs from the card's in {st['calls']} calls (first {st['first']}), "
        f"{st['decisions']} decisions at a near-tie (widest CPU gap {st['widest']:.6f}, ROUTE_GAP "
        f"{ROUTE_GAP}), {st['excused']} after moved inputs; {int(moved.sum())} of {moved.numel()} rows moved")
    for i, (rows_i, out) in enumerate(zip(rows, r["outs"])):
        held, after = (~moved[i]).nonzero().flatten().tolist(), moved[i].nonzero().flatten().tolist()
        par.check(name, i, rows_i[held], [out[j] for j in held])
        if after:
            par.check(f"{name}-after-routing-difference", i, rows_i[after], [out[j] for j in after], bound=False)


STAGE = 1 << 28     # bf16 values the pinned staging buffer carries to the host at a time (512 MiB)


class HostArena:
    """One flat f32 buffer on the host that the replayed legs' trees take
    turns in, each leaf a view of it, carried over through one pinned bf16
    staging buffer. Pages this process has touched once stay with it, so a
    later leg neither waits for the memory an earlier one freed (it comes
    back to MemAvailable only seconds later) nor pays again for touching
    fresh pages, which cost more than the copy itself."""

    def __init__(self, torch, n: int):
        self.torch = torch
        self.flat = torch.empty(n, dtype=torch.float32)
        self.stage = torch.empty(STAGE, dtype=torch.bfloat16, pin_memory=True)

    def tree(self, tree):
        """``tree`` (on the card) in f32 in the arena, from its start; the
        tree it held before is overwritten."""
        off = 0

        def put(x):
            nonlocal off
            dst = self.flat[off:off + x.numel()]
            off += x.numel()
            src = x.reshape(-1)
            if x.dtype != self.torch.bfloat16:
                dst.copy_(src)
                return dst.view(x.shape)
            for a in range(0, x.numel(), STAGE):
                m = min(STAGE, x.numel() - a)
                self.stage[:m].copy_(src[a:a + m])
                dst[a:a + m].copy_(self.stage[:m])
            return dst.view(x.shape)

        return _map(tree, put)

    def quantized(self, card, host):
        """``quantize_params`` of ``card`` (a tree on the card), computed
        there a (d, f) slice at a time, its int8 values written over
        ``host`` (the arena's f32 copy of the same tree, from ``tree``) as
        f32 (the same numbers, read by the CPU's f32 products without a
        copy) and its bf16 scales on the host; ``host``'s other leaves as
        they are. The card computes the bits it computed for the int8
        replay: each channel's scale reads its own column alone."""
        from repro_torch.models.quant import QUANT_LEAVES, _quantize_into, scale_shape

        torch = self.torch

        def walk(c, h, key=""):
            if isinstance(c, dict):
                return {k: walk(c[k], h[k], k) for k in c}
            if key not in QUANT_LEAVES or c.ndim < 2:
                return h
            d, f = c.shape[-2:]
            s = torch.empty(scale_shape(c.shape), dtype=torch.bfloat16)
            q_card = torch.empty((d, f), dtype=torch.int8, device=c.device)
            s_card = torch.empty((1, f), dtype=torch.bfloat16, device=c.device)
            cs, hs, ss = c.reshape(-1, d, f), h.view(-1, d, f), s.view(-1, 1, f)
            for i in range(cs.shape[0]):
                _quantize_into(cs[i], q_card, s_card)
                hs[i].copy_(q_card)
                ss[i].copy_(s_card)
            return {"q": h, "s": s}

        return walk(card, host)


def parity_moe(torch, par, moe) -> None:
    """The MoE legs, each a replay held by ``moe_replay_parity``, each tree
    brought to the host in f32 in turn in one ``HostArena``, sized for the
    largest, once the host has room for it (``host_room``): J
    (jamba-1.5-large 2L, no drop possible) and J8 (the same with int8
    weights), C (llama4 1L, no drop possible), then A (dbrx 2L, no drop
    possible), B (the same weights at binding capacity) and A8 (A with int8
    weights). An int8 leg's tree is its float legs', quantized into the
    arena over it (``HostArena.quantized``), so it runs last on that tree.
    Every leg runs."""
    legs = (("J and J8", "jamba", "jamba 2L", (("J", "jamba-2L-J"), ("J8", "jamba-2L-J8"))),
            ("C", "llama4", "llama4 1L", (("C", "llama4-1L-C"),)),
            ("A, B and A8", "dbrx", "dbrx 2L", (("A", "dbrx-2L-A"), ("B", "dbrx-2L-B"), ("A8", "dbrx-2L-A8"))))
    n = max(sum(t.numel() for t in _leaves(moe["served"][m]["params"])) for _, m, _, _ in legs)
    t0 = time.perf_counter()
    room = host_room(4 * n + LEG_MARGIN)
    arena = HostArena(torch, n)
    log(f"  parity arena: {n} f32 values ({4 * n} B), {time.perf_counter() - t0:.1f} s for the room: {room}")
    with torch.no_grad():
        for leg, model, label, runs in legs:
            t0 = time.perf_counter()
            m = moe["served"][model]
            p32 = arena.tree(m["params"])
            t1 = time.perf_counter()
            times = []
            for key, name in runs:
                t2 = time.perf_counter()
                if key.endswith("8"):
                    p32 = arena.quantized(m["params"], p32)
                    times.append(f"int8 tree into the arena {time.perf_counter() - t2:.1f} s")
                    t2 = time.perf_counter()
                moe_replay_parity(torch, par, p32, m[key], name)
                times.append(f"{key} replay {time.perf_counter() - t2:.1f} s")
            m["params"] = None
            del p32
            free_card(torch)
            log(f"  parity legs {leg} ({label}): {time.perf_counter() - t0:.1f} s (f32 tree in the arena "
                f"{t1 - t0:.1f} s; {'; '.join(times)}); host MemAvailable {mem_available()} B")
    del arena
    log(f"  parity arena freed: {release_host()}")


def drop_trees(*runs) -> None:
    """Drop the weights the runs hold (every nested ``params``), so that the
    host can take the MoE legs' f32 trees."""

    def walk(x):
        if isinstance(x, dict):
            if "params" in x:
                x["params"] = None
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    for r in runs:
        walk(r)


def _map(tree, fn):
    return {k: _map(v, fn) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def offload(torch, runs) -> None:
    """Move the weights each run holds (``run["params"]``) to the host, one
    copy per tree however many runs share it, and release the card's cache."""
    import gc

    moved = {}
    for r in runs:
        key = id(r["params"])
        if key not in moved:
            moved[key] = _map(r["params"], lambda t: t.cpu())
        r["params"] = moved[key]
    gc.collect()
    torch.cuda.empty_cache()


PLACE_F, PLACE_D = 1200.0, 1e6     # the default Thresholds: the paper's knee and payload split


def place_along(pol, reqs, rates, flask_free: int, docker_free: int) -> list:
    """``place_all``'s loop with each request's own rate: ``place`` per
    request, availability consumed by each flask and docker decision."""
    from repro_torch.core import Tier

    out = []
    for r, f in zip(reqs, rates):
        t = pol.place(r, float(f), flask_free, docker_free).tier
        flask_free -= t == Tier.FLASK
        docker_free -= t == Tier.DOCKER
        out.append(int(t))
    return out


def sched_placer(torch, dev) -> None:
    """``placing_batch_torch`` on the card against the Python loop of
    ``StraightLinePolicy``, exactly: at N 1024 with the placement twin's
    arguments, and at the paper's top ramp (7000 bimodal sessions a 180 s
    window) with the window estimator's rate along the arrivals, and with
    scalar rates through ``place_all`` itself. Sizes are rounded to float32
    before the loop sees them, as the placer compares in float32. Then its
    CUDA-event and device times, device operations per call and bytes
    bound at N 1024, 7000 and 2**20, beside the loop's host time."""
    import numpy as np

    from repro_torch.core import Request, StraightLinePolicy, Thresholds
    from repro_torch.core.placing import placing_batch_torch
    from repro_torch.core.telemetry import FrequencyEstimator
    from repro_torch.core.workload import ramp

    pol = StraightLinePolicy(Thresholds(F=PLACE_F, D=PLACE_D))

    def on_card(f_t, sizes, ff, df):
        out = placing_batch_torch(f_t, sizes, ff, df, F=PLACE_F, D=PLACE_D)
        if out.device.type != "cuda" or out.dtype != torch.int32 or out.shape != sizes.shape:
            raise AssertionError(f"placer output on {out.device}, {out.dtype}, {tuple(out.shape)}")
        return out.tolist()

    reqs = [Request(rid=i, arrival_t=0.0, data_size=1e5) for i in range(1024)]
    want = [int(d.tier) for d in pol.place_all(reqs, 900.0, 4, 8)]
    if on_card(900.0, torch.full((1024,), 1e5, dtype=torch.float32, device=dev), 4, 8) != want:
        raise AssertionError("placer on the card != place_all at N 1024")

    wl = ramp(7000, dist="bimodal", seed=7000)
    fe, rates = FrequencyEstimator(window_s=180.0), []
    for r in wl:
        fe.observe(r.arrival_t)
        rates.append(fe.frequency(r.arrival_t))
    sizes32 = np.array([r.data_size for r in wl], np.float32)
    reqs = [Request(rid=i, arrival_t=r.arrival_t, data_size=float(s)) for i, (r, s) in enumerate(zip(wl, sizes32))]
    sizes = torch.from_numpy(sizes32).to(dev)
    f_dev = torch.tensor(rates, dtype=torch.float32, device=dev)
    tally = {}
    for ff, df in ((0, 0), (4, 8), (64, 512)):
        got = on_card(f_dev, sizes, ff, df)
        if got != place_along(pol, reqs, rates, ff, df):
            raise AssertionError(f"placer on the card != the loop at N 7000, availability ({ff}, {df})")
        for ft in (900.0, 5000.0):
            if on_card(ft, sizes, ff, df) != [int(d.tier) for d in pol.place_all(reqs, ft, ff, df)]:
                raise AssertionError(f"placer on the card != place_all at N 7000, f_t {ft}, ({ff}, {df})")
        tally[f"({ff}, {df})"] = [got.count(t) for t in range(3)]
    log(f"  placer == Python loop on the card: N 1024 (f_t 900, (4, 8)); N 7000 ramp, rate 1-{rates[-1]:.0f} "
        f"along the arrivals and f_t 900 / 5000; flask/docker/serverless by availability {tally}")

    t0 = time.perf_counter()
    pol.place_all(reqs, 900.0, 4, 8)
    loop_us = (time.perf_counter() - t0) / len(reqs) * 1e6
    g = np.random.default_rng(1)
    for n in (1024, 7000, 2**20):
        if n == 7000:
            s, f = sizes, f_dev
        else:
            big = g.random(n) >= 0.8
            s = torch.from_numpy(np.where(big, g.lognormal(np.log(8e6), 0.4, n),
                                          g.lognormal(np.log(150e3), 0.3, n)).astype(np.float32)).to(dev)
            f = torch.arange(1, n + 1, dtype=torch.float32, device=dev) * (7000.0 / n)
        fn = lambda: placing_batch_torch(f, s, 4, 8, F=PLACE_F, D=PLACE_D)  # noqa: E731
        b_ms = 3 * 4 * n / HBM_BYTES_S * 1e3        # sizes and rates read, ids written, 4 B each
        d = {"events_ms": time_ms(fn), "device_ms": device_ms(fn), "ops": device_ops(fn)}
        log(f"  placing_batch_torch N {n}: {d['events_ms']:.7f} ms (CUDA events, back to back), device "
            f"{d['device_ms']} ms (profiler), {d['ops']:.1f} device operations a call, bytes bound "
            f"{b_ms:.7f} ms; {d['events_ms'] * 1e6 / n:.3f} ns a request")
    log(f"  Python loop (place_all, N 7000) on this host: {loop_us:.4f} us a request")


def sched_gates() -> None:
    """The paper's gates of ``tests/test_system.py`` through the port's
    simulator, at its loads: the interactive knee (Fig 4), the elastic
    memory classes (Fig 5a), StraightLine against every static tier, the
    hedge, the burst on the elastic tier, retry and autoscaler prewarming."""
    from repro_torch.core import SimConfig, Simulation, StaticPolicy, StraightLinePolicy, Tier
    from repro_torch.core.autoscaler import Autoscaler
    from repro_torch.core.testbed import paper_tiers
    from repro_torch.core.workload import burst, ramp

    def run(policy, load, mem="3GB", seed=1, **kw):
        sim = Simulation(policy, paper_tiers(seed=seed, elastic_mem=mem), SimConfig(**kw))
        return sim.run(ramp(load, seed=load)).summary()

    def gate(name: str, ok: bool, got) -> None:
        log(f"  gate {name}: {got}")
        if not ok:
            raise AssertionError(f"paper gate {name} failed: {got}")

    low, knee, high = (run(StaticPolicy(Tier.FLASK), n)["failure_rate"] for n in (800, 1400, 2000))
    gate("knee (Fig 4)", low < 0.05 and knee > 0.15 and high > knee, (low, knee, high))
    two = run(StaticPolicy(Tier.SERVERLESS), 6000, mem="2GB")["failure_rate"]
    three = run(StaticPolicy(Tier.SERVERLESS), 6000, mem="3GB")["failure_rate"]
    gate("memory classes (Fig 5a)", two > 0.25 and three < two * 0.5, (two, three))
    for load, bound_ in ((1400, 0.05), (4000, 0.05), (6000, 0.15)):
        sl = run(StraightLinePolicy(), load)["failure_rate"]
        st = {t.name: run(StaticPolicy(t), load, mem="2GB" if t == Tier.SERVERLESS else "3GB")["failure_rate"]
              for t in Tier}
        gate(f"StraightLine beats every static tier at {load}",
             sl < bound_ and all(sl <= v + 1e-9 for v in st.values()), (sl, st))
    base = run(StraightLinePolicy(), 3000)["p95_response_s"]
    hedged = run(StraightLinePolicy(), 3000, hedge_after_s=2.0)["p95_response_s"]
    gate("hedging", hedged <= base + 0.5, (base, hedged))
    m = Simulation(StraightLinePolicy(), paper_tiers(seed=0), SimConfig()).run(
        burst(background_rate=2.0, burst_rate=120.0, burst_at_s=60, burst_len_s=20, seed=7))
    n_elastic = sum(r.tier == Tier.SERVERLESS for r in m.completed)
    gate("burst on the elastic tier", m.failure_rate < 0.05 and n_elastic > 0, (m.failure_rate, n_elastic))
    plain = run(StaticPolicy(Tier.FLASK), 2500)["failure_rate"]
    retried = run(StaticPolicy(Tier.FLASK), 2500, retry_failed_on_elastic=True)["failure_rate"]
    gate("retry on elastic", retried < plain, (plain, retried))
    wl = dict(background_rate=1.0, burst_rate=80.0, burst_at_s=90, burst_len_s=15, seed=9)
    cold = Simulation(StaticPolicy(Tier.SERVERLESS), paper_tiers(seed=2), SimConfig()).run(burst(**wl))
    warm = Simulation(StaticPolicy(Tier.SERVERLESS), paper_tiers(seed=2),
                      SimConfig(autoscaler=Autoscaler())).run(burst(**wl))
    cold_p95, warm_p95 = cold.summary()["p95_response_s"], warm.summary()["p95_response_s"]
    gate("autoscaler prewarming", warm_p95 <= cold_p95 + 1e-9, (cold_p95, warm_p95))


def phase_sched(torch, dev) -> None:
    """Phase 11: the placer on the card, the paper's gates through the
    port's simulator, then the five figure twins' rows (placement's
    vectorized row timed on the card)."""
    from repro_torch.benchmarks import (fig4_interactive, fig5_elastic, fig6_7_platforms,
                                        fig8_response, placement)

    t0 = time.perf_counter()
    sched_placer(torch, dev)
    t1 = time.perf_counter()
    sched_gates()
    t2 = time.perf_counter()
    for mod in (fig4_interactive, fig5_elastic, fig6_7_platforms, fig8_response):
        mod.main()
    placement.main([])
    log(f"  phase 15 wall time: placer {t1 - t0:.1f} s, gates {t2 - t1:.1f} s, "
        f"figure twins {time.perf_counter() - t2:.1f} s")


# ---------------------------------------------------------------------------
# Phase 16: training
# ---------------------------------------------------------------------------

TRAIN_STEPS, TRAIN_CKPT = 5, 3   # smollm FULL straight run; resumed from the checkpoint at step 3
TRAIN_BATCH, TRAIN_SEQ = 4, 2048  # SmolLM's context
XLSTM_TRAIN = (4, 256, 2)        # xlstm-350m FULL: batch, sequence, steps
PARITY_TRAIN = (2, 256)          # the 2-layer parity leg's batch
RESUME_TOL = TOL["bfloat16"]     # resumed losses against the straight run's (atomics in the embedding backward)
PARITY_F32_REL = 1e-3            # card f32 (TF32 off) against CPU f32: each grad leaf's max |d| / max |CPU|
PARITY_BF16_COS = 0.98           # card bf16 against CPU f32: the least cosine of a grad leaf
PARITY_BF16_LOSS = 0.05          # and the largest loss difference


def grads_vs_plain(torch, fn, plain, inputs, seed: int = 0) -> dict:
    """Outputs and gradients of sum(out * r) (r seeded normals) through
    ``fn`` (the wrapper: the kernel inside its autograd Function) and through
    the plain version's autograd, on the same inputs: the largest scaled
    difference of the outputs and of the gradients, and each path's time
    (forward and backward, CUDA events)."""
    def run(f):
        xs = [x.detach().clone().requires_grad_(x.is_floating_point()) for x in inputs]
        outs = f(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        g = torch.Generator(xs[0].device).manual_seed(seed)
        total = sum((o.float() * torch.randn(o.shape, generator=g, device=o.device)).sum() for o in outs)
        return [o.detach() for o in outs], torch.autograd.grad(total, [x for x in xs if x.requires_grad])

    (ok, gk), (op, gp) = run(fn), run(plain)
    torch.cuda.synchronize()
    return {"out_err": max(scaled_err(a, b) for a, b in zip(ok, op)),
            "grad_err": max(scaled_err(a, b) for a, b in zip(gk, gp)),
            "ms": time_ms(lambda: run(fn), iters=2, reps=3),
            "plain_ms": time_ms(lambda: run(plain), iters=2, reps=3)}


def train_functions(torch, dev) -> dict:
    """(a) The three autograd Functions against the plain versions'
    autograd at training shapes, f32 and bf16: rmsnorm (8192, 960) (4 x
    2048 tokens of smollm), flash (4, 2048, 15, 64) and a ragged S 1999,
    mLSTM at xlstm-350m's (16, 256, 512) in chunks of 64 from a non-zero
    carry, every output carrying a gradient. Each within TOL of the plain
    version's outputs and gradients."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mlstm_chunk import ops as mk_ops
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunkwise_bh_ref
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    g = torch.Generator(dev).manual_seed(16)
    B, H, KV, hd = TRAIN_BATCH, 15, 5, 64
    BH, S_m, DH = 4 * XLSTM_TRAIN[0], XLSTM_TRAIN[1], 512
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        name_dt = str(dt).replace("torch.", "")

        def r(*s, scale=1.0):
            return (torch.randn(s, generator=g, device=dev) * scale).to(dt)

        cases = {"rmsnorm (8192, 960)": (rms_ops.rmsnorm, rmsnorm_ref, (r(8192, 960), 0.5 + r(960).abs()))}
        for S in (TRAIN_SEQ, TRAIN_SEQ - 49):
            cases[f"flash ({B}, {S}, {H}, {hd})"] = (
                fa_ops.flash_attention, lambda q, k, v: fa_ops._plain(q, k, v, "bshd"),
                (r(B, S, H, hd), r(B, S, KV, hd), r(B, S, KV, hd)))
        m_in = mlstm_inputs(torch, g, dev, BH, S_m, DH, dt)
        carry = (torch.randn(BH, DH, DH, generator=g, device=dev) * 0.01,
                 torch.randn(BH, DH, generator=g, device=dev) * 0.01, torch.randn(BH, generator=g, device=dev))
        cases[f"mlstm ({BH}, {S_m}, {DH})"] = (lambda *a: mk_ops.mlstm_chunkwise_bh(*a, chunk=64),
                                               lambda *a: mlstm_chunkwise_bh_ref(*a, chunk=64), (*m_in, *carry))
        for name, (fn, plain, inputs) in cases.items():
            res = grads_vs_plain(torch, fn, plain, inputs)
            out[f"{name} {name_dt}"] = res
            log(f"  train grads {name} {name_dt}: outputs {res['out_err']:.3e}, gradients {res['grad_err']:.3e} "
                f"(tol {TOL[name_dt]:g}); forward + backward {res['ms']:.4f} ms through the kernel's Function, "
                f"{res['plain_ms']:.4f} ms through the plain version (events)")
            if not max(res["out_err"], res["grad_err"]) <= TOL[name_dt]:
                raise AssertionError(f"train grads {name} {name_dt}: {res}")
        free_card(torch)
    return out


def opt_state_reckoning(cfg, state_dtype: str) -> int:
    """Bytes of AdamW's m and v and the step count, from the config's
    parameter shapes: 4 or 2 B a value, or for int8 1 B a value and a 4-B
    scale a block of the last dim (the value itself where no block divides
    it)."""
    from repro_torch.models import get_model
    from repro_torch.train.optimizer import _block_for
    from repro_torch.train.tree import leaves

    total = 4
    for d in leaves(get_model(cfg).param_defs()):
        n = math.prod(d.shape)
        if state_dtype == "int8":
            b = _block_for(d.shape[-1] if d.shape else 1)
            total += 2 * (n + 4 * (n // b if b else n))
        else:
            total += 2 * n * (4 if state_dtype == "float32" else 2)
    return total


def train_run(torch, argv: list, label: str) -> dict:
    """``launch/train.main(argv)`` with the launch counts set to 0 just
    before and read just after, and the peak memory of the run."""
    from repro_torch.launch import train as launch_train

    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    r = launch_train.main(argv)
    torch.cuda.synchronize()
    r["wall"] = time.perf_counter() - t0
    r["counts"] = read_counts()
    r["peak"] = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in r["history"]]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: a loss is not finite: {losses}")
    log(f"  {label}: {r['steps_done']} steps in {r['wall']:.3f} s (launcher wall {r['wall_s']:.3f} s), "
        f"losses {[round(x, 4) for x in losses]}, grad norms {[round(h['grad_norm'], 4) for h in r['history']]}, "
        f"peak {r['peak']} B; launches {r['counts']}")
    return r


def drop_train(*runs) -> None:
    """Drop the parameters and optimizer states a training run holds."""
    for r in runs:
        r["params"] = r["opt_state"] = None


def train_step_profile(torch, cfg, params, opt_state, ocfg) -> dict:
    """A train step's host time (synchronized, one step after a warm-up), tokens a second,
    and its device time and busy share over a profiled step, under the
    config's remat and under remat none (the backward's recompute share:
    the device time the first adds over the second)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import get_model
    from repro_torch.train.data import DataConfig, SyntheticLM

    data = SyntheticLM(DataConfig(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, vocab_size=cfg.vocab_size, seed=9))
    batch = {k: torch.as_tensor(v, device=params["embedding"].device) for k, v in data.batch_at(0).items()}
    state = {"p": params, "o": opt_state}
    out = {}
    for remat in (cfg.remat, "none"):
        fn = make_train_step(get_model(cfg.replace(remat=remat)), ocfg)

        def step():
            state["p"], state["o"], m = fn(state["p"], state["o"], batch)
            return m

        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        prof = profiled_steps(torch, step, n=1)
        out[remat] = {"ms": ms, "tokens_s": TRAIN_BATCH * TRAIN_SEQ / ms * 1e3, **prof}
        log(f"  train step remat={remat}, batch {TRAIN_BATCH} x {TRAIN_SEQ}: {ms:.3f} ms (host clock, synchronized, "
            f"one step), {out[remat]['tokens_s']:.1f} tokens/s; {prof['text']}")
        for e in prof["top"][:8]:
            log(f"    device {e.self_device_time_total / prof['n']:12.1f} us/step  x{e.count / prof['n']:g}/step  "
                f"{e.key[:90]}")
    full, none = out[cfg.remat]["device_us"], out["none"]["device_us"]
    out["recompute_share"] = (full - none) / full if full and none else None
    log(f"  the backward's recompute: {full - none:.1f} us of {full:.1f} us of device time a step "
        f"({out['recompute_share']:.4f}), remat {cfg.remat} against none")
    return out


def train_smollm(torch) -> dict:
    """(b) smollm-360m FULL (32 layers, bf16) through ``launch/train.main``:
    TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens with f32 AdamW states
    under WarmupCosine, a checkpoint every TRAIN_CKPT steps, the loss
    falling (the mean of the later half 0.5 below the first step's); the
    checkpoint at step TRAIN_CKPT resumed in a fresh run, its
    losses within RESUME_TOL of the straight run's; 2 * (2L + 1) - 1 rmsnorm
    and 2L flash launches a step (remat full: the forward's and the
    backward's recompute), no decode kernel; the step's time, tokens a
    second, busy share, peak memory and the recompute's share; then 1 step
    each with bf16 and int8 states, their bytes against the reckoning."""
    import shutil

    from repro_torch.configs.registry import get_config
    from repro_torch.train.optimizer import OptConfig, state_bytes

    cfg = get_config("smollm-360m")
    L = cfg.n_layers
    ckdir = OUT / "train_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    base = ["--arch", "smollm-360m", "--batch-size", str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ),
            "--log-every", "1", "--lr", "1e-3"]
    runs = {}
    straight = runs["train_smollm"] = train_run(
        torch, base + ["--steps", str(TRAIN_STEPS), "--ckpt-every", str(TRAIN_CKPT),
                       "--ckpt-dir", str(ckdir / "straight")], "smollm-360m FULL f32 states, straight")
    per_step = {"rmsnorm": 2 * (2 * L + 1) - 1, "flash_attention": 2 * L}
    for k, n in per_step.items():
        if straight["counts"][k] != TRAIN_STEPS * n:
            raise AssertionError(f"smollm train: {straight['counts'][k]} {k} launches over {TRAIN_STEPS} "
                                 f"steps, expected {n} a step")
    if any(straight["counts"][k] for k in ("paged_attention", "decode_attention", "paged_prefill_write",
                                           "paged_prefill_write_quant", "mlstm_chunkwise")):
        raise AssertionError(f"smollm train launched a serving kernel: {straight['counts']}")
    # each step's loss is over its own batch (it moves by about 1 from batch
    # to batch), so the run's later half is held to the first step's
    losses = [h["loss"] for h in straight["history"]]
    late = statistics.mean(losses[len(losses) // 2:])
    log(f"  loss: first step {losses[0]:.4f}, mean of steps {len(losses) // 2}-{len(losses) - 1} {late:.4f}")
    if not late < losses[0] - 0.5:
        raise AssertionError(f"smollm train: the loss did not fall: {losses}")
    (ckdir / "resume").mkdir(parents=True)
    shutil.copytree(ckdir / "straight" / f"step_{TRAIN_CKPT:08d}", ckdir / "resume" / f"step_{TRAIN_CKPT:08d}")
    resumed = runs["train_smollm_resume"] = train_run(
        torch, base + ["--steps", str(TRAIN_STEPS), "--ckpt-every", str(TRAIN_STEPS + 1),
                       "--ckpt-dir", str(ckdir / "resume")], f"smollm-360m FULL, resumed at step {TRAIN_CKPT}")
    tail = {h["step"]: h["loss"] for h in straight["history"] if h["step"] >= TRAIN_CKPT}
    got = {h["step"]: h["loss"] for h in resumed["history"]}
    diff = max(abs(got[s] - tail[s]) for s in tail) if set(got) == set(tail) else math.inf
    log(f"  resume: steps {sorted(got)} against the straight run's, largest loss difference {diff:.3e} "
        f"(bound {RESUME_TOL:g})")
    if not diff <= RESUME_TOL:
        raise AssertionError(f"resumed losses {got} against the straight run's {tail}")
    for k, n in per_step.items():
        if resumed["counts"][k] != (TRAIN_STEPS - TRAIN_CKPT) * n:
            raise AssertionError(f"resumed run: {resumed['counts'][k]} {k} launches")
    shutil.rmtree(ckdir, ignore_errors=True)
    n_par = sum(t.numel() for t in _leaves(straight["params"]))
    states = {"float32": state_bytes(straight["opt_state"])}
    log(f"  smollm-360m FULL: {n_par} parameters; params {2 * n_par} B + grads {2 * n_par} B + f32 states "
        f"{states['float32']} B (reckoned {opt_state_reckoning(cfg, 'float32')}); peak {straight['peak']} B")
    prof = train_step_profile(torch, cfg, straight["params"], straight["opt_state"], OptConfig(lr=1e-3))
    drop_train(straight, resumed)
    peaks = {"float32": straight["peak"]}
    for dt in ("bfloat16", "int8"):
        r = runs[f"train_smollm_{dt}"] = train_run(torch, base + ["--steps", "1", "--opt-dtype", dt],
                                                   f"smollm-360m FULL {dt} states")
        states[dt], peaks[dt] = state_bytes(r["opt_state"]), r["peak"]
        want = opt_state_reckoning(cfg, dt)
        log(f"  {dt} states: {states[dt]} B (reckoned {want}); peak {r['peak']} B")
        if states[dt] != want:
            raise AssertionError(f"{dt} optimizer states: {states[dt]} B, reckoned {want}")
        drop_train(r)
    if states["float32"] != opt_state_reckoning(cfg, "float32"):
        raise AssertionError(f"f32 optimizer states: {states['float32']} B")
    return {"runs": runs, "profile": prof, "states": states, "peaks": peaks, "resume_diff": diff,
            "losses": losses}


def train_xlstm(torch) -> dict:
    """(c) xlstm-350m FULL (24 layers, 21 mLSTM, bf16) through
    ``launch/train.main`` for a few steps: the mLSTM kernel launched in the
    forward and in the backward's recompute of every mLSTM layer each
    step."""
    from repro_torch.configs.registry import get_config

    cfg = get_config("xlstm-350m")
    B, S, steps = XLSTM_TRAIN
    r = train_run(torch, ["--arch", "xlstm-350m", "--batch-size", str(B), "--seq-len", str(S), "--steps",
                          str(steps), "--log-every", "1", "--lr", "1e-3"], "xlstm-350m FULL f32 states")
    n_m = sum(k == "mlstm" for k in cfg.block_pattern) * cfg.n_superblocks
    want = {"mlstm_chunkwise": steps * 2 * n_m, "rmsnorm": steps * (2 * cfg.n_layers + 1)}
    for k, n in want.items():
        if r["counts"][k] != n:
            raise AssertionError(f"xlstm train: {r['counts'][k]} {k} launches, expected {n}")
    drop_train(r)
    return r


def train_parity(torch, dev) -> dict:
    """(d) smollm at FULL width cut to 2 layers, on seeded weights: the
    loss and every gradient leaf of a step on the card in f32 (TF32 off)
    against the CPU's plain path in f32, each leaf within PARITY_F32_REL of
    its largest CPU value; then on the weights rounded to bf16, the card in
    bf16 against the CPU in f32 on the same weights: the loss within
    PARITY_BF16_LOSS and each leaf's cosine similarity at least
    PARITY_BF16_COS."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import get_model
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.tree import leaves, paths

    cfg = get_config("smollm-360m").replace(n_layers=2)
    f32 = cfg.replace(param_dtype=torch.float32, compute_dtype=torch.float32)
    B, S = PARITY_TRAIN
    batch = SyntheticLM(DataConfig(batch_size=B, seq_len=S, vocab_size=cfg.vocab_size, seed=11)).batch_at(0)
    cpu_batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    card_batch = {k: v.to(dev) for k, v in cpu_batch.items()}
    p32 = seeded_params(torch, f32, dev, seed=17)
    res = {}
    for leg, card_cfg, card_p in (("f32", f32, p32), ("bf16", cfg, _map(p32, lambda t: t.to(torch.bfloat16)))):
        reset_counts()
        (l_card, _), g_card = value_and_grad(get_model(card_cfg), card_p, card_batch)
        torch.cuda.synchronize()
        counts = read_counts()
        cpu_p = _map(card_p, lambda t: t.float().cpu())
        t0 = time.perf_counter()
        (l_cpu, _), g_cpu = value_and_grad(get_model(f32), cpu_p, cpu_batch)
        cpu_s = time.perf_counter() - t0
        rel, cos = {}, {}
        for path, a, b in zip(paths(g_cpu), leaves(g_card), leaves(g_cpu)):
            a = a.float().cpu()
            rel[path] = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            cos[path] = float(torch.nn.functional.cosine_similarity(a.reshape(1, -1).double(),
                                                                    b.reshape(1, -1).double()))
        dl = abs(float(l_card) - float(l_cpu))
        res[leg] = {"loss_card": float(l_card), "loss_cpu": float(l_cpu), "loss_diff": dl, "rel": rel, "cos": cos,
                    "counts": counts}
        worst = max(rel, key=rel.get)
        low = min(cos, key=cos.get)
        log(f"  parity {leg} (smollm 2L full width, batch {B} x {S}): loss card {float(l_card):.6f}, CPU "
            f"{float(l_cpu):.6f} (|d| {dl:.3e}); largest leaf difference {rel[worst]:.3e} of its max ({worst}); "
            f"least cosine {cos[low]:.6f} ({low}); CPU {cpu_s:.1f} s; launches {counts}")
        if counts["rmsnorm"] != 2 * (2 * cfg.n_layers + 1) - 1 or counts["flash_attention"] != 2 * cfg.n_layers:
            raise AssertionError(f"parity {leg}: launches {counts}")
        if leg == "f32" and not (max(rel.values()) <= PARITY_F32_REL and dl <= PARITY_F32_REL * abs(float(l_cpu))):
            raise AssertionError(f"parity f32: loss |d| {dl}, leaves {rel}")
        if leg == "bf16" and not (min(cos.values()) >= PARITY_BF16_COS and dl <= PARITY_BF16_LOSS):
            raise AssertionError(f"parity bf16: loss |d| {dl}, cosines {cos}")
    return res


def phase_train(torch, dev) -> dict:
    """Phase 16: training on the card, every earlier tree off it."""
    t0 = time.perf_counter()
    funcs = train_functions(torch, dev)
    t1 = time.perf_counter()
    smollm = train_smollm(torch)
    t2 = time.perf_counter()
    xlstm = train_xlstm(torch)
    t3 = time.perf_counter()
    parity = train_parity(torch, dev)
    free_card(torch)
    log(f"  phase 16 wall time: Functions {t1 - t0:.1f} s, smollm {t2 - t1:.1f} s, xlstm {t3 - t2:.1f} s, "
        f"parity {time.perf_counter() - t3:.1f} s")
    counts = {k: r["counts"] for k, r in smollm["runs"].items()}
    counts["train_xlstm"] = xlstm["counts"]
    return {"functions": funcs, "smollm": smollm, "xlstm": xlstm, "parity": parity, "counts": counts}


# ---------------------------------------------------------------------------
# Phase 17: the Xception-analog classifier and the training twins
# ---------------------------------------------------------------------------

XC_SIZE = 299             # the paper's input resolution
XC_STEPS = 20             # SGD steps of each training leg
XC_FWD_BATCHES = (1, 8)   # forward timing
XC_LOGIT_TOL = 2e-5       # card f32 (TF32 off) against CPU f32: logits and loss, of their scale (or 1)
# and each gradient leaf, of its largest magnitude. The wide leg's f32 gradients are ill-conditioned:
# weights moved by 1e-7 of themselves moved them by 2.1e-4 of a leaf's largest on the H100
# (``xc_parity`` measures it each run), and one card step was 2.08e-4 off the CPU's
XC_GRAD_TOL = {"default": 1e-4, "wide": 5e-4}
XC_SENS_EPS = (1e-7, 1e-6)  # relative weight perturbations of the sensitivity measurement
FIG3_LM_STEPS = 2 * 40    # the fig3 twin's two LM profiles of 40 steps
TRAIN_SMALL_STEPS = 40    # train_small: 20 steps, the crash, 20 resumed from the checkpoint at 20


def xc_legs() -> dict:
    """name -> (config, training batch, learning rate, parity batch). The
    default leg is ``XceptionConfig``'s widths at 299 px; the wide leg
    Xception's middle-flow width and repeats (728 channels, 8 blocks;
    Chollet 2017, Fig. 5). The wide leg's learning rate is the fig3 task's
    1e-2 scaled by 32 / 728: at 1e-2 its head moves the logits by about
    width x lr a step, and on the CPU at 32 and 64 px its loss swung
    between 1.5 and 108 over 20 steps."""
    from repro_torch.models.xception import XceptionConfig

    return {"default": (XceptionConfig(img_size=XC_SIZE), 32, 1e-2, 8),
            "wide": (XceptionConfig(width=728, n_blocks=8, img_size=XC_SIZE), 8, 1e-2 * 32 / 728, 2)}


def xc_flops(cfg) -> int:
    """Operations of one image's forward pass: the convolutions' and the
    head's multiply-adds, two operations each (the stride-2 entry conv's
    output is ceil(size / 2) square)."""
    side = -(-cfg.img_size // 2)
    w, hw = cfg.width, side * side
    return 2 * (hw * w * 27 + cfg.n_blocks * hw * (9 * w + w * w) + w * cfg.num_classes)


def xc_act_bytes(cfg, batch: int) -> int:
    """Bytes of one (batch, width, side, side) f32 activation."""
    side = -(-cfg.img_size // 2)
    return 4 * batch * cfg.width * side * side


def xc_step_reckoning(cfg, batch: int, n_params: int) -> int:
    """Bytes a training step adds above the resident tree and batches: the
    activations autograd saves (5 a block: the depthwise and pointwise
    outputs, the centred and the normalized values, the ReLU output; 1 for
    the entry), 2 more of gradient buffers in the backward, and the
    gradients and the updated tree (4 B a parameter each)."""
    return (5 * cfg.n_blocks + 3) * xc_act_bytes(cfg, batch) + 2 * 4 * n_params


def xc_train(torch, dev, name: str, cfg, batch: int, lr: float) -> dict:
    """(b) The fig3 task (``task_batch``, default_rng(0)) at XC_SIZE for
    XC_STEPS plain SGD steps from a seeded init on the card: the later
    half's mean accuracy above the first half's, every loss finite; the
    step's time (host clock over steps 1 to XC_STEPS - 1, synchronized),
    images a second, its peak memory above the resident tree and batches
    against ``xc_step_reckoning``, and a profiled step's device time and
    busy share. Returns the trained tree."""
    import numpy as np

    from repro_torch.benchmarks.fig3_training import sgd_step, task_batch
    from repro_torch.models import xception

    rng = np.random.default_rng(0)
    n = XC_STEPS + 2
    batches = [tuple(torch.from_numpy(a).to(dev) for a in task_batch(rng, batch, cfg.img_size)) for _ in range(n)]
    state = {"p": xception.init(torch.Generator(dev).manual_seed(0), cfg, dev), "i": 0}
    n_params = sum(t.numel() for t in state["p"].values())

    def step():
        state["p"], m = sgd_step(cfg, state["p"], *batches[state["i"]], lr=lr)
        state["i"] += 1
        return m

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = [step()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms += [step() for _ in range(XC_STEPS - 1)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / (XC_STEPS - 1) * 1e3
    peak = torch.cuda.max_memory_allocated() - base
    accs, losses = [float(m["acc"]) for m in ms], [float(m["loss"]) for m in ms]
    prof = profiled_steps(torch, step, n=2)
    want = xc_step_reckoning(cfg, batch, n_params)
    bound_ms = 3 * xc_flops(cfg) * batch / F32_FLOPS_S * 1e3
    first, late = statistics.mean(accs[:XC_STEPS // 2]), statistics.mean(accs[XC_STEPS // 2:])
    log(f"  xception {name} train (width {cfg.width}, {cfg.n_blocks} blocks, {n_params} parameters, {XC_SIZE} px, "
        f"batch {batch}, lr {lr:g}): step {step_ms:.3f} ms (host clock, synchronized, mean of {XC_STEPS - 1}), "
        f"{batch / step_ms * 1e3:.1f} images/s, bound {bound_ms:.3f} ms (3 x the forward's operations at "
        f"67 TFLOP/s f32); peak {peak} B above the resident tree and batches (reckoned {want}); {prof['text']}")
    log(f"    accuracy: first half {first:.4f}, later half {late:.4f}; losses {[round(x, 4) for x in losses]}")
    for e in prof["top"][:6]:
        log(f"    device {e.self_device_time_total / prof['n']:12.1f} us/step  x{e.count / prof['n']:g}/step  "
            f"{e.key[:90]}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"xception {name}: a loss is not finite: {losses}")
    if not late > first:
        raise AssertionError(f"xception {name}: accuracy did not rise: {accs}")
    return {"params": state["p"], "n_params": n_params, "step_ms": step_ms, "images_s": batch / step_ms * 1e3,
            "bound_ms": bound_ms, "peak": peak, "reckoned": want, "busy": prof["busy"],
            "device_us": prof["device_us"], "ops": prof["ops"], "acc_first": first, "acc_late": late}


def xc_forward(torch, dev, name: str, cfg, params) -> dict:
    """(a) The forward pass at XC_SIZE and each of XC_FWD_BATCHES: CUDA-event
    time in the public layout (NHWC images viewed as channels_last) and with
    the images copied to contiguous NCHW first (``forward_nchw``), and a
    profiled call's device time, device operations and busy share."""
    import numpy as np

    from repro_torch.benchmarks.fig3_training import task_batch
    from repro_torch.models import xception

    out = {}
    for batch in XC_FWD_BATCHES:
        img = torch.from_numpy(task_batch(np.random.default_rng(batch), batch, cfg.img_size)[0]).to(dev)
        nchw = img.permute(0, 3, 1, 2).contiguous()
        with torch.no_grad():
            ms = time_ms(lambda: xception.forward(cfg, params, img), iters=3, reps=3)
            ms_nchw = time_ms(lambda: xception.forward_nchw(cfg, params, nchw), iters=3, reps=3)
            prof = profiled_steps(torch, lambda: xception.forward(cfg, params, img), n=3)
        b_ms = xc_flops(cfg) * batch / F32_FLOPS_S * 1e3
        out[batch] = {"ms": ms, "ms_nchw": ms_nchw, "device_ms": prof["device_us"] / 1e3, "ops": prof["ops"],
                      "busy": prof["busy"], "bound_ms": b_ms}
        log(f"  xception {name} forward, batch {batch}: {ms:.3f} ms channels_last, {ms_nchw:.3f} ms NCHW "
            f"(events); device {prof['device_us'] / 1e3 / batch:.4f} ms an image, bound {b_ms / batch:.4f} "
            f"({xc_flops(cfg) / 1e9:.3f} GFLOP an image at 67 TFLOP/s f32); {prof['text']}")
    return out


def xc_parity(torch, dev, name: str, cfg, params, batch: int) -> dict:
    """(c) One f32 step on the card (TF32 off) against the CPU's plain f32
    on the same tree and batch: logits and loss within XC_LOGIT_TOL of their
    scale (or 1), each gradient leaf within the leg's XC_GRAD_TOL of its
    largest CPU magnitude; how far the card's gradients move when the
    weights are moved by XC_SENS_EPS of themselves (seeded normals, as
    ``scripts/train_grad_sensitivity.py`` does on the CPU), the spread no
    card-against-CPU comparison can go below; and whether two identical
    card steps give the same bits,
    reported per output and asserted for the logits, the loss and every
    leaf but the convolution kernels (cuDNN's weight gradients of the
    pointwise and entry convs differed between two identical steps on the
    H100)."""
    import numpy as np

    from repro_torch.benchmarks.fig3_training import task_batch
    from repro_torch.models import xception

    img, lab = task_batch(np.random.default_rng(7), batch, cfg.img_size)
    img_d, lab_d = torch.from_numpy(img).to(dev), torch.from_numpy(lab).to(dev)
    runs = []
    for _ in range(2):
        with torch.no_grad():
            logits = xception.forward(cfg, params, img_d)
        (loss, _), g = xception.value_and_grad(cfg, params, img_d, lab_d)
        runs.append((logits.cpu(), loss.cpu(), {k: v.cpu() for k, v in g.items()}))
    (logits, loss, g), (logits2, loss2, g2) = runs
    same = {"logits": torch.equal(logits, logits2), "loss": torch.equal(loss, loss2),
            **{k: torch.equal(g[k], g2[k]) for k in g}}
    cpu_p = {k: v.cpu() for k, v in params.items()}
    t0 = time.perf_counter()
    with torch.no_grad():
        logits_cpu = xception.forward(cfg, cpu_p, torch.from_numpy(img))
    (loss_cpu, _), g_cpu = xception.value_and_grad(cfg, cpu_p, torch.from_numpy(img), torch.from_numpy(lab))
    cpu_s = time.perf_counter() - t0
    logit_err = float((logits - logits_cpu).abs().max()) / max(1.0, float(logits_cpu.abs().max()))
    loss_err = abs(float(loss) - float(loss_cpu)) / max(1.0, abs(float(loss_cpu)))
    rel = {k: float((g[k] - g_cpu[k]).abs().max()) / max(float(g_cpu[k].abs().max()), 1e-30) for k in g}
    worst = max(rel, key=rel.get)
    differ = sorted(k for k, v in same.items() if not v)
    # how far the card's own two steps are apart, on the same scale: the
    # spread of cuDNN's summation order
    spread = max(float((g[k] - g2[k]).abs().max()) / max(float(g_cpu[k].abs().max()), 1e-30) for k in g)
    sens = {}
    for i, eps in enumerate(XC_SENS_EPS):
        gen = torch.Generator(dev).manual_seed(11 + i)
        moved = {k: v * (1 + eps * torch.randn(v.shape, generator=gen, device=dev)) for k, v in params.items()}
        gm = xception.value_and_grad(cfg, moved, img_d, lab_d)[1]
        sens[eps] = max((float((gm[k].cpu() - g[k]).abs().max()) / max(float(g_cpu[k].abs().max()), 1e-30), k)
                        for k in g)
    tol = XC_GRAD_TOL[name]
    log(f"  xception {name} parity (batch {batch}): logits {logit_err:.3e}, loss {loss_err:.3e} (card "
        f"{float(loss):.6f}, CPU {float(loss_cpu):.6f}; tol {XC_LOGIT_TOL:g}); largest leaf difference "
        f"{rel[worst]:.3e} of its max ({worst}; tol {tol:g}); CPU {cpu_s:.1f} s; two card steps "
        f"bit-identical: {'all' if not differ else 'all but ' + ', '.join(differ)} (largest leaf difference "
        f"between them {spread:.3e} of the CPU leaf's max); weights moved by "
        + ", ".join(f"{eps:g} move the card's gradients by {e:.3e} ({k})" for eps, (e, k) in sens.items()))
    if not (logit_err <= XC_LOGIT_TOL and loss_err <= XC_LOGIT_TOL and max(rel.values()) <= tol):
        raise AssertionError(f"xception {name} parity: logits {logit_err}, loss {loss_err}, leaves {rel}")
    kernels = {k for k in g if k == "entry" or k.endswith(("_dw", "_pw"))}
    if any(k not in kernels for k in differ):
        raise AssertionError(f"xception {name}: two identical card steps differ in {differ}")
    return {"logit_err": logit_err, "loss_err": loss_err, "rel": rel, "same_bits": same, "spread": spread,
            "sensitivity": sens, "cpu_s": cpu_s}


def xc_twins(torch) -> dict:
    """(d) The fig3 twin's rows (its ``main`` on the card), ``train_small
    --steps TRAIN_SMALL_STEPS`` (a crash at half the steps, the resume) and
    the quickstart, each with the launch counts set to 0 just before and
    read just after: the smollm SMOKE train steps (remat none) launch
    2L + 1 rmsnorm and L flash a step, the Xception rows none."""
    from repro_torch.benchmarks import common as bench_common
    from repro_torch.benchmarks import fig3_training
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import quickstart, train_small

    L = get_config("smollm-360m", smoke=True).n_layers
    per_step = {"rmsnorm": 2 * L + 1, "flash_attention": L}
    out = {}
    for label, fn, steps in (("fig3_training", lambda: fig3_training.main([]), FIG3_LM_STEPS),
                             ("train_small", lambda: train_small.main(["--steps", str(TRAIN_SMALL_STEPS)]),
                              TRAIN_SMALL_STEPS),
                             ("quickstart", lambda: quickstart.main([]), 0)):
        reset_counts()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        out[label] = {"result": r, "counts": counts, "wall": wall}
        log(f"  {label} on the card: {wall:.3f} s; launches {counts}"
            + (f"; a step: {counts['rmsnorm'] / steps:g} rmsnorm, {counts['flash_attention'] / steps:g} flash"
               if steps else ""))
        if steps and any(counts[k] != steps * n for k, n in per_step.items()):
            raise AssertionError(f"{label}: launches {counts}, expected {per_step} a step over {steps} steps")
        if any(counts[k] for k in counts if k not in per_step and k != "decode_attention"):
            raise AssertionError(f"{label} launched a paged-serving or mLSTM kernel: {counts}")
    rows = bench_common.ROWS[-3:]
    log(f"  fig3 rows: {rows}")
    if not (rows[2].startswith("fig3.xception_analog,") and all(r.startswith("fig3.lm.") for r in rows[:2])):
        raise AssertionError(f"fig3 rows: {rows}")
    q = out["quickstart"]
    if not (math.isfinite(q["result"]["loss"]) and q["counts"]["rmsnorm"] > 0 and q["counts"]["flash_attention"] > 0):
        raise AssertionError(f"quickstart: loss {q['result']['loss']}, launches {q['counts']}")
    return out


def phase_xception(torch, dev) -> dict:
    """Phase 17: the Xception analog at 299 px on both legs, (b) trained,
    (a) timed forward and (c) held to the CPU, with 0 launches of the seven
    kernels over all three; then (d) the training twins."""
    t0 = time.perf_counter()
    reset_counts()
    legs = {}
    for name, (cfg, batch, lr, parity_batch) in xc_legs().items():
        tr = xc_train(torch, dev, name, cfg, batch, lr)
        params = tr.pop("params")
        legs[name] = {"train": tr, "forward": xc_forward(torch, dev, name, cfg, params),
                      "parity": xc_parity(torch, dev, name, cfg, params, parity_batch)}
        del params
        free_card(torch)
    counts = read_counts()
    log(f"  xception path launches: {counts}")
    if any(counts.values()):
        raise AssertionError(f"the Xception path launched a kernel: {counts}")
    t1 = time.perf_counter()
    twins = xc_twins(torch)
    free_card(torch)
    log(f"  phase 17 wall time: xception legs {t1 - t0:.1f} s, twins {time.perf_counter() - t1:.1f} s")
    return {"legs": legs, "twins": twins,
            "counts": {"xception": counts, **{k: t["counts"] for k, t in twins.items()}}}


# ---------------------------------------------------------------------------
# Phase 18: the dry run
# ---------------------------------------------------------------------------

DRYRUN_CELLS = [("smollm-360m", "train_4k"), ("smollm-360m", "prefill_32k"), ("smollm-360m", "decode_32k"),
                ("smollm-360m", "long_500k"), ("dbrx-132b", "train_4k"), ("jamba-1.5-large-398b", "long_500k")]
DRYRUN_STEPS = {"train": (4, 2048), "prefill": (1, 2048), "decode": (4, 2048)}   # batch, sequence (the cache in decode)


def dryrun_cells(outdir: Path) -> list:
    """(a) ``run_cell`` on the meta device for production cells, each
    record written to ``outdir`` as the dry run's CLI writes it."""
    from repro_torch.configs.registry import skip_reason
    from repro_torch.launch import dryrun

    recs = []
    for arch, shape in DRYRUN_CELLS:
        rec = dryrun.run_cell(arch, shape)
        (outdir / f"single__{arch}__{shape}.json").write_text(json.dumps(rec, indent=1))
        want = "skip" if skip_reason(arch, shape) else "ok"
        if rec["status"] != want:
            raise AssertionError(f"dry run {arch} {shape}: {rec['status']}, expected {want}: {rec}")
        if want == "ok":
            t, m = rec["roofline"], rec["mem"]
            log(f"  {arch} {shape}: bound {t['bound']}, compute {t['compute_s'] * 1e3:.3f} ms, memory "
                f"{t['memory_s'] * 1e3:.3f} ms, {m['per_device_total'] / 1e9:.3f} GB a device, useful "
                f"{rec['useful_compute_ratio']:.4f}; traced in {rec['trace_s']} s")
        else:
            log(f"  {arch} {shape}: skip ({rec['reason'][:48]}...)")
        recs.append(rec)
    return recs


def card_args(torch, model, kind: str, dev, gen):
    """The step and its arguments on the card for ``DRYRUN_STEPS[kind]``:
    seeded weights, f32 AdamW states, int32 ids from a seeded generator, a
    zero dense cache written at its last position."""
    from repro_torch.launch import steps
    from repro_torch.train.optimizer import OptConfig, init_opt_state

    B, S = DRYRUN_STEPS[kind]
    params = model.init(gen)
    ids = lambda *shape: torch.randint(0, model.cfg.vocab_size, shape, generator=gen, device=dev,  # noqa: E731
                                       dtype=torch.int32)
    if kind == "train":
        return (steps.make_train_step(model, OptConfig()), (params, init_opt_state(params, OptConfig()),
                {"tokens": ids(B, S), "labels": ids(B, S)}), 2)
    if kind == "prefill":
        return steps.make_prefill_step(model, cap=S), (params, {"tokens": ids(B, S)}), 0
    return (steps.make_decode_step(model), (params, model.init_cache(B, S, dev),
            {"token": ids(B, 1), "cache_index": S - 1}), 0)


def dryrun_step(torch, kind: str, dev) -> dict:
    """(b) one smollm-360m FULL step on the card under the counter against
    the meta trace of the same ShapeSpec: FLOPs and bytes equal, the
    arguments' bytes equal, the roofline bound at most the step's device
    time; the measured time over the bound and the predicted peak beside
    the measured one."""
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import cost, dryrun, steps
    from repro_torch.models import get_model
    from repro_torch.models.api import ShapeSpec
    from repro_torch.train.optimizer import OptConfig

    B, S = DRYRUN_STEPS[kind]
    spec = ShapeSpec(f"{kind}_{S}", kind, S, B)
    cfg = dryrun.adjust_config(get_config("smollm-360m"), spec)
    model = get_model(cfg)
    step, args, n_donated = card_args(torch, model, kind, dev, torch.Generator(dev).manual_seed(18))
    state = {"args": args}

    def run():
        out = step(*state["args"])
        if kind == "train":
            state["args"] = (out[0], out[1], state["args"][2])
        return out

    run()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, card = cost.step_cost(run, state["args"], state["args"][:n_donated])
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    del out
    lowered = {"train": lambda: steps.lower_train(model, spec, OptConfig()),
               "prefill": lambda: steps.lower_prefill(model, spec),
               "decode": lambda: steps.lower_decode(model, spec)}[kind]()
    _, meta = cost.step_cost(lowered, lowered.args, lowered.donated)
    if (card["flops"], card["mem_bytes"]) != (meta["flops"], meta["mem_bytes"]):
        raise AssertionError(f"dry run {kind}: the card counted {card['flops']} FLOPs and {card['mem_bytes']} B, "
                             f"the meta trace {meta['flops']} and {meta['mem_bytes']}")
    held = cost.tree_bytes(state["args"])
    if meta["argument_bytes"] != held:
        raise AssertionError(f"dry run {kind}: argument_bytes {meta['argument_bytes']}, the card holds {held}")
    terms = cost.roofline_terms(meta)
    prof = profiled_steps(torch, run, n=1)
    dev_s = prof["device_us"] * 1e-6
    total = meta["argument_bytes"] + meta["peak_bytes"]
    log(f"  smollm-360m {kind} B {B} S {S}: {meta['flops']} FLOPs, {meta['mem_bytes']} B of operation traffic "
        f"(card == meta), arguments {held} B; bound {terms['step_s_lower_bound'] * 1e3:.4f} ms "
        f"({terms['bound']}), device {dev_s * 1e3:.4f} ms ({dev_s / terms['step_s_lower_bound']:.2f}x the bound, "
        f"{prof['ops']:g} device operations); predicted per_device_total {total} B (the step's peak "
        f"{meta['peak_bytes']} B over the arguments), measured max_memory_allocated growth {grown} B over "
        f"{base} B allocated")
    if not terms["step_s_lower_bound"] <= dev_s:
        raise AssertionError(f"dry run {kind}: bound {terms['step_s_lower_bound']} s above the step's "
                             f"device time {dev_s} s")
    return {"flops": meta["flops"], "mem_bytes": meta["mem_bytes"], "bound_s": terms["step_s_lower_bound"],
            "device_s": dev_s, "peak_predicted": meta["peak_bytes"], "peak_growth": grown,
            "per_device_total": total}


def phase_dryrun(torch, dev) -> dict:
    """Phase 18: the dry run's records on the meta device, three smollm
    steps on the card counted against their meta traces, and the
    estimator reading the records back."""
    from repro_torch.core.estimator import LatencyEstimator

    t0 = time.perf_counter()
    outdir = OUT / "dryrun"
    outdir.mkdir(parents=True, exist_ok=True)
    for p in outdir.glob("*.json"):
        p.unlink()
    recs = dryrun_cells(outdir)
    t1 = time.perf_counter()
    steps = {}
    for kind in DRYRUN_STEPS:
        steps[kind] = dryrun_step(torch, kind, dev)
        free_card(torch)
    t2 = time.perf_counter()
    est = LatencyEstimator(str(outdir))
    for r in recs:
        if r["status"] != "ok":
            continue
        t = r["roofline"]
        want = max(t["compute_s"], t["memory_s"], t["collective_s"])
        got = est.step_time(r["arch"], r["shape"])
        if got != want:
            raise AssertionError(f"estimator {r['arch']} {r['shape']}: {got}, the record says {want}")
    log(f"  the estimator reads {len(est.records)} records; phase 18 wall time: cells {t1 - t0:.1f} s, card "
        f"steps {t2 - t1:.1f} s")
    return {"records": recs, "steps": steps}


# ---------------------------------------------------------------------------
# 19. witness: the analysis tier, and phase 4's serve under the lock-order witness
# ---------------------------------------------------------------------------

WITNESS_SUBMITTERS = 6
WITNESS_STEPS = 3           # decode steps a leg of the witnessed-step timing covers
WITNESS_ROUNDS = 3          # rounds of four legs: unwitnessed, witnessed, witnessed, unwitnessed


def witnessed_step_ms(torch, cfg, params, dev) -> dict:
    """A batch-8 paged decode step's time on the host clock (synchronized,
    mean of WITNESS_STEPS steps a leg) with no lock witnessed and with the
    engine's step RLock and ``_build``'s two locks witnessed (the count lock
    is taken at every launch: 97 a step), in WITNESS_ROUNDS rounds of
    unwitnessed, witnessed, witnessed, unwitnessed legs on one engine."""
    from repro_torch.analysis.witness import LockWitness, instrument_build, instrument_engine
    from repro_torch.launch.serve_hybrid import MAXLEN, PROMPT, PS, prompt_for
    from repro_torch.serving.engine import PagedEngineConfig, PagedInferenceEngine

    B = 8
    eng = PagedInferenceEngine(cfg, PagedEngineConfig(
        page_size=PS, num_pages=1 + B * MAXLEN // PS, max_slots=B, max_seq_len=MAXLEN,
        max_new_tokens=MAXLEN - PROMPT), params=params, device=dev)
    for i in range(B):
        eng.submit(prompt_for(i, cfg.vocab_size))
    while eng.waiting:
        eng.step()
    eng.step()
    lock, w = eng.lock, LockWitness()

    def leg(witnessed: bool) -> float:
        restore = None
        if witnessed:
            instrument_engine(eng, w)
            restore = instrument_build(w)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(WITNESS_STEPS):
                eng.step()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / WITNESS_STEPS
        finally:
            if restore is not None:
                restore()
                eng.lock = lock

    plain, witnessed = [], []
    for _ in range(WITNESS_ROUNDS):
        for on in (False, True, True, False):
            (witnessed if on else plain).append(leg(on))
    n = WITNESS_ROUNDS * 2 * WITNESS_STEPS
    return {"plain": plain, "witnessed": witnessed,
            "count_lock_per_step": w.acquire_counts().get("_build._count_lock", 0) / n}


def check_witnessed_streams(torch, r, chunked) -> None:
    """The witnessed serve's greedy streams against phase 4's, request by
    request. Where both runs served a request on the same tier (an engine
    of the same shapes), the streams must be equal token for token: the
    witness must not change a bit of the computation. The 1-, 8- and
    4-slot tiers run their bf16 products at other batch sizes, which may
    round apart; a stream served on another tier than in phase 4 that
    differs is held, every token, to the parity phase's rule (its lead on
    the CPU in f32 on the same weights within FLIP_BOUND)."""
    from repro_torch.launch import serve_hybrid
    from repro_torch.models import get_model

    N = serve_hybrid.N
    tier = {q.rid: q.tier.name for q in r["metrics"].completed}
    tier4 = {q.rid: q.tier.name for q in chunked["metrics"].completed}
    differ = [rid for rid in range(N) if r["results"][rid] != chunked["results"][rid]]
    same = [rid for rid in range(N) if tier[rid] == tier4[rid]]
    log(f"  greedy streams equal to phase 4's: {N - len(differ)} of {N}; {len(same)} requests on "
        f"the same tier as in phase 4, {sum(rid not in differ for rid in same)} of them equal")
    for rid in differ:
        a, b = r["results"][rid], chunked["results"][rid]
        j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        log(f"    rid {rid}: tier {tier[rid]} (phase 4 {tier4[rid]}), first difference at token {j}: "
            f"{a[j]} against {b[j]}")
    bad = [rid for rid in differ if rid in same]
    if bad:
        raise AssertionError(f"witnessed serve: streams differ from phase 4's on the same tier: rids {bad}")
    if differ:
        par = Parity(torch)
        model = get_model(par.f32(chunked["cfg"]))
        p32 = par.to_cpu(chunked["params"])
        with torch.no_grad():
            for rid in differ:
                par.forced(model, p32, "smollm-witness", rid, r["prompts"][rid], r["results"][rid])
        par.report()


def phase_witness(torch, dev, chunked) -> dict:
    """The port's analyzers on this checkout (0 unsuppressed findings, the
    committed lock-order graph fresh), then phase 4's chunked serve again
    under the lock-order witness: 24 requests from WITNESS_SUBMITTERS
    threads through the router and three EngineLoops as
    launch/serve_hybrid builds them, on phase 4's weights, with the
    router, every backend's condition, each loop and engine, the tracer,
    the sampler and ``_build``'s two locks witnessed. Asserts 0 failures,
    the path's three kernels launched, the same greedy outputs as phase 4
    for every request, observed orders consistent with the static graph
    (the engine's step lock reentrant), and the edge from the engine's
    step lock to the count lock both observed and static."""
    from repro_torch.analysis.__main__ import run_all
    from repro_torch.analysis.common import unsuppressed
    from repro_torch.analysis.witness import LockWitness, instrument_build
    from repro_torch.launch import serve_hybrid

    t0 = time.perf_counter()
    findings, graph = run_all(ROOT, ["locklint", "lockorder", "kernelcheck"])
    loud = unsuppressed(findings)
    if loud:
        raise AssertionError("analysis findings:\n" + "\n".join(f.format() for f in loud))
    doc = json.dumps(graph.to_json(), indent=2, sort_keys=True) + "\n"
    if (ROOT / "docs" / "lock_order_torch.json").read_text() != doc:
        raise AssertionError("docs/lock_order_torch.json is stale against the tree")
    static = {(e.src, e.dst) for e in graph.edges}
    log(f"  analyzers: 0 unsuppressed findings, {len(findings)} suppressed with reasons; "
        f"{len(graph.edges)} static edges, docs/lock_order_torch.json fresh; "
        f"{time.perf_counter() - t0:.3f} s")

    w = LockWitness()
    restore = instrument_build(w)
    reset_counts()
    t0 = time.perf_counter()
    try:
        r = serve_hybrid.main(device="cuda", smoke=False, chunk_tokens=32,
                              out_dir=str(OUT / "serve_witness"), seed=0, params=chunked["params"],
                              verbose=False, witness=w, submitters=WITNESS_SUBMITTERS)
        torch.cuda.synchronize()
    finally:
        restore()
    wall = time.perf_counter() - t0
    counts = read_counts()
    m = r["metrics"].summary()
    log(f"  witnessed serve: {m['total']} requests from {WITNESS_SUBMITTERS} submitters, "
        f"{m['failed']} failed, serve {r['serve_s']:.3f} s (wall {wall:.3f} s incl. tier set-up), "
        f"placement {r['by_tier']}, {r['hedged']} hedged; launches {counts}")
    log(f"  serve time witnessed {r['serve_s']:.3f} s against phase 4's unwitnessed "
        f"{chunked['serve_s']:.3f} s (1 submitter; same requests, weights and tiers)")
    if m["failed"] or m["total"] != serve_hybrid.N:
        raise AssertionError(f"witnessed serve: {m}")
    for name in ("rmsnorm", "paged_prefill_write", "paged_attention[flat]"):
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched in the witnessed serve")

    check_witnessed_streams(torch, r, chunked)

    counts_w = w.acquire_counts()
    observed = w.edges()
    unknown = w.unknown_edges(static)
    log(f"  acquires: {dict(sorted(counts_w.items()))}")
    log("  observed edges: " + ", ".join(f"{e.src} -> {e.dst} x{e.count}" for e in observed))
    log(f"  unknown_edges (observed, not static): {sorted(unknown)}")
    w.assert_consistent(static, reentrant={"_EngineBase.lock"})
    edge = ("_EngineBase.lock", "_build._count_lock")
    if edge not in static or edge not in w.edge_set(strip_instances=True):
        raise AssertionError(f"{edge[0]} -> {edge[1]} must be static and observed: "
                             f"static {edge in static}, observed {sorted(w.edge_set(strip_instances=True))}")
    for name in ("StraightLineRouter._lock", "EngineLoop._lock", "_EngineBase.lock", "Tracer._lock",
                 "MonitorSampler._lock", "_build._count_lock"):
        if counts_w.get(name, 0) <= 0:
            raise AssertionError(f"witnessed serve: {name} was never acquired: {counts_w}")

    step = witnessed_step_ms(torch, chunked["cfg"], chunked["params"], dev)
    log(f"  batch-8 decode step (host clock, synchronized, {WITNESS_STEPS} steps a leg, {WITNESS_ROUNDS} "
        f"rounds of unwitnessed, witnessed, witnessed, unwitnessed): median unwitnessed "
        f"{statistics.median(step['plain']):.3f} ms {[round(x, 3) for x in step['plain']]}, median "
        f"witnessed {statistics.median(step['witnessed']):.3f} ms "
        f"{[round(x, 3) for x in step['witnessed']]}; {step['count_lock_per_step']:g} count-lock "
        f"acquires a witnessed step")
    return {"counts": counts, "serve_s": r["serve_s"], "step": step}


# ---------------------------------------------------------------------------
# 20. mesh: the explicit-collective half of the mesh path
# ---------------------------------------------------------------------------

MESH_WORLD = 4              # gloo ranks sharing cuda:0 in part (b), a (2, 2) ('data', 'model') mesh
MESH_TP = 2
MESH_TIMEOUT_S = 120.0      # every collective's timeout
MESH_SPAWN_S = 300.0        # the longest part (b) waits for its ranks
MESH_SEED = 20
MESH_DECODE = (8, 1)        # decode batch: 8 sequences, 1 token
MESH_PREFILL = (2, 128)     # prefill batch; the second sequence holds MESH_PREFILL_VALID tokens
MESH_PREFILL_VALID = 77
MESH_PSUM = (MESH_WORLD, 6144 * 64)   # the compressed all-reduce's input, a row a rank


def mesh_layer(torch, dev, int8: bool = False):
    """dbrx-132b's MoE layer at FULL width (16 experts top-4, d 6144, d_ff
    10752, gated, bf16, capacity factor 1.25, fsdp_experts), drawn on
    ``dev`` from MESH_SEED (the same on every rank); with ``int8`` its
    weight-only int8 tree from the quantized init."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.common import init_tree
    from repro_torch.models.moe import moe_defs
    from repro_torch.models.quant import init_quantized

    cfg = get_config("dbrx-132b")
    gen = torch.Generator(dev).manual_seed(MESH_SEED)
    return cfg, (init_quantized if int8 else init_tree)(gen, moe_defs(cfg), cfg.param_dtype, dev)


def mesh_inputs(torch, cfg, dev) -> dict:
    """The decode batch, the prefill batch and its mask (right-padded), the
    compressed all-reduce's rows, all from MESH_SEED + 1."""
    g = torch.Generator(dev).manual_seed(MESH_SEED + 1)
    B, S = MESH_PREFILL
    return {"decode": torch.randn(*MESH_DECODE, cfg.d_model, generator=g, device=dev).to(cfg.compute_dtype),
            "prefill": torch.randn(B, S, cfg.d_model, generator=g, device=dev).to(cfg.compute_dtype),
            "valid": torch.arange(S, device=dev)[None] < torch.tensor([S, MESH_PREFILL_VALID], device=dev)[:, None],
            "psum": torch.randn(*MESH_PSUM, generator=g, device=dev)}


def int8_equal_at_ties(torch, x, q, q_cpu) -> int:
    """int8 blocks of ``_quantize`` on the card against the CPU's: equal but
    for 1 LSB where x / scale sits at a rounding tie (ground rule 4); the
    count of values that differ."""
    from repro_torch.train.compression import _quantize

    _, scale, _ = _quantize(x.cpu())
    flat = torch.nn.functional.pad(x.cpu().float().reshape(-1), (0, q.numel() - x.numel())).reshape(q.shape)
    frac = (flat / scale).abs()
    tie = (frac - frac.floor() - 0.5).abs() < 1e-6
    d = (q.cpu().int() - q_cpu.int()).abs()
    if int(d.max()) > 1 or not bool((d.eq(0) | tie).all()):
        raise AssertionError(f"int8 blocks on the card differ from the CPU's off rounding ties: {int(d.max())}")
    return int(d.ne(0).sum())


def mesh_world1(torch, dev) -> dict:
    """Part (a): NCCL at world size 1. ``moe_ffn`` under the ctx of
    ``make_tier_mesh(1, 1)`` equals ``ctx=None`` bit for bit on dbrx-132b's
    layer (8 decode tokens); the compressed psum over the 1-rank 'data' axis
    on the card against the CPU."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world, make_tier_mesh
    from repro_torch.models import moe
    from repro_torch.sharding.axes import P, make_ctx
    from repro_torch.train.compression import _dequantize, _quantize, make_compressed_psum

    store = OUT / "mesh" / "store_world1"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    init_world("nccl", 0, 1, dist.FileStore(str(store), 1), timeout_s=MESH_TIMEOUT_S)
    try:
        ctx = make_ctx(make_tier_mesh(1, 1))
        cfg, p = mesh_layer(torch, dev)
        x = mesh_inputs(torch, cfg, dev)
        out, aux = moe.moe_ffn(cfg, p, x["decode"], ctx=ctx)
        ref, ref_aux = moe.moe_ffn(cfg, p, x["decode"])
        if not (ctx.tp_size == 1 and torch.equal(out, ref) and torch.equal(aux, ref_aux)):
            raise AssertionError("moe_ffn under the world-size-1 mesh differs from ctx=None")
        del p
        xs = x["psum"][:1]
        got = make_compressed_psum(ctx, "data", P(None, None))(xs)
        q, scale, pad = _quantize(xs)
        q_cpu, scale_cpu, _ = _quantize(xs.cpu())
        ties = int8_equal_at_ties(torch, xs, q, q_cpu)
        if not torch.equal(got, _dequantize(q, scale, pad, xs.shape)):
            raise AssertionError("the world-size-1 compressed psum is not its own int8 round trip")
        same = (q.cpu() == q_cpu).all(-1, keepdim=True)
        if not torch.equal(torch.where(same, got.cpu().reshape(q.shape), 0),
                           torch.where(same, _dequantize(q_cpu, scale_cpu, 0, q.shape), 0)):
            raise AssertionError("the compressed psum on the card differs from the CPU's on equal int8 blocks")
        return {"backend": dist.get_backend(), "moe_equal": True, "psum_values": xs.numel(),
                "int8_differing_at_ties": ties, "scales_equal": bool(torch.equal(scale.cpu(), scale_cpu))}
    finally:
        dist.destroy_process_group()


def _owned(tree):
    """A tree's leaves as tensors of their own (the blocks, not views of the
    full layer), so the full layer can be freed."""
    if isinstance(tree, dict):
        return {k: _owned(v) for k, v in tree.items()}
    return tree.clone()


def _route_rows(r: dict, e_off: int, n: int) -> dict:
    return {k: r[k][e_off:e_off + n] for k in ("sel_idx", "sel_valid", "gate")}


def _timed(torch, fn):
    """``fn()`` and its one call's host ms (to the card's synchronize) and
    CUDA-event span on the rank's stream (which includes the waits of
    gloo's host-side exchange)."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, {"host_ms": (time.perf_counter() - t0) * 1e3, "event_ms": start.elapsed_time(end)}


def mesh_rank(rank: int, out_dir: str) -> None:
    """One of part (b)'s ranks: gloo on cuda:0 in a (2, 2) mesh over
    ('data', 'model'). Draws dbrx-132b's whole layer, computes the
    single-device references on the card, cuts its blocks and frees the
    layer, then runs the sharded ``moe_ffn`` (weight gather on the decode
    and the masked prefill, token gather on the decode, weight gather with
    int8 experts) and the compressed all-reduce on CUDA and CPU tensors.
    Writes rank{r}.json; raises on any check that fails."""
    import hashlib

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import init_world, make_tier_mesh
    from repro_torch.models import moe
    from repro_torch.sharding.axes import P, coordinate, make_ctx
    from repro_torch.train.compression import make_compressed_psum

    res = {"rank": rank}
    out = Path(out_dir)
    try:
        dev = init_world("gloo", rank, MESH_WORLD, dist.FileStore(str(out / "store"), MESH_WORLD),
                         timeout_s=MESH_TIMEOUT_S, device="cuda:0")
        torch.backends.cuda.matmul.allow_tf32 = False
        mesh = make_tier_mesh(MESH_WORLD, MESH_TP, device=dev)
        ctx = make_ctx(mesh)
        coord = coordinate(mesh)
        cfg, p = mesh_layer(torch, dev)
        x = mesh_inputs(torch, cfg, dev)
        tok = cfg.replace(moe_token_gather=True)
        n_local = cfg.moe.n_experts // MESH_TP
        e_off = coord["model"] * n_local
        res.update(coord=coord, e_off=e_off, device=torch.cuda.get_device_name(dev))

        def route_of(xb, vb=None):
            xf = xb.reshape(-1, cfg.d_model)
            return moe.route(cfg, xf.float() @ p["router"].float(), moe.capacity_for(cfg, xf.shape[0]),
                             None if vb is None else vb.reshape(-1))

        # single-device references on the card: every data shard's (the aux
        # is their mean), the whole decode batch's for the token gather
        dec, pre, valid = x["decode"], x["prefill"], x["valid"]
        d_i = coord["data"]
        ref = {"decode": [moe.moe_ffn(cfg, p, xs) for xs in dec.chunk(2)],
               "prefill": [moe.moe_ffn(cfg, p, xs, vs) for xs, vs in zip(pre.chunk(2), valid.chunk(2))],
               "token": moe.moe_ffn(cfg, p, dec)}
        rows = {"decode": _route_rows(route_of(dec.chunk(2)[d_i]), e_off, n_local),
                "prefill": _route_rows(route_of(pre.chunk(2)[d_i], valid.chunk(2)[d_i]), e_off, n_local),
                "token": _route_rows(route_of(dec), e_off, n_local)}
        p_l, dec_l, _ = moe.moe_blocks(cfg, ctx, p, dec)
        _, pre_l, valid_l = moe.moe_blocks(cfg, ctx, p, pre, valid)
        p_l = _owned(p_l)
        blocks = {"decode": (p_l, dec_l.clone(), None), "prefill": (p_l, pre_l.clone(), valid_l.clone())}
        res["block_gb"] = sum(t.numel() * t.element_size() for t in p_l.values()) / 1e9
        del p, p_l, dec_l, pre_l, valid_l
        torch.cuda.empty_cache()

        seen = []
        orig_route = moe.route

        def recording(*a, **kw):
            r = orig_route(*a, **kw)
            seen.append(r)
            return r

        def sharded(c, pb, xb, vb):
            seen.clear()
            moe.route = recording
            try:
                return moe.moe_ffn(c, pb, xb, vb, ctx=ctx)
            finally:
                moe.route = orig_route

        checks = {}
        for name, c, key in (("weight gather decode", cfg, "decode"), ("weight gather prefill", cfg, "prefill"),
                             ("token gather decode", tok, "decode")):
            pb, xb, vb = blocks[key]
            (got, aux), timing = _timed(torch, lambda: sharded(c, pb, xb, vb))
            if c.moe_token_gather:
                whole, want_aux = ref["token"]
                want = whole.chunk(2)[d_i]
                route_key = "token"
            else:
                want = ref[key][d_i][0]
                want_aux = sum(a for _, a in ref[key]) / 2
                route_key = key
            e = scaled_err(got, want)
            ea = abs(float(aux) - float(want_aux))
            same_route = all(torch.equal(seen[0][k], rows[route_key][k]) for k in ("sel_idx", "sel_valid", "gate"))
            checks[name] = {"scaled_err": e, "max_abs_err": err(got, want), "aux_err": ea,
                            "route_equal": same_route, "slots": list(seen[0]["sel_idx"].shape),
                            "kept": int(seen[0]["sel_valid"].sum()), "assigned": int(seen[0]["assigned"].sum())}
            if not (e <= TOL["bfloat16"] and ea <= TOL["float32"] and same_route and got.shape == xb.shape):
                raise AssertionError(f"rank {rank} {name}: {checks[name]}")
            if key == "decode":
                checks[name].update(timing)
        del blocks, ref, pb, xb, vb, got, want, whole
        torch.cuda.empty_cache()

        cfg8, p8 = mesh_layer(torch, dev, int8=True)
        want, _ = moe.moe_ffn(cfg8, p8, dec.chunk(2)[d_i])
        want_aux = sum(moe.moe_ffn(cfg8, p8, xs)[1] for xs in dec.chunk(2)) / 2
        pb, xb, vb = moe.moe_blocks(cfg8, ctx, p8, dec)
        pb, xb = _owned(pb), xb.clone()
        del p8
        torch.cuda.empty_cache()
        (got, aux), timing = _timed(torch, lambda: moe.moe_ffn(cfg8, pb, xb, vb, ctx=ctx))
        name = "weight gather decode, int8 experts"
        checks[name] = {"scaled_err": scaled_err(got, want), "max_abs_err": err(got, want),
                        "aux_err": abs(float(aux) - float(want_aux))}
        if not (checks[name]["scaled_err"] <= TOL["bfloat16"] and checks[name]["aux_err"] <= TOL["float32"]):
            raise AssertionError(f"rank {rank} {name}: {checks[name]}")
        checks[name].update(timing)
        del pb, xb, vb
        torch.cuda.empty_cache()

        pod = init_device_mesh("cuda", (MESH_WORLD,), mesh_dim_names=("pod",))
        fn = make_compressed_psum(pod, "pod", P("pod", None))
        row = x["psum"][rank:rank + 1]
        got, timing = _timed(torch, lambda: fn(row))
        got_cpu = fn(row.cpu())
        true = x["psum"].sum(0, keepdim=True)
        rel = float((got - true).abs().max() / true.abs().max())
        checks["compressed all-reduce"] = {
            "equal_to_cpu_ranks": bool(torch.equal(got.cpu(), got_cpu)), "rel_err": rel,
            "sha256": hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest(), **timing}
        if not (checks["compressed all-reduce"]["equal_to_cpu_ranks"] and rel < 0.05):
            raise AssertionError(f"rank {rank} compressed all-reduce: {checks['compressed all-reduce']}")
        res["checks"] = checks
        res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        import traceback

        res["error"] = traceback.format_exc()
        raise
    finally:
        (out / f"rank{rank}.json").write_text(json.dumps(res))


def phase_mesh(torch, dev) -> dict:
    """Phase 20: part (a) in this process, part (b) in MESH_WORLD spawned
    ranks, each joined or killed by MESH_SPAWN_S; a rank that fails or hangs
    fails the phase."""
    import multiprocessing

    t0 = time.perf_counter()
    one = mesh_world1(torch, dev)
    log(f"  (a) NCCL world size 1 ({one['backend']}): moe_ffn under make_tier_mesh(1, 1) == ctx=None bit for "
        f"bit (dbrx-132b FULL layer, {MESH_DECODE[0]} decode tokens); compressed psum of {one['psum_values']} "
        f"values: int8 == the CPU's but {one['int8_differing_at_ties']} at rounding ties, scales equal "
        f"{one['scales_equal']} [{time.perf_counter() - t0:.1f} s]")
    free_card(torch)

    t1 = time.perf_counter()
    out = OUT / "mesh" / "ranks"
    out.mkdir(parents=True, exist_ok=True)
    for f in out.iterdir():
        f.unlink()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=mesh_rank, args=(r, str(out))) for r in range(MESH_WORLD)]
    for pr in procs:
        pr.start()
    try:
        deadline = time.monotonic() + MESH_SPAWN_S
        for pr in procs:
            pr.join(max(1.0, deadline - time.monotonic()))
    finally:
        stuck = [r for r, pr in enumerate(procs) if pr.is_alive()]
        for pr in procs:
            if pr.is_alive():
                pr.kill()
            pr.join()
    ranks = [json.loads((out / f"rank{r}.json").read_text()) if (out / f"rank{r}.json").exists() else {}
             for r in range(MESH_WORLD)]
    bad = [(r, pr.exitcode, ranks[r].get("error", "no result")[-2000:]) for r, pr in enumerate(procs)
           if pr.exitcode != 0 or "checks" not in ranks[r]]
    if stuck or bad:
        raise AssertionError(f"phase 20 (b): ranks past {MESH_SPAWN_S} s {stuck}; failed {bad}")
    digests = {r["checks"]["compressed all-reduce"]["sha256"] for r in ranks}
    if len(digests) != 1:
        raise AssertionError(f"phase 20 (b): the compressed all-reduce differs between ranks: {digests}")
    log(f"  (b) {MESH_WORLD} gloo ranks on {ranks[0]['device']}, mesh ({MESH_WORLD // MESH_TP}, {MESH_TP}) over "
        f"('data', 'model'), dbrx-132b FULL layer, each rank's experts block {ranks[0]['block_gb']:.3f} GB, peak "
        f"{max(r['peak_gb'] for r in ranks):.3f} GB [{time.perf_counter() - t1:.1f} s]")
    for name in ranks[0]["checks"]:
        cs = [r["checks"][name] for r in ranks]
        parts = [f"{k} max {max(c[k] for c in cs):.3e}" for k in ("scaled_err", "max_abs_err", "aux_err", "rel_err")
                 if k in cs[0]]
        if "route_equal" in cs[0]:
            parts.append(f"routes == the single-device rows [e_off, e_off + {cs[0]['slots'][0]}) on "
                         f"{sum(c['route_equal'] for c in cs)} of {len(cs)} ranks (slots {cs[0]['slots']}, kept "
                         f"of assigned {[(c['kept'], c['assigned']) for c in cs]})")
        if "equal_to_cpu_ranks" in cs[0]:
            parts.append(f"== the CPU ranks' bit for bit on {sum(c['equal_to_cpu_ranks'] for c in cs)} ranks, "
                         f"one digest on all")
        if "host_ms" in cs[0]:
            parts.append("one call host ms " + ", ".join(f"{c['host_ms']:.3f}" for c in cs)
                         + "; CUDA-event span ms " + ", ".join(f"{c['event_ms']:.3f}" for c in cs)
                         + " (the checked call, after the single-device references warmed the card)")
        log(f"  {name}: " + "; ".join(parts))
    return {"world1": one, "ranks": ranks, "seconds": time.perf_counter() - t0}


GSPMD_WORLD = 4             # gloo ranks sharing cuda:0 in part (b), a (2, 2) ('data', 'model') mesh
GSPMD_TP = 2
GSPMD_LAYERS = 2            # of glm4-9b's 40, at FULL width
GSPMD_BATCH = (4, 256)      # tokens a step
GSPMD_STEPS = 2
GSPMD_SEED = 21
GSPMD_TIMEOUT_S = 300.0     # every collective's timeout
GSPMD_SPAWN_S = 420.0       # the longest part (b) waits for its ranks
GSPMD_LOSS_TOL = 0.05       # phase 16's bf16 bounds against the single-device step
GSPMD_COS = 0.98


def gspmd_model(torch):
    """glm4-9b at FULL width (d 4096, 32 heads over 2, hd 128, d_ff 13696,
    vocab 151552, bf16, remat full), GSPMD_LAYERS of its 40 layers."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import get_model

    return get_model(get_config("glm4-9b").replace(n_layers=GSPMD_LAYERS))


def gspmd_batch(torch, cfg, dev) -> dict:
    g = torch.Generator(dev).manual_seed(GSPMD_SEED + 1)
    B, S = GSPMD_BATCH
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev),
            "labels": torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)}


def gspmd_counts(c: dict) -> dict:
    return {"rmsnorm": c["rmsnorm"], "flash_attention": c["flash_attention"]}


def gspmd_world1(torch, dev, out: Path) -> dict:
    """Part (a): NCCL at world size 1. The train step under the ctx of
    ``make_tier_mesh(1, 1)``, its parameters and states DTensors of the
    trees, against the ``ctx=None`` step bit for bit: the loss, every
    gradient and every parameter and state after AdamW, and the launches.
    Writes the single-device step's loss and gradients for part (b)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world, make_tier_mesh
    from repro_torch.launch.steps import (distribute_tree, make_train_step, opt_shardings, param_shardings,
                                          value_and_grad)
    from repro_torch.sharding.axes import make_ctx
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.tree import leaves, paths

    store = out / "store_world1"
    store.unlink(missing_ok=True)
    init_world("nccl", 0, 1, dist.FileStore(str(store), 1), timeout_s=GSPMD_TIMEOUT_S)
    try:
        ctx = make_ctx(make_tier_mesh(1, 1))
        model = gspmd_model(torch)
        ocfg = OptConfig(lr=1e-4)
        params = model.init(torch.Generator(dev).manual_seed(GSPMD_SEED))
        batch = gspmd_batch(torch, model.cfg, dev)
        reset_counts()
        (loss, _), grads = value_and_grad(model, params, batch)
        all_counts = read_counts()
        counts = gspmd_counts(all_counts)
        torch.save({"loss": loss.cpu(), "grads": {k: g.cpu() for k, g in zip(paths(grads), leaves(grads))},
                    "counts": counts}, out / "reference.pt")
        reset_counts()
        (loss1, _), grads1 = value_and_grad(model, params, batch, ctx)
        all_counts1 = read_counts()
        counts1 = gspmd_counts(all_counts1)
        if not (torch.equal(loss, loss1) and all(torch.equal(a, b) for a, b in zip(leaves(grads), leaves(grads1)))
                and counts == counts1):
            raise AssertionError("phase 21 (a): the world-size-1 loss or gradients differ from ctx=None's")
        del grads, grads1
        opt = init_opt_state(params, ocfg)
        p_ref, o_ref, m_ref = make_train_step(model, ocfg)(params, opt, batch)
        dp = distribute_tree(params, param_shardings(model, ctx, fsdp=True))
        do = distribute_tree(opt, opt_shardings(model, ctx, ocfg))
        del params, opt
        p1, o1, m1 = make_train_step(model, ocfg, ctx=ctx)(dp, do, batch)
        same = all(torch.equal(a.to_local(), b) for a, b in zip(leaves(p1), leaves(p_ref))) and all(
            torch.equal(a.to_local(), b) for a, b in zip(leaves(o1), leaves(o_ref)))
        if not (same and torch.equal(m1["loss"], m_ref["loss"])):
            raise AssertionError("phase 21 (a): the world-size-1 step's parameters or states differ from ctx=None's")
        return {"backend": dist.get_backend(), "loss": float(loss), "counts": counts, "all_counts": all_counts1,
                "leaves": len(leaves(p1)), "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    finally:
        dist.destroy_process_group()


def _cos(torch, a, b) -> float:
    a, b = a.float().reshape(-1), b.float().reshape(-1)
    n = float(a.norm() * b.norm())
    return 1.0 if n == 0 and float(a.norm() + b.norm()) == 0 else float(a @ b) / max(n, 1e-30)


def gspmd_rank(rank: int, out_dir: str) -> None:
    """One of part (b)'s ranks: the staged gloo backend on cuda:0 in a (2, 2)
    mesh over ('data', 'model'). Draws glm4-9b's 2-layer tree, puts it on
    the mesh by ``param_shardings(fsdp=True)`` (f32 AdamW states by
    ``opt_shardings``), takes the gradient once and GSPMD_STEPS train steps
    on the same batch. Checks the loss and each gradient block against part
    (a)'s single-device step, every leaf's placements and block shape, the
    CE's local logits and the kernels' launches. Writes rank{r}.json."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world, make_tier_mesh
    from repro_torch.launch.steps import (distribute_tree, make_train_step, opt_shardings, param_shardings,
                                          value_and_grad)
    from repro_torch.models import loss as loss_mod
    from repro_torch.sharding.axes import coordinate, make_ctx, placements
    from repro_torch.sharding.staged import STAGED, staged_log
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.tree import leaves, paths

    res = {"rank": rank}
    out = Path(out_dir)
    try:
        dev = init_world(STAGED, rank, GSPMD_WORLD, dist.FileStore(str(out / "store"), GSPMD_WORLD),
                         timeout_s=GSPMD_TIMEOUT_S, device="cuda:0")
        torch.backends.cuda.matmul.allow_tf32 = False
        mesh = make_tier_mesh(GSPMD_WORLD, GSPMD_TP, device=dev)
        ctx = make_ctx(mesh)
        coord = coordinate(mesh)
        model = gspmd_model(torch)
        ocfg = OptConfig(lr=1e-4)
        psh = param_shardings(model, ctx, fsdp=True)
        osh = opt_shardings(model, ctx, ocfg)
        full = model.init(torch.Generator(dev).manual_seed(GSPMD_SEED))
        params = distribute_tree(full, psh)
        del full
        torch.cuda.empty_cache()
        opt = distribute_tree(init_opt_state(params, ocfg), osh)
        batch = gspmd_batch(torch, model.cfg, dev)
        ref = torch.load(out.parent / "reference.pt", mmap=True)
        res.update(coord=coord, device=torch.cuda.get_device_name(dev))

        bad = []
        for name, tree, shard in (("param", params, psh), ("m", opt["m"], osh["m"]), ("v", opt["v"], osh["v"])):
            for path, t, sh in zip(paths(tree), leaves(tree), leaves(shard)):
                want = tuple(sh.block(torch.empty(t.shape, device="meta"), coord).shape)
                if tuple(t.placements) != placements(sh.spec, mesh) or tuple(t.to_local().shape) != want:
                    bad.append((name, path, str(t.placements), tuple(t.to_local().shape), want))
        if tuple(opt["step"].placements) != placements(osh["step"].spec, mesh):
            bad.append(("step", str(opt["step"].placements)))
        if bad:
            raise AssertionError(f"rank {rank}: leaves off their trees' layouts: {bad[:4]}")
        res["leaves"] = len(leaves(params)) + len(leaves(opt["m"])) * 2 + 1
        res["param_block_gb"] = sum(t.to_local().numel() * t.element_size() for t in leaves(params)) / 1e9

        shapes = []
        orig = loss_mod.qeinsum

        def recording(x, w):
            y = orig(x, w)
            shapes.append(tuple(y.shape))
            return y

        loss_mod.qeinsum = recording
        try:
            reset_counts()
            (loss, _), grads = value_and_grad(model, params, batch, ctx)
            res["all_counts"] = read_counts()
            counts = gspmd_counts(res["all_counts"])
        finally:
            loss_mod.qeinsum = orig
        res["logits_blocks"] = sorted(set(shapes))
        V_l = model.cfg.vocab_size // GSPMD_TP
        if not shapes or any(sh[-1] != V_l or sh[0] != GSPMD_BATCH[0] // (GSPMD_WORLD // GSPMD_TP)
                             for sh in shapes):
            raise AssertionError(f"rank {rank}: CE logits blocks {sorted(set(shapes))}, expected (2, C, {V_l})")
        if counts != ref["counts"]:
            raise AssertionError(f"rank {rank}: launches {counts}, the single-device step's {ref['counts']}")
        res["counts"] = counts
        res["loss"] = float(loss)
        res["loss_err"] = abs(float(loss) - float(ref["loss"]))
        coss = {}
        for path, g, p, sh in zip(paths(grads), leaves(grads), leaves(params), leaves(psh)):
            if tuple(g.placements) != tuple(p.placements):
                raise AssertionError(f"rank {rank}: gradient {path} in {g.placements}, parameter in {p.placements}")
            coss[path] = _cos(torch, g.to_local(), sh.block(ref["grads"][path], coord).to(dev))
        res["min_cos"] = min(coss.values())
        res["min_cos_leaf"] = min(coss, key=coss.get)
        if res["loss_err"] > GSPMD_LOSS_TOL or res["min_cos"] < GSPMD_COS:
            raise AssertionError(f"rank {rank}: loss {loss} vs {float(ref['loss'])}, gradient cosines {coss}")
        del grads, ref
        torch.cuda.empty_cache()

        step = make_train_step(model, ocfg, ctx=ctx)
        losses, timing = [], {}
        before = {a: {k: list(v) for k, v in d.items()} for a, d in staged_log(mesh).items()}
        for i in range(GSPMD_STEPS):
            torch.cuda.reset_peak_memory_stats(dev)
            (params, opt, metrics), timing = _timed(torch, lambda: step(params, opt, batch))
            losses.append(float(metrics["loss"]))
        after = staged_log(mesh)
        moved = {a: {k: [v[0] - before.get(a, {}).get(k, [0, 0])[0], v[1] - before.get(a, {}).get(k, [0, 0])[1]]
                     for k, v in d.items()} for a, d in after.items()}
        res["losses"] = losses
        res["step"] = timing
        res["step_peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        res["moved_per_step"] = {a: {k: [v[0] // GSPMD_STEPS, v[1] // GSPMD_STEPS] for k, v in d.items()}
                                 for a, d in moved.items()}
        res["bytes_per_step"] = sum(v[1] for d in res["moved_per_step"].values() for v in d.values())
        if not all(math.isfinite(x) for x in losses) or abs(losses[0] - res["loss"]) > 1e-3:
            raise AssertionError(f"rank {rank}: step losses {losses} against the gradient pass's {res['loss']}")
        for t, sh in zip(leaves(params), leaves(psh)):
            if tuple(t.placements) != placements(sh.spec, mesh):
                raise AssertionError(f"rank {rank}: a parameter after the steps in {t.placements}")
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        import traceback

        res["error"] = traceback.format_exc()
        raise
    finally:
        (out / f"rank{rank}.json").write_text(json.dumps(res))


def phase_gspmd(torch, dev) -> dict:
    """Phase 21: part (a) in this process, part (b) in GSPMD_WORLD spawned
    ranks, each joined or killed by GSPMD_SPAWN_S; a rank that fails or
    hangs fails the phase."""
    import multiprocessing

    t0 = time.perf_counter()
    base = OUT / "gspmd"
    base.mkdir(parents=True, exist_ok=True)
    one = gspmd_world1(torch, dev, base)
    log(f"  (a) NCCL world size 1 ({one['backend']}): glm4-9b FULL width {GSPMD_LAYERS}L bf16, batch "
        f"{GSPMD_BATCH[0]} x {GSPMD_BATCH[1]}, the train step under make_tier_mesh(1, 1) == ctx=None bit for bit "
        f"(loss {one['loss']:.6f}, every gradient, {one['leaves']} parameters and their f32 AdamW states), "
        f"launches {one['counts']} a gradient pass in both, peak {one['peak_gb']:.3f} GB "
        f"[{time.perf_counter() - t0:.1f} s]")
    free_card(torch)

    t1 = time.perf_counter()
    out = base / "ranks"
    out.mkdir(parents=True, exist_ok=True)
    for f in out.iterdir():
        f.unlink()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=gspmd_rank, args=(r, str(out))) for r in range(GSPMD_WORLD)]
    for pr in procs:
        pr.start()
    try:
        deadline = time.monotonic() + GSPMD_SPAWN_S
        for pr in procs:
            pr.join(max(1.0, deadline - time.monotonic()))
    finally:
        stuck = [r for r, pr in enumerate(procs) if pr.is_alive()]
        for pr in procs:
            if pr.is_alive():
                pr.kill()
            pr.join()
    ranks = [json.loads((out / f"rank{r}.json").read_text()) if (out / f"rank{r}.json").exists() else {}
             for r in range(GSPMD_WORLD)]
    bad = [(r, pr.exitcode, ranks[r].get("error", "no result")[-2000:]) for r, pr in enumerate(procs)
           if pr.exitcode != 0 or "losses" not in ranks[r]]
    if stuck or bad:
        raise AssertionError(f"phase 21 (b): ranks past {GSPMD_SPAWN_S} s {stuck}; failed {bad}")
    (base / "ranks.json").write_text(json.dumps(ranks, indent=1))
    r0 = ranks[0]
    log(f"  (b) {GSPMD_WORLD} ranks on {r0['device']} (gloo, CUDA operands staged through the host), mesh "
        f"({GSPMD_WORLD // GSPMD_TP}, {GSPMD_TP}) over ('data', 'model'), param_shardings(fsdp=True), f32 AdamW; "
        f"{r0['leaves']} leaves a rank in their trees' placements and block shapes; parameter blocks "
        f"{r0['param_block_gb']:.3f} GB a rank [{time.perf_counter() - t1:.1f} s]")
    log(f"  loss against the single-device step: " + ", ".join(f"{r['loss']:.6f} (err {r['loss_err']:.3e})"
                                                              for r in ranks)
        + f" (tol {GSPMD_LOSS_TOL}); least gradient-block cosine " + ", ".join(
            f"{r['min_cos']:.6f} ({r['min_cos_leaf']})" for r in ranks) + f" (bound {GSPMD_COS})")
    log(f"  CE logits blocks a rank {r0['logits_blocks']} (vocab {151552} over {GSPMD_TP}); launches a gradient "
        f"pass " + ", ".join(str(r["counts"]) for r in ranks))
    log(f"  {GSPMD_STEPS} train steps, losses " + "; ".join(str(r["losses"]) for r in ranks))
    log("  one step (the last): host ms " + ", ".join(f"{r['step']['host_ms']:.3f}" for r in ranks)
        + "; CUDA-event span ms " + ", ".join(f"{r['step']['event_ms']:.3f}" for r in ranks)
        + "; peak GB " + ", ".join(f"{r['step_peak_gb']:.3f}" for r in ranks)
        + "; bytes staged through the host a step " + ", ".join(str(r["bytes_per_step"]) for r in ranks))
    log(f"  staged collectives a step, rank 0: {json.dumps(r0['moved_per_step'])}")
    return {"world1": one, "ranks": ranks, "seconds": time.perf_counter() - t0}


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
    (OUT / "timeline.log").write_text("")

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
    dump = sass_dump(_build.BUILD_DIR / _build.LIB_NAME)

    # 3. kernels
    log(f"phase 3 kernels: [at {time.perf_counter() - T_START:.1f} s]")
    try:
        rows = phase_kernels(torch, dev)
    except BaseException:
        dump[0].kill()
        dump[0].wait()
        raise
    names = {"flash_bf16_kernel": "flash_attention", "mlstm_tc_kernel": "mlstm_chunkwise"}
    sass = kernel_sass(dump, {"flash_bf16_kernel": {"ILi64E": "hd<=64", "ILi128E": "hd<=128"},
                              "mlstm_tc_kernel": {"ILi16E": "TC 16", "ILi32E": "TC 32"}})
    for kernel, hmma in sass.items():
        name = names[kernel]
        log(f"  {name} bf16 kernel SASS (cuobjdump -sass): "
            + ", ".join(f"{n}: {c} HMMA/HGMMA" for n, c in sorted(hmma.items())))
        if not hmma or min(hmma.values()) == 0:
            raise AssertionError(f"the bf16 {name} kernel issues no tensor-core instruction: {hmma}")

    # 4. serve
    log(f"phase 4 serve: smollm-360m FULL bf16, 24 requests through StraightLineRouter [at {time.perf_counter() - T_START:.1f} s]")
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

    # 19. witness: the analysis tier, and phase 4's chunked serve under the lock-order witness
    log(f"phase 19 witness: the port's analyzers; phase 4's chunked serve from {WITNESS_SUBMITTERS} "
        f"submitters with every lock witnessed [at {time.perf_counter() - T_START:.1f} s]")
    t_witness = time.perf_counter()
    witness = phase_witness(torch, dev, chunked)
    log(f"  witness phase {time.perf_counter() - t_witness:.1f} s")

    # 5. launcher
    log(f"phase 5 launcher: launch/serve.main(), smollm-360m FULL bf16, 32 requests, dense engines [at {time.perf_counter() - T_START:.1f} s]")
    dense_step(torch, chunked["cfg"], chunked["params"], dev)
    depth = ("--layers", str(LAUNCHER_LAYERS["smollm-360m"]))
    l_chunk, lc_counts = launcher_leg(torch, 32, chunked["params"], extra=depth)
    l_whole, lw_counts = launcher_leg(torch, 0, chunked["params"], extra=depth)
    if lw_counts["flash_attention"] <= 0:
        raise AssertionError("flash_attention was not launched by the whole-prompt launcher")

    # 6. compact pools
    log(f"phase 6 pools: FULL bf16 paged engine, int8 pool and chained tables, prompts of 120-200 tokens [at {time.perf_counter() - T_START:.1f} s]")
    pools = phase_pools(torch, chunked["cfg"], chunked["params"], dev)

    # 7. options
    log(f"phase 7 options: FULL bf16 engines with spec_tokens, the prefix cache and fork() [at {time.perf_counter() - T_START:.1f} s]")
    opts = phase_options(torch, chunked["cfg"], chunked["params"], dev)

    # 8. xlstm
    log(f"phase 8 xlstm: xlstm-350m FULL bf16, the launcher's 32 requests and 8 long prompts on a paged engine [at {time.perf_counter() - T_START:.1f} s]")
    xlstm = phase_xlstm(torch, dev)

    # 9. glm4-9b, every earlier phase's weights moved off the card first
    before = torch.cuda.memory_allocated()
    offload(torch, [chunked, whole, l_chunk, l_whole, opts, xlstm])
    log(f"phase 9 glm4: glm4-9b FULL bf16, earlier weights moved to the host ("
        f"{before / 2**30:.3f} -> {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated) "
        f"[at {time.perf_counter() - T_START:.1f} s]")
    glm4 = phase_glm4(torch, dev)

    # 10. int8w: weight-only int8, granite-8b and qwen1.5-32b, glm4's trees moved off the card first
    before = torch.cuda.memory_allocated()
    offload(torch, [glm4])
    log(f"phase 10 int8w: granite-8b FULL bf16 and int8 weights, qwen1.5-32b FULL int8 weights, glm4 "
        f"weights moved to the host ({before / 2**30:.3f} -> {torch.cuda.memory_allocated() / 2**30:.3f} "
        f"GiB allocated) [at {time.perf_counter() - T_START:.1f} s]")
    int8w = phase_int8w(torch, dev)

    # 11. stubs: the two stub-frontend families, every earlier tree off the card
    log(f"phase 11 stubs: qwen2-vl-2b and whisper-large-v3 FULL, bf16 and int8 weights ("
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated) [at {time.perf_counter() - T_START:.1f} s]")
    t_stubs = time.perf_counter()
    stubs = phase_stubs(torch, dev)
    log(f"  stubs phase {time.perf_counter() - t_stubs:.1f} s")

    # 12. moe: the MoE family at FULL width, cut in depth, every earlier tree off the card
    log(f"phase 12 moe: dbrx-132b 4L and llama4-maverick 2L FULL width, bf16 and int8 weights "
        f"({torch.cuda.memory_allocated() / 2**30:.3f} "
        f"GiB allocated; host MemAvailable {mem_available()} B) [at {time.perf_counter() - T_START:.1f} s]")
    t_moe = time.perf_counter()
    moe = phase_moe(torch, dev)
    log(f"  moe phase {time.perf_counter() - t_moe:.1f} s")

    # 13. hybrid: jamba-1.5-large at FULL width, its first 4 layers, every earlier tree off the card;
    # then the parity legs' replays (MoE and hybrid), kept on the card
    log(f"phase 13 hybrid: jamba-1.5-large-398b FULL width, the first {HYBRID_LAYERS} layers of its "
        f"superblock in bf16, its whole first superblock ({HYBRID_INT8_LAYERS} layers) with int8 weights "
        f"({torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated; host MemAvailable "
        f"{mem_available()} B) [at {time.perf_counter() - T_START:.1f} s]")
    t_hybrid = time.perf_counter()
    hybrid = phase_hybrid(torch, dev)
    log(f"  hybrid phase {time.perf_counter() - t_hybrid:.1f} s")
    t0 = time.perf_counter()
    moe["served"] = moe_parity_models(torch, dev)
    log(f"  parity legs' runs on the card: {time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated)")

    # 14. parity
    log(f"phase 14 parity: teacher-forced CPU f32 plain paths on the same weights [at {time.perf_counter() - T_START:.1f} s]")
    t_parity = time.perf_counter()
    par = Parity(torch)
    for name, fn, args in (("smollm", parity_smollm, ([chunked, whole], [l_chunk, l_whole], pools)),
                           ("options", parity_options, (opts,)), ("xlstm", parity_xlstm, (xlstm,)),
                           ("glm4", parity_glm4, (glm4,)), ("int8w", parity_int8w, (int8w,)),
                           ("stubs", parity_stubs, (stubs,))):
        t0 = time.perf_counter()
        fn(torch, par, *args)
        log(f"  parity {name}: {time.perf_counter() - t0:.1f} s")
    drop_trees(chunked, whole, l_chunk, l_whole, opts, xlstm, glm4, int8w, stubs)
    t0 = time.perf_counter()
    log(f"  earlier trees dropped: {release_host()}")
    parity_moe(torch, par, moe)
    log(f"  parity moe: {time.perf_counter() - t0:.1f} s")
    par.report()
    t_summary = time.perf_counter()

    # 15. sched
    log(f"phase 15 sched: placing_batch_torch on the card, the paper's gates and figure twins "
        f"through the port's simulator [at {time.perf_counter() - T_START:.1f} s]")
    phase_sched(torch, dev)

    # 16. train: every earlier tree off the card
    drop_trees(moe, hybrid)
    free_card(torch)
    log(f"phase 16 train: smollm-360m FULL through launch/train, xlstm-350m FULL, a 2-layer parity leg ("
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated) [at {time.perf_counter() - T_START:.1f} s]")
    t_train = time.perf_counter()
    train = phase_train(torch, dev)
    log(f"  train phase {time.perf_counter() - t_train:.1f} s")

    # 17. xception: the paper's own model at 299 px and the training twins, every earlier tree off the card
    log(f"phase 17 xception: the Xception analog at {XC_SIZE} px (width 32 and 728), fig3_training, "
        f"train_small and the quickstart ({torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated) "
        f"[at {time.perf_counter() - T_START:.1f} s]")
    t_xc = time.perf_counter()
    xc = phase_xception(torch, dev)
    log(f"  xception phase {time.perf_counter() - t_xc:.1f} s")

    # 18. dryrun: the meta trace's records, three smollm steps counted on the card, the estimator
    free_card(torch)
    log(f"phase 18 dryrun: run_cell on the meta device, smollm-360m train, prefill and decode counted on the card "
        f"[at {time.perf_counter() - T_START:.1f} s]")
    t_dry = time.perf_counter()
    phase_dryrun(torch, dev)
    log(f"  dryrun phase {time.perf_counter() - t_dry:.1f} s")

    # 20. mesh: NCCL at world size 1 here, then MESH_WORLD gloo ranks on the card
    free_card(torch)
    log(f"phase 20 mesh: dbrx-132b's FULL MoE layer expert-parallel, the compressed all-reduce; NCCL at world "
        f"size 1, then {MESH_WORLD} gloo ranks on the card [at {time.perf_counter() - T_START:.1f} s]")
    mesh = phase_mesh(torch, dev)
    log(f"  mesh phase {mesh['seconds']:.1f} s")

    # 21. gspmd: the mesh path's GSPMD half, glm4-9b's train step; NCCL at world size 1, then GSPMD_WORLD ranks
    free_card(torch)
    log(f"phase 21 gspmd: glm4-9b FULL width {GSPMD_LAYERS}L, the sharded train step on DTensors; NCCL at world "
        f"size 1, then {GSPMD_WORLD} ranks on the card [at {time.perf_counter() - T_START:.1f} s]")
    gspmd = phase_gspmd(torch, dev)
    log(f"  gspmd phase {gspmd['seconds']:.1f} s")

    # 22. summary
    runs = {"serve_chunk32": c_counts, "witness_chunk32": witness["counts"], "serve_whole_prompt": w_counts, "launcher_chunk32": lc_counts,
            "launcher_whole_prompt": lw_counts, "pools_int8_chained": pools["int8_chained"]["counts"],
            "pools_int8_flat": pools["int8_flat"]["counts"],
            "pools_bf16_chained": pools["bf16_chained"]["counts"],
            **{f"options_spec_{k}": r["counts"] for k, r in opts["spec"].items()},
            **{f"options_prefix_{k}": r["counts"] for k, r in opts["prefix"].items()},
            "options_fork": opts["fork"]["counts"], **xlstm["counts"], **glm4["counts"],
            **int8w["counts"], **stubs["counts"], **moe["counts"], **hybrid["counts"], **train["counts"],
            **xc["counts"], "gspmd_world1": gspmd["world1"]["all_counts"],
            **{f"gspmd_rank{r['rank']}": r["all_counts"] for r in gspmd["ranks"]}}
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
    log(f"chip_smoke wall time {time.perf_counter() - T_START:.3f} s (parity {t_summary - t_parity:.1f} s, "
        f"sched, train, xception, dryrun, mesh and gspmd {time.perf_counter() - t_summary:.1f} s)")
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
