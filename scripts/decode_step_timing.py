#!/usr/bin/env python3
"""Decode step time of smollm-360m FULL in bf16 (random weights from a seeded
generator) on an NVIDIA card, through the port's public engine API only, so
that two checkouts can be compared in one run on one card:

    python scripts/decode_step_timing.py --src path/to/checkout/src --tag NAME

A paged engine with 8 slots (16-token pages, the serve_hybrid shapes) and a
dense engine with 4 slots and max_len 96 (the launcher's) each take 8-token
prompts, then decode steps are timed on the host clock, synchronized: the
median over 3 runs of the mean of 15 steps. Prints the card's name and
power limit, then one JSON line."""
import argparse
import json
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default="src")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve_hybrid import MAXLEN, PROMPT, PS, prompt_for
    from repro_torch.models import get_model
    from repro_torch.serving.engine import (
        EngineConfig,
        InferenceEngine,
        PagedEngineConfig,
        PagedInferenceEngine,
    )

    if not torch.cuda.is_available():
        print("decode_step_timing: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    cfg = get_config("smollm-360m")
    params = get_model(cfg).init(torch.Generator(dev).manual_seed(0))
    engines = {
        "paged, batch 8": (8, PagedInferenceEngine(cfg, PagedEngineConfig(
            page_size=PS, num_pages=1 + 8 * MAXLEN // PS, max_slots=8, max_seq_len=MAXLEN,
            max_new_tokens=MAXLEN - PROMPT), params=params, device=dev)),
        "dense, batch 4": (4, InferenceEngine(cfg, EngineConfig(max_slots=4, max_len=MAXLEN,
                                                                 max_new_tokens=MAXLEN - PROMPT),
                                              params=params, device=dev)),
    }
    out = {"tag": args.tag, "src": args.src, "step_ms": {}}
    for name, (slots, eng) in engines.items():
        for i in range(slots):
            eng.submit(prompt_for(i, cfg.vocab_size))
        while eng.waiting:
            eng.step()
        eng.step()
        torch.cuda.synchronize()
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(15):
                eng.step()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3 / 15)
        out["step_ms"][name] = {"median": statistics.median(runs), "runs": runs}
        print(f"  [{args.tag}] {name}: {statistics.median(runs):.3f} ms per step (runs {runs})", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
