"""Dry run: trace every (arch x shape) cell on the meta device and reckon its
roofline on one H100 (the torch twin of ``repro/launch/dryrun.py``).

Each cell runs the real train or serve step once over meta stand-ins
(``launch/steps.lower_*``: parameters, optimizer states, a dense cache and
inputs at the ``ShapeSpec``'s global shape, nothing allocated and nothing
computed) under ``launch/cost.CostCounter``, and records:

  * mem                    — argument, output, temporary and aliased bytes
                             and their total, by the JAX formula (the
                             temporaries: the peak of the storages the step
                             creates, less its new outputs);
  * cost                   — the counter's FLOPs, the step's arguments read
                             once plus its outputs written once
                             (``mem_lo``), every operation's traffic
                             (``mem``), and no collective bytes (one card);
  * roofline               — compute / memory / collective seconds at one
                             H100's rates (``core/estimator.py``) + bound;
  * MODEL_FLOPS            — 6*N*D convention + useful-compute ratio.

The port's one mesh is one H100 (``--mesh single``, recorded as
``"mesh": "1xH100"``); ``multi`` and ``both`` raise until the port has the
mesh path's GSPMD half. On that mesh no ctx reaches the model, so the
``moetok`` variants give ``baseline``'s and ``w8``'s records, as in the JAX
package (``moe_ffn`` takes its single-device path). The JAX record's XLA
keys (``xla_cost``, ``hlo_bytes``, ``while_trips``, ``compile_s``)
describe a compiled XLA program, which an eager step does not have: they
are left out, and ``trace_s`` (the meta trace's wall time) is added. The
dry run needs no card: the meta device holds the shapes alone, and
nothing computes on the CPU.

Usage:
  python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
  python -m repro_torch.launch.dryrun --all --outdir dryrun_out
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch

# Per-arch dry-run policies (the JAX package's):
#   opt_dtype  — optimizer-state dtype of the train cells
#   kv_quant   — int8 KV for the decode shapes
POLICY = {
    "llama4-maverick-400b-a17b": {"opt_dtype": "int8"},
    "jamba-1.5-large-398b": {"opt_dtype": "bfloat16"},
    "dbrx-132b": {"opt_dtype": "float32"},
    "qwen1.5-32b": {"kv_quant_decode": True},
}

MESH = "1xH100"
NO_MESH = ("the multi-pod mesh waits for the dry run's multi-device stand-ins (ROADMAP Queue 1 item 10, "
           "sub-item 4)")


def _mesh_knob(knob: str):
    """A variant whose knob is a sharding knob of the mesh path's GSPMD
    half, which the port lacks: it raises."""
    def variant(cfg, spec):
        raise NotImplementedError(f"the port has no {knob} knob (a sharding knob of the mesh path, "
                                  f"ROADMAP Queue 1 item 10, sub-item 2)")

    return variant


# Optional perf overrides applied on top of the baseline; selected with
# --variant. Each maps cfg -> cfg.
VARIANTS = {
    "w8": lambda cfg, spec: cfg.replace(weights_int8=True),
    "moetok": lambda cfg, spec: cfg.replace(moe_token_gather=True),
    "w8+moetok": lambda cfg, spec: cfg.replace(weights_int8=True, moe_token_gather=True),
    "sbf16": lambda cfg, spec: cfg.replace(attn_scores_bf16=True),
    "remat0": lambda cfg, spec: cfg.replace(remat="none"),
    "sp": _mesh_knob("seq_shard_activations"),
    "sbf16+remat0": lambda cfg, spec: cfg.replace(attn_scores_bf16=True, remat="none"),
    "sbf16+sp": _mesh_knob("seq_shard_activations"),
    "kvbf16": lambda cfg, spec: cfg.replace(kv_quant=False),
    "unroll": lambda cfg, spec: cfg.replace(scan_unroll=cfg.n_superblocks),
    "mb4": lambda cfg, spec: cfg,   # microbatches handled in run_cell
    "mb4+sbf16": lambda cfg, spec: cfg.replace(attn_scores_bf16=True),
}


def adjust_config(cfg, shape_spec, variant: str = ""):
    """Shape-dependent knobs: bound the plain attention's transient scores
    near 1.5 GB (the whole global batch is local on one card)."""
    kind = shape_spec.kind
    pol = POLICY.get(cfg.name, {})
    if kind == "decode" and pol.get("kv_quant_decode"):
        cfg = cfg.replace(kv_quant=True)
    if kind in ("train", "prefill"):
        # est score bytes: B_local * H * chunk * S * 4
        b_local = shape_spec.global_batch
        S = shape_spec.seq_len
        H = cfg.n_heads
        chunk = cfg.attn_chunk
        while chunk > 128 and b_local * H * chunk * S * 4 > 1.5e9:
            chunk //= 2
        if chunk != cfg.attn_chunk:
            cfg = cfg.replace(attn_chunk=chunk)
    if kind != "train":
        cfg = cfg.replace(remat="none")
    return cfg


def run_cell(arch: str, shape_name: str, multi_pod: bool = False, variant: str = "") -> dict:
    from repro_torch.configs.registry import get_config, skip_reason
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.cost import roofline_terms, step_cost
    from repro_torch.launch.flops import model_flops
    from repro_torch.launch.steps import lower_decode, lower_prefill, lower_train
    from repro_torch.models import get_model
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.tree import leaves

    if multi_pod:
        raise NotImplementedError(NO_MESH)
    spec = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": MESH, "variant": variant, "status": "ok"}
    skip = skip_reason(arch, shape_name)
    if skip:
        rec["status"] = "skip"
        rec["reason"] = skip
        return rec

    cfg = adjust_config(get_config(arch), spec, variant)
    if variant:
        if variant not in VARIANTS:
            raise KeyError(f"variant {variant!r}; known: {list(VARIANTS)}")
        cfg = VARIANTS[variant](cfg, spec)
    model = get_model(cfg)

    t0 = time.time()
    if spec.kind == "train":
        ocfg = OptConfig(state_dtype=POLICY.get(arch, {}).get("opt_dtype", "float32"))
        rec["opt_dtype"] = ocfg.state_dtype
        mb = 4 if variant.startswith("mb4") else 1
        lowered = lower_train(model, spec, ocfg, microbatches=mb)
    elif spec.kind == "prefill":
        lowered = lower_prefill(model, spec)
    else:
        rec["kv_quant"] = bool(cfg.kv_quant)
        lowered = lower_decode(model, spec)
    _, cost = step_cost(lowered, lowered.args, lowered.donated)
    rec["trace_s"] = round(time.time() - t0, 1)

    itemsize = torch.empty((), dtype=cfg.param_dtype).element_size()
    rec["params_bytes_per_dev"] = int(sum(math.prod(d.shape) * itemsize for d in leaves(model.param_defs())))
    arg, out, alias = cost["argument_bytes"], cost["output_bytes"], cost["alias_bytes"]
    temp = cost["peak_bytes"] - (out - alias)
    rec["mem"] = {
        "argument_bytes": arg,
        "output_bytes": out,
        "temp_bytes": temp,
        "alias_bytes": alias,
        "per_device_total": arg + temp + out - alias,
    }
    rec["cost"] = {
        "flops_per_dev": float(cost["flops"]),
        "mem_lo_bytes_per_dev": float(cost["mem_lo_bytes"]),
        "mem_bytes_per_dev": float(cost["mem_bytes"]),
        "coll_wire_bytes_per_dev": 0.0,
    }
    rec["roofline"] = roofline_terms(cost)
    mf = model_flops(model, spec)
    rec["model_flops_global"] = mf
    rec["useful_compute_ratio"] = (mf / cost["flops"]) if cost["flops"] else 0.0
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="")
    ap.add_argument("--outdir", default="dryrun_out")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    if args.mesh != "single":
        raise NotImplementedError(NO_MESH)

    from repro_torch.configs.registry import list_archs
    from repro_torch.configs.shapes import SHAPES

    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]

    failures = 0
    for arch in archs:
        for shape in shapes:
            tag = f"single__{arch}__{shape}"
            tag += f"__{args.variant}" if args.variant else ""
            path = outdir / f"{tag}.json"
            if path.exists() and not args.force:
                print(f"CACHED {tag}")
                continue
            print(f"RUN    {tag} ...", flush=True)
            try:
                rec = run_cell(arch, shape, False, args.variant)
            except NotImplementedError:
                raise
            except Exception as e:
                rec = {
                    "arch": arch, "shape": shape, "mesh": MESH,
                    "status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:],
                }
                failures += 1
            path.write_text(json.dumps(rec, indent=1))
            status = rec["status"]
            extra = ""
            if status == "ok":
                r = rec["roofline"]
                extra = (
                    f" bound={r['bound']} c={r['compute_s']*1e3:.2f}ms "
                    f"m={r['memory_s']*1e3:.2f}ms k={r['collective_s']*1e3:.2f}ms "
                    f"memGB={rec['mem']['per_device_total']/1e9:.2f} "
                    f"useful={rec['useful_compute_ratio']:.2f}"
                )
            print(f"DONE   {tag}: {status}{extra}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
