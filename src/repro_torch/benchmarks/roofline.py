"""§Roofline table (the torch twin of ``benchmarks/roofline.py``): read the
port's dry-run records (``launch/dryrun.py``) and emit the three-term
roofline per (arch x shape) on one H100 — compute/memory/collective
seconds, dominant bound, MODEL_FLOPS ratio, memory.

    python -m repro_torch.launch.dryrun --all
    python -m repro_torch.benchmarks.roofline [--dir dryrun_out]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.benchmarks.common import emit

DRYRUN = Path("dryrun_out")


def rows(directory: Path, mesh_prefix: str = "single"):
    return [json.loads(p.read_text()) for p in sorted(directory.glob(f"{mesh_prefix}__*.json"))]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=str(DRYRUN), help="the dry run's records")
    directory = Path(ap.parse_args(argv).dir)
    if not directory.exists():
        emit("roofline.missing", 0.0, "run python -m repro_torch.launch.dryrun --all first")
        return
    counts = {"compute": 0, "memory": 0, "collective": 0}
    for r in rows(directory, "single"):
        cell = f"{r['arch']}.{r['shape']}"
        if r["status"] == "skip":
            emit(f"roofline.{cell}", 0.0, "SKIP:" + r["reason"][:60])
            continue
        if r["status"] != "ok":
            emit(f"roofline.{cell}", 0.0, "ERROR")
            continue
        t = r["roofline"]
        counts[t["bound"]] += 1
        emit(
            f"roofline.{cell}",
            t["step_s_lower_bound"] * 1e6,
            (
                f"bound={t['bound']};c_ms={t['compute_s']*1e3:.2f};"
                f"m_ms={t['memory_s']*1e3:.2f};k_ms={t['collective_s']*1e3:.2f};"
                f"useful={r['useful_compute_ratio']:.2f};"
                f"memGB={r['mem']['per_device_total']/1e9:.1f}"
            ),
        )
    ok_multi = sum(1 for r in rows(directory, "multi") if r["status"] == "ok")
    skip_multi = sum(1 for r in rows(directory, "multi") if r["status"] == "skip")
    emit(
        "roofline.summary",
        0.0,
        f"bounds={counts};multi_pod_ok={ok_multi};multi_pod_skip={skip_multi}",
    )


if __name__ == "__main__":
    main()
