"""CLI for the port's static-analysis tier: ``python -m repro_torch.analysis``.

Runs locklint + lockorder + kernelcheck over the port, prints every finding
(suppressed ones tagged with their reason), and exits nonzero if any finding
is unsuppressed. ``--emit-graph DIR`` regenerates the lock-order artifacts
(``lock_order_torch.json`` / ``lock_order_torch.dot``); ``--check-graph
FILE`` fails if the committed JSON artifact is stale relative to the tree.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List

from .common import Finding, SourceFile, render_report, unsuppressed
from .kernelcheck import KernelCheck
from .locklint import LockLint
from .lockorder import LockOrder

#: the concurrency surface: every module of the port that creates or takes a lock
CONCURRENCY_MODULES = (
    "src/repro_torch/core/router.py",
    "src/repro_torch/core/telemetry.py",
    "src/repro_torch/core/tracing.py",
    "src/repro_torch/serving/scheduler.py",
    "src/repro_torch/serving/engine.py",
    "src/repro_torch/serving/prefix_cache.py",
    "src/repro_torch/kernels/_build.py",
    "src/repro_torch/launch/serve.py",
    "src/repro_torch/launch/serve_hybrid.py",
)
#: the kernel wrappers, for lockorder's device-dispatch resolution
DISPATCH_GLOB = "src/repro_torch/kernels/*/ops.py"
KERNELS = "src/repro_torch/kernels"
GRAPH_STEM = "lock_order_torch"


def repo_root() -> Path:
    here = Path(__file__).resolve()
    for parent in here.parents:
        if (parent / "src" / "repro_torch").is_dir() and (parent / "ROADMAP.md").exists():
            return parent
    return here.parents[3]


def load_concurrency_sources(root: Path) -> List[SourceFile]:
    """Load the concurrency modules with repo-relative paths, so findings and
    the committed graph artifact are machine-independent."""
    out = []
    for rel in CONCURRENCY_MODULES:
        p = root / rel
        if p.exists():
            out.append(SourceFile.from_text(rel, p.read_text()))
    return out


def load_dispatch_sources(root: Path) -> List[SourceFile]:
    return [SourceFile.from_text(str(p.relative_to(root)), p.read_text())
            for p in sorted(root.glob(DISPATCH_GLOB))]


def build_graph(root: Path) -> LockOrder:
    graph = LockOrder(load_concurrency_sources(root), load_dispatch_sources(root))
    graph.build()
    return graph


def run_all(root: Path, only: List[str]) -> tuple:
    """(findings, LockOrder graph) for the requested analyzers."""
    findings: List[Finding] = []
    graph = None
    if "locklint" in only:
        findings += LockLint(load_concurrency_sources(root)).run()
    if "lockorder" in only:
        graph = build_graph(root)
        findings += graph.check()
    if "kernelcheck" in only:
        findings += KernelCheck(str(root / KERNELS), str(root / "tests")).run()
    return findings, graph


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.analysis", description=__doc__)
    ap.add_argument("--only", default="locklint,lockorder,kernelcheck",
                    help="comma-separated analyzer subset")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument("--emit-graph", metavar="DIR",
                    help=f"write {GRAPH_STEM}.json + {GRAPH_STEM}.dot into DIR")
    ap.add_argument("--check-graph", metavar="FILE",
                    help="fail if FILE differs from the freshly-extracted graph")
    ap.add_argument("--root", default=None, help="repo root (default: auto)")
    args = ap.parse_args(argv)

    root = Path(args.root).resolve() if args.root else repo_root()
    only = [t.strip() for t in args.only.split(",") if t.strip()]
    findings, graph = run_all(root, only)

    rc = 0
    if args.emit_graph or args.check_graph:
        if graph is None:
            graph = build_graph(root)
        doc = json.dumps(graph.to_json(), indent=2, sort_keys=True) + "\n"
        if args.emit_graph:
            out = Path(args.emit_graph)
            out.mkdir(parents=True, exist_ok=True)
            (out / f"{GRAPH_STEM}.json").write_text(doc)
            (out / f"{GRAPH_STEM}.dot").write_text(graph.to_dot())
            print(f"lock-order graph: {out}/{GRAPH_STEM}.{{json,dot}} "
                  f"({len(graph.edges)} edges)", file=sys.stderr)
        if args.check_graph:
            committed = Path(args.check_graph)
            if not committed.exists() or committed.read_text() != doc:
                print(f"lock-order artifact {committed} is stale; regenerate with "
                      f"`python -m repro_torch.analysis --emit-graph {committed.parent}`",
                      file=sys.stderr)
                rc = 1

    live = unsuppressed(findings)
    if args.json:
        print(json.dumps([f.to_json() for f in findings], indent=2))
    else:
        report = render_report(findings, show_suppressed=True)
        if report:
            print(report)
        n_sup = len(findings) - len(live)
        print(f"repro_torch.analysis: {len(live)} finding(s), {n_sup} suppressed "
              f"({', '.join(only)})", file=sys.stderr)
    return 1 if live else rc


if __name__ == "__main__":
    raise SystemExit(main())
