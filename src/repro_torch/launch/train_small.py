"""Train a reduced model end-to-end with checkpoint/restart fault tolerance
(the twin of ``examples/train_small.py``, its flags and lines kept).

    PYTHONPATH=src python -m repro_torch.launch.train_small [--steps 120] [--arch smollm-360m]
        [--ckpt-dir DIR] [--device cpu]

Trains the smoke config for half the steps, "crashes", and resumes from the
latest checkpoint (one every 20 steps) to the end; the loss must fall. The
checkpoint directory is removed at the end. ``--device`` defaults to the
card.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
from typing import List, Optional

from repro_torch.configs.registry import get_config
from repro_torch.models import get_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import DataConfig
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.schedule import WarmupCosine
from repro_torch.train.trainer import TrainConfig, Trainer


def make_trainer(cfg, steps: int, total_steps: int, ckpt_dir: Optional[str], device=None) -> Trainer:
    """A trainer that stops after ``steps`` of a ``total_steps`` schedule."""
    return Trainer(
        get_model(cfg),
        TrainConfig(steps=steps, ckpt_every=20, ckpt_dir=ckpt_dir, log_every=10, opt=OptConfig(lr=2e-3)),
        DataConfig(batch_size=4, seq_len=64, vocab_size=cfg.vocab_size, seed=7),
        schedule=WarmupCosine(peak_lr=2e-3, warmup_steps=10, total_steps=total_steps),
        device=device,
    )


def main(argv: Optional[List[str]] = None) -> dict:
    """Returns the crashed run's and the resumed run's trainer results and
    the checkpoint step the resume started from."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="straightline_ckpt_")
    cfg = get_config(args.arch, smoke=True).replace(attn_chunk=16, ce_chunks=2)

    half = args.steps // 2
    print(f"training {args.arch} (smoke) for {half} steps, then simulating a crash...")
    r1 = make_trainer(cfg, half, args.steps, ckpt_dir, args.device).run(seed=0)
    resumed_from = ckpt.latest_step(ckpt_dir)
    print(f"  crashed at step {r1['steps_done']}; latest checkpoint: {resumed_from}")

    print("restarting — auto-resume from checkpoint:")
    r2 = make_trainer(cfg, args.steps, args.steps, ckpt_dir, args.device).run(seed=0)
    hist = r2["history"]
    print(f"  resumed and finished at step {r2['steps_done']}")
    print(f"  loss: {hist[0]['loss']:.3f} (start) -> {hist[-1]['loss']:.3f} (final)")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise AssertionError(f"the loss did not fall: {hist[0]['loss']} -> {hist[-1]['loss']}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    print("OK — checkpoint/restart training complete")
    return {"crashed": r1, "resumed": r2, "resumed_from": resumed_from}


if __name__ == "__main__":
    main()
