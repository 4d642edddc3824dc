"""Training launcher (the twin of ``repro/launch/train.py``, every flag kept).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m          # FULL, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 20
        [--ckpt-dir DIR] [--ckpt-every N] [--opt-dtype float32|bfloat16|int8] [--data FILE]

AdamW (``--opt-dtype`` states) under a WarmupCosine schedule peaking at
``--lr`` (warmup max(5, steps / 10) steps) over ``--steps`` steps of
``--batch-size`` x ``--seq-len`` tokens from ``SyntheticLM`` (or a token
file, ``--data``); a checkpoint every ``--ckpt-every`` steps into
``--ckpt-dir``, from whose latest checkpoint a run resumes; SIGTERM saves
and exits. ``--log-every`` sets how often a step's metrics are kept (the
reference keeps every 10th).

Where the JAX launcher always trains the smoke configuration (with
``attn_chunk=64, ce_chunks=2``), this one trains the FULL model (bf16, the
config's ``remat`` and ``ce_chunks``) unless ``--smoke`` is given, and
``--device`` defaults to the card.
"""
from __future__ import annotations

import argparse
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true", help="the smoke config (default: FULL)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--opt-dtype", default="float32", choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--data", default=None, help="token .bin file (default: synthetic)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Train as the flags say; returns the trainer's result (params,
    opt_state, history, steps_done, wall_s, preempted)."""
    args = parse_args(argv)

    from repro_torch.configs.registry import get_config
    from repro_torch.models import get_model
    from repro_torch.train.data import DataConfig
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.schedule import WarmupCosine
    from repro_torch.train.trainer import TrainConfig, Trainer

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.smoke:
        cfg = cfg.replace(attn_chunk=64, ce_chunks=2)
    trainer = Trainer(
        get_model(cfg),
        TrainConfig(
            steps=args.steps,
            ckpt_every=args.ckpt_every,
            ckpt_dir=args.ckpt_dir,
            log_every=args.log_every,
            opt=OptConfig(lr=args.lr, state_dtype=args.opt_dtype),
        ),
        DataConfig(
            batch_size=args.batch_size,
            seq_len=args.seq_len,
            vocab_size=cfg.vocab_size,
            path=args.data,
            seed=args.seed,
        ),
        schedule=WarmupCosine(peak_lr=args.lr, warmup_steps=max(5, args.steps // 10), total_steps=args.steps),
        device=args.device,
    )
    trainer.install_preemption_handler()
    r = trainer.run(seed=args.seed)
    h = r["history"]
    print(
        f"{args.arch}: {r['steps_done']} steps in {r['wall_s']:.1f}s | "
        f"loss {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f}"
        + (" | PREEMPTED (checkpoint saved)" if r["preempted"] else "")
    )
    return r


if __name__ == "__main__":
    main()
