"""Paper Fig 3: model-development convergence on two resource profiles (the
twin of ``benchmarks/fig3_training.py``, the same rows).

The paper trains Xception on a CPU vs GPU cluster and reports that the GPU
cluster reaches stable accuracy in 1-2 epochs vs 9-10. The analogue here:
the same reduced LM trained under a small-batch profile (CPU-class) and a
large-batch profile (accelerator-class); the large-batch profile reaches the
loss target in fewer optimizer steps. Also trains the Xception-analog
classifier itself (the paper's own app model).

    PYTHONPATH=src python -m repro_torch.benchmarks.fig3_training              # on the card
    PYTHONPATH=src python -m repro_torch.benchmarks.fig3_training --device cpu

The port cannot replay ``jax.random``: each function draws its initial
weights from a ``torch.Generator`` seeded 0 unless given ``params``.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from repro_torch.benchmarks.common import emit
from repro_torch.configs.registry import get_config
from repro_torch.models import get_model, xception
from repro_torch.models.common import resolve_device
from repro_torch.models.xception import XceptionConfig
from repro_torch.train.data import DataConfig
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import TrainConfig, Trainer

LM_TARGET = 4.5
XC_LR, XC_BATCH, XC_STEPS = 1e-2, 32, 60


def lm_profile(name: str, batch: int, steps: int, device=None, params=None) -> dict:
    """smollm-360m SMOKE under AdamW for ``steps`` steps of ``batch`` x 32
    tokens; emits the row and returns the trainer's result."""
    cfg = get_config("smollm-360m", smoke=True).replace(attn_chunk=16, ce_chunks=2)
    tr = Trainer(
        get_model(cfg),
        TrainConfig(steps=steps, ckpt_every=10**9, ckpt_dir=None, log_every=1, opt=OptConfig(lr=2e-3)),
        DataConfig(batch_size=batch, seq_len=32, vocab_size=cfg.vocab_size, seed=5),
        device=device,
    )
    r = tr.run(params=params, seed=0)
    losses = [h["loss"] for h in r["history"]]
    hit = next((h["step"] for h in r["history"] if h["loss"] < LM_TARGET), -1)
    emit(
        f"fig3.lm.{name}",
        r["wall_s"] / max(1, r["steps_done"]) * 1e6,
        f"loss0={losses[0]:.3f};lossN={losses[-1]:.3f};steps_to_{LM_TARGET}={hit}",
    )
    return r


def task_batch(rng: np.random.Generator, batch: int, size: int):
    """The 4-class synthetic image task (class-dependent color bias, so
    learnable): labels (batch,) and NHWC images, numpy."""
    lab = rng.integers(0, 4, batch)
    img = rng.normal(0, 1, (batch, size, size, 3)).astype(np.float32)
    img[..., 0] += lab[:, None, None] * 1.5
    return img, lab


def sgd_step(cfg: XceptionConfig, params: dict, img, lab, lr: float = XC_LR):
    """One plain SGD step: (new params, the metrics before the step)."""
    (_, m), g = xception.value_and_grad(cfg, params, img, lab)
    return {k: p - lr * g[k] for k, p in params.items()}, m


def xception_train(device=None, params=None) -> List[float]:
    """The Xception analog at 32 px, 60 SGD steps of 32 images from
    ``default_rng(0)``; emits the row and returns each step's accuracy."""
    dev = resolve_device(device)
    cfg = XceptionConfig(img_size=32, width=16, n_blocks=2)
    if params is None:
        params = xception.init(torch.Generator(dev).manual_seed(0), cfg, dev)
    params = {k: v.to(dev) for k, v in params.items()}
    rng = np.random.default_rng(0)
    accs = []
    for _ in range(XC_STEPS):
        img, lab = task_batch(rng, XC_BATCH, cfg.img_size)
        params, m = sgd_step(cfg, params, torch.from_numpy(img).to(dev), torch.from_numpy(lab).to(dev))
        accs.append(float(m["acc"]))
    emit(
        "fig3.xception_analog",
        0.0,
        f"acc_first10={np.mean(accs[:10]):.3f};acc_last10={np.mean(accs[-10:]):.3f}",
    )
    return accs


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    dev = resolve_device(ap.parse_args(argv).device)
    lm_profile("small_batch_cpu_profile", batch=2, steps=40, device=dev)
    lm_profile("large_batch_accel_profile", batch=8, steps=40, device=dev)
    xception_train(device=dev)


if __name__ == "__main__":
    main()
