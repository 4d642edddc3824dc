"""Learning-rate schedules (pure functions of step), in f32 as the JAX
package computes them (the torch twin of ``repro/train/schedule.py``). A
step given as a tensor keeps its device; a Python int gives a CPU tensor."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class WarmupCosine:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    final_frac: float = 0.1

    def __call__(self, step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = self.peak_lr * step / max(1, self.warmup_steps)
        prog = torch.clamp(
            (step - self.warmup_steps) / max(1, self.total_steps - self.warmup_steps), 0.0, 1.0
        )
        cos = self.peak_lr * (self.final_frac + (1 - self.final_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < self.warmup_steps, warm, cos)


@dataclass(frozen=True)
class Constant:
    lr: float = 3e-4

    def __call__(self, step):
        device = step.device if isinstance(step, torch.Tensor) else None
        return torch.tensor(self.lr, dtype=torch.float32, device=device)
