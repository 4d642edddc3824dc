#!/usr/bin/env python3
"""How far f32 rounding alone moves a model's training gradients, on the CPU.

    PYTHONPATH=src python scripts/train_grad_sensitivity.py [--arch smollm-360m xlstm-350m]

For each SMOKE config (f32, remat full, seeded weights, a SyntheticLM batch
of 2 x 32 tokens), the gradient of every parameter leaf is taken once on the
weights and once on the weights times (1 + eps * n), n seeded standard
normal, for eps 1e-7 (about f32's rounding) and 1e-6. Prints, per eps, the
loss difference and the largest gradient difference over the leaf's largest
magnitude (or 1), with that leaf's path: the spread a card-against-CPU
gradient comparison of the model cannot go below. One JSON line at the end.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["smollm-360m", "xlstm-350m"])
    args = ap.parse_args()
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import get_model
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.tree import leaves, map_tree, paths

    out = {}
    for arch in args.arch:
        cfg = get_config(arch, smoke=True).replace(remat="full")
        model = get_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        data = SyntheticLM(DataConfig(batch_size=2, seq_len=32, vocab_size=cfg.vocab_size, seed=1))
        batch = {k: torch.from_numpy(v) for k, v in data.batch_at(0).items()}
        (loss, _), grads = value_and_grad(model, params, batch)
        g = torch.Generator().manual_seed(5)
        out[arch] = {}
        for eps in (1e-7, 1e-6):
            moved = map_tree(lambda t: t * (1 + eps * torch.randn(t.shape, generator=g)), params)
            (loss_m, _), grads_m = value_and_grad(model, moved, batch)
            err, path = max((float((a - b).abs().max()) / max(1.0, float(b.abs().max())), p)
                            for p, a, b in zip(paths(grads), leaves(grads_m), leaves(grads)))
            out[arch][str(eps)] = {"loss_diff": abs(float(loss_m) - float(loss)), "grad_diff": err, "leaf": path}
            print(f"{arch} eps {eps:g}: loss |d| {abs(float(loss_m) - float(loss)):.3e}, largest gradient "
                  f"difference {err:.3e} of its leaf's largest ({path})")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
