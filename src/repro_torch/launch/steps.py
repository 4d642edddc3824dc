"""Step builders (the torch twin of ``repro/launch/steps.py``): the train
step, with gradient accumulation over microbatches, and the serving steps.
The JAX package's sharding trees and ``lower_*`` helpers wait for the
port's sharding; PyTorch runs each step eagerly, so nothing is jitted."""
from __future__ import annotations

from typing import Any, Mapping

import torch

from repro_torch.train.optimizer import OptConfig, adamw_update
from repro_torch.train.tree import leaves, map_tree, unflatten


def value_and_grad(model, params: Any, batch: Mapping):
    """((loss, metrics), grads): the loss of ``model.loss`` and its gradient
    for every parameter leaf (zeros where the loss does not reach a leaf, as
    ``jax.grad`` gives them). ``params`` is not changed: the gradient is
    taken through detached views of its leaves."""
    p = map_tree(lambda t: t.detach().requires_grad_(True), params)
    flat = leaves(p)
    with torch.enable_grad():
        loss, metrics = model.loss(p, batch)
        got = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(flat, got)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), unflatten(params, grads)


def _split(x, microbatches: int):
    """(microbatches, ...) slices of a batch entry along its first axis, or
    the entry repeated where that axis does not divide (M-RoPE's (3, B, S)
    positions), as the reference reshapes or broadcasts."""
    x = torch.as_tensor(x)
    if x.ndim >= 1 and x.shape[0] % microbatches == 0:
        return x.reshape((microbatches, x.shape[0] // microbatches) + tuple(x.shape[1:]))
    return x.expand((microbatches,) + tuple(x.shape))


def make_train_step(model, ocfg: OptConfig, schedule=None, microbatches: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``. microbatches > 1: gradient accumulation, the global batch
    split on axis 0; the gradients accumulate in bf16 (``acc + g.to(bf16) /
    microbatches``, as the reference's scan does) and the loss and metrics
    are the microbatches' means."""

    def train_step(params, opt_state, batch):
        if microbatches > 1:
            mb = {k: _split(v, microbatches) for k, v in batch.items()}
            grads = map_tree(lambda t: torch.zeros(t.shape, dtype=torch.bfloat16, device=t.device), params)
            losses, ms = [], []
            for i in range(microbatches):
                (loss, metrics), g = value_and_grad(model, params, {k: v[i] for k, v in mb.items()})
                grads = map_tree(lambda a, b: a + b.to(a.dtype) / microbatches, grads, g)
                losses.append(loss)
                ms.append(metrics)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean(dim=0) for k in ms[0]}
        else:
            (loss, metrics), grads = value_and_grad(model, params, batch)
        lr = schedule(opt_state["step"]) if schedule is not None else None
        new_params, new_opt, stats = adamw_update(grads, opt_state, params, ocfg, lr=lr)
        metrics = dict(metrics)
        metrics.update(stats)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return train_step


def make_prefill_step(model, cap: int = 0):
    def prefill_step(params, batch):
        return model.prefill(params, batch, cap=cap)

    return prefill_step


def make_decode_step(model):
    def decode_step(params, cache, batch):
        return model.decode(params, cache, batch)

    return decode_step
