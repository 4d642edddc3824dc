"""Step builders (the torch twin of ``repro/launch/steps.py``): the train
step, with gradient accumulation over microbatches, the serving steps, and
the dry run's ``lower_*`` helpers, which put each step over meta stand-ins.
The JAX package's sharding trees wait for the port's sharding; PyTorch runs
each step eagerly, so nothing is jitted: a "lowered" step is the step and
its stand-ins, run once under ``launch/cost.CostCounter``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Mapping

import torch

from repro_torch.train.optimizer import OptConfig, adamw_update, opt_state_shapes
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


# ---------------------------------------------------------------------------
# Lowering helpers (the dry run)
# ---------------------------------------------------------------------------


@dataclass
class Lowered:
    """A step over its meta stand-ins: ``lowered()`` runs it once; ``args``
    are its arguments and ``donated`` those its outputs take the place of
    (the parameters and states in training, the cache in decode)."""

    step: Callable
    args: tuple
    donated: tuple = ()

    def __call__(self):
        return self.step(*self.args)


def lower_train(model, shape_spec, ocfg: OptConfig, microbatches: int = 1) -> Lowered:
    pshapes = model.param_shapes()
    oshapes = opt_state_shapes(pshapes, ocfg)
    inputs = model.input_specs(shape_spec)
    step = make_train_step(model, ocfg, microbatches=microbatches)
    return Lowered(step, (pshapes, oshapes, inputs), (pshapes, oshapes))


def _serve_params(model):
    """The serving parameters' stand-ins: weight-only int8 when enabled."""
    pshapes = model.param_shapes()
    if model.cfg.weights_int8:
        from repro_torch.models.quant import quantized_shape_tree

        pshapes = quantized_shape_tree(pshapes)
    return pshapes


def lower_prefill(model, shape_spec) -> Lowered:
    inputs = model.input_specs(shape_spec)
    step = make_prefill_step(model, cap=shape_spec.seq_len)
    return Lowered(step, (_serve_params(model), inputs))


def lower_decode(model, shape_spec) -> Lowered:
    """One decode step over a dense cache of ``seq_len`` positions, written
    at its last one: ``cache_index`` is that host int (the port's decode
    reads it on the host; a meta tensor has no value to read)."""
    B, S = shape_spec.global_batch, shape_spec.seq_len
    inputs = dict(model.input_specs(shape_spec), cache_index=S - 1)
    cache = model.init_cache(B, S, "meta")          # cache_defs(B, S), nothing allocated
    return Lowered(make_decode_step(model), (_serve_params(model), cache, inputs), (cache,))
