"""Step builders and sharding trees (the torch twin of
``repro/launch/steps.py``): the param, batch, cache and optimizer sharding
trees, the train step, with gradient accumulation over microbatches, the
serving steps, and the dry run's ``lower_*`` helpers, which put each step
over meta stand-ins. PyTorch runs each step eagerly, so nothing is jitted:
a "lowered" step is the step and its stand-ins, run once under
``launch/cost.CostCounter``.

The trees hold ``sharding.axes.NamedSharding`` leaves (None without a
ctx), spec for spec those of the JAX package. ``NamedSharding.distribute``
puts a full tensor on the mesh as a DTensor of that layout. A train step
over a ctx of more than one device takes DTensor parameters and states and
returns them in the same layouts: every gradient is redistributed to its
parameter's placements before the update, as JAX's compiled step gives each
gradient in its parameter's sharding. Over a ctx of one device the step is
the single-device step (DTensor leaves on that mesh are computed on as
their local tensors)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Mapping, Optional

import torch

from repro_torch.models.common import map_defs
from repro_torch.models.transformer import sharded
from repro_torch.sharding.axes import (MeshCtx, NamedSharding, P, Rules, full_value, is_dtensor, like,
                                      with_sharding_constraint)
from repro_torch.train.optimizer import OptConfig, _block_for, adamw_update, opt_state_shapes
from repro_torch.train.tree import leaves, map_tree, unflatten

# ---------------------------------------------------------------------------
# Sharding trees
# ---------------------------------------------------------------------------


def param_shardings(model, ctx: Optional[MeshCtx], fsdp: bool):
    return Rules(ctx, fsdp_params=fsdp).sharding_tree(model.param_defs())


def _ns(ctx, spec):
    return NamedSharding(ctx.mesh, spec) if ctx is not None else None


def batch_shardings(ctx: Optional[MeshCtx], input_specs: Mapping, global_batch: int):
    """Batch entries over the batch axes: M-RoPE positions (3, B, S) on
    their second dim, every entry whose first dim is the global batch on
    its first, the rest replicated."""
    if ctx is None:
        return {k: None for k in input_specs}
    out = {}
    for name, t in input_specs.items():
        shp = tuple(t.shape)
        if name == "positions" and len(shp) == 3:
            out[name] = _ns(ctx, P(None, ctx.batch_spec_for(shp[1]), None))
        elif shp and shp[0] == global_batch:
            out[name] = _ns(ctx, P(ctx.batch_spec_for(shp[0]), *([None] * (len(shp) - 1))))
        else:
            out[name] = _ns(ctx, P(*([None] * len(shp))))
    return out


def cache_shardings(ctx: Optional[MeshCtx], cache_defs: Any):
    """Decode caches: axis 1 = batch; the KV sequence (attention) and the
    channel dims (recurrent states) over the model axis where they divide;
    cross-attention K/V over the batch only."""
    def walk(node, name: str = "", parent: str = ""):
        if isinstance(node, Mapping):
            return {k: walk(v, k, name) for k, v in node.items()}
        if ctx is None:
            return None
        shape = tuple(node.shape)
        nd, tpn = len(shape), ctx.tp_size
        ax = [None] * nd
        if nd >= 2:
            ax[1] = ctx.batch_spec_for(shape[1])
        if "cross" in parent:
            pass
        elif name in ("k", "v", "k_scale", "v_scale") and nd >= 3:
            if shape[2] % tpn == 0:
                ax[2] = ctx.tp_axis
        elif name == "conv" and nd == 4:
            if shape[3] % tpn == 0:
                ax[3] = ctx.tp_axis
        elif name == "ssm" and nd == 4:
            if shape[2] % tpn == 0:
                ax[2] = ctx.tp_axis
        elif name in ("C", "n", "c", "h") and nd >= 4:
            if shape[3] % tpn == 0:
                ax[3] = ctx.tp_axis
        return NamedSharding(ctx.mesh, P(*ax))

    return walk(cache_defs)


def opt_shardings(model, ctx: Optional[MeshCtx], ocfg: OptConfig):
    """ZeRO-1: f32/bf16 states share the (fsdp-extended) param specs; int8
    blockwise states are shape-preserving (``optimizer.quantize_blockwise``):
    q shares the param's spec, the per-block scale drops the last-dim
    sharding (an unquantizable leaf's scale, value[..., None], keeps it and
    adds a replicated dim)."""
    defs = model.param_defs()
    int8 = ocfg.state_dtype == "int8"
    if ctx is None:
        none = map_defs(lambda d: {"q": None, "scale": None} if int8 else None, defs)
        return {"m": none, "v": none, "step": None}
    rules = Rules(ctx, fsdp_params=True)

    def leaf(d):
        spec = rules.spec_for(d)
        if not int8:
            return NamedSharding(ctx.mesh, spec)
        s_spec = list(spec) + [None] * (len(d.shape) - len(spec))
        if _block_for(d.shape[-1] if d.shape else 1) == 0:
            s_spec = s_spec + [None]
        else:
            s_spec[-1] = None
        return {"q": NamedSharding(ctx.mesh, spec), "scale": NamedSharding(ctx.mesh, P(*s_spec))}

    tree = map_defs(leaf, defs)
    return {"m": tree, "v": tree, "step": NamedSharding(ctx.mesh, P())}


def distribute_tree(tree: Any, shardings: Any) -> Any:
    """Each leaf of ``tree`` put on the mesh by its ``NamedSharding`` (the
    port's ``jax.tree.map(jax.device_put, tree, shardings)``: a full tensor
    cut, a DTensor redistributed); a None sharding leaves the leaf as it
    is. A None or single sharding may stand for a whole subtree."""
    if isinstance(tree, Mapping):
        return {k: distribute_tree(v, shardings[k] if isinstance(shardings, Mapping) else shardings)
                for k, v in tree.items()}
    return tree if shardings is None else with_sharding_constraint(tree, shardings)


def value_and_grad(model, params: Any, batch: Mapping, ctx: Optional[MeshCtx] = None):
    """((loss, metrics), grads): the loss of ``model.loss`` and its gradient
    for every parameter leaf (zeros where the loss does not reach a leaf, as
    ``jax.grad`` gives them). ``params`` is not changed: the gradient is
    taken through detached views of its leaves. On a mesh (DTensor
    parameters) every gradient is redistributed to its parameter's
    placements, and the loss and metrics are plain tensors."""
    p = map_tree(lambda t: t.detach().requires_grad_(True), params)
    flat = leaves(p)
    with torch.enable_grad():
        loss, metrics = model.loss(p, batch, ctx=ctx) if sharded(ctx) else model.loss(p, batch)
        got = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(flat, got)]
    if sharded(ctx):
        grads = [g.redistribute(t.device_mesh, t.placements) for t, g in zip(flat, grads)]
        bad = [i for i, (t, g) in enumerate(zip(flat, grads)) if tuple(g.placements) != tuple(t.placements)]
        if bad:
            raise AssertionError(f"gradients {bad} are not in their parameters' placements")
    return ((full_value(loss).detach(), {k: full_value(v).detach() for k, v in metrics.items()}),
            unflatten(params, grads))


def _local(tree):
    """DTensor leaves as their local tensors (a mesh of one device)."""
    return map_tree(lambda t: t.to_local() if is_dtensor(t) else t, tree)


def _like(tree, ref):
    """``tree``'s leaves as DTensors of ``ref``'s corresponding layouts
    where ``ref``'s are DTensors."""
    return unflatten(ref, [like(t, r) if is_dtensor(r) else t for t, r in zip(leaves(tree), leaves(ref))])


def _split(x, microbatches: int):
    """(microbatches, ...) slices of a batch entry along its first axis, or
    the entry repeated where that axis does not divide (M-RoPE's (3, B, S)
    positions), as the reference reshapes or broadcasts."""
    x = torch.as_tensor(x)
    if x.ndim >= 1 and x.shape[0] % microbatches == 0:
        return x.reshape((microbatches, x.shape[0] // microbatches) + tuple(x.shape[1:]))
    return x.expand((microbatches,) + tuple(x.shape))


def make_train_step(model, ocfg: OptConfig, schedule=None, microbatches: int = 1,
                    ctx: Optional[MeshCtx] = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``. microbatches > 1: gradient accumulation, the global batch
    split on axis 0; the gradients accumulate in bf16 (``acc + g.to(bf16) /
    microbatches``, as the reference's scan does) and the loss and metrics
    are the microbatches' means. With ``ctx`` over more than one device the
    parameters and states are DTensors (``param_shardings``,
    ``opt_shardings``) and the batch's entries full tensors or DTensors;
    over one device DTensor leaves on its mesh are stepped as their local
    tensors and returned in their layouts."""

    def train_step(params, opt_state, batch):
        if ctx is not None and not sharded(ctx):
            new_p, new_o, metrics = step(_local(params), _local(opt_state), _local(batch))
            return _like(new_p, params), _like(new_o, opt_state), metrics
        return step(params, opt_state, batch)

    def step(params, opt_state, batch):
        if microbatches > 1:
            mb = {k: _split(v, microbatches) for k, v in batch.items()}
            grads = map_tree(lambda t: torch.zeros_like(t, dtype=torch.bfloat16), params)
            losses, ms = [], []
            for i in range(microbatches):
                (loss, metrics), g = value_and_grad(model, params, {k: v[i] for k, v in mb.items()}, ctx)
                grads = map_tree(lambda a, b: a + b.to(a.dtype) / microbatches, grads, g)
                losses.append(loss)
                ms.append(metrics)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean(dim=0) for k in ms[0]}
        else:
            (loss, metrics), grads = value_and_grad(model, params, batch, ctx)
        lr = schedule(full_value(opt_state["step"])) if schedule is not None else None
        new_params, new_opt, stats = adamw_update(grads, opt_state, params, ocfg, lr=lr)
        metrics = dict(metrics)
        metrics.update(stats)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return train_step


def make_prefill_step(model, cap: int = 0, ctx: Optional[MeshCtx] = None):
    def prefill_step(params, batch):
        return model.prefill(params, batch, cap=cap, ctx=ctx)

    return prefill_step


def make_decode_step(model, ctx: Optional[MeshCtx] = None):
    def decode_step(params, cache, batch):
        return model.decode(params, cache, batch, ctx=ctx)

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


def _on_mesh(ctx) -> None:
    """The dry run traces one device's step on meta stand-ins; the mesh's
    stand-ins wait for ROADMAP Queue 1 item 10, sub-item 4."""
    if sharded(ctx):
        raise NotImplementedError("the dry run on a multi-device mesh waits for ROADMAP Queue 1 item 10, "
                                  "sub-item 4")


def lower_train(model, shape_spec, ocfg: OptConfig, microbatches: int = 1, *, ctx=None) -> Lowered:
    _on_mesh(ctx)
    pshapes = model.param_shapes()
    oshapes = opt_state_shapes(pshapes, ocfg)
    inputs = model.input_specs(shape_spec)
    step = make_train_step(model, ocfg, microbatches=microbatches, ctx=ctx)
    return Lowered(step, (pshapes, oshapes, inputs), (pshapes, oshapes))


def _serve_params(model, ctx=None):
    """(the serving parameters' stand-ins, their shardings): weight-only
    int8 when enabled, the shardings through ``quantized_sharding_tree``."""
    pshapes = model.param_shapes()
    psh = param_shardings(model, ctx, fsdp=False)
    if model.cfg.weights_int8:
        from repro_torch.models.quant import quantized_shape_tree, quantized_sharding_tree

        psh = quantized_sharding_tree(psh, pshapes)
        pshapes = quantized_shape_tree(pshapes)
    return pshapes, psh


def lower_prefill(model, shape_spec, *, ctx=None) -> Lowered:
    _on_mesh(ctx)
    inputs = model.input_specs(shape_spec)
    step = make_prefill_step(model, cap=shape_spec.seq_len, ctx=ctx)
    return Lowered(step, (_serve_params(model, ctx)[0], inputs))


def lower_decode(model, shape_spec, *, ctx=None) -> Lowered:
    """One decode step over a dense cache of ``seq_len`` positions, written
    at its last one: ``cache_index`` is that host int (the port's decode
    reads it on the host; a meta tensor has no value to read)."""
    _on_mesh(ctx)
    B, S = shape_spec.global_batch, shape_spec.seq_len
    inputs = dict(model.input_specs(shape_spec), cache_index=S - 1)
    cache = model.init_cache(B, S, "meta")          # cache_defs(B, S), nothing allocated
    return Lowered(make_decode_step(model, ctx=ctx), (_serve_params(model, ctx)[0], cache, inputs), (cache,))
