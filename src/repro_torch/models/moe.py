"""Mixture-of-experts FFN with expert parallelism over the TP ('model') axis
(the torch twin of ``repro/models/moe.py``).

Every token picks its ``top_k`` experts by router probability; each expert
then keeps its top-C tokens by gate weight (C = ``capacity_for`` the token
count) and drops the rest (Switch/GShard semantics). All experts compute
their C slots whatever the routing, as the reference does.

Both top-k's break ties as ``jax.lax.top_k`` does, the lower index first:
a stable descending sort, on the CPU and on the card (``torch.topk``
promises no order among equal values, and identical rows, such as idle
decode slots holding the same stale token, tie exactly). The combine is
deterministic: each expert's C token indices are distinct, so the gated
outputs scatter into an (E, T, d) buffer without collisions and are summed
over E, where an ``index_add_`` over all E * C rows would add with atomics
in an order that varies between runs on the card.

The expert products go through ``quant.qeinsum``, so the expert weights may
be weight-only int8 ({"q", "s"} dicts with scales (E, 1, f)), as the JAX
package's ``_experts_ffn`` takes them; the router stays floating point.

On a mesh (``ctx`` with a 'model' axis over 1) each rank holds the experts
``[e_off, e_off + E/tp)`` and runs the JAX package's ``shard_map`` body on
its own blocks (``moe_in_specs``), with ``torch.distributed`` collectives
(``sharding/collectives.py``) in place of JAX's:
  * weight gather: under ``fsdp_experts`` all-gather the d_ff shards over
    'data', route the rank's tokens to its experts at the capacity of its
    own token count, all-reduce the output over 'model' and average the aux
    over the batch axes;
  * token gather (``moe_token_gather`` with ``fsdp_experts`` and a sharded
    batch): all-gather the tokens over the batch axes instead, keep the
    experts sharded, all-reduce the partial outputs over 'data' and 'model'
    and take the rank's tokens back out.
The single-device path is the oracle of both.
"""
from __future__ import annotations

import functools
from typing import Mapping, Optional, Tuple

import torch

from repro_torch.models.common import FSDP, NULL, TP, ModelConfig, ParamDef, activation
from repro_torch.models.quant import qeinsum
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.axes import P, PartitionSpec, coordinate, shard_block


def moe_defs(cfg: ModelConfig) -> dict:
    m = cfg.moe
    d, f, E = cfg.d_model, cfg.d_ff, m.n_experts
    ff_axis = FSDP if m.fsdp_experts else NULL
    defs = {
        "router": ParamDef((d, E), (NULL, NULL)),
        "w1": ParamDef((E, d, f), (TP, NULL, ff_axis)),
        "w2": ParamDef((E, f, d), (TP, ff_axis, NULL)),
    }
    if cfg.gated_mlp:
        defs["w3"] = ParamDef((E, d, f), (TP, NULL, ff_axis))
    return defs


def capacity_for(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` tokens: int(cf * k * n / E) + 1 in
    Python floats, clamped to [4, n]."""
    m = cfg.moe
    c = int(m.capacity_factor * m.top_k * n_tokens / m.n_experts) + 1
    return min(max(c, 4), n_tokens)


@functools.lru_cache(maxsize=64)
def _capacity_table(cfg: ModelConfig, T: int, device: torch.device) -> torch.Tensor:
    """[0, capacity_for(1), ..., capacity_for(T)] on ``device``, built once
    per (config, T, device): indexed by a padded prefill's count of valid
    tokens on the device, with no read back to the host."""
    return torch.tensor([0] + [capacity_for(cfg, t) for t in range(1, T + 1)], dtype=torch.long,
                        device=device)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values along the last axis and their indices, ties
    broken by the lower index first (``jax.lax.top_k``'s order)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def route(cfg: ModelConfig, logits: torch.Tensor, capacity: int, valid=None, e_offset: int = 0,
          n_local: Optional[int] = None) -> dict:
    """The routing of T tokens over the experts ``[e_offset, e_offset +
    n_local)`` (all E by default) from f32 router logits over all E (T, E):
    ``probs`` (T, E); ``topv``/``topi`` (T, k), the normalized gate weights
    and global expert ids of each token; ``w_te`` (E_local, T), each token's
    gate weight at each local expert (0 where not chosen); ``assigned``
    (E_local, T); ``sel_idx`` (E_local, C), each expert's top-C tokens by
    ``assigned + w_te``; ``sel_valid`` (E_local, C), the kept slots
    (assigned, and with ``valid`` within the capacity of the valid token
    count); ``gate`` (E_local, C), the kept slots' weights. ``valid`` (T,)
    bool marks right-padded prefill: a pad token neither claims a slot nor
    gets output."""
    m = cfg.moe
    T, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    topv, topi = top_k(probs, m.top_k)
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)

    eids = e_offset + torch.arange(E if n_local is None else n_local, device=logits.device)
    match = topi[None, :, :] == eids[:, None, None]                # (E_local, T, k)
    if valid is not None:
        match = match & valid[None, :, None]
    w_te = (match * topv[None]).sum(-1)                            # (E_local, T)
    assigned = match.any(-1)                                       # (E_local, T)

    score = assigned.float() + w_te
    sel_idx = top_k(score, capacity)[1]                            # (E_local, C)
    sel_valid = torch.gather(assigned, 1, sel_idx)
    if valid is not None:
        # capacity of the valid token count, not of the padded T: exactly the
        # slots an unpadded run of the same tokens would have
        dyn_c = _capacity_table(cfg, T, logits.device)[valid.sum().reshape(1)]
        sel_valid = sel_valid & (torch.arange(capacity, device=logits.device)[None, :] < dyn_c[:, None])
    gate = torch.gather(w_te, 1, sel_idx) * sel_valid
    return {"probs": probs, "topv": topv, "topi": topi, "w_te": w_te, "assigned": assigned,
            "sel_idx": sel_idx, "sel_valid": sel_valid, "gate": gate}


def _experts_ffn(cfg: ModelConfig, xg: torch.Tensor, w1, w3, w2) -> torch.Tensor:
    """xg (E, C, d) through each expert's FFN: (E, C, d) @ (E, d, f), ... ->
    (E, C, d), batched products in xg's dtype through ``qeinsum`` (expert
    weights plain or weight-only int8)."""
    h = activation(cfg, qeinsum(xg, w1))
    if cfg.gated_mlp:
        h = h * qeinsum(xg, w3)
    return qeinsum(h, w2)


def moe_core(cfg: ModelConfig, x_flat: torch.Tensor, logits: torch.Tensor, w1,
             w3, w2, capacity: int, valid=None, e_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_flat (T, d), logits (T, E) f32 over all E experts, the weights of
    the experts ``[e_offset, e_offset + E_local)``: (E_local, d, f) /
    (E_local, f, d), plain or quantized dicts. Returns (out (T, d), those
    experts' share of the output; the Switch load-balance aux loss over all
    E, an f32 scalar)."""
    m = cfg.moe
    T, d = x_flat.shape
    E_local = (w1["q"] if isinstance(w1, Mapping) else w1).shape[0]
    r = route(cfg, logits, capacity, valid, e_offset, E_local)
    sel_idx = r["sel_idx"]
    xg = x_flat[sel_idx.reshape(-1)].reshape(E_local, capacity, d)
    y = _experts_ffn(cfg, xg, w1, w3, w2)
    y = y * r["gate"][..., None].to(y.dtype)
    buf = torch.zeros((E_local, T, d), dtype=x_flat.dtype, device=x_flat.device)
    buf.scatter_(1, sel_idx[..., None].expand(E_local, capacity, d), y)
    out = buf.sum(0)

    # over the global experts: the same on every model shard, whose logits
    # come from the same tokens. one_hot's CPU kernel reads the ids back to
    # check their range (the card's does not); this comparison counts the
    # same on every device
    E = logits.shape[-1]
    counts = (r["topi"][..., None] == torch.arange(E, device=x_flat.device)).sum((0, 1)).float()   # (E,)
    frac_tokens = counts / T / m.top_k
    frac_probs = r["probs"].mean(0)
    aux = E * torch.sum(frac_tokens * frac_probs)
    return out, aux


def moe_ffn(cfg: ModelConfig, p: Mapping, x: torch.Tensor, valid=None, ctx=None,
            batch: Optional[int] = None):
    """x (B, S, d); ``valid`` (B, S) bool marks right-padded prefill tokens,
    which claim no expert capacity. Router logits in f32. Returns (out (B,
    S, d), aux).

    With ``ctx`` None or a 'model' axis of 1 this is the single-device path
    on x as given, as in the JAX package. Otherwise x, ``valid`` and ``p``'s
    leaves are this rank's blocks under ``moe_in_specs`` for a global batch
    of ``batch`` sequences (by default x's batch times ``ctx.dp_size``), and
    the call returns this rank's block of the output and the aux."""
    B, S, d = x.shape
    if ctx is None or ctx.tp_size == 1:
        x_flat = x.reshape(B * S, d)
        logits = x_flat.float() @ p["router"].float()
        v = valid.reshape(B * S) if valid is not None else None
        out, aux = moe_core(cfg, x_flat, logits, p["w1"], p.get("w3"), p["w2"],
                            capacity_for(cfg, B * S), valid=v)
        return out.reshape(B, S, d), aux

    m = cfg.moe
    if m.n_experts % ctx.tp_size:
        raise ValueError(f"{cfg.name}: {m.n_experts} experts do not divide over {ctx.tp_size} model shards")
    batch = B * ctx.dp_size if batch is None else batch
    batch_spec = ctx.batch_spec_for(batch)
    dp = ctx.size_of(batch_spec)
    if B * dp != batch:
        raise ValueError(f"x holds {B} sequences; the block of a batch of {batch} over {batch_spec} "
                         f"holds {batch // dp}")
    mesh = ctx.mesh
    T_local = B * S
    token_gather = cfg.moe_token_gather and m.fsdp_experts and batch_spec is not None
    cap = capacity_for(cfg, T_local * dp if token_gather else T_local)
    e_off = coll.axis_index(mesh, ctx.tp_axis) * (m.n_experts // ctx.tp_size)
    w1, w3, w2 = p["w1"], p.get("w3"), p["w2"]

    if token_gather:
        # decode layout: tokens are tiny, so gather them over the batch axes
        # and keep the experts sharded (experts x 'model', d_ff x 'data')
        xg, vg = x, valid
        for ax in reversed(ctx.batch_axes):
            xg = coll.all_gather(xg, mesh, ax)
            if valid is not None:
                vg = coll.all_gather(vg, mesh, ax)
        T = xg.shape[0] * S
        x_flat = xg.reshape(T, d)
        logits = x_flat.float() @ p["router"].float()
        out, aux = moe_core(cfg, x_flat, logits, w1, w3, w2, cap,
                            valid=vg.reshape(T) if valid is not None else None, e_offset=e_off)
        # partial over d_ff ('data') and the experts ('model')
        out = coll.psum(out, mesh, (ctx.fsdp_axis, ctx.tp_axis))
        idx = 0
        for a in ctx.batch_axes:
            idx = idx * ctx.shape[a] + coll.axis_index(mesh, a)
        return out.reshape(-1, T_local, d)[idx].reshape(B, S, d), aux

    if m.fsdp_experts:
        w1, w2 = _gather_w(w1, ctx, 2), _gather_w(w2, ctx, 1)
        w3 = _gather_w(w3, ctx, 2) if w3 is not None else None
    x_flat = x.reshape(T_local, d)
    logits = x_flat.float() @ p["router"].float()
    out, aux = moe_core(cfg, x_flat, logits, w1, w3, w2, cap,
                        valid=valid.reshape(T_local) if valid is not None else None, e_offset=e_off)
    out = coll.psum(out, mesh, ctx.tp_axis)
    if ctx.batch_axes:
        aux = coll.pmean(aux, mesh, ctx.batch_axes)
    return out.reshape(B, S, d), aux


def _gather_w(w, ctx, dim: int):
    """An expert leaf's d_ff shards all-gathered over the fsdp axis along
    ``dim``; an int8 leaf's scales only where they are sharded there (a
    contracting dim of 1 is whole on every rank)."""
    if isinstance(w, Mapping):
        s = w["s"]
        return {"q": coll.all_gather(w["q"], ctx.mesh, ctx.fsdp_axis, dim),
                "s": coll.all_gather(s, ctx.mesh, ctx.fsdp_axis, dim) if s.shape[dim] > 1 else s}
    return coll.all_gather(w, ctx.mesh, ctx.fsdp_axis, dim)


def moe_in_specs(cfg: ModelConfig, ctx, p: Mapping, batch: int) -> dict:
    """The layouts of the sharded ``moe_ffn``'s arguments for a global batch
    of ``batch`` sequences (the JAX package's in_specs): "x" and "valid"
    over the batch axes, the router whole, the experts over 'model' and,
    under ``fsdp_experts``, d_ff over 'data'; an int8 leaf's scales drop the
    axis of their contracting dim of 1."""
    batch_spec = ctx.batch_spec_for(batch)
    ff = ctx.fsdp_axis if cfg.moe.fsdp_experts else None

    def leaf(w, spec3):
        if isinstance(w, Mapping):
            s3 = list(spec3)
            if w["s"].shape[-2] == 1:
                s3[-2] = None
            return {"q": P(*spec3), "s": P(*s3)}
        return P(*spec3)

    specs = {"x": P(batch_spec, None, None), "valid": P(batch_spec, None), "router": P(None, None),
             "w1": leaf(p["w1"], (ctx.tp_axis, None, ff)), "w2": leaf(p["w2"], (ctx.tp_axis, ff, None))}
    if "w3" in p:
        specs["w3"] = leaf(p["w3"], (ctx.tp_axis, None, ff))
    return specs


def moe_blocks(cfg: ModelConfig, ctx, p: Mapping, x: torch.Tensor, valid=None, coord=None):
    """This rank's blocks (or those of the mesh position ``coord``) of the
    full layer ``p``, batch ``x`` (B, S, d) and mask ``valid``, as the
    sharded ``moe_ffn`` takes them: (p_local, x_local, valid_local)."""
    specs = moe_in_specs(cfg, ctx, p, x.shape[0])
    coord = coordinate(ctx.mesh) if coord is None else coord
    sizes = ctx.shape

    def cut(t, spec):
        if isinstance(spec, PartitionSpec):
            return shard_block(t, spec, sizes, coord)
        return {k: cut(t[k], spec[k]) for k in spec}

    p_local = {k: cut(p[k], specs[k]) for k in p}
    v_local = None if valid is None else cut(valid, specs["valid"])
    return p_local, cut(x, specs["x"]), v_local


def moe_ffn_sharded(cfg: ModelConfig, ctx, p: Mapping, x, valid=None):
    """``moe_ffn`` of a DTensor x (B, S, d) pinned to the batch axes, with
    DTensor leaves ``p``: each leaf is redistributed to its ``moe_in_specs``
    layout and the sharded body runs on the rank's blocks (``local_map``,
    the reference's ``shard_map``). Returns (out, a DTensor laid out as x;
    aux, replicated). Forward only: the body's collectives carry no
    gradient, so a gradient through it raises."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.axes import NamedSharding, placements, redistribute

    mesh, B = ctx.mesh, x.shape[0]
    specs = moe_in_specs(cfg, ctx, p, B)
    flat = [(k, None, p[k], specs[k]) if isinstance(specs[k], PartitionSpec) else (k, j, p[k][j], specs[k][j])
            for k in sorted(p) for j in ([None] if isinstance(specs[k], PartitionSpec) else sorted(specs[k]))]
    if torch.is_grad_enabled() and any(t.requires_grad for t in [x] + [f[2] for f in flat]):
        raise NotImplementedError("training the sharded MoE (a backward through its collectives) waits for "
                                  "ROADMAP Queue 1 item 10")

    def place(t, spec):
        if isinstance(t, DTensor):
            return redistribute(t, placements(spec, mesh))
        return NamedSharding(mesh, spec).distribute(t)

    names = [("x", None, x, specs["x"])] + ([("valid", None, valid, specs["valid"])] if valid is not None else [])
    args = [place(t, spec) for _, _, t, spec in names + flat]

    def body(*ls):
        xl, vl = ls[0], (ls[1] if valid is not None else None)
        pl: dict = {}
        for (k, j, _, _), t in zip(flat, ls[len(names):]):
            if j is None:
                pl[k] = t
            else:
                pl.setdefault(k, {})[j] = t
        return moe_ffn(cfg, pl, xl, vl, ctx=ctx, batch=B)

    x_pl = placements(specs["x"], mesh)
    return local_map(body, out_placements=(x_pl, placements(P(), mesh)),
                     in_placements=tuple(tuple(a.placements) for a in args), device_mesh=mesh)(*args)
