"""Mixture-of-experts FFN on one device (the torch twin of the single-device
path of ``repro/models/moe.py``; its ``shard_map`` path over a mesh waits
for the port's sharding).

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
"""
from __future__ import annotations

import functools
from typing import Mapping, Tuple

import torch

from repro_torch.models.common import ModelConfig, ParamDef, activation
from repro_torch.models.quant import qeinsum


def moe_defs(cfg: ModelConfig) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    defs = {
        "router": ParamDef((d, E)),
        "w1": ParamDef((E, d, f)),
        "w2": ParamDef((E, f, d)),
    }
    if cfg.gated_mlp:
        defs["w3"] = ParamDef((E, d, f))
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


def route(cfg: ModelConfig, logits: torch.Tensor, capacity: int, valid=None) -> dict:
    """The routing of T tokens over E experts from f32 router logits (T, E):
    ``probs`` (T, E); ``topv``/``topi`` (T, k), the normalized gate weights
    and expert ids of each token; ``w_te`` (E, T), each token's gate weight
    at each expert (0 where not chosen); ``assigned`` (E, T); ``sel_idx``
    (E, C), each expert's top-C tokens by ``assigned + w_te``; ``sel_valid``
    (E, C), the kept slots (assigned, and with ``valid`` within the capacity
    of the valid token count); ``gate`` (E, C), the kept slots' weights.
    ``valid`` (T,) bool marks right-padded prefill: a pad token neither
    claims a slot nor gets output."""
    m = cfg.moe
    T, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    topv, topi = top_k(probs, m.top_k)
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)

    eids = torch.arange(E, device=logits.device)
    match = topi[None, :, :] == eids[:, None, None]                # (E, T, k)
    if valid is not None:
        match = match & valid[None, :, None]
    w_te = (match * topv[None]).sum(-1)                            # (E, T)
    assigned = match.any(-1)                                       # (E, T)

    score = assigned.float() + w_te
    sel_idx = top_k(score, capacity)[1]                            # (E, C)
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
             w3, w2, capacity: int, valid=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_flat (T, d), logits (T, E) f32, expert weights (E, d, f) / (E, f, d),
    plain or quantized dicts. Returns (out (T, d), the Switch load-balance
    aux loss, an f32 scalar)."""
    m = cfg.moe
    T, d = x_flat.shape
    E = (w1["q"] if isinstance(w1, Mapping) else w1).shape[0]
    r = route(cfg, logits, capacity, valid)
    sel_idx = r["sel_idx"]
    xg = x_flat[sel_idx.reshape(-1)].reshape(E, capacity, d)
    y = _experts_ffn(cfg, xg, w1, w3, w2)
    y = y * r["gate"][..., None].to(y.dtype)
    buf = torch.zeros((E, T, d), dtype=x_flat.dtype, device=x_flat.device)
    buf.scatter_(1, sel_idx[..., None].expand(E, capacity, d), y)
    out = buf.sum(0)

    # one_hot's CPU kernel reads the ids back to check their range (the
    # card's does not); this comparison counts the same on every device
    counts = (r["topi"][..., None] == torch.arange(E, device=x_flat.device)).sum((0, 1)).float()   # (E,)
    frac_tokens = counts / T / m.top_k
    frac_probs = r["probs"].mean(0)
    aux = E * torch.sum(frac_tokens * frac_probs)
    return out, aux


def moe_ffn(cfg: ModelConfig, p: Mapping, x: torch.Tensor, valid=None):
    """x (B, S, d); ``valid`` (B, S) bool marks right-padded prefill tokens,
    which claim no expert capacity. Router logits in f32. Returns (out (B,
    S, d), aux)."""
    B, S, d = x.shape
    x_flat = x.reshape(B * S, d)
    logits = x_flat.float() @ p["router"].float()
    v = valid.reshape(B * S) if valid is not None else None
    out, aux = moe_core(cfg, x_flat, logits, p["w1"], p.get("w3"), p["w2"],
                        capacity_for(cfg, B * S), valid=v)
    return out.reshape(B, S, d), aux
