"""The training loss, and greedy next-token selection from final hidden
states.

``lm_loss`` is the reference's chunked cross-entropy: ``cfg.ce_chunks``
sequence chunks (one where S does not divide), each under
``torch.utils.checkpoint`` so its (B, S / chunks, V) f32 logits are
recomputed in the backward instead of kept, as the reference's
``jax.checkpoint``'d scan body does; logits through ``qeinsum`` in the
hidden dtype, then f32, softcap, logsumexp, the label's logit, z-loss.

Logits are the product in the hidden dtype through ``quant.qeinsum`` (a
weight-only int8 unembed included), then cast to f32, as the JAX package's
``qeinsum(...).astype(f32)``, so bf16 logits round before the argmax exactly
where the reference's do. Ties go to the FIRST maximum, like
``jnp.argmax``.

On a mesh (``ctx`` over more than one device; the hidden states a
DTensor) the logits stay sharded on the vocab over the model axis wherever
V divides, as the reference's sharding constraint keeps them: each rank
computes its (B / batch shards, C, V / model shards) block in a
``local_map`` region, the cross-entropy's logsumexp takes a max and then a
sum all-reduce over the model axis, and the label's logit comes from the
shard that holds it (Megatron's vocab-parallel cross-entropy); the argmax
reduces (value, global index) pairs, ties to the lower index. No rank
holds a (B, C, V) tensor."""
from __future__ import annotations

from typing import Mapping, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.kernels import _grad
from repro_torch.models.common import ModelConfig, unembed_weight
from repro_torch.models.quant import qeinsum
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.axes import redistribute

IGNORE = -1


def _vocab_split(ctx, w):
    """(placements of the unembedding w (d, V) to compute in, the model
    axis's mesh dim, True where V is split over it): gathered over the fsdp
    axis, V over the model axis where it divides, the rest replicated."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = ctx.mesh
    tp = mesh.mesh_dim_names.index(ctx.tp_axis)
    split = w.shape[-1] % ctx.tp_size == 0 and ctx.tp_size > 1
    pl = [Replicate()] * mesh.ndim
    if split:
        pl[tp] = Shard(w.ndim - 1)
    return tuple(pl), tp, split


def _ce_sharded(cfg: ModelConfig, ctx, w, x_c, labels_c):
    """``_chunk_ce`` on a mesh: x_c (B, C, d) and labels_c (B, C) DTensors
    pinned to the batch axes, w (d, V) a DTensor. Returns the three sums,
    each a DTensor replicated on every rank."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = ctx.mesh
    w_pl, tp, split = _vocab_split(ctx, w)
    x_pl, l_pl = tuple(x_c.placements), tuple(labels_c.placements)
    sums = tuple(Partial() if isinstance(a, Shard) else Replicate() for a in x_pl)
    w_grad = tuple(Partial() if isinstance(a, Shard) else w_pl[i] for i, a in enumerate(x_pl))
    # each vocab shard's logits give x only their part of its gradient
    x_grad = tuple(Partial() if split and i == tp else a for i, a in enumerate(x_pl))

    def body(xl, wl, yl):
        logits = qeinsum(xl, wl).float()                               # (B_l, C, V_l)
        if cfg.logit_softcap:
            logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
        if not split:
            return _ce_sums(torch.logsumexp(logits, dim=-1), _label_logit(logits, yl, 0), yl)
        m = coll.pmax(logits.amax(dim=-1), mesh, ctx.tp_axis)         # (B_l, C), no gradient
        se = coll.sum_replicated(torch.exp(logits - m[..., None]).sum(-1), mesh, ctx.tp_axis)
        lo = mesh.get_local_rank(tp) * logits.shape[-1]
        ll = coll.sum_replicated(_label_logit(logits, yl, lo), mesh, ctx.tp_axis)
        return _ce_sums(m + torch.log(se), ll, yl)

    out = local_map(body, out_placements=(sums, sums, sums), in_placements=(x_pl, w_pl, l_pl),
                    in_grad_placements=(x_grad, w_grad, l_pl), device_mesh=mesh)(
        x_c, redistribute(w, w_pl), labels_c)
    rep = (Replicate(),) * mesh.ndim
    return tuple(t.redistribute(mesh, rep) for t in out)


def _label_logit(logits, labels, lo: int):
    """Each position's logit at its label where the label falls in this
    block's vocab range [lo, lo + V_l), else 0."""
    V_l = logits.shape[-1]
    idx = labels.long() - lo
    here = (idx >= 0) & (idx < V_l)
    got = torch.gather(logits, -1, idx.clamp(0, V_l - 1)[..., None])[..., 0]
    return torch.where(here, got, torch.zeros((), dtype=got.dtype, device=got.device))


def _ce_sums(z, ll, labels):
    """(sum of z - ll, sum of z^2, count) over the positions whose label is
    not IGNORE."""
    valid = labels != IGNORE
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    return (torch.where(valid, z - ll, zero).sum(), torch.where(valid, z * z, zero).sum(),
            valid.sum().to(z.dtype))


def _chunk_ce(cfg: ModelConfig, w, x_c: torch.Tensor, labels_c: torch.Tensor, ctx=None):
    """x_c: (B, C, d); labels_c: (B, C) int, IGNORE to mask. Returns (sum of
    the losses, sum of z^2, count) over the chunk's valid positions. The
    label's logit is gathered: the reference sums an iota mask's one nonzero
    term, the same value. On a mesh: ``_ce_sharded``."""
    if ctx is not None and ctx.n_devices > 1:
        return _ce_sharded(cfg, ctx, w, x_c, labels_c)
    logits = qeinsum(x_c, w).float()
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    z = torch.logsumexp(logits, dim=-1)                               # (B, C)
    valid = labels_c != IGNORE
    ll = torch.gather(logits, -1, labels_c.clamp(min=0)[..., None].long())[..., 0]
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    loss = torch.where(valid, z - ll, zero)
    return loss.sum(), torch.where(valid, z * z, zero).sum(), valid.sum()


def lm_loss(cfg: ModelConfig, params: Mapping, hidden: torch.Tensor, labels: torch.Tensor,
            z_weight: float = 1e-4, ctx=None) -> Tuple[torch.Tensor, dict]:
    """hidden (B, S, d), final-normed; labels (B, S) int, IGNORE to mask.
    Returns (ce + z-loss, {"ce", "z", "tokens"}), each a scalar tensor: the
    mean cross-entropy and the z-loss (``z_weight`` times the mean squared
    logsumexp) over the valid positions, and their count (at least 1). On a
    mesh hidden is a DTensor and the results are replicated DTensors."""
    B, S, d = hidden.shape
    w = unembed_weight(cfg, params)
    if ctx is not None and ctx.n_devices > 1:
        from repro_torch.models.transformer import batch_sharded
        from repro_torch.sharding.axes import gather_fsdp

        w, labels = gather_fsdp(w, ctx), batch_sharded(ctx, labels)
    nc = cfg.ce_chunks if S % cfg.ce_chunks == 0 else 1
    if nc == 1:
        sl, sz, cnt = _chunk_ce(cfg, w, hidden, labels, ctx)
    else:
        C = S // nc
        recompute = _grad.wants_grad(hidden, w)
        sl = sz = cnt = None
        for c in range(0, S, C):       # in order, as the reference's scan carries the sums
            args = (cfg, w, hidden[:, c:c + C], labels[:, c:c + C], ctx)
            part = ckpt.checkpoint(_chunk_ce, *args, use_reentrant=False) if recompute else _chunk_ce(*args)
            sl, sz, cnt = part if sl is None else (sl + part[0], sz + part[1], cnt + part[2])
    denom = torch.clamp(cnt, min=1).float()
    loss = sl / denom
    zloss = z_weight * sz / denom
    return loss + zloss, {"ce": loss, "z": zloss, "tokens": denom}


def logits(cfg: ModelConfig, params: Mapping, hidden: torch.Tensor) -> torch.Tensor:
    """(..., d) -> (..., V) float32 logits (no softcap: argmax is monotone
    under it, and the JAX package's next-token path skips it too)."""
    return qeinsum(hidden, unembed_weight(cfg, params)).float()


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis, int32."""
    V = x.shape[-1]
    is_max = x == torch.amax(x, dim=-1, keepdim=True)
    idx = torch.arange(V, device=x.device).expand_as(x)
    return torch.where(is_max, idx, torch.full_like(idx, V)).amin(dim=-1).to(torch.int32)


def argmax_sharded(cfg: ModelConfig, ctx, params: Mapping, hidden) -> torch.Tensor:
    """``first_argmax`` of the logits of a DTensor ``hidden`` (..., d) whose
    last dim is whole, the vocab split over the model axis where it
    divides: each rank takes its block's first maximum and its global
    index, the model axis's (value, index) pairs are all-gathered, and the
    largest value wins, ties to the lower index. Returns an int32 DTensor
    laid out as ``hidden`` without its last dim."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.axes import gather_fsdp

    mesh = ctx.mesh
    w = gather_fsdp(unembed_weight(cfg, params), ctx)
    w_pl, tp, split = _vocab_split(ctx, w)
    h_pl = tuple(hidden.placements)
    if any(isinstance(a, Shard) and a.dim == hidden.ndim - 1 for a in h_pl):
        raise ValueError(f"argmax_sharded: the hidden dim must be whole, got {h_pl}")

    def body(hl, wl):
        lg = qeinsum(hl, wl).float()
        idx = first_argmax(lg).long()
        if not split:
            return idx.to(torch.int32)
        val = torch.gather(lg, -1, idx[..., None])[..., 0]
        idx = idx + mesh.get_local_rank(tp) * lg.shape[-1]
        vals = coll.all_gather(val[None], mesh, ctx.tp_axis)             # (tp, ...) in vocab order
        idxs = coll.all_gather(idx[None], mesh, ctx.tp_axis)
        best = first_argmax(vals.movedim(0, -1)).long()                  # the first shard holding the max
        return torch.gather(idxs.movedim(0, -1), -1, best[..., None])[..., 0].to(torch.int32)

    return local_map(body, out_placements=list(h_pl), in_placements=(h_pl, w_pl), device_mesh=mesh)(
        hidden, redistribute(w, w_pl))


def next_tokens_all(cfg: ModelConfig, params: Mapping, hidden: torch.Tensor, ctx=None) -> torch.Tensor:
    """Greedy next-token ids at EVERY position, (B, S, d) -> (B, S) int32:
    the speculative verify pass reads the greedy continuation after each of
    its positions in one shot. On a mesh: ``argmax_sharded``."""
    if ctx is not None and ctx.n_devices > 1:
        return argmax_sharded(cfg, ctx, params, hidden)
    return first_argmax(logits(cfg, params, hidden))


def next_tokens(cfg: ModelConfig, params: Mapping, hidden_last: torch.Tensor, ctx=None) -> torch.Tensor:
    """Greedy next-token ids from final hidden states (B, 1|S, d) -> (B,).
    On a mesh: ``argmax_sharded``."""
    if ctx is not None and ctx.n_devices > 1:
        return argmax_sharded(cfg, ctx, params, hidden_last[:, -1, :])
    return first_argmax(logits(cfg, params, hidden_last[:, -1, :]))
