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
``jnp.argmax``."""
from __future__ import annotations

from typing import Mapping, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.kernels import _grad
from repro_torch.models.common import ModelConfig, unembed_weight
from repro_torch.models.quant import qeinsum

IGNORE = -1


def _chunk_ce(cfg: ModelConfig, w, x_c: torch.Tensor, labels_c: torch.Tensor):
    """x_c: (B, C, d); labels_c: (B, C) int, IGNORE to mask. Returns (sum of
    the losses, sum of z^2, count) over the chunk's valid positions. The
    label's logit is gathered: the reference sums an iota mask's one nonzero
    term, the same value."""
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
            z_weight: float = 1e-4) -> Tuple[torch.Tensor, dict]:
    """hidden (B, S, d), final-normed; labels (B, S) int, IGNORE to mask.
    Returns (ce + z-loss, {"ce", "z", "tokens"}), each a scalar tensor: the
    mean cross-entropy and the z-loss (``z_weight`` times the mean squared
    logsumexp) over the valid positions, and their count (at least 1)."""
    B, S, d = hidden.shape
    w = unembed_weight(cfg, params)
    nc = cfg.ce_chunks if S % cfg.ce_chunks == 0 else 1
    if nc == 1:
        sl, sz, cnt = _chunk_ce(cfg, w, hidden, labels)
    else:
        C = S // nc
        recompute = _grad.wants_grad(hidden, w)
        sl = sz = torch.zeros((), dtype=torch.float32, device=hidden.device)
        cnt = torch.zeros((), dtype=torch.long, device=hidden.device)
        for c in range(0, S, C):       # in order, as the reference's scan carries the sums
            args = (cfg, w, hidden[:, c:c + C], labels[:, c:c + C])
            part = ckpt.checkpoint(_chunk_ce, *args, use_reentrant=False) if recompute else _chunk_ce(*args)
            sl, sz, cnt = sl + part[0], sz + part[1], cnt + part[2]
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


def next_tokens_all(cfg: ModelConfig, params: Mapping, hidden: torch.Tensor) -> torch.Tensor:
    """Greedy next-token ids at EVERY position, (B, S, d) -> (B, S) int32:
    the speculative verify pass reads the greedy continuation after each of
    its positions in one shot."""
    return first_argmax(logits(cfg, params, hidden))


def next_tokens(cfg: ModelConfig, params: Mapping, hidden_last: torch.Tensor) -> torch.Tensor:
    """Greedy next-token ids from final hidden states (B, 1|S, d) -> (B,)."""
    return first_argmax(logits(cfg, params, hidden_last[:, -1, :]))
