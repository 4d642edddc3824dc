"""Greedy next-token selection from final hidden states.

Logits are the product in the hidden dtype, then cast to f32 (as the JAX
package's ``qeinsum(...).astype(f32)``), so bf16 logits round before the
argmax exactly where the reference's do. Ties go to the FIRST maximum, like
``jnp.argmax``."""
from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.models.common import ModelConfig, unembed_weight


def logits(cfg: ModelConfig, params: Mapping, hidden: torch.Tensor) -> torch.Tensor:
    """(..., d) -> (..., V) float32 logits (no softcap: argmax is monotone
    under it, and the JAX package's next-token path skips it too)."""
    w = unembed_weight(cfg, params)
    return (hidden @ w.to(hidden.dtype)).float()


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis, int32."""
    V = x.shape[-1]
    is_max = x == torch.amax(x, dim=-1, keepdim=True)
    idx = torch.arange(V, device=x.device).expand_as(x)
    return torch.where(is_max, idx, torch.full_like(idx, V)).amin(dim=-1).to(torch.int32)


def next_tokens(cfg: ModelConfig, params: Mapping, hidden_last: torch.Tensor) -> torch.Tensor:
    """Greedy next-token ids from final hidden states (B, 1|S, d) -> (B,)."""
    return first_argmax(logits(cfg, params, hidden_last[:, -1, :]))
