"""Rotary position embeddings (standard RoPE)."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), float32."""
    e = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** e)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    # x: (..., head_dim); cos/sin broadcastable to (..., head_dim//2)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int."""
    inv = rope_freqs(x.shape[-1], theta, x.device)        # (hd/2,)
    ang = positions.float()[..., None] * inv              # (B, S, hd/2)
    cos = torch.cos(ang)[..., None, :]                    # (B, S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    return _rotate(x, cos, sin)


def positions_for(batch: int, seq: int, offset=0, device=None) -> torch.Tensor:
    """(batch, seq) int32 positions offset + arange(seq)."""
    p = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + int(offset)
    return p.expand(batch, seq)
