"""Rotary position embeddings: standard RoPE and Qwen2-VL's M-RoPE."""
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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float, sections: tuple) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. x: (B, S, H, hd); positions: (3, B, S) int,
    the temporal, height and width streams. ``sections`` splits the hd/2
    frequency slots among the three streams in order (e.g. (16, 24, 24) at
    hd 128): slot j takes its angle from the stream whose section holds it,
    the same f32 angle as the JAX package's ``take_along_axis``."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2 or len(sections) != 3:
        raise ValueError(f"mrope sections {sections} must split hd/2 = {hd // 2} into three")
    inv = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions.float()[..., None] * inv              # (3, B, S, hd/2)
    bounds = [0, sections[0], sections[0] + sections[1], hd // 2]
    ang = torch.cat([ang[i, ..., bounds[i]:bounds[i + 1]] for i in range(3)], dim=-1)   # (B, S, hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    return _rotate(x, cos, sin)


def positions_for(batch: int, seq: int, offset=0, device=None) -> torch.Tensor:
    """(batch, seq) int32 positions offset + arange(seq)."""
    p = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + int(offset)
    return p.expand(batch, seq)


def mrope_positions_for(batch: int, seq: int, offset=0, device=None) -> torch.Tensor:
    """Text-only M-RoPE positions (3, batch, seq): the three streams share
    the temporal index offset + arange(seq)."""
    return positions_for(batch, seq, offset, device)[None].expand(3, batch, seq)
