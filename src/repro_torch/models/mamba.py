"""Mamba helpers shared with the xLSTM mixers (the torch twin of the part of
``repro/models/mamba.py`` the ported families use; the Mamba mixer itself
is ROADMAP Queue 1 item 8)."""
from __future__ import annotations

import torch


def conv_state_at(xp: torch.Tensor, n_valid, K: int) -> torch.Tensor:
    """Rolling conv state as of the last *valid* token of a right-padded
    sequence. xp is the state-prepended input (B, S+K-1, d), so the K-1
    inputs ending at token n_valid-1 live at xp[:, n_valid : n_valid+K-1].
    The start is clamped into [0, S], as ``dynamic_slice_in_dim`` clamps it."""
    B, T, _ = xp.shape
    S = T - (K - 1)
    nv = torch.as_tensor(n_valid, dtype=torch.long, device=xp.device).reshape(-1).expand(B)
    idx = nv.clamp(0, S)[:, None] + torch.arange(K - 1, device=xp.device)[None, :]
    return torch.gather(xp, 1, idx[:, :, None].expand(B, K - 1, xp.shape[2]))
