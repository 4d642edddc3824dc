"""Plain PyTorch oracle for flash attention (causal, GQA)."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v):
    """q: (B, H, S, hd); k/v: (B, KV, S, hd) -> (B, H, S, hd), f32 softmax."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    qg = q.reshape(B, KV, G, S, hd).float()
    s = torch.einsum("bkgqh,bkth->bkgqt", qg, k.float()) / (hd ** 0.5)
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bkgqt,bkth->bkgqh", p, v.float())
    return o.reshape(B, H, S, hd).to(q.dtype)
