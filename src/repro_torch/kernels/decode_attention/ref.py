"""Plain PyTorch oracle for fused GQA decode attention over a dense cache."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k, v, lengths, softcap: float = 0.0):
    """q: (B, KV, G, hd); k/v: (B, KV, T, hd); lengths: (B,). f32 softmax,
    output in q's dtype."""
    B, KV, G, hd = q.shape
    T = k.shape[2]
    s = torch.einsum("bkgh,bkth->bkgt", q.float(), k.float())
    s = s / (hd ** 0.5)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    mask = torch.arange(T, device=q.device)[None, None, None, :] < lengths.to(q.device)[:, None, None, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bkgt,bkth->bkgh", p, v.float())
    return o.to(q.dtype)
