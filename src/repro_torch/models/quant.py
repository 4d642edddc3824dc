"""int8 KV-cache quantization: one scale per (token, head), the head dim the
reduced axis (the torch twin of ``repro/models/quant.py``'s KV idiom).

Shared by the dense int8 cache (models/attention.py) and the paged pool's
plain versions (kernels/paged_attention/ref.py), so every storage path
quantizes bit-identically. The int8 values are computed from the f32 scale
with IEEE division and round-half-to-even (``torch.round``); only then is
the scale stored as bf16. The write kernel of ``csrc/paged_attention.cu``
does the same arithmetic. Weight-only int8 (``quantize_params``,
``qeinsum``) is not ported yet (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import torch


def quantize_kv(x: torch.Tensor):
    """Per (token, head) absmax int8. x: (..., hd). Returns (int8 values,
    bf16 scales with the trailing axis reduced to 1)."""
    xf = x.float()
    # divide by a tensor on x's device: on CUDA, torch divides by a Python
    # scalar as a multiply by its reciprocal, which can be 1 ulp off x / 127
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = (amax / amax.new_tensor(127.0)).clamp_min(1e-8)
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale.float()).to(dtype)
