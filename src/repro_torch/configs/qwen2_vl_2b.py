"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution (arXiv:2409.12191).

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936. The vision frontend
is a stub: an image prompt arrives as precomputed patch and token embeddings
(``EmbedsLM.prefill``); M-RoPE position ids carry the (t, h, w) streams
(sections 16/24/24 over hd=128).
"""
import torch

from repro_torch.configs.shapes import FULL_ATTENTION_SKIP
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    head_dim=128,
    inputs="embeds",
    pos="mrope",
    mrope_sections=(16, 24, 24),
    qkv_bias=True,
    rope_theta=1000000.0,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
    head_dim=16, mrope_sections=(2, 3, 3),
    param_dtype=torch.float32, compute_dtype=torch.float32, remat="none",
    attn_chunk=8, ce_chunks=2,
)

SKIP_SHAPES = {"long_500k": FULL_ATTENTION_SKIP}
