"""glm4-9b [dense] — RoPE, GQA, QKV bias (hf:THUDM/glm-4-9b).

40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
"""
import torch

from repro_torch.configs.shapes import FULL_ATTENTION_SKIP
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    qkv_bias=True,
    rope_theta=10000.0,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
    param_dtype=torch.float32, compute_dtype=torch.float32, remat="none",
    attn_chunk=8, ce_chunks=2,
)

SKIP_SHAPES = {"long_500k": FULL_ATTENTION_SKIP}
