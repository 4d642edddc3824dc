"""granite-8b [dense] — llama-arch, code (arXiv:2405.04324).

36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
"""
import torch

from repro_torch.configs.shapes import FULL_ATTENTION_SKIP
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    rope_theta=10000.0,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
    param_dtype=torch.float32, compute_dtype=torch.float32, remat="none",
    attn_chunk=8, ce_chunks=2,
)

SKIP_SHAPES = {"long_500k": FULL_ATTENTION_SKIP}
