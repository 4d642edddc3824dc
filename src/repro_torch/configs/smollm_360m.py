"""smollm-360m [dense] — llama-arch small (hf:HuggingFaceTB/SmolLM-360M).

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
"""
import torch

from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    rope_theta=10000.0,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=60, n_heads=3, n_kv_heads=1, d_ff=128, vocab_size=512,
    param_dtype=torch.float32, compute_dtype=torch.float32,
    attn_chunk=8,
)
