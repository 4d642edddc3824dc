"""llama4-maverick-400b-a17b [moe] — MoE 128e top-1, early fusion
(hf:meta-llama/Llama-4-Maverick). Text backbone.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.
"""
import torch

from repro_torch.configs.shapes import FULL_ATTENTION_SKIP
from repro_torch.models.common import ModelConfig, MoECfg

FULL = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    moe=MoECfg(n_experts=128, top_k=1, every_k=1, fsdp_experts=True),
    rope_theta=500000.0,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
    moe=MoECfg(n_experts=8, top_k=1, every_k=1),
    param_dtype=torch.float32, compute_dtype=torch.float32, remat="none",
    attn_chunk=8, ce_chunks=2,
)

SKIP_SHAPES = {"long_500k": FULL_ATTENTION_SKIP}
