"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2
(arXiv:2403.19887).

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536. Superblock = 8 layers
with one attention layer (1:7); MoE FFN on every other layer (the released
Jamba period, which pins the 398B total). Only 9 of the 72 layers hold KV.
"""
import torch

from repro_torch.models.common import MambaCfg, ModelConfig, MoECfg

FULL = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    block_pattern=("mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba", "mamba"),
    mamba=MambaCfg(d_state=16, d_conv=4, expand=2, chunk=128),
    moe=MoECfg(n_experts=16, top_k=2, every_k=2, fsdp_experts=True),
    rope_theta=10000.0,
)

SMOKE = FULL.replace(
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
    mamba=MambaCfg(d_state=4, d_conv=4, expand=2, chunk=8),
    moe=MoECfg(n_experts=4, top_k=2, every_k=2),
    param_dtype=torch.float32, compute_dtype=torch.float32, remat="none",
    attn_chunk=8, ce_chunks=2,
)

SKIP_SHAPES = {}
