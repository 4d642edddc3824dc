"""whisper-large-v3 [audio] — encoder-decoder, conv frontend stub (arXiv:2212.04356).

32L d_model=1280 20H (kv=20) d_ff=5120 vocab=51866: 32 encoder and 32
decoder layers (whisper-large-v3's num_hidden_layers=32 applies to each
stack). The audio frontend is a stub: callers give precomputed 1500-frame
embeddings. Decoder self-attention uses RoPE in place of the 448-entry
learned table, as the JAX package adapts it. ``ce_chunks`` is raised to 32
to bound the training loss's logits slice (vocab 51866), as in the JAX
package.
"""
import torch

from repro_torch.configs.shapes import FULL_ATTENTION_SKIP
from repro_torch.models.common import EncoderCfg, ModelConfig

FULL = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    encoder=EncoderCfg(n_layers=32, n_ctx=1500, n_heads=20, d_ff=5120),
    cross_attn=True,
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    ce_chunks=32,
)

SMOKE = FULL.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=512,
    encoder=EncoderCfg(n_layers=2, n_ctx=12, n_heads=4, d_ff=128),
    param_dtype=torch.float32, compute_dtype=torch.float32, remat="none",
    attn_chunk=8, ce_chunks=2,
)

SKIP_SHAPES = {"long_500k": FULL_ATTENTION_SKIP}
