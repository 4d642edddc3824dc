"""Whisper-style encoder-decoder backbone (the torch twin of
``repro/models/whisper.py``).

The audio frontend (log-mel and the convolutional downsampling) is a stub,
as in the JAX package: callers give precomputed frame embeddings (B, n_ctx,
d). The encoder is a bidirectional transformer without position encoding
(positions are baked into the stub frames); the decoder is a causal stack
with cross-attention, whose K/V the prefill computes and caches. The decoder
uses RoPE, as the JAX package adapts it, in place of Whisper's learned
448-position table.
"""
from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig, apply_norm, norm_defs, stack_defs
from repro_torch.models.rotary import positions_for


def encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    e = cfg.encoder
    return cfg.replace(n_layers=e.n_layers, n_heads=e.n_heads, n_kv_heads=e.n_heads, d_ff=e.d_ff,
                       cross_attn=False, pos="none", block_pattern=("attn",))


def param_defs(cfg: ModelConfig) -> dict:
    ecfg = encoder_cfg(cfg)
    return {
        "decoder": tf.param_defs(cfg),
        "encoder": {
            "blocks": stack_defs(tf.superblock_defs(ecfg), ecfg.n_superblocks),
            "final_norm": norm_defs(ecfg),
        },
    }


def encode(cfg: ModelConfig, params: Mapping, frames: torch.Tensor) -> torch.Tensor:
    """The encoder over frames (B, T, d), every frame attending to every
    other (the plain path: the flash kernel is causal). Returns (B, T, d)."""
    ecfg = encoder_cfg(cfg)
    B, T, _ = frames.shape
    pos = positions_for(B, T, device=frames.device)
    x, _, _ = tf.run_stack(ecfg, params["encoder"]["blocks"], frames.to(ecfg.compute_dtype), pos, "train",
                           causal=False)
    return apply_norm(ecfg, params["encoder"]["final_norm"], x)


def forward(cfg: ModelConfig, params: Mapping, frames=None, tokens=None, positions=None,
            mode: str = "train", cache=None, cache_index=None, n_valid=None):
    """Returns (decoder hidden (B, S, d), cache), in train mode (hidden,
    aux) as ``transformer.forward`` gives them. The encoder runs in train
    and prefill; decode reads the cross K/V the prefill cached. ``n_valid``
    marks a right-padded decoder prefill (only the causal decoder stack
    needs the mask)."""
    enc_out = encode(cfg, params, frames) if mode in ("train", "prefill") else None
    return tf.forward(cfg, params["decoder"], tokens, positions, mode=mode, cache=cache,
                      cache_index=cache_index, n_valid=n_valid, enc_out=enc_out)
