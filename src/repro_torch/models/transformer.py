"""Decoder stack, attention-only: the superblock pattern run as a Python loop
over the stacked superblock parameters (the JAX package scans them with
``lax.scan``).

Parameters, caches and pools keep the JAX package's stacked layout: every
leaf under ``blocks`` carries a leading (n_superblocks,) axis, so a layer's
parameters and caches are views ``leaf[i]`` and in-place writes land in the
stack.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models.common import (
    ModelConfig,
    apply_norm,
    embed_defs,
    embed_tokens,
    norm_defs,
    stack_defs,
)
from repro_torch.models.mlp import mlp, mlp_defs


def _check_pattern(cfg: ModelConfig) -> None:
    if any(kind != "attn" for kind in cfg.block_pattern) or cfg.d_ff <= 0:
        raise NotImplementedError(
            f"{cfg.name}: only attention-only decoders with an MLP are ported so far "
            "(the other families are ROADMAP Queue 1 item 8)"
        )


def superblock_defs(cfg: ModelConfig) -> dict:
    _check_pattern(cfg)
    defs: dict = {}
    for i, _ in enumerate(cfg.block_pattern):
        defs[f"l{i}_norm"] = norm_defs(cfg)
        defs[f"l{i}_mixer"] = attn.attention_defs(cfg)
        defs[f"l{i}_ffn_norm"] = norm_defs(cfg)
        defs[f"l{i}_ffn"] = mlp_defs(cfg)
    return defs


def param_defs(cfg: ModelConfig) -> dict:
    defs = dict(embed_defs(cfg))
    defs["blocks"] = stack_defs(superblock_defs(cfg), cfg.n_superblocks)
    defs["final_norm"] = norm_defs(cfg)
    return defs


def _init(defs: dict, device) -> dict:
    return {"blocks": {
        key: {name: torch.zeros(s.shape, dtype=s.dtype, device=device) for name, s in leaves.items()}
        for key, leaves in defs["blocks"].items()
    }}


def cache_defs(cfg: ModelConfig, batch: int, cap: int) -> dict:
    """Dense decode cache: every attention layer has a (batch, cap) stripe
    per slot, stacked on the superblock axis."""
    _check_pattern(cfg)
    n = cfg.n_superblocks
    return {"blocks": {
        f"l{i}_mixer": {name: attn.TensorSpec((n,) + s.shape, s.dtype)
                        for name, s in attn.kv_cache_defs(cfg, batch, cap).items()}
        for i, _ in enumerate(cfg.block_pattern)
    }}


def init_cache(cfg: ModelConfig, batch: int, cap: int, device) -> dict:
    return _init(cache_defs(cfg, batch, cap), device)


def paged_cache_defs(cfg: ModelConfig, num_pages: int, page_size: int) -> dict:
    """Paged decode cache: every attention layer has its page pool, stacked
    on the superblock axis."""
    _check_pattern(cfg)
    n = cfg.n_superblocks
    per_sb = {}
    for i, _ in enumerate(cfg.block_pattern):
        per_sb[f"l{i}_mixer"] = {
            name: attn.TensorSpec((n,) + s.shape, s.dtype)
            for name, s in attn.paged_kv_pool_defs(cfg, num_pages, page_size).items()
        }
    return {"blocks": per_sb}


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int, device) -> dict:
    return _init(paged_cache_defs(cfg, num_pages, page_size), device)


def _index(tree, i: int):
    """The i-th superblock's slice of a stacked tree (views)."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: _index(v, i) for k, v in tree.items()}


def _superblock(cfg: ModelConfig, p: Mapping, x: torch.Tensor, positions, mode: str,
                cache_sb: Optional[Mapping], cache_index) -> torch.Tensor:
    for i, _ in enumerate(cfg.block_pattern):
        h = apply_norm(cfg, p[f"l{i}_norm"], x)
        c_in = cache_sb[f"l{i}_mixer"] if cache_sb is not None else None
        h, _ = attn.self_attention(cfg, p[f"l{i}_mixer"], h, positions, mode, c_in, cache_index)
        x = x + h
        h = apply_norm(cfg, p[f"l{i}_ffn_norm"], x)
        x = x + mlp(cfg, p[f"l{i}_ffn"], h)
    return x


def forward(
    cfg: ModelConfig,
    params: Mapping,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    mode: str = "train",
    cache: Optional[Mapping] = None,
    cache_index=None,
) -> Tuple[torch.Tensor, Optional[Mapping]]:
    """Returns (hidden (B, S, d) after the final norm, cache). The cache's
    pools are updated in place. Right-padded prefill needs no mask here:
    causal attention keeps pad positions out of every valid row."""
    x = embed_tokens(cfg, params, tokens)
    for sb in range(cfg.n_superblocks):
        p_sb = _index(params["blocks"], sb)
        c_sb = _index(cache["blocks"], sb) if cache is not None else None
        x = _superblock(cfg, p_sb, x, positions, mode, c_sb, cache_index)
    return apply_norm(cfg, params["final_norm"], x), cache
