"""Decoder stack: the superblock pattern run as a Python loop over the stacked
superblock parameters (the JAX package scans them with ``lax.scan``).

Mixers ported so far: attention (with a gated MLP), and the xLSTM family's
mLSTM and sLSTM (no FFN, ``d_ff = 0``).

Parameters, caches and pools keep the JAX package's stacked layout: every
leaf under ``blocks`` carries a leading (n_superblocks,) axis, so a layer's
parameters and caches are views ``leaf[i]`` and in-place writes land in the
stack. Recurrent mixers return new state tensors, which are copied into the
cache's leaves.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from repro_torch.models import attention as attn
from repro_torch.models import xlstm as xl
from repro_torch.models.common import (
    ModelConfig,
    apply_norm,
    embed_defs,
    embed_tokens,
    norm_defs,
    stack_defs,
)
from repro_torch.models.mlp import mlp, mlp_defs

RECURRENT = {"mlstm": (xl.mlstm_defs, xl.mlstm_cache_defs, xl.mlstm_mixer),
             "slstm": (xl.slstm_defs, xl.slstm_cache_defs, xl.slstm_mixer)}


def _check_pattern(cfg: ModelConfig) -> None:
    for kind in cfg.block_pattern:
        if kind != "attn" and kind not in RECURRENT:
            raise NotImplementedError(
                f"{cfg.name}: the {kind!r} mixer is not ported yet (ROADMAP Queue 1 item 8)")


def superblock_defs(cfg: ModelConfig) -> dict:
    _check_pattern(cfg)
    defs: dict = {}
    for i, kind in enumerate(cfg.block_pattern):
        defs[f"l{i}_norm"] = norm_defs(cfg)
        defs[f"l{i}_mixer"] = attn.attention_defs(cfg) if kind == "attn" else RECURRENT[kind][0](cfg)
        if cfg.d_ff > 0:
            defs[f"l{i}_ffn_norm"] = norm_defs(cfg)
            defs[f"l{i}_ffn"] = mlp_defs(cfg)
    return defs


def param_defs(cfg: ModelConfig) -> dict:
    defs = dict(embed_defs(cfg))
    defs["blocks"] = stack_defs(superblock_defs(cfg), cfg.n_superblocks)
    defs["final_norm"] = norm_defs(cfg)
    return defs


def _stacked(cfg: ModelConfig, per_layer) -> dict:
    """{"blocks": {l<i>_mixer: leaves}} with the superblock axis prepended;
    ``per_layer(kind)`` gives a layer's TensorSpecs (None: no entry)."""
    n = cfg.n_superblocks
    blocks = {}
    for i, kind in enumerate(cfg.block_pattern):
        specs = per_layer(kind)
        if specs is not None:
            blocks[f"l{i}_mixer"] = {name: attn.TensorSpec((n,) + s.shape, s.dtype)
                                     for name, s in specs.items()}
    return {"blocks": blocks}


def _init(defs: dict, device) -> dict:
    return {"blocks": {
        key: {name: torch.zeros(s.shape, dtype=s.dtype, device=device) for name, s in leaves.items()}
        for key, leaves in defs["blocks"].items()
    }}


def cache_defs(cfg: ModelConfig, batch: int, cap: int) -> dict:
    """Dense decode cache: every attention layer has a (batch, cap) stripe
    per slot, every recurrent layer its state per slot, stacked on the
    superblock axis."""
    _check_pattern(cfg)
    return _stacked(cfg, lambda kind: attn.kv_cache_defs(cfg, batch, cap) if kind == "attn"
                    else RECURRENT[kind][1](cfg, batch))


def init_cache(cfg: ModelConfig, batch: int, cap: int, device) -> dict:
    return _init(cache_defs(cfg, batch, cap), device)


def paged_cache_defs(cfg: ModelConfig, num_pages: int, page_size: int, batch: int = 1) -> dict:
    """Paged decode cache: every attention layer has its page pool, every
    recurrent layer its state per slot (``batch`` slots), stacked on the
    superblock axis."""
    _check_pattern(cfg)
    return _stacked(cfg, lambda kind: attn.paged_kv_pool_defs(cfg, num_pages, page_size)
                    if kind == "attn" else RECURRENT[kind][1](cfg, batch))


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int, device,
                     batch: int = 1) -> dict:
    return _init(paged_cache_defs(cfg, num_pages, page_size, batch), device)


def chunk_state_defs(cfg: ModelConfig, batch: int = 1) -> dict:
    """The chunked-prefill recurrent carry: one entry per recurrent mixer
    (attention chunks live in the cache or pool). It stays OUTSIDE the
    decode cache: while a sequence is mid-prefill, batched decode steps of
    other slots sweep every slot's in-cache state with garbage updates, so
    the engine keeps the authoritative state here and installs it into the
    slot when the last chunk completes."""
    _check_pattern(cfg)
    return _stacked(cfg, lambda kind: None if kind == "attn" else RECURRENT[kind][1](cfg, batch))


def init_chunk_state(cfg: ModelConfig, device, batch: int = 1) -> dict:
    """Zero carry for the first chunk of a chunked prefill; an empty tree
    for attention-only models."""
    return _init(chunk_state_defs(cfg, batch), device)


def recurrent_keys(cfg: ModelConfig):
    """Cache keys of the recurrent mixers."""
    return [f"l{i}_mixer" for i, kind in enumerate(cfg.block_pattern) if kind != "attn"]


def _index(tree, i: int):
    """The i-th superblock's slice of a stacked tree (views)."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: _index(v, i) for k, v in tree.items()}


def _write(dst: Mapping, src: Mapping, at: Optional[int] = None) -> None:
    """Copy a mixer's new state into cache leaves, in place (at slot ``at``
    of a batch axis when given)."""
    for name, t in src.items():
        leaf = dst[name] if at is None else dst[name][at:at + 1]
        leaf.copy_(t)


def _superblock(cfg: ModelConfig, p: Mapping, x: torch.Tensor, positions, mode: str,
                cache_sb: Optional[Mapping], cache_index, valid=None, chunk_sb=None):
    """One superblock. Returns (x, new_chunk) where ``new_chunk`` holds the
    recurrent carry after this chunk when ``chunk_sb`` was given.

    Chunked prefill (a ``ChunkPrefillIndex`` or ``PagedChunkPrefillIndex``
    with a carry): recurrent mixers resume from and return ``chunk_sb``; the
    in-cache state is left as it is. Paged prefill: recurrent mixers run from
    zero state (a fresh sequence) and their final state lands at the slot.
    Otherwise (dense prefill, decode): they run from the cache's state and
    write the new state back."""
    new_chunk: dict = {}
    chunk_pf = isinstance(cache_index, (attn.ChunkPrefillIndex, attn.PagedChunkPrefillIndex))
    paged_pf = isinstance(cache_index, attn.PagedPrefillIndex)
    for i, kind in enumerate(cfg.block_pattern):
        key = f"l{i}_mixer"
        h = apply_norm(cfg, p[f"l{i}_norm"], x)
        c_in = cache_sb[key] if cache_sb is not None else None
        if kind == "attn":
            h, _ = attn.self_attention(cfg, p[key], h, positions, mode, c_in, cache_index)
        else:
            mixer = RECURRENT[kind][2]
            if chunk_pf and chunk_sb is not None:
                h, new_chunk[key] = mixer(cfg, p[key], h, mode, chunk_sb[key], valid=valid)
            elif paged_pf and c_in is not None:
                zero = {name: torch.zeros((1,) + t.shape[1:], dtype=t.dtype, device=t.device)
                        for name, t in c_in.items()}
                h, part = mixer(cfg, p[key], h, mode, zero, valid=valid)
                _write(c_in, part, at=int(cache_index.slot))
            else:
                h, c_out = mixer(cfg, p[key], h, mode, c_in, valid=valid)
                if c_in is not None:
                    _write(c_in, c_out)
        x = x + h
        if cfg.d_ff > 0:
            h = apply_norm(cfg, p[f"l{i}_ffn_norm"], x)
            x = x + mlp(cfg, p[f"l{i}_ffn"], h)
    return x, new_chunk


def forward(
    cfg: ModelConfig,
    params: Mapping,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    mode: str = "train",
    cache: Optional[Mapping] = None,
    cache_index=None,
    n_valid=None,
    chunk_state: Optional[Mapping] = None,
):
    """Returns (hidden (B, S, d) after the final norm, cache), or with
    ``chunk_state`` (chunked prefill) (hidden, cache, new_chunk_state). The
    cache's leaves are updated in place.

    ``n_valid`` (B,) marks right-padded prefill: tokens at positions >=
    n_valid[b] are padding and identity for every recurrent state update
    (causal attention keeps them out of every valid row by itself)."""
    x = embed_tokens(cfg, params, tokens)
    valid = None
    if n_valid is not None:
        S = x.shape[1]
        nv = torch.as_tensor(n_valid, dtype=torch.int32, device=x.device).reshape(-1, 1)
        valid = torch.arange(S, dtype=torch.int32, device=x.device)[None, :] < nv
    new_state = {}
    for sb in range(cfg.n_superblocks):
        p_sb = _index(params["blocks"], sb)
        c_sb = _index(cache["blocks"], sb) if cache is not None else None
        s_sb = _index(chunk_state["blocks"], sb) if chunk_state is not None else None
        x, s_new = _superblock(cfg, p_sb, x, positions, mode, c_sb, cache_index, valid, s_sb)
        for key, leaves in s_new.items():
            new_state.setdefault(key, {n: [] for n in leaves})
            for n, t in leaves.items():
                new_state[key][n].append(t)
    h = apply_norm(cfg, params["final_norm"], x)
    if chunk_state is None:
        return h, cache
    stacked = {key: {n: torch.stack(ts) for n, ts in leaves.items()} for key, leaves in new_state.items()}
    return h, cache, {"blocks": stacked}
