"""Model API the serving engines talk to (the torch twin of
``repro/models/api.py``, decoder-LM dense and paged paths; the speculative
``verify`` passes are not ported yet, ROADMAP Queue 1 item 3).

    model = get_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0))
    cache = model.init_cache(batch, cap, device)            # dense stripes
    tok, cache = model.prefill(params, batch, cache)         # one slot's view
    pool = model.init_paged_cache(num_pages, page_size, device, batch)
    tok, pool = model.prefill_paged(params, batch, pool)
    tok, cache = model.decode(params, cache, batch)          # either layout

Batches hold tensors on the model's device, or host values the functions
move there. Caches and page pools are updated in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tf
from repro_torch.models.common import ModelConfig, init_tree
from repro_torch.models.loss import logits, next_tokens
from repro_torch.models.rotary import positions_for


def _last_valid(h: torch.Tensor, n_valid) -> torch.Tensor:
    """Hidden state of the last *valid* token of a right-padded prefill.
    h: (B, S, d); n_valid: (B,) or scalar. Returns (B, 1, d). The index is
    clipped into [0, S-1], as the JAX package clips it."""
    if n_valid is None:
        return h
    B, S, _ = h.shape
    nv = torch.as_tensor(n_valid, dtype=torch.long, device=h.device).reshape(-1)
    idx = (nv - 1).clamp(0, S - 1).expand(B)
    return h[torch.arange(B, device=h.device), idx][:, None, :]


def _tokens(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.long)


@dataclass
class DecoderLM:
    cfg: ModelConfig

    # -- params ------------------------------------------------------------
    def param_defs(self):
        return tf.param_defs(self.cfg)

    def init(self, gen: torch.Generator):
        """Random weights drawn from ``gen`` on the generator's device."""
        return init_tree(gen, self.param_defs(), self.cfg.param_dtype, gen.device)

    # -- cache ---------------------------------------------------------------
    def cache_defs(self, batch: int, cap: int):
        return tf.cache_defs(self.cfg, batch, cap)

    def init_cache(self, batch: int, cap: int, device):
        return tf.init_cache(self.cfg, batch, cap, device)

    def init_paged_cache(self, num_pages: int, page_size: int, device, batch: int = 1):
        """The page pools of the attention layers and the state of ``batch``
        slots of the recurrent ones."""
        return tf.init_paged_cache(self.cfg, num_pages, page_size, device, batch)

    # -- steps ---------------------------------------------------------------
    def hidden(self, params, tokens) -> torch.Tensor:
        """Final hidden states of a whole sequence, causal, no cache: the
        teacher-forcing path (B, S) -> (B, S, d)."""
        dev = params["embedding"].device
        tokens = _tokens(tokens, dev)
        B, S = tokens.shape
        h, _ = tf.forward(self.cfg, params, tokens, positions_for(B, S, device=dev), mode="train")
        return h

    def logits(self, params, hidden) -> torch.Tensor:
        return logits(self.cfg, params, hidden)

    def prefill(self, params, batch: Mapping, cache=None, cap: int = 0):
        """Dense whole-prompt prefill. batch: tokens (B, Lp) right-padded,
        n_valid (B,) optional (pad positions are identity for every
        recurrent update, and the token comes from the last valid position).
        ``cache`` (B-slot leaves, e.g. one slot's view of an engine's stacked
        cache) is written IN PLACE from position 0, and its recurrent state
        is zeroed first, as the fresh cache the JAX package builds starts;
        without it a fresh cache of capacity ``cap`` (default Lp) is made.
        Returns (next_token (B,), cache)."""
        dev = params["embedding"].device
        tokens = _tokens(batch["tokens"], dev)
        B, S = tokens.shape
        if cache is None:
            cache = self.init_cache(B, cap or S, dev)
        else:
            for key in tf.recurrent_keys(self.cfg):
                for leaf in cache["blocks"][key].values():
                    leaf.zero_()
        n_valid = batch.get("n_valid")
        h, cache = tf.forward(self.cfg, params, tokens, positions_for(B, S, device=dev),
                              mode="prefill", cache=cache, cache_index=0, n_valid=n_valid)
        return next_tokens(self.cfg, params, _last_valid(h, n_valid)), cache

    def prefill_paged(self, params, batch: Mapping, cache):
        """Paged prefill of ONE sequence straight into the shared page pool.

        batch: tokens (1, Lp) right-padded to a bucket length, n_valid (1,),
        tab_row (P,) block-table row, slot (the decode slot). Recurrent
        mixers run from zero state and land their final state at ``slot``.
        Returns (next_token (1,), cache)."""
        dev = params["embedding"].device
        tokens = _tokens(batch["tokens"], dev)
        B, S = tokens.shape
        if B != 1:
            raise ValueError("prefill_paged scatters through ONE block-table row; B must be 1")
        pidx = attn_mod.PagedPrefillIndex(
            tab_row=torch.as_tensor(batch["tab_row"], dtype=torch.int32, device=dev),
            slot=int(batch["slot"]),
        )
        n_valid = batch.get("n_valid")
        h, cache = tf.forward(self.cfg, params, tokens, positions_for(B, S, device=dev),
                              mode="prefill", cache=cache, cache_index=pidx, n_valid=n_valid)
        return next_tokens(self.cfg, params, _last_valid(h, n_valid)), cache

    def init_chunk_state(self, device):
        """Zero recurrent carry (B = 1) for the first chunk of a chunked
        prefill: one entry per recurrent mixer, an empty tree for
        attention-only models (their chunks live in the cache or pool)."""
        return tf.init_chunk_state(self.cfg, device)

    def install_chunk_state(self, cache, chunk_state, slot):
        """Write a finished chunked prefill's recurrent carry into the decode
        cache at ``slot``, in place (cache leaves are (n_sb, B, ...), the
        carry's (n_sb, 1, ...))."""
        for key, leaves in chunk_state["blocks"].items():
            for name, part in leaves.items():
                cache["blocks"][key][name][:, slot:slot + 1].copy_(part)
        return cache

    def prefill_chunk(self, params, batch: Mapping, cache, chunk_state):
        """Dense resumable partial-context prefill of ONE slot's stripe.

        batch: tokens (1, Cp) one right-padded chunk; n_valid (1,) valid
        tokens in this chunk; offset tokens already in the stripe. cache: the
        slot's view (B = 1 leaves, full capacity), written IN PLACE at
        ``offset``; the chunk attends over the whole stripe by absolute
        position; recurrent mixers resume from ``chunk_state`` (the carry of
        the previous chunk, ``init_chunk_state`` for the first) and leave the
        cache's state as it is. Returns (next_token (1,), cache, the new
        chunk_state); only the final chunk's token is meaningful."""
        dev = params["embedding"].device
        tokens = _tokens(batch["tokens"], dev)
        B, S = tokens.shape
        offset = int(batch["offset"])
        n_valid = batch.get("n_valid")
        h, cache, chunk_state = tf.forward(
            self.cfg, params, tokens, positions_for(B, S, offset, device=dev), mode="prefill",
            cache=cache, cache_index=attn_mod.ChunkPrefillIndex(offset), n_valid=n_valid,
            chunk_state=chunk_state)
        return next_tokens(self.cfg, params, _last_valid(h, n_valid)), cache, chunk_state

    def prefill_chunk_paged(self, params, batch: Mapping, cache, chunk_state):
        """Paged resumable partial-context prefill of ONE sequence.

        batch: tokens (1, Cp) one right-padded chunk; n_valid (1,) valid
        tokens in this chunk; offset (a page multiple) tokens already in the
        pool; tab_row (P,) the FULL block-table row; slot. Recurrent mixers
        resume from ``chunk_state``. Returns (next_token (1,), cache, the new
        chunk_state); only the final chunk's token is meaningful."""
        dev = params["embedding"].device
        tokens = _tokens(batch["tokens"], dev)
        B, S = tokens.shape
        if B != 1:
            raise ValueError("prefill_chunk_paged scatters through ONE block-table row; B must be 1")
        offset = int(batch["offset"])
        cidx = attn_mod.PagedChunkPrefillIndex(
            tab_row=torch.as_tensor(batch["tab_row"], dtype=torch.int32, device=dev),
            slot=int(batch["slot"]),
            offset=offset,
        )
        n_valid = batch.get("n_valid")
        h, cache, chunk_state = tf.forward(
            self.cfg, params, tokens, positions_for(B, S, offset, device=dev), mode="prefill",
            cache=cache, cache_index=cidx, n_valid=n_valid, chunk_state=chunk_state)
        return next_tokens(self.cfg, params, _last_valid(h, n_valid)), cache, chunk_state

    def decode(self, params, cache, batch: Mapping):
        """One batched decode step. Paged (batch has ``block_tab``): token
        (B, 1), lengths (B,) tokens already in cache, block_tab (B, P), or
        with ``l2_tab`` (n_rows, tpp) the (B, W1) first level of a chained
        table. Dense: token (B, 1) and ``lengths`` (B,) per-slot write
        positions, or a scalar ``cache_index`` for an aligned batch. Returns
        (next_tokens (B,), cache)."""
        dev = params["embedding"].device
        tok = _tokens(batch["token"], dev)
        B, S = tok.shape
        if "block_tab" in batch:
            lens = torch.as_tensor(batch["lengths"], dtype=torch.int32, device=dev)
            l2 = batch.get("l2_tab")
            idx = attn_mod.PagedIndex(
                lens, torch.as_tensor(batch["block_tab"], dtype=torch.int32, device=dev),
                None if l2 is None else torch.as_tensor(l2, dtype=torch.int32, device=dev),
            )
            pos = lens[:, None] + torch.arange(S, dtype=torch.int32, device=dev)[None, :]
        elif "lengths" in batch:
            idx = torch.as_tensor(batch["lengths"], dtype=torch.int32, device=dev)
            pos = idx[:, None] + torch.arange(S, dtype=torch.int32, device=dev)[None, :]
        else:
            idx = int(batch["cache_index"])
            pos = positions_for(B, S, idx, device=dev)
        h, cache = tf.forward(self.cfg, params, tok, pos, mode="decode", cache=cache,
                              cache_index=idx)
        return next_tokens(self.cfg, params, h), cache


def get_model(cfg: ModelConfig) -> DecoderLM:
    return DecoderLM(cfg)
