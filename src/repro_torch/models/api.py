"""Model API the serving engine talks to (the torch twin of
``repro/models/api.py``, decoder-LM paged paths only).

    model = get_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0))
    cache = model.init_paged_cache(num_pages, page_size, device)
    tok, cache = model.prefill_paged(params, batch, cache)
    tok, cache = model.decode(params, cache, batch)

Batches hold tensors on the model's device, or host values the functions
move there. The page pools are updated in place.
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
    def init_paged_cache(self, num_pages: int, page_size: int, device):
        return tf.init_paged_cache(self.cfg, num_pages, page_size, device)

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

    def prefill_paged(self, params, batch: Mapping, cache):
        """Paged prefill of ONE sequence straight into the shared page pool.

        batch: tokens (1, Lp) right-padded to a bucket length, n_valid (1,),
        tab_row (P,) block-table row, slot (the decode slot). Returns
        (next_token (1,), cache)."""
        dev = params["embedding"].device
        tokens = _tokens(batch["tokens"], dev)
        B, S = tokens.shape
        if B != 1:
            raise ValueError("prefill_paged scatters through ONE block-table row; B must be 1")
        pidx = attn_mod.PagedPrefillIndex(
            tab_row=torch.as_tensor(batch["tab_row"], dtype=torch.int32, device=dev),
            slot=int(batch["slot"]),
        )
        h, cache = tf.forward(self.cfg, params, tokens, positions_for(B, S, device=dev),
                              mode="prefill", cache=cache, cache_index=pidx)
        return next_tokens(self.cfg, params, _last_valid(h, batch.get("n_valid"))), cache

    def init_chunk_state(self):
        """The chunked-prefill recurrent carry: empty for attention-only
        models (their chunks live in the pool)."""
        return {"blocks": {}}

    def install_chunk_state(self, cache, chunk_state, slot):
        """Install a finished chunked prefill's recurrent carry at ``slot``:
        nothing to do for attention-only models."""
        if chunk_state["blocks"]:
            raise NotImplementedError("recurrent chunk state is not ported yet")
        return cache

    def prefill_chunk_paged(self, params, batch: Mapping, cache, chunk_state):
        """Paged resumable partial-context prefill of ONE sequence.

        batch: tokens (1, Cp) one right-padded chunk; n_valid (1,) valid
        tokens in this chunk; offset (a page multiple) tokens already in the
        pool; tab_row (P,) the FULL block-table row; slot. Returns
        (next_token (1,), cache, chunk_state); only the final chunk's token
        is meaningful."""
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
        h, cache = tf.forward(self.cfg, params, tokens, positions_for(B, S, offset, device=dev),
                              mode="prefill", cache=cache, cache_index=cidx)
        tok = next_tokens(self.cfg, params, _last_valid(h, batch.get("n_valid")))
        return tok, cache, chunk_state

    def decode(self, params, cache, batch: Mapping):
        """One batched decode step over the page pool. batch: token (B, 1),
        lengths (B,) tokens already in cache, block_tab (B, P). Returns
        (next_tokens (B,), cache)."""
        if "block_tab" not in batch:
            raise NotImplementedError("the dense decode path is not ported yet (ROADMAP Queue 1 item 7)")
        dev = params["embedding"].device
        tok = _tokens(batch["token"], dev)
        B, S = tok.shape
        lens = torch.as_tensor(batch["lengths"], dtype=torch.int32, device=dev)
        pidx = attn_mod.PagedIndex(
            lens, torch.as_tensor(batch["block_tab"], dtype=torch.int32, device=dev)
        )
        pos = lens[:, None] + torch.arange(S, dtype=torch.int32, device=dev)[None, :]
        h, cache = tf.forward(self.cfg, params, tok, pos, mode="decode", cache=cache,
                              cache_index=pidx)
        return next_tokens(self.cfg, params, h), cache


def get_model(cfg: ModelConfig) -> DecoderLM:
    return DecoderLM(cfg)
