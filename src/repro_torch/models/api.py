"""Model API the serving engines talk to (the torch twin of
``repro/models/api.py``): the decoder LM's dense and paged paths, the VLM
backbone ``EmbedsLM`` (a prompt of precomputed embeddings and M-RoPE
positions) and the encoder-decoder ``EncDecLM`` (whisper: frames and
tokens), each chosen by ``get_model``.

    model = get_model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0))   # int8 with cfg.weights_int8
    cache = model.init_cache(batch, cap, device)            # dense stripes
    tok, cache = model.prefill(params, batch, cache)         # one slot's view
    pool = model.init_paged_cache(num_pages, page_size, device, batch)
    tok, pool = model.prefill_paged(params, batch, pool)
    tok, cache = model.decode(params, cache, batch)          # either layout
    toks, cache = model.verify(params, batch, cache)         # speculative, one slot's view
    toks, pool = model.verify_paged(params, batch, pool)
    tok, cache = EmbedsLM(cfg).prefill(params, {"inputs_embeds": e, "positions": p})
    tok, cache = EncDecLM(cfg).prefill(params, {"frames": f, "tokens": t})
    loss, metrics = model.loss(params, {"tokens": t, "labels": l})   # training
    loss, metrics = model.loss(params, batch, ctx=make_ctx(mesh))    # sharded: DTensor params
    model.param_shapes(); model.input_specs(shape)           # the dry run's meta stand-ins

Every method the JAX package gives a ``ctx`` takes one as a keyword
(``ctx=None``: one device). A ctx over one device takes the single-device
path. Over more than one, ``loss`` runs sharded on DTensor parameters (laid
out as ``launch/steps.param_shardings`` says); the serving methods raise
``NotImplementedError``: their sequence-sharded cache waits for ROADMAP
Queue 1 item 10, sub-item 5.

Batches hold tensors on the model's device, or host values the functions
move there. Caches and page pools are updated in place.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tf
from repro_torch.models import whisper as wh
from repro_torch.models.common import ModelConfig, init_tree, shape_tree
from repro_torch.models.loss import lm_loss, logits, next_tokens, next_tokens_all
from repro_torch.models.quant import check_int8_family, init_quantized
from repro_torch.models.rotary import mrope_positions_for, positions_for
from repro_torch.models.transformer import sharded


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


def _tok(shape, device) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device=device)


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


def _serving(ctx) -> None:
    """Serving on a multi-device mesh raises (its cache is not ported)."""
    if sharded(ctx):
        raise NotImplementedError(attn_mod.SERVING_ON_MESH)


@dataclass
class DecoderLM:
    cfg: ModelConfig

    # -- params ------------------------------------------------------------
    def param_defs(self):
        return tf.param_defs(self.cfg)

    def init(self, gen: torch.Generator):
        """Random weights drawn from ``gen`` on the generator's device. With
        ``cfg.weights_int8`` the tree is weight-only int8 (``models/quant.py``),
        drawn leaf by leaf and a superblock's slice at a time, each slice
        quantized as ``quantize_params`` quantizes the floating-point tree,
        so that tree never exists whole: qwen1.5-32b's 70 GB of bf16 weights
        become a 36 GB tree on the card, and jamba-1.5-large's superblock
        (90.5 GB in bf16) a 48.7 GB one. The stacked expert leaves (n_sb, E,
        d, f) are drawn and quantized one (d, f) slice at a time. Bit for bit
        ``quantize_params`` of the floating-point init on the CPU at smoke
        size; on the card its own draw. Every family the JAX package
        quantizes (attention and Mamba decoders, MoE, the VLM backbone, the
        encoder-decoder, whose ``param_defs`` this walks whole); the xLSTM
        mixers raise ``WeightsInt8Error``."""
        if self.cfg.weights_int8:
            check_int8_family(self.cfg)
            return init_quantized(gen, self.param_defs(), self.cfg.param_dtype, gen.device)
        return init_tree(gen, self.param_defs(), self.cfg.param_dtype, gen.device)

    def param_shapes(self, device="meta"):
        """Empty tensors of the parameters' shapes and dtype (on the meta
        device, the dry run's stand-ins; ``models/quant.quantized_shape_tree``
        gives the weight-only int8 tree's)."""
        return shape_tree(self.param_defs(), self.cfg.param_dtype, device)

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
    def _positions(self, batch: int, seq: int, offset=0, device=None) -> torch.Tensor:
        """Standard positions offset + arange(seq): (batch, seq), or the
        three text-only M-RoPE streams (3, batch, seq)."""
        if self.cfg.pos == "mrope":
            return mrope_positions_for(batch, seq, offset, device)
        return positions_for(batch, seq, offset, device)

    def _prompt_positions(self, positions, B: int, S: int, dev):
        """A whole sequence's positions and whether they are the index's:
        the caller's (any values, so False), else the standard ones (True).
        Only index positions let attention take the index-masked flash
        kernel; the flag is known on the host, nothing is read back."""
        if positions is None:
            return self._positions(B, S, device=dev), True
        return torch.as_tensor(positions, device=dev), False

    def _inputs(self, tokens, inputs_embeds, dev):
        """tokens (B, S) or inputs_embeds (B, S, d) on ``dev``, the other
        None, and (B, S)."""
        if inputs_embeds is not None:
            inputs_embeds = torch.as_tensor(inputs_embeds, device=dev)
            return None, inputs_embeds, *inputs_embeds.shape[:2]
        tokens = _tokens(tokens, dev)
        return tokens, None, *tokens.shape

    def hidden(self, params, tokens=None, positions=None, inputs_embeds=None, ctx=None) -> torch.Tensor:
        """Final hidden states of a whole sequence, causal, no cache: the
        teacher-forcing path, tokens (B, S) or ``inputs_embeds`` (B, S, d)
        -> (B, S, d). ``positions`` as ``prefill`` takes them."""
        dev = params["embedding"].device
        tokens, inputs_embeds, B, S = self._inputs(tokens, inputs_embeds, dev)
        pos, index = self._prompt_positions(positions, B, S, dev)
        h, _ = tf.forward(self.cfg, params, tokens, pos, mode="train", inputs_embeds=inputs_embeds,
                          index_positions=index, ctx=ctx)
        return h

    def logits(self, params, hidden) -> torch.Tensor:
        return logits(self.cfg, params, hidden)

    def loss(self, params, batch: Mapping, ctx=None):
        """The training loss of tokens (B, S) against labels (B, S) (IGNORE
        masks a position), positions optional as ``hidden`` takes them:
        ``lm_loss`` plus, for an MoE model, ``moe.aux_weight`` times the
        layers' aux loss. Returns (loss, metrics). On a mesh the batch's
        entries (full tensors or DTensors) are sharded over the batch axes,
        and the loss and metrics are replicated DTensors."""
        dev = params["embedding"].device
        tokens, _, B, S = self._inputs(batch["tokens"], None, dev)
        pos, index = self._prompt_positions(batch.get("positions"), B, S, dev)
        h, aux = tf.forward(self.cfg, params, tokens, pos, mode="train", index_positions=index, ctx=ctx)
        loss, metrics = lm_loss(self.cfg, params, h, _tokens(batch["labels"], dev), ctx=ctx)
        if self.cfg.moe is not None:
            loss = loss + self.cfg.moe.aux_weight * aux
            metrics["moe_aux"] = aux
        return loss, metrics

    def _prompt_cache(self, cache, B: int, cap: int, dev):
        """The cache a whole-prompt prefill writes from position 0: the
        given one with its recurrent state zeroed (as the fresh cache the
        JAX package builds starts), or a fresh one of capacity ``cap``."""
        if cache is None:
            return self.init_cache(B, cap, dev)
        for key in tf.recurrent_keys(self.cfg):
            for leaf in cache["blocks"][key].values():
                leaf.zero_()
        return cache

    def prefill(self, params, batch: Mapping, cache=None, cap: int = 0, ctx=None):
        """Dense whole-prompt prefill. batch: tokens (B, Lp) right-padded,
        n_valid (B,) optional (pad positions are identity for every
        recurrent update, and the token comes from the last valid position),
        positions (B, S) optional ((3, B, S) under M-RoPE; default
        ``arange``). ``cache`` (B-slot leaves, e.g. one slot's view of an
        engine's stacked cache) is written IN PLACE from position 0, and its
        recurrent state is zeroed first; without it a fresh cache of
        capacity ``cap`` (default Lp) is made. Returns (next_token (B,),
        cache)."""
        _serving(ctx)
        return self._prefill(params, batch, cache, cap, tokens=batch["tokens"])

    def _prefill(self, params, batch: Mapping, cache, cap: int, tokens=None, inputs_embeds=None):
        """``prefill``'s body over tokens (B, Lp) or inputs_embeds (B, Lp, d)."""
        dev = params["embedding"].device
        tokens, inputs_embeds, B, S = self._inputs(tokens, inputs_embeds, dev)
        cache = self._prompt_cache(cache, B, cap or S, dev)
        n_valid = batch.get("n_valid")
        pos, index = self._prompt_positions(batch.get("positions"), B, S, dev)
        h, cache = tf.forward(self.cfg, params, tokens, pos, mode="prefill", cache=cache, cache_index=0,
                              n_valid=n_valid, inputs_embeds=inputs_embeds, index_positions=index)
        return next_tokens(self.cfg, params, _last_valid(h, n_valid)), cache

    def prefill_paged(self, params, batch: Mapping, cache, ctx=None):
        """Paged prefill of ONE sequence straight into the shared page pool.

        batch: tokens (1, Lp) right-padded to a bucket length, n_valid (1,),
        tab_row (P,) block-table row, slot (the decode slot), positions
        optional, as ``prefill`` takes them. Recurrent mixers run from zero
        state and land their final state at ``slot``. Returns (next_token
        (1,), cache)."""
        _serving(ctx)
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
        pos, index = self._prompt_positions(batch.get("positions"), B, S, dev)
        h, cache = tf.forward(self.cfg, params, tokens, pos, mode="prefill", cache=cache,
                              cache_index=pidx, n_valid=n_valid, index_positions=index)
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

    def prefill_chunk(self, params, batch: Mapping, cache, chunk_state, ctx=None):
        """Dense resumable partial-context prefill of ONE slot's stripe.

        batch: tokens (1, Cp) one right-padded chunk; n_valid (1,) valid
        tokens in this chunk; offset tokens already in the stripe. cache: the
        slot's view (B = 1 leaves, full capacity), written IN PLACE at
        ``offset``; the chunk attends over the whole stripe by absolute
        position; recurrent mixers resume from ``chunk_state`` (the carry of
        the previous chunk, ``init_chunk_state`` for the first) and leave the
        cache's state as it is. Returns (next_token (1,), cache, the new
        chunk_state); only the final chunk's token is meaningful."""
        _serving(ctx)
        dev = params["embedding"].device
        tokens = _tokens(batch["tokens"], dev)
        B, S = tokens.shape
        offset = int(batch["offset"])
        n_valid = batch.get("n_valid")
        h, cache, chunk_state = tf.forward(
            self.cfg, params, tokens, self._positions(B, S, offset, dev), mode="prefill",
            cache=cache, cache_index=attn_mod.ChunkPrefillIndex(offset), n_valid=n_valid,
            chunk_state=chunk_state)
        return next_tokens(self.cfg, params, _last_valid(h, n_valid)), cache, chunk_state

    def prefill_chunk_paged(self, params, batch: Mapping, cache, chunk_state, ctx=None):
        """Paged resumable partial-context prefill of ONE sequence.

        batch: tokens (1, Cp) one right-padded chunk; n_valid (1,) valid
        tokens in this chunk; offset (a page multiple) tokens already in the
        pool; tab_row (P,) the FULL block-table row; slot. Recurrent mixers
        resume from ``chunk_state``. Returns (next_token (1,), cache, the new
        chunk_state); only the final chunk's token is meaningful."""
        _serving(ctx)
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
            self.cfg, params, tokens, self._positions(B, S, offset, dev), mode="prefill",
            cache=cache, cache_index=cidx, n_valid=n_valid, chunk_state=chunk_state)
        return next_tokens(self.cfg, params, _last_valid(h, n_valid)), cache, chunk_state

    def verify(self, params, batch: Mapping, cache, ctx=None):
        """Dense speculative verify of ONE slot's stripe (B = 1).

        batch: tokens (1, S), the slot's pending last token then k proposal
        tokens; offset, tokens already in the stripe (any position: dense
        stripes need no alignment). All S tokens' K/V are written IN PLACE
        at ``offset`` (a verify step is a chunk: ``ChunkPrefillIndex``) and
        the greedy next token is read at every position. Attention-only
        decoders (the engines enforce it). Returns (tokens (1, S), cache)."""
        _serving(ctx)
        dev = params["embedding"].device
        tokens = _tokens(batch["tokens"], dev)
        B, S = tokens.shape
        if B != 1:
            raise ValueError("verify runs ONE slot's stripe; B must be 1")
        offset = int(batch["offset"])
        h, cache = tf.forward(self.cfg, params, tokens, self._positions(B, S, offset, dev),
                              mode="prefill", cache=cache,
                              cache_index=attn_mod.ChunkPrefillIndex(offset))
        return next_tokens_all(self.cfg, params, h), cache

    def verify_paged(self, params, batch: Mapping, cache, ctx=None):
        """Paged speculative verify of ONE sequence (B = 1): as ``verify``,
        against the shared page pool; batch also carries tab_row (P,), the
        sequence's full block-table row. The S tokens scatter through the
        row at a mid-page offset (``PagedVerifyIndex``) and attend over the
        gathered context by absolute position. Returns (tokens (1, S),
        cache)."""
        _serving(ctx)
        dev = params["embedding"].device
        tokens = _tokens(batch["tokens"], dev)
        B, S = tokens.shape
        if B != 1:
            raise ValueError("verify_paged scatters through ONE block-table row; B must be 1")
        offset = int(batch["offset"])
        vidx = attn_mod.PagedVerifyIndex(
            tab_row=torch.as_tensor(batch["tab_row"], dtype=torch.int32, device=dev), offset=offset)
        h, cache = tf.forward(self.cfg, params, tokens, self._positions(B, S, offset, dev),
                              mode="prefill", cache=cache, cache_index=vidx)
        return next_tokens_all(self.cfg, params, h), cache

    def decode(self, params, cache, batch: Mapping, ctx=None):
        """One batched decode step. Paged (batch has ``block_tab``): token
        (B, 1), lengths (B,) tokens already in cache, block_tab (B, P), or
        with ``l2_tab`` (n_rows, tpp) the (B, W1) first level of a chained
        table. Dense: token (B, 1) and ``lengths`` (B,) per-slot write
        positions, or a scalar ``cache_index`` for an aligned batch. Positions
        follow the cache index, under M-RoPE in all three streams (after an
        image prompt too, as in the JAX package). Returns (next_tokens (B,),
        cache)."""
        _serving(ctx)
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
        if self.cfg.pos == "mrope":
            pos = pos[None].expand(3, B, S)
        h, cache = tf.forward(self.cfg, params, tok, pos, mode="decode", cache=cache,
                              cache_index=idx)
        return next_tokens(self.cfg, params, h), cache

    # -- dry-run specs ---------------------------------------------------------
    def input_specs(self, shape: ShapeSpec, device="meta") -> dict:
        """Empty tensors of every input of the step ``shape`` names, with the
        JAX package's shapes and dtypes (int32 ids and a scalar
        ``cache_index``), on the meta device by default: the port's
        ``ShapeDtypeStruct``. The dry run hands the decode step a host int
        for ``cache_index`` (``launch/steps.lower_decode``)."""
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "train":
            return {"tokens": _tok((B, S), device), "labels": _tok((B, S), device)}
        if shape.kind == "prefill":
            return {"tokens": _tok((B, S), device)}
        if shape.kind == "decode":
            return {"token": _tok((B, 1), device), "cache_index": _tok((), device)}
        raise ValueError(shape.kind)


@dataclass
class EmbedsLM(DecoderLM):
    """VLM backbone: a prompt arrives as precomputed patch and token
    embeddings (the vision frontend is a stub). Token prompts take the
    decoder LM's paths, with text-only M-RoPE positions."""

    def prefill(self, params, batch: Mapping, cache=None, cap: int = 0, ctx=None):
        """Dense whole-prompt prefill of inputs_embeds (B, S, d), with
        positions (3, B, S) optional (``vlm.mrope_positions_with_image`` for
        an image prompt; default text-only) and n_valid optional; ``cache``
        and ``cap`` as ``DecoderLM.prefill`` takes them. A batch without
        ``inputs_embeds`` raises KeyError, as the JAX package's does.
        Returns (next_token (B,), cache)."""
        _serving(ctx)
        return self._prefill(params, batch, cache, cap, inputs_embeds=batch["inputs_embeds"])

    def loss(self, params, batch: Mapping, ctx=None):
        """The training loss over inputs_embeds (B, S, d) against labels (B,
        S), positions (3, B, S) optional: ``lm_loss`` alone (no aux term, as
        in the JAX package). Returns (loss, metrics)."""
        h = self.hidden(params, positions=batch.get("positions"), inputs_embeds=batch["inputs_embeds"], ctx=ctx)
        return lm_loss(self.cfg, params, h, _tokens(batch["labels"], h.device), ctx=ctx)

    def input_specs(self, shape: ShapeSpec, device="meta") -> dict:
        """As ``DecoderLM.input_specs``, the prompt as inputs_embeds (B, S,
        d) in the compute dtype with M-RoPE positions (3, B, S)."""
        B, S, d = shape.global_batch, shape.seq_len, self.cfg.d_model
        emb = torch.empty((B, S, d), dtype=self.cfg.compute_dtype, device=device)
        pos = _tok((3, B, S), device)
        if shape.kind == "train":
            return {"inputs_embeds": emb, "positions": pos, "labels": _tok((B, S), device)}
        if shape.kind == "prefill":
            return {"inputs_embeds": emb, "positions": pos}
        if shape.kind == "decode":
            return {"token": _tok((B, 1), device), "cache_index": _tok((), device)}
        raise ValueError(shape.kind)


@dataclass
class EncDecLM(DecoderLM):
    """Whisper-style encoder-decoder; frames are stub (precomputed)
    embeddings. Parameters {"decoder", "encoder"}; the dense cache carries
    each decoder layer's cross K/V of ``cfg.encoder.n_ctx`` frames. Only the
    dense whole-prompt prefill and the aligned decode exist, as in the JAX
    package (no paged cache, no chunked prefill)."""

    def param_defs(self):
        return wh.param_defs(self.cfg)

    def cache_defs(self, batch: int, cap: int):
        return tf.cache_defs(self.cfg, batch, cap, enc_len=self.cfg.encoder.n_ctx)

    def init_cache(self, batch: int, cap: int, device):
        return tf.init_cache(self.cfg, batch, cap, device, enc_len=self.cfg.encoder.n_ctx)

    def hidden(self, params, tokens, frames) -> torch.Tensor:
        """The decoder's final hidden states over tokens (B, S) after the
        encoder over frames (B, T, d): the teacher-forcing path."""
        dev = params["decoder"]["embedding"].device
        tokens = _tokens(tokens, dev)
        B, S = tokens.shape
        h, _ = wh.forward(self.cfg, params, frames=torch.as_tensor(frames, device=dev), tokens=tokens,
                          positions=positions_for(B, S, device=dev), mode="train")
        return h

    def logits(self, params, hidden) -> torch.Tensor:
        return logits(self.cfg, params["decoder"], hidden)

    def loss(self, params, batch: Mapping, ctx=None):
        """The training loss of the decoder over tokens (B, S) after the
        encoder over frames (B, T, d), against labels (B, S): ``lm_loss``
        on the decoder's unembedding, no aux term. Returns (loss,
        metrics). The encoder-decoder on a multi-device mesh is not
        ported: such a ctx raises ``NotImplementedError``."""
        if sharded(ctx):
            raise NotImplementedError("the encoder-decoder on a multi-device mesh is not ported "
                                      "(ROADMAP Queue 1 item 10)")
        h = self.hidden(params, batch["tokens"], batch["frames"])
        return lm_loss(self.cfg, params["decoder"], h, _tokens(batch["labels"], h.device))

    def prefill(self, params, batch: Mapping, cache=None, cap: int = 0, ctx=None):
        """batch: frames (B, n_ctx, d), tokens (B, Lp) right-padded, n_valid
        (B,) optional. The encoder runs over the frames, each decoder layer
        caches its cross K/V, and the tokens' K/V go into the cache from
        position 0 (a fresh cache of capacity ``cap``, default Lp, when none
        is given). Returns (next_token (B,), cache)."""
        _serving(ctx)
        dev = params["decoder"]["embedding"].device
        tokens = _tokens(batch["tokens"], dev)
        B, S = tokens.shape
        frames = torch.as_tensor(batch["frames"], device=dev)
        cache = self._prompt_cache(cache, B, cap or S, dev)
        n_valid = batch.get("n_valid")
        h, cache = wh.forward(self.cfg, params, frames=frames, tokens=tokens,
                              positions=positions_for(B, S, device=dev), mode="prefill", cache=cache,
                              cache_index=0, n_valid=n_valid)
        return next_tokens(self.cfg, params["decoder"], _last_valid(h, n_valid)), cache

    def decode(self, params, cache, batch: Mapping, ctx=None):
        """One aligned decode step: token (B, 1) at the scalar
        ``cache_index``. Returns (next_tokens (B,), cache)."""
        _serving(ctx)
        dev = params["decoder"]["embedding"].device
        tok = _tokens(batch["token"], dev)
        B, S = tok.shape
        idx = int(batch["cache_index"])
        h, cache = wh.forward(self.cfg, params, tokens=tok, positions=positions_for(B, S, idx, dev),
                              mode="decode", cache=cache, cache_index=idx)
        return next_tokens(self.cfg, params["decoder"], h), cache

    def input_specs(self, shape: ShapeSpec, device="meta") -> dict:
        """As ``DecoderLM.input_specs``, with the encoder's frames (B, n_ctx,
        d) in the compute dtype for training and prefill."""
        B, S = shape.global_batch, shape.seq_len
        frames = torch.empty((B, self.cfg.encoder.n_ctx, self.cfg.d_model), dtype=self.cfg.compute_dtype,
                             device=device)
        if shape.kind == "train":
            return {"frames": frames, "tokens": _tok((B, S), device), "labels": _tok((B, S), device)}
        if shape.kind == "prefill":
            return {"frames": frames, "tokens": _tok((B, S), device)}
        if shape.kind == "decode":
            return {"token": _tok((B, 1), device), "cache_index": _tok((), device)}
        raise ValueError(shape.kind)


def get_model(cfg: ModelConfig) -> DecoderLM:
    if cfg.encoder is not None:
        return EncDecLM(cfg)
    if cfg.inputs == "embeds":
        return EmbedsLM(cfg)
    return DecoderLM(cfg)
