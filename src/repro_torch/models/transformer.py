"""Decoder stack: the superblock pattern run as a Python loop over the stacked
superblock parameters (the JAX package scans them with ``lax.scan``).

Every mixer kind of the reference: attention (with a gated or a plain GELU
MLP, or the mixture-of-experts FFN on the layers ``cfg.layer_has_moe``
names), Mamba (jamba's hybrid superblock), and the xLSTM family's mLSTM and
sLSTM (no FFN, ``d_ff = 0``). With
``cfg.cross_attn`` (the whisper decoder) every layer also attends over the
encoder's output, whose K/V the prefill computes and keeps in the cache.

Parameters, caches and pools keep the JAX package's stacked layout: every
leaf under ``blocks`` carries a leading (n_superblocks,) axis, so a layer's
parameters and caches are views ``leaf[i]`` and in-place writes land in the
stack. Recurrent mixers return new state tensors, which are copied into the
cache's leaves.

Training (``mode="train"`` where a gradient is wanted) wraps each superblock in
``torch.utils.checkpoint`` as ``cfg.remat`` says (``_remat_wrap``) and sums
the MoE layers' aux loss over the stack, as the reference's ``run_stack``
carries it. The reference's ``_loop_barrier`` (a ``custom_vjp`` around
``optimization_barrier``) only keeps XLA from hoisting loop-invariant work
out of its ``lax.scan``; a Python loop has nothing to hoist, so it has no
twin here.
"""
from __future__ import annotations

import functools
from typing import Mapping, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.kernels import _grad
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
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
from repro_torch.models.moe import moe_defs, moe_ffn, moe_ffn_sharded
from repro_torch.sharding.axes import NamedSharding, P, gather_fsdp, redistribute, with_sharding_constraint

RECURRENT = {"mamba": (mam.mamba_defs, mam.mamba_cache_defs, mam.mamba_mixer),
             "mlstm": (xl.mlstm_defs, xl.mlstm_cache_defs, xl.mlstm_mixer),
             "slstm": (xl.slstm_defs, xl.slstm_cache_defs, xl.slstm_mixer)}


def _check_pattern(cfg: ModelConfig) -> None:
    """An unknown mixer kind raises ``ValueError(kind)``, as the reference's
    ``superblock_defs`` does."""
    for kind in cfg.block_pattern:
        if kind != "attn" and kind not in RECURRENT:
            raise ValueError(kind)


def superblock_defs(cfg: ModelConfig) -> dict:
    _check_pattern(cfg)
    defs: dict = {}
    for i, kind in enumerate(cfg.block_pattern):
        defs[f"l{i}_norm"] = norm_defs(cfg)
        defs[f"l{i}_mixer"] = attn.attention_defs(cfg) if kind == "attn" else RECURRENT[kind][0](cfg)
        if cfg.cross_attn:
            defs[f"l{i}_cross_norm"] = norm_defs(cfg)
            defs[f"l{i}_cross"] = attn.attention_defs(cfg, cross=True)
        if cfg.d_ff > 0:
            defs[f"l{i}_ffn_norm"] = norm_defs(cfg)
            defs[f"l{i}_ffn"] = moe_defs(cfg) if cfg.layer_has_moe(i) else mlp_defs(cfg)
    return defs


def param_defs(cfg: ModelConfig) -> dict:
    defs = dict(embed_defs(cfg))
    defs["blocks"] = stack_defs(superblock_defs(cfg), cfg.n_superblocks)
    defs["final_norm"] = norm_defs(cfg)
    return defs


def _stacked(cfg: ModelConfig, per_layer, cross=None) -> dict:
    """{"blocks": {l<i>_mixer: leaves}} with the superblock axis prepended;
    ``per_layer(kind)`` gives a layer's TensorSpecs (None: no entry), and
    ``cross`` (with ``cfg.cross_attn``) those of its ``l<i>_cross`` entry."""
    n = cfg.n_superblocks

    def stack(specs):
        return {name: attn.TensorSpec((n,) + s.shape, s.dtype) for name, s in specs.items()}

    blocks = {}
    for i, kind in enumerate(cfg.block_pattern):
        specs = per_layer(kind)
        if specs is not None:
            blocks[f"l{i}_mixer"] = stack(specs)
        if cross is not None:
            blocks[f"l{i}_cross"] = stack(cross)
    return {"blocks": blocks}


def _init(defs: dict, device) -> dict:
    return {"blocks": {
        key: {name: torch.zeros(s.shape, dtype=s.dtype, device=device) for name, s in leaves.items()}
        for key, leaves in defs["blocks"].items()
    }}


def cache_defs(cfg: ModelConfig, batch: int, cap: int, enc_len: int = 0) -> dict:
    """Dense decode cache: every attention layer has a (batch, cap) stripe
    per slot, every recurrent layer its state per slot, stacked on the
    superblock axis. With ``cfg.cross_attn`` every layer also keeps the
    cross-attention K/V of ``enc_len`` encoder frames per slot, (batch,
    enc_len, H, hd) in the compute dtype."""
    _check_pattern(cfg)
    cross = None
    if cfg.cross_attn:
        if enc_len <= 0:
            raise ValueError(f"{cfg.name}: a cross-attention cache needs enc_len > 0")
        spec = attn.TensorSpec((batch, enc_len, cfg.n_heads, cfg.hd), cfg.compute_dtype)
        cross = {"k": spec, "v": spec}
    return _stacked(cfg, lambda kind: attn.kv_cache_defs(cfg, batch, cap) if kind == "attn"
                    else RECURRENT[kind][1](cfg, batch), cross)


def init_cache(cfg: ModelConfig, batch: int, cap: int, device, enc_len: int = 0) -> dict:
    return _init(cache_defs(cfg, batch, cap, enc_len), device)


def paged_cache_defs(cfg: ModelConfig, num_pages: int, page_size: int, batch: int = 1) -> dict:
    """Paged decode cache: every attention layer has its page pool, every
    recurrent layer its state per slot (``batch`` slots), stacked on the
    superblock axis. Cross-attention has no paged layout, as in the JAX
    package."""
    _check_pattern(cfg)
    if cfg.cross_attn:
        raise NotImplementedError("paged cache does not support cross-attention")
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


def _leaves(tree):
    """The tensors of a nested dict, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for v in tree.values() for t in _leaves(v)]


def _write(dst: Mapping, src: Mapping, at: Optional[int] = None) -> None:
    """Copy a mixer's new state into cache leaves, in place (at slot ``at``
    of a batch axis when given)."""
    for name, t in src.items():
        leaf = dst[name] if at is None else dst[name][at:at + 1]
        leaf.copy_(t)


def sharded(ctx) -> bool:
    """True where ``ctx`` spans more than one device: the model runs on
    DTensors. With ``ctx`` None or a mesh of one device it runs as on one
    device, as ``moe.moe_ffn`` does."""
    return ctx is not None and ctx.n_devices > 1


def _constrain(ctx, x, seq_shard: bool = False):
    """Pin activations (B, S, ...) to the batch axes, the rest replicated
    (the reference's ``_constrain``). Megatron-style sequence sharding of
    the activations (``seq_shard``) is not ported."""
    if seq_shard:
        raise NotImplementedError("seq_shard_activations: sequence-sharded activations wait for "
                                  "ROADMAP Queue 1 item 10, sub-item 2")
    if not sharded(ctx):
        return x
    spec = P(ctx.batch_spec_for(x.shape[0]), *([None] * (x.ndim - 1)))
    return with_sharding_constraint(x, NamedSharding(ctx.mesh, spec))


def _superblock(cfg: ModelConfig, p: Mapping, x: torch.Tensor, positions, mode: str,
                cache_sb: Optional[Mapping], cache_index, valid=None, chunk_sb=None,
                enc_out=None, causal: bool = True, index_positions: bool = True, ctx=None):
    """One superblock. Returns (x, new_chunk, aux) where ``new_chunk`` holds
    the recurrent carry after this chunk when ``chunk_sb`` was given and
    ``aux`` is, in train mode, the sum of its MoE layers' aux losses (an f32
    scalar tensor; 0.0 without MoE layers, and in serving, which drops it).

    Cross-attention (``cfg.cross_attn``): train projects ``enc_out`` to K/V;
    prefill does so and copies them into the cache; decode reads them from
    the cache.

    Chunked prefill (a ``ChunkPrefillIndex`` or ``PagedChunkPrefillIndex``
    with a carry): recurrent mixers resume from and return ``chunk_sb``; the
    in-cache state is left as it is. Paged prefill: recurrent mixers run from
    zero state (a fresh sequence) and their final state lands at the slot.
    Otherwise (dense prefill, decode): they run from the cache's state and
    write the new state back.

    On a mesh (``sharded(ctx)``) x and ``p`` are DTensors: the layer's
    parameters are gathered over the fsdp axis, x is pinned to the batch
    axes at entry and exit (``_constrain``), and so is each residual
    branch's output before it is added."""
    new_chunk: dict = {}
    aux = 0.0
    if sharded(ctx):
        p = gather_fsdp(p, ctx)
        x = _constrain(ctx, x)
    chunk_pf = isinstance(cache_index, (attn.ChunkPrefillIndex, attn.PagedChunkPrefillIndex))
    paged_pf = isinstance(cache_index, attn.PagedPrefillIndex)
    for i, kind in enumerate(cfg.block_pattern):
        key = f"l{i}_mixer"
        h = apply_norm(cfg, p[f"l{i}_norm"], x)
        c_in = cache_sb[key] if cache_sb is not None else None
        if kind == "attn":
            h, _ = attn.self_attention(cfg, p[key], h, positions, mode, c_in, cache_index,
                                       causal=causal, index_positions=index_positions)
        elif sharded(ctx):
            raise NotImplementedError(f"{kind} mixers on a multi-device mesh are not ported (ROADMAP Queue 1 "
                                      f"item 10)")
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
        x = x + _constrain(ctx, h)
        if cfg.cross_attn:
            h = apply_norm(cfg, p[f"l{i}_cross_norm"], x)
            if mode == "decode":
                kv = cache_sb[f"l{i}_cross"]
            else:
                kv = attn.cross_kv(cfg, p[f"l{i}_cross"], enc_out)
                if mode == "prefill":
                    _write(cache_sb[f"l{i}_cross"], kv)
            x = x + attn.cross_attention(cfg, p[f"l{i}_cross"], h, kv)
        if cfg.d_ff > 0:
            h = apply_norm(cfg, p[f"l{i}_ffn_norm"], x)
            if cfg.layer_has_moe(i):
                if sharded(ctx):
                    h, a = moe_ffn_sharded(cfg, ctx, p[f"l{i}_ffn"], h, valid=valid)
                else:
                    h, a = moe_ffn(cfg, p[f"l{i}_ffn"], h, valid=valid)
                if mode == "train":
                    aux = aux + a
            else:
                h = mlp(cfg, p[f"l{i}_ffn"], h)
            x = x + _constrain(ctx, h)
    return _constrain(ctx, x), new_chunk, aux


def _save_products(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the outputs of products with no batch dims
    (``aten.mm``, ``aten.addmm``), recompute the rest, as JAX's
    ``dots_with_no_batch_dims_saveable``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(cfg: ModelConfig, fn):
    """``fn`` (one superblock) as training's backward sees it: kept whole
    (``"none"``), recomputed whole (``"full"``), or recomputed but for its
    weight products (``"dots"``); ``torch.utils.checkpoint`` without
    reentrancy in the last two."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        ctx_fn = functools.partial(ckpt.create_selective_checkpoint_contexts, _save_products)
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, context_fn=ctx_fn)
    if cfg.remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    raise ValueError(f"remat {cfg.remat!r}: expected full, dots or none")


def run_stack(cfg: ModelConfig, blocks: Mapping, x: torch.Tensor, positions, mode: str,
              cache: Optional[Mapping] = None, cache_index=None, valid=None,
              chunk_state: Optional[Mapping] = None, enc_out=None, causal: bool = True,
              index_positions: bool = True, ctx=None):
    """The superblocks over x, in order. Returns (x, new chunk state or
    None, aux: the MoE aux losses summed); the cache's leaves are updated in
    place. In train mode, where a gradient is wanted (grad on, and x or a
    parameter requires it), each superblock goes through ``_remat_wrap``."""
    new_state = {}
    aux = 0.0
    block = _superblock
    if mode == "train" and _grad.wants_grad(x, *_leaves(blocks)):
        block = _remat_wrap(cfg, _superblock)
    for sb in range(cfg.n_superblocks):
        p_sb = _index(blocks, sb)
        c_sb = _index(cache["blocks"], sb) if cache is not None else None
        s_sb = _index(chunk_state["blocks"], sb) if chunk_state is not None else None
        x, s_new, a = block(cfg, p_sb, x, positions, mode, c_sb, cache_index, valid, s_sb,
                            enc_out, causal, index_positions, ctx)
        aux = aux + a
        for key, leaves in s_new.items():
            new_state.setdefault(key, {n: [] for n in leaves})
            for n, t in leaves.items():
                new_state[key][n].append(t)
    if chunk_state is None:
        return x, None, aux
    return x, {"blocks": {key: {n: torch.stack(ts) for n, ts in leaves.items()}
                          for key, leaves in new_state.items()}}, aux


def forward(
    cfg: ModelConfig,
    params: Mapping,
    tokens: Optional[torch.Tensor],
    positions: torch.Tensor,
    mode: str = "train",
    cache: Optional[Mapping] = None,
    cache_index=None,
    n_valid=None,
    chunk_state: Optional[Mapping] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    enc_out: Optional[torch.Tensor] = None,
    index_positions: bool = True,
    ctx=None,
):
    """Returns (hidden (B, S, d) after the final norm, cache), or with
    ``chunk_state`` (chunked prefill) (hidden, cache, new_chunk_state); in
    train mode, which has no cache, (hidden, aux), aux the MoE layers' aux
    losses summed over the stack (an f32 scalar tensor, 0.0 without MoE
    layers). The cache's leaves are
    updated in place. ``inputs_embeds`` (B, S, d) stands
    in for the embedded ``tokens`` (the VLM backbone); ``enc_out`` is the
    encoder's output the cross-attention layers attend over (train and
    prefill). ``index_positions`` False says that ``positions`` may differ
    from ``arange(S)`` in some row (they came from the caller), which keeps
    whole-sequence attention off the index-masked flash kernel.

    ``n_valid`` (B,) marks right-padded prefill: tokens at positions >=
    n_valid[b] are padding and identity for every recurrent state update
    (causal attention keeps them out of every valid row by itself).

    On a mesh (``sharded(ctx)``: training only) the parameters are DTensors
    as ``launch/steps.param_shardings`` lays them out; tokens, positions and
    ``inputs_embeds`` come full or as DTensors and are sharded over the
    batch axes; the embedding is looked up on the vocab shards
    (``embed_sharded``) and the hidden state comes back a DTensor."""
    if sharded(ctx):
        if mode != "train" or cache is not None or n_valid is not None:
            raise NotImplementedError(attn.SERVING_ON_MESH)
        return _forward_sharded(cfg, ctx, params, tokens, positions, inputs_embeds, enc_out, index_positions)
    if inputs_embeds is not None:
        x = inputs_embeds.to(cfg.compute_dtype)
    else:
        x = embed_tokens(cfg, params, tokens)
    valid = None
    if n_valid is not None:
        S = x.shape[1]
        nv = torch.as_tensor(n_valid, dtype=torch.int32, device=x.device).reshape(-1, 1)
        valid = torch.arange(S, dtype=torch.int32, device=x.device)[None, :] < nv
    x, new_state, aux = run_stack(cfg, params["blocks"], x, positions, mode, cache, cache_index, valid,
                                  chunk_state, enc_out, index_positions=index_positions)
    h = apply_norm(cfg, params["final_norm"], x)
    if mode == "train":
        return h, aux
    if chunk_state is None:
        return h, cache
    return h, cache, new_state


def batch_sharded(ctx, x, batch_dim: int = 0):
    """A batch input (tokens, labels, positions, embeddings) sharded over
    the batch axes along ``batch_dim``, the rest replicated: a DTensor
    passes through ``with_sharding_constraint``, a full tensor is cut."""
    spec = [None] * x.ndim
    spec[batch_dim] = ctx.batch_spec_for(x.shape[batch_dim])
    return with_sharding_constraint(x, NamedSharding(ctx.mesh, P(*spec)))


def embed_sharded(cfg: ModelConfig, ctx, table, tokens):
    """The embedding rows of ``tokens`` (a batch-sharded DTensor) from the
    DTensor ``table`` (V, d), gathered over the fsdp axis, each rank looking
    up the ids of its vocab shard and zeros elsewhere (Megatron's
    vocab-parallel embedding): partial over the model axis where the vocab
    is split there, then pinned to the batch axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = ctx.mesh
    table = gather_fsdp(table, ctx)
    tp = mesh.mesh_dim_names.index(ctx.tp_axis)
    vocab = isinstance(table.placements[tp], Shard) and table.placements[tp].dim == 0
    tab_pl = tuple(Shard(0) if i == tp and vocab else Replicate() for i in range(mesh.ndim))
    tok_pl = tuple(tokens.placements)
    out_pl = tuple(Partial() if i == tp and vocab else a for i, a in enumerate(tok_pl))
    tab_grad = tuple(Partial() if isinstance(a, Shard) and i != tp else tab_pl[i] for i, a in enumerate(tok_pl))

    def body(tab, tok):
        tok = tok.long()
        if not vocab:
            return tab[tok].to(cfg.compute_dtype)
        lo = mesh.get_local_rank(tp) * tab.shape[0]
        here = (tok >= lo) & (tok < lo + tab.shape[0])
        rows = tab[(tok - lo).clamp(0, tab.shape[0] - 1)]
        return torch.where(here[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device)).to(
            cfg.compute_dtype)

    x = local_map(body, out_placements=list(out_pl), in_placements=(tab_pl, tok_pl),
                  in_grad_placements=(tab_grad, tok_pl), device_mesh=mesh)(redistribute(table, tab_pl), tokens)
    return _constrain(ctx, x)


def _forward_sharded(cfg: ModelConfig, ctx, params, tokens, positions, inputs_embeds, enc_out,
                     index_positions: bool):
    """``forward`` in train mode on a mesh: returns (hidden, aux)."""
    if enc_out is not None:
        raise NotImplementedError("the encoder-decoder on a multi-device mesh is not ported (ROADMAP Queue 1 "
                                  "item 10)")
    if inputs_embeds is not None:
        x = _constrain(ctx, batch_sharded(ctx, inputs_embeds).to(cfg.compute_dtype))
    else:
        x = embed_sharded(cfg, ctx, params["embedding"], batch_sharded(ctx, tokens))
    positions = batch_sharded(ctx, positions, 1 if cfg.pos == "mrope" else 0)
    x, _, aux = run_stack(cfg, params["blocks"], x, positions, "train", index_positions=index_positions, ctx=ctx)
    return apply_norm(cfg, gather_fsdp(params["final_norm"], ctx), x), aux
