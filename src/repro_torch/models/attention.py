"""GQA attention over a dense KV cache (one stripe of ``cap`` positions per
slot) or the paged KV pool: prefill (whole prompt or chunk) and batched
decode, with f32/bf16 or int8 storage, plus the plain query-chunked
attention the model runs where the JAX package runs its jnp path, and the
encoder-decoder cross-attention (plain torch, as its JAX twin is jnp).

The caches and pools are preallocated tensors updated IN PLACE (the JAX
package donates and returns new buffers instead): every write below mutates
the cache dict's tensors and returns the same dict.
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.kernels import _grad
from repro_torch.models.common import NULL, TP, ModelConfig, ParamDef
from repro_torch.models.quant import dequantize_kv, qeinsum, quantize_kv
from repro_torch.models.rotary import apply_mrope, apply_rope
from repro_torch.sharding.axes import is_dtensor, redistribute

NEG_INF = -1e30
# prefill and decode over a multi-device mesh: the cache shards its sequence
# axis over the model axis (launch/steps.cache_shardings), which needs a
# softmax combine across ranks
SERVING_ON_MESH = ("prefill, decode, chunks and verify on a multi-device mesh wait for the mesh "
                   "path's sharded serving (ROADMAP Queue 1 item 10, sub-item 5: a softmax "
                   "combine over the sequence-sharded cache)")


class TensorSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def attention_defs(cfg: ModelConfig, cross: bool = False) -> dict:
    """Projections of one attention layer; cross-attention has KV = H."""
    H, hd, d = cfg.n_heads, cfg.hd, cfg.d_model
    KV = H if cross else min(cfg.n_kv_heads, H)
    defs = {
        "wq": ParamDef((d, H * hd), (NULL, TP)),
        "wk": ParamDef((d, KV * hd), (NULL, TP)),
        "wv": ParamDef((d, KV * hd), (NULL, TP)),
        "wo": ParamDef((H * hd, d), (TP, NULL)),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H * hd,), (TP,), "zeros")
        defs["bk"] = ParamDef((KV * hd,), (TP,), "zeros")
        defs["bv"] = ParamDef((KV * hd,), (TP,), "zeros")
    return defs


# ---------------------------------------------------------------------------
# Dense KV cache: one (cap, KV, hd) stripe per slot
# ---------------------------------------------------------------------------


def kv_cache_defs(cfg: ModelConfig, batch: int, cap: int) -> dict:
    """Shapes and dtypes of one attention layer's dense KV cache; with
    ``cfg.kv_quant`` int8 values plus a bf16 scale per (token, head)."""
    KV = min(cfg.n_kv_heads, cfg.n_heads)
    shape = (batch, cap, KV, cfg.hd)
    if cfg.kv_quant:
        sshape = (batch, cap, KV, 1)
        return {"k": TensorSpec(shape, torch.int8), "v": TensorSpec(shape, torch.int8),
                "k_scale": TensorSpec(sshape, torch.bfloat16),
                "v_scale": TensorSpec(sshape, torch.bfloat16)}
    return {"k": TensorSpec(shape, cfg.kv_dtype), "v": TensorSpec(shape, cfg.kv_dtype)}


class ChunkPrefillIndex(NamedTuple):
    """Chunked (resumable) dense prefill of one slot's stripe: chunk token t
    sits at absolute position offset + t; the chunk's K/V is written at
    ``offset`` and its queries attend over the whole stripe by absolute
    position."""

    offset: int


def _dus(buf: torch.Tensor, upd: torch.Tensor, index) -> None:
    """Write upd (B, S, ...) into buf (B, T, ...) at sequence position
    ``index``, IN PLACE: a scalar, or (B,) per slot. The start is clamped
    into [0, T - S], as ``dynamic_update_slice`` clamps it in the JAX
    package: a slot at T writes its one decode token at T - 1 (the engine
    never asks for that: its stop condition ends a sequence at T - 1)."""
    B, S = upd.shape[0], upd.shape[1]
    T = buf.shape[1]
    upd = upd.to(buf.dtype)
    if isinstance(index, torch.Tensor) and index.dim() == 1:
        start = index.to(device=buf.device, dtype=torch.long).clamp(0, T - S)
        pos = start[:, None] + torch.arange(S, device=buf.device)[None, :]
        buf[torch.arange(B, device=buf.device)[:, None], pos] = upd
    else:
        start = min(max(int(index), 0), T - S)
        buf[:, start:start + S] = upd


def cache_kv(cfg: ModelConfig, cache: Mapping, k: torch.Tensor, v: torch.Tensor, index) -> Mapping:
    """Write k/v (B, S_new, KV, hd) into the dense cache at ``index`` (see
    ``_dus``), quantized when the cache is int8. Returns the same dict."""
    if cfg.kv_quant:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        for name, upd in (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs)):
            _dus(cache[name], upd, index)
    else:
        _dus(cache["k"], k, index)
        _dus(cache["v"], v, index)
    return cache


def read_kv(cfg: ModelConfig, cache: Mapping, dtype):
    """The cache's K/V in ``dtype``: the stored tensors themselves when they
    already have it (no copy), dequantized when the cache is int8."""
    if cfg.kv_quant:
        return (dequantize_kv(cache["k"], cache["k_scale"], dtype),
                dequantize_kv(cache["v"], cache["v_scale"], dtype))
    return cache["k"].to(dtype), cache["v"].to(dtype)


# ---------------------------------------------------------------------------
# Paged KV cache (serving/paging.py owns the host-side allocator; this is the
# device layout and its access path)
# ---------------------------------------------------------------------------


class PagedIndex(NamedTuple):
    """Decode-time cache address: lengths (B,) int32 tokens already in cache
    per slot (the write position); block_tab (B, P) int32 physical page per
    logical block, unused entries on the reserved null page 0. With ``l2``
    (chained two-level tables) block_tab is the (B, W1) first-level row of
    table-page ids into the (n_rows, tpp) second-level pool, and logical
    block i resolves to ``l2[block_tab[b, i // tpp], i % tpp]``."""

    lengths: torch.Tensor
    block_tab: torch.Tensor
    l2: Optional[torch.Tensor] = None


class PagedPrefillIndex(NamedTuple):
    """Prefill-time cache address of one sequence: token t scatters to
    (tab_row[t // ps], t % ps); bucket padding maps to the null page 0.
    slot is the decode slot (owner of recurrent state; unused here)."""

    tab_row: torch.Tensor
    slot: int


class PagedChunkPrefillIndex(NamedTuple):
    """Chunked (resumable) paged prefill of one sequence: the chunk's K/V
    scatters through the row shifted by offset // ps pages (offset a page
    multiple), and its queries attend over the gathered context view masked
    by absolute position."""

    tab_row: torch.Tensor
    slot: int
    offset: int


class PagedVerifyIndex(NamedTuple):
    """Speculative verify pass over one paged sequence: verify token t (the
    pending last token, then the proposal) scatters to absolute position
    offset + t through the row at an ARBITRARY (mid-page) offset, and the
    queries attend over the gathered context view masked by absolute
    position, as a prefill chunk does. Rejected positions stay in the pool
    as garbage until the engine rolls its write-head back."""

    tab_row: torch.Tensor
    offset: int


def paged_kv_pool_defs(cfg: ModelConfig, num_pages: int, page_size: int) -> dict:
    """Shapes and dtypes of one attention layer's shared page pool; with
    ``cfg.kv_quant`` int8 values plus a bf16 scale per (page slot, head).
    Every access path dispatches on the presence of the ``k_scale`` leaf."""
    KV = min(cfg.n_kv_heads, cfg.n_heads)
    shape = (num_pages, KV, page_size, cfg.hd)
    if cfg.kv_quant:
        sshape = (num_pages, KV, page_size, 1)
        return {"k": TensorSpec(shape, torch.int8), "v": TensorSpec(shape, torch.int8),
                "k_scale": TensorSpec(sshape, torch.bfloat16),
                "v_scale": TensorSpec(sshape, torch.bfloat16)}
    return {"k": TensorSpec(shape, cfg.kv_dtype), "v": TensorSpec(shape, cfg.kv_dtype)}


def paged_cache_kv(cfg: ModelConfig, cache: Mapping, k: torch.Tensor, v: torch.Tensor,
                   idx: PagedIndex) -> Mapping:
    """Scatter one new token's K/V (B, 1, KV, hd) into the page pool at each
    slot's (page, offset), in place, quantized into an int8 pool; with
    chained tables the logical page resolves through the second level. Dead
    slots (length 0, null table) write into the reserved null page. A
    logical page past the row's end is redirected to the null page too; JAX
    would clamp it onto the row's last page (the engine never produces
    one)."""
    from repro_torch.kernels.paged_attention.ref import chain_rows

    pool_k = cache["k"]
    ps, KV = pool_k.shape[2], pool_k.shape[1]
    tab = idx.block_tab if idx.l2 is None else chain_rows(idx.block_tab, idx.l2)
    tab = tab.to(torch.long)
    P = tab.shape[1]
    lens = idx.lengths.to(torch.long)
    lp = lens // ps
    pages = torch.where(
        lp < P, tab.gather(1, lp.clamp(max=P - 1)[:, None])[:, 0], torch.zeros_like(lp)
    )
    offs = lens % ps
    kvh = torch.arange(KV, device=pool_k.device)
    at = (pages[:, None], kvh[None, :], offs[:, None])
    if "k_scale" in cache:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        for name, upd in (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs)):
            cache[name][at] = upd[:, 0]
    else:
        cache["k"][at] = k[:, 0].to(pool_k.dtype)
        cache["v"][at] = v[:, 0].to(cache["v"].dtype)
    return cache


def paged_write_prompt(cfg: ModelConfig, cache: Mapping, k: torch.Tensor, v: torch.Tensor,
                       tab_row: torch.Tensor, offset: Optional[int] = None) -> Mapping:
    """Write a whole prefilled prompt, or with ``offset`` one prompt chunk,
    (1, Lp, KV, hd) through one sequence's block-table row into the pool:
    the prefill-write kernel (quantizing into an int8 pool) on the card, its
    plain version on the CPU."""
    from repro_torch.kernels.paged_attention import ops as pa_ops

    if "k_scale" in cache:
        pa_ops.paged_prefill_write_quant(cache["k"], cache["v"], cache["k_scale"], cache["v_scale"],
                                         k, v, tab_row, offset=offset)
    else:
        pa_ops.paged_prefill_write(cache["k"], cache["v"], k, v, tab_row, offset=offset)
    return cache


# ---------------------------------------------------------------------------
# Core attention math (grouped-query, f32 softmax)
# ---------------------------------------------------------------------------


def _group(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, KV, G, hd)."""
    B, S, H, hd = q.shape
    return q.reshape(B, S, kv_heads, H // kv_heads, hd)


def _attend_block(q, k, v, mask, softcap: float = 0.0, scores_bf16: bool = False):
    """q: (B,Cq,KV,G,hd); k/v: (B,T,KV,hd); mask: (B,1,1,Cq,T) bool. Scores
    and softmax in f32; the probabilities meet V in q's dtype. With
    ``scores_bf16`` (``cfg.attn_scores_bf16``) the scores are materialised
    in bf16, as the reference's ``preferred_element_type`` gives them, and
    the softmax's exponent and sums stay f32."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqkgh,btkh->bkgqt", q.float(), k.float())
    if scores_bf16:
        s = s.to(torch.bfloat16)
        scale = s.new_tensor(scale)               # rounded to bf16, as the reference's
    s = s * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp((s - m).float())
    p = p / torch.sum(p, dim=-1, keepdim=True)
    return torch.einsum("bkgqt,btkh->bqkgh", p.to(q.dtype), v.to(q.dtype))


def chunked_attention(
    cfg: ModelConfig,
    q: torch.Tensor,           # (B, S, H, hd)
    k: torch.Tensor,           # (B, T, KV, hd)
    v: torch.Tensor,
    pos_q: torch.Tensor,       # (B, S) int
    pos_k: torch.Tensor,       # (B, T) int
    causal: bool = True,
    allow_kernel: bool = True,
) -> torch.Tensor:
    """Query-chunked attention; returns (B, S, H, hd). A square causal
    attention with no softcap goes to the flash kernel (the plain version on
    the CPU), which masks by index — where the JAX package's ``use_pallas``
    path takes ``flash_attention_bhsd``, except that a softcap keeps the
    plain path here, since the kernel has none. ``cfg.attn_scores_bf16``
    applies to the plain path alone: the flash kernel keeps its scores in
    f32, as the JAX package's Pallas kernel ignores the knob.
    ``allow_kernel=False`` forces
    the plain path, masked by ``pos_q >= pos_k``: a chunk of queries over a
    longer context, or positions that are not ``arange(S)`` in every row
    (an image prompt's temporal stream repeats an index)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if causal and S > 1 and allow_kernel and S == k.shape[1] and not cfg.logit_softcap:
        from repro_torch.kernels.flash_attention import ops as fa_ops

        return fa_ops.flash_attention(q, k, v)
    qg = _group(q, KV)
    chunk = min(cfg.attn_chunk, S)
    if S % chunk != 0:
        chunk = S  # irregular small shapes: single block
    # several chunks under a gradient: each recomputes its scores in the
    # backward, as the reference's jax.checkpoint'd scan body does
    recompute = chunk < S and _grad.wants_grad(q, k, v)
    outs = []
    for c0 in range(0, S, chunk):
        pb = pos_q[:, c0:c0 + chunk]
        if causal:
            mask = pb[:, None, None, :, None] >= pos_k[:, None, None, None, :]
        else:
            mask = torch.ones((B, 1, 1, pb.shape[1], k.shape[1]), dtype=torch.bool, device=q.device)
        if recompute:
            outs.append(ckpt.checkpoint(_attend_block, qg[:, c0:c0 + chunk], k, v, mask, cfg.logit_softcap,
                                        cfg.attn_scores_bf16, use_reentrant=False))
        else:
            outs.append(_attend_block(qg[:, c0:c0 + chunk], k, v, mask, cfg.logit_softcap,
                                      cfg.attn_scores_bf16))
    return torch.cat(outs, dim=1).reshape(B, S, H, hd)


def context_attention(cfg: ModelConfig, q, k, v, pos_q) -> torch.Tensor:
    """Chunked-prefill attention: a chunk of queries (B, Cq, H, hd) over the
    whole cached context (B, T, KV, hd), masked causally by ABSOLUTE position
    — which also hides unwritten cache positions and tail-chunk padding."""
    B, T = k.shape[0], k.shape[1]
    pos_k = torch.arange(T, dtype=torch.int32, device=k.device)[None, :].expand(B, T)
    return chunked_attention(cfg, q, k, v, pos_q, pos_k, causal=True, allow_kernel=False)


def decode_attention_quant(cfg: ModelConfig, q: torch.Tensor, cache: Mapping, cache_len) -> torch.Tensor:
    """int8-cache decode without a dequantized copy of the cache: the per
    (token, head) scales fold into the scores (k) and the probabilities (v),
    which meet V in bf16, as in the JAX package (plain PyTorch there too:
    no Pallas kernel computes it). q: (B, S, H, hd)."""
    B, S, H, hd = q.shape
    KV = cache["k"].shape[2]
    T = cache["k"].shape[1]
    qg = _group(q, KV)                                       # (B,S,KV,G,hd)
    s = torch.einsum("bqkgh,btkh->bkgqt", qg.float(), cache["k"].float())
    k_sc = cache["k_scale"].float()[..., 0]                  # (B,T,KV)
    s = s * (1.0 / hd ** 0.5) * k_sc.permute(0, 2, 1)[:, :, None, None, :]
    cl = torch.as_tensor(cache_len, device=q.device)
    cl = cl.reshape(-1, 1, 1, 1, 1) if cl.dim() == 1 else cl
    mask = torch.arange(T, device=q.device)[None, None, None, None, :] < cl
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    v_sc = cache["v_scale"].float()[..., 0]
    p = p * v_sc.permute(0, 2, 1)[:, :, None, None, :]
    o = torch.einsum("bkgqt,btkh->bqkgh", p.to(torch.bfloat16).float(), cache["v"].float())
    return o.to(q.dtype).reshape(B, S, H, hd)


def decode_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_len) -> torch.Tensor:
    """q (B, 1, H, hd) over the dense cache k/v (B, T, KV, hd) as stored, the
    first ``cache_len`` (scalar or (B,)) positions valid: the decode kernel
    on the card, its plain version on the CPU. The softcap is applied, as
    the JAX package's jnp path applies it (its Pallas kernel drops it)."""
    from repro_torch.kernels.decode_attention import ops as da_ops

    return da_ops.decode_attention(q, k, v, cache_len, softcap=cfg.logit_softcap)


# ---------------------------------------------------------------------------
# Full attention sub-layer (projection + rope + attend + out-projection)
# ---------------------------------------------------------------------------


def _apply_pos(cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    if cfg.pos == "rope":
        return apply_rope(x, positions, cfg.rope_theta)
    if cfg.pos == "mrope":
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return x


def _heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, S, n * hd) -> (B, S, n, hd). A DTensor whose shards of the last
    dim would cut through a head (n not a multiple of the shard count) is
    first gathered over the axes that shard it, so that every rank's view
    holds whole heads."""
    B, S = t.shape[:2]
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard

        pl = list(t.placements)
        cut = [i for i, a in enumerate(pl) if isinstance(a, Shard) and a.dim == t.ndim - 1]
        if n % math.prod(t.device_mesh.size(i) for i in cut):
            for i in cut:
                pl[i] = Replicate()
            t = t.redistribute(t.device_mesh, pl)
    return t.reshape(B, S, n, hd)


def _project_qkv(cfg: ModelConfig, p: Mapping, x: torch.Tensor, n_heads: int):
    H = n_heads
    KV = min(cfg.n_kv_heads, H)
    hd = cfg.hd
    q = qeinsum(x, p["wq"])
    k = qeinsum(x, p["wk"])
    v = qeinsum(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return _heads(q, H, hd), _heads(k, KV, hd), _heads(v, KV, hd)


def _attend_sharded(cfg: ModelConfig, q, k, v, positions, causal: bool, index_positions: bool):
    """Position encoding and attention of DTensor q (B, S, H, hd), k/v (B, S,
    KV, hd) on each rank's block (``local_map``): batch as the projections
    split it, q's heads as they split them. K/V heads that are split as q's
    are (KV a multiple of the model shards) give each rank the heads its
    query heads use; otherwise they come whole to every rank, which takes
    the heads its query heads read, and their gradient is partial over the
    model axis. The kernels launch on the blocks: flash attention where the
    whole-sequence path takes it, as ``chunked_attention`` chooses."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    H, KV = q.shape[2], k.shape[2]
    qp = tuple(q.placements)
    heads = [i for i, a in enumerate(qp) if isinstance(a, Shard) and a.dim == 2]
    k_heads = [i for i, a in enumerate(k.placements) if isinstance(a, Shard) and a.dim == 2]
    if heads and k_heads == heads:
        kp, pick = tuple(k.placements), False
    else:
        kp = tuple(Replicate() if i in k_heads else a for i, a in enumerate(k.placements))
        pick = bool(heads)
    k, v = redistribute(k, kp), redistribute(v, kp)
    batch = tuple(Shard(1 if cfg.pos == "mrope" else 0) if isinstance(a, Shard) and a.dim == 0 else Replicate()
                  for a in qp)
    positions = redistribute(positions, batch) if is_dtensor(positions) else positions
    kv_grad = tuple(Partial() if pick and i in heads else a for i, a in enumerate(kp))
    G = H // KV

    def body(ql, kl, vl, pos):
        if pick:
            Hl = ql.shape[2]
            lo = sum(mesh.get_local_rank(i) * math.prod(mesh.size(j) for j in heads[n + 1:])
                     for n, i in enumerate(heads)) * Hl
            if Hl % G and G % Hl:
                raise ValueError(f"{Hl} query heads a rank do not hold whole groups of {G} or lie in one")
            kl, vl = kl[:, :, lo // G:(lo + Hl - 1) // G + 1], vl[:, :, lo // G:(lo + Hl - 1) // G + 1]
        pos_t = pos[0] if cfg.pos == "mrope" else pos
        ql, kl = _apply_pos(cfg, ql, pos), _apply_pos(cfg, kl, pos)
        return chunked_attention(cfg, ql, kl, vl, pos_t, pos_t, causal=causal, allow_kernel=index_positions)

    return local_map(body, out_placements=list(qp), in_placements=(qp, kp, kp, batch),
                     in_grad_placements=(qp, kv_grad, kv_grad, batch), device_mesh=mesh)(q, k, v, positions)


def self_attention(
    cfg: ModelConfig,
    p: Mapping,
    x: torch.Tensor,
    positions: torch.Tensor,
    mode: str,                      # train | prefill | decode
    cache: Optional[Mapping] = None,
    cache_index=None,
    causal: bool = True,
    index_positions: bool = True,
):
    """Returns (out, cache); the cache's pools are updated in place.
    positions: (B, S), or (3, B, S) under M-RoPE, whose temporal stream
    (the first) drives the masks, as in the JAX package. The caller sets
    ``index_positions`` False when a whole-sequence pass's positions may
    differ from ``arange(S)`` in some row: the flash kernel, which masks by
    index, is then left for the plain path. ``causal=False`` (the encoder)
    attends everywhere."""
    H = cfg.n_heads
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, H)
    if is_dtensor(q):
        if mode != "train":
            raise NotImplementedError(SERVING_ON_MESH)
        o = _attend_sharded(cfg, q, k, v, positions, causal, index_positions)
        return qeinsum(o.reshape(B, S, H * cfg.hd), p["wo"]), cache
    pos_t = positions[0] if cfg.pos == "mrope" else positions     # temporal stream for masks
    q = _apply_pos(cfg, q, positions)
    k = _apply_pos(cfg, k, positions)

    if mode == "train":
        o = chunked_attention(cfg, q, k, v, pos_t, pos_t, causal=causal, allow_kernel=index_positions)
    elif mode == "prefill" and isinstance(cache_index, PagedPrefillIndex):
        # truly paged prefill: K/V scatter straight through the block table
        paged_write_prompt(cfg, cache, k, v, cache_index.tab_row)
        o = chunked_attention(cfg, q, k, v, pos_t, pos_t, causal=causal, allow_kernel=index_positions)
    elif mode == "prefill" and isinstance(cache_index, PagedChunkPrefillIndex):
        # chunked paged prefill: scatter this chunk at its page-aligned
        # offset, then attend over the dense gathered context view
        from repro_torch.kernels.paged_attention import ops as pa_ops

        paged_write_prompt(cfg, cache, k, v, cache_index.tab_row, offset=cache_index.offset)
        ck, cv = pa_ops.paged_gather_context(cache["k"], cache["v"], cache_index.tab_row,
                                             pool_ks=cache.get("k_scale"),
                                             pool_vs=cache.get("v_scale"))
        o = context_attention(cfg, q, ck.to(x.dtype), cv.to(x.dtype), pos_t)
    elif mode == "prefill" and isinstance(cache_index, PagedVerifyIndex):
        # speculative verify: scatter the k + 1 verify tokens at a mid-page
        # offset, then attend over the gathered context by absolute position
        from repro_torch.kernels.paged_attention import ops as pa_ops

        if "k_scale" in cache:
            pa_ops.paged_verify_write_quant(cache["k"], cache["v"], cache["k_scale"], cache["v_scale"],
                                            k, v, cache_index.tab_row, cache_index.offset)
        else:
            pa_ops.paged_verify_write(cache["k"], cache["v"], k, v, cache_index.tab_row,
                                      cache_index.offset)
        ck, cv = pa_ops.paged_gather_context(cache["k"], cache["v"], cache_index.tab_row,
                                             pool_ks=cache.get("k_scale"),
                                             pool_vs=cache.get("v_scale"))
        o = context_attention(cfg, q, ck.to(x.dtype), cv.to(x.dtype), pos_t)
    elif mode == "prefill" and isinstance(cache_index, ChunkPrefillIndex):
        # chunked dense prefill: write this chunk into the slot's stripe at
        # ``offset`` and attend over the whole stripe by absolute position
        cache_kv(cfg, cache, k, v, cache_index.offset)
        ck, cv = read_kv(cfg, cache, x.dtype)
        o = context_attention(cfg, q, ck, cv, pos_t)
    elif mode == "prefill":
        # whole-prompt dense prefill into the stripe at 0 (or the given index)
        cache_kv(cfg, cache, k, v, 0 if cache_index is None else cache_index)
        o = chunked_attention(cfg, q, k, v, pos_t, pos_t, causal=causal, allow_kernel=index_positions)
    elif mode == "decode" and isinstance(cache_index, PagedIndex):
        if S != 1:
            raise ValueError(f"paged decode takes one token per slot, got S={S}")
        paged_cache_kv(cfg, cache, k, v, cache_index)
        from repro_torch.kernels.paged_attention import ops as pa_ops

        o = pa_ops.paged_attention(
            q, cache["k"], cache["v"], cache_index.block_tab, cache_index.lengths + 1,
            softcap=cfg.logit_softcap, pool_ks=cache.get("k_scale"),
            pool_vs=cache.get("v_scale"), l2_tab=cache_index.l2,
        )
    elif mode == "decode":
        # dense decode: cache_index is the write position, scalar or (B,)
        if S != 1 or cache_index is None:
            raise ValueError(f"dense decode takes one token per slot and a cache index, got S={S}")
        cache_kv(cfg, cache, k, v, cache_index)
        if cfg.kv_quant:
            o = decode_attention_quant(cfg, q, cache, cache_index + S)
        else:
            ck, cv = read_kv(cfg, cache, x.dtype)
            o = decode_attention(cfg, q, ck, cv, cache_index + S)
    else:
        raise ValueError(f"mode={mode!r}")
    out = qeinsum(o.reshape(B, S, H * cfg.hd), p["wo"])
    return out, cache


def cross_attention(cfg: ModelConfig, p: Mapping, x: torch.Tensor, kv: Mapping) -> torch.Tensor:
    """Encoder-decoder cross-attention of x (B, S, d) over the encoder's
    precomputed K/V {"k", "v"} (B, T, H, hd): every query sees every frame
    (the plain path; the flash kernel is causal)."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    q = qeinsum(x, p["wq"]).reshape(B, S, H, hd)
    k, v = kv["k"].to(x.dtype), kv["v"].to(x.dtype)
    pos_q = torch.zeros((B, S), dtype=torch.int32, device=x.device)
    pos_k = torch.zeros((B, k.shape[1]), dtype=torch.int32, device=x.device)
    o = chunked_attention(cfg, q, k, v, pos_q, pos_k, causal=False)
    return qeinsum(o.reshape(B, S, H * hd), p["wo"])


def cross_kv(cfg: ModelConfig, p: Mapping, enc_out: torch.Tensor) -> dict:
    """The encoder output (B, T, d) projected once to cross-attention K/V
    {"k", "v"} (B, T, H, hd)."""
    B, T, _ = enc_out.shape
    H, hd = cfg.n_heads, cfg.hd
    return {"k": qeinsum(enc_out, p["wk"]).reshape(B, T, H, hd),
            "v": qeinsum(enc_out, p["wv"]).reshape(B, T, H, hd)}
