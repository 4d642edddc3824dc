"""GQA attention over a dense KV cache (one stripe of ``cap`` positions per
slot) or the paged KV pool: prefill (whole prompt or chunk) and batched
decode, with f32/bf16 or int8 storage, plus the plain query-chunked
attention the model runs where the JAX package runs its jnp path.

The caches and pools are preallocated tensors updated IN PLACE (the JAX
package donates and returns new buffers instead): every write below mutates
the cache dict's tensors and returns the same dict.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import torch

from repro_torch.models.common import ModelConfig, ParamDef
from repro_torch.models.quant import dequantize_kv, quantize_kv
from repro_torch.models.rotary import apply_rope

NEG_INF = -1e30


class TensorSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def attention_defs(cfg: ModelConfig) -> dict:
    H, KV, hd, d = cfg.n_heads, min(cfg.n_kv_heads, cfg.n_heads), cfg.hd, cfg.d_model
    if cfg.qkv_bias:
        raise NotImplementedError("qkv_bias is not ported yet (ROADMAP Queue 1 item 8)")
    return {
        "wq": ParamDef((d, H * hd)),
        "wk": ParamDef((d, KV * hd)),
        "wv": ParamDef((d, KV * hd)),
        "wo": ParamDef((H * hd, d)),
    }


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


def _attend_block(q, k, v, mask, softcap: float = 0.0):
    """q: (B,Cq,KV,G,hd); k/v: (B,T,KV,hd); mask: (B,1,1,Cq,T) bool. Scores
    and softmax in f32; the probabilities meet V in q's dtype."""
    hd = q.shape[-1]
    s = torch.einsum("bqkgh,btkh->bkgqt", q.float(), k.float())
    s = s * (1.0 / (hd ** 0.5))
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
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
    attention with standard positions and no softcap goes to the flash
    kernel (the plain version on the CPU) — where the JAX package's
    ``use_pallas`` path takes ``flash_attention_bhsd``, except that a softcap
    keeps the plain path here, since the kernel has none. ``allow_kernel=False``
    forces the plain path (a chunk of queries over a longer context)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if causal and S > 1 and allow_kernel and S == k.shape[1] and not cfg.logit_softcap:
        from repro_torch.kernels.flash_attention import ops as fa_ops

        return fa_ops.flash_attention(q, k, v)
    qg = _group(q, KV)
    chunk = min(cfg.attn_chunk, S)
    if S % chunk != 0:
        chunk = S  # irregular small shapes: single block
    outs = []
    for c0 in range(0, S, chunk):
        pb = pos_q[:, c0:c0 + chunk]
        if causal:
            mask = pb[:, None, None, :, None] >= pos_k[:, None, None, None, :]
        else:
            mask = torch.ones((B, 1, 1, pb.shape[1], k.shape[1]), dtype=torch.bool, device=q.device)
        outs.append(_attend_block(qg[:, c0:c0 + chunk], k, v, mask, cfg.logit_softcap))
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


def _project_qkv(cfg: ModelConfig, p: Mapping, x: torch.Tensor, n_heads: int):
    B, S, _ = x.shape
    H = n_heads
    KV = min(cfg.n_kv_heads, H)
    hd = cfg.hd
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    return q.reshape(B, S, H, hd), k.reshape(B, S, KV, hd), v.reshape(B, S, KV, hd)


def self_attention(
    cfg: ModelConfig,
    p: Mapping,
    x: torch.Tensor,
    positions: torch.Tensor,
    mode: str,                      # train | prefill | decode
    cache: Optional[Mapping] = None,
    cache_index=None,
):
    """Returns (out, cache); the cache's pools are updated in place."""
    H = cfg.n_heads
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, H)
    if cfg.pos != "rope":
        raise NotImplementedError(f"pos={cfg.pos!r} is not ported yet")
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if mode == "train":
        o = chunked_attention(cfg, q, k, v, positions, positions)
    elif mode == "prefill" and isinstance(cache_index, PagedPrefillIndex):
        # truly paged prefill: K/V scatter straight through the block table
        paged_write_prompt(cfg, cache, k, v, cache_index.tab_row)
        o = chunked_attention(cfg, q, k, v, positions, positions)
    elif mode == "prefill" and isinstance(cache_index, PagedChunkPrefillIndex):
        # chunked paged prefill: scatter this chunk at its page-aligned
        # offset, then attend over the dense gathered context view
        from repro_torch.kernels.paged_attention import ops as pa_ops

        paged_write_prompt(cfg, cache, k, v, cache_index.tab_row, offset=cache_index.offset)
        ck, cv = pa_ops.paged_gather_context(cache["k"], cache["v"], cache_index.tab_row,
                                             pool_ks=cache.get("k_scale"),
                                             pool_vs=cache.get("v_scale"))
        o = context_attention(cfg, q, ck.to(x.dtype), cv.to(x.dtype), positions)
    elif mode == "prefill" and isinstance(cache_index, ChunkPrefillIndex):
        # chunked dense prefill: write this chunk into the slot's stripe at
        # ``offset`` and attend over the whole stripe by absolute position
        cache_kv(cfg, cache, k, v, cache_index.offset)
        ck, cv = read_kv(cfg, cache, x.dtype)
        o = context_attention(cfg, q, ck, cv, positions)
    elif mode == "prefill":
        # whole-prompt dense prefill into the stripe at 0 (or the given index)
        cache_kv(cfg, cache, k, v, 0 if cache_index is None else cache_index)
        o = chunked_attention(cfg, q, k, v, positions, positions)
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
    out = o.reshape(B, S, H * cfg.hd) @ p["wo"].to(x.dtype)
    return out, cache
