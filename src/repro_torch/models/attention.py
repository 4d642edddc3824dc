"""GQA attention over the paged KV pool: prefill (whole prompt or chunk) and
batched decode, plus the plain query-chunked attention the model runs where
the JAX package runs its jnp path.

The page pools are preallocated tensors updated IN PLACE (the JAX package
donates and returns new buffers instead): every write below mutates the
cache dict's tensors and returns the same dict.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional

import torch

from repro_torch.models.common import ModelConfig, ParamDef
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
# Paged KV cache (serving/paging.py owns the host-side allocator; this is the
# device layout and its access path)
# ---------------------------------------------------------------------------


class PagedIndex(NamedTuple):
    """Decode-time cache address: lengths (B,) int32 tokens already in cache
    per slot (the write position); block_tab (B, P) int32 physical page per
    logical block, unused entries on the reserved null page 0."""

    lengths: torch.Tensor
    block_tab: torch.Tensor


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
    """Shapes and dtypes of one attention layer's shared page pool."""
    if cfg.kv_quant:
        raise NotImplementedError("int8 KV pools are not ported yet (ROADMAP Queue 1 item 1)")
    KV = min(cfg.n_kv_heads, cfg.n_heads)
    shape = (num_pages, KV, page_size, cfg.hd)
    return {"k": TensorSpec(shape, cfg.kv_dtype), "v": TensorSpec(shape, cfg.kv_dtype)}


def paged_cache_kv(cfg: ModelConfig, cache: Mapping, k: torch.Tensor, v: torch.Tensor,
                   idx: PagedIndex) -> Mapping:
    """Scatter one new token's K/V (B, 1, KV, hd) into the page pool at each
    slot's (page, offset), in place. Dead slots (length 0, null table)
    write into the reserved null page. A logical page past the row's end is
    redirected to the null page too; JAX would clamp it onto the row's last
    page (the engine never produces one)."""
    pool_k, pool_v = cache["k"], cache["v"]
    ps, KV = pool_k.shape[2], pool_k.shape[1]
    tab = idx.block_tab.to(torch.long)
    P = tab.shape[1]
    lens = idx.lengths.to(torch.long)
    lp = lens // ps
    pages = torch.where(
        lp < P, tab.gather(1, lp.clamp(max=P - 1)[:, None])[:, 0], torch.zeros_like(lp)
    )
    offs = lens % ps
    kvh = torch.arange(KV, device=pool_k.device)
    at = (pages[:, None], kvh[None, :], offs[:, None])
    pool_k[at] = k[:, 0].to(pool_k.dtype)
    pool_v[at] = v[:, 0].to(pool_v.dtype)
    return cache


def paged_write_prompt(cfg: ModelConfig, cache: Mapping, k: torch.Tensor, v: torch.Tensor,
                       tab_row: torch.Tensor, offset: Optional[int] = None) -> Mapping:
    """Write a whole prefilled prompt, or with ``offset`` one prompt chunk,
    (1, Lp, KV, hd) through one sequence's block-table row into the pool:
    the prefill-write kernel on the card, its plain version on the CPU."""
    from repro_torch.kernels.paged_attention import ops as pa_ops

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
        ck, cv = pa_ops.paged_gather_context(cache["k"], cache["v"], cache_index.tab_row)
        o = context_attention(cfg, q, ck.to(x.dtype), cv.to(x.dtype), positions)
    elif mode == "decode" and isinstance(cache_index, PagedIndex):
        if S != 1:
            raise ValueError(f"paged decode takes one token per slot, got S={S}")
        paged_cache_kv(cfg, cache, k, v, cache_index)
        from repro_torch.kernels.paged_attention import ops as pa_ops

        o = pa_ops.paged_attention(
            q, cache["k"], cache["v"], cache_index.block_tab, cache_index.lengths + 1,
            softcap=cfg.logit_softcap,
        )
    else:
        raise NotImplementedError(
            f"mode={mode!r} with {type(cache_index).__name__} is not ported yet "
            "(the dense cache paths are ROADMAP Queue 1 item 7)"
        )
    out = o.reshape(B, S, H * cfg.hd) @ p["wo"].to(x.dtype)
    return out, cache
