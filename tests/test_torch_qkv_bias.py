"""The qkv_bias family in the port (glm4-9b and qwen1.5-32b) against the JAX
package on the CPU, and the two decode kernels' plain versions at G > 8.

Models: glm4-9b SMOKE (G = 2), a G = 16 variant of it (16 query heads over
one KV head) and qwen1.5-32b SMOKE (G = 1), in f32 on the same weights,
bridged with ``params_from_jax``. JAX inits the three biases to zeros, which
would make parity vacuous, so every test draws them from a seeded standard
normal into both trees. Held to f32 2e-5: logits of the dense whole-prompt
and chunked prefill, decode and verify, and of the paged prefill, chunked
prefill, batched decode (f32 flat and int8 chained pools) and verify.
Greedy streams of the port's dense and paged engines (bf16 and int8 pools)
equal the JAX engines'.

Kernels: ``paged_attention_ref`` on all four legs and ``decode_attention_ref``
at G 9, 12 and 16 against the Pallas kernels in interpret mode; the split
planners counting head groups; a plain emulation of the CUDA kernels' head
groups (grid index, the per-split partial layout, the combine) against the
plain versions, at the group width the wrappers plan for."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.kernels.decode_attention.kernel import decode_attention_grouped  # noqa: E402
from repro.kernels.paged_attention.kernel import paged_attention_grouped  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.engine import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serving.engine import PagedEngineConfig as JPagedEngineConfig  # noqa: E402
from repro.serving.engine import PagedInferenceEngine as JPagedInferenceEngine  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import chain_rows, gather_kv, paged_attention_ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402
from repro_torch.models.quant import dequantize_kv  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    EngineConfig,
    InferenceEngine,
    PagedEngineConfig,
    PagedInferenceEngine,
)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}      # tests/test_kernels.py:17
NP, PS, P = 16, 8, 6
LOG2E = 1.4426950408889634
# (registry arch, the SMOKE config's changes): G = 2, 16 and 1
ARCHS = {"glm4-9b": ("glm4-9b", {}),
         "glm4-9b-G16": ("glm4-9b", {"n_heads": 16, "n_kv_heads": 1, "d_model": 256}),
         "qwen1.5-32b": ("qwen1.5-32b", {})}


@pytest.fixture(scope="module", params=list(ARCHS))
def weights(request):
    """JAX and port configs and weights of one arch, the biases drawn from
    a seeded standard normal into both trees."""
    arch, over = ARCHS[request.param]
    jcfg = j_get_config(arch, smoke=True).replace(attn_chunk=64, **over)
    tcfg = get_config(arch, smoke=True).replace(attn_chunk=64, **over)
    tree = jax.tree.map(np.asarray, j_get_model(jcfg).init(jax.random.PRNGKey(0)))
    mixer = tree["blocks"]["l0_mixer"]
    rng = np.random.default_rng(5)
    for name in ("bq", "bk", "bv"):
        assert not mixer[name].any()                      # JAX's init: zeros
        mixer[name] = rng.standard_normal(mixer[name].shape).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_jax(tree, tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _logits_j(jparams, h):
    return np.asarray(jnp.einsum("bsd,dv->bsv", h, jparams["unembed"]), np.float32)


def _logits_t(tparams, h):
    return (h @ tparams["unembed"]).float().numpy()


def _close(jh, th, jparams, tparams, n=None):
    d = np.max(np.abs(_logits_j(jparams, jh)[:, :n] - _logits_t(tparams, th)[:, :n]))
    assert d < TOL["float32"], d


def test_bias_leaves_in_defs_and_bridge(weights):
    """The three bias leaves, (n_layers, H hd) and (n_layers, KV hd), land
    bit for bit through the bridge; a tree without them is refused."""
    jcfg, tcfg, jparams, tparams = weights
    mixer = tparams["blocks"]["l0_mixer"]
    H, KV, hd, L = tcfg.n_heads, tcfg.n_kv_heads, tcfg.hd, tcfg.n_layers
    assert mixer["bq"].shape == (L, H * hd)
    assert mixer["bk"].shape == mixer["bv"].shape == (L, KV * hd)
    for name in ("bq", "bk", "bv"):
        np.testing.assert_array_equal(mixer[name].numpy(), np.asarray(jparams["blocks"]["l0_mixer"][name]))
        assert float(mixer[name].abs().max()) > 0
    tree = jax.tree.map(np.asarray, jparams)
    del tree["blocks"]["l0_mixer"]["bq"]
    with pytest.raises(KeyError):
        params_from_jax(tree, tcfg, "cpu")


def test_dense_prefill_chunk_decode_and_verify_logits_match_jax(weights):
    """Slot 0 prefilled whole (11 tokens padded to 16), slot 1 in chunks of
    8 at offsets 0, 8, 16, slot 2 dead; two batched decode steps; then a
    5-token verify of slot 1 at offset 22 (mid-bucket). Logits within f32
    2e-5 of the JAX model's at every step."""
    jcfg, tcfg, jparams, tparams = weights
    rng = np.random.default_rng(3)
    B, CAP = 3, 32
    jcache = jtf.init_cache(jcfg, B, CAP)
    tcache = get_model(tcfg).init_cache(B, CAP, "cpu")

    def view(slot):
        return {"blocks": {k: {n: t[:, slot:slot + 1] for n, t in leaves.items()}
                           for k, leaves in tcache["blocks"].items()}}

    def put(slot, mini):
        return jax.tree.map(lambda full, part: jax.lax.dynamic_update_slice_in_dim(
            full, part.astype(full.dtype), slot, axis=1), jcache, mini)

    def mini(slot):
        return jax.tree.map(lambda full: jax.lax.dynamic_slice_in_dim(full, slot, 1, axis=1), jcache)

    toks = np.zeros((1, 16), np.int32)
    toks[0, :11] = rng.integers(1, tcfg.vocab_size, 11)
    pos = np.arange(16, dtype=np.int32)[None]
    jh, m, _ = jtf.forward(jcfg, None, jparams, tokens=jnp.asarray(toks), positions=jnp.asarray(pos),
                           mode="prefill", cache=jtf.init_cache(jcfg, 1, CAP), cache_index=0)
    jcache = put(0, m)
    th, _ = ttf.forward(tcfg, tparams, torch.from_numpy(toks).long(), torch.from_numpy(pos),
                        mode="prefill", cache=view(0), cache_index=0)
    _close(jh, th, jparams, tparams, 11)
    last0 = int(np.argmax(_logits_t(tparams, th)[0, 10]))

    b = rng.integers(1, tcfg.vocab_size, 20)
    for off in (0, 8, 16):
        piece = b[off:off + 8]
        toks = np.zeros((1, 8), np.int32)
        toks[0, :len(piece)] = piece
        pos = np.arange(off, off + 8, dtype=np.int32)[None]
        jh, m, _, _ = jtf.forward(jcfg, None, jparams, tokens=jnp.asarray(toks),
                                  positions=jnp.asarray(pos), mode="prefill", cache=mini(1),
                                  chunk_state=jtf.init_chunk_state(jcfg),
                                  cache_index=jattn.ChunkPrefillIndex(jnp.asarray(off, jnp.int32)))
        jcache = put(1, m)
        th, _ = ttf.forward(tcfg, tparams, torch.from_numpy(toks).long(), torch.from_numpy(pos),
                            mode="prefill", cache=view(1), cache_index=tattn.ChunkPrefillIndex(off))
        _close(jh, th, jparams, tparams, len(piece))

    lens = np.array([11, 20, 0], np.int32)
    last = np.array([last0, 7, 0], np.int32)
    for _ in range(2):
        jh, jcache, _ = jtf.forward(jcfg, None, jparams, tokens=jnp.asarray(last[:, None]),
                                    positions=jnp.asarray(lens[:, None]), mode="decode",
                                    cache=jcache, cache_index=jnp.asarray(lens))
        th, tcache = ttf.forward(tcfg, tparams, torch.from_numpy(last[:, None]).long(),
                                 torch.from_numpy(lens[:, None]), mode="decode", cache=tcache,
                                 cache_index=torch.from_numpy(lens))
        d = np.max(np.abs(_logits_j(jparams, jh)[:2] - _logits_t(tparams, th)[:2]))
        assert d < TOL["float32"], d
        last = np.argmax(_logits_t(tparams, th)[:, 0], -1).astype(np.int32)
        lens = lens + np.array([1, 1, 0], np.int32)

    off = int(lens[1])                                     # a verify pass: 5 tokens at 22
    toks = np.array([[int(last[1]), 3, 1, 4, 1]], np.int32)
    pos = np.arange(off, off + 5, dtype=np.int32)[None]
    jh, _, _, _ = jtf.forward(jcfg, None, jparams, tokens=jnp.asarray(toks), positions=jnp.asarray(pos),
                              mode="prefill", cache=mini(1), chunk_state=jtf.init_chunk_state(jcfg),
                              cache_index=jattn.ChunkPrefillIndex(jnp.asarray(off, jnp.int32)))
    th, _ = ttf.forward(tcfg, tparams, torch.from_numpy(toks).long(), torch.from_numpy(pos),
                        mode="prefill", cache=view(1), cache_index=tattn.ChunkPrefillIndex(off))
    _close(jh, th, jparams, tparams)


@pytest.mark.parametrize("leg", ["f32", "int8+chained"])
def test_paged_prefill_chunk_decode_and_verify_logits_match_jax(weights, leg):
    """One sequence prefilled whole (bucket-padded), one in three chunks, two
    batched decode steps over four slots (two dead), then a 4-token verify
    at a mid-page offset through the first row: f32 pools on flat tables,
    or int8 pools on chained tables. Logits within f32 2e-5 of JAX's."""
    jcfg, tcfg, jparams, tparams = weights
    quant = leg != "f32"
    if quant:
        jcfg, tcfg = jcfg.replace(kv_quant=True), tcfg.replace(kv_quant=True)
    rng = np.random.default_rng(0)
    jcache = jtf.init_paged_cache(jcfg, 4, NP, PS)
    tcache = ttf.init_paged_cache(tcfg, NP, PS, "cpu")
    row_a = np.array([1, 2, 3, 0, 0, 0], np.int32)
    row_b = np.array([4, 5, 6, 7, 0, 0], np.int32)

    toks = np.zeros(16, np.int32)
    toks[:11] = rng.integers(1, tcfg.vocab_size, 11)
    pos = np.arange(16, dtype=np.int32)[None]
    jh, jcache, _ = jtf.forward(
        jcfg, None, jparams, tokens=jnp.asarray(toks[None]), positions=jnp.asarray(pos),
        mode="prefill", cache=jcache,
        cache_index=jattn.PagedPrefillIndex(jnp.asarray(row_a), jnp.asarray(0, jnp.int32)))
    th, tcache = ttf.forward(
        tcfg, tparams, torch.from_numpy(toks[None]).long(), torch.from_numpy(pos), mode="prefill",
        cache=tcache, cache_index=tattn.PagedPrefillIndex(torch.from_numpy(row_a), 0))
    _close(jh, th, jparams, tparams, 11)
    last0 = int(np.argmax(_logits_t(tparams, th)[0, 10]))

    b = rng.integers(1, tcfg.vocab_size, 20)
    for off in (0, 8, 16):
        piece = b[off:off + 8]
        toks = np.zeros(8, np.int32)
        toks[:len(piece)] = piece
        pos = np.arange(off, off + 8, dtype=np.int32)[None]
        jh, jcache, _, _ = jtf.forward(
            jcfg, None, jparams, tokens=jnp.asarray(toks[None]), positions=jnp.asarray(pos),
            mode="prefill", cache=jcache, chunk_state=jtf.init_chunk_state(jcfg),
            cache_index=jattn.PagedChunkPrefillIndex(
                jnp.asarray(row_b), jnp.asarray(1, jnp.int32), jnp.asarray(off, jnp.int32)))
        th, tcache = ttf.forward(
            tcfg, tparams, torch.from_numpy(toks[None]).long(), torch.from_numpy(pos),
            mode="prefill", cache=tcache,
            cache_index=tattn.PagedChunkPrefillIndex(torch.from_numpy(row_b), 1, off))
        _close(jh, th, jparams, tparams, len(piece))

    tab = np.zeros((4, P), np.int32)
    tab[0], tab[1] = row_a, row_b
    l2 = None
    if quant:                                     # tpp 2: l2 row 0 is the null row
        l2 = np.array([[0, 0], [1, 2], [3, 0], [4, 5], [6, 7]], np.int32)
        tab = np.array([[1, 2, 0], [3, 4, 0], [0, 0, 0], [0, 0, 0]], np.int32)
        assert np.array_equal(chain_rows(torch.from_numpy(tab), torch.from_numpy(l2)).numpy()[:2],
                              np.stack([row_a, row_b]))
    lens = np.array([11, 20, 0, 0], np.int32)
    last = np.array([last0, 7, 0, 0], np.int32)
    for _ in range(2):
        jidx = jattn.PagedIndex(jnp.asarray(lens), jnp.asarray(tab), None if l2 is None else jnp.asarray(l2))
        tidx = tattn.PagedIndex(torch.from_numpy(lens), torch.from_numpy(tab),
                                None if l2 is None else torch.from_numpy(l2))
        jh, jcache, _ = jtf.forward(jcfg, None, jparams, tokens=jnp.asarray(last[:, None]),
                                    positions=jnp.asarray(lens[:, None]), mode="decode",
                                    cache=jcache, cache_index=jidx)
        th, tcache = ttf.forward(tcfg, tparams, torch.from_numpy(last[:, None]).long(),
                                 torch.from_numpy(lens[:, None]), mode="decode", cache=tcache,
                                 cache_index=tidx)
        d = np.max(np.abs(_logits_j(jparams, jh)[:2] - _logits_t(tparams, th)[:2]))
        assert d < TOL["float32"], d
        last = np.argmax(_logits_t(tparams, th)[:, 0], -1).astype(np.int32)
        lens = lens + np.array([1, 1, 0, 0], np.int32)

    off = int(lens[0])                                     # 13: mid-page
    toks = np.array([[int(last[0]), 2, 7, 1]], np.int32)
    pos = np.arange(off, off + 4, dtype=np.int32)[None]
    jh, jcache, _ = jtf.forward(
        jcfg, None, jparams, tokens=jnp.asarray(toks), positions=jnp.asarray(pos), mode="prefill",
        cache=jcache, cache_index=jattn.PagedVerifyIndex(jnp.asarray(row_a), jnp.asarray(off, jnp.int32)))
    th, tcache = ttf.forward(tcfg, tparams, torch.from_numpy(toks).long(), torch.from_numpy(pos),
                             mode="prefill", cache=tcache,
                             cache_index=tattn.PagedVerifyIndex(torch.from_numpy(row_a), off))
    _close(jh, th, jparams, tparams)


def _prompts(vocab: int, lengths):
    return [[int(x) for x in np.random.default_rng(40 + i).integers(1, vocab, n)]
            for i, n in enumerate(lengths)]


@pytest.mark.parametrize("engine", ["dense_whole_prompt", "paged_bf16_chunk16", "paged_int8_chained"])
def test_engine_greedy_streams_match_jax(weights, engine):
    """The port's dense and paged engines emit the JAX engines' greedy
    streams on the same weights: prompts shorter than a page, across pages
    and longer than a chunk, more prompts than slots."""
    jcfg, tcfg, jparams, tparams = weights
    prompts = _prompts(tcfg.vocab_size, [5, 19, 30, 8])
    if engine.startswith("dense"):
        kw = dict(max_slots=3, max_len=64, max_new_tokens=6)
        j = JInferenceEngine(jcfg, JEngineConfig(**kw), params=jparams)
        t = InferenceEngine(tcfg, EngineConfig(**kw), params=tparams, device="cpu")
    else:
        kw = dict(page_size=8, num_pages=33, max_slots=3, max_seq_len=64, max_new_tokens=6)
        kw.update(dict(cache_dtype="bf16", chunk_tokens=16) if "bf16" in engine else
                  dict(cache_dtype="int8", chained_tables=True, table_page_entries=2))
        j = JPagedInferenceEngine(jcfg, JPagedEngineConfig(**kw), params=jparams)
        t = PagedInferenceEngine(tcfg, PagedEngineConfig(**kw), params=tparams, device="cpu")
    want = [s.out for s in j.generate(prompts)]
    got = [s.out for s in t.generate(prompts)]
    assert got == want


# ---------------------------------------------------------------------------
# The decode kernels' plain versions at G > 8, the planners, the head groups
# ---------------------------------------------------------------------------


def _pair(a: np.ndarray, dt: str):
    jdt, tdt = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dt]
    return jnp.asarray(a, jnp.float32).astype(jdt), torch.from_numpy(a.astype(np.float32)).to(tdt)


def _err(a, b) -> float:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(jnp.asarray(a, jnp.float32))
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(jnp.asarray(b, jnp.float32))
    return float(np.max(np.abs(a - b)))


def _chain(tab: np.ndarray, tpp: int):
    B, P_ = tab.shape
    l1 = np.zeros((B, P_ // tpp), np.int32)
    l2 = [np.zeros(tpp, np.int32)]
    for b in range(B):
        for j in range(P_ // tpp):
            piece = tab[b, j * tpp:(j + 1) * tpp]
            if piece.any():
                l1[b, j] = len(l2)
                l2.append(piece)
    return l1, np.stack(l2)


@pytest.mark.parametrize("G", [9, 12, 16])
@pytest.mark.parametrize("leg", ["flat", "int8", "chained", "int8+chained"])
def test_paged_ref_at_large_G_matches_pallas(leg, G):
    """paged_attention_ref at G 9, 12 and 16, every leg, against the Pallas
    kernel in interpret mode: a dead slot, lengths on and off page
    boundaries, a full row; f32 2e-5 (int8 pools: the same dequantized
    values on both sides)."""
    rng = np.random.default_rng(30 + G)
    NPg, KV, ps, hd, Pg, B = 12, 2, 8, 16, 4, 4
    quant, chained = "int8" in leg, "chained" in leg
    qj, qt = _pair(rng.standard_normal((B, KV, G, hd)).astype(np.float32), "float32")
    if quant:
        ints = [rng.integers(-127, 128, (NPg, KV, ps, hd)).astype(np.int8) for _ in range(2)]
        scales = [rng.uniform(0, 0.05, (NPg, KV, ps, 1)).astype(np.float32) for _ in range(2)]
        pools_t = [torch.from_numpy(a) for a in ints]
        sc_t = [torch.from_numpy(s).to(torch.bfloat16) for s in scales]
        pools_j = [jnp.asarray(a) for a in ints]
        jkw = {"pool_ks": jnp.asarray(scales[0]).astype(jnp.bfloat16),
               "pool_vs": jnp.asarray(scales[1]).astype(jnp.bfloat16)}
        tkw = {"pool_ks": sc_t[0], "pool_vs": sc_t[1]}
    else:
        pairs = [_pair(rng.standard_normal((NPg, KV, ps, hd)).astype(np.float32), "float32")
                 for _ in range(2)]
        pools_j, pools_t = [p[0] for p in pairs], [p[1] for p in pairs]
        jkw, tkw = {}, {}
    tab = np.stack([rng.permutation(np.arange(1, NPg))[:Pg] for _ in range(B)]).astype(np.int32)
    tab[0] = 0
    lens = np.array([1, 8, 13, 32], np.int32)
    if chained:
        l1, l2 = _chain(tab, 2)
        tab = l1
        jkw["l2_tab"], tkw["l2_tab"] = jnp.asarray(l2), torch.from_numpy(l2)
    out = paged_attention_ref(qt, *pools_t, torch.from_numpy(tab), torch.from_numpy(lens), **tkw)
    jout = paged_attention_grouped(qj, *pools_j, jnp.asarray(tab), jnp.asarray(lens), interpret=True, **jkw)
    assert out.shape == (B, KV, G, hd) and torch.isfinite(out).all()
    assert _err(out[1:], jout[1:]) < TOL["float32"]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [9, 12, 16])
def test_decode_ref_at_large_G_matches_pallas(G, dt):
    """decode_attention_ref (and the wrapper on the CPU, which runs it) at
    G 9, 12 and 16 against the Pallas kernel in interpret mode, lengths 1,
    16, 95 and 96 of a 96-token cache."""
    rng = np.random.default_rng(50 + G)
    B, KV, hd, T = 4, 2, 16, 96
    qj, qt = _pair(rng.standard_normal((B, KV, G, hd)).astype(np.float32), dt)
    kj, kt = _pair(rng.standard_normal((B, KV, T, hd)).astype(np.float32), dt)
    vj, vt = _pair(rng.standard_normal((B, KV, T, hd)).astype(np.float32), dt)
    lens = np.array([1, 16, 95, 96], np.int32)
    out = decode_attention_ref(qt, kt, vt, torch.from_numpy(lens))
    jout = decode_attention_grouped(qj, kj, vj, jnp.asarray(lens), bt=32, interpret=True)
    assert _err(out, jout) < TOL[dt]
    wrapped = da_ops.decode_attention(qt.reshape(B, 1, KV * G, hd), kt.transpose(1, 2), vt.transpose(1, 2),
                                      torch.from_numpy(lens))
    assert torch.equal(wrapped.reshape(B, KV, G, hd), out)


@pytest.mark.parametrize("G", [1, 3, 8, 9, 16, 24, 40])
@pytest.mark.parametrize("B,KV", [(1, 1), (4, 2), (8, 2), (1, 40), (6, 5)])
def test_split_planners_count_head_groups(B, KV, G):
    """Both planners count a block per head group, one for G <= 8 and
    ceil(G / 4) past it: at most two blocks per SM with a split, no split
    under MIN_SPLIT tokens; G <= 8 plans as before (one group)."""
    n_groups = da_ops.head_groups(G)
    assert n_groups == (1 if G <= 8 else -(-G // 4))
    for T in (96, 1000, 4096):
        n = da_ops.plan_splits(B, KV, T, G)
        if n > 1:
            assert B * KV * n_groups * n <= 2 * da_ops.SMS
            assert all(b - a >= da_ops.MIN_SPLIT for a, b in da_ops.split_bounds(T, n))
        if G <= 8:
            assert n == da_ops.plan_splits(B, KV, T)
    for Pn, ps in ((6, 16), (256, 16), (40, 24)):
        n = pa_ops.plan_page_splits(B, KV, Pn, ps, G)
        if n > 1:
            assert B * KV * n_groups * n <= 2 * da_ops.SMS
            assert all((b - a) * ps >= da_ops.MIN_SPLIT for a, b in pa_ops.page_split_bounds(Pn, n))
        if G <= 8:
            assert n == pa_ops.plan_page_splits(B, KV, Pn, ps)


def _head_group_kernel(q, k, v, lens, bounds, softcap, gm):
    """Plain emulation of the CUDA decode kernels' grid with head groups:
    block x = (bh * nsplit + split) * n_groups + group takes heads [g0, g0 +
    n) of (b, KV head) bh over rows [start, min(stop, len)) of its split and
    writes its (m, l, acc) (base 2) at the kernel's offsets of the split's G
    x (hd + 2) partial; then combine_kernel's merge of the splits in split
    order. q (B, KV, G, hd), k/v (B, KV, T, hd) f32; bounds in rows. The
    partials start as NaN: a slot no block writes shows in the output."""
    B, KV, G, hd = q.shape
    nsplit, n_groups = len(bounds), -(-G // gm)
    PSZ = G * (hd + 2)
    part = torch.full((B * KV * nsplit * PSZ,), math.nan)
    for x in range(B * KV * nsplit * n_groups):
        group, rest = x % n_groups, x // n_groups
        bh, split = rest // nsplit, rest % nsplit
        g0 = group * gm
        n = min(gm, G - g0)
        b, h = bh // KV, bh % KV
        t0, t1 = bounds[split][0], min(bounds[split][1], int(lens[b]))
        s = q[b, h, g0:g0 + n] @ k[b, h, t0:max(t0, t1)].T / math.sqrt(hd)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        s = s * LOG2E
        if t1 > t0:
            m = s.amax(-1)
            p = torch.exp2(s - m[:, None])
        else:
            m, p = torch.full((n,), -math.inf), s
        base = (bh * nsplit + split) * PSZ
        part[base + g0:base + g0 + n] = m
        part[base + G + g0:base + G + g0 + n] = p.sum(-1)
        part[base + 2 * G + g0 * hd:base + 2 * G + (g0 + n) * hd] = (p @ v[b, h, t0:max(t0, t1)]).flatten()
    out = torch.empty(B * KV, G, hd)
    for bh in range(B * KV):
        pb = part[bh * nsplit * PSZ:(bh + 1) * nsplit * PSZ].view(nsplit, PSZ)
        M = pb[:, :G].amax(0)
        w = torch.where(pb[:, :G].isinf(), 0.0, torch.exp2(pb[:, :G] - torch.where(M.isinf(), 0.0, M)))
        den = (pb[:, G:2 * G] * w).sum(0)
        num = (pb[:, 2 * G:].view(nsplit, G, hd) * w[:, :, None]).sum(0)
        out[bh] = num / den.clamp_min(1e-30)[:, None]
    return out.view(B, KV, G, hd)


@pytest.mark.parametrize("G", [5, 12, 16, 24])
@pytest.mark.parametrize("layout", ["paged", "paged_int8", "dense"])
def test_head_group_split_and_combine_match_ref(layout, G):
    """The emulated head groups and splits against the plain versions at the
    planners' splits: lengths 0, 1, split - 1, split, split + 1 and a full
    row; f32 2e-5, a length of 0 gives 0, every partial slot written."""
    rng = np.random.default_rng(60 + G)
    B, KV, hd, ps = 6, 2, 16, 8
    q = torch.from_numpy(rng.standard_normal((B, KV, G, hd)).astype(np.float32))
    if layout == "dense":
        T = 1024
        n = da_ops.plan_splits(B, KV, T, G)
        bounds = da_ops.split_bounds(T, n)
    else:
        Pn = 128
        n = pa_ops.plan_page_splits(B, KV, Pn, ps, G)
        bounds = [(a * ps, b * ps) for a, b in pa_ops.page_split_bounds(Pn, n)]
        T = Pn * ps
    assert n > 1
    s = bounds[1][0]
    lens = torch.tensor([0, 1, s - 1, s, s + 1, T], dtype=torch.int32)
    if layout == "dense":
        k, v = (torch.from_numpy(rng.standard_normal((B, KV, T, hd)).astype(np.float32)) for _ in range(2))
        ref = decode_attention_ref(q, k, v, lens, softcap=30.0)
        cap = 30.0
    else:
        NPg = 1 + sum(-(-int(L) // ps) for L in lens)
        perm = rng.permutation(np.arange(1, NPg))
        tab = np.zeros((B, T // ps), np.int32)
        used = 0
        for b, L in enumerate(lens.tolist()):
            c = -(-L // ps)
            tab[b, :c] = perm[used:used + c]
            used += c
        table = torch.from_numpy(tab)
        kw = {}
        if layout == "paged_int8":
            pk, pv = (torch.from_numpy(rng.integers(-127, 128, (NPg, KV, ps, hd)).astype(np.int8))
                      for _ in range(2))
            kw = {n_: torch.from_numpy(rng.uniform(0, 0.05, (NPg, KV, ps, 1)).astype(np.float32))
                  .to(torch.bfloat16) for n_ in ("pool_ks", "pool_vs")}
            k = dequantize_kv(gather_kv(pk, table), gather_kv(kw["pool_ks"], table), torch.float32)
            v = dequantize_kv(gather_kv(pv, table), gather_kv(kw["pool_vs"], table), torch.float32)
        else:
            pk, pv = (torch.from_numpy(rng.standard_normal((NPg, KV, ps, hd)).astype(np.float32))
                      for _ in range(2))
            k, v = gather_kv(pk, table), gather_kv(pv, table)
        cap = 0.0
        ref = paged_attention_ref(q, pk, pv, table, lens, **kw)
    gm = G if G <= 8 else da_ops.GROUP_HEADS
    out = _head_group_kernel(q, k.float(), v.float(), lens, bounds, cap, gm)
    assert torch.isfinite(out).all()
    assert float(out[0].abs().max()) == 0.0                          # length 0 -> 0
    assert float((out[1:] - ref[1:]).abs().max()) < TOL["float32"]
