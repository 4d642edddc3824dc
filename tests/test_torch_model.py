"""The port's model path (src/repro_torch/models) against the JAX package's
``DecoderLM`` on the CPU, smollm-360m SMOKE in f32, on the same weights
(bridged with ``params_from_jax``), the same caches, page pools and block
tables: logits of the paged prefill, the chunked paged prefill, the batched
paged decode (flat and chained tables, f32 and int8 pools), the dense
prefill, chunked prefill and decode (f32, bf16 and int8 caches) and the
whole-sequence (teacher-forcing) forward, to f32 2e-5; the caches after
each step (int8 values within one LSB); and padded-vs-unpadded prefill."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402

TOL = 2e-5
NP, PS, P = 16, 8, 6


@pytest.fixture(scope="module")
def models():
    jcfg = j_get_config("smollm-360m", smoke=True)
    tcfg = get_config("smollm-360m", smoke=True)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _logits_j(jparams, h):
    return np.asarray(jnp.einsum("bsd,dv->bsv", h, jparams["unembed"]), np.float32)


def _logits_t(tparams, h):
    return (h @ tparams["unembed"]).float().numpy()


def _pools_close(jcache, tcache):
    for name in ("k", "v"):
        j = np.asarray(jcache["blocks"]["l0_mixer"][name])[:, 1:]      # page 0: pad garbage
        t = tcache["blocks"]["l0_mixer"][name][:, 1:].numpy()
        assert np.max(np.abs(j - t)) < TOL, name


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "uint16"])
def test_params_from_jax_round_trip(dtype):
    """Every leaf lands bit for bit in the stacked layout; bf16 leaves arrive
    as JAX's numpy bf16 arrays or as their uint16 bits."""
    bf = dtype != "float32"
    jcfg = j_get_config("smollm-360m", smoke=True)
    tcfg = get_config("smollm-360m", smoke=True)
    if bf:
        jcfg = jcfg.replace(param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16)
        tcfg = tcfg.replace(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    tree = jax.tree.map(np.asarray, j_get_model(jcfg).init(jax.random.PRNGKey(1)))
    if dtype == "uint16":
        tree = jax.tree.map(lambda a: a.view(np.uint16), tree)
    port = params_from_jax(tree, tcfg, "cpu")
    assert port["blocks"]["l0_mixer"]["wq"].shape == (tcfg.n_layers, tcfg.d_model, tcfg.n_heads * tcfg.hd)
    src = dict(_leaves(tree))
    got = dict(_leaves(port))
    assert set(src) == set(got) == {
        "/embedding", "/unembed", "/final_norm/w", "/blocks/l0_norm/w", "/blocks/l0_ffn_norm/w",
        "/blocks/l0_mixer/wq", "/blocks/l0_mixer/wk", "/blocks/l0_mixer/wv", "/blocks/l0_mixer/wo",
        "/blocks/l0_ffn/w1", "/blocks/l0_ffn/w2", "/blocks/l0_ffn/w3"}
    for path, a in src.items():
        t = got[path]
        assert t.dtype == tcfg.param_dtype, path
        back = t.view(torch.int16).numpy().view(np.uint16) if bf else t.numpy()
        np.testing.assert_array_equal(back, np.asarray(a).view(np.uint16) if bf else a, err_msg=path)
    with pytest.raises(KeyError):
        params_from_jax({**tree, "extra": np.zeros(1)}, tcfg, "cpu")


def test_paged_prefill_chunk_and_decode_logits_match_jax(models):
    """One sequence prefilled whole (bucket-padded), one in three chunks,
    then two batched decode steps over four slots (two dead), all on one
    pool: logits and pools agree with the JAX model at f32 2e-5."""
    jcfg, tcfg, jparams, tparams = models
    rng = np.random.default_rng(0)
    jcache = jtf.init_paged_cache(jcfg, 4, NP, PS)
    tcache = ttf.init_paged_cache(tcfg, NP, PS, "cpu")
    row_a = np.array([1, 2, 0, 0, 0, 0], np.int32)
    row_b = np.array([3, 4, 5, 6, 0, 0], np.int32)

    # whole-prompt paged prefill: 11 tokens padded to 16
    a = rng.integers(1, tcfg.vocab_size, 11)
    toks = np.zeros(16, np.int32)
    toks[:11] = a
    pos = np.arange(16, dtype=np.int32)[None]
    jh, jcache, _ = jtf.forward(
        jcfg, None, jparams, tokens=jnp.asarray(toks[None]), positions=jnp.asarray(pos),
        mode="prefill", cache=jcache,
        cache_index=jattn.PagedPrefillIndex(jnp.asarray(row_a), jnp.asarray(0, jnp.int32)))
    th, tcache = ttf.forward(
        tcfg, tparams, torch.from_numpy(toks[None]).long(), torch.from_numpy(pos), mode="prefill",
        cache=tcache, cache_index=tattn.PagedPrefillIndex(torch.from_numpy(row_a), 0))
    jl, tl = _logits_j(jparams, jh), _logits_t(tparams, th)
    assert np.max(np.abs(jl[:, :11] - tl[:, :11])) < TOL
    _pools_close(jcache, tcache)

    # chunked paged prefill: 20 tokens in chunks of 8 at offsets 0, 8, 16
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
        n = len(piece)
        assert np.max(np.abs(_logits_j(jparams, jh)[:, :n] - _logits_t(tparams, th)[:, :n])) < TOL
    _pools_close(jcache, tcache)

    # two batched decode steps: slots 0/1 live, slots 2/3 dead
    tab = np.zeros((4, P), np.int32)
    tab[0], tab[1] = row_a, row_b
    lens = np.array([11, 20, 0, 0], np.int32)
    last = np.array([int(np.argmax(jl[0, 10])), 7, 0, 0], np.int32)
    for _ in range(2):
        jh, jcache, _ = jtf.forward(
            jcfg, None, jparams, tokens=jnp.asarray(last[:, None]),
            positions=jnp.asarray(lens[:, None]), mode="decode", cache=jcache,
            cache_index=jattn.PagedIndex(jnp.asarray(lens), jnp.asarray(tab)))
        th, tcache = ttf.forward(
            tcfg, tparams, torch.from_numpy(last[:, None]).long(), torch.from_numpy(lens[:, None]),
            mode="decode", cache=tcache,
            cache_index=tattn.PagedIndex(torch.from_numpy(lens), torch.from_numpy(tab)))
        jl, tl = _logits_j(jparams, jh), _logits_t(tparams, th)
        assert np.max(np.abs(jl[:2] - tl[:2])) < TOL
        last = np.argmax(tl[:, 0], -1).astype(np.int32)
        lens = lens + np.array([1, 1, 0, 0], np.int32)
    _pools_close(jcache, tcache)


def test_api_tokens_and_teacher_forcing_match_jax(models):
    """The DecoderLM entry points the engine calls emit the JAX model's
    greedy tokens, and the whole-sequence forward (the chip's teacher-forcing
    path) matches the JAX train-mode forward."""
    jcfg, tcfg, jparams, tparams = models
    jm, tm = j_get_model(jcfg), get_model(tcfg)
    rng = np.random.default_rng(1)
    toks = rng.integers(1, tcfg.vocab_size, (1, 13)).astype(np.int32)
    jh, _, _ = jtf.forward(jcfg, None, jparams, tokens=jnp.asarray(toks),
                           positions=jnp.asarray(np.arange(13, dtype=np.int32)[None]), mode="train")
    th = tm.hidden(tparams, toks)
    assert np.max(np.abs(_logits_j(jparams, jh) - tm.logits(tparams, th).numpy())) < TOL

    row = np.array([2, 3, 0, 0, 0, 0], np.int32)
    padded = np.zeros((1, 16), np.int32)
    padded[0, :13] = toks[0]
    jtok, _ = jm.prefill_paged(None, jparams, {"tokens": jnp.asarray(padded), "n_valid": jnp.asarray([13]),
                                               "tab_row": row, "slot": 0},
                               jtf.init_paged_cache(jcfg, 2, NP, PS))
    ttok, _ = tm.prefill_paged(tparams, {"tokens": padded, "n_valid": [13], "tab_row": row, "slot": 0},
                               tm.init_paged_cache(NP, PS, "cpu"))
    assert ttok.tolist() == np.asarray(jtok).tolist()


def test_padded_prefill_matches_unpadded(models):
    """Bucket padding is invisible: the same prompt prefilled at its own
    length and padded to the next bucket emits the same token from the same
    last-valid hidden state and writes the same K/V for its valid tokens."""
    _, tcfg, _, tparams = models
    tm = get_model(tcfg)
    prompt = np.random.default_rng(2).integers(1, tcfg.vocab_size, 11)
    row = np.array([5, 6, 0, 0, 0, 0], np.int32)
    outs = []
    for Lp in (11, 16):
        toks = np.zeros((1, Lp), np.int64)
        toks[0, :11] = prompt
        cache = tm.init_paged_cache(NP, PS, "cpu")
        tok, cache = tm.prefill_paged(tparams, {"tokens": toks, "n_valid": [11], "tab_row": row,
                                                "slot": 0}, cache)
        outs.append((tok, cache["blocks"]["l0_mixer"]["k"].clone()))
    assert outs[0][0].tolist() == outs[1][0].tolist()
    k0, k1 = outs[0][1], outs[1][1]
    assert torch.allclose(k0[:, 5], k1[:, 5], atol=TOL)                  # tokens 0..7
    assert torch.allclose(k0[:, 6, :, :3], k1[:, 6, :, :3], atol=TOL)    # tokens 8..10


def _cfgs(models, cache: str):
    jcfg, tcfg = models[0], models[1]
    if cache == "int8":
        return jcfg.replace(kv_quant=True), tcfg.replace(kv_quant=True)
    if cache == "bf16":
        return (jcfg.replace(kv_cache_dtype=jnp.bfloat16),
                tcfg.replace(kv_cache_dtype=torch.bfloat16))
    return jcfg, tcfg


def _leaf_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _caches_close(jcache, tcache, tol, sl=slice(None)):
    """Every leaf of layer 0 agrees within ``tol`` (int8 values: one LSB,
    where an f32 K that differs in its last bit lands on the other side of a
    rounding boundary) over ``sl`` of the axis after the stacking one."""
    for name, t in tcache["blocks"]["l0_mixer"].items():
        j = _leaf_np(jcache["blocks"]["l0_mixer"][name])[:, sl]
        d = np.max(np.abs(j - _leaf_np(t)[:, sl]))
        assert d <= (1 if t.dtype == torch.int8 else tol), (name, d)


@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
def test_dense_prefill_chunk_and_decode_logits_match_jax(models, cache):
    """Three slots of a dense cache (capacity 32): slot 0 prefilled whole
    (11 tokens padded to 16) into its stripe in place, slot 1 in chunks of
    8 at offsets 0, 8, 16, slot 2 dead; then two batched decode steps with
    per-slot lengths. Logits and the caches agree with the JAX model, which
    builds a one-slot cache and writes it back."""
    jcfg, tcfg = _cfgs(models, cache)
    jparams, tparams = models[2], models[3]
    tm = get_model(tcfg)
    rng = np.random.default_rng(3)
    B, CAP = 3, 32
    jcache = jtf.init_cache(jcfg, B, CAP)
    tcache = tm.init_cache(B, CAP, "cpu")

    def view(slot):
        return {"blocks": {k: {n: t[:, slot:slot + 1] for n, t in leaves.items()}
                           for k, leaves in tcache["blocks"].items()}}

    def put(slot, mini):
        return jax.tree.map(lambda full, part: jax.lax.dynamic_update_slice_in_dim(
            full, part.astype(full.dtype), slot, axis=1), jcache, mini)

    a = rng.integers(1, tcfg.vocab_size, 11)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :11] = a
    pos = np.arange(16, dtype=np.int32)[None]
    jh, mini, _ = jtf.forward(jcfg, None, jparams, tokens=jnp.asarray(toks),
                              positions=jnp.asarray(pos), mode="prefill",
                              cache=jtf.init_cache(jcfg, 1, CAP), cache_index=0)
    jcache = put(0, mini)
    th, _ = ttf.forward(tcfg, tparams, torch.from_numpy(toks).long(), torch.from_numpy(pos),
                        mode="prefill", cache=view(0), cache_index=0)
    assert np.max(np.abs(_logits_j(jparams, jh)[:, :11] - _logits_t(tparams, th)[:, :11])) < TOL
    last0 = int(np.argmax(_logits_t(tparams, th)[0, 10]))

    b = rng.integers(1, tcfg.vocab_size, 20)
    for off in (0, 8, 16):
        piece = b[off:off + 8]
        toks = np.zeros((1, 8), np.int32)
        toks[0, :len(piece)] = piece
        pos = np.arange(off, off + 8, dtype=np.int32)[None]
        mini = jax.tree.map(lambda full: jax.lax.dynamic_slice_in_dim(full, 1, 1, axis=1), jcache)
        jh, mini, _, _ = jtf.forward(jcfg, None, jparams, tokens=jnp.asarray(toks),
                                     positions=jnp.asarray(pos), mode="prefill", cache=mini,
                                     chunk_state=jtf.init_chunk_state(jcfg),
                                     cache_index=jattn.ChunkPrefillIndex(jnp.asarray(off, jnp.int32)))
        jcache = put(1, mini)
        th, _ = ttf.forward(tcfg, tparams, torch.from_numpy(toks).long(), torch.from_numpy(pos),
                            mode="prefill", cache=view(1),
                            cache_index=tattn.ChunkPrefillIndex(off))
        n = len(piece)
        d = np.max(np.abs(_logits_j(jparams, jh)[:, :n] - _logits_t(tparams, th)[:, :n]))
        assert d < TOL, d
    _caches_close(jcache, tcache, TOL, slice(0, 2))

    lens = np.array([11, 20, 0], np.int32)
    last = np.array([last0, 7, 0], np.int32)
    for _ in range(2):
        jh, jcache, _ = jtf.forward(jcfg, None, jparams, tokens=jnp.asarray(last[:, None]),
                                    positions=jnp.asarray(lens[:, None]), mode="decode",
                                    cache=jcache, cache_index=jnp.asarray(lens))
        th, tcache = ttf.forward(tcfg, tparams, torch.from_numpy(last[:, None]).long(),
                                 torch.from_numpy(lens[:, None]), mode="decode", cache=tcache,
                                 cache_index=torch.from_numpy(lens))
        jl, tl = _logits_j(jparams, jh), _logits_t(tparams, th)
        assert np.max(np.abs(jl[:2] - tl[:2])) < TOL
        last = np.argmax(tl[:, 0], -1).astype(np.int32)
        lens = lens + np.array([1, 1, 0], np.int32)
    _caches_close(jcache, tcache, TOL, slice(0, 2))


def test_dense_api_prefill_and_decode_tokens_match_jax(models):
    """``DecoderLM.prefill(..., cap)`` (a fresh cache) and the dense leg of
    ``decode`` with per-slot ``lengths`` emit the JAX model's tokens."""
    jcfg, tcfg, jparams, tparams = models
    jm, tm = j_get_model(jcfg), get_model(tcfg)
    toks = np.random.default_rng(4).integers(1, tcfg.vocab_size, (2, 9)).astype(np.int32)
    jtok, jcache = jm.prefill(None, jparams, {"tokens": jnp.asarray(toks),
                                              "n_valid": jnp.asarray([9, 6])}, cap=16)
    ttok, tcache = tm.prefill(tparams, {"tokens": toks, "n_valid": [9, 6]}, cap=16)
    assert ttok.tolist() == np.asarray(jtok).tolist()
    assert tcache["blocks"]["l0_mixer"]["k"].shape == (tcfg.n_layers, 2, 16, 1, tcfg.hd)
    lens = np.array([9, 6], np.int32)
    jtok, _ = jm.decode(None, jparams, jcache, {"token": jnp.asarray(np.asarray(jtok)[:, None]),
                                                "cache_index": jnp.max(lens),
                                                "lengths": jnp.asarray(lens)})
    ttok, _ = tm.decode(tparams, tcache, {"token": ttok[:, None], "lengths": lens})
    assert ttok.tolist() == np.asarray(jtok).tolist()


@pytest.mark.parametrize("leg", ["int8", "chained", "int8+chained"])
def test_paged_int8_and_chained_decode_logits_match_jax(models, leg):
    """A paged prefill then two batched decode steps over four slots (two
    dead) with an int8 pool, chained tables, or both: logits and pools agree
    with the JAX model (int8 values within one LSB)."""
    quant, chained = "int8" in leg, "chained" in leg
    jcfg, tcfg = _cfgs(models, "int8" if quant else "f32")
    jparams, tparams = models[2], models[3]
    rng = np.random.default_rng(6)
    jcache = jtf.init_paged_cache(jcfg, 4, NP, PS)
    tcache = ttf.init_paged_cache(tcfg, NP, PS, "cpu")
    rows = {0: np.array([1, 2, 0, 0, 0, 0], np.int32), 1: np.array([3, 4, 5, 6, 0, 0], np.int32)}
    lens = np.array([11, 20, 0, 0], np.int32)
    last = np.zeros(4, np.int32)
    for slot, n in ((0, 11), (1, 20)):
        toks = np.zeros((1, 24), np.int32)
        toks[0, :n] = rng.integers(1, tcfg.vocab_size, n)
        pos = np.arange(24, dtype=np.int32)[None]
        jh, jcache, _ = jtf.forward(
            jcfg, None, jparams, tokens=jnp.asarray(toks), positions=jnp.asarray(pos),
            mode="prefill", cache=jcache,
            cache_index=jattn.PagedPrefillIndex(jnp.asarray(rows[slot]), jnp.asarray(slot, jnp.int32)))
        th, tcache = ttf.forward(tcfg, tparams, torch.from_numpy(toks).long(), torch.from_numpy(pos),
                                 mode="prefill", cache=tcache,
                                 cache_index=tattn.PagedPrefillIndex(torch.from_numpy(rows[slot]), slot))
        assert np.max(np.abs(_logits_j(jparams, jh)[:, :n] - _logits_t(tparams, th)[:, :n])) < TOL
        last[slot] = int(np.argmax(_logits_t(tparams, th)[0, n - 1]))
    tab = np.zeros((4, P), np.int32)
    tab[0], tab[1] = rows[0], rows[1]
    l2 = None
    if chained:                                   # tpp 2: l2 row 0 is the null row
        l2 = np.array([[0, 0], [1, 2], [3, 4], [5, 6]], np.int32)
        tab = np.array([[1, 0, 0], [2, 3, 0], [0, 0, 0], [0, 0, 0]], np.int32)
    for _ in range(2):
        jidx = jattn.PagedIndex(jnp.asarray(lens), jnp.asarray(tab),
                                None if l2 is None else jnp.asarray(l2))
        tidx = tattn.PagedIndex(torch.from_numpy(lens), torch.from_numpy(tab),
                                None if l2 is None else torch.from_numpy(l2))
        jh, jcache, _ = jtf.forward(jcfg, None, jparams, tokens=jnp.asarray(last[:, None]),
                                    positions=jnp.asarray(lens[:, None]), mode="decode",
                                    cache=jcache, cache_index=jidx)
        th, tcache = ttf.forward(tcfg, tparams, torch.from_numpy(last[:, None]).long(),
                                 torch.from_numpy(lens[:, None]), mode="decode", cache=tcache,
                                 cache_index=tidx)
        jl, tl = _logits_j(jparams, jh), _logits_t(tparams, th)
        assert np.max(np.abs(jl[:2] - tl[:2])) < TOL
        last = np.argmax(tl[:, 0], -1).astype(np.int32)
        lens = lens + np.array([1, 1, 0, 0], np.int32)
    _caches_close(jcache, tcache, TOL, slice(1, None))            # page 0: pad garbage
