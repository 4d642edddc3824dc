"""The port's model path (src/repro_torch/models) against the JAX package's
``DecoderLM`` on the CPU, smollm-360m SMOKE in f32, on the same weights
(bridged with ``params_from_jax``), the same page pools and the same block
tables: logits of the paged prefill, the chunked paged prefill, the batched
paged decode and the whole-sequence (teacher-forcing) forward, to f32 2e-5;
the pools after each step; and padded-vs-unpadded prefill."""
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
