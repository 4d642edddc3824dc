"""Weight-only int8 in the port (``models/quant.py``: ``quantize_weight``,
``qeinsum``, ``quantize_params``, ``DecoderLM.init`` under ``weights_int8``)
and granite-8b, against the JAX package on the CPU.

``quantize_weight`` equals JAX's bit for bit (int8 values and bf16 scale
bits; f32 and bf16 input, 2-D and stacked 3-D, a zero column, .5 ties).
``qeinsum`` matches JAX's on every pattern the port uses, at f32 2e-5 and
bf16 2e-2, and the floating-point product within test_perf_variants.py's
relative 0.02. ``quantize_params`` quantizes the leaves JAX's does on four
smoke trees, and a JAX-quantized tree carried through the bridge equals the
port's quantization of the carried floating-point tree. granite-8b SMOKE
and qwen1.5-32b SMOKE (q/k/v biases drawn standard normal in both trees)
with int8 weights: logits of the whole-sequence forward, the dense and
paged prefill, chunks, decode and verify within f32 2e-5 of JAX's, and the
dense and paged engines' greedy streams equal to the JAX engines'."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import granite_8b as j_granite  # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.quant import qeinsum as j_qeinsum  # noqa: E402
from repro.models.quant import quantize_params as j_quantize_params  # noqa: E402
from repro.models.quant import quantize_weight as j_quantize_weight  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.engine import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serving.engine import PagedEngineConfig as JPagedEngineConfig  # noqa: E402
from repro.serving.engine import PagedInferenceEngine as JPagedInferenceEngine  # noqa: E402
from repro_torch.configs import granite_8b  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.models.quant import (  # noqa: E402
    QUANT_LEAVES,
    WeightsInt8Error,
    is_quant,
    qeinsum,
    quantize_params,
    quantize_weight,
)
from repro_torch.serving.engine import (  # noqa: E402
    EngineConfig,
    InferenceEngine,
    PagedEngineConfig,
    PagedInferenceEngine,
)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}      # tests/test_kernels.py:17
NP, PS, P = 16, 8, 6


def _bits(t) -> np.ndarray:
    """Raw bits of a bf16 array (JAX or torch) as uint16."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def _pair(a: np.ndarray, dt: str):
    if dt == "float32":
        return jnp.asarray(a), torch.from_numpy(a.copy())
    j = jnp.asarray(a).astype(jnp.bfloat16)
    t = torch.from_numpy(a.copy()).to(torch.bfloat16)
    assert np.array_equal(_bits(j), _bits(t))      # both round f32 to nearest even
    return j, t


def _weight(shape, seed):
    """Normal values with a zero column, and a column whose values fall on
    .5 ties of q: amax 127 (scale 1.0) beside 2.5, -3.5, 0.5, ..."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    w[..., 0] = 0.0
    d = shape[-2]
    ties = (np.arange(d, dtype=np.float32) % 8) - 3.5
    ties[0] = 127.0
    w[..., 1] = ties
    return w


@pytest.mark.parametrize("shape", [(64, 96), (3, 40, 24)], ids=["2d", "stacked3d"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_quantize_weight_bit_for_bit(shape, dt):
    wj, wt = _pair(_weight(shape, 0), dt)
    want, got = j_quantize_weight(wj), quantize_weight(wt)
    sshape = list(shape)
    sshape[-2] = 1
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.bfloat16
    assert tuple(got["s"].shape) == tuple(sshape)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(_bits(got["s"]), _bits(want["s"]))
    q = got["q"].numpy()
    assert not q[..., 0].any() and np.abs(q[..., 1]).max() == 127
    assert set(np.unique(q[..., 1][..., 1:])) <= {-4, -2, 0, 2, 4}   # .5 ties to even


# (JAX pattern, x shape, w shape): every product the port runs
PATTERNS = [
    ("bsd,dh->bsh", (2, 5, 64), (64, 96)),       # q/k/v projections
    ("bsh,he->bse", (2, 5, 96), (96, 64)),       # out-projection
    ("bsd,df->bsf", (2, 5, 64), (64, 128)),      # MLP w1, w3
    ("bsf,fd->bsd", (2, 5, 128), (128, 64)),     # MLP w2
    ("bd,dv->bv", (3, 64), (64, 512)),           # greedy logits
    ("bsd,dv->bsv", (2, 5, 64), (64, 512)),      # verify logits
]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PATTERNS, ids=[p[0] for p in PATTERNS])
def test_qeinsum_matches_jax_and_the_float_product(case, dt):
    jpattern, xs, ws = case
    rng = np.random.default_rng(len(jpattern) + xs[-1])
    w = rng.standard_normal(ws).astype(np.float32) / np.sqrt(ws[0])
    x = rng.standard_normal(xs).astype(np.float32) * 0.5
    xj, xt = _pair(x, dt)
    wq_j = j_quantize_weight(jnp.asarray(w))
    wq_t = {"q": torch.from_numpy(np.asarray(wq_j["q"]).copy()),
            "s": torch.from_numpy(_bits(wq_j["s"]).view(np.int16).copy()).view(torch.bfloat16)}
    got = qeinsum(xt, wq_t)
    want = j_qeinsum(jpattern, xj, wq_j)
    assert got.dtype == xt.dtype and tuple(got.shape) == tuple(want.shape)
    err = np.max(np.abs(got.float().numpy() - np.asarray(want, np.float32)))
    assert err < TOL[dt], err
    plain = qeinsum(xt, torch.from_numpy(w))          # a float w: x @ w in x's dtype
    err = np.max(np.abs(plain.float().numpy() - np.asarray(j_qeinsum(jpattern, xj, jnp.asarray(w)),
                                                           np.float32)))
    assert err < TOL[dt], err
    fp = x @ w
    rel = np.max(np.abs(got.float().numpy() - fp)) / np.max(np.abs(fp))
    assert rel < 0.02, rel


def _j_tree(arch: str, over=None):
    """JAX config and f32 smoke weights of ``arch``; q/k/v biases (where the
    config has them) drawn standard normal, as JAX inits them to zeros."""
    jcfg = j_get_config(arch, smoke=True).replace(attn_chunk=64, **(over or {}))
    tree = jax.tree.map(np.asarray, j_get_model(jcfg).init(jax.random.PRNGKey(0)))
    mixer = tree["blocks"]["l0_mixer"]
    rng = np.random.default_rng(5)
    for name in ("bq", "bk", "bv"):
        if name in mixer:
            mixer[name] = rng.standard_normal(mixer[name].shape).astype(np.float32)
    return jcfg, tree


def _walk(tree, path=""):
    if isinstance(tree, dict) and not is_quant(tree):
        for k, v in tree.items():
            yield from _walk(v, f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-8b", "glm4-9b", "qwen1.5-32b"])
def test_quantize_params_matches_jax_and_the_bridge_carries_it(arch):
    """The same leaves quantized as JAX's (by key, 2-D and stacked 3-D), the
    biases, norms and embedding untouched; a JAX-quantized tree through the
    bridge equals the port's quantize_params of the bridged float tree."""
    jcfg, tree = _j_tree(arch)
    tcfg = get_config(arch, smoke=True).replace(attn_chunk=64)
    tfloat = params_from_jax(tree, tcfg, "cpu")
    mine = quantize_params(tfloat)
    jq = jax.tree.map(np.asarray, j_quantize_params(jax.tree.map(jnp.asarray, tree)))
    carried = params_from_jax(jq, tcfg.replace(weights_int8=True), "cpu")
    want_quant = {p for p, leaf in _walk(jq) if isinstance(leaf, dict)}
    assert want_quant == {p for p, leaf in _walk(mine) if is_quant(leaf)}
    assert {p.rsplit("/", 1)[-1] for p in want_quant} <= QUANT_LEAVES
    assert "/embedding" not in want_quant and "/blocks/l0_mixer/wq" in want_quant
    floats = dict(_walk(tfloat))
    for (path, a), (_, b) in zip(_walk(mine), _walk(carried)):
        if path in want_quant:
            assert a["q"].dtype == b["q"].dtype == torch.int8, path
            assert torch.equal(a["q"], b["q"]) and torch.equal(a["s"].view(torch.int16),
                                                               b["s"].view(torch.int16)), path
            assert tuple(a["s"].shape) == floats[path].shape[:-2] + (1, floats[path].shape[-1])
        else:
            assert a is floats[path] and torch.equal(a, b), path        # untouched, not copied
    assert quantize_params(mine)["blocks"]["l0_ffn"]["w1"] is not None   # a quantized tree passes
    assert torch.equal(quantize_params(mine)["unembed"]["q"], mine["unembed"]["q"])


def test_bridge_refuses_a_quantized_leaf_elsewhere():
    jcfg, tree = _j_tree("granite-8b")
    tcfg = get_config("granite-8b", smoke=True).replace(attn_chunk=64)
    jq = jax.tree.map(np.asarray, j_quantize_params(jax.tree.map(jnp.asarray, tree)))
    bad = dict(jq, embedding=jax.tree.map(np.asarray, j_quantize_weight(jnp.asarray(tree["embedding"]))))
    with pytest.raises(ValueError, match="embedding"):
        params_from_jax(bad, tcfg, "cpu")
    bad = dict(jq, unembed={"q": jq["unembed"]["q"].astype(np.int16), "s": jq["unembed"]["s"]})
    with pytest.raises(ValueError, match="int8"):
        params_from_jax(bad, tcfg, "cpu")


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-8b", "glm4-9b", "qwen1.5-32b"])
def test_int8_init_is_quantize_params_of_init(arch):
    """The quantized init (``weights_int8``) drawn a slice at a time equals
    quantize_params of the whole-leaf init, bit for bit, on the CPU at smoke
    size; the same structure and dtypes; the generators end in the same
    state."""
    cfg = get_config(arch, smoke=True)
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    want = quantize_params(get_model(cfg).init(g1))
    got = get_model(cfg.replace(weights_int8=True)).init(g2)
    a, b = dict(_walk(want)), dict(_walk(got))
    assert a.keys() == b.keys()
    for path, leaf in a.items():
        if is_quant(leaf):
            assert b[path]["q"].dtype == torch.int8 and b[path]["s"].dtype == torch.bfloat16
            assert torch.equal(leaf["q"], b[path]["q"]), path
            assert torch.equal(leaf["s"].view(torch.int16), b[path]["s"].view(torch.int16)), path
        else:
            assert leaf.dtype == b[path].dtype == cfg.param_dtype and torch.equal(leaf, b[path]), path
    assert torch.equal(torch.randn(4, generator=g1), torch.randn(4, generator=g2))


def test_xlstm_with_int8_weights_raises():
    cfg = get_config("xlstm-350m", smoke=True)
    with pytest.raises(WeightsInt8Error, match="plain product"):
        get_model(cfg.replace(weights_int8=True)).init(torch.Generator().manual_seed(0))
    with pytest.raises(WeightsInt8Error, match="xlstm-350m"):
        serve.main(["--arch", "xlstm-350m", "--smoke", "--device", "cpu", "--weights-int8"])


def _name(dtype) -> str:
    return str(dtype).replace("torch.", "").replace("jax.numpy.", "")


@pytest.mark.parametrize("which", ["FULL", "SMOKE"])
def test_granite_config_field_for_field(which):
    """Every field of the port's ModelConfig equals JAX's granite-8b (dtypes
    by name); JAX's training-only fields (remat, ce_chunks) have no twin."""
    mine, theirs = getattr(granite_8b, which), getattr(j_granite, which)
    for f in dataclasses.fields(ModelConfig):
        a, b = getattr(mine, f.name), getattr(theirs, f.name)
        if f.name in ("param_dtype", "compute_dtype", "kv_cache_dtype") and a is not None:
            assert _name(a) == np.dtype(b).name, f.name
        else:
            assert a == b, f.name
    assert get_config("granite-8b", smoke=which == "SMOKE") is mine
    assert (mine.n_heads // mine.n_kv_heads, mine.hd) == ((4, 128) if which == "FULL" else (2, 16))


# ---------------------------------------------------------------------------
# The model and engines with int8 weights against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["granite-8b", "qwen1.5-32b"])
def qweights(request):
    """JAX and port configs (``weights_int8``) and int8 trees of one arch:
    JAX's quantize_params of its f32 smoke init, carried by the bridge."""
    jcfg, tree = _j_tree(request.param)
    jcfg = jcfg.replace(weights_int8=True)
    tcfg = get_config(request.param, smoke=True).replace(attn_chunk=64, weights_int8=True)
    jparams = j_quantize_params(jax.tree.map(jnp.asarray, tree))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    assert is_quant(tparams["unembed"]) and is_quant(tparams["blocks"]["l0_ffn"]["w2"])
    return jcfg, tcfg, jparams, tparams


def _logits_j(jparams, h):
    return np.asarray(j_qeinsum("bsd,dv->bsv", h, jparams["unembed"]), np.float32)


def _close(jh, th, jparams, tparams, tcfg, n=None):
    t = get_model(tcfg).logits(tparams, th).numpy()
    d = np.max(np.abs(_logits_j(jparams, jh)[:, :n] - t[:, :n]))
    assert d < TOL["float32"], d
    return t


def test_whole_sequence_and_dense_paths_match_jax(qweights):
    """The whole-sequence forward; slot 0 prefilled whole (11 tokens padded
    to 16), slot 1 in chunks of 8 at offsets 0, 8, 16; two batched decode
    steps; a 5-token verify of slot 1 at 22. Logits within f32 2e-5."""
    jcfg, tcfg, jparams, tparams = qweights
    rng = np.random.default_rng(3)
    toks = rng.integers(1, tcfg.vocab_size, (2, 13)).astype(np.int32)
    jh, _, _ = jtf.forward(jcfg, None, jparams, tokens=jnp.asarray(toks),
                           positions=jnp.asarray(np.tile(np.arange(13, dtype=np.int32), (2, 1))),
                           mode="train")
    _close(jh, get_model(tcfg).hidden(tparams, toks), jparams, tparams, tcfg)

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
    last0 = int(np.argmax(_close(jh, th, jparams, tparams, tcfg, 11)[0, 10]))

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
        _close(jh, th, jparams, tparams, tcfg, len(piece))

    lens = np.array([11, 20, 0], np.int32)
    last = np.array([last0, 7, 0], np.int32)
    for _ in range(2):
        jh, jcache, _ = jtf.forward(jcfg, None, jparams, tokens=jnp.asarray(last[:, None]),
                                    positions=jnp.asarray(lens[:, None]), mode="decode",
                                    cache=jcache, cache_index=jnp.asarray(lens))
        th, tcache = ttf.forward(tcfg, tparams, torch.from_numpy(last[:, None]).long(),
                                 torch.from_numpy(lens[:, None]), mode="decode", cache=tcache,
                                 cache_index=torch.from_numpy(lens))
        t = _close(jh[:2], th[:2], jparams, tparams, tcfg)
        last = np.concatenate([np.argmax(t[:, 0], -1), [0]]).astype(np.int32)
        lens = lens + np.array([1, 1, 0], np.int32)

    off = int(lens[1])
    toks = np.array([[int(last[1]), 3, 1, 4, 1]], np.int32)
    pos = np.arange(off, off + 5, dtype=np.int32)[None]
    jh, _, _, _ = jtf.forward(jcfg, None, jparams, tokens=jnp.asarray(toks), positions=jnp.asarray(pos),
                              mode="prefill", cache=mini(1), chunk_state=jtf.init_chunk_state(jcfg),
                              cache_index=jattn.ChunkPrefillIndex(jnp.asarray(off, jnp.int32)))
    th, _ = ttf.forward(tcfg, tparams, torch.from_numpy(toks).long(), torch.from_numpy(pos),
                        mode="prefill", cache=view(1), cache_index=tattn.ChunkPrefillIndex(off))
    _close(jh, th, jparams, tparams, tcfg)


def test_paged_paths_match_jax(qweights):
    """On int8 pools with chained tables: one sequence prefilled whole, one
    in three chunks, two batched decode steps over four slots (two dead),
    then a 4-token verify at a mid-page offset. Logits within f32 2e-5."""
    jcfg, tcfg, jparams, tparams = qweights
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
    last0 = int(np.argmax(_close(jh, th, jparams, tparams, tcfg, 11)[0, 10]))

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
        _close(jh, th, jparams, tparams, tcfg, len(piece))

    # chained tables, 2 entries a table page: l2 row 0 is the null row
    l2 = np.array([[0, 0], [1, 2], [3, 0], [4, 5], [6, 7]], np.int32)
    tab = np.array([[1, 2, 0], [3, 4, 0], [0, 0, 0], [0, 0, 0]], np.int32)
    lens = np.array([11, 20, 0, 0], np.int32)
    last = np.array([last0, 7, 0, 0], np.int32)
    for _ in range(2):
        jidx = jattn.PagedIndex(jnp.asarray(lens), jnp.asarray(tab), jnp.asarray(l2))
        tidx = tattn.PagedIndex(torch.from_numpy(lens), torch.from_numpy(tab), torch.from_numpy(l2))
        jh, jcache, _ = jtf.forward(jcfg, None, jparams, tokens=jnp.asarray(last[:, None]),
                                    positions=jnp.asarray(lens[:, None]), mode="decode",
                                    cache=jcache, cache_index=jidx)
        th, tcache = ttf.forward(tcfg, tparams, torch.from_numpy(last[:, None]).long(),
                                 torch.from_numpy(lens[:, None]), mode="decode", cache=tcache,
                                 cache_index=tidx)
        t = _close(jh[:2], th[:2], jparams, tparams, tcfg)
        last = np.concatenate([np.argmax(t[:, 0], -1), [0, 0]]).astype(np.int32)
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
    _close(jh, th, jparams, tparams, tcfg)


@pytest.mark.parametrize("engine", ["dense_whole_prompt", "paged_bf16_chunk16", "paged_int8_chained"])
def test_engine_greedy_streams_match_jax(qweights, engine):
    """The port's dense and paged engines with int8 weights emit the JAX
    engines' greedy streams on the same quantized tree: prompts shorter than
    a page, across pages and longer than a chunk, more prompts than slots."""
    jcfg, tcfg, jparams, tparams = qweights
    prompts = [[int(x) for x in np.random.default_rng(40 + i).integers(1, tcfg.vocab_size, n)]
               for i, n in enumerate([5, 19, 30, 8])]
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


def test_weight_int8_engine_greedy_parity():
    """The twin of test_perf_variants.py's test of that name: smollm SMOKE,
    the engine on quantize_params of the engine's own weights keeps the
    float engine's first three tokens, and gives the JAX int8 engine's
    stream on the same quantized tree."""
    cfg = get_config("smollm-360m", smoke=True).replace(attn_chunk=64)
    ecfg = EngineConfig(max_slots=1, max_len=48, max_new_tokens=5)
    base = InferenceEngine(cfg, ecfg, device="cpu")
    qcfg = cfg.replace(weights_int8=True)
    qparams = quantize_params(base.params)
    quant = InferenceEngine(qcfg, ecfg, params=qparams, device="cpu")
    s0 = base.generate([[1, 2, 3, 4, 5]])[0]
    s1 = quant.generate([[1, 2, 3, 4, 5]])[0]
    assert s0.out[:3] == s1.out[:3]

    def to_np(t):
        return t.view(torch.int16).numpy().view(jnp.bfloat16) if t.dtype == torch.bfloat16 else t.numpy()

    jq = jax.tree.map(lambda a: jnp.asarray(to_np(a)), qparams)
    jcfg = j_get_config("smollm-360m", smoke=True).replace(attn_chunk=64, weights_int8=True)
    j = JInferenceEngine(jcfg, JEngineConfig(max_slots=1, max_len=48, max_new_tokens=5), params=jq)
    assert j.generate([[1, 2, 3, 4, 5]])[0].out == s1.out
