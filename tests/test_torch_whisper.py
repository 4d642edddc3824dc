"""The whisper family in the port (whisper-large-v3: ``EncDecLM``, layernorm,
the plain GELU MLP, cross-attention) against the JAX package on the CPU.

whisper-large-v3 SMOKE in f32 on the same weights, bridged with
``params_from_jax`` (a {"decoder", "encoder"} tree). JAX inits every
layernorm bias to zeros, which would leave ``b`` untested, so the tests draw
them from a seeded standard normal into both trees. Held to f32 2e-5:
``layernorm``, the MLP, ``cross_kv`` and ``cross_attention``, ``encode``,
and the logits of ``EncDecLM.prefill`` (right-padded too) and of the decode
steps after it. The engines refuse the family where the JAX engines do:
no paged cache for cross-attention, no chunked prefill, no speculation, and
the dense whole-prompt prefill has no frames."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import whisper_large_v3 as j_whisper  # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import whisper as jwh  # noqa: E402
from repro.models.common import layernorm as j_layernorm  # noqa: E402
from repro.models.common import unembed_weight as j_unembed_weight  # noqa: E402
from repro.models.mlp import mlp as j_mlp  # noqa: E402
from repro.models.quant import qeinsum as j_qeinsum  # noqa: E402
from repro.models.quant import quantize_params as j_quantize_params  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.engine import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serving.engine import PagedEngineConfig as JPagedEngineConfig  # noqa: E402
from repro.serving.engine import PagedInferenceEngine as JPagedInferenceEngine  # noqa: E402
from repro_torch.configs import whisper_large_v3  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import EncDecLM, ModelConfig, get_model  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import whisper as twh  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402
from repro_torch.models.common import layernorm  # noqa: E402
from repro_torch.models.loss import logits as t_logits  # noqa: E402
from repro_torch.models.mlp import mlp  # noqa: E402
from repro_torch.models.quant import check_int8_family  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    EngineConfig,
    InferenceEngine,
    PagedEngineConfig,
    PagedInferenceEngine,
)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}      # tests/test_kernels.py:17
PROMPT = [3, 1, 4, 1, 5, 9, 2]


def _normal_biases(tree, rng):
    """Every layernorm bias ``b`` of a numpy tree, drawn standard normal."""
    for key, node in tree.items():
        if isinstance(node, dict):
            _normal_biases(node, rng)
        elif key == "b":
            assert not node.any()                         # JAX's init: zeros
            tree[key] = rng.standard_normal(node.shape).astype(np.float32)


@pytest.fixture(scope="module")
def whisper():
    jcfg, tcfg = j_get_config("whisper-large-v3", smoke=True), get_config("whisper-large-v3", smoke=True)
    tree = jax.tree.map(np.asarray, j_get_model(jcfg).init(jax.random.PRNGKey(0)))
    _normal_biases(tree, np.random.default_rng(5))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), params_from_jax(tree, tcfg, "cpu"), tree


@pytest.fixture
def logits_out(monkeypatch):
    """Both packages' ``prefill`` and ``decode`` return the last position's
    f32 logits (B, V) in place of the greedy token."""
    monkeypatch.setattr(japi, "next_tokens", lambda cfg, ctx, params, h: j_qeinsum(
        "bd,dv->bv", h[:, -1], j_unembed_weight(cfg, params)).astype(jnp.float32))
    monkeypatch.setattr(tapi, "next_tokens", lambda cfg, params, h: t_logits(cfg, params, h[:, -1]))


def _close(j, t, tol=TOL["float32"]):
    d = float(np.max(np.abs(np.asarray(jnp.asarray(j, jnp.float32)) - t.float().numpy())))
    assert d < tol, d
    return d


def _frames(cfg, B, seed=1):
    return np.random.default_rng(seed).standard_normal((B, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)


def _layer(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# The pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_layernorm_matches_jax(dt):
    """``layernorm`` (eps 1e-5, statistics in f32) within f32 2e-5 and bf16
    2e-2 of JAX's, on rows with a large mean."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 7, 64)) * 3 + 5).astype(np.float32)
    w, b = rng.standard_normal(64).astype(np.float32), rng.standard_normal(64).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dt == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = j_layernorm(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt), jnp.asarray(b).astype(jdt))
    got = layernorm(*(torch.from_numpy(a).to(tdt) for a in (x, w, b)))
    assert got.dtype == tdt
    _close(want, got, TOL[dt])


def test_gelu_mlp_matches_jax(whisper):
    """The plain (non-gated) MLP with tanh GELU, ``jax.nn.gelu``'s default:
    w1 and w2 only, within f32 2e-5 of JAX's on layer 1's weights."""
    jcfg, tcfg, jparams, tparams, _ = whisper
    assert set(tparams["decoder"]["blocks"]["l0_ffn"]) == {"w1", "w2"}
    x = np.random.default_rng(3).standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
    jp = _layer(jparams["decoder"]["blocks"]["l0_ffn"], 1)
    tp = {k: v[1] for k, v in tparams["decoder"]["blocks"]["l0_ffn"].items()}
    _close(j_mlp(jcfg, jp, jnp.asarray(x)), mlp(tcfg, tp, torch.from_numpy(x)))


def test_cross_kv_and_cross_attention_match_jax(whisper):
    """``cross_kv`` of an encoder output (2, 12, d) and ``cross_attention``
    of 5 decoder positions over it, within f32 2e-5 of JAX's; the
    cross-attention projections have KV = H, also where the config's self
    attention groups heads."""
    jcfg, tcfg, jparams, tparams, _ = whisper
    rng = np.random.default_rng(4)
    enc = rng.standard_normal((2, tcfg.encoder.n_ctx, tcfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
    jp = _layer(jparams["decoder"]["blocks"]["l0_cross"])
    tp = {k: v[0] for k, v in tparams["decoder"]["blocks"]["l0_cross"].items()}
    jkv, tkv = jattn.cross_kv(jcfg, jp, jnp.asarray(enc)), tattn.cross_kv(tcfg, tp, torch.from_numpy(enc))
    for name in ("k", "v"):
        assert tkv[name].shape == (2, tcfg.encoder.n_ctx, tcfg.n_heads, tcfg.hd)
        _close(jkv[name], tkv[name])
    _close(jattn.cross_attention(jcfg, jp, jnp.asarray(x), jkv), tattn.cross_attention(tcfg, tp, torch.from_numpy(x), tkv))
    grouped = get_config("qwen2-vl-2b", smoke=True)
    jgrouped = j_get_config("qwen2-vl-2b", smoke=True)
    for cross in (False, True):
        mine = {k: d.shape for k, d in tattn.attention_defs(grouped, cross=cross).items()}
        theirs = {k: d.shape for k, d in jattn.attention_defs(jgrouped, cross=cross).items()}
        assert mine == theirs
    assert mine["wk"] == (grouped.d_model, grouped.n_heads * grouped.hd)


def test_encode_matches_jax(whisper):
    """The bidirectional encoder (no position encoding, final layernorm)
    over seeded frames (2, 12, d), within f32 2e-5 of JAX's ``encode``."""
    jcfg, tcfg, jparams, tparams, _ = whisper
    frames = _frames(tcfg, 2)
    _close(jwh.encode(jcfg, None, jparams, jnp.asarray(frames)), twh.encode(tcfg, tparams, torch.from_numpy(frames)))


# ---------------------------------------------------------------------------
# EncDecLM
# ---------------------------------------------------------------------------


def test_encdec_prefill_and_decode_logits_match_jax(whisper, logits_out):
    """``EncDecLM.prefill`` of two 7-token prompts over seeded frames, then
    three decode steps at a scalar ``cache_index``: logits within f32 2e-5
    of JAX's at every step, and the cached cross K/V equal to JAX's."""
    jcfg, tcfg, jparams, tparams, _ = whisper
    jmodel, tmodel = j_get_model(jcfg), get_model(tcfg)
    assert isinstance(tmodel, EncDecLM) and type(jmodel).__name__ == "EncDecLM"
    frames = _frames(tcfg, 2)
    toks = np.random.default_rng(6).integers(1, tcfg.vocab_size, (2, 7)).astype(np.int32)
    want, jcache = jmodel.prefill(None, jparams, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}, cap=16)
    got, tcache = tmodel.prefill(tparams, {"tokens": toks, "frames": torch.from_numpy(frames)}, cap=16)
    _close(want, got)
    for name in ("k", "v"):
        _close(jcache["blocks"]["l0_cross"][name], tcache["blocks"]["l0_cross"][name])
    for j in range(3):
        tok = got.argmax(-1).to(torch.int32)[:, None]
        want, jcache = jmodel.decode(None, jparams, jcache, {"token": jnp.asarray(tok.numpy()),
                                                            "cache_index": jnp.asarray(7 + j, jnp.int32)})
        got, tcache = tmodel.decode(tparams, tcache, {"token": tok, "cache_index": 7 + j})
        _close(want, got)


def test_padded_prefill_matches_unpadded_encdec(whisper, logits_out):
    """The n_valid contract holds for enc-dec too (the twin of the JAX
    package's test of that name): decoder pads are masked and the logits
    come from the last valid position, equal to the unpadded prefill's and
    to JAX's padded prefill's, within f32 2e-5."""
    jcfg, tcfg, jparams, tparams, _ = whisper
    model = get_model(tcfg)
    n, frames = len(PROMPT), torch.from_numpy(_frames(tcfg, 1))
    unpadded, _ = model.prefill(tparams, {"tokens": [PROMPT], "frames": frames}, cap=32)
    padded = np.zeros((1, 16), np.int32)
    padded[0, :n] = PROMPT
    batch = {"tokens": padded, "frames": frames, "n_valid": np.array([n], np.int32)}
    got, _ = model.prefill(tparams, batch, cap=32)
    assert float((got - unpadded).abs().max()) < TOL["float32"]
    want, _ = j_get_model(jcfg).prefill(None, jparams, {"tokens": jnp.asarray(padded), "frames": jnp.asarray(frames.numpy()),
                                                        "n_valid": jnp.asarray([n])}, cap=32)
    _close(want, got)


def test_bridge_carries_the_nested_tree(whisper):
    """The {"decoder", "encoder"} tree crosses leaf for leaf with the
    shapes of ``EncDecLM.param_defs``; a missing or an extra key raises
    KeyError, a wrong shape ValueError."""
    jcfg, tcfg, jparams, tparams, tree = whisper
    assert set(tparams) == {"decoder", "encoder"}
    assert set(tparams["encoder"]) == {"blocks", "final_norm"}
    np.testing.assert_array_equal(tparams["encoder"]["final_norm"]["b"].numpy(), tree["encoder"]["final_norm"]["b"])
    np.testing.assert_array_equal(tparams["decoder"]["blocks"]["l0_cross_norm"]["b"].numpy(),
                                  tree["decoder"]["blocks"]["l0_cross_norm"]["b"])
    for mutate, exc in ((lambda t: t["encoder"]["blocks"].pop("l0_ffn"), KeyError),
                        (lambda t: t["decoder"]["blocks"]["l0_cross"].update(bq=np.zeros(64, np.float32)), KeyError),
                        (lambda t: t.update(extra={}), KeyError),
                        (lambda t: t["encoder"].update(final_norm={"w": np.ones(64, np.float32)}), KeyError),
                        (lambda t: t["decoder"].update(embedding=np.zeros((3, 64), np.float32)), ValueError)):
        broken = jax.tree.map(lambda a: a, tree)
        mutate(broken)
        with pytest.raises(exc):
            params_from_jax(broken, tcfg, "cpu")


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test compares what each package raises
        return type(e), str(e)
    return None


def test_engine_guards_raise_where_jax_raises(whisper):
    """Both packages refuse whisper in the same places, with the same
    exception and message: the paged engine (no paged cross-attention;
    the prefix cache), chunked prefill on either engine, speculation, and
    the dense whole-prompt prefill, which has no frames (KeyError)."""
    jcfg, tcfg, jparams, tparams, _ = whisper
    paged = dict(page_size=8, num_pages=33, max_slots=2, max_seq_len=64, max_new_tokens=4)
    dense = dict(max_slots=2, max_len=32, max_new_tokens=4)
    cases = [("paged", paged), ("paged", dict(paged, prefix_cache=True)), ("paged", dict(paged, chunk_tokens=16)),
             ("dense", dict(dense, chunk_tokens=16)), ("dense", dict(dense, spec_tokens=2)), ("dense", dense)]
    for kind, kw in cases:
        if kind == "paged":
            theirs = _raised(lambda: JPagedInferenceEngine(jcfg, JPagedEngineConfig(**kw), params=jparams).generate([[1, 2]]))
            mine = _raised(lambda: PagedInferenceEngine(tcfg, PagedEngineConfig(**kw), params=tparams,
                                                        device="cpu").generate([[1, 2]]))
        else:
            theirs = _raised(lambda: JInferenceEngine(jcfg, JEngineConfig(**kw), params=jparams).generate([[1, 2]]))
            mine = _raised(lambda: InferenceEngine(tcfg, EngineConfig(**kw), params=tparams,
                                                   device="cpu").generate([[1, 2]]))
        assert theirs is not None and mine == theirs, (kind, kw, mine, theirs)


# ---------------------------------------------------------------------------
# The config
# ---------------------------------------------------------------------------


def _count(defs) -> int:
    if isinstance(defs, dict):
        return sum(_count(v) for v in defs.values())
    return int(np.prod(defs.shape))


@pytest.mark.parametrize("which", ["FULL", "SMOKE"])
def test_whisper_config_field_for_field(which):
    """Every field of the port's ModelConfig equals JAX's whisper-large-v3
    (dtypes by name, the encoder field for field); JAX's training-only
    fields (remat, ce_chunks) have no twin. Weight-only int8 of the family
    (and of qwen2-vl-2b) passes ``check_int8_family``; at SMOKE size the
    port's quantized init equals JAX's ``quantize_params`` of the port's
    floating-point init, bit for bit."""
    mine, theirs = getattr(whisper_large_v3, which), getattr(j_whisper, which)
    for f in dataclasses.fields(ModelConfig):
        a, b = getattr(mine, f.name), getattr(theirs, f.name)
        if f.name in ("param_dtype", "compute_dtype", "kv_cache_dtype") and a is not None:
            assert str(a).replace("torch.", "") == np.dtype(b).name, f.name
        elif f.name == "encoder":
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b, f.name
    assert get_config("whisper-large-v3", smoke=which == "SMOKE") is mine
    if which == "FULL":
        assert _count(get_model(mine).param_defs()) == 1_601_198_080
    for arch in ("whisper-large-v3", "qwen2-vl-2b"):
        cfg = get_config(arch, smoke=which == "SMOKE")
        check_int8_family(cfg)
        if which == "SMOKE":
            floats = get_model(cfg).init(torch.Generator().manual_seed(3))
            got = get_model(cfg.replace(weights_int8=True)).init(torch.Generator().manual_seed(3))
            want = j_quantize_params(jax.tree.map(lambda t: jnp.asarray(t.numpy()), floats))
            n = 0
            for path, leaf in jax.tree_util.tree_leaves_with_path(want):
                mine = got
                for k in path:
                    mine = mine[k.key]
                a = np.asarray(leaf)
                b = mine.view(torch.int16).numpy().view(np.uint16) if mine.dtype == torch.bfloat16 else mine.numpy()
                assert np.array_equal(a.view(np.uint16) if a.dtype.name == "bfloat16" else a, b), path
                n += a.dtype == np.int8
            assert n > 0


def test_launcher_fails_at_construction_in_both(monkeypatch):
    """``--arch whisper-large-v3`` fails while the launcher builds its dense
    tiers (chunked prefill, its default, is decoder-only), in both
    packages, with the same exception and message."""
    import sys

    from repro.launch import serve as jserve
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "whisper-large-v3"])
    theirs = _raised(jserve.main)
    mine = _raised(lambda: serve.main(["--arch", "whisper-large-v3", "--smoke", "--device", "cpu"]))
    assert theirs is not None and mine == theirs == (ValueError, "chunked prefill is decoder-only (no enc-dec support)")
