"""The VLM family in the port (qwen2-vl-2b: ``EmbedsLM``, M-RoPE) against the
JAX package on the CPU, and the decoder's ``prefill`` taking a caller's
positions.

Models in f32 on the same weights, bridged with ``params_from_jax``; JAX
inits the q/k/v biases to zeros, so the tests draw them from a seeded
standard normal into both trees. Held to f32 2e-5: logits of the decoder's
dense and paged prefill under positions that are not ``arange`` (smollm
SMOKE), and of qwen2-vl-2b SMOKE's image prompt through ``EmbedsLM.prefill``
and the decode steps after it. The image prompt's tokens share one temporal
index, which the JAX package masks by (``self_attention``'s ``pos_t``): the
index-masked flash kernel would give other logits there, so this test fails
if the port takes it. ``apply_mrope`` is held to JAX's at f32 2e-5 and bf16
2e-2, ``mrope_positions_with_image`` equal as integers. Greedy streams of
the port's paged engine (whole-prompt and chunked) and dense chunked engine
equal the JAX engines' on text prompts; the dense whole-prompt engine fails
in both packages, since ``EmbedsLM.prefill`` wants embeddings."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import qwen2_vl_2b as j_qwen2_vl  # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.common import unembed_weight as j_unembed_weight  # noqa: E402
from repro.models.quant import qeinsum as j_qeinsum  # noqa: E402
from repro.models.rotary import apply_mrope as j_apply_mrope  # noqa: E402
from repro.models.vlm import mrope_positions_with_image as j_mrope_positions_with_image  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.engine import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serving.engine import PagedEngineConfig as JPagedEngineConfig  # noqa: E402
from repro.serving.engine import PagedInferenceEngine as JPagedInferenceEngine  # noqa: E402
from repro_torch.configs import qwen2_vl_2b  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import EmbedsLM, ModelConfig, get_model  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402
from repro_torch.models.loss import logits as t_logits  # noqa: E402
from repro_torch.models.rotary import apply_mrope, apply_rope, mrope_positions_for, positions_for  # noqa: E402
from repro_torch.models.vlm import mrope_positions_with_image  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    EngineConfig,
    InferenceEngine,
    PagedEngineConfig,
    PagedInferenceEngine,
)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}      # tests/test_kernels.py:17
NP, PS = 16, 8


def _weights(arch: str):
    """JAX and port SMOKE configs and f32 weights of ``arch``, every bias
    drawn from a seeded standard normal into both trees."""
    jcfg, tcfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    tree = jax.tree.map(np.asarray, j_get_model(jcfg).init(jax.random.PRNGKey(0)))
    mixer = tree["blocks"]["l0_mixer"]
    rng = np.random.default_rng(5)
    for name in ("bq", "bk", "bv"):
        if name in mixer:
            assert not mixer[name].any()                  # JAX's init: zeros
            mixer[name] = rng.standard_normal(mixer[name].shape).astype(np.float32)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), params_from_jax(tree, tcfg, "cpu")


@pytest.fixture(scope="module")
def vlm():
    return _weights("qwen2-vl-2b")


@pytest.fixture
def logits_out(monkeypatch):
    """Both packages' ``prefill`` and ``decode`` return the last position's
    f32 logits (B, V) in place of the greedy token."""
    monkeypatch.setattr(japi, "next_tokens", lambda cfg, ctx, params, h: j_qeinsum(
        "bd,dv->bv", h[:, -1], j_unembed_weight(cfg, params)).astype(jnp.float32))
    monkeypatch.setattr(tapi, "next_tokens", lambda cfg, params, h: t_logits(cfg, params, h[:, -1]))


def _close(j, t, tol=TOL["float32"]):
    d = float(np.max(np.abs(np.asarray(j, np.float32) - t.float().numpy())))
    assert d < tol, d
    return d


# ---------------------------------------------------------------------------
# The decoder's prefill takes the caller's positions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_prefill_takes_the_callers_positions(logits_out, layout):
    """smollm SMOKE: ``prefill`` (two rows, one shifted by 5, one with
    repeated positions) and ``prefill_paged`` (one row, repeated and
    shifted) under the caller's positions, right-padded: logits within f32
    2e-5 of JAX's, whose prefill honours ``batch["positions"]``."""
    jcfg, tcfg, jparams, tparams = _weights("smollm-360m")
    rng = np.random.default_rng(1)
    S = 16
    if layout == "dense":
        toks = rng.integers(1, tcfg.vocab_size, (2, S)).astype(np.int32)
        pos = np.stack([np.arange(S) + 5, 3 * (np.arange(S) // 2)]).astype(np.int32)
        batch = {"tokens": toks, "positions": pos, "n_valid": np.array([S, 13], np.int32)}
        want, _ = j_get_model(jcfg).prefill(None, jparams, {k: jnp.asarray(v) for k, v in batch.items()})
        got, _ = get_model(tcfg).prefill(tparams, batch)
    else:
        toks = np.zeros((1, S), np.int32)
        toks[0, :11] = rng.integers(1, tcfg.vocab_size, 11)
        pos = (np.arange(S) // 2 + 3)[None].astype(np.int32)
        row = np.array([1, 2, 3, 0], np.int32)
        batch = {"tokens": toks, "positions": pos, "n_valid": np.array([11], np.int32), "tab_row": row,
                 "slot": 0}
        want, _ = j_get_model(jcfg).prefill_paged(None, jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                                                  jtf.init_paged_cache(jcfg, 1, NP, PS))
        got, _ = get_model(tcfg).prefill_paged(tparams, batch, get_model(tcfg).init_paged_cache(NP, PS, "cpu"))
    _close(want, got)
    # the caller's positions matter: the standard ones give other logits
    del batch["positions"]
    if layout == "dense":
        other, _ = get_model(tcfg).prefill(tparams, batch)
    else:
        other, _ = get_model(tcfg).prefill_paged(tparams, batch, get_model(tcfg).init_paged_cache(NP, PS, "cpu"))
    assert float((other - got).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sections", [(2, 3, 3), (16, 24, 24)])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_apply_mrope_matches_jax(sections, dt):
    """``apply_mrope`` on x (2, 24, 3, hd) at an image prompt's positions
    plus an offset of up to 4000, within f32 2e-5 and bf16 2e-2 of JAX's."""
    hd = 2 * sum(sections)
    rng = np.random.default_rng(sum(sections))
    x = rng.standard_normal((2, 24, 3, hd)).astype(np.float32)
    pos = np.asarray(j_mrope_positions_with_image(2, 24, 4, 4, 4)) + rng.integers(0, 4000, (3, 2, 1))
    jdt, tdt = (jnp.float32, torch.float32) if dt == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = j_apply_mrope(jnp.asarray(x).astype(jdt), jnp.asarray(pos, jnp.int32), 1e6, sections)
    got = apply_mrope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos.astype(np.int32)), 1e6, sections)
    assert got.dtype == tdt
    _close(jnp.asarray(want, jnp.float32), got, TOL[dt])


@pytest.mark.parametrize("case", [(1, 10, 0, 2, 3), (2, 24, 4, 4, 4), (3, 40, 7, 3, 5), (2, 16, 0, 4, 4)])
def test_mrope_positions_with_image_equal_jax(case):
    """The (3, B, S) streams equal JAX's as int32, with and without a
    trailing text span; an image past the sequence raises."""
    got = mrope_positions_with_image(*case)
    want = np.asarray(j_mrope_positions_with_image(*case))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        mrope_positions_with_image(1, 8, 2, 3, 3)


def test_text_only_mrope_equals_rope():
    """Text-only M-RoPE (three equal streams) is RoPE, bit for bit, at any
    offset."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 9, 4, 128)).astype(np.float32))
    for off in (0, 7, 3000):
        a = apply_mrope(x, mrope_positions_for(2, 9, off), 1e6, (16, 24, 24))
        b = apply_rope(x, positions_for(2, 9, off), 1e6)
        assert torch.equal(a, b)
    assert mrope_positions_for(2, 9, 4).shape == (3, 2, 9)


# ---------------------------------------------------------------------------
# EmbedsLM: an image prompt, then decode
# ---------------------------------------------------------------------------


def test_embeds_prefill_with_an_image_then_decode_match_jax(vlm, logits_out):
    """``EmbedsLM.prefill`` of two seeded embedding prompts of 24 tokens, a 4
    x 4 image at 4, positions from ``mrope_positions_with_image``; then four
    decode steps, two at a scalar ``cache_index`` and two at per-slot
    ``lengths``: logits within f32 2e-5 of the JAX jnp path's at every step.
    The image's bidirectional attention matters: text-only positions give
    other logits."""
    jcfg, tcfg, jparams, tparams = vlm
    B, S, CAP = 2, 24, 32
    emb = np.random.default_rng(2).standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    pos = mrope_positions_with_image(B, S, 4, 4, 4)
    jmodel, tmodel = j_get_model(jcfg), get_model(tcfg)
    assert isinstance(tmodel, EmbedsLM) and type(jmodel).__name__ == "EmbedsLM"
    want, jcache = jmodel.prefill(None, jparams, {"inputs_embeds": jnp.asarray(emb),
                                                  "positions": jnp.asarray(pos.numpy())}, cap=CAP)
    got, tcache = tmodel.prefill(tparams, {"inputs_embeds": torch.from_numpy(emb), "positions": pos}, cap=CAP)
    _close(want, got)
    text, _ = tmodel.prefill(tparams, {"inputs_embeds": torch.from_numpy(emb)}, cap=CAP)
    assert float((text - got).abs().max()) > 1e-3
    for j in range(4):
        tok = got.argmax(-1).to(torch.int32)[:, None]
        jb = {"token": jnp.asarray(tok.numpy()), "cache_index": jnp.asarray(S + j, jnp.int32)}
        tb = {"token": tok, "cache_index": S + j}
        if j >= 2:
            lens = np.full(B, S + j, np.int32)
            jb["lengths"], tb = jnp.asarray(lens), {"token": tok, "lengths": lens}
        want, jcache = jmodel.decode(None, jparams, jcache, jb)
        got, tcache = tmodel.decode(tparams, tcache, tb)
        _close(want, got)


# ---------------------------------------------------------------------------
# Engines on text prompts
# ---------------------------------------------------------------------------


def _prompts(vocab: int, lens):
    rng = np.random.default_rng(11)
    return [rng.integers(1, vocab, n).tolist() for n in lens]


@pytest.mark.parametrize("engine", ["paged-whole", "paged-chunked", "dense-chunked"])
def test_engine_greedy_streams_match_jax(vlm, engine):
    """qwen2-vl-2b's text prompts through the port's paged engine
    (whole-prompt and 16-token chunks) and dense chunked engine: the JAX
    engines' greedy streams, more prompts than slots."""
    jcfg, tcfg, jparams, tparams = vlm
    prompts = _prompts(tcfg.vocab_size, [5, 19, 30, 8])
    if engine.startswith("dense"):
        kw = dict(max_slots=3, max_len=64, max_new_tokens=6, chunk_tokens=16)
        j = JInferenceEngine(jcfg, JEngineConfig(**kw), params=jparams)
        t = InferenceEngine(tcfg, EngineConfig(**kw), params=tparams, device="cpu")
    else:
        kw = dict(page_size=PS, num_pages=33, max_slots=3, max_seq_len=64, max_new_tokens=6,
                  chunk_tokens=16 if engine.endswith("chunked") else 0)
        j = JPagedInferenceEngine(jcfg, JPagedEngineConfig(**kw), params=jparams)
        t = PagedInferenceEngine(tcfg, PagedEngineConfig(**kw), params=tparams, device="cpu")
    want = [s.out for s in j.generate(prompts)]
    got = [s.out for s in t.generate(prompts)]
    assert got == want


def test_dense_whole_prompt_engine_fails_in_both(vlm):
    """The dense engine's whole-prompt prefill hands ``EmbedsLM.prefill``
    tokens, where it wants ``inputs_embeds``: KeyError in both packages."""
    jcfg, tcfg, jparams, tparams = vlm
    kw = dict(max_slots=2, max_len=32, max_new_tokens=4)
    with pytest.raises(KeyError, match="inputs_embeds"):
        JInferenceEngine(jcfg, JEngineConfig(**kw), params=jparams).generate([[1, 2, 3]])
    with pytest.raises(KeyError, match="inputs_embeds"):
        InferenceEngine(tcfg, EngineConfig(**kw), params=tparams, device="cpu").generate([[1, 2, 3]])


# ---------------------------------------------------------------------------
# The config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["FULL", "SMOKE"])
def test_qwen2_vl_config_field_for_field(which):
    """Every field of the port's ModelConfig equals JAX's qwen2-vl-2b (dtypes
    by name); JAX's training-only fields (remat, ce_chunks) have no twin."""
    mine, theirs = getattr(qwen2_vl_2b, which), getattr(j_qwen2_vl, which)
    for f in dataclasses.fields(ModelConfig):
        a, b = getattr(mine, f.name), getattr(theirs, f.name)
        if f.name in ("param_dtype", "compute_dtype", "kv_cache_dtype") and a is not None:
            assert str(a).replace("torch.", "") == np.dtype(b).name, f.name
        else:
            assert a == b, f.name
    assert get_config("qwen2-vl-2b", smoke=which == "SMOKE") is mine
    if which == "FULL":        # the stub vision tower has no weights
        assert _count(get_model(mine).param_defs()) == 1_777_088_000


def _count(defs) -> int:
    if isinstance(defs, dict):
        return sum(_count(v) for v in defs.values())
    return int(np.prod(defs.shape))


def test_launcher_serves_text_prompts():
    """``--arch qwen2-vl-2b`` serves through the launcher's dense engines
    with its default 32-token chunks, as the JAX launcher does: 8 requests,
    0 failures."""
    from repro_torch.launch import serve

    r = serve.main(["--arch", "qwen2-vl-2b", "--smoke", "--device", "cpu", "--requests", "8", "--workers", "2"])
    m = r["metrics"].summary()
    assert (m["total"], m["failed"]) == (8, 0)
    assert all(len(out) == 8 for out in r["results"].values())
