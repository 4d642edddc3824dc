"""Weight-only int8 of the MoE (dbrx-132b, llama4-maverick), hybrid
(jamba-1.5-large), VLM (qwen2-vl-2b) and encoder-decoder (whisper-large-v3)
families in the port, against the JAX package on the CPU.

The batched ``qeinsum`` (the expert products "ecd,edf->ecf" and
"ecf,efd->ecd" on a 3-D int8 weight with (E, 1, f) scales) within f32 2e-5
and bf16 2e-2 of JAX's. JAX's ``quantize_params`` of each family's SMOKE
tree, carried by the bridge, equals the port's ``quantize_params`` of the
bridged floating-point tree bit for bit (stacked expert leaves (n_sb, E, d,
f) with scales (n_sb, E, 1, f), the encoder's and cross-attention's
projections); the port's ``weights_int8`` init equals ``quantize_params`` of
its floating-point init. On the bridged JAX int8 tree (every leaf the JAX
init sets to zeros, biases and Mamba's conv_b, dt_bias and A_log, drawn
standard normal), the logits of the dense and paged prefill and decode, of
qwen2-vl-2b's image prompt and of whisper's prefill and decode are within
f32 2e-5 of JAX's; the dense and paged engines' greedy streams of dbrx and
jamba equal the JAX engines' on ``quantize_params`` of the same tree, at
capacity factor 8 (no drop possible, as the JAX package's engine tests run
MoE). The launcher serves these families with ``--weights-int8``; whisper
fails at construction in both packages with it, as without it.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models.common import unembed_weight as j_unembed_weight  # noqa: E402
from repro.models.quant import qeinsum as j_qeinsum  # noqa: E402
from repro.models.quant import quantize_params as j_quantize_params  # noqa: E402
from repro.models.quant import quantize_weight as j_quantize_weight  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.engine import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serving.engine import PagedEngineConfig as JPagedEngineConfig  # noqa: E402
from repro.serving.engine import PagedInferenceEngine as JPagedInferenceEngine  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402
from repro_torch.models.loss import logits as t_logits  # noqa: E402
from repro_torch.models.quant import (  # noqa: E402
    QUANT_LEAVES,
    check_int8_family,
    is_quant,
    qeinsum,
    quantize_params,
)
from repro_torch.models.vlm import mrope_positions_with_image  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    EngineConfig,
    InferenceEngine,
    PagedEngineConfig,
    PagedInferenceEngine,
)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}      # tests/test_kernels.py:17
DBRX, LLAMA4, JAMBA = "dbrx-132b", "llama4-maverick-400b-a17b", "jamba-1.5-large-398b"
VLM, WHISPER = "qwen2-vl-2b", "whisper-large-v3"
ARCHS = (DBRX, LLAMA4, JAMBA, VLM, WHISPER)
DECODERS = (DBRX, LLAMA4, JAMBA)
NP, PS = 16, 8


def _bits(t) -> np.ndarray:
    """Raw bits of a bf16 array (JAX or torch) as uint16."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def _normal_zeros(tree, rng):
    """Every leaf of a numpy tree that the JAX init sets to zeros (q/k/v and
    layernorm biases, Mamba's conv_b, dt_bias and A_log), drawn standard
    normal, so that a dropped bias moves the outputs."""
    for key, node in tree.items():
        if isinstance(node, dict):
            _normal_zeros(node, rng)
        elif not node.any():
            tree[key] = rng.standard_normal(node.shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _weights(arch: str):
    """JAX and port SMOKE configs with ``weights_int8`` (attn_chunk 64), the
    floating-point numpy tree, JAX's ``quantize_params`` of it and that
    tree carried by the bridge."""
    jcfg = j_get_config(arch, smoke=True).replace(attn_chunk=64, weights_int8=True)
    tcfg = get_config(arch, smoke=True).replace(attn_chunk=64, weights_int8=True)
    tree = jax.tree.map(np.asarray, j_get_model(jcfg).init(jax.random.PRNGKey(0)))
    _normal_zeros(tree, np.random.default_rng(5))
    jq = j_quantize_params(jax.tree.map(jnp.asarray, tree))
    return jcfg, tcfg, tree, jq, params_from_jax(jax.tree.map(np.asarray, jq), tcfg, "cpu")


def _ample(arch: str):
    """``_weights(arch)`` at capacity factor 8 (the same trees: the init does
    not read it), so that no expert drops a token."""
    jcfg, tcfg, tree, jq, tq = _weights(arch)
    return (jcfg.replace(moe=dataclasses.replace(jcfg.moe, capacity_factor=8.0)),
            tcfg.replace(moe=dataclasses.replace(tcfg.moe, capacity_factor=8.0)), tree, jq, tq)


def _walk(tree, path=""):
    if isinstance(tree, dict) and not is_quant(tree):
        for k, v in tree.items():
            yield from _walk(v, f"{path}/{k}")
    else:
        yield path, tree


@pytest.fixture
def logits_out(monkeypatch):
    """Both packages' ``prefill`` and ``decode`` return the last position's
    f32 logits (B, V) in place of the greedy token."""
    monkeypatch.setattr(japi, "next_tokens", lambda cfg, ctx, params, h: j_qeinsum(
        "bd,dv->bv", h[:, -1], j_unembed_weight(cfg, params)).astype(jnp.float32))
    monkeypatch.setattr(tapi, "next_tokens", lambda cfg, params, h: t_logits(cfg, params, h[:, -1]))


def _close(j, t, tol=TOL["float32"], rows=slice(None)):
    d = float(np.max(np.abs(np.asarray(j, np.float32)[rows] - t.float().numpy()[rows])))
    assert d < tol, d
    return d


# ---------------------------------------------------------------------------
# The batched product
# ---------------------------------------------------------------------------

PATTERNS = [("ecd,edf->ecf", (4, 6, 16), (4, 16, 24)), ("ecf,efd->ecd", (4, 6, 24), (4, 24, 16))]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PATTERNS, ids=[p[0] for p in PATTERNS])
def test_batched_qeinsum_matches_jax(case, dt):
    """x (E, C, d) against an int8 (E, d, f) with (E, 1, f) scales: JAX's
    ``qeinsum`` on the pattern within f32 2e-5 / bf16 2e-2, the f32 product
    equal to each expert's 2-D product bit for bit (the scales broadcast
    over the C rows of their own expert), and the plain branch ``x @ w``."""
    pattern, xs, ws = case
    rng = np.random.default_rng(11)
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal(ws) / np.sqrt(ws[1])).astype(np.float32)
    jdt = jnp.float32 if dt == "float32" else jnp.bfloat16
    tdt = torch.float32 if dt == "float32" else torch.bfloat16
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x).to(tdt)
    jw = j_quantize_weight(jnp.asarray(w).astype(jdt))
    tw = {"q": torch.from_numpy(np.array(jw["q"])),
          "s": torch.from_numpy(_bits(jw["s"]).view(np.int16).copy()).view(torch.bfloat16)}
    assert tuple(tw["s"].shape) == (ws[0], 1, ws[2])
    want, got = j_qeinsum(pattern, jx, jw), qeinsum(tx, tw)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape) == (xs[0], xs[1], ws[2])
    _close(jnp.asarray(want, jnp.float32), got, TOL[dt])
    per_expert = torch.stack([qeinsum(tx[e], {"q": tw["q"][e], "s": tw["s"][e]}) for e in range(xs[0])])
    assert torch.equal(got, per_expert)
    plain = torch.from_numpy(w)
    assert torch.equal(qeinsum(tx, plain), tx @ plain.to(tdt))


def test_qeinsum_refuses_a_weight_of_other_rank():
    w = {"q": torch.zeros(2, 3, 4, 5, dtype=torch.int8), "s": torch.ones(2, 3, 1, 5, dtype=torch.bfloat16)}
    with pytest.raises(ValueError, match="4 dimensions"):
        qeinsum(torch.zeros(2, 3, 6, 4), w)


# ---------------------------------------------------------------------------
# The trees: quantize_params, the bridge and the quantized init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_params_matches_jax_and_the_bridge_carries_it(arch):
    """JAX's ``quantize_params`` of the SMOKE tree, through the bridge,
    equals the port's ``quantize_params`` of the bridged float tree: the
    same leaves quantized (by key, up to the stacked 4-D expert leaves),
    int8 values equal, scales' bits equal and shaped with axis ndim - 2 at
    1; every other leaf untouched. ``check_int8_family`` lets the family
    through."""
    jcfg, tcfg, tree, jq, carried = _weights(arch)
    check_int8_family(tcfg)
    tfloat = params_from_jax(tree, tcfg.replace(weights_int8=False), "cpu")
    mine = quantize_params(tfloat)
    want = {p for p, leaf in _walk(jax.tree.map(np.asarray, jq)) if isinstance(leaf, dict)}
    assert want == {p for p, leaf in _walk(mine) if is_quant(leaf)}
    assert {p.rsplit("/", 1)[-1] for p in want} <= QUANT_LEAVES
    floats = dict(_walk(tfloat))
    ranks = set()
    for (path, a), (_, b) in zip(_walk(mine), _walk(carried)):
        if path in want:
            shape = floats[path].shape
            ranks.add(len(shape))
            assert a["q"].dtype == b["q"].dtype == torch.int8, path
            assert torch.equal(a["q"], b["q"]), path
            assert torch.equal(a["s"].view(torch.int16), b["s"].view(torch.int16)), path
            assert tuple(a["s"].shape) == tuple(b["s"].shape) == shape[:-2] + (1, shape[-1]), path
        else:
            assert a is floats[path] and torch.equal(a, b), path
    assert ranks == ({2, 3, 4} if tcfg.moe is not None else {2, 3})     # unembed, stacked, experts


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_init_is_quantize_params_of_init(arch):
    """The quantized init (``weights_int8``), drawn a (d, f) slice at a time,
    equals ``quantize_params`` of the whole-leaf init bit for bit at SMOKE
    size (the encoder-decoder's nested tree and the stacked experts
    included); the generators end in the same state."""
    cfg = get_config(arch, smoke=True)
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    want = dict(_walk(quantize_params(get_model(cfg).init(g1))))
    got = dict(_walk(get_model(cfg.replace(weights_int8=True)).init(g2)))
    assert want.keys() == got.keys()
    assert sum(is_quant(leaf) for leaf in want.values()) > 0
    for path, leaf in want.items():
        if is_quant(leaf):
            assert got[path]["q"].dtype == torch.int8 and got[path]["s"].dtype == torch.bfloat16
            assert torch.equal(leaf["q"], got[path]["q"]), path
            assert torch.equal(leaf["s"].view(torch.int16), got[path]["s"].view(torch.int16)), path
        else:
            assert leaf.dtype == got[path].dtype == cfg.param_dtype and torch.equal(leaf, got[path]), path
    assert torch.equal(torch.randn(4, generator=g1), torch.randn(4, generator=g2))


# ---------------------------------------------------------------------------
# Logits on the bridged JAX int8 tree
# ---------------------------------------------------------------------------


def _prompts(vocab: int, lens, seed: int = 3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("arch", DECODERS)
def test_dense_prefill_and_decode_logits_match_jax(arch, logits_out):
    """Two prompts of 11 and 7 tokens right-padded to 16 (``n_valid``) in one
    dense prefill, then three decode steps at per-slot lengths: logits
    within f32 2e-5 of JAX's at every step, at the default (binding)
    capacity factor."""
    jcfg, tcfg, _, jq, tq = _weights(arch)
    jm, tm = j_get_model(jcfg), get_model(tcfg)
    toks = np.zeros((2, 16), np.int32)
    for b, p in enumerate(_prompts(tcfg.vocab_size, [11, 7])):
        toks[b, :len(p)] = p
    nv = np.array([11, 7], np.int32)
    want, jc = jm.prefill(None, jq, {"tokens": jnp.asarray(toks), "n_valid": jnp.asarray(nv)}, cap=24)
    got, tc = tm.prefill(tq, {"tokens": torch.from_numpy(toks), "n_valid": torch.from_numpy(nv)}, cap=24)
    _close(want, got)
    lens = nv.copy()
    for _ in range(3):
        tok = got.argmax(-1).to(torch.int32)[:, None]
        want, jc = jm.decode(None, jq, jc, {"token": jnp.asarray(tok.numpy()), "lengths": jnp.asarray(lens),
                                             "cache_index": jnp.asarray(lens)})
        got, tc = tm.decode(tq, tc, {"token": tok, "lengths": lens})
        _close(want, got)
        lens = lens + 1


@pytest.mark.parametrize("arch", DECODERS + (VLM,))
def test_paged_prefill_and_decode_logits_match_jax(arch, logits_out):
    """Two token prompts (11 of 16 tokens valid, and 16) prefilled one at a
    time into a page pool through their block-table rows, then three
    batched paged decode steps: logits within f32 2e-5 of JAX's (qwen2-vl's
    text-only M-RoPE positions included)."""
    jcfg, tcfg, _, jq, tq = _weights(arch)
    jm, tm = j_get_model(jcfg), get_model(tcfg)
    jc = jm.init_paged_cache(2, NP, PS)
    tc = tm.init_paged_cache(NP, PS, "cpu", 2)
    tab = np.array([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)
    lens, firsts = [], []
    for b, p in enumerate(_prompts(tcfg.vocab_size, [11, 16], seed=4)):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :len(p)] = p
        batch = {"tokens": toks, "n_valid": np.array([len(p)], np.int32), "tab_row": tab[b], "slot": b}
        want, jc = jm.prefill_paged(None, jq, {k: jnp.asarray(v) for k, v in batch.items()}, jc)
        got, tc = tm.prefill_paged(tq, {k: torch.as_tensor(v) for k, v in batch.items()}, tc)
        _close(want, got)
        lens.append(len(p))
        firsts.append(got)
    got, lens = torch.cat(firsts), np.array(lens, np.int32)
    for _ in range(3):
        tok = got.argmax(-1).to(torch.int32)[:, None]
        batch = {"token": tok.numpy(), "lengths": lens, "block_tab": tab}
        want, jc = jm.decode(None, jq, jc, {k: jnp.asarray(v) for k, v in batch.items()})
        got, tc = tm.decode(tq, tc, {k: torch.as_tensor(v) for k, v in batch.items()})
        _close(want, got)
        lens = lens + 1


def test_vlm_image_prompt_logits_match_jax(logits_out):
    """qwen2-vl-2b with int8 weights: ``EmbedsLM.prefill`` of two seeded
    embedding prompts of 24 tokens with a 4 x 4 image at 4 (positions from
    ``mrope_positions_with_image``), then three decode steps at a scalar
    cache index: logits within f32 2e-5 of the JAX jnp path's."""
    jcfg, tcfg, _, jq, tq = _weights(VLM)
    jm, tm = j_get_model(jcfg), get_model(tcfg)
    B, S, CAP = 2, 24, 32
    emb = np.random.default_rng(2).standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    pos = mrope_positions_with_image(B, S, 4, 4, 4)
    want, jc = jm.prefill(None, jq, {"inputs_embeds": jnp.asarray(emb), "positions": jnp.asarray(pos.numpy())},
                          cap=CAP)
    got, tc = tm.prefill(tq, {"inputs_embeds": torch.from_numpy(emb), "positions": pos}, cap=CAP)
    _close(want, got)
    for j in range(3):
        tok = got.argmax(-1).to(torch.int32)[:, None]
        want, jc = jm.decode(None, jq, jc, {"token": jnp.asarray(tok.numpy()),
                                             "cache_index": jnp.asarray(S + j, jnp.int32)})
        got, tc = tm.decode(tq, tc, {"token": tok, "cache_index": S + j})
        _close(want, got)


def test_whisper_prefill_and_decode_logits_match_jax(logits_out):
    """whisper-large-v3 with int8 weights (the encoder's, the decoder's and
    the cross-attention's projections and the unembed): ``EncDecLM.prefill``
    of seeded frames and two 7-token prompts, then three decode steps:
    logits within f32 2e-5 of JAX's."""
    jcfg, tcfg, _, jq, tq = _weights(WHISPER)
    jm, tm = j_get_model(jcfg), get_model(tcfg)
    assert is_quant(tq["encoder"]["blocks"]["l0_mixer"]["wq"]) and is_quant(tq["decoder"]["blocks"]["l0_cross"]["wk"])
    frames = np.random.default_rng(1).standard_normal((2, tcfg.encoder.n_ctx, tcfg.d_model)).astype(np.float32)
    toks = np.stack(_prompts(tcfg.vocab_size, [7, 7]))
    want, jc = jm.prefill(None, jq, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)}, cap=12)
    got, tc = tm.prefill(tq, {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(toks)}, cap=12)
    _close(want, got)
    for j in range(3):
        tok = got.argmax(-1).to(torch.int32)[:, None]
        want, jc = jm.decode(None, jq, jc, {"token": jnp.asarray(tok.numpy()), "cache_index": 7 + j})
        got, tc = tm.decode(tq, tc, {"token": tok, "cache_index": 7 + j})
        _close(want, got)


# ---------------------------------------------------------------------------
# Engines, with no drop possible
# ---------------------------------------------------------------------------

ENGINES = {
    "dense_chunk16": ("dense", dict(max_slots=3, max_len=64, chunk_tokens=16)),
    "paged_whole_prompt": ("paged", dict(page_size=8, num_pages=33, max_slots=3, max_seq_len=64)),
    "paged_int8_chained": ("paged", dict(page_size=8, num_pages=33, max_slots=3, max_seq_len=64,
                                         cache_dtype="int8", chained_tables=True, table_page_entries=2)),
}


@pytest.mark.parametrize("arch, engine", [(DBRX, e) for e in ENGINES] + [
    (JAMBA, "dense_chunk16"), (JAMBA, "paged_int8_chained")])
def test_engine_greedy_streams_match_jax(arch, engine):
    """The port's dense and paged engines on the bridged int8 tree emit the
    greedy streams of the JAX engines on ``quantize_params`` of the same
    tree (``weights_int8``, as test_perf_variants.py's
    test_weight_int8_engine_greedy_parity builds them): prompts shorter than
    a page, across pages and longer than a chunk, more prompts than slots,
    at capacity factor 8."""
    jcfg, tcfg, _, jq, tq = _ample(arch)
    kind, kw = ENGINES[engine]
    kw = dict(kw, max_new_tokens=6)
    prompts = [p.tolist() for p in _prompts(tcfg.vocab_size, [5, 19, 30, 8, 13], seed=40)]
    if kind == "dense":
        j = JInferenceEngine(jcfg, JEngineConfig(**kw), params=jq)
        t = InferenceEngine(tcfg, EngineConfig(**kw), params=tq, device="cpu")
    else:
        j = JPagedInferenceEngine(jcfg, JPagedEngineConfig(**kw), params=jq)
        t = PagedInferenceEngine(tcfg, PagedEngineConfig(**kw), params=tq, device="cpu")
    want = [s.out for s in j.generate(prompts)]
    got = [s.out for s in t.generate(prompts)]
    assert got == want
    if kind == "paged":
        t.allocator.check_invariants()
        assert t.allocator.used_pages == 0


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch, extra", [(LLAMA4, ["--layers", "1"]), (JAMBA, ["--layers", "8"]), (VLM, [])],
                         ids=["llama4-1L", "jamba-superblock", "qwen2-vl"])
def test_launcher_serves_int8_weights(arch, extra):
    """``--weights-int8`` serves the MoE, hybrid and VLM families on the CPU
    at SMOKE width, 0 failures: one quantized tree on every tier, the
    experts' and the unembed's leaves int8, the Mamba projections float."""
    r = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--weights-int8", "--requests", "4", *extra])
    m = r["metrics"].summary()
    assert m["total"] == 4 and m["failed"] == 0
    assert r["cfg"].weights_int8 and is_quant(r["params"]["unembed"])
    blocks = r["params"]["blocks"]
    ffn = blocks["l1_ffn"] if arch == JAMBA else blocks["l0_ffn"]
    assert is_quant(ffn["w1"]) and is_quant(ffn["w2"])
    if arch == JAMBA:
        assert r["cfg"].n_layers == 8 and ffn["w1"]["q"].ndim == 4
        assert blocks["l0_mixer"]["in_proj"].dtype == torch.float32


def test_whisper_launcher_with_int8_weights_fails_at_construction_in_both(monkeypatch):
    """``--arch whisper-large-v3 --weights-int8`` fails while the launcher
    builds its dense tiers (chunked prefill is decoder-only), in both
    packages, with the same exception and message: the int8 path runs
    through the model API, as the bf16 one does."""
    import sys

    from repro.launch import serve as jserve

    def raised(fn):
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - the test compares what each package raises
            return type(e), str(e)
        return None

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", WHISPER, "--weights-int8"])
    theirs = raised(jserve.main)
    mine = raised(lambda: serve.main(["--arch", WHISPER, "--smoke", "--device", "cpu", "--weights-int8"]))
    assert theirs is not None and mine == theirs == (ValueError, "chunked prefill is decoder-only (no enc-dec support)")
