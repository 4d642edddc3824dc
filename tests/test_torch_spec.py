"""The port's speculative decoding against the JAX package on the CPU:
smollm-360m SMOKE in f32 (a 24-token vocabulary, so greedy output settles
into short cycles and the prompt-lookup proposer fires), the same weights
bridged with ``params_from_jax``.

Held: ``next_tokens_all``; the two verify writes against the JAX refs at
mid-page offsets and past the row's end; ``verify`` and ``verify_paged``
against JAX (ids exact, pools within 2e-5); greedy streams of port spec on
== JAX spec on == port spec off for the dense and paged engines, whole-prompt
and chunked, int8 pools and chained tables; preemption mid-speculation on a
pool sized so that it preempts; spec over a warm and a cold prefix cache; an
EngineLoop's throughput metrics; the refusal of recurrent models. Every
stream test asserts that proposals were accepted. A flipped token is
reported with the port's top-2 logit gap at that step."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.kernels.paged_attention import ref as j_ref  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models.loss import next_tokens_all as j_next_tokens_all  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.engine import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serving.engine import PagedEngineConfig as JPagedEngineConfig  # noqa: E402
from repro.serving.engine import PagedInferenceEngine as JPagedInferenceEngine  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402
from repro_torch.models.loss import next_tokens_all  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    EngineConfig,
    InferenceEngine,
    PagedEngineConfig,
    PagedInferenceEngine,
)
from repro_torch.serving.scheduler import EngineLoop  # noqa: E402

VOCAB, NEW, MAXLEN, PS = 24, 48, 128, 8
PROMPTS = [[1, 2, 3, 4, 5, 1, 2, 3, 4, 5], [7, 8, 9, 7, 8, 9], [3, 1, 4, 1, 5, 9, 2, 6]]


@pytest.fixture(scope="module")
def weights():
    jcfg = j_get_config("smollm-360m", smoke=True).replace(attn_chunk=64, vocab_size=VOCAB)
    tcfg = get_config("smollm-360m", smoke=True).replace(attn_chunk=64, vocab_size=VOCAB)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def jax_runs(weights):
    """JAX engine streams, computed once per engine setting and shared."""
    jcfg, _, jparams, _ = weights
    memo = {}

    def run(kind, prompts=PROMPTS, **kw):
        key = (kind, repr(prompts), tuple(sorted(kw.items())))
        if key not in memo:
            if kind == "dense":
                eng = JInferenceEngine(jcfg, JEngineConfig(**kw), params=jparams)
            else:
                eng = JPagedInferenceEngine(jcfg, JPagedEngineConfig(**kw), params=jparams)
            memo[key] = ([s.out for s in eng.generate(prompts)], eng.spec_accepted)
        return memo[key]

    return run


def _assert_same_tokens(weights, prompts, want, got):
    """Equal greedy streams; on a flip, name the step and the port's top-2
    logit gap there (teacher-forced on the reference's context)."""
    _, tcfg, _, tparams = weights
    model = get_model(tcfg)
    for prompt, a, b in zip(prompts, want, got):
        if a == b:
            continue
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        with torch.no_grad():
            row = model.logits(tparams, model.hidden(tparams, [prompt + a[:j]]))[0, -1]
        top2 = torch.topk(row, 2).values
        pytest.fail(f"prompt {prompt}: token {j} differs ({a} vs {b}); "
                    f"top-2 logit gap there {float(top2[0] - top2[1]):.3e}")


def _port(weights, kind, **kw):
    _, tcfg, _, tparams = weights
    if kind == "dense":
        return InferenceEngine(tcfg, EngineConfig(**kw), params=tparams, device="cpu")
    return PagedInferenceEngine(tcfg, PagedEngineConfig(**kw), params=tparams, device="cpu")


# ---------------------------------------------------------------------------
# Model pieces
# ---------------------------------------------------------------------------


def test_next_tokens_all_matches_jax(weights):
    """Greedy ids at every position, ties included (a repeated row)."""
    jcfg, tcfg, jparams, tparams = weights
    h = np.random.default_rng(0).normal(size=(2, 5, tcfg.d_model)).astype(np.float32)
    h[1, 3] = h[1, 2]
    want = np.asarray(j_next_tokens_all(jcfg, None, jparams, jnp.asarray(h)))
    got = next_tokens_all(tcfg, tparams, torch.from_numpy(h))
    assert got.dtype == torch.int32 and got.shape == (2, 5)
    np.testing.assert_array_equal(got.numpy(), want)


def _pools(rng, NP, KV, ps, hd, quant):
    if quant:
        k = rng.integers(-127, 128, (NP, KV, ps, hd)).astype(np.int8)
        v = rng.integers(-127, 128, (NP, KV, ps, hd)).astype(np.int8)
        ks = torch.from_numpy(rng.random((NP, KV, ps, 1)).astype(np.float32)).bfloat16()
        vs = torch.from_numpy(rng.random((NP, KV, ps, 1)).astype(np.float32)).bfloat16()
        return [k, v, ks.float().numpy(), vs.float().numpy()]
    return [rng.normal(size=(NP, KV, ps, hd)).astype(np.float32) for _ in range(2)]


def _to_jax(pools, quant):
    out = [jnp.asarray(p) for p in pools]
    if quant:
        out[2:] = [x.astype(jnp.bfloat16) for x in out[2:]]
    return out


def _to_torch(pools, quant):
    out = [torch.from_numpy(p.copy()) for p in pools]
    if quant:
        out[2:] = [x.bfloat16() for x in out[2:]]
    return out


def _compare_pools(jpools, tpools, quant):
    """Every page but the null page 0: f32 within 2e-5, int8 within 1 LSB
    (a bf16 tie may round either way), scales bit for bit."""
    for i, (a, b) in enumerate(zip(jpools, tpools)):
        a = np.asarray(a.astype(jnp.float32))[1:]
        b = b.float().numpy()[1:]
        if quant and i < 2:
            assert np.abs(a - b).max() <= 1
            assert (a != b).mean() < 1e-3
        elif quant:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("offset", [5, 13, 29, 30, 40], ids=lambda o: f"offset{o}")
def test_verify_write_matches_jax_ref(quant, offset):
    """Five tokens at mid-page offsets of a 4-entry row of 8-token pages:
    inside a page, across a page boundary, running past the row's end (30:
    the last three go to the null page) and wholly past it (40)."""
    rng = np.random.default_rng(offset)
    NP, KV, ps, hd, S = 9, 2, 8, 16, 5
    pools = _pools(rng, NP, KV, ps, hd, quant)
    tab = np.array([6, 2, 8, 3], np.int32)
    k = rng.normal(size=(1, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(1, S, KV, hd)).astype(np.float32)
    jp = _to_jax(pools, quant)
    tp = _to_torch(pools, quant)
    args_j = (jnp.asarray(k), jnp.asarray(v), jnp.asarray(tab), offset)
    args_t = (torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(tab), offset)
    if quant:
        want = j_ref.paged_verify_write_quant_ref(*jp, *args_j)
        got = pa_ops.paged_verify_write_quant(*tp, *args_t)
    else:
        want = j_ref.paged_verify_write_ref(*jp, *args_j)
        got = pa_ops.paged_verify_write(*tp, *args_t)
    assert all(g.data_ptr() == t.data_ptr() for g, t in zip(got, tp))     # in place
    _compare_pools(want, got, quant)


def _fill_like(jtree, ttree, rng):
    """Write the same random values into a JAX cache tree (returned anew)
    and the port's (in place): int8 leaves as int8, bf16 scales as bf16."""
    if isinstance(ttree, dict):
        return {key: _fill_like(jtree[key], ttree[key], rng) for key in ttree}
    if ttree.dtype == torch.int8:
        a = rng.integers(-127, 128, tuple(ttree.shape)).astype(np.int8)
        ttree.copy_(torch.from_numpy(a))
        return jnp.asarray(a)
    a = torch.from_numpy(rng.random(tuple(ttree.shape)).astype(np.float32) - 0.5)
    ttree.copy_(a.to(ttree.dtype))
    return jnp.asarray(ttree.float().numpy()).astype(jtree.dtype)


def _compare_trees(jtree, ttree, paged):
    if isinstance(ttree, dict):
        for key in ttree:
            _compare_trees(jtree[key], ttree[key], paged)
        return
    a = np.asarray(jtree.astype(jnp.float32))
    b = ttree.float().numpy()
    if paged:                              # (n_sb, num_pages, ...): skip the null page
        a, b = a[:, 1:], b[:, 1:]
    tol = 1 if ttree.dtype == torch.int8 else 2e-5
    np.testing.assert_allclose(a, b, rtol=0, atol=tol)


@pytest.mark.parametrize("layout", ["dense", "paged", "paged_int8"])
def test_verify_matches_jax(weights, layout):
    """Five verify tokens at offset 13 over a cache of random contents: the
    greedy ids at every position exactly, the cache within 2e-5."""
    jcfg, tcfg, jparams, tparams = weights
    if layout == "paged_int8":
        jcfg, tcfg = jcfg.replace(kv_quant=True), tcfg.replace(kv_quant=True)
    jm, tm = j_get_model(jcfg), get_model(tcfg)
    rng = np.random.default_rng(7)
    toks = np.array([[3, 1, 4, 1, 5]], np.int32)
    if layout == "dense":
        tcache = tm.init_cache(1, 32, "cpu")
        jcache = _fill_like(jm.init_cache(1, 32), tcache, rng)
        want, jcache = jm.verify(None, jparams, {"tokens": jnp.asarray(toks), "offset": 13}, jcache)
        got, tcache = tm.verify(tparams, {"tokens": torch.from_numpy(toks), "offset": 13}, tcache)
    else:
        tcache = tm.init_paged_cache(9, PS, "cpu")
        jcache = _fill_like(jm.init_paged_cache(1, 9, PS), tcache, rng)
        tab = np.array([4, 7, 1, 5], np.int32)
        want, jcache = jm.verify_paged(
            None, jparams, {"tokens": jnp.asarray(toks), "tab_row": jnp.asarray(tab), "offset": 13},
            jcache)
        got, tcache = tm.verify_paged(
            tparams, {"tokens": torch.from_numpy(toks), "tab_row": torch.from_numpy(tab),
                      "offset": 13}, tcache)
    assert got.shape == (1, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _compare_trees(jcache, tcache, paged=layout != "dense")


# ---------------------------------------------------------------------------
# Engines: spec on == JAX spec on == spec off
# ---------------------------------------------------------------------------

VARIANTS = {
    "dense_whole_prompt": ("dense", dict(max_slots=4, max_len=MAXLEN)),
    "dense_chunk32": ("dense", dict(max_slots=4, max_len=MAXLEN, chunk_tokens=32)),
    "paged_whole_prompt": ("paged", dict(page_size=PS, num_pages=65, max_slots=4,
                                         max_seq_len=MAXLEN)),
    "paged_chunk32": ("paged", dict(page_size=PS, num_pages=65, max_slots=4, max_seq_len=MAXLEN,
                                    chunk_tokens=32)),
    "paged_int8": ("paged", dict(page_size=PS, num_pages=65, max_slots=4, max_seq_len=MAXLEN,
                                 cache_dtype="int8")),
    "paged_chained": ("paged", dict(page_size=4, num_pages=65, max_slots=4, max_seq_len=MAXLEN,
                                    chained_tables=True, table_page_entries=4)),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_spec_streams_match_jax_and_spec_off(weights, jax_runs, variant):
    kind, kw = VARIANTS[variant]
    kw = dict(kw, max_new_tokens=NEW)
    want, j_accepted = jax_runs(kind, spec_tokens=4, **kw)
    off = [s.out for s in _port(weights, kind, **kw).generate(PROMPTS)]
    on = _port(weights, kind, spec_tokens=4, **kw)
    got = [s.out for s in on.generate(PROMPTS)]
    _assert_same_tokens(weights, PROMPTS, want, got)
    _assert_same_tokens(weights, PROMPTS, off, got)
    assert on.spec_proposed > 0 and on.spec_accepted > 0
    assert on.spec_accepted == j_accepted
    assert on.tokens_emitted == sum(len(o) for o in got)
    if kind == "paged":
        on.allocator.check_invariants()
        assert on.allocator.used_pages == 0
        if on.chain is not None:
            on.chain.check_invariants(on.pcfg.max_slots)


def test_dense_int8_spec_matches_jax(weights, jax_runs):
    """The dense int8 cache under speculation: the JAX engine's streams.
    Spec off is not held here: the dense int8 decode rounds its
    probabilities to bf16 and the verify pass does not, so one stream
    parts from spec off at a near-tie in both packages alike."""
    kw = dict(max_slots=4, max_len=MAXLEN, max_new_tokens=NEW, cache_dtype="int8")
    want, j_accepted = jax_runs("dense", spec_tokens=4, **kw)
    on = _port(weights, "dense", spec_tokens=4, **kw)
    _assert_same_tokens(weights, PROMPTS, want, [s.out for s in on.generate(PROMPTS)])
    assert on.spec_accepted == j_accepted > 0


def test_dense_spec_at_the_stripe_end(weights, jax_runs):
    """A 40-token stripe: speculation runs until the stop at max_len - 1,
    with k_eff capped at max_len - 1 - L, so no verify write reaches the
    stripe's edge (where the cache write would clamp)."""
    kw = dict(max_slots=2, max_len=40, max_new_tokens=NEW)
    want, _ = jax_runs("dense", spec_tokens=4, **kw)
    on = _port(weights, "dense", spec_tokens=4, **kw)
    got = [s.out for s in on.generate(PROMPTS)]
    off = [s.out for s in _port(weights, "dense", **kw).generate(PROMPTS)]
    _assert_same_tokens(weights, PROMPTS, want, got)
    _assert_same_tokens(weights, PROMPTS, off, got)
    assert [len(p) + len(o) for p, o in zip(PROMPTS, got)] == [40] * 3   # stopped at the cap
    assert on.spec_accepted > 0


def test_preemption_mid_speculation_restart_parity(weights):
    """A pool tight enough that growth preempts while slots speculate: the
    resumed sequences re-emit the ample pool's streams, and the spec-off
    streams too."""
    prompts = [p[:6] for p in PROMPTS] + [[2, 4, 2, 4, 2, 4], [5, 6, 5, 6, 5, 6]]
    kw = dict(page_size=4, max_slots=5, max_seq_len=64, max_new_tokens=40)
    ample = _port(weights, "paged", num_pages=81, spec_tokens=4, **kw)
    a = [s.out for s in ample.generate(prompts)]
    assert ample.preemptions == 0 and ample.spec_accepted > 0
    tight = _port(weights, "paged", num_pages=24, spec_tokens=4, **kw)
    t = [s.out for s in tight.generate(prompts)]
    assert tight.preemptions > 0, "tight pool never preempted"
    assert tight.spec_accepted > 0
    off = [s.out for s in _port(weights, "paged", num_pages=24, **kw).generate(prompts)]
    _assert_same_tokens(weights, prompts, a, t)
    _assert_same_tokens(weights, prompts, off, t)
    tight.allocator.check_invariants()
    assert tight.allocator.used_pages == 0


def test_spec_with_prefix_cache_warm_and_cold(weights, jax_runs):
    """Spec over the prefix cache: the cold pass and the warm pass (the same
    prompts again, prefill skipped from the tree) reproduce the spec-off
    streams and the JAX engine's, and release-to-cache keeps the
    invariants."""
    kw = dict(page_size=PS, num_pages=65, max_slots=4, max_seq_len=MAXLEN, max_new_tokens=NEW,
              prefix_cache=True)
    off = _port(weights, "paged", **kw)
    cold_off = [s.out for s in off.generate(PROMPTS)]
    warm_off = [s.out for s in off.generate(PROMPTS)]
    on = _port(weights, "paged", spec_tokens=4, **kw)
    cold = [s.out for s in on.generate(PROMPTS)]
    cold_accepted = on.spec_accepted
    warm_seqs = on.generate(PROMPTS)
    warm = [s.out for s in warm_seqs]
    want, _ = jax_runs("paged", spec_tokens=4, **kw)
    _assert_same_tokens(weights, PROMPTS, cold_off, cold)
    _assert_same_tokens(weights, PROMPTS, warm_off, warm)
    _assert_same_tokens(weights, PROMPTS, want, cold)
    assert cold_accepted > 0 and on.spec_accepted > cold_accepted
    assert any(s.cached_tokens > 0 for s in warm_seqs), "warm pass never hit the cache"
    on.allocator.check_invariants()
    on.prefix_cache.check_invariants()
    assert on.allocator.used_pages == on.prefix_cache.cached_pages


def test_spec_through_engine_loop_records_throughput(weights, jax_runs):
    """The step loop is spec-transparent, the tokens-per-step gauge reads
    above 0 and the accepted-run histogram holds one observation per verify
    pass."""
    kw = dict(page_size=PS, num_pages=65, max_slots=4, max_seq_len=MAXLEN, max_new_tokens=NEW)
    want, _ = jax_runs("paged", spec_tokens=4, **kw)
    eng = _port(weights, "paged", spec_tokens=4, **kw)
    loop = EngineLoop(eng)                        # stepped by hand
    sids = [loop.submit(p) for p in PROMPTS]
    done = {}
    for _ in range(400):
        for s in loop.step_once():
            done[s.sid] = s
        if len(done) == len(sids):
            break
    _assert_same_tokens(weights, PROMPTS, want, [done[sid].out for sid in sids])
    labels = {"engine": loop.name}
    assert loop.registry.gauge("engine_tokens_per_step", labels).value > 0
    hist = loop.registry.histogram("spec_accepted_run", labels)
    assert hist.total > 0, "no verify pass was observed"
    assert hist.sum == float(eng.spec_accepted)
    snap = eng.capacity_now()
    assert snap["spec_tokens"] == 4 and snap["spec_accepted"] == eng.spec_accepted > 0


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_spec_rejects_recurrent_models(kind):
    """xlstm-350m refuses spec_tokens with the reference's message."""
    cfg = get_config("xlstm-350m", smoke=True)
    with pytest.raises(ValueError, match="attention-only"):
        if kind == "dense":
            InferenceEngine(cfg, EngineConfig(max_slots=2, max_len=64, spec_tokens=2), device="cpu")
        else:
            PagedInferenceEngine(cfg, PagedEngineConfig(spec_tokens=2), device="cpu")
