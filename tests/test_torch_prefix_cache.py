"""The port's prefix cache and ``fork()`` against the JAX package on the CPU.

The radix tree's unit tests run against the port's copy
(``repro_torch.serving.prefix_cache``). The engine tests use smollm-360m
SMOKE in f32 with the JAX weights bridged by ``params_from_jax``: warm ==
cold == the JAX engine, whole-prompt and chunked, f32 and int8 pools; a
mid-prefill preemption that restarts at the re-validated boundary; eviction
before any preemption; the capacity keys and ``admission_capacity``; an
EngineLoop's prefix metrics; ``fork`` against the JAX engine for smollm-360m
(a cache-attached source, a copied partial page, the pinned tree path) and
xlstm-350m (the slot's recurrent state copied); and the refusal of
recurrent models. A flipped token is reported with the port's top-2 logit
gap at that step."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.serving.engine import PagedEngineConfig as JPagedEngineConfig  # noqa: E402
from repro.serving.engine import PagedInferenceEngine as JPagedInferenceEngine  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import CapacityGauge  # noqa: E402
from repro_torch.core.telemetry import (  # noqa: E402
    MetricsRegistry,
    MonitorSampler,
    cached_pages,
    prefix_hit_rate,
    reclaimable_pages,
)
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402
from repro_torch.serving.engine import PagedEngineConfig, PagedInferenceEngine  # noqa: E402
from repro_torch.serving.paging import BlockAllocator, PageTable  # noqa: E402
from repro_torch.serving.prefix_cache import PrefixCache  # noqa: E402
from repro_torch.serving.scheduler import EngineLoop  # noqa: E402

# ---------------------------------------------------------------------------
# Radix tree over a BlockAllocator (no model): the reference's unit tests
# ---------------------------------------------------------------------------

PS = 4


def _cache(num_pages=20):
    a = BlockAllocator(num_pages=num_pages, page_size=PS)
    return a, PrefixCache(a, PS)


def _path(node):
    out = []
    while node is not None and node.parent is not None:
        out.append(node)
        node = node.parent
    return out


def test_acquire_miss_insert_then_hit_shares_pages():
    a, pc = _cache()
    toks = list(range(10))                        # 2 full pages + partial
    assert pc.acquire(toks) == ([], None, 0)
    seq_pages = a.alloc(3)
    assert pc.insert(toks, seq_pages[:2]) == 2    # adopts the seq's 2 full pages
    a.free(seq_pages[2:])
    assert pc.cached_pages == 2 and a.used_pages == 2
    pages, node, matched = pc.acquire(toks)
    assert matched == 8 and pages == seq_pages[:2]
    assert all(a.ref_count(p) == 2 for p in pages)  # tree + acquirer
    assert node.holders == 1 and pc.evictable_pages() == 0
    pc.release(node)
    a.free(pages)
    assert pc.evictable_pages() == 2
    pc.check_invariants()
    a.check_invariants()


def test_acquire_capped_one_token_short_of_context():
    a, pc = _cache()
    toks = list(range(8))                         # exactly 2 pages
    pc.insert(toks, a.alloc(2))
    got, node, matched = pc.acquire(toks)
    assert matched == 4 and len(got) == 1         # (8-1)//4 = 1 page, not 2
    pc.cancel(got, node)
    pc.check_invariants()


def test_insert_splits_node_at_divergence_and_frees_duplicates():
    a, pc = _cache()
    shared = [7] * 8
    s1, s2 = shared + [1] * 4, shared + [2] * 4
    p1 = a.alloc(3)
    pc.insert(s1, p1)
    assert len(pc.nodes()) == 1
    p2 = a.alloc(3)
    pc.insert(s2, p2)
    assert pc.cached_pages == 4 and a.used_pages == 4
    nodes = pc.nodes()
    assert len(nodes) == 3                        # split parent + two leaves
    parent = next(n for n in nodes if n.children)
    assert len(parent.pages) == 2 and parent.pages == p1[:2]
    assert sorted(p for n in nodes if not n.children for p in n.pages) == sorted([p1[2], p2[2]])
    got, node, matched = pc.acquire(shared + [9])
    assert matched == 8 and got == p1[:2] and node is parent
    pc.cancel(got, node)
    pc.check_invariants()
    a.check_invariants()


def test_lru_eviction_drops_cold_unpinned_leaves_first():
    a, pc = _cache()
    cold, warm = [1] * 8, [2] * 8
    pc.insert(cold + [0], a.alloc(2))
    pc.insert(warm + [0], a.alloc(2))
    pc.acquire(warm + [9])                        # touches + pins warm
    got, node, _ = pc.acquire(cold + [9])         # touch cold last, unpinned
    pc.cancel(got, node)
    assert pc.evict(10) == 2                      # only the cold leaf went
    assert pc.cached_pages == 2 and pc.evictions == 1
    assert {tuple(n.keys[0]) for n in pc.nodes()} == {(2, 2, 2, 2)}
    pc.check_invariants()
    a.check_invariants()


def test_evict_reports_actually_reclaimed_pages_only():
    a, pc = _cache()
    toks = [3] * 12
    pc.insert(toks, a.alloc(3))
    got, node, matched = pc.acquire(toks)
    assert matched == 8
    pc.release(node)                              # unpin, keep the shares
    free_before = a.free_pages
    assert pc.evict(3) == 1                       # only the unshared 3rd page
    assert a.free_pages == free_before + 1
    a.free(got)
    assert a.free_pages == free_before + 3
    pc.check_invariants()
    a.check_invariants()


def test_drop_restores_pool_and_path_pin_counters_balance():
    a, pc = _cache()
    pc.insert([1] * 8 + [0], a.alloc(2))
    pc.insert([1] * 4 + [2] * 4 + [0], a.alloc(2))
    got, node, _ = pc.acquire([1] * 8 + [9])
    for n in pc.nodes():
        assert (n.holders == 1) == (n in _path(node))
    pc.release(node)
    a.free(got)
    assert pc.evictable_pages() == pc.cached_pages == 3
    assert pc.drop() == 3
    a.check_invariants()
    assert a.used_pages == 0 and pc.cached_pages == 0


# ---------------------------------------------------------------------------
# Engines against the JAX engine
# ---------------------------------------------------------------------------

SYS = list(range(1, 26))                          # 25-token shared "system prompt"


@pytest.fixture(scope="module")
def weights():
    jcfg = j_get_config("smollm-360m", smoke=True).replace(attn_chunk=64)
    tcfg = get_config("smollm-360m", smoke=True).replace(attn_chunk=64)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _assert_same_tokens(weights, prompts, want, got):
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


def _settings(prefix_cache=True, chunk_tokens=0, num_pages=60, max_new=6, page_size=4,
              max_slots=4, max_seq_len=64, **kw):
    return dict(page_size=page_size, num_pages=num_pages, max_slots=max_slots,
                max_seq_len=max_seq_len, max_new_tokens=max_new, chunk_tokens=chunk_tokens,
                prefix_cache=prefix_cache, **kw)


def _paged(weights, **kw):
    return PagedInferenceEngine(weights[1], PagedEngineConfig(**_settings(**kw)),
                                params=weights[3], device="cpu")


def _jpaged(weights, **kw):
    return JPagedInferenceEngine(weights[0], JPagedEngineConfig(**_settings(**kw)),
                                 params=weights[2])


@pytest.mark.parametrize("variant", [{"chunk_tokens": 0}, {"chunk_tokens": 8},
                                     {"chunk_tokens": 0, "cache_dtype": "int8"}],
                         ids=["whole_prompt", "chunk8", "int8"])
def test_warm_equals_cold_equals_jax(weights, variant):
    """Warm and cold streams are equal, equal to the JAX engine's with the
    cache on, and to the port's with it off; the cursor starts at the
    page-aligned match boundary."""
    prompts = [SYS + [30, 31, 32], SYS + [30, 31, 32], SYS + [40]]
    eng, jeng = _paged(weights, **variant), _jpaged(weights, **variant)
    got, want = [], []
    for p in prompts:
        got += eng.generate([p])
        want += jeng.generate([p])
    assert [s.cached_tokens for s in got] == [s.cached_tokens for s in want] == [0, 24, 24]
    _assert_same_tokens(weights, prompts, [s.out for s in want], [s.out for s in got])
    assert got[1].out == got[0].out
    cold = _paged(weights, prefix_cache=False, **variant).generate([prompts[0]])[0]
    assert cold.out == got[0].out
    assert eng.capacity_now()["prefix_cached_tokens"] == jeng.capacity_now()["prefix_cached_tokens"]
    eng.prefix_cache.check_invariants()
    eng.allocator.check_invariants()
    assert eng.allocator.used_pages == eng.prefix_cache.cached_pages > 0
    assert eng.prefix_cache.drop() > 0
    assert eng.allocator.used_pages == 0


def test_release_to_cache_retains_pages_cache_off_frees_them(weights):
    on = _paged(weights)
    on.generate([SYS + [30]])
    assert on.allocator.used_pages == on.prefix_cache.cached_pages > 0
    off = _paged(weights, prefix_cache=False)
    off.generate([SYS + [30]])
    assert off.allocator.used_pages == 0


def test_mid_prefill_preemption_restarts_at_revalidated_boundary(weights):
    """A prefix-hit sequence preempted mid-prefill re-matches on resume, at
    the re-validated boundary (a cold restart when the tree was evicted
    meanwhile), and emits the unpreempted tokens."""
    prompt = SYS + list(range(30, 46))            # 41-token context
    ample = _paged(weights, chunk_tokens=4, num_pages=80)
    ample.generate([SYS + [99]])
    ref = ample.generate([prompt])[0]
    assert ref.cached_tokens == 24
    for evict_while_parked in (False, True):
        eng = _paged(weights, chunk_tokens=4, num_pages=80)
        eng.generate([SYS + [99]])
        sid = eng.submit(prompt)
        eng.step()                                # admit + first chunk only
        slot = next(i for i, s in enumerate(eng.slot_seq) if s is not None)
        seq = eng.slot_seq[slot]
        assert eng._chunking[slot] and seq.cached_tokens == 24
        assert int(eng._chunk_pos[slot]) >= 24    # cursor began at the boundary
        with eng.lock:
            eng._preempt_newest([slot])
        assert seq.preemptions == 1
        if evict_while_parked:
            assert eng.prefix_cache.evict(10_000) > 0
            assert eng.prefix_cache.cached_pages == 0
        done = []
        for _ in range(60):
            done += eng.step()
            if done:
                break
        (res,) = done
        assert res.sid == sid and res.out == ref.out
        assert res.cached_tokens == (0 if evict_while_parked else 24)
        eng.prefix_cache.check_invariants()
        eng.allocator.check_invariants()


def test_eviction_reclaims_cold_leaves_before_any_preemption(weights):
    """Under page pressure the engine drains cold tree leaves and never
    preempts while an evictable leaf remains; the streams equal the JAX
    engine's."""
    kw = dict(num_pages=16, max_slots=2, max_seq_len=32, max_new=8)
    eng, jeng = _paged(weights, **kw), _jpaged(weights, **kw)
    for t in (50, 60):
        eng.generate([[t] * 11])
        jeng.generate([[t] * 11])
    assert eng.prefix_cache.cached_pages == eng.prefix_cache.evictable_pages() == 8
    prompts = [[70 + i] * 11 for i in range(4)]
    out = eng.generate(prompts)
    want = jeng.generate(prompts)
    _assert_same_tokens(weights, prompts, [s.out for s in want], [s.out for s in out])
    assert all(len(s.out) == 8 for s in out)
    assert eng.prefix_cache.evicted_pages_total > 0
    assert eng.preemptions == 0
    eng.prefix_cache.check_invariants()
    eng.allocator.check_invariants()


def test_capacity_keys_and_admission_capacity(weights):
    """The four cache keys exist only with the cache on, their values equal
    the JAX engine's, and ``admission_capacity`` counts evictable pages as
    free."""
    on, jon = _paged(weights), _jpaged(weights)
    for e in (on, jon):
        e.generate([SYS + [30]])
    snap = on.capacity_now()
    assert set(snap) == set(jon.capacity_now())
    for key in ("cached_pages", "evictable_pages", "prefix_hit_rate", "prefix_cached_tokens",
                "free_pages"):
        assert snap[key] == jon.capacity_now()[key], key
    assert snap["cached_pages"] > 0 and snap["prefix_hit_rate"] == 0.0
    on.generate([SYS + [30]])
    assert on.capacity_now()["prefix_hit_rate"] > 0
    absent = _paged(weights, prefix_cache=False).capacity_now()
    for key in ("cached_pages", "evictable_pages", "prefix_hit_rate", "prefix_cached_tokens"):
        assert key not in absent
    assert cached_pages(snap) > 0 and cached_pages(absent) is None
    assert prefix_hit_rate(absent) is None
    assert reclaimable_pages(snap) == snap["free_pages"] + snap["evictable_pages"]

    eng = _paged(weights, num_pages=20, max_slots=8, max_seq_len=32, max_new=4)
    for t in (50, 60, 70):
        eng.generate([[t] * 11])
    free, evictable = eng.allocator.free_pages, eng.prefix_cache.evictable_pages()
    per_seq = PageTable.pages_needed(12, 4)
    got = eng.admission_capacity(est_tokens=11)
    assert evictable > 0 and got == min(eng.free_slots(), (free + evictable) // per_seq)
    assert got > free // per_seq


def test_engine_loop_and_sampler_export_prefix_metrics(weights):
    reg = MetricsRegistry()
    loop = EngineLoop(_paged(weights), name="paged", registry=reg)
    with loop:
        loop.generate([SYS + [30, 31], SYS + [30, 31]], timeout=120)
        loop.generate([SYS + [30, 31]], timeout=120)
    text = reg.prometheus_text()
    assert 'prefix_matched_tokens_bucket{engine="paged"' in text
    assert 'prefix_cache_hit_ratio{engine="paged"}' in text
    assert reg.counter("prefix_cached_tokens_total", {"engine": "paged"}).value > 0
    hist = reg.merged_histogram("prefix_matched_tokens")
    assert hist.total == 3 and hist.counts[0] >= 1        # misses observe 0
    gauge = CapacityGauge()
    gauge.register_stats("paged", loop.capacity_now)
    sampler = MonitorSampler(gauge, registry=reg)
    sampler.sample_once()
    latest = sampler.latest("paged")
    assert latest["cached_pages"] > 0 and latest["prefix_hit_rate"] > 0
    assert reg.gauge("tier_cached_pages", {"tier": "paged"}).value > 0


@pytest.mark.parametrize("arch", ["xlstm-350m"])
def test_prefix_cache_rejects_recurrent_models(arch):
    with pytest.raises(ValueError, match="attention-only"):
        PagedInferenceEngine(get_config(arch, smoke=True), PagedEngineConfig(prefix_cache=True),
                             device="cpu")


# ---------------------------------------------------------------------------
# fork()
# ---------------------------------------------------------------------------


def _step_until(eng, pred, limit=40):
    for _ in range(limit):
        if pred():
            return
        eng.step()
    raise AssertionError("condition never held")


def _drain(eng, want: int):
    done = {}
    for _ in range(200):
        for s in eng.step():
            done[s.sid] = s.out
        if len(done) == want:
            return done
    raise AssertionError(f"{len(done)} of {want} sequences finished")


def test_fork_of_cache_attached_sequence_matches_jax(weights):
    """A source attached to the tree, mid-page: the clone shares its full
    pages, gets a copy of the partial page, pins the tree path once more,
    and both finish with the source's tokens, as in the JAX engine."""
    engines = [_paged(weights, max_new=8), _jpaged(weights, max_new=8)]
    outs, nodes = [], []
    for eng in engines:
        eng.generate([SYS + [30, 31, 32]])        # populate the tree
        sid = eng.submit(SYS + [30, 31, 32])
        _step_until(eng, lambda: any(s is not None and not eng._chunking[i]
                                     and eng.slot_len[i] % 4 for i, s in enumerate(eng.slot_seq)))
        slot = next(i for i, s in enumerate(eng.slot_seq) if s is not None)
        node = eng._cache_nodes[slot]
        assert node is not None and node.holders == 1
        src_pages = list(eng.tables[slot].pages)
        csid = eng.fork(sid)
        assert csid is not None and node.holders == 2
        cslot = next(i for i, s in enumerate(eng.slot_seq) if s is not None and s.sid == csid)
        n_full = int(eng.slot_len[slot]) // 4
        assert eng.tables[cslot].pages[:n_full] == src_pages[:n_full]       # shared
        assert eng.tables[cslot].pages[n_full] != src_pages[n_full]         # copied
        assert eng.slot_seq[cslot].cached_tokens == eng.slot_seq[slot].cached_tokens == 24
        assert eng.prefix_cache.evict(100) == 0 or node.holders == 2
        done = _drain(eng, 2)
        assert done[sid] == done[csid]
        assert node.holders == 0
        eng.prefix_cache.check_invariants()
        eng.allocator.check_invariants()
        outs.append([done[sid], done[csid]])
        nodes.append(len(eng.prefix_cache.nodes()))
    prompt = SYS + [30, 31, 32]
    _assert_same_tokens(weights, [prompt, prompt], outs[1], outs[0])
    assert nodes[0] == nodes[1]


def test_fork_of_int8_pool_copies_the_scales(weights):
    """On an int8 pool the copy covers the scale pools: the clone's stream
    equals its source's and the JAX engine's."""
    kw = dict(prefix_cache=False, max_new=10, cache_dtype="int8")
    outs = []
    for eng in (_paged(weights, **kw), _jpaged(weights, **kw)):
        sids = [eng.submit(SYS[:9]), eng.submit(SYS[5:19])]
        _step_until(eng, lambda: all(eng.slot_len[i] % 4 for i in range(2)))
        csids = [eng.fork(sid) for sid in sids]
        done = _drain(eng, 4)
        assert [done[c] for c in csids] == [done[s] for s in sids]
        outs.append([done[s] for s in sids + csids])
        eng.allocator.check_invariants()
        assert eng.allocator.used_pages == 0
    _assert_same_tokens(weights, [SYS[:9], SYS[5:19]] * 2, outs[1], outs[0])


def test_fork_of_xlstm_copies_the_recurrent_state():
    """xlstm-350m on the paged engine: the clone gets the source slot's
    recurrent state and both emit the JAX engine's tokens."""
    jcfg = j_get_config("xlstm-350m", smoke=True)
    tcfg = get_config("xlstm-350m", smoke=True)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    kw = dict(page_size=4, num_pages=33, max_slots=3, max_seq_len=32, max_new_tokens=8)
    prompt = [int(t) for t in np.random.default_rng(3).integers(1, tcfg.vocab_size, 7)]
    outs = []
    for eng in (PagedInferenceEngine(tcfg, PagedEngineConfig(**kw), params=tparams, device="cpu"),
                JPagedInferenceEngine(jcfg, JPagedEngineConfig(**kw), params=jparams)):
        sid = eng.submit(prompt)
        for _ in range(3):
            eng.step()
        csid = eng.fork(sid)
        assert csid is not None
        done = _drain(eng, 2)
        assert done[sid] == done[csid]
        outs.append(done[sid])
    assert outs[0] == outs[1]


def test_fork_returns_none_without_a_slot(weights):
    eng = _paged(weights, prefix_cache=False, max_slots=1)
    sid = eng.submit(SYS[:6])
    eng.step()
    assert eng.fork(sid) is None and eng.fork(sid + 7) is None
