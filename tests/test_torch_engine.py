"""The port's serving engines (src/repro_torch/serving) against the JAX
package's ``InferenceEngine`` and ``PagedInferenceEngine`` on the CPU:
smollm-360m SMOKE in f32, the same weights (bridged with
``params_from_jax``), the same engine settings, and identical greedy
``Sequence.out`` for whole-prompt and chunked prefill, f32, bf16 and int8
caches, flat and chained block tables, a preemption-resume run on a tight
pool, and ``EngineLoop``s fed by concurrent submitters. A flipped token is
reported with the top-2 logit gap at that step, from the port's
teacher-forced forward."""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.engine import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serving.engine import PagedEngineConfig as JPagedEngineConfig  # noqa: E402
from repro.serving.engine import PagedInferenceEngine as JPagedInferenceEngine  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    EngineConfig,
    InferenceEngine,
    PagedEngineConfig,
    PagedInferenceEngine,
)
from repro_torch.serving.scheduler import EngineLoop  # noqa: E402


@pytest.fixture(scope="module")
def weights():
    jcfg = j_get_config("smollm-360m", smoke=True).replace(attn_chunk=64)
    tcfg = get_config("smollm-360m", smoke=True).replace(attn_chunk=64)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _engines(weights, **kw):
    jcfg, tcfg, jparams, tparams = weights
    j = JPagedInferenceEngine(jcfg, JPagedEngineConfig(**kw), params=jparams)
    t = PagedInferenceEngine(tcfg, PagedEngineConfig(**kw), params=tparams, device="cpu")
    return j, t


def _prompts(vocab: int, lengths, base: int = 0):
    return [[int(x) for x in np.random.default_rng(base + i).integers(1, vocab, n)]
            for i, n in enumerate(lengths)]


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
        pytest.fail(f"prompt {prompt}: token {j} differs (jax {a}, port {b}); "
                    f"top-2 logit gap there {float(top2[0] - top2[1]):.3e}")


@pytest.mark.parametrize("chunk_tokens", [0, 16], ids=["whole_prompt", "chunked"])
def test_engine_greedy_tokens_match_jax(weights, chunk_tokens):
    """Prompts shorter than a page, across pages and longer than a chunk;
    more prompts than slots, so admission and release interleave."""
    j, t = _engines(weights, page_size=8, num_pages=33, max_slots=3, max_seq_len=64,
                    max_new_tokens=6, chunk_tokens=chunk_tokens)
    prompts = _prompts(weights[1].vocab_size, [5, 19, 30, 8, 12])
    want = [s.out for s in j.generate(prompts)]
    got = [s.out for s in t.generate(prompts)]
    _assert_same_tokens(weights, prompts, want, got)
    assert t.compile_events == j.compile_events
    assert set(t.capacity_now()) == set(j.capacity_now())
    t.allocator.check_invariants()
    assert t.allocator.used_pages == 0 and all(s is None for s in t.slot_seq)


def test_engine_preemption_resume_matches_jax(weights):
    """Nine usable pages for four sequences: growth starves the pool, the
    newest sequence is preempted and re-prefilled from its context, and
    every stream still equals the reference's."""
    j, t = _engines(weights, page_size=4, num_pages=10, max_slots=4, max_seq_len=32,
                    max_new_tokens=8)
    prompts = [[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12], [2, 4, 6, 1]]
    want = [s.out for s in j.generate(prompts)]
    got = [s.out for s in t.generate(prompts)]
    assert t.preemptions > 0 and j.preemptions > 0
    _assert_same_tokens(weights, prompts, want, got)
    t.allocator.check_invariants()
    assert t.allocator.used_pages == 0


def test_engine_loop_concurrent_submitters_match_jax(weights):
    """Submitter threads into the port's EngineLoop (chunked prefill, one
    shared decode batch) get the tokens the JAX engine's serialized
    generate produces."""
    kw = dict(page_size=8, num_pages=25, max_slots=3, max_seq_len=64, max_new_tokens=5,
              chunk_tokens=16)
    j, t = _engines(weights, **kw)
    prompts = _prompts(weights[1].vocab_size, [6, 17, 9, 25, 3, 11], base=10)
    want = [s.out for s in j.generate(prompts)]
    got = [None] * len(prompts)
    with EngineLoop(t, name="test") as loop:
        def worker(i):
            got[i] = loop.wait(loop.submit(prompts[i]), 120).out

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    _assert_same_tokens(weights, prompts, want, got)
    assert all(s is None for s in t.slot_seq)
    assert t.allocator.free_pages == kw["num_pages"] - 1


@pytest.mark.parametrize("option", [{"spec_tokens": 2}, {"prefix_cache": True}],
                         ids=["spec_tokens", "prefix_cache"])
def test_unported_engine_options_raise(weights, option):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PagedInferenceEngine(weights[1], PagedEngineConfig(**option), params=weights[3],
                             device="cpu")


def test_dense_engine_spec_tokens_is_not_ported(weights):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 3"):
        InferenceEngine(weights[1], EngineConfig(spec_tokens=2), params=weights[3], device="cpu")


def test_fork_is_not_ported(weights):
    eng = PagedInferenceEngine(weights[1], PagedEngineConfig(), params=weights[3], device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.fork(0)


def test_engine_default_device_is_the_card(weights):
    """``device=None`` means the card; without one it raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedInferenceEngine(weights[1], PagedEngineConfig(), params=weights[3])


def _dense(weights, **kw):
    jcfg, tcfg, jparams, tparams = weights
    j = JInferenceEngine(jcfg, JEngineConfig(**kw), params=jparams)
    t = InferenceEngine(tcfg, EngineConfig(**kw), params=tparams, device="cpu")
    return j, t


@pytest.mark.parametrize("variant", [
    {}, {"chunk_tokens": 16}, {"cache_dtype": "bf16"}, {"cache_dtype": "int8"},
    {"cache_dtype": "int8", "chunk_tokens": 16},
], ids=["whole_prompt", "chunked", "bf16", "int8", "int8_chunked"])
def test_dense_engine_greedy_tokens_match_jax(weights, variant):
    """The dense engine's generate(): more prompts than slots, prompts across
    a chunk; each slot's prefill writes its stripe in place."""
    j, t = _dense(weights, max_slots=3, max_len=64, max_new_tokens=6, **variant)
    prompts = _prompts(weights[1].vocab_size, [5, 19, 30, 8, 12], base=20)
    want = [s.out for s in j.generate(prompts)]
    got = [s.out for s in t.generate(prompts)]
    _assert_same_tokens(weights, prompts, want, got)
    assert t.compile_events == j.compile_events
    jc, tc = j.capacity_now(), t.capacity_now()
    assert set(tc) == set(jc)
    for key in ("kv_cache_dtype", "kv_bytes_per_token", "cache_tokens", "free_cache_tokens",
                "tokens_emitted", "chunk_tokens", "total_buckets"):
        assert tc[key] == jc[key], key
    assert all(s is None for s in t.slot_seq) and t.admission_capacity() == 3


def test_dense_engine_rejects_a_chunk_that_does_not_divide_max_len(weights):
    with pytest.raises(ValueError, match="divide"):
        InferenceEngine(weights[1], EngineConfig(max_len=40, chunk_tokens=16), params=weights[3],
                        device="cpu")


def test_dense_engine_loop_concurrent_submitters_match_jax(weights):
    """Submitter threads into an EngineLoop over the dense engine (chunked
    prefill, one shared decode batch) get the JAX engine's tokens."""
    kw = dict(max_slots=3, max_len=64, max_new_tokens=5, chunk_tokens=16)
    j, t = _dense(weights, **kw)
    prompts = _prompts(weights[1].vocab_size, [6, 17, 9, 25, 3, 11], base=30)
    want = [s.out for s in j.generate(prompts)]
    got = [None] * len(prompts)
    with EngineLoop(t, name="dense") as loop:
        def worker(i):
            got[i] = loop.wait(loop.submit(prompts[i]), 120).out

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        assert not any(th.is_alive() for th in threads)
    _assert_same_tokens(weights, prompts, want, got)
    assert all(s is None for s in t.slot_seq)


PAGED_VARIANTS = {
    "int8_whole_prompt": dict(page_size=4, num_pages=33, cache_dtype="int8"),
    "int8_chunked": dict(page_size=4, num_pages=65, cache_dtype="int8", chunk_tokens=16),
    "int8_preempt": dict(page_size=4, num_pages=10, cache_dtype="int8"),
    "chained_f32": dict(page_size=4, num_pages=33, chained_tables=True, table_page_entries=3),
    "chained_int8": dict(page_size=4, num_pages=10, cache_dtype="int8", chained_tables=True),
}


@pytest.mark.parametrize("variant", list(PAGED_VARIANTS))
def test_paged_int8_and_chained_engines_match_jax(weights, variant):
    """The paged engine with an int8 pool (whole-prompt, chunked and
    preemption-resume) and with chained tables (f32 and int8, the latter on
    a pool tight enough to preempt): the JAX engine's greedy streams, table
    rows recycled at the end."""
    kw = dict(max_slots=4, max_seq_len=32, max_new_tokens=8, **PAGED_VARIANTS[variant])
    j, t = _engines(weights, **kw)
    prompts = _prompts(weights[1].vocab_size, [4, 20, 9, 4] if "chunked" in variant else [4] * 4,
                       base=40)
    want = [s.out for s in j.generate(prompts)]
    got = [s.out for s in t.generate(prompts)]
    _assert_same_tokens(weights, prompts, want, got)
    assert t.preemptions == j.preemptions
    if "preempt" in variant or variant == "chained_int8":
        assert t.preemptions > 0
    snap = t.capacity_now()
    assert snap["kv_cache_dtype"] == j.capacity_now()["kv_cache_dtype"]
    assert snap["kv_bytes_per_token"] == j.capacity_now()["kv_bytes_per_token"]
    t.allocator.check_invariants()
    assert t.allocator.used_pages == 0
    if t.chain is not None:
        t.chain.check_invariants(t.pcfg.max_slots)
        assert t.chain.free_rows == t.chain.l2.shape[0] - 1


def test_chained_engine_admits_a_prompt_its_flat_twin_cannot(weights):
    """A 200-token prompt over a 32-page pool: the flat engine cannot be
    built (its table is wider than the pool), the chained one re-derives its
    length cap from the pool, completes the prompt with the JAX chained
    engine's tokens, and rejects a prompt longer than the pool."""
    jcfg, tcfg, jparams, tparams = weights
    prompt = [int(x) for x in np.random.default_rng(0).integers(1, tcfg.vocab_size, 200)]
    flat = dict(page_size=8, num_pages=33, max_slots=2, max_seq_len=1024, max_new_tokens=4)
    with pytest.raises(ValueError, match="num_pages"):
        PagedInferenceEngine(tcfg, PagedEngineConfig(**flat), params=tparams, device="cpu")
    t = PagedInferenceEngine(tcfg, dataclasses.replace(PagedEngineConfig(**flat), chained_tables=True),
                             params=tparams, device="cpu")
    j = JPagedInferenceEngine(jcfg, JPagedEngineConfig(**flat, chained_tables=True), params=jparams)
    assert t._len_cap == j._len_cap == 256
    got, want = t.generate([prompt]), j.generate([prompt])
    assert len(got[0].out) == 4 and got[0].done
    _assert_same_tokens(weights, [prompt], [want[0].out], [got[0].out])
    t.allocator.check_invariants()
    t.chain.check_invariants(t.pcfg.max_slots)
    with pytest.raises(ValueError, match="length cap"):
        t.submit([1] * 300)
