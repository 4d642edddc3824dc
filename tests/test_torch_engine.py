"""The port's paged serving engine (src/repro_torch/serving) against the JAX
package's ``PagedInferenceEngine`` on the CPU: smollm-360m SMOKE in f32, the
same weights (bridged with ``params_from_jax``), the same engine settings,
and identical greedy ``Sequence.out`` for whole-prompt prefill, chunked
prefill, a preemption-resume run on a tight pool, and an ``EngineLoop`` fed
by concurrent submitters. A flipped token is reported with the top-2 logit
gap at that step, from the port's teacher-forced forward."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.serving.engine import PagedEngineConfig as JPagedEngineConfig  # noqa: E402
from repro.serving.engine import PagedInferenceEngine as JPagedInferenceEngine  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402
from repro_torch.serving.engine import PagedEngineConfig, PagedInferenceEngine  # noqa: E402
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


@pytest.mark.parametrize("option", [
    {"spec_tokens": 2}, {"prefix_cache": True}, {"chained_tables": True}, {"cache_dtype": "int8"},
], ids=["spec_tokens", "prefix_cache", "chained_tables", "int8"])
def test_unported_engine_options_raise(weights, option):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PagedInferenceEngine(weights[1], PagedEngineConfig(**option), params=weights[3],
                             device="cpu")


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
