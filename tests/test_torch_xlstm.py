"""The port's xLSTM family (src/repro_torch/models/xlstm.py and
kernels/mlstm_chunk) against the JAX package on the CPU, on the same inputs
made from a numpy seed: the plain chunkwise mLSTM against the Pallas
``mlstm_chunkwise_bh`` (interpret mode, zero carry), the jnp
``mlstm_chunkwise`` from a non-zero carry and ``mlstm_sequential``; the
pad-tail identity; both mixers in prefill and decode with a cache;
``DecoderLM`` hidden states, logits and chunk carries on bridged weights;
and the dense and paged engines' greedy streams on xlstm-350m SMOKE.

Tolerances: f32 2e-5 (tests/test_kernels.py:17), absolute for h and m and
for mixer outputs, relative to the largest reference magnitude for C, n and
the model's hidden states and logits (eight layers of exponential gating
grow the residual stream); against ``mlstm_sequential`` the bounds of
tests/test_kernels.py:69-71."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.kernels.mlstm_chunk import ops as jmk_ops  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models import xlstm as jxl  # noqa: E402
from repro.models.rotary import positions_for as j_positions_for  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.engine import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serving.engine import PagedEngineConfig as JPagedEngineConfig  # noqa: E402
from repro.serving.engine import PagedInferenceEngine as JPagedInferenceEngine  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels.mlstm_chunk import ops as mk_ops  # noqa: E402
from repro_torch.kernels.mlstm_chunk import ref as mk_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models import xlstm as txl  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    EngineConfig,
    InferenceEngine,
    PagedEngineConfig,
    PagedInferenceEngine,
)
from repro_torch.serving.scheduler import EngineLoop  # noqa: E402

TOL = 2e-5


def _abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def _rel(a, b) -> float:
    """Largest difference over the largest magnitude of the reference b."""
    b = np.asarray(b, np.float32)
    return _abs(a, b) / max(float(np.max(np.abs(b))), 1e-30)


def _t(a) -> np.ndarray:
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _gates(rng, B, S, NH, DH):
    """q, k, v (B, S, NH, DH) and raw gates i, f (B, S, NH), as
    tests/test_kernels.py draws them."""
    q = rng.standard_normal((B, S, NH, DH)).astype(np.float32) * 0.5
    k = rng.standard_normal((B, S, NH, DH)).astype(np.float32) * 0.5
    v = rng.standard_normal((B, S, NH, DH)).astype(np.float32)
    i = rng.standard_normal((B, S, NH)).astype(np.float32)
    f = rng.standard_normal((B, S, NH)).astype(np.float32) + 2.0
    return q, k, v, i, f


def _zero_carry(B, NH, DH):
    return (np.zeros((B, NH, DH, DH), np.float32), np.zeros((B, NH, DH), np.float32),
            np.zeros((B, NH), np.float32))


def _port_chunkwise(args, carry, chunk):
    return mk_ref.mlstm_chunkwise(*(torch.from_numpy(a) for a in args),
                                  *(torch.from_numpy(np.array(c)) for c in carry), chunk=chunk)


def _close_state(got, want):
    (C, n, m), (Cj, nj, mj) = got, want
    assert _rel(_t(C), Cj) < TOL
    assert _rel(_t(n), nj) < TOL
    assert _abs(_t(m), mj) < TOL


# ---------------------------------------------------------------------------
# The chunkwise mLSTM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,NH,DH,chunk",
                         [(2, 128, 2, 64, 32), (1, 64, 4, 128, 64), (2, 96, 1, 64, 32),
                          (1, 40, 2, 32, 16)])
def test_plain_chunkwise_matches_pallas_kernel(B, S, NH, DH, chunk):
    """The TPU kernel's own cases (tests/test_kernels.py:55), run in
    interpret mode from zero state, plus S % chunk != 0 (one chunk of S)."""
    rng = np.random.default_rng(2)
    args = _gates(rng, B, S, NH, DH)
    carry = _zero_carry(B, NH, DH)
    hj, state_j = jmk_ops.mlstm_chunkwise(*map(jnp.asarray, args), *map(jnp.asarray, carry),
                                          chunk=chunk)
    ht, state_t = _port_chunkwise(args, carry, chunk)
    assert ht.shape == (B, S, NH, DH) and ht.dtype == torch.float32
    assert _abs(_t(ht), hj) < TOL
    _close_state(state_t, state_j)


@pytest.mark.parametrize("chunk,S", [(8, 24), (16, 32), (8, 13)])
def test_plain_chunkwise_resumes_from_a_carry_like_jnp(chunk, S):
    """A non-zero carry, taken from ``mlstm_sequential`` over a 9-step
    prefix, into the port's plain version and the jnp ``mlstm_chunkwise``
    (the TPU kernel would drop it)."""
    rng = np.random.default_rng(4)
    B, NH, DH = 2, 2, 32
    pre = _gates(rng, B, 9, NH, DH)
    _, carry = jxl.mlstm_sequential(*map(jnp.asarray, pre), *map(jnp.asarray, _zero_carry(B, NH, DH)))
    assert float(jnp.max(jnp.abs(carry[0]))) > 0.1
    args = _gates(rng, B, S, NH, DH)
    cfg = j_get_config("xlstm-350m", smoke=True)
    cfg = cfg.replace(xlstm=cfg.xlstm.__class__(chunk=chunk))
    hj, state_j = jxl.mlstm_chunkwise(cfg, *map(jnp.asarray, args), *carry)
    ht, state_t = _port_chunkwise(args, [np.asarray(c) for c in carry], chunk)
    assert _abs(_t(ht), hj) < TOL
    _close_state(state_t, state_j)
    tcfg = get_config("xlstm-350m", smoke=True)
    tcfg = tcfg.replace(xlstm=tcfg.xlstm.__class__(chunk=chunk))
    hm, _ = txl.mlstm_chunkwise(tcfg, *(torch.from_numpy(a) for a in args),
                                      *(torch.from_numpy(np.array(c)) for c in carry))
    assert torch.equal(hm, ht)


def test_plain_chunkwise_matches_sequential():
    """Against the sequential recurrence, with tests/test_kernels.py:69-71's
    bounds."""
    rng = np.random.default_rng(6)
    B, S, NH, DH = 2, 64, 2, 32
    args = _gates(rng, B, S, NH, DH)
    carry = _zero_carry(B, NH, DH)
    hs, (Cs, ns, ms) = jxl.mlstm_sequential(*map(jnp.asarray, args), *map(jnp.asarray, carry))
    ht, (C, n, m) = _port_chunkwise(args, carry, 16)
    assert _abs(_t(ht), hs) < 1e-4
    assert _abs(_t(C), Cs) < 1e-3
    assert _abs(_t(m), ms) < 1e-5
    hq, (Cq, nq, mq) = txl.mlstm_sequential(*(torch.from_numpy(a) for a in args),
                                            *(torch.from_numpy(c) for c in carry))
    assert _abs(_t(hq), hs) < TOL
    _close_state((Cq, nq, mq), (Cs, ns, ms))


@pytest.mark.parametrize("chunk", [8, 64])
def test_pad_tail_leaves_the_carry_bit_identical(chunk):
    """Pad steps (i -> NEG, f -> BIG) after the valid ones: an all-pad
    tail leaves (C, n, m) exactly as the valid prefix left them."""
    rng = np.random.default_rng(8)
    B, NH, DH, S = 1, 2, 32, 16
    q, k, v, i, f = _gates(rng, B, 2 * S, NH, DH)
    i[:, S:] = txl.NEG
    f[:, S:] = txl.BIG
    carry = _zero_carry(B, NH, DH)
    _, state_pad = _port_chunkwise((q, k, v, i, f), carry, chunk)
    _, state = _port_chunkwise(tuple(a[:, :S] for a in (q, k, v, i, f)), carry, chunk)
    if chunk == 8:           # whole chunks of pads: bit-identical
        for a, b in zip(state_pad, state):
            assert torch.equal(a, b)
    else:                    # one chunk of 32 holding both: equal to rounding
        _close_state(state_pad, [_t(s) for s in state])


def test_wrapper_takes_the_plain_version_on_cpu():
    rng = np.random.default_rng(9)
    args = [torch.from_numpy(a) for a in _gates(rng, 1, 16, 2, 32)]
    carry = [torch.from_numpy(c) for c in _zero_carry(1, 2, 32)]
    before = mk_ops.mlstm_chunkwise_bh.launches
    h, state = mk_ops.mlstm_chunkwise(*args, *carry, chunk=8)
    h_ref, state_ref = mk_ref.mlstm_chunkwise(*args, *carry, chunk=8)
    assert torch.equal(h, h_ref) and all(torch.equal(a, b) for a, b in zip(state, state_ref))
    assert mk_ops.mlstm_chunkwise_bh.launches == before


@pytest.mark.parametrize("n_valid", [0, 3, 7, 9])
def test_conv_state_at_clamps_like_dynamic_slice(n_valid):
    """The start index clamps into [0, S] (S = 7 here) instead of raising."""
    from repro.models.mamba import conv_state_at as j_conv_state_at

    xp = np.random.default_rng(n_valid).standard_normal((2, 10, 5)).astype(np.float32)
    nv = np.array([n_valid, 2], np.int32)
    want = j_conv_state_at(jnp.asarray(xp), jnp.asarray(nv), 4)
    got = tmamba.conv_state_at(torch.from_numpy(xp), torch.from_numpy(nv), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Mixers and the model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jcfg = j_get_config("xlstm-350m", smoke=True)
    tcfg = get_config("xlstm-350m", smoke=True)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, tcfg, jparams, tparams


def _layer(tree, li):
    return jax.tree.map(lambda a: a[0], tree["blocks"][f"l{li}_mixer"])


def _tlayer(tree, li):
    return {k: v[0] for k, v in tree["blocks"][f"l{li}_mixer"].items()}


def _random_cache(rng, specs):
    """The same random (finite, m moderate) state for both packages."""
    out = {}
    for name, s in specs.items():
        out[name] = (rng.standard_normal(s.shape) * (0.3 if name != "m" else 1.0)).astype(np.float32)
        if name == "n":
            out[name] = np.abs(out[name])
    return out


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_mixers_match_jax(weights, kind, mode):
    """Prefill of a right-padded batch (``valid``) and a 2-step decode, from
    a random cache: outputs to 2e-5, new caches to 2e-5 (C and n relative)."""
    jcfg, tcfg, jparams, tparams = weights
    li = 0 if kind == "mlstm" else 7
    rng = np.random.default_rng(10)
    B, S = 2, (13 if mode == "prefill" else 2)
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    specs = (txl.mlstm_cache_defs if kind == "mlstm" else txl.slstm_cache_defs)(tcfg, B)
    cache = _random_cache(rng, specs)
    valid = None
    if mode == "prefill":
        valid = np.arange(S)[None, :] < np.array([[13], [6]])
    jmix, tmix = getattr(jxl, f"{kind}_mixer"), getattr(txl, f"{kind}_mixer")
    oj, cj = jmix(jcfg, _layer(jparams, li), jnp.asarray(x), mode,
                  {k: jnp.asarray(v) for k, v in cache.items()},
                  valid=None if valid is None else jnp.asarray(valid))
    ot, ct = tmix(tcfg, _tlayer(tparams, li), torch.from_numpy(x), mode,
                  {k: torch.from_numpy(v) for k, v in cache.items()},
                  valid=None if valid is None else torch.from_numpy(valid))
    assert _abs(_t(ot), oj) < TOL
    assert set(ct) == set(cj)
    for name in cj:
        d = _rel(_t(ct[name]), cj[name]) if name in ("C", "n") else _abs(_t(ct[name]), cj[name])
        assert d < TOL, (name, d)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_mlstm_mixer_is_no_noisier_than_the_reference(seed):
    """One mLSTM mixer at xlstm-350m's full width (DH = 512) in bf16, on the
    same bf16 weights and input: the port's mean distance from the f32
    result stays within 1.5x the JAX package's own. bf16 moves this mixer's
    output far more than a matmul's rounding (the exponential gates and the
    head-wise norm amplify it), in both packages alike."""
    from repro.models.common import init_tree

    jcfg, tcfg = j_get_config("xlstm-350m"), get_config("xlstm-350m")
    p32 = init_tree(jax.random.PRNGKey(seed), jxl.mlstm_defs(jcfg), jnp.float32)
    p16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p32)
    x = jnp.asarray(np.random.default_rng(seed).standard_normal((2, 16, 1024)), jnp.bfloat16)
    want, _ = jxl.mlstm_mixer(jcfg.replace(param_dtype=jnp.float32, compute_dtype=jnp.float32),
                              jax.tree.map(lambda a: a.astype(jnp.float32), p16),
                              x.astype(jnp.float32), "prefill")
    oj, _ = jxl.mlstm_mixer(jcfg, p16, x, "prefill")
    pt = {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16) for k, v in p16.items()}
    ot, _ = txl.mlstm_mixer(tcfg, pt, torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16),
                            "prefill")
    want = np.asarray(want)
    e_ref = float(np.mean(np.abs(_t(oj) - want)))
    e_port = float(np.mean(np.abs(_t(ot) - want)))
    assert e_port <= 1.5 * e_ref, (e_port, e_ref)


def test_params_from_jax_takes_the_xlstm_tree(weights):
    """Every leaf bit for bit, the 3-D ``r_gates`` included."""
    jcfg, tcfg, jparams, tparams = weights
    src = jax.tree.map(np.asarray, jparams)
    r = tparams["blocks"]["l7_mixer"]["r_gates"]
    assert r.shape == (tcfg.n_superblocks, tcfg.n_heads, 16, 64)
    assert set(tparams["blocks"]) == set(src["blocks"])
    for key, leaves in src["blocks"].items():
        assert set(leaves) == set(tparams["blocks"][key])
        for name, a in leaves.items():
            np.testing.assert_array_equal(tparams["blocks"][key][name].numpy(), a, err_msg=name)


def test_model_hidden_and_logits_match_jax(weights):
    jcfg, tcfg, jparams, tparams = weights
    toks = np.random.default_rng(12).integers(1, tcfg.vocab_size, (2, 21))
    hj, _, _ = jtf.forward(jcfg, None, jparams, tokens=jnp.asarray(toks),
                           positions=j_positions_for(2, 21), mode="train")
    model = get_model(tcfg)
    ht = model.hidden(tparams, toks)
    assert _rel(_t(ht), hj) < TOL
    lj = jnp.einsum("bsd,dv->bsv", hj, jparams["unembed"])
    assert _rel(_t(model.logits(tparams, ht)), lj) < TOL


def test_paged_prefill_chunks_and_decode_match_jax(weights):
    """One sequence whole-prompt (bucket-padded) into slot 2, one in three
    right-padded chunks with the carry between them and installed into slot
    1, then two batched decode steps over four slots: logits, carries and
    slot states agree with the JAX model."""
    jcfg, tcfg, jparams, tparams = weights
    jm, tm = j_get_model(jcfg), get_model(tcfg)
    rng = np.random.default_rng(14)
    a, b = rng.integers(1, tcfg.vocab_size, 11), rng.integers(1, tcfg.vocab_size, 19)
    NP, PS, P = 8, 8, 4
    jc = jm.init_paged_cache(4, NP, PS)
    tc = tm.init_paged_cache(NP, PS, "cpu", 4)
    row = np.zeros(P, np.int32)
    toks = np.zeros((1, 16), np.int64)
    toks[0, :11] = a
    batch = {"tokens": toks, "n_valid": np.array([11]), "tab_row": row, "slot": 2}
    tj, jc = jm.prefill_paged(None, jparams, {**batch, "tokens": jnp.asarray(toks)}, jc)
    tt, tc = tm.prefill_paged(tparams, batch, tc)
    assert int(tt[0]) == int(tj[0])
    js, ts = jm.init_chunk_state(), tm.init_chunk_state("cpu")
    for off in (0, 8, 16):
        piece = b[off:off + 8]
        ctoks = np.zeros((1, 8), np.int64)
        ctoks[0, :len(piece)] = piece
        cb = {"tokens": ctoks, "n_valid": np.array([len(piece)]), "offset": off,
              "tab_row": row, "slot": 1}
        tj, jc, js = jm.prefill_chunk_paged(None, jparams, {**cb, "tokens": jnp.asarray(ctoks)},
                                            jc, js)
        tt, tc, ts = tm.prefill_chunk_paged(tparams, cb, tc, ts)
        for key in js["blocks"]:
            for name in js["blocks"][key]:
                got, want = _t(ts["blocks"][key][name]), np.asarray(js["blocks"][key][name])
                d = _rel(got, want) if name in ("C", "n") else _abs(got, want)
                assert d < TOL, (off, key, name, d)
    assert int(tt[0]) == int(tj[0])
    jc = jm.install_chunk_state(jc, js, 1)
    tc = tm.install_chunk_state(tc, ts, 1)
    last = np.array([0, int(tt[0]), int(tj[0]), 0])
    lens = np.array([0, 19, 11, 0], np.int32)
    for _ in range(2):
        db = {"token": last[:, None], "lengths": lens, "block_tab": np.zeros((4, P), np.int32)}
        nj, jc = jm.decode(None, jparams, jc, {k: jnp.asarray(v) for k, v in db.items()})
        nt, tc = tm.decode(tparams, tc, db)
        np.testing.assert_array_equal(nt.numpy()[1:3], np.asarray(nj)[1:3])
        last, lens = nt.numpy().astype(np.int64), lens + 1
    for key in jc["blocks"]:
        for name in jc["blocks"][key]:
            got = _t(tc["blocks"][key][name])[:, 1:3]
            want = np.asarray(jc["blocks"][key][name], np.float32)[:, 1:3]
            d = _rel(got, want) if name in ("C", "n") else _abs(got, want)
            assert d < TOL, (key, name, d)


def test_dense_prefill_into_a_used_slot_starts_from_zero_state(weights):
    """``prefill`` into a slot view whose recurrent state an earlier
    sequence left behind gives the logits of a prefill into a fresh cache."""
    _, tcfg, _, tparams = weights
    tm = get_model(tcfg)
    toks = np.random.default_rng(16).integers(1, tcfg.vocab_size, (1, 16))
    fresh_tok, fresh = tm.prefill(tparams, {"tokens": toks, "n_valid": 12}, cap=32)
    cache = tm.init_cache(2, 32, "cpu")
    for leaves in cache["blocks"].values():
        for leaf in leaves.values():
            leaf.normal_()
    view = {"blocks": {k: {n: t[:, 1:2] for n, t in v.items()} for k, v in cache["blocks"].items()}}
    tok, _ = tm.prefill(tparams, {"tokens": toks, "n_valid": 12}, view)
    assert int(tok[0]) == int(fresh_tok[0])
    for key in ttf.recurrent_keys(tcfg):
        for name, leaf in fresh["blocks"][key].items():
            assert torch.equal(cache["blocks"][key][name][:, 1:2], leaf), (key, name)


def test_unknown_mixer_kind_raises_value_error():
    """A mixer kind outside the reference's (attn, mamba, mlstm, slstm)
    raises ValueError(kind), as the JAX package's ``superblock_defs`` does."""
    cfg = get_config("smollm-360m", smoke=True).replace(block_pattern=("attn", "retnet"))
    jcfg = j_get_config("smollm-360m", smoke=True).replace(block_pattern=("attn", "retnet"))
    with pytest.raises(ValueError, match="retnet"):
        get_model(cfg).param_defs()
    with pytest.raises(ValueError, match="retnet"):
        jtf.superblock_defs(jcfg)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------


def _prompts(vocab: int, lengths, base: int = 0):
    return [[int(x) for x in np.random.default_rng(base + i).integers(1, vocab, n)]
            for i, n in enumerate(lengths)]


def _assert_same_tokens(weights, prompts, want, got):
    """Equal greedy streams; on a flip, the step and the port's top-2 logit
    gap there (teacher-forced on the reference's context)."""
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


DENSE_VARIANTS = {
    "whole_prompt": dict(max_slots=2, max_len=64),
    "chunked": dict(max_slots=2, max_len=64, chunk_tokens=16),
    "one_slot_reused": dict(max_slots=1, max_len=64),
}


@pytest.mark.parametrize("variant", list(DENSE_VARIANTS))
def test_dense_engine_greedy_tokens_match_jax(weights, variant):
    """More prompts than slots, so every slot is reused by a later wave
    after decode steps (and, first, prewarm) left state in it; prompts
    across a chunk."""
    jcfg, tcfg, jparams, tparams = weights
    kw = dict(max_new_tokens=5, **DENSE_VARIANTS[variant])
    j = JInferenceEngine(jcfg, JEngineConfig(**kw), params=jparams)
    t = InferenceEngine(tcfg, EngineConfig(**kw), params=tparams, device="cpu")
    t.prewarm()
    prompts = _prompts(tcfg.vocab_size, [5, 19, 30, 8], base=50)
    want = [s.out for s in j.generate(prompts)]
    got = [s.out for s in t.generate(prompts)]
    _assert_same_tokens(weights, prompts, want, got)
    assert set(t.capacity_now()) == set(j.capacity_now())
    assert t.capacity_now()["kv_bytes_per_token"] == j.capacity_now()["kv_bytes_per_token"]


PAGED_VARIANTS = {
    "whole_prompt": dict(page_size=8, num_pages=33, max_slots=3, max_seq_len=48),
    "chunked": dict(page_size=8, num_pages=33, max_slots=3, max_seq_len=48, chunk_tokens=16),
    "preempt": dict(page_size=4, num_pages=10, max_slots=4, max_seq_len=32),
}


@pytest.mark.parametrize("variant", list(PAGED_VARIANTS))
def test_paged_engine_greedy_tokens_match_jax(weights, variant):
    """Whole-prompt, chunked (a chunk splits the longer prompts, the carry
    crosses calls) and a pool tight enough to preempt and resume."""
    jcfg, tcfg, jparams, tparams = weights
    kw = dict(max_new_tokens=6, **PAGED_VARIANTS[variant])
    j = JPagedInferenceEngine(jcfg, JPagedEngineConfig(**kw), params=jparams)
    t = PagedInferenceEngine(tcfg, PagedEngineConfig(**kw), params=tparams, device="cpu")
    lengths = [4] * 4 if variant == "preempt" else [5, 19, 30, 8, 12]
    prompts = _prompts(tcfg.vocab_size, lengths, base=60)
    want = [s.out for s in j.generate(prompts)]
    got = [s.out for s in t.generate(prompts)]
    _assert_same_tokens(weights, prompts, want, got)
    assert t.preemptions == j.preemptions
    if variant == "preempt":
        assert t.preemptions > 0
    assert set(t.capacity_now()) == set(j.capacity_now())
    assert t.compile_events == j.compile_events
    t.allocator.check_invariants()
    assert t.allocator.used_pages == 0


@pytest.mark.parametrize("dense", [False, True], ids=["paged", "dense"])
def test_engine_loop_concurrent_submitters_match_jax(weights, dense):
    """Submitter threads into an EngineLoop (chunked prefill, one shared
    decode batch) get the JAX engine's serialized tokens."""
    jcfg, tcfg, jparams, tparams = weights
    if dense:
        kw = dict(max_slots=3, max_len=64, max_new_tokens=5, chunk_tokens=16)
        j = JInferenceEngine(jcfg, JEngineConfig(**kw), params=jparams)
        t = InferenceEngine(tcfg, EngineConfig(**kw), params=tparams, device="cpu")
    else:
        kw = dict(page_size=8, num_pages=25, max_slots=3, max_seq_len=64, max_new_tokens=5,
                  chunk_tokens=16)
        j = JPagedInferenceEngine(jcfg, JPagedEngineConfig(**kw), params=jparams)
        t = PagedInferenceEngine(tcfg, PagedEngineConfig(**kw), params=tparams, device="cpu")
    prompts = _prompts(tcfg.vocab_size, [6, 17, 9, 25, 3], base=70)
    want = [s.out for s in j.generate(prompts)]
    got = [None] * len(prompts)
    with EngineLoop(t, name="xlstm") as loop:
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


@pytest.mark.parametrize("chunk", ["0", "32"])
def test_launcher_serves_xlstm(chunk):
    r = serve.main(["--arch", "xlstm-350m", "--smoke", "--device", "cpu", "--requests", "6",
                    "--workers", "2", "--prewarm", "--chunk-tokens", chunk])
    m = r["metrics"]
    assert m.total == 6 and m.failure_rate == 0.0, m.summary()
    assert r["cfg"].name == "xlstm-350m"
    assert all(len(out) == 8 for out in r["results"].values())
