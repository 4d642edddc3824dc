"""The port's Mamba mixer (src/repro_torch/models/mamba.py) and the jamba
hybrid (jamba-1.5-large-398b) against the JAX package on the CPU.

The JAX SMOKE tree goes over the bridge with ``conv_b``, ``dt_bias`` and
``A_log`` (zeros in the JAX init) drawn from a seeded normal in both trees,
so that a transposed A or a dropped bias moves the outputs. ``mamba_mixer``
in prefill (one chunk, several, S not a multiple of the chunk; with and
without a padding mask at several valid counts, 0 included; from a zero and
a non-zero cache) and decode (S 1 and 3): output and new cache within f32
2e-5 of JAX's. jamba SMOKE at its default, binding capacity: the logits of
the whole-sequence forward, of the dense prefill (padded), chunked prefill
(the Mamba carry across chunks) and decode, and of the paged ones, within
f32 2e-5. The dense and paged engines' greedy streams equal the JAX
engines' with no drop possible (capacity factor 8, as the JAX package's
engine tests run jamba). Every guard raises as JAX's does.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import jamba_15_large as j_jamba  # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.engine import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serving.engine import PagedEngineConfig as JPagedEngineConfig  # noqa: E402
from repro.serving.engine import PagedInferenceEngine as JPagedInferenceEngine  # noqa: E402
from repro_torch.configs import jamba_15_large  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import mamba as tmamba  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    EngineConfig,
    InferenceEngine,
    PagedEngineConfig,
    PagedInferenceEngine,
)

TOL = 2e-5                     # f32, tests/test_kernels.py:17
ARCH = "jamba-1.5-large-398b"
ZEROS = ("conv_b", "dt_bias", "A_log")     # the Mamba leaves the JAX init sets to zeros
NP, PS, P = 16, 8, 6
# the reference's forward compiled once per shape, so that the chunks and
# decode steps of one shape share a compile
JFORWARD = jax.jit(jtf.forward, static_argnums=(0, 1), static_argnames=("mode",))
JMIXER = jax.jit(jmamba.mamba_mixer, static_argnums=(0, 3))


def _abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


def _t(a) -> np.ndarray:
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _weights(capacity_factor=None):
    """JAX and port configs (SMOKE, attn_chunk 64) and trees: the JAX init,
    its ZEROS leaves drawn standard normal from numpy's seed 7."""
    jcfg = j_get_config(ARCH, smoke=True).replace(attn_chunk=64)
    tcfg = get_config(ARCH, smoke=True).replace(attn_chunk=64)
    if capacity_factor is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, capacity_factor=capacity_factor))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, capacity_factor=capacity_factor))
    tree = jax.tree.map(np.asarray, j_get_model(jcfg).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    for key, leaves in tree["blocks"].items():
        for name in ZEROS:
            if key.endswith("_mixer") and name in leaves:
                leaves[name] = rng.standard_normal(leaves[name].shape).astype(np.float32)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), params_from_jax(tree, tcfg, "cpu")


@pytest.fixture(scope="module")
def weights():
    return _weights()


# ---------------------------------------------------------------------------
# The mixer
# ---------------------------------------------------------------------------


def _layer(tree, li):
    return {k: v[0] for k, v in tree["blocks"][f"l{li}_mixer"].items()}


# (mode, S, n_valid per row or None, cache: "none" | "zero" | "random")
MIXER_CASES = {
    "prefill_one_chunk": ("prefill", 8, None, "zero"),
    "prefill_three_chunks_resumed": ("prefill", 24, None, "random"),
    "prefill_S_not_a_multiple": ("prefill", 13, None, "random"),
    "prefill_below_one_chunk_no_cache": ("prefill", 5, None, "none"),
    "prefill_valid_13_6": ("prefill", 13, [13, 6], "random"),
    "prefill_valid_16_0": ("prefill", 16, [16, 0], "zero"),
    "prefill_valid_20_9_resumed": ("prefill", 24, [20, 9], "random"),
    "prefill_valid_1_3_below_one_chunk": ("prefill", 4, [1, 3], "random"),
    "decode_S1": ("decode", 1, None, "random"),
    "decode_S3": ("decode", 3, None, "random"),
}


@pytest.mark.parametrize("case", list(MIXER_CASES))
def test_mamba_mixer_matches_jax(weights, case):
    """One Mamba layer of the SMOKE tree (d_inner 128, d_state 4, chunk 8),
    B 2: the output, and the new conv and ssm state, within f32 2e-5 of
    ``repro.models.mamba.mamba_mixer`` on the same inputs."""
    jcfg, tcfg, jparams, tparams = weights
    mode, S, nv, kind = MIXER_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    B = 2
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    dI, _, dS = tmamba._dims(tcfg)
    assert (dI, dS) == jmamba._dims(jcfg)[::2]
    cache = None
    if kind != "none":
        conv = np.zeros((B, tcfg.mamba.d_conv - 1, dI), np.float32)
        ssm = np.zeros((B, dI, dS), np.float32)
        if kind == "random":
            conv, ssm = rng.standard_normal(conv.shape).astype(np.float32), \
                rng.standard_normal(ssm.shape).astype(np.float32)
        cache = {"conv": conv, "ssm": ssm}
    valid = None if nv is None else np.arange(S)[None, :] < np.array(nv)[:, None]
    oj, cj = JMIXER(jcfg, jax.tree.map(lambda a: a[0], jparams["blocks"]["l0_mixer"]),
                    jnp.asarray(x), mode,
                    None if cache is None else {k: jnp.asarray(v) for k, v in cache.items()},
                    valid=None if valid is None else jnp.asarray(valid))
    ot, ct = tmamba.mamba_mixer(tcfg, _layer(tparams, 0), torch.from_numpy(x), mode,
                                None if cache is None else {k: torch.from_numpy(v) for k, v in cache.items()},
                                valid=None if valid is None else torch.from_numpy(valid))
    assert ot.shape == (B, S, tcfg.d_model)
    assert _abs(_t(ot), oj) < TOL
    if cache is None:
        assert ct is None and cj is None
        return
    assert set(ct) == set(cj) == {"conv", "ssm"}
    assert ct["ssm"].dtype == torch.float32 and tuple(ct["conv"].shape) == cache["conv"].shape
    for name in ("conv", "ssm"):
        assert _abs(_t(ct[name]), cj[name]) < TOL, name


def test_pad_steps_leave_the_state_as_the_unpadded_prefill():
    """A right-padded prefill (valid 5 of 12) ends in the state of the
    5-token prefill: dt masked to 0 makes each pad step identity, and the
    conv state is gathered at the last valid token."""
    cfg = get_config(ARCH, smoke=True)
    p = {k: v[0] for k, v in get_model(cfg).init(torch.Generator().manual_seed(1))["blocks"]["l0_mixer"].items()}
    x = torch.randn(1, 12, cfg.d_model, generator=torch.Generator().manual_seed(2))
    cache = {n: torch.zeros(s.shape, dtype=s.dtype) for n, s in tmamba.mamba_cache_defs(cfg, 1).items()}
    out_p, cp = tmamba.mamba_mixer(cfg, p, x, "prefill", cache, valid=torch.arange(12)[None] < 5)
    out_u, cu = tmamba.mamba_mixer(cfg, p, x[:, :5], "prefill", cache)
    assert float((out_p[:, :5] - out_u).abs().max()) < TOL
    assert torch.equal(cp["conv"], cu["conv"])
    assert float((cp["ssm"] - cu["ssm"]).abs().max()) < TOL


# ---------------------------------------------------------------------------
# Configs and the bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["FULL", "SMOKE"])
def test_config_field_for_field(which):
    """Every field of the port's ModelConfig equals JAX's (dtypes by name,
    the Mamba and MoE configs field for field); JAX's training and
    sharding fields (remat, ce_chunks, ...) have no twin."""
    mine, theirs = getattr(jamba_15_large, which), getattr(j_jamba, which)
    for f in dataclasses.fields(ModelConfig):
        a, b = getattr(mine, f.name), getattr(theirs, f.name)
        if f.name in ("param_dtype", "compute_dtype", "kv_cache_dtype") and a is not None:
            assert str(a).replace("torch.", "") == np.dtype(b).name, f.name
        elif f.name in ("moe", "mamba"):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name
    assert get_config(ARCH, smoke=which == "SMOKE") is mine
    assert jamba_15_large.SKIP_SHAPES == j_jamba.SKIP_SHAPES == {}
    assert [mine.layer_has_moe(i) for i in range(8)] == [False, True] * 4


def test_bridge_carries_the_mamba_leaves(weights):
    """Every Mamba leaf of every layer bit for bit, the drawn ZEROS leaves
    among them; shapes as the port's defs give them."""
    jcfg, tcfg, jparams, tparams = weights
    dI, dtR, dS = tmamba._dims(tcfg)
    want = {"in_proj": (64, 2 * dI), "conv_w": (4, dI), "conv_b": (dI,), "x_proj": (dI, dtR + 2 * dS),
            "dt_proj": (dtR, dI), "dt_bias": (dI,), "A_log": (dI, dS), "D": (dI,), "out_proj": (dI, 64)}
    for i, kind in enumerate(tcfg.block_pattern):
        leaves = tparams["blocks"][f"l{i}_mixer"]
        if kind != "mamba":
            continue
        assert {n: tuple(t.shape[1:]) for n, t in leaves.items()} == want
        for n, t in leaves.items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(jparams["blocks"][f"l{i}_mixer"][n]))
        assert float(leaves["A_log"].abs().sum()) > 0


# ---------------------------------------------------------------------------
# The model at binding capacity
# ---------------------------------------------------------------------------


def _logits_j(jparams, h):
    return np.asarray(jnp.einsum("bsd,dv->bsv", h, jparams["unembed"]), np.float32)


def _logits_t(tparams, h):
    return (h @ tparams["unembed"]).float().numpy()


def _close(jh, th, jparams, tparams, rows=None, n=None):
    a, b = _logits_j(jparams, jh), _logits_t(tparams, th)
    if rows is not None:
        a, b = a[rows], b[rows]
    d = np.max(np.abs(a[:, :n] - b[:, :n]))
    assert d < TOL, d


def test_forward_logits_match_jax(weights):
    """The whole-sequence forward over two 21-token rows (each spans three
    Mamba chunks, 21 not a multiple of 8: one chunk of 21)."""
    jcfg, tcfg, jparams, tparams = weights
    toks = np.random.default_rng(12).integers(1, tcfg.vocab_size, (2, 21))
    pos = np.broadcast_to(np.arange(21, dtype=np.int32), (2, 21))
    jh, _, _ = jtf.forward(jcfg, None, jparams, tokens=jnp.asarray(toks), positions=jnp.asarray(pos),
                           mode="train")
    th, _ = ttf.forward(tcfg, tparams, torch.from_numpy(toks), torch.from_numpy(pos.copy()), mode="train")
    _close(jh, th, jparams, tparams)


def _states_close(jcache, tcache, slots):
    """The Mamba states of ``slots``: conv absolute, ssm relative to its
    largest reference magnitude (a sum over every token so far), 2e-5."""
    for key, leaves in jcache["blocks"].items():
        for name, a in leaves.items():
            if name in ("conv", "ssm"):
                a = np.asarray(a, np.float32)[:, slots]
                d = _abs(_t(tcache["blocks"][key][name])[:, slots], a)
                if name == "ssm":
                    d /= max(float(np.max(np.abs(a))), 1.0)
                assert d < TOL, (key, name, d, float(np.max(np.abs(a))))


def test_dense_prefill_chunks_and_decode_logits_match_jax(weights):
    """Slot 0 prefilled whole (11 tokens padded to 16, masked by n_valid),
    slot 1 in chunks of 8 (the last padded; the Mamba carry crosses calls
    and is installed after the last), slot 2 idle holding slot 0's token;
    three batched decode steps. Logits and every slot's Mamba state within
    f32 2e-5 of JAX's, at the default capacity factor."""
    jcfg, tcfg, jparams, tparams = weights
    jm, tm = j_get_model(jcfg), get_model(tcfg)
    rng = np.random.default_rng(3)
    B, CAP = 3, 40
    jcache = jtf.init_cache(jcfg, B, CAP)
    tcache = tm.init_cache(B, CAP, "cpu")

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
    nv = np.array([11], np.int32)
    jh, m, _ = JFORWARD(jcfg, None, jparams, tokens=jnp.asarray(toks), positions=jnp.asarray(pos),
                           mode="prefill", cache=jtf.init_cache(jcfg, 1, CAP), cache_index=0,
                           n_valid=jnp.asarray(nv))
    jcache = put(0, m)
    th, _ = ttf.forward(tcfg, tparams, torch.from_numpy(toks).long(), torch.from_numpy(pos),
                        mode="prefill", cache=view(0), cache_index=0, n_valid=torch.from_numpy(nv))
    _close(jh, th, jparams, tparams, n=11)
    last0 = int(np.argmax(_logits_t(tparams, th)[0, 10]))

    b = rng.integers(1, tcfg.vocab_size, 20)
    js, ts = jm.init_chunk_state(), tm.init_chunk_state("cpu")
    for off in (0, 8, 16):
        piece = b[off:off + 8]
        toks = np.zeros((1, 8), np.int32)
        toks[0, :len(piece)] = piece
        pos = np.arange(off, off + 8, dtype=np.int32)[None]
        nv = np.array([len(piece)], np.int32)
        jh, m, js, _ = JFORWARD(jcfg, None, jparams, tokens=jnp.asarray(toks),
                                   positions=jnp.asarray(pos), mode="prefill", cache=mini(1),
                                   chunk_state=js, n_valid=jnp.asarray(nv),
                                   cache_index=jattn.ChunkPrefillIndex(jnp.asarray(off, jnp.int32)))
        jcache = put(1, m)
        th, _, ts = ttf.forward(tcfg, tparams, torch.from_numpy(toks).long(), torch.from_numpy(pos),
                                mode="prefill", cache=view(1), cache_index=tattn.ChunkPrefillIndex(off),
                                n_valid=torch.from_numpy(nv), chunk_state=ts)
        _close(jh, th, jparams, tparams, n=len(piece))
    jcache = jm.install_chunk_state(jcache, js, 1)
    tcache = tm.install_chunk_state(tcache, ts, 1)
    _states_close(jcache, tcache, slice(0, 2))

    lens = np.array([11, 20, 11], np.int32)
    last = np.array([last0, 7, last0], np.int32)        # slot 2 idle: slot 0's token
    for _ in range(3):
        jh, jcache, _ = JFORWARD(jcfg, None, jparams, tokens=jnp.asarray(last[:, None]),
                                    positions=jnp.asarray(lens[:, None]), mode="decode",
                                    cache=jcache, cache_index=jnp.asarray(lens))
        th, tcache = ttf.forward(tcfg, tparams, torch.from_numpy(last[:, None]).long(),
                                 torch.from_numpy(lens[:, None]), mode="decode", cache=tcache,
                                 cache_index=torch.from_numpy(lens))
        _close(jh, th, jparams, tparams)
        last = np.argmax(_logits_t(tparams, th)[:, 0], -1).astype(np.int32)
        last[2] = last[0]
        lens = lens + np.array([1, 1, 0], np.int32)
    _states_close(jcache, tcache, slice(0, 3))


def test_paged_prefill_chunks_and_decode_logits_match_jax(weights):
    """One sequence prefilled whole into slot 0 (11 of 16 tokens valid, from
    zero state), one in three chunks into slot 1 (the carry installed after
    the last), three batched decode steps over four slots (two idle on the
    null page, holding the first slot's token and length). Logits of the
    live rows and their Mamba states within f32 2e-5 of JAX's, at the
    default capacity."""
    jcfg, tcfg, jparams, tparams = weights
    jm, tm = j_get_model(jcfg), get_model(tcfg)
    rng = np.random.default_rng(0)
    jcache = jtf.init_paged_cache(jcfg, 4, NP, PS)
    tcache = ttf.init_paged_cache(tcfg, NP, PS, "cpu", batch=4)
    for key in ttf.recurrent_keys(tcfg):                 # a used slot: prefill starts from zero
        tcache["blocks"][key]["ssm"].normal_(generator=torch.Generator().manual_seed(5))
    row_a = np.array([1, 2, 3, 0, 0, 0], np.int32)
    row_b = np.array([4, 5, 6, 7, 0, 0], np.int32)
    toks = np.zeros(16, np.int32)
    toks[:11] = rng.integers(1, tcfg.vocab_size, 11)
    pos = np.arange(16, dtype=np.int32)[None]
    nv = np.array([11], np.int32)
    jh, jcache, _ = JFORWARD(
        jcfg, None, jparams, tokens=jnp.asarray(toks[None]), positions=jnp.asarray(pos),
        mode="prefill", cache=jcache, n_valid=jnp.asarray(nv),
        cache_index=jattn.PagedPrefillIndex(jnp.asarray(row_a), jnp.asarray(0, jnp.int32)))
    th, tcache = ttf.forward(
        tcfg, tparams, torch.from_numpy(toks[None]).long(), torch.from_numpy(pos), mode="prefill",
        cache=tcache, cache_index=tattn.PagedPrefillIndex(torch.from_numpy(row_a), 0),
        n_valid=torch.from_numpy(nv))
    _close(jh, th, jparams, tparams, n=11)
    last0 = int(np.argmax(_logits_t(tparams, th)[0, 10]))

    b = rng.integers(1, tcfg.vocab_size, 20)
    js, ts = jm.init_chunk_state(), tm.init_chunk_state("cpu")
    for off in (0, 8, 16):
        piece = b[off:off + 8]
        toks = np.zeros(8, np.int32)
        toks[:len(piece)] = piece
        pos = np.arange(off, off + 8, dtype=np.int32)[None]
        nv = np.array([len(piece)], np.int32)
        jh, jcache, js, _ = JFORWARD(
            jcfg, None, jparams, tokens=jnp.asarray(toks[None]), positions=jnp.asarray(pos),
            mode="prefill", cache=jcache, chunk_state=js, n_valid=jnp.asarray(nv),
            cache_index=jattn.PagedChunkPrefillIndex(
                jnp.asarray(row_b), jnp.asarray(1, jnp.int32), jnp.asarray(off, jnp.int32)))
        th, tcache, ts = ttf.forward(
            tcfg, tparams, torch.from_numpy(toks[None]).long(), torch.from_numpy(pos),
            mode="prefill", cache=tcache, n_valid=torch.from_numpy(nv), chunk_state=ts,
            cache_index=tattn.PagedChunkPrefillIndex(torch.from_numpy(row_b), 1, off))
        _close(jh, th, jparams, tparams, n=len(piece))
    jcache = jm.install_chunk_state(jcache, js, 1)
    tcache = tm.install_chunk_state(tcache, ts, 1)
    _states_close(jcache, tcache, slice(0, 2))

    tab = np.zeros((4, P), np.int32)
    tab[0], tab[1] = row_a, row_b
    lens = np.array([11, 20, 11, 11], np.int32)
    last = np.array([last0, 7, last0, last0], np.int32)
    for _ in range(3):
        jidx = jattn.PagedIndex(jnp.asarray(lens), jnp.asarray(tab))
        tidx = tattn.PagedIndex(torch.from_numpy(lens), torch.from_numpy(tab))
        jh, jcache, _ = JFORWARD(jcfg, None, jparams, tokens=jnp.asarray(last[:, None]),
                                    positions=jnp.asarray(lens[:, None]), mode="decode",
                                    cache=jcache, cache_index=jidx)
        th, tcache = ttf.forward(tcfg, tparams, torch.from_numpy(last[:, None]).long(),
                                 torch.from_numpy(lens[:, None]), mode="decode", cache=tcache,
                                 cache_index=tidx)
        _close(jh, th, jparams, tparams, rows=slice(0, 2))
        last = np.argmax(_logits_t(tparams, th)[:, 0], -1).astype(np.int32)
        last[2:] = last[0]
        lens = lens + np.array([1, 1, 0, 0], np.int32)
    _states_close(jcache, tcache, slice(0, 2))


def test_padded_prefill_matches_unpadded_at_binding_capacity():
    """The twin of tests/test_prefill_padding.py's MoE test on jamba-smoke:
    at the default capacity factor, a prompt padded to 16 with n_valid gives
    the unpadded prompt's token, logits and Mamba state."""
    cfg = get_config(ARCH, smoke=True).replace(attn_chunk=64)
    assert cfg.moe is not None and cfg.moe.capacity_factor < 2.0
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompt = [5, 17, 200, 9, 33, 71, 2, 140, 88, 4, 300]
    n = len(prompt)
    tok_u, cu = model.prefill(params, {"tokens": torch.tensor([prompt])}, cap=32)
    padded = torch.zeros(1, 16, dtype=torch.long)
    padded[0, :n] = torch.tensor(prompt)
    tok_p, cp = model.prefill(params, {"tokens": padded, "n_valid": torch.tensor([n])}, cap=32)
    assert int(tok_u[0]) == int(tok_p[0])
    hu = ttf.forward(cfg, params, torch.tensor([prompt]), torch.arange(n)[None], mode="train")[0]
    hp = ttf.forward(cfg, params, padded, torch.arange(16)[None], mode="train", n_valid=torch.tensor([n]))[0]
    assert float((hu - hp[:, :n]).abs().max()) < TOL
    for key in ttf.recurrent_keys(cfg):
        for name in ("conv", "ssm"):
            assert float((cu["blocks"][key][name] - cp["blocks"][key][name]).abs().max()) < TOL


# ---------------------------------------------------------------------------
# Engines, with no drop possible
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ample():
    """jamba-smoke at capacity factor 8 (C = T at these sizes)."""
    return _weights(capacity_factor=8.0)


def _prompts(vocab: int, lengths, base: int = 40):
    return [[int(x) for x in np.random.default_rng(base + i).integers(1, vocab, n)]
            for i, n in enumerate(lengths)]


ENGINES = {
    "dense_chunk16": ("dense", dict(max_slots=3, max_len=64, chunk_tokens=16)),
    "dense_one_slot_reused": ("dense", dict(max_slots=1, max_len=64)),
    "paged_whole_prompt": ("paged", dict(page_size=8, num_pages=33, max_slots=2, max_seq_len=64)),
    "paged_chunk16": ("paged", dict(page_size=8, num_pages=33, max_slots=3, max_seq_len=64,
                                    chunk_tokens=16)),
    "paged_int8_chained": ("paged", dict(page_size=8, num_pages=33, max_slots=3, max_seq_len=64,
                                         cache_dtype="int8", chained_tables=True, table_page_entries=2)),
}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_engine_greedy_streams_match_jax(ample, engine):
    """The port's dense and paged engines emit the JAX engines' greedy
    streams on the same weights: prompts shorter than a page, across pages
    and longer than a chunk, more prompts than slots, so that every slot is
    reused by a later wave after decode steps left Mamba state in it (the
    prewarm too, on the dense engine)."""
    jcfg, tcfg, jparams, tparams = ample
    kind, kw = ENGINES[engine]
    kw = dict(kw, max_new_tokens=6)
    prompts = _prompts(tcfg.vocab_size, [5, 19, 30, 8, 13])
    if kind == "dense":
        j = JInferenceEngine(jcfg, JEngineConfig(**kw), params=jparams)
        t = InferenceEngine(tcfg, EngineConfig(**kw), params=tparams, device="cpu")
        t.prewarm()
    else:
        j = JPagedInferenceEngine(jcfg, JPagedEngineConfig(**kw), params=jparams)
        t = PagedInferenceEngine(tcfg, PagedEngineConfig(**kw), params=tparams, device="cpu")
    want = [s.out for s in j.generate(prompts)]
    got = [s.out for s in t.generate(prompts)]
    assert got == want
    assert t.capacity_now()["kv_bytes_per_token"] == j.capacity_now()["kv_bytes_per_token"]
    if kind == "paged":
        t.allocator.check_invariants()
        assert t.allocator.used_pages == 0


def _drain(eng, want: int):
    done = {}
    for _ in range(200):
        for s in eng.step():
            done[s.sid] = s.out
        if len(done) == want:
            return done
    raise AssertionError(f"{len(done)} of {want} sequences finished")


def test_fork_copies_the_mamba_state(ample):
    """fork() on the paged engine mid-decode: the clone gets the source
    slot's Mamba state (the JAX engine's ``copy_fork`` copies every
    recurrent leaf's row), and both emit the JAX engine's tokens."""
    jcfg, tcfg, jparams, tparams = ample
    kw = dict(page_size=4, num_pages=33, max_slots=3, max_seq_len=32, max_new_tokens=8)
    prompt = _prompts(tcfg.vocab_size, [7], base=3)[0]
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


# ---------------------------------------------------------------------------
# Guards and the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("guard", ["dense_spec", "paged_spec", "paged_prefix_cache"])
def test_engine_guards_refuse_jamba_as_jax_does(ample, guard):
    """Speculative decoding and the prefix cache need an attention-only
    decoder: both packages' engines raise ValueError on jamba."""
    jcfg, tcfg, jparams, tparams = ample
    opt = {"prefix_cache": True} if guard == "paged_prefix_cache" else {"spec_tokens": 4}
    if guard == "dense_spec":
        pairs = ((JInferenceEngine, JEngineConfig, jcfg, jparams, {}),
                 (InferenceEngine, EngineConfig, tcfg, tparams, {"device": "cpu"}))
        kw = dict(max_slots=2, max_len=64, **opt)
    else:
        pairs = ((JPagedInferenceEngine, JPagedEngineConfig, jcfg, jparams, {}),
                 (PagedInferenceEngine, PagedEngineConfig, tcfg, tparams, {"device": "cpu"}))
        kw = dict(page_size=8, num_pages=33, max_slots=2, max_seq_len=64, **opt)
    for eng, ecfg, cfg, params, extra in pairs:
        with pytest.raises(ValueError, match="attention-only"):
            eng(cfg, ecfg(**kw), params=params, **extra)


def test_weights_int8_jamba_forward_matches_jax(weights):
    """Weight-only int8 of the hybrid: JAX's ``quantize_params`` of the SMOKE
    tree (attention, dense FFN, expert and unembed leaves int8; the Mamba
    projections float, as JAX's ``QUANT_LEAVES`` leave them), through the
    bridge: the whole-sequence forward's logits within f32 2e-5 of JAX's at
    the default capacity; the launcher serves it with ``--weights-int8``,
    0 failures."""
    from repro.models.quant import qeinsum as j_qeinsum
    from repro.models.quant import quantize_params as j_quantize_params
    from repro_torch.models.quant import is_quant

    jcfg, tcfg, jparams, _ = weights
    jcfg, tcfg = jcfg.replace(weights_int8=True), tcfg.replace(weights_int8=True)
    jq = j_quantize_params(jparams)
    tq = params_from_jax(jax.tree.map(np.asarray, jq), tcfg, "cpu")
    blocks = tq["blocks"]
    assert is_quant(blocks["l1_ffn"]["w1"]) and blocks["l1_ffn"]["w1"]["q"].ndim == 4
    assert is_quant(blocks["l3_mixer"]["wq"]) and not is_quant(blocks["l0_mixer"]["in_proj"])
    toks = np.random.default_rng(9).integers(1, tcfg.vocab_size, (2, 13)).astype(np.int32)
    pos = np.tile(np.arange(13, dtype=np.int32), (2, 1))
    jh, _, _ = jtf.forward(jcfg, None, jq, tokens=jnp.asarray(toks), positions=jnp.asarray(pos), mode="train")
    want = j_qeinsum("bsd,dv->bsv", jh, jq["unembed"]).astype(jnp.float32)
    got = get_model(tcfg).logits(tq, get_model(tcfg).hidden(tq, toks))
    assert _abs(want, got.numpy()) < TOL
    r = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--weights-int8", "--requests", "2"])
    assert r["metrics"].summary()["failed"] == 0 and is_quant(r["params"]["blocks"]["l1_ffn"]["w2"])


def test_launcher_serves_the_first_four_layers():
    """``--layers 4`` on the SMOKE config serves the superblock's first four
    layers (Mamba, Mamba + MoE, Mamba, attention + MoE): a tree drawn for
    them, and an 8-layer tree passed in, whose first four layers serve (the
    same streams as the tree cut to them)."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--layers", "4", "--requests", "6"]
    r = serve.main(argv)
    m = r["metrics"].summary()
    assert m["total"] == 6 and m["failed"] == 0
    cfg = r["cfg"]
    assert cfg.n_layers == 4 and cfg.block_pattern == ("mamba", "mamba", "mamba", "attn")
    assert [cfg.layer_has_moe(i) for i in range(4)] == [False, True, False, True]
    blocks = r["params"]["blocks"]
    layers = {k.split("_")[0] for k in blocks}
    assert layers == {"l0", "l1", "l2", "l3"}
    assert "router" in blocks["l1_ffn"] and "router" in blocks["l3_ffn"] and "w1" in blocks["l2_ffn"]
    full = get_model(get_config(ARCH, smoke=True)).init(torch.Generator().manual_seed(4))
    cut = {**full, "blocks": {k: v for k, v in full["blocks"].items() if k.split("_")[0] in layers}}
    assert set(cut["blocks"]) == set(blocks)
    got = serve.main(argv, params=full)["results"]
    assert got == serve.main(argv, params=cut)["results"]


@pytest.mark.parametrize("smoke, layers, ok", [(True, 4, True), (True, 8, True), (False, 3, True),
                                               (False, 16, True), (True, 9, False), (True, -1, False),
                                               (False, 12, False), (False, 80, False)])
def test_launcher_layers_rule(smoke, layers, ok, capsys):
    """N from 1 to the pattern's length (8), or a multiple of it up to the
    depth (8 SMOKE, 72 FULL); any other N is an argparse error before
    anything is built."""
    argv = ["--arch", ARCH, "--layers", str(layers)] + (["--smoke"] if smoke else [])
    if ok:
        assert serve.parse_args(argv).layers == layers
        return
    with pytest.raises(SystemExit):
        serve.parse_args(argv)
    assert "--layers" in capsys.readouterr().err
