"""The MoE family in the port (dbrx-132b, llama4-maverick) against the JAX
package on the CPU.

``moe_core`` and ``moe_ffn`` (output and aux loss) against JAX's single-device
path over expert counts, top-k's, capacity factors and token counts, with
and without a padding mask and with duplicated rows (idle decode slots
holding the same stale token tie exactly: both top-k's must break ties as
``jax.lax.top_k`` does). dbrx-smoke and llama4-smoke at the default, binding
capacity factor: the logits of the dense prefill (padded), chunked prefill,
decode (an idle slot duplicating a live one) and verify, and of the paged
prefill, chunked prefill, decode and verify, within f32 2e-5 of JAX's on the
same weights. The engines' greedy streams equal the JAX engines' with no
drop possible (capacity factor 8, as the JAX package's engine tests run MoE:
idle slots' stale hidden states differ between the packages by design).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import dbrx_132b as j_dbrx  # noqa: E402
from repro.configs import llama4_maverick as j_llama4  # noqa: E402
from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.models import MoECfg as JMoECfg  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving.engine import InferenceEngine as JInferenceEngine  # noqa: E402
from repro.serving.engine import PagedEngineConfig as JPagedEngineConfig  # noqa: E402
from repro.serving.engine import PagedInferenceEngine as JPagedInferenceEngine  # noqa: E402
from repro_torch.configs import dbrx_132b, llama4_maverick  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402
from repro_torch.models.common import ModelConfig, MoECfg  # noqa: E402
from repro_torch.serving.engine import (  # noqa: E402
    EngineConfig,
    InferenceEngine,
    PagedEngineConfig,
    PagedInferenceEngine,
)

TOL = 2e-5                     # f32, tests/test_kernels.py:17
ARCHS = ("dbrx-132b", "llama4-maverick-400b-a17b")
NP, PS, P = 16, 8, 6


def _cfgs(arch: str, **moe_over):
    jcfg = j_get_config(arch, smoke=True).replace(attn_chunk=64)
    tcfg = get_config(arch, smoke=True).replace(attn_chunk=64)
    if moe_over:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe_over))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, **moe_over))
    return jcfg, tcfg


def _weights(arch: str, **moe_over):
    jcfg, tcfg = _cfgs(arch, **moe_over)
    tree = jax.tree.map(np.asarray, j_get_model(jcfg).init(jax.random.PRNGKey(0)))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), params_from_jax(tree, tcfg, "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    return _weights(request.param)


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["FULL", "SMOKE"])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_for_matches_jax(arch, which):
    """capacity_for in Python floats, clamped to [4, n], at n 1-512."""
    jcfg = getattr({"dbrx-132b": j_dbrx, ARCHS[1]: j_llama4}[arch], which)
    tcfg = get_config(arch, smoke=which == "SMOKE")
    assert [tmoe.capacity_for(tcfg, n) for n in range(1, 513)] == \
        [jmoe.capacity_for(jcfg, n) for n in range(1, 513)]


def _layer_case(E, k, cf, T, variant, seed):
    """Inputs of one layer case: x (T, d), f32 router and expert weights
    scaled so that capacity binds (the router favours low experts), a
    ``valid`` mask (the last third of the rows padding) and duplicated rows
    (rows 1..3 copies of row 0)."""
    rng = np.random.default_rng(seed)
    d, f = 16, 32
    x = rng.standard_normal((T, d)).astype(np.float32)
    if "dup" in variant:
        x[1:min(4, T)] = x[0]
    router = (rng.standard_normal((d, E)) + np.linspace(0.6, 0, E)[None] * 0.5).astype(np.float32)
    w1, w3 = (rng.standard_normal((E, d, f)).astype(np.float32) / 4 for _ in range(2))
    w2 = rng.standard_normal((E, f, d)).astype(np.float32) / 6
    valid = None
    if "valid" in variant:
        valid = np.arange(T) < max(1, T - T // 3)
    return x, router, w1, w3, w2, valid


@pytest.mark.parametrize("variant", ["plain", "valid", "dup", "dup+valid"])
@pytest.mark.parametrize("T", [1, 8, 24])
@pytest.mark.parametrize("E,k,cf", [(4, 2, 1.25), (8, 1, 1.25), (16, 4, 1.25), (4, 2, 8.0)])
def test_moe_core_and_ffn_match_jax(E, k, cf, T, variant):
    """moe_core on given logits, and moe_ffn from x (router logits in f32),
    out and aux within f32 2e-5 of JAX's single-device path."""
    jcfg = j_dbrx.SMOKE.replace(moe=JMoECfg(n_experts=E, top_k=k, capacity_factor=cf))
    tcfg = dbrx_132b.SMOKE.replace(moe=MoECfg(n_experts=E, top_k=k, capacity_factor=cf))
    x, router, w1, w3, w2, valid = _layer_case(E, k, cf, T, variant, seed=E * 100 + T)
    cap = tmoe.capacity_for(tcfg, T)
    logits = x @ router
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.from_numpy(valid)
    jout, jaux = jmoe.moe_core(jcfg, jnp.asarray(x), jnp.asarray(logits), jnp.asarray(w1),
                               jnp.asarray(w3), jnp.asarray(w2), 0, cap, valid=jv)
    tout, taux = tmoe.moe_core(tcfg, torch.from_numpy(x), torch.from_numpy(logits), torch.from_numpy(w1),
                               torch.from_numpy(w3), torch.from_numpy(w2), cap, valid=tv)
    assert np.max(np.abs(np.asarray(jout) - tout.numpy())) < TOL
    assert abs(float(jaux) - float(taux)) < TOL

    B = 2 if T % 2 == 0 else 1
    p = {"router": router, "w1": w1, "w3": w3, "w2": w2}
    xb = x.reshape(B, T // B, -1)
    jv = None if valid is None else jnp.asarray(valid.reshape(B, -1))
    tv = None if valid is None else torch.from_numpy(valid.reshape(B, -1))
    jout, jaux = jmoe.moe_ffn(jcfg, None, {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(xb), valid=jv)
    tout, taux = tmoe.moe_ffn(tcfg, {n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(xb),
                              valid=tv)
    assert tout.shape == xb.shape
    assert np.max(np.abs(np.asarray(jout) - tout.numpy())) < TOL
    assert abs(float(jaux) - float(taux)) < TOL


def test_ties_break_to_the_lower_index():
    """top_k keeps jax.lax.top_k's order among equal values; a routing of
    identical rows over capacity keeps the lower-indexed rows."""
    x = torch.tensor([[0.0, 1.0, 0.0, 1.0, 0.5], [2.0, 2.0, 2.0, 2.0, 2.0]])
    v, i = tmoe.top_k(x, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    assert i.tolist() == np.asarray(ji).tolist() == [[1, 3, 4], [0, 1, 2]]
    assert np.array_equal(v.numpy(), np.asarray(jv))
    cfg = dbrx_132b.SMOKE.replace(moe=MoECfg(n_experts=4, top_k=1))
    logits = torch.zeros(6, 4)
    logits[:, 2] = 3.0                                    # six identical rows, all to expert 2
    r = tmoe.route(cfg, logits, 4)
    assert r["sel_idx"][2].tolist() == [0, 1, 2, 3] and bool(r["sel_valid"][2].all())


def test_blocked_draw_on_the_cpu(monkeypatch):
    """A leaf within BLOCK values is one f32 draw, the values of the
    whole-leaf draw; a larger one is drawn a block of its leading axes at a
    time, in order (BLOCK shrunk to 64 values here)."""
    from repro_torch.models import common

    small = common.ParamDef((4, 16), (None, None))
    got = common.init_param(torch.Generator().manual_seed(0), small, torch.float32, "cpu")
    assert torch.equal(got, torch.randn(4, 16, generator=torch.Generator().manual_seed(0)) * 0.5)
    monkeypatch.setattr(common, "BLOCK", 64)
    got = common.init_param(torch.Generator().manual_seed(0), common.ParamDef((3, 4, 8, 8), (None,) * 4),
                            torch.bfloat16, "cpu")
    g = torch.Generator().manual_seed(0)
    want = torch.stack([torch.stack([torch.randn(8, 8, generator=g) for _ in range(4)]) for _ in range(3)])
    assert torch.equal(got, (want * 8 ** -0.5).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# Configs and the bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["FULL", "SMOKE"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_field_for_field(arch, which):
    """Every field of the port's ModelConfig equals JAX's (dtypes by name,
    the MoE config field for field); JAX's training and sharding fields
    (remat, ce_chunks, moe_token_gather, ...) have no twin."""
    mine = getattr({"dbrx-132b": dbrx_132b, ARCHS[1]: llama4_maverick}[arch], which)
    theirs = getattr({"dbrx-132b": j_dbrx, ARCHS[1]: j_llama4}[arch], which)
    for f in dataclasses.fields(ModelConfig):
        a, b = getattr(mine, f.name), getattr(theirs, f.name)
        if f.name in ("param_dtype", "compute_dtype", "kv_cache_dtype") and a is not None:
            assert str(a).replace("torch.", "") == np.dtype(b).name, f.name
        elif f.name == "moe":
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b, f.name
    assert get_config(arch, smoke=which == "SMOKE") is mine
    assert mine.layer_has_moe(0) and mine.family == "moe"


def test_bridge_carries_the_stacked_expert_leaves(weights):
    """router (n_sb, d, E), w1/w3 (n_sb, E, d, f) and w2 (n_sb, E, f, d) land
    bit for bit; a tree without an expert leaf is refused."""
    jcfg, tcfg, jparams, tparams = weights
    ffn, jffn = tparams["blocks"]["l0_ffn"], jparams["blocks"]["l0_ffn"]
    L, d, f, E = tcfg.n_layers, tcfg.d_model, tcfg.d_ff, tcfg.moe.n_experts
    want = {"router": (L, d, E), "w1": (L, E, d, f), "w3": (L, E, d, f), "w2": (L, E, f, d)}
    assert {n: tuple(t.shape) for n, t in ffn.items()} == want
    for n in want:
        np.testing.assert_array_equal(ffn[n].numpy(), np.asarray(jffn[n]))
    tree = jax.tree.map(np.asarray, jparams)
    del tree["blocks"]["l0_ffn"]["w3"]
    with pytest.raises(KeyError):
        params_from_jax(tree, tcfg, "cpu")


# ---------------------------------------------------------------------------
# Model paths at binding capacity
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


def test_dense_prefill_chunk_decode_and_verify_logits_match_jax(weights):
    """Slot 0 prefilled whole (11 tokens padded to 16, masked by n_valid),
    slot 1 in chunks of 8 (the last padded), slot 2 idle holding slot 0's
    token; three batched decode steps; then a 5-token verify of slot 1.
    Logits within f32 2e-5 of JAX's at every step, at the default capacity
    factor."""
    jcfg, tcfg, jparams, tparams = weights
    rng = np.random.default_rng(3)
    B, CAP = 3, 40
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
    nv = np.array([11], np.int32)
    jh, m, _ = jtf.forward(jcfg, None, jparams, tokens=jnp.asarray(toks), positions=jnp.asarray(pos),
                           mode="prefill", cache=jtf.init_cache(jcfg, 1, CAP), cache_index=0,
                           n_valid=jnp.asarray(nv))
    jcache = put(0, m)
    th, _ = ttf.forward(tcfg, tparams, torch.from_numpy(toks).long(), torch.from_numpy(pos),
                        mode="prefill", cache=view(0), cache_index=0, n_valid=torch.from_numpy(nv))
    _close(jh, th, jparams, tparams, n=11)
    last0 = int(np.argmax(_logits_t(tparams, th)[0, 10]))

    b = rng.integers(1, tcfg.vocab_size, 20)
    for off in (0, 8, 16):
        piece = b[off:off + 8]
        toks = np.zeros((1, 8), np.int32)
        toks[0, :len(piece)] = piece
        pos = np.arange(off, off + 8, dtype=np.int32)[None]
        nv = np.array([len(piece)], np.int32)
        jh, m, _, _ = jtf.forward(jcfg, None, jparams, tokens=jnp.asarray(toks),
                                  positions=jnp.asarray(pos), mode="prefill", cache=mini(1),
                                  chunk_state=jtf.init_chunk_state(jcfg), n_valid=jnp.asarray(nv),
                                  cache_index=jattn.ChunkPrefillIndex(jnp.asarray(off, jnp.int32)))
        jcache = put(1, m)
        th, _ = ttf.forward(tcfg, tparams, torch.from_numpy(toks).long(), torch.from_numpy(pos),
                            mode="prefill", cache=view(1), cache_index=tattn.ChunkPrefillIndex(off),
                            n_valid=torch.from_numpy(nv))
        _close(jh, th, jparams, tparams, n=len(piece))

    lens = np.array([11, 20, 11], np.int32)
    last = np.array([last0, 7, last0], np.int32)        # slot 2 idle: slot 0's token, a tie
    for _ in range(3):
        jh, jcache, _ = jtf.forward(jcfg, None, jparams, tokens=jnp.asarray(last[:, None]),
                                    positions=jnp.asarray(lens[:, None]), mode="decode",
                                    cache=jcache, cache_index=jnp.asarray(lens))
        th, tcache = ttf.forward(tcfg, tparams, torch.from_numpy(last[:, None]).long(),
                                 torch.from_numpy(lens[:, None]), mode="decode", cache=tcache,
                                 cache_index=torch.from_numpy(lens))
        _close(jh, th, jparams, tparams, rows=slice(0, 2))
        last = np.argmax(_logits_t(tparams, th)[:, 0], -1).astype(np.int32)
        last[2] = last[0]
        lens = lens + np.array([1, 1, 0], np.int32)

    off = int(lens[1])                                     # a verify pass: 5 tokens at 23
    toks = np.array([[int(last[1]), 3, 1, 4, 1]], np.int32)
    pos = np.arange(off, off + 5, dtype=np.int32)[None]
    jh, _, _, _ = jtf.forward(jcfg, None, jparams, tokens=jnp.asarray(toks), positions=jnp.asarray(pos),
                              mode="prefill", cache=mini(1), chunk_state=jtf.init_chunk_state(jcfg),
                              cache_index=jattn.ChunkPrefillIndex(jnp.asarray(off, jnp.int32)))
    th, _ = ttf.forward(tcfg, tparams, torch.from_numpy(toks).long(), torch.from_numpy(pos),
                        mode="prefill", cache=view(1), cache_index=tattn.ChunkPrefillIndex(off))
    _close(jh, th, jparams, tparams)


def test_paged_prefill_chunk_decode_and_verify_logits_match_jax(weights):
    """One sequence prefilled whole (11 of 16 tokens valid), one in three
    chunks, three batched decode steps over four slots (two idle, holding
    the first slot's token and length), then a 4-token verify at a mid-page
    offset. Logits within f32 2e-5 of JAX's, at the default capacity."""
    jcfg, tcfg, jparams, tparams = weights
    rng = np.random.default_rng(0)
    jcache = jtf.init_paged_cache(jcfg, 4, NP, PS)
    tcache = ttf.init_paged_cache(tcfg, NP, PS, "cpu")
    row_a = np.array([1, 2, 3, 0, 0, 0], np.int32)
    row_b = np.array([4, 5, 6, 7, 0, 0], np.int32)
    toks = np.zeros(16, np.int32)
    toks[:11] = rng.integers(1, tcfg.vocab_size, 11)
    pos = np.arange(16, dtype=np.int32)[None]
    nv = np.array([11], np.int32)
    jh, jcache, _ = jtf.forward(
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
    for off in (0, 8, 16):
        piece = b[off:off + 8]
        toks = np.zeros(8, np.int32)
        toks[:len(piece)] = piece
        pos = np.arange(off, off + 8, dtype=np.int32)[None]
        nv = np.array([len(piece)], np.int32)
        jh, jcache, _, _ = jtf.forward(
            jcfg, None, jparams, tokens=jnp.asarray(toks[None]), positions=jnp.asarray(pos),
            mode="prefill", cache=jcache, chunk_state=jtf.init_chunk_state(jcfg), n_valid=jnp.asarray(nv),
            cache_index=jattn.PagedChunkPrefillIndex(
                jnp.asarray(row_b), jnp.asarray(1, jnp.int32), jnp.asarray(off, jnp.int32)))
        th, tcache = ttf.forward(
            tcfg, tparams, torch.from_numpy(toks[None]).long(), torch.from_numpy(pos),
            mode="prefill", cache=tcache, n_valid=torch.from_numpy(nv),
            cache_index=tattn.PagedChunkPrefillIndex(torch.from_numpy(row_b), 1, off))
        _close(jh, th, jparams, tparams, n=len(piece))

    tab = np.zeros((4, P), np.int32)
    tab[0], tab[1] = row_a, row_b
    lens = np.array([11, 20, 11, 11], np.int32)
    last = np.array([last0, 7, last0, last0], np.int32)
    for _ in range(3):
        jidx = jattn.PagedIndex(jnp.asarray(lens), jnp.asarray(tab))
        tidx = tattn.PagedIndex(torch.from_numpy(lens), torch.from_numpy(tab))
        jh, jcache, _ = jtf.forward(jcfg, None, jparams, tokens=jnp.asarray(last[:, None]),
                                    positions=jnp.asarray(lens[:, None]), mode="decode",
                                    cache=jcache, cache_index=jidx)
        th, tcache = ttf.forward(tcfg, tparams, torch.from_numpy(last[:, None]).long(),
                                 torch.from_numpy(lens[:, None]), mode="decode", cache=tcache,
                                 cache_index=tidx)
        _close(jh, th, jparams, tparams, rows=slice(0, 2))
        last = np.argmax(_logits_t(tparams, th)[:, 0], -1).astype(np.int32)
        last[2:] = last[0]
        lens = lens + np.array([1, 1, 0, 0], np.int32)

    off = int(lens[0])                                     # 14: mid-page
    toks = np.array([[int(last[0]), 2, 7, 1]], np.int32)
    pos = np.arange(off, off + 4, dtype=np.int32)[None]
    jh, jcache, _ = jtf.forward(
        jcfg, None, jparams, tokens=jnp.asarray(toks), positions=jnp.asarray(pos), mode="prefill",
        cache=jcache, cache_index=jattn.PagedVerifyIndex(jnp.asarray(row_a), jnp.asarray(off, jnp.int32)))
    th, tcache = ttf.forward(tcfg, tparams, torch.from_numpy(toks).long(), torch.from_numpy(pos),
                             mode="prefill", cache=tcache,
                             cache_index=tattn.PagedVerifyIndex(torch.from_numpy(row_a), off))
    _close(jh, th, jparams, tparams)


def test_padded_prefill_matches_unpadded_at_binding_capacity():
    """The twin of tests/test_prefill_padding.py's MoE test on dbrx-smoke:
    at the default capacity factor, a prompt padded to 16 with n_valid gives
    the unpadded prompt's token and logits (capacity of the valid count)."""
    cfg = get_config("dbrx-132b", smoke=True).replace(attn_chunk=64)
    assert cfg.moe.capacity_factor < 2.0
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompt = [5, 17, 200, 9, 33, 71, 2, 140, 88, 4, 300]
    n = len(prompt)
    tok_u, _ = model.prefill(params, {"tokens": torch.tensor([prompt])}, cap=32)
    padded = torch.zeros(1, 16, dtype=torch.long)
    padded[0, :n] = torch.tensor(prompt)
    tok_p, _ = model.prefill(params, {"tokens": padded, "n_valid": torch.tensor([n])}, cap=32)
    assert int(tok_u[0]) == int(tok_p[0])
    hu = ttf.forward(cfg, params, torch.tensor([prompt]), torch.arange(n)[None], mode="train")[0]
    hp = ttf.forward(cfg, params, padded, torch.arange(16)[None], mode="train", n_valid=torch.tensor([n]))[0]
    assert float((hu - hp[:, :n]).abs().max()) < TOL


# ---------------------------------------------------------------------------
# Engines, with no drop possible
# ---------------------------------------------------------------------------


def _prompts(vocab: int, lengths):
    return [[int(x) for x in np.random.default_rng(40 + i).integers(1, vocab, n)]
            for i, n in enumerate(lengths)]


@pytest.fixture(scope="module")
def ample():
    """dbrx-smoke and llama4-smoke at capacity factor 8 (C = T at these
    sizes), JAX and port weights."""
    return {arch: _weights(arch, capacity_factor=8.0) for arch in ARCHS}


ENGINES = {"dense_whole_prompt": ("dense", {}), "dense_chunk16": ("dense", {"chunk_tokens": 16}),
           "paged_bf16_whole_prompt": ("paged", {"cache_dtype": "bf16"}),
           "paged_f32_chunk16": ("paged", {"chunk_tokens": 16}),
           "paged_int8_chained": ("paged", {"cache_dtype": "int8", "chained_tables": True,
                                            "table_page_entries": 2}),
           "paged_spec4": ("paged", {"spec_tokens": 4}), "dense_spec4": ("dense", {"spec_tokens": 4})}


@pytest.mark.parametrize("arch,engine", [("dbrx-132b", e) for e in ENGINES] + [
    (ARCHS[1], e) for e in ("dense_chunk16", "paged_int8_chained", "paged_spec4")])
def test_engine_greedy_streams_match_jax(ample, arch, engine):
    """The port's dense and paged engines emit the JAX engines' greedy
    streams on the same weights: prompts shorter than a page, across pages
    and longer than a chunk, more prompts than slots; spec on is the twin of
    the JAX package's test_spec_parity_on_moe_arch. Every engine on dbrx,
    three on llama4."""
    jcfg, tcfg, jparams, tparams = ample[arch]
    kind, extra = ENGINES[engine]
    prompts = _prompts(tcfg.vocab_size, [5, 19, 30, 8])
    if kind == "dense":
        kw = dict(max_slots=3, max_len=64, max_new_tokens=6, **extra)
        j = JInferenceEngine(jcfg, JEngineConfig(**kw), params=jparams)
        t = InferenceEngine(tcfg, EngineConfig(**kw), params=tparams, device="cpu")
    else:
        kw = dict(page_size=8, num_pages=33, max_slots=3, max_seq_len=64, max_new_tokens=6, **extra)
        j = JPagedInferenceEngine(jcfg, JPagedEngineConfig(**kw), params=jparams)
        t = PagedInferenceEngine(tcfg, PagedEngineConfig(**kw), params=tparams, device="cpu")
    want = [s.out for s in j.generate(prompts)]
    got = [s.out for s in t.generate(prompts)]
    assert got == want
    if "spec" in engine:
        assert t.spec_accepted == j.spec_accepted


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def test_weights_int8_moe_ffn_matches_jax():
    """Weight-only int8 of the MoE family: ``moe_ffn`` on JAX's
    ``quantize_params`` of a layer (int8 (E, d, f) expert leaves with (E, 1,
    f) scales, the router float) within f32 2e-5 of JAX's, out and aux, at a
    binding capacity with a padding mask; the launcher serves llama4 with
    ``--weights-int8``, 0 failures."""
    from repro.models.quant import quantize_params as j_quantize_params
    from repro_torch.launch import serve
    from repro_torch.models.quant import is_quant

    E, k, cf, T = 8, 2, 1.25, 24
    jcfg = j_dbrx.SMOKE.replace(moe=JMoECfg(n_experts=E, top_k=k, capacity_factor=cf))
    tcfg = dbrx_132b.SMOKE.replace(moe=MoECfg(n_experts=E, top_k=k, capacity_factor=cf))
    x, router, w1, w3, w2, valid = _layer_case(E, k, cf, T, "valid", seed=5)
    jq = j_quantize_params({"router": jnp.asarray(router), "w1": jnp.asarray(w1), "w3": jnp.asarray(w3),
                            "w2": jnp.asarray(w2)})
    tq = {n: ({"q": torch.from_numpy(np.array(v["q"])),
               "s": torch.from_numpy(np.array(v["s"]).view(np.int16)).view(torch.bfloat16)}
              if isinstance(v, dict) else torch.from_numpy(np.array(v))) for n, v in jq.items()}
    assert is_quant(tq["w1"]) and tuple(tq["w2"]["s"].shape) == (E, 1, 16) and not is_quant(tq["router"])
    xb, vb = x.reshape(2, T // 2, -1), valid.reshape(2, -1)
    jout, jaux = jmoe.moe_ffn(jcfg, None, jq, jnp.asarray(xb), valid=jnp.asarray(vb))
    tout, taux = tmoe.moe_ffn(tcfg, tq, torch.from_numpy(xb), valid=torch.from_numpy(vb))
    assert np.max(np.abs(np.asarray(jout) - tout.numpy())) < TOL
    assert abs(float(jaux) - float(taux)) < TOL
    r = serve.main(["--arch", ARCHS[1], "--smoke", "--device", "cpu", "--weights-int8", "--requests", "2"])
    assert r["metrics"].summary()["failed"] == 0 and is_quant(r["params"]["blocks"]["l0_ffn"]["w1"])


def test_launcher_serves_one_layer_of_dbrx():
    """``--arch dbrx-132b --smoke --layers 1 --device cpu``: the first layer
    of the configuration at its width, 32 requests, 0 failures."""
    from repro_torch.launch import serve

    r = serve.main(["--arch", "dbrx-132b", "--smoke", "--layers", "1", "--device", "cpu"])
    m = r["metrics"].summary()
    assert m["total"] == 32 and m["failed"] == 0
    assert r["cfg"].n_layers == 1 and r["cfg"].d_model == dbrx_132b.SMOKE.d_model
    assert r["params"]["blocks"]["l0_ffn"]["w1"].shape[0] == 1


@pytest.mark.parametrize("arch, layers", [("dbrx-132b", 3), ("dbrx-132b", -1), ("xlstm-350m", 12),
                                          ("xlstm-350m", 16)])
def test_launcher_rejects_layers_outside_the_config(arch, layers, capsys):
    """``--layers`` above the config's depth, below 1, or past the block
    pattern's length and not a multiple of it (xlstm-350m's is 8 long; its
    FULL depth 24, its smoke depth 8) is an argparse error before anything
    is built."""
    from repro_torch.launch import serve

    smoke = [] if (arch, layers) == ("xlstm-350m", 12) else ["--smoke"]   # 12: FULL, 24 layers deep
    with pytest.raises(SystemExit):
        serve.parse_args(["--arch", arch, *smoke, "--layers", str(layers), "--device", "cpu"])
    assert "--layers" in capsys.readouterr().err
    assert serve.parse_args(["--arch", arch, "--smoke", "--layers", "2" if arch == "dbrx-132b" else "8"]).layers
