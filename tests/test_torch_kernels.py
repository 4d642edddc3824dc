"""The port's kernel families (src/repro_torch/kernels) against the JAX
package's Pallas kernels in interpret mode and their jnp oracles, on the CPU:
every wrapper given a CPU tensor runs its plain PyTorch version, which must
compute what the TPU kernel computes. Inputs come from seeded numpy and go
to both frameworks. Tolerances are those of tests/test_kernels.py (f32 2e-5,
bf16 2e-2); the prefill write is compared exactly. The CUDA kernels
themselves are held against these plain versions on the card, in
tests/test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import ops as jda_ops  # noqa: E402
from repro.kernels.decode_attention.kernel import decode_attention_grouped  # noqa: E402
from repro.kernels.flash_attention import ops as jfa_ops  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref  # noqa: E402
from repro.kernels.paged_attention import ops as jpa_ops  # noqa: E402
from repro.kernels.paged_attention.kernel import (  # noqa: E402
    paged_attention_grouped,
    paged_prefill_write_grouped_quant,
)
from repro.kernels.paged_attention.ref import paged_attention_ref as j_paged_ref  # noqa: E402
from repro.kernels.rmsnorm import ops as jrms_ops  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import quant as jquant  # noqa: E402
from repro.models.common import rmsnorm as j_rmsnorm  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref, paged_prefill_write_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import quant as tquant  # noqa: E402
from repro_torch.models.common import ModelConfig  # noqa: E402
from repro_torch.models.loss import first_argmax  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _pair(a: np.ndarray, dt: str):
    """The same values as a JAX array and a CPU tensor (bf16 rounds alike)."""
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(a, jnp.float32).astype(jdt), torch.from_numpy(a.astype(np.float32)).to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _err(a, b) -> float:
    return float(np.max(np.abs(_np(a) - _np(b))))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 96, 160), (2, 8, 64), (7, 97), (3, 960)])
def test_rmsnorm_matches_pallas(shape, dt):
    rng = np.random.default_rng(3)
    xj, xt = _pair(rng.standard_normal(shape).astype(np.float32), dt)
    w = np.linspace(0.5, 1.5, shape[-1]).astype(np.float32)
    wj, wt = jnp.asarray(w), torch.from_numpy(w)
    out = rms_ops.rmsnorm(xt, wt)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    assert _err(out, jrms_ops.rmsnorm(xj, wj)) < TOL[dt]      # Pallas, interpret mode
    assert _err(out, j_rmsnorm(xj, wj)) < TOL[dt]             # the jnp oracle
    assert _err(out, rmsnorm_ref(xt, wt)) == 0.0


def _pools(rng, NP, KV, ps, hd, dt):
    pk = rng.standard_normal((NP, KV, ps, hd)).astype(np.float32)
    pv = rng.standard_normal((NP, KV, ps, hd)).astype(np.float32)
    return _pair(pk, dt), _pair(pv, dt)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("Lp,offset", [(32, None), (16, 16), (24, 8), (8, 32)])
def test_paged_prefill_write_matches_pallas(Lp, offset, dt):
    rng = np.random.default_rng(11)
    NP, KV, ps, hd = 10, 2, 8, 16
    (pkj, pkt), (pvj, pvt) = _pools(rng, NP, KV, ps, hd, dt)
    (kj, kt), (vj, vt) = (_pair(rng.standard_normal((1, Lp, KV, hd)).astype(np.float32), dt)
                          for _ in range(2))
    row = np.array([4, 7, 2, 9, 0], np.int32)
    before_k, before_v = pkt.clone(), pvt.clone()
    jk, jv = jpa_ops.paged_prefill_write(pkj, pvj, kj, vj, jnp.asarray(row),
                                         use_pallas=True, offset=offset)
    tk, tv = pa_ops.paged_prefill_write(pkt, pvt, kt, vt, torch.from_numpy(row), offset=offset)
    assert tk is pkt and tv is pvt                               # in place
    shifted = pa_ops._shift_row(torch.from_numpy(row), offset or 0, ps)
    np.testing.assert_array_equal(
        shifted.numpy(), np.asarray(jpa_ops._shift_row(jnp.asarray(row), offset or 0, ps)))
    touched = {int(p) for p in shifted[: -(-Lp // ps)]}
    for p in range(1, NP):                       # page 0 absorbs pad writes: never compared
        np.testing.assert_array_equal(_np(tk[p]), _np(jk[p]))
        np.testing.assert_array_equal(_np(tv[p]), _np(jv[p]))
        if p not in touched:
            assert torch.equal(tk[p], before_k[p]) and torch.equal(tv[p], before_v[p])


def test_paged_prefill_write_ragged_tail_and_row_guard():
    """A ragged Lp writes the tail page's first Lp % ps slots only (the JAX
    wrapper takes its jnp ref there); more tokens than the row has pages
    raise instead of clamping onto the row's last page."""
    rng = np.random.default_rng(12)
    NP, KV, ps, hd, Lp = 8, 2, 8, 16, 13
    (pkj, pkt), (pvj, pvt) = _pools(rng, NP, KV, ps, hd, "float32")
    kj, kt = _pair(rng.standard_normal((1, Lp, KV, hd)).astype(np.float32), "float32")
    row = np.array([3, 5], np.int32)
    jk, jv = jpa_ops.paged_prefill_write(pkj, pvj, kj, kj, jnp.asarray(row), use_pallas=True)
    tk, tv = pa_ops.paged_prefill_write(pkt, pvt, kt, kt, torch.from_numpy(row))
    np.testing.assert_array_equal(_np(tk), _np(jk))
    np.testing.assert_array_equal(_np(tv), _np(jv))
    with pytest.raises(ValueError):
        paged_prefill_write_ref(pkt, pvt, kt, kt, torch.tensor([3], dtype=torch.int32))


@pytest.mark.parametrize("dt,softcap", [("float32", 0.0), ("bfloat16", 0.0), ("float32", 5.0)])
def test_paged_attention_matches_pallas(dt, softcap):
    """Dead slots (length 0 + 1 over the null row), a length on a page
    boundary, a ragged one and a full row; softcap before the mask."""
    rng = np.random.default_rng(5)
    NP, KV, G, ps, hd, P, B = 12, 2, 3, 8, 16, 4, 5
    (pkj, pkt), (pvj, pvt) = _pools(rng, NP, KV, ps, hd, dt)
    qj, qt = _pair(rng.standard_normal((B, KV, G, hd)).astype(np.float32), dt)
    tab = np.stack([rng.permutation(np.arange(1, NP))[:P] for _ in range(B)]).astype(np.int32)
    tab[0] = 0
    lens = np.array([1, 8, 13, 32, 17], np.int32)
    jout = paged_attention_grouped(qj, pkj, pvj, jnp.asarray(tab), jnp.asarray(lens),
                                   interpret=True, softcap=softcap)
    jref = j_paged_ref(qj, pkj, pvj, jnp.asarray(tab), jnp.asarray(lens), softcap=softcap)
    q4 = qt.reshape(B, 1, KV * G, hd)
    out = pa_ops.paged_attention(q4, pkt, pvt, torch.from_numpy(tab), torch.from_numpy(lens),
                                 softcap=softcap)
    assert out.shape == (B, 1, KV * G, hd) and out.dtype == qt.dtype
    out = out.reshape(B, KV, G, hd)
    assert torch.isfinite(out.float()).all()
    assert _err(out, jout) < TOL[dt]
    assert _err(out, jref) < TOL[dt]
    ref = paged_attention_ref(qt, pkt, pvt, torch.from_numpy(tab), torch.from_numpy(lens),
                              softcap=softcap)
    assert _err(out, ref) == 0.0


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [16, 40])
def test_flash_attention_matches_pallas(S, dt):
    """S = 40 is not a multiple of the 16-row block: the JAX wrapper pads,
    the port masks the ragged edge."""
    rng = np.random.default_rng(9)
    B, H, KV, hd = 1, 6, 2, 16
    qj, qt = _pair(rng.standard_normal((B, S, H, hd)).astype(np.float32), dt)
    kj, kt = _pair(rng.standard_normal((B, S, KV, hd)).astype(np.float32), dt)
    vj, vt = _pair(rng.standard_normal((B, S, KV, hd)).astype(np.float32), dt)
    jout = jfa_ops.flash_attention(qj, kj, vj, bq=16, bkv=16)           # Pallas, interpret mode
    out = fa_ops.flash_attention(qt, kt, vt)
    assert out.shape == (B, S, H, hd) and out.dtype == qt.dtype
    assert _err(out, jout) < TOL[dt]
    jref = j_attention_ref(*(a.transpose(0, 2, 1, 3) for a in (qj, kj, vj))).transpose(0, 2, 1, 3)
    assert _err(out, jref) < TOL[dt]
    assert _err(out, attention_ref(*(a.transpose(1, 2) for a in (qt, kt, vt))).transpose(1, 2)) == 0.0


def test_index_guards():
    """JAX clamps gathers and drops scatters; the port's plain versions say
    what they do instead of faulting: the decode scatter of a slot whose
    length sits at the row's end goes to the null page, and ties in the
    greedy argmax go to the first maximum, like jnp.argmax."""
    cfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=8, n_heads=2,
                      n_kv_heads=1, d_ff=8, vocab_size=8, compute_dtype=torch.float32)
    NP, KV, ps, hd = 4, 1, 2, 4
    cache = {"k": torch.zeros(NP, KV, ps, hd), "v": torch.zeros(NP, KV, ps, hd)}
    k = torch.ones(2, 1, KV, hd)
    idx = tattn.PagedIndex(torch.tensor([1, 4], dtype=torch.int32),
                           torch.tensor([[2, 3], [1, 3]], dtype=torch.int32))
    tattn.paged_cache_kv(cfg, cache, k, 2 * k, idx)
    assert cache["k"][2, 0, 1].eq(1).all()            # slot 0: page 2, slot 1
    assert cache["k"][0, 0, 0].eq(1).all()            # slot 1: past the row -> null page
    assert cache["k"][3].eq(0).all() and cache["k"][1].eq(0).all()
    x = torch.tensor([[0.0, 3.0, 1.0, 3.0], [2.0, 2.0, 2.0, 2.0]])
    assert first_argmax(x).tolist() == np.asarray(jnp.argmax(jnp.asarray(x.numpy()), -1)).tolist()



def _bits(x) -> np.ndarray:
    """The raw bits of an int8 or bf16 array or tensor, for exact compares."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_quantize_kv_matches_jax_bit_for_bit(dt):
    """Per (token, head) absmax int8 with the f32 scale, round half to even,
    the scale stored as bf16; zero rows and exact halves included."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((3, 7, 2, 16)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0                                     # floor of the scale
    x[0, 1, 0, :4] = [127.0, 0.5, 1.5, -2.5]             # exact halves: ties to even
    xj, xt = _pair(x, dt)
    jq, js = jquant.quantize_kv(xj)
    tq, ts = tquant.quantize_kv(xt)
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16 and ts.shape == (3, 7, 2, 1)
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    for odt, jodt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(_np(tquant.dequantize_kv(tq, ts, odt)),
                                      _np(jquant.dequantize_kv(jq, js, jodt)))


def _int8_pools(rng, NP, KV, ps, hd):
    ik = rng.integers(-127, 128, (NP, KV, ps, hd)).astype(np.int8)
    iv = rng.integers(-127, 128, (NP, KV, ps, hd)).astype(np.int8)
    ks = (rng.random((NP, KV, ps, 1)) * 0.05).astype(np.float32)
    vs = (rng.random((NP, KV, ps, 1)) * 0.05).astype(np.float32)
    (ksj, kst), (vsj, vst) = _pair(ks, "bfloat16"), _pair(vs, "bfloat16")
    return ((jnp.asarray(ik), torch.from_numpy(ik)), (jnp.asarray(iv), torch.from_numpy(iv)),
            (ksj, kst), (vsj, vst))


def _ties(x: np.ndarray) -> int:
    """Elements of x (1, L, KV, hd) whose x / scale is exactly half-way."""
    sc = np.maximum(np.abs(x).max(-1, keepdims=True) / np.float32(127.0), np.float32(1e-8))
    r = x / sc
    return int(np.sum(r - np.floor(r) == 0.5))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("Lp,offset", [(16, None), (16, 8), (24, 0), (13, None)])
def test_paged_prefill_write_quant_matches_pallas(Lp, offset, dt):
    """The int8 write against the Pallas kernel in interpret mode (the jnp
    ref for a ragged Lp, as the JAX wrapper takes it): int8 bits exact but
    for at most one LSB at a rounding tie, scales exact, pages outside the
    (shifted) row untouched."""
    rng = np.random.default_rng(13)
    NP, KV, ps, hd = 9, 2, 8, 16
    pools = _int8_pools(rng, NP, KV, ps, hd)
    (kj, kt), (vj, vt) = (_pair(rng.standard_normal((1, Lp, KV, hd)).astype(np.float32), dt)
                          for _ in range(2))
    row = np.array([4, 7, 2, 0], np.int32)
    before = [p[1].clone() for p in pools]
    jout = jpa_ops.paged_prefill_write_quant(*(p[0] for p in pools), kj, vj, jnp.asarray(row),
                                             use_pallas=True, offset=offset)
    tout = pa_ops.paged_prefill_write_quant(*(p[1] for p in pools), kt, vt, torch.from_numpy(row),
                                            offset=offset)
    assert all(a is p[1] for a, p in zip(tout, pools))              # in place
    ties = _ties(_np(kt)) + _ties(_np(vt))
    touched = {int(p) for p in pa_ops._shift_row(torch.from_numpy(row), offset or 0, ps)[: -(-Lp // ps)]}
    for a, b, old in zip(tout, jout, before):
        for p in range(1, NP):                   # page 0 absorbs pad writes: never compared
            if a.dtype == torch.int8:
                d = np.abs(_bits(a[p]).astype(np.int32) - np.asarray(b[p]).astype(np.int32))
                assert d.max() <= 1 and int((d > 0).sum()) <= ties
            else:
                np.testing.assert_array_equal(_bits(a[p]), _bits(b[p]))
            if p not in touched:
                assert torch.equal(a[p], old[p])


def test_paged_prefill_write_quant_kernel_in_interpret_mode_equals_port():
    """The Pallas quantized write kernel itself (page-multiple Lp) writes the
    bits the port's plain version writes."""
    rng = np.random.default_rng(14)
    NP, KV, ps, hd = 6, 2, 4, 16
    pools = _int8_pools(rng, NP, KV, ps, hd)
    kj, kt = _pair(rng.standard_normal((1, 8, KV, hd)).astype(np.float32), "bfloat16")
    row = np.array([3, 5, 0], np.int32)
    jout = paged_prefill_write_grouped_quant(*(p[0] for p in pools), kj, kj, jnp.asarray(row),
                                             interpret=True)
    tout = pa_ops.paged_prefill_write_quant(*(p[1] for p in pools), kt, kt, torch.from_numpy(row))
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(_bits(a[1:]), _bits(b[1:]))


def _chain(tab: np.ndarray, tpp: int):
    """The two-level tables encoding flat rows: l2 row 0 null, one row per
    (slot, table page) holding a live page, unused l1 entries on row 0."""
    B, P = tab.shape
    W1 = -(-P // tpp)
    flat = np.zeros((B, W1 * tpp), np.int32)
    flat[:, :P] = tab
    l1 = np.zeros((B, W1), np.int32)
    l2 = [np.zeros(tpp, np.int32)]
    for b in range(B):
        for j in range(W1):
            piece = flat[b, j * tpp:(j + 1) * tpp]
            if piece.any():
                l1[b, j] = len(l2)
                l2.append(piece)
    return l1, np.stack(l2)


@pytest.mark.parametrize("leg", ["int8", "chained", "int8+chained"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_paged_attention_int8_and_chained_legs_match_pallas(leg, dt):
    """The int8 and chained legs (and both) against the Pallas kernel in
    interpret mode and its jnp ref: dead slots, lengths on and off page
    boundaries, a full row; the chained output bit for bit the flat one."""
    rng = np.random.default_rng(15)
    NP, KV, G, ps, hd, P, B = 14, 2, 3, 8, 16, 4, 5
    quant, chained = "int8" in leg, "chained" in leg
    if quant:
        (pkj, pkt), (pvj, pvt), (ksj, kst), (vsj, vst) = _int8_pools(rng, NP, KV, ps, hd)
        jkw, tkw = {"pool_ks": ksj, "pool_vs": vsj}, {"pool_ks": kst, "pool_vs": vst}
    else:
        (pkj, pkt), (pvj, pvt) = _pools(rng, NP, KV, ps, hd, dt)
        jkw, tkw = {}, {}
    qj, qt = _pair(rng.standard_normal((B, KV, G, hd)).astype(np.float32), dt)
    tab = np.stack([rng.permutation(np.arange(1, NP))[:P] for _ in range(B)]).astype(np.int32)
    tab[0] = 0
    tab[3, 2:] = 0
    lens = np.array([1, 8, 13, 16, 32], np.int32)
    q4 = qt.reshape(B, 1, KV * G, hd)
    flat = pa_ops.paged_attention(q4, pkt, pvt, torch.from_numpy(tab), torch.from_numpy(lens), **tkw)
    jtab = jnp.asarray(tab)
    if chained:
        l1, l2 = _chain(tab, 2)
        jtab = jnp.asarray(l1)
        jkw["l2_tab"], tkw["l2_tab"] = jnp.asarray(l2), torch.from_numpy(l2)
        out = pa_ops.paged_attention(q4, pkt, pvt, torch.from_numpy(l1), torch.from_numpy(lens), **tkw)
        assert torch.equal(out, flat)
    else:
        out = flat
    jout = paged_attention_grouped(qj, pkj, pvj, jtab, jnp.asarray(lens), interpret=True, **jkw)
    jref = j_paged_ref(qj, pkj, pvj, jtab, jnp.asarray(lens), **jkw)
    out = out.reshape(B, KV, G, hd)
    assert out.dtype == qt.dtype and torch.isfinite(out.float()).all()
    assert _err(out, jout) < TOL[dt]
    assert _err(out, jref) < TOL[dt]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [96, 128])
def test_decode_attention_matches_pallas(T, dt):
    """Dense decode over (B, T, KV, hd) as stored, lengths 1, 16, 95 and 96,
    against the Pallas kernel in interpret mode (through its wrapper, which
    transposes and pads) and its jnp ref."""
    rng = np.random.default_rng(17)
    B, KV, G, hd = 4, 2, 3, 16
    qj, qt = _pair(rng.standard_normal((B, 1, KV * G, hd)).astype(np.float32), dt)
    kj, kt = _pair(rng.standard_normal((B, T, KV, hd)).astype(np.float32), dt)
    vj, vt = _pair(rng.standard_normal((B, T, KV, hd)).astype(np.float32), dt)
    lens = np.array([1, 16, 95, 96], np.int32)
    out = da_ops.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    assert out.shape == (B, 1, KV * G, hd) and out.dtype == qt.dtype
    jout = jda_ops.decode_attention(qj, kj, vj, jnp.asarray(lens))
    assert _err(out, jout) < TOL[dt]
    jk = decode_attention_grouped(qj[:, 0].reshape(B, KV, G, hd), kj.transpose(0, 2, 1, 3),
                                  vj.transpose(0, 2, 1, 3), jnp.asarray(lens), bt=32, interpret=True)
    assert _err(out.reshape(B, KV, G, hd), jk) < TOL[dt]
    scalar = da_ops.decode_attention(qt, kt, vt, 16)               # one length for every slot
    assert _err(scalar, jda_ops.decode_attention(qj, kj, vj, 16)) < TOL[dt]


@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_decode_attention_softcap_matches_jnp_path(softcap):
    """The port applies the softcap where the Pallas kernel drops it: it is
    held to the JAX package's jnp ``decode_attention`` (use_pallas off)."""
    from repro.models.common import ModelConfig as JModelConfig

    rng = np.random.default_rng(19)
    B, T, KV, G, hd = 3, 24, 2, 2, 8
    jcfg = JModelConfig(name="t", family="dense", n_layers=1, d_model=32, n_heads=KV * G,
                        n_kv_heads=KV, d_ff=8, vocab_size=8, logit_softcap=softcap)
    tcfg = ModelConfig(name="t", family="dense", n_layers=1, d_model=32, n_heads=KV * G,
                       n_kv_heads=KV, d_ff=8, vocab_size=8, logit_softcap=softcap)
    qj, qt = _pair(rng.standard_normal((B, 1, KV * G, hd)).astype(np.float32) * 4, "float32")
    kj, kt = _pair(rng.standard_normal((B, T, KV, hd)).astype(np.float32) * 4, "float32")
    vj, vt = _pair(rng.standard_normal((B, T, KV, hd)).astype(np.float32), "float32")
    lens = np.array([1, 9, 24], np.int32)
    jout = jattn.decode_attention(jcfg, qj, kj, vj, jnp.asarray(lens))
    out = tattn.decode_attention(tcfg, qt, kt, vt, torch.from_numpy(lens))
    assert _err(out, jout) < TOL["float32"]
