"""The page-pool writes' contract on the CPU: the page each chunk token lands
in (``write_page_ids``, the rule the CUDA write kernels resolve in place of a
shifted row) against ``_shift_row`` of the port and of the JAX package; the
launch shape (``plan_write_grid``); and the plain path with a chunk offset,
rows shifted past their end included, against the JAX package's Pallas
writes in interpret mode. Inputs come from seeded numpy. The kernels
themselves are held against these plain versions on the card, in
tests/test_torch_cuda.py."""
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import ops as jpa_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402

SMS = 132                                      # an H100 SXM's SMs


@pytest.mark.parametrize("row,ps,Lp,NP", [
    ([4, 7, 2, 9, 1], 8, 40, 10),              # every entry in use at shift 0
    ([4, 7, 2, 9, 1], 8, 13, 10),              # ragged Lp
    ([3, 5, 0], 16, 20, 6),                    # a null entry inside the row
    ([6, -1, 11, 2, 40, 0], 4, 7, 8),          # ids outside the pool [0, NP)
    ([5], 16, 16, 6),                          # a one-page row
])
def test_write_page_ids_match_shift_row(row, ps, Lp, NP):
    """For every page-multiple offset from 0 to (P + 1) * ps (rows shifted
    past their end included): token t's page is the shifted row's entry t //
    ps, in the port and in the JAX package; and the plain write with that
    offset lands token t in exactly that page (dropped outside the pool)."""
    P = len(row)
    tab = torch.tensor(row, dtype=torch.int32)
    t = np.arange(Lp)
    rng = np.random.default_rng(P * 100 + Lp)
    k = torch.from_numpy(rng.standard_normal((1, Lp, 2, 8)).astype(np.float32))
    for off in range(0, (P + 1) * ps + 1, ps):
        ids = pa_ops.write_page_ids(tab, off // ps, Lp, ps)
        assert ids.dtype == tab.dtype and ids.shape == (Lp,)
        shifted = pa_ops._shift_row(tab, off, ps)
        np.testing.assert_array_equal(ids.numpy(), shifted.numpy()[t // ps])
        j_shifted = np.asarray(jpa_ops._shift_row(jnp.asarray(np.array(row, np.int32)), off, ps))
        np.testing.assert_array_equal(ids.numpy(), j_shifted[t // ps])
        if -(-Lp // ps) > P:
            continue
        pk, pv = torch.full((NP, 2, ps, 8), 7.0), torch.full((NP, 2, ps, 8), 7.0)
        pa_ops.paged_prefill_write(pk, pv, k, -k, tab, offset=off)
        want_k, want_v = torch.full((NP, 2, ps, 8), 7.0), torch.full((NP, 2, ps, 8), 7.0)
        for i, page in enumerate(ids.tolist()):
            if 0 <= page < NP:
                want_k[page, :, i % ps], want_v[page, :, i % ps] = k[0, i], -k[0, i]
        assert torch.equal(pk[1:], want_k[1:]) and torch.equal(pv[1:], want_v[1:])


@pytest.mark.parametrize("Lp,KV,hd,elem_bytes", [
    (16, 5, 64, 2), (256, 5, 64, 2), (2048, 5, 64, 2), (1, 5, 64, 2), (20, 5, 20, 2),
    (256, 5, 64, 4), (128, 5, 64, 2), (128, 2, 128, 4), (100, 8, 8, 2), (37, 1, 256, 4),
])
def test_plan_write_grid_covers_every_row_once(Lp, KV, hd, elem_bytes):
    """Every (token, head) row in exactly one block; a power of two of at
    most 16 tokens a block; the grid fills the card where a block of a
    warp's lanes can, and takes 16 tokens a block (the smallest grid) where
    it cannot."""
    tokens, blocks = pa_ops.plan_write_grid(Lp, KV, hd, elem_bytes, SMS)
    assert 1 <= tokens <= 16 and tokens & (tokens - 1) == 0
    assert blocks == -(-Lp // tokens) * KV
    rows = Counter((t, h) for x in range(blocks // KV) for h in range(KV)
                   for t in range(x * tokens, min(Lp, (x + 1) * tokens)))
    assert len(rows) == Lp * KV and set(rows.values()) == {1}
    lanes = max(1, -(-hd * elem_bytes // 16))
    if blocks < SMS:
        assert tokens == 16
    elif tokens < 16:                          # halved only to fill the card
        assert -(-Lp // (2 * tokens)) * KV < SMS and tokens * lanes >= 32


def test_plan_write_grid_at_the_serving_shapes():
    """The main path's 16-token chunk: one block per KV head; the pools
    shape (Lp 256) and a 2048-token prompt fill the 132 SMs."""
    assert pa_ops.plan_write_grid(16, 5, 64, 2, SMS) == (16, 5)
    assert pa_ops.plan_write_grid(256, 5, 64, 2, SMS)[1] >= SMS
    assert pa_ops.plan_write_grid(2048, 5, 64, 2, SMS)[1] >= SMS


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


def _ties(x: np.ndarray) -> int:
    """Elements of x (1, L, KV, hd) whose x / scale is exactly half-way."""
    sc = np.maximum(np.abs(x).max(-1, keepdims=True) / np.float32(127.0), np.float32(1e-8))
    r = x / sc
    return int(np.sum(r - np.floor(r) == 0.5))


@pytest.mark.parametrize("quant", [False, True], ids=["write", "write_quant"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shift", [1, 3, 4, 6], ids=["inside", "tail_past_end", "at_end", "beyond_end"])
def test_plain_write_with_offset_matches_pallas(quant, dt, shift):
    """A two-page chunk through a four-entry row at offset shift * ps: inside
    the row, with its tail page past the row's end, and wholly past it
    (every token on the null page). Pages 1.. equal the Pallas write's in
    interpret mode (int8 values within one at a rounding tie, scales
    exact); pages the chunk does not reach are untouched."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dt]
    rng = np.random.default_rng(21 + shift)
    NP, KV, ps, hd, Lp = 8, 2, 8, 16, 16
    row = np.array([5, 2, 7, 3], np.int32)
    x = [rng.standard_normal((1, Lp, KV, hd)).astype(np.float32) for _ in range(2)]
    kj, vj = (jnp.asarray(a).astype(jdt) for a in x)
    kt, vt = (torch.from_numpy(a).to(tdt) for a in x)
    if quant:
        pools = [rng.integers(-127, 128, (NP, KV, ps, hd)).astype(np.int8) for _ in range(2)]
        pools += [(rng.random((NP, KV, ps, 1)) * 0.05).astype(np.float32) for _ in range(2)]
        tp = [torch.from_numpy(p) for p in pools[:2]] + [torch.from_numpy(p).to(torch.bfloat16)
                                                         for p in pools[2:]]
        jp = [jnp.asarray(p) for p in pools[:2]] + [jnp.asarray(p).astype(jnp.bfloat16) for p in pools[2:]]
        jout = jpa_ops.paged_prefill_write_quant(*jp, kj, vj, jnp.asarray(row), use_pallas=True,
                                                 offset=shift * ps)
        before = [p.clone() for p in tp]
        tout = pa_ops.paged_prefill_write_quant(*tp, kt, vt, torch.from_numpy(row), offset=shift * ps)
        ties = _ties(np.asarray(kj, np.float32)) + _ties(np.asarray(vj, np.float32))
    else:
        pools = [rng.standard_normal((NP, KV, ps, hd)).astype(np.float32) for _ in range(2)]
        jp = [jnp.asarray(p).astype(jdt) for p in pools]
        tp = [torch.from_numpy(p).to(tdt) for p in pools]
        jout = jpa_ops.paged_prefill_write(*jp, kj, vj, jnp.asarray(row), use_pallas=True,
                                           offset=shift * ps)
        before = [p.clone() for p in tp]
        tout = pa_ops.paged_prefill_write(*tp, kt, vt, torch.from_numpy(row), offset=shift * ps)
        ties = 0
    assert all(a is p for a, p in zip(tout, tp))                  # in place
    touched = set(pa_ops.write_page_ids(torch.from_numpy(row), shift, Lp, ps).tolist())
    assert touched == {int(row[i]) if i < len(row) else 0 for i in (shift, shift + 1)}
    for a, b, old in zip(tout, jout, before):
        for p in range(1, NP):                   # page 0 absorbs the writes past the end
            if a.dtype == torch.int8:
                d = np.abs(_bits(a[p]).astype(np.int32) - np.asarray(b[p]).astype(np.int32))
                assert d.max() <= 1 and int((d > 0).sum()) <= ties
            else:
                np.testing.assert_array_equal(_bits(a[p]), _bits(b[p]))
            if p not in touched:
                assert torch.equal(a[p], old[p])
