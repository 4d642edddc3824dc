"""The arithmetic and the layouts of the port's two attention kernels,
checked on the CPU: the paged decode's split of a row's pages across blocks
(the planner, and a plain emulation of the per-split (m, l, acc) and their
combine in split order, on every leg), and the flash wrapper's strides (the
model's (B, S, H, hd) layout and the TPU kernel's (B, H, S, hd), handed to
the kernel as they lie) against the JAX package's Pallas kernel in
interpret mode. Inputs come from seeded numpy. The CUDA kernels themselves
are held against the plain versions on the card, in tests/test_torch_cuda.py."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention_bhsd as j_flash_bhsd  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import chain_rows, gather_kv, paged_attention_ref  # noqa: E402
from repro_torch.models.quant import dequantize_kv  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}      # tests/test_kernels.py:17
LOG2E = 1.4426950408889634


@pytest.mark.parametrize("B,KV,P,ps", [(8, 5, 16, 16), (8, 5, 6, 16), (4, 5, 256, 16), (1, 5, 256, 16),
                                       (1, 1, 4096, 16), (64, 5, 16, 16), (6, 2, 64, 8),
                                       (2, 1, 40, 24), (3, 2, 7, 128), (1, 1, 3, 16)])
def test_page_split_planner(B, KV, P, ps):
    """Whole pages, [0, P) covered in order, no split under MIN_SPLIT
    tokens, at most two blocks per SM, one split for a short row."""
    n = pa_ops.plan_page_splits(B, KV, P, ps)
    bounds = pa_ops.page_split_bounds(P, n)
    assert len(bounds) == n >= 1
    assert all(isinstance(a, int) and isinstance(b, int) for a, b in bounds)
    assert bounds[0][0] == 0 and bounds[-1][1] == P
    assert all(prev[1] == nxt[0] for prev, nxt in zip(bounds, bounds[1:]))
    if n > 1:
        assert all((stop - start) * ps >= da_ops.MIN_SPLIT for start, stop in bounds)
        assert B * KV * n <= 2 * da_ops.SMS
    if P * ps < 2 * da_ops.MIN_SPLIT or B * KV >= da_ops.SMS:
        assert n == 1


def _split_combine(q, k, v, lens, bounds, ps, softcap):
    """Plain emulation of the kernel's split and combine: q (B, KV, G, hd)
    f32; k/v (B, KV, T, hd) f32 (dequantized); each split's (m, l, acc)
    over its live rows with scores in base 2, then the splits merged in
    split order with weights 2^(m_s - M). A row of length 0 gives 0."""
    B, KV, G, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    parts = []
    for start, stop in bounds:
        t0, t1 = start * ps, stop * ps
        s = torch.einsum("bkgh,bkth->bkgt", q, k[:, :, t0:t1]) * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        s = s * LOG2E
        live = (torch.arange(t0, t1)[None, :] < lens[:, None])[:, None, None, :]
        s = torch.where(live, s, torch.full_like(s, -math.inf))
        m = s.amax(-1)                                                 # -inf: no live row
        p = torch.where(live, torch.exp2(s - torch.where(m.isinf(), 0.0, m)[..., None]), 0.0)
        parts.append((m, p.sum(-1), torch.einsum("bkgt,bkth->bkgh", p, v[:, :, t0:t1])))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    num = torch.zeros_like(q)
    den = torch.zeros_like(M)
    for m, l, acc in parts:
        w = torch.where(m.isinf(), 0.0, torch.exp2(m - torch.where(M.isinf(), 0.0, M)))
        num = num + acc * w[..., None]
        den = den + l * w
    return num / den.clamp_min(1e-30)[..., None]


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("leg", ["flat", "chained", "int8", "int8+chained"])
def test_paged_split_combine_matches_ref(leg, softcap):
    """The emulation at the planner's splits against paged_attention_ref,
    lengths 0, 1, split - 1, split, split + 1 and a full row, bf16 or int8
    pools, chained tables encoding the flat ones: f32 2e-5, a length of 0
    gives 0."""
    rng = np.random.default_rng(21)
    B, KV, G, hd, ps, P, tpp = 6, 2, 3, 16, 8, 64, 4
    n = pa_ops.plan_page_splits(B, KV, P, ps)
    bounds = pa_ops.page_split_bounds(P, n)
    assert n > 1
    split = bounds[1][0] * ps
    lens_l = [0, 1, split - 1, split, split + 1, P * ps]
    NP = 1 + sum(-(-L // ps) for L in lens_l)
    perm = rng.permutation(np.arange(1, NP))
    tab = np.zeros((B, P), np.int32)
    used = 0
    for b, L in enumerate(lens_l):
        k_ = -(-L // ps)
        tab[b, :k_] = perm[used:used + k_]
        used += k_
    tab[1] = 0                                       # a dead slot: length 1 over the null page
    quant = "int8" in leg
    kw = {}
    if quant:
        pool_k = torch.from_numpy(rng.integers(-127, 128, (NP, KV, ps, hd)).astype(np.int8))
        pool_v = torch.from_numpy(rng.integers(-127, 128, (NP, KV, ps, hd)).astype(np.int8))
        kw = {"pool_ks": torch.from_numpy(rng.uniform(0, 0.05, (NP, KV, ps, 1)).astype(np.float32)).to(torch.bfloat16),
              "pool_vs": torch.from_numpy(rng.uniform(0, 0.05, (NP, KV, ps, 1)).astype(np.float32)).to(torch.bfloat16)}
    else:
        pool_k, pool_v = (torch.from_numpy(rng.standard_normal((NP, KV, ps, hd)).astype(np.float32))
                          .to(torch.bfloat16) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((B, KV, G, hd)).astype(np.float32))
    lens = torch.tensor(lens_l, dtype=torch.int32)
    table = torch.from_numpy(tab)
    if "chained" in leg:
        W1 = P // tpp
        l1 = torch.zeros(B, W1, dtype=torch.int32)
        rows = [torch.zeros(tpp, dtype=torch.int32)]
        for b in range(B):
            for j in range(W1):
                piece = table[b, j * tpp:(j + 1) * tpp]
                if bool(piece.ne(0).any()):
                    l1[b, j] = len(rows)
                    rows.append(piece)
        l2 = torch.stack(rows)
        assert torch.equal(chain_rows(l1, l2), table)
        kw["l2_tab"] = l2
        table = l1
    ref = paged_attention_ref(q, pool_k, pool_v, table, lens, softcap=softcap, **kw)
    flat = chain_rows(table, kw["l2_tab"]) if "chained" in leg else table
    k, v = gather_kv(pool_k, flat), gather_kv(pool_v, flat)
    if quant:
        k = dequantize_kv(k, gather_kv(kw["pool_ks"], flat), torch.float32)
        v = dequantize_kv(v, gather_kv(kw["pool_vs"], flat), torch.float32)
    out = _split_combine(q, k.float(), v.float(), lens, bounds, ps, softcap)
    assert torch.isfinite(out).all()
    assert float(out[0].abs().max()) == 0.0                          # length 0 -> 0
    assert float((out[1:] - ref[1:]).abs().max()) < TOL["float32"]


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_flash_kernel_strides_address_the_tensor(layout):
    """The (batch, position, head) strides the wrapper hands the kernel,
    from a tensor's own strides in either layout (contiguous, a transposed
    view, a slice of wider heads): addressing its storage with them gives
    the tensor in (B, S, H, hd) order."""
    B, S, H, hd = 2, 5, 3, 8
    base = torch.arange(B * S * (H + 1) * hd, dtype=torch.float32)
    views = {"bshd": [base[: B * S * H * hd].view(B, S, H, hd),
                      base.view(B, S, H + 1, hd)[:, :, :H],
                      base[: B * S * H * hd].view(B, H, S, hd).transpose(1, 2)],
             "bhsd": [base[: B * S * H * hd].view(B, H, S, hd),
                      base.view(B, H + 1, S, hd)[:, :H],
                      base[: B * S * H * hd].view(B, S, H, hd).transpose(1, 2)]}[layout]
    for t in views:
        sb, ss, sh = fa_ops.kernel_strides(t.stride(), layout)
        bshd = t if layout == "bshd" else t.transpose(1, 2)
        assert (sb, ss, sh) == (bshd.stride(0), bshd.stride(1), bshd.stride(2))
        got = torch.as_strided(base, (B, S, H, hd), (sb, ss, sh, 1), t.storage_offset())
        assert torch.equal(got, bshd)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("S", [16, 40, 96])
def test_flash_attention_strided_inputs_match_pallas(S, G, dt):
    """flash_attention on non-contiguous (B, S, H, hd) views (q a slice of
    wider heads, k and v views of one stacked tensor) against the Pallas
    flash_attention_bhsd in interpret mode on the same values."""
    rng = np.random.default_rng(23 + S + G)
    B, KV, hd = 1, 2, 16
    H = G * KV
    jdt, tdt = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dt]
    qn = rng.standard_normal((B, S, H + 1, hd)).astype(np.float32)
    kvn = rng.standard_normal((2, B, S, KV, hd)).astype(np.float32)
    qw = torch.from_numpy(qn).to(tdt)
    kv = torch.from_numpy(kvn).to(tdt)
    q, k, v = qw[:, :, :H], kv[0], kv[1]
    assert not q.is_contiguous()
    out = fa_ops.flash_attention(q, k, v)
    assert out.shape == (B, S, H, hd) and out.dtype == tdt
    bq = 8 if S % 16 else 16
    jq = jnp.asarray(qn[:, :, :H]).astype(jdt).transpose(0, 2, 1, 3)
    jk = jnp.asarray(kvn[0]).astype(jdt).transpose(0, 2, 1, 3)
    jv = jnp.asarray(kvn[1]).astype(jdt).transpose(0, 2, 1, 3)
    jout = j_flash_bhsd(jq, jk, jv, bq=bq, bkv=bq, interpret=True).transpose(0, 2, 1, 3)
    assert float(np.max(np.abs(_np(out) - _np(jout)))) < TOL[dt]
