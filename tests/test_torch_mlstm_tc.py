"""The numerics of the port's bf16 tensor-core mLSTM kernel
(``csrc/mlstm_chunk.cu``, namespace ``tc``), emulated in plain PyTorch on
the CPU and held to the JAX package's jnp ``mlstm_chunkwise`` with a carry
on the same inputs (made from a numpy seed, rounded to bf16 as the kernel
reads them), and its column-tile plan.

The emulation follows the kernel's choices: the row stabiliser as a prefix
maximum, m_i = max(cum_i + max_{j<=i}(i_j - cum_j), cum_i + m0), with the
decay as exp((cum_i - m_i) + (i_j - cum_j)); the scores rounded to bf16 for
s v, their row sums taken unrounded; C's low 13 mantissa bits dropped for
q C, as the TF32 tensor cores read an f32 register; q . n, m', the carry
weights and the carry update in f32 with the plain version's expressions.
Tolerances: h 2e-2 (bf16, tests/test_kernels.py:17) over the reference's
largest magnitude where that is above 1; C and n 2e-5 relative to the
largest reference magnitude, m 2e-5 absolute."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.models import xlstm as jxl  # noqa: E402
from repro_torch.kernels.mlstm_chunk import ops as mk_ops  # noqa: E402
from repro_torch.kernels.mlstm_chunk import ref as mk_ref  # noqa: E402

TOL_H, TOL_STATE = 2e-2, 2e-5


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """f32 with the low 13 mantissa bits cleared: what a TF32 product reads."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def tc_chunk(q, k, v, i, lf, C0, n0, m0):
    """One chunk of the bf16 kernel's numerics. q, k, v: (BH, L, DH) bf16;
    i, lf: (BH, L) f32; carry f32. Returns (h (BH, L, DH) f32, (C, n, m))."""
    L = q.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    cum = torch.cumsum(lf, dim=-1)
    total = cum[:, -1]
    b = i - cum                                                   # B_j = i_j - cum_j
    m_row = torch.maximum(cum + torch.cummax(b, dim=-1).values, cum + m0[:, None])
    a_row = cum - m_row                                           # A_i = cum_i - m_i
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool))
    s = torch.where(tri, (qf @ kf.transpose(1, 2)) * torch.exp(a_row[:, :, None] + b[:, None, :]),
                    torch.zeros(()))
    dsum = s.sum(dim=-1)                                          # unrounded
    e = torch.exp((cum + m0[:, None]) - m_row)
    num = s.to(torch.bfloat16).float() @ vf + e[:, :, None] * (qf @ tf32_truncate(C0))
    den = dsum + e * (qf @ n0[:, :, None])[:, :, 0]
    h = num / torch.clamp(den.abs(), min=1.0)[:, :, None]
    aw = (total[:, None] - cum) + i
    m_new = torch.maximum(total + m0, aw.amax(dim=-1))
    scale_old = torch.exp((total + m0) - m_new)
    kw = kf * torch.exp(aw - m_new[:, None])[:, :, None]
    C = scale_old[:, None, None] * C0 + kw.transpose(1, 2) @ vf
    n = scale_old[:, None] * n0 + kw.sum(dim=1)
    return h, (C, n, m_new)


def tc_chunkwise_bh(q, k, v, i, lf, C0, n0, m0, chunk: int = 64):
    """The emulation over the sequence, chunk by chunk (L as the kernel
    takes it). Returns (h (BH, S, DH) bf16, C, n, m)."""
    L = mk_ref.chunk_len(q.shape[1], chunk)
    C, n, m = C0, n0, m0
    hs = []
    for c0 in range(0, q.shape[1], L):
        sl = slice(c0, c0 + L)
        h, (C, n, m) = tc_chunk(q[:, sl], k[:, sl], v[:, sl], i[:, sl], lf[:, sl], C, n, m)
        hs.append(h)
    return torch.cat(hs, dim=1).to(torch.bfloat16), C, n, m


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _inputs(rng, NH, S, DH):
    """Model-layout (1, S, NH, ...) q (scaled by DH^-1/2), k, v rounded to
    bf16, raw gates i and f in f32."""
    q = _bf16(rng.standard_normal((1, S, NH, DH)).astype(np.float32) * DH ** -0.5)
    k = _bf16(rng.standard_normal((1, S, NH, DH)).astype(np.float32))
    v = _bf16(rng.standard_normal((1, S, NH, DH)).astype(np.float32))
    i = rng.standard_normal((1, S, NH)).astype(np.float32)
    f = rng.standard_normal((1, S, NH)).astype(np.float32) + 2.0
    return q, k, v, i, f


def _carry(rng, NH, DH, zero: bool):
    """A zero carry, or the plain version's state after 24 steps."""
    z = (np.zeros((1, NH, DH, DH), np.float32), np.zeros((1, NH, DH), np.float32),
         np.zeros((1, NH), np.float32))
    if zero:
        return z
    pre = _inputs(rng, NH, 24, DH)
    _, state = mk_ref.mlstm_chunkwise(*(torch.from_numpy(a) for a in pre),
                                      *(torch.from_numpy(c) for c in z), chunk=64)
    return tuple(c.numpy() for c in state)


def _bh(args, carry):
    """The kernel's (BH, S, DH) layout, bf16 q/k/v, lf = log_sigmoid(f)."""
    q, k, v, i, f = (torch.from_numpy(a) for a in args)
    lf = torch.nn.functional.logsigmoid(f)
    NH, DH = q.shape[2], q.shape[3]
    return ([mk_ref.to_bh(t).to(torch.bfloat16) for t in (q, k, v)] + [mk_ref.to_bh(i), mk_ref.to_bh(lf)],
            [torch.from_numpy(carry[0]).reshape(NH, DH, DH), torch.from_numpy(carry[1]).reshape(NH, DH),
             torch.from_numpy(carry[2]).reshape(NH)])


@pytest.mark.parametrize("BH", [1, 4, 16, 33])
def test_plan_col_tile(BH):
    """16 columns a block where BH * DH / 32 blocks would leave SMs idle, 32
    otherwise; always a divisor of DH."""
    for DH in (32, 512, 1024):
        tc = mk_ops.plan_col_tile(BH, DH, 132)
        assert tc in (16, 32) and tc <= DH and DH % tc == 0
        assert tc == (16 if BH * DH // 32 < 132 else 32)
    assert mk_ops.plan_col_tile(4, 512) == 16 and 4 * 512 // 16 >= 128   # 128 blocks, not 64


@pytest.mark.parametrize("DH", [64, 512])
@pytest.mark.parametrize("S", [8, 16, 96, 200])
def test_tc_numerics_match_jnp_chunkwise_with_carry(DH, S):
    """The emulated kernel against jnp ``mlstm_chunkwise`` (chunk 64: L = S
    at S 8, 16 and the ragged 96 and 200), from a zero and a non-zero
    carry."""
    rng = np.random.default_rng(10 * S + DH)
    NH = 2
    cfg = j_get_config("xlstm-350m", smoke=True)
    cfg = cfg.replace(xlstm=cfg.xlstm.__class__(chunk=64))
    for zero in (True, False):
        args = _inputs(rng, NH, S, DH)
        carry = _carry(rng, NH, DH, zero)
        hj, (Cj, nj, mj) = jxl.mlstm_chunkwise(cfg, *map(jnp.asarray, args), *map(jnp.asarray, carry))
        x, c = _bh(args, carry)
        h, C, n, m = tc_chunkwise_bh(*x, *c, chunk=64)
        hj = mk_ref.to_bh(torch.from_numpy(np.array(hj, np.float32)))
        ref_max = float(hj.abs().max())
        assert float((h.float() - hj).abs().max()) / max(1.0, ref_max) < TOL_H, (DH, S, zero)
        for got, want in ((C, Cj), (n, nj)):
            want = torch.from_numpy(np.array(want, np.float32)).reshape(got.shape)
            assert float((got - want).abs().max()) / float(want.abs().max()) < TOL_STATE, (DH, S, zero)
        assert float((m - torch.from_numpy(np.array(mj)).reshape(NH)).abs().max()) < TOL_STATE


def test_tc_pad_chunk_leaves_the_state_bit_identical():
    """A chunk of pad steps (i = -1e30, lf = 0) keeps (C, n, m) bit for bit:
    exp(0) is 1 and the carry weights are 0."""
    rng = np.random.default_rng(3)
    NH, DH = 2, 64
    x, c = _bh(_inputs(rng, NH, 32, DH), _carry(rng, NH, DH, zero=False))
    i, lf = x[3].clone(), x[4].clone()
    i[:, 16:], lf[:, 16:] = mk_ref.NEG, 0.0
    padded = tc_chunkwise_bh(*x[:3], i, lf, *c, chunk=16)
    head = tc_chunkwise_bh(*(t[:, :16] for t in (*x[:3], i, lf)), *c, chunk=16)
    assert float(head[1].abs().max()) > 0.1
    for a, b in zip(padded[1:], head[1:]):
        assert torch.equal(a, b)


def test_tf32_truncate_drops_the_low_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, -3.0 - 2.0 ** -12, 0.0])
    assert tf32_truncate(x).tolist() == [1.0 + 2.0 ** -10, 1.0, -3.0, 0.0]
