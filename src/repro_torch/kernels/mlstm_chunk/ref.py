"""Plain chunkwise mLSTM with a carry (the port's ``mlstm_chunkwise``).

The torch twin of ``repro/models/xlstm.py``'s ``_mlstm_chunk`` and
``mlstm_chunkwise``: per chunk of L steps, the decay-weighted L x L
``q k^T`` term, its product with ``v``, the inter-chunk term ``q C`` and the
carry update ``C <- e^{..} C + (k w)^T v``, all stabilised in f32. Unlike the
TPU kernel it resumes from a non-zero carry ``(C0, n0, m0)``.

Two layouts: the kernel's (BH, S, DH) with ``lf = log_sigmoid(f)``, and the
model's (B, S, NH, DH) with raw gates.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG = -1e30


def chunk_len(S: int, chunk: int) -> int:
    """The chunk length L: ``min(chunk, S)``, and S itself when L does not
    divide S."""
    L = min(chunk, S)
    return S if S % L else L


def mlstm_chunk_bh(q, k, v, i, lf, C0, n0, m0):
    """One chunk. q, k, v: (BH, L, DH); i, lf: (BH, L) f32; C0 (BH, DH, DH),
    n0 (BH, DH), m0 (BH) f32. Returns (h (BH, L, DH) f32, (C, n, m))."""
    L = q.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    cum = torch.cumsum(lf, dim=-1)                                # inclusive
    total = cum[:, -1:]
    # intra-chunk decay D_ij = cum_i - cum_j + i_j (j <= i)
    Dm = cum[:, :, None] - cum[:, None, :] + i[:, None, :]
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool, device=q.device))
    Dm = torch.where(tri, Dm, torch.full_like(Dm, NEG))
    g = cum + m0[:, None]                                         # inter stabiliser input
    m_row = torch.maximum(Dm.amax(dim=-1), g)                     # (BH, L)
    s = (qf @ kf.transpose(1, 2)) * torch.exp(Dm - m_row[:, :, None])
    inter = torch.exp(g - m_row)[:, :, None]                      # (BH, L, 1)
    num = s @ vf + inter * (qf @ C0)
    den = s.sum(dim=-1) + inter[:, :, 0] * (qf @ n0[:, :, None])[:, :, 0]
    h = num / torch.clamp(den.abs(), min=1.0)[:, :, None]
    # carry update
    a = total - cum + i                                           # decay j..L + gate
    m_new = torch.maximum(total[:, 0] + m0, a.amax(dim=-1))
    scale_old = torch.exp(total[:, 0] + m0 - m_new)               # (BH,)
    w = torch.exp(a - m_new[:, None])                             # (BH, L)
    C = scale_old[:, None, None] * C0 + (kf * w[:, :, None]).transpose(1, 2) @ vf
    n = scale_old[:, None] * n0 + (kf * w[:, :, None]).sum(dim=1)
    return h, (C, n, m_new)


def mlstm_chunkwise_bh_ref(q, k, v, i, lf, C0, n0, m0, chunk: int = 64):
    """The kernel's function. q, k, v: (BH, S, DH); i, lf: (BH, S) f32;
    C0 (BH, DH, DH), n0 (BH, DH), m0 (BH) f32. Returns (h (BH, S, DH) in
    q's dtype, C, n, m) in f32, chunk by chunk in order."""
    S = q.shape[1]
    L = chunk_len(S, chunk)
    C, n, m = C0.float(), n0.float(), m0.float()
    hs = []
    for c0 in range(0, S, L):
        sl = slice(c0, c0 + L)
        h, (C, n, m) = mlstm_chunk_bh(q[:, sl], k[:, sl], v[:, sl], i[:, sl], lf[:, sl], C, n, m)
        hs.append(h)
    return torch.cat(hs, dim=1).to(q.dtype), C, n, m


def to_bh(t: torch.Tensor) -> torch.Tensor:
    """(B, S, NH, ...) -> (B*NH, S, ...)."""
    B, S, NH = t.shape[:3]
    return t.transpose(1, 2).reshape(B * NH, S, *t.shape[3:]).contiguous()


def from_bh(t: torch.Tensor, B: int) -> torch.Tensor:
    """(B*NH, S, ...) -> (B, S, NH, ...)."""
    BH, S = t.shape[:2]
    return t.reshape(B, BH // B, S, *t.shape[2:]).transpose(1, 2)


def mlstm_chunkwise(q, k, v, i, f, C0, n0, m0, chunk: int = 64, bh_fn=mlstm_chunkwise_bh_ref):
    """The model's layout. q, k, v: (B, S, NH, DH); i, f: (B, S, NH) raw
    gates; C0 (B, NH, DH, DH), n0 (B, NH, DH), m0 (B, NH). Returns
    (h (B, S, NH, DH) in q's dtype, (C, n, m)) in f32. ``bh_fn`` computes
    the (BH, S, DH) form (the plain version, or the kernel's wrapper)."""
    B, S, NH, DH = q.shape
    lf = F.logsigmoid(f.float())
    h, C, n, m = bh_fn(to_bh(q), to_bh(k), to_bh(v), to_bh(i.float()), to_bh(lf),
                       C0.reshape(B * NH, DH, DH).float().contiguous(),
                       n0.reshape(B * NH, DH).float().contiguous(),
                       m0.reshape(B * NH).float().contiguous(), chunk=chunk)
    return from_bh(h, B), (C.reshape(B, NH, DH, DH), n.reshape(B, NH, DH), m.reshape(B, NH))
