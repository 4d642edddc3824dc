"""xLSTM blocks: chunkwise-parallel mLSTM and sequential sLSTM (the torch twin
of ``repro/models/xlstm.py``).

mLSTM recurrence (per head; q scaled by 1/sqrt(DK)):
    m_t = max(lf_t + m_{t-1}, i_t)
    C_t = exp(lf_t + m_{t-1} - m_t) C_{t-1} + exp(i_t - m_t) k_t v_t^T
    n_t = exp(lf_t + m_{t-1} - m_t) n_{t-1} + exp(i_t - m_t) k_t
    h_t = (q_t C_t) / max(|q_t . n_t|, 1)

A prefill runs the chunkwise form (``kernels/mlstm_chunk``: the Hopper
kernel on the card, its plain version on the CPU), resuming from the
cache's or the chunk carry's ``(C, n, m)``; the decode step runs the
sequential form, a Python loop over S, as the JAX package runs it in jnp.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.mlstm_chunk import ops as mk_ops
from repro_torch.kernels.mlstm_chunk import ref as mk_ref
from repro_torch.models.attention import TensorSpec
from repro_torch.models.common import NULL, TP, ModelConfig, ParamDef, rmsnorm
from repro_torch.models.mamba import conv_state_at

NEG = mk_ref.NEG
# A forget-gate preactivation this large makes log_sigmoid(f) exactly 0.0 in
# f32 (softplus(-BIG) underflows), so a masked pad step multiplies the state
# by exp(0) == 1: bit-exact identity, not merely approximate.
BIG = 1e9


def _mlstm_dims(cfg: ModelConfig) -> Tuple[int, int]:
    dU = int(cfg.xlstm.proj_factor * cfg.d_model)  # up-projected width
    return dU, dU // cfg.n_heads


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    dU, _ = _mlstm_dims(cfg)
    NH = cfg.n_heads
    K = cfg.xlstm.conv
    return {
        "up_proj": ParamDef((d, 2 * dU), (NULL, TP)),
        "conv_w": ParamDef((K, dU), (NULL, TP), scale=0.5),
        "conv_b": ParamDef((dU,), (TP,), "zeros"),
        "wq": ParamDef((dU, dU), (NULL, TP)),
        "wk": ParamDef((dU, dU), (NULL, TP)),
        "wv": ParamDef((dU, dU), (NULL, TP)),
        "wi": ParamDef((dU, NH), (TP, NULL)),
        "wf": ParamDef((dU, NH), (TP, NULL)),
        "bi": ParamDef((NH,), (NULL,), "zeros"),
        "bf": ParamDef((NH,), (NULL,), "ones"),   # bias toward remembering
        "hnorm": ParamDef((dU,), (TP,), "ones"),
        "down_proj": ParamDef((dU, d), (TP, NULL)),
    }


def mlstm_cache_defs(cfg: ModelConfig, batch: int) -> dict:
    dU, DH = _mlstm_dims(cfg)
    NH = cfg.n_heads
    K = cfg.xlstm.conv
    return {
        "C": TensorSpec((batch, NH, DH, DH), torch.float32),
        "n": TensorSpec((batch, NH, DH), torch.float32),
        "m": TensorSpec((batch, NH), torch.float32),
        "conv": TensorSpec((batch, K - 1, dU), cfg.compute_dtype),
    }


def _conv(cfg: ModelConfig, p: Mapping, x: torch.Tensor, state, n_valid=None):
    """Depthwise causal conv over the sequence, from ``state`` (B, K-1, dU)
    or zeros. Returns (silu(conv + b), the new state)."""
    B, S, dU = x.shape
    K = cfg.xlstm.conv
    if state is None:
        state = torch.zeros((B, K - 1, dU), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = torch.zeros_like(x)
    w = p["conv_w"].to(x.dtype)
    for k in range(K):
        out = out + xp[:, k:k + S, :] * w[k]
    new_state = xp[:, S:, :] if n_valid is None else conv_state_at(xp, n_valid, K)
    return F.silu(out + p["conv_b"].to(x.dtype)), new_state


def _qkvif(cfg: ModelConfig, p: Mapping, xm: torch.Tensor, xc: torch.Tensor):
    """xm: conv path (B, S, dU); xc: raw up-projection (B, S, dU) for v."""
    B, S, dU = xm.shape
    NH = cfg.n_heads
    DH = dU // NH
    q = (xm @ p["wq"].to(xm.dtype)).reshape(B, S, NH, DH)
    k = (xm @ p["wk"].to(xm.dtype)).reshape(B, S, NH, DH)
    v = (xc @ p["wv"].to(xm.dtype)).reshape(B, S, NH, DH)
    i = (xm @ p["wi"].to(xm.dtype)).float() + p["bi"].float()
    f = (xm @ p["wf"].to(xm.dtype)).float() + p["bf"].float()
    q = q * (DH ** -0.5)
    return q, k, v, i, f


def mlstm_sequential(q, k, v, i, f, C0, n0, m0):
    """Decode path and oracle. q, k, v: (B, S, NH, DH); i, f: (B, S, NH)
    raw. Returns (h (B, S, NH, DH) f32, (C, n, m))."""
    lf = F.logsigmoid(f)
    C, n, m = C0, n0, m0
    hs = []
    for t in range(q.shape[1]):
        qt, kt, vt = q[:, t].float(), k[:, t].float(), v[:, t].float()
        it, lft = i[:, t], lf[:, t]
        m_new = torch.maximum(lft + m, it)
        a = torch.exp(lft + m - m_new)[..., None]              # (B, NH, 1)
        b = torch.exp(it - m_new)[..., None]
        C = a[..., None] * C + b[..., None] * (kt[..., :, None] * vt[..., None, :])
        n = a * n + b * kt
        num = torch.einsum("bhd,bhde->bhe", qt, C)
        den = torch.clamp(torch.einsum("bhd,bhd->bh", qt, n).abs(), min=1.0)
        hs.append(num / den[..., None])
        m = m_new
    return torch.stack(hs, dim=1), (C, n, m)


def mlstm_chunkwise(cfg: ModelConfig, q, k, v, i, f, C0, n0, m0):
    """The plain chunkwise form over the whole sequence, chunk length
    ``min(chunk, S)`` (S itself when that does not divide S); one chunk's
    form is ``kernels/mlstm_chunk/ref.mlstm_chunk_bh``."""
    return mk_ref.mlstm_chunkwise(q, k, v, i, f, C0, n0, m0, chunk=cfg.xlstm.chunk)


def mlstm_mixer(cfg: ModelConfig, p: Mapping, x: torch.Tensor, mode: str, cache=None, valid=None):
    """x: (B, S, d) -> (out, new_cache).

    ``valid`` (B, S) bool marks right-padded prefill. Identity pad steps via
    the gates: i -> NEG kills the input branch (exp(i - m) == 0) and
    f -> BIG makes the retain factor exp(log_sigmoid(f)) == 1 exactly, in
    both the sequential and the chunkwise form (kernel included)."""
    B, S, d = x.shape
    dU, DH = _mlstm_dims(cfg)
    NH = cfg.n_heads
    xz = x @ p["up_proj"].to(x.dtype)
    xu, z = torch.split(xz, dU, dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    n_valid = valid.sum(dim=1).to(torch.int32) if valid is not None else None
    xm, new_conv = _conv(cfg, p, xu, conv_state, n_valid=n_valid)
    q, k, v, i, f = _qkvif(cfg, p, xm, xu)
    if valid is not None:
        i = torch.where(valid[..., None], i, torch.full_like(i, NEG))
        f = torch.where(valid[..., None], f, torch.full_like(f, BIG))

    if cache is not None:
        C0, n0, m0 = cache["C"], cache["n"], cache["m"]
    else:
        C0 = torch.zeros((B, NH, DH, DH), dtype=torch.float32, device=x.device)
        n0 = torch.zeros((B, NH, DH), dtype=torch.float32, device=x.device)
        m0 = torch.zeros((B, NH), dtype=torch.float32, device=x.device)

    if mode == "decode":
        h, (C, n, m) = mlstm_sequential(q, k, v, i, f, C0, n0, m0)
    else:
        h, (C, n, m) = mk_ops.mlstm_chunkwise(q, k, v, i, f, C0, n0, m0, chunk=cfg.xlstm.chunk)

    h = h.reshape(B, S, dU).to(x.dtype)
    # head-wise norm (rmsnorm over DH per head), then the output gate
    h = rmsnorm(h.reshape(B, S, NH, DH), torch.ones(DH, device=x.device)).reshape(B, S, dU)
    h = h * p["hnorm"].to(x.dtype)
    h = h * F.silu(z)
    out = h @ p["down_proj"].to(x.dtype)
    new_cache = None
    if cache is not None:
        new_cache = {"C": C, "n": n, "m": m, "conv": new_conv.to(cache["conv"].dtype)}
    return out, new_cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    NH = cfg.n_heads
    DH = d // NH
    return {
        "w_gates": ParamDef((d, 4 * d), (NULL, NULL)),
        "r_gates": ParamDef((NH, DH, 4 * DH), (NULL, NULL, NULL), scale=0.3),
        "b_gates": ParamDef((4 * d,), (NULL,), "zeros"),
        "out_proj": ParamDef((d, d), (NULL, TP)),
        "hnorm": ParamDef((d,), (NULL,), "ones"),
    }


def slstm_cache_defs(cfg: ModelConfig, batch: int) -> dict:
    NH = cfg.n_heads
    DH = cfg.d_model // NH
    sd = TensorSpec((batch, NH, DH), torch.float32)
    return {"c": sd, "n": sd, "h": sd, "m": TensorSpec((batch, NH), torch.float32)}


def slstm_mixer(cfg: ModelConfig, p: Mapping, x: torch.Tensor, mode: str, cache=None, valid=None):
    """Sequential sLSTM with exponential gating and head-wise recurrence.
    ``valid`` (B, S) bool: pad steps keep the previous carry unchanged."""
    B, S, d = x.shape
    NH = cfg.n_heads
    DH = d // NH
    wx = (x @ p["w_gates"].to(x.dtype)).float() + p["b_gates"].float()
    wx = wx.reshape(B, S, NH, 4 * DH)
    R = p["r_gates"].float()

    if cache is not None:
        c, n, h, m = cache["c"], cache["n"], cache["h"], cache["m"]
    else:
        # zeros, as the cache starts: prefill then decode continues exactly
        # (h divides by max(n, 1), so n = 0 is safe)
        c = torch.zeros((B, NH, DH), dtype=torch.float32, device=x.device)
        n, h = torch.zeros_like(c), torch.zeros_like(c)
        m = torch.zeros((B, NH), dtype=torch.float32, device=x.device)

    vmask = valid if valid is not None else torch.ones((B, S), dtype=torch.bool, device=x.device)
    hs = []
    for t in range(S):
        pre = wx[:, t] + torch.einsum("bhd,hde->bhe", h, R)   # (B, NH, 4DH)
        zt, it, ft, ot = torch.split(pre, DH, dim=-1)
        # scalar-per-cell exponential gating with a stabiliser (max over cell dims)
        i_s = it.amax(dim=-1)
        f_s = F.logsigmoid(ft.amax(dim=-1))
        m_new = torch.maximum(f_s + m, i_s)
        i_g = torch.exp(it - m_new[..., None])
        f_g = torch.exp(F.logsigmoid(ft) + m[..., None] - m_new[..., None])
        c_new = f_g * c + i_g * torch.tanh(zt)
        n_new = f_g * n + i_g
        h_new = torch.sigmoid(ot) * c_new / torch.clamp(n_new, min=1.0)
        hs.append(h_new)
        # pad steps carry the previous state through untouched
        keep = vmask[:, t, None, None]
        c = torch.where(keep, c_new, c)
        n = torch.where(keep, n_new, n)
        h = torch.where(keep, h_new, h)
        m = torch.where(keep[..., 0], m_new, m)
    out = torch.stack(hs, dim=1).reshape(B, S, d).to(x.dtype)
    out = rmsnorm(out, p["hnorm"])
    out = out @ p["out_proj"].to(x.dtype)
    new_cache = {"c": c, "n": n, "h": h, "m": m} if cache is not None else None
    return out, new_cache
