"""Mamba (S6) selective-state-space mixer, the torch twin of
``repro/models/mamba.py``.

A prefill runs the selective scan a chunk at a time: within a chunk an
inclusive scan of the pairs ``(Abar, Bx)`` (``_chunk_scan``, a doubling
scan in log2(L) steps over (B, L, d_inner, d_state) tensors; no L x L
matrix), across chunks the state ``h`` carried in a Python loop, as the JAX
package carries it through ``lax.scan``. A decode step runs the exact
recurrence on ``(conv, ssm)``. ``conv_state_at`` is shared with the xLSTM
mixers. Plain torch throughout: the reference has no Pallas kernel here.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.attention import TensorSpec
from repro_torch.models.common import NULL, TP, ModelConfig, ParamDef


def _dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    dt_rank = m.dt_rank or math.ceil(cfg.d_model / 16)
    return d_inner, dt_rank, m.d_state


def mamba_defs(cfg: ModelConfig) -> dict:
    m = cfg.mamba
    d = cfg.d_model
    dI, dtR, dS = _dims(cfg)
    return {
        "in_proj": ParamDef((d, 2 * dI), (NULL, TP)),
        "conv_w": ParamDef((m.d_conv, dI), (NULL, TP), scale=0.5),
        "conv_b": ParamDef((dI,), (TP,), "zeros"),
        "x_proj": ParamDef((dI, dtR + 2 * dS), (TP, NULL)),
        "dt_proj": ParamDef((dtR, dI), (NULL, TP)),
        "dt_bias": ParamDef((dI,), (TP,), "zeros"),
        "A_log": ParamDef((dI, dS), (TP, NULL), "zeros"),   # A = -exp(A_log) ~ -1
        "D": ParamDef((dI,), (TP,), "ones"),
        "out_proj": ParamDef((dI, d), (TP, NULL)),
    }


def mamba_cache_defs(cfg: ModelConfig, batch: int) -> dict:
    m = cfg.mamba
    dI, _, dS = _dims(cfg)
    return {
        "conv": TensorSpec((batch, m.d_conv - 1, dI), cfg.compute_dtype),
        "ssm": TensorSpec((batch, dI, dS), torch.float32),
    }


def conv_state_at(xp: torch.Tensor, n_valid, K: int) -> torch.Tensor:
    """Rolling conv state as of the last *valid* token of a right-padded
    sequence. xp is the state-prepended input (B, S+K-1, d), so the K-1
    inputs ending at token n_valid-1 live at xp[:, n_valid : n_valid+K-1].
    The start is clamped into [0, S], as ``dynamic_slice_in_dim`` clamps it."""
    B, T, _ = xp.shape
    S = T - (K - 1)
    nv = torch.as_tensor(n_valid, dtype=torch.long, device=xp.device).reshape(-1).expand(B)
    idx = nv.clamp(0, S)[:, None] + torch.arange(K - 1, device=xp.device)[None, :]
    return torch.gather(xp, 1, idx[:, :, None].expand(B, K - 1, xp.shape[2]))


def _causal_conv(cfg: ModelConfig, p: Mapping, x: torch.Tensor, state: Optional[torch.Tensor],
                 n_valid=None):
    """Depthwise causal conv1d. x: (B, S, dI); state: (B, K-1, dI) or None.
    Returns (out (B, S, dI), new_state (B, K-1, dI)). ``n_valid`` (B,) makes
    the carried state reflect the last valid token instead of trailing
    padding."""
    B, S, dI = x.shape
    K = cfg.mamba.d_conv
    if state is None:
        state = torch.zeros((B, K - 1, dI), dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)          # (B, S+K-1, dI)
    out = torch.zeros_like(x)
    w = p["conv_w"].to(x.dtype)
    for k in range(K):
        out = out + xp[:, k:k + S, :] * w[k]
    out = out + p["conv_b"].to(x.dtype)
    if K <= 1:
        new_state = state
    elif n_valid is None:
        new_state = xp[:, S:, :]
    else:
        new_state = conv_state_at(xp, n_valid, K)
    return out, new_state


def _ssm_inputs(cfg: ModelConfig, p: Mapping, xc: torch.Tensor):
    """xc: conv+silu output (B, S, dI) -> dt (B, S, dI), Bc/Cc (B, S, dS),
    A (dI, dS); the projections in xc's dtype, the rest in f32.

    ``F.softplus`` returns its input above a threshold of 20, where
    ``jax.nn.softplus`` computes log1p(exp(-x)) + x: the two differ by less
    than 3e-9 there, far inside every tolerance."""
    dI, dtR, dS = _dims(cfg)
    proj = xc @ p["x_proj"].to(xc.dtype)
    dt_r, Bc, Cc = torch.split(proj, [dtR, dS, dS], dim=-1)
    dt = dt_r @ p["dt_proj"].to(xc.dtype)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())                      # (dI, dS)
    return dt, Bc.float(), Cc.float(), A


def _chunk_scan(dt, Bc, Cc, A, xc, h0):
    """One chunk of the selective scan.

    dt: (B, L, dI) f32; Bc/Cc: (B, L, dS) f32; A: (dI, dS); xc: (B, L, dI);
    h0: (B, dI, dS) f32. Returns (y (B, L, dI) f32, h_last).

    The inclusive scan of the pairs (Abar, Bx) under comb(l, r) = (r0 l0,
    r0 l1 + r1) is a doubling scan: at step k every position t >= k
    combines with t - k, so after log2(L) steps position t holds the
    product Acum of Abar over [0, t] and the state hin reached from zero.
    Then h = Acum h0 + hin, as in the reference; only the order of the
    products differs from its associative scan."""
    Abar = torch.exp(dt[..., None] * A)                     # (B, L, dI, dS)
    Bx = (dt * xc.float())[..., None] * Bc[:, :, None, :]
    L, k = Abar.shape[1], 1
    while k < L:
        Bx = torch.cat([Bx[:, :k], torch.addcmul(Bx[:, k:], Abar[:, k:], Bx[:, :-k])], dim=1)
        Abar = torch.cat([Abar[:, :k], Abar[:, k:] * Abar[:, :-k]], dim=1)
        k *= 2
    h = Abar * h0[:, None] + Bx                             # (B, L, dI, dS)
    y = torch.einsum("blds,bls->bld", h, Cc)
    return y, h[:, -1]


def mamba_mixer(cfg: ModelConfig, p: Mapping, x: torch.Tensor, mode: str, cache=None, valid=None):
    """x: (B, S, d). Returns (out (B, S, d), new_cache).

    ``valid`` (B, S) bool marks right-padded prefill: pad steps must be
    identity on the carried state. Masking dt to 0 does exactly that
    (Abar = exp(0 A) = 1 and the input contribution dt x B vanishes), and the
    conv state is gathered at the last valid token. A prefill resumes from
    ``cache["ssm"]`` (zeros for a fresh sequence, the carry for a chunked
    prefill's continuation); a decode runs the exact recurrence over its S
    steps from ``cache``."""
    B, S, d = x.shape
    dI, _, dS = _dims(cfg)
    xz = x @ p["in_proj"].to(x.dtype)
    xp, z = torch.split(xz, dI, dim=-1)

    conv_state = cache["conv"] if cache is not None else None
    n_valid = valid.sum(dim=1).to(torch.int32) if valid is not None else None
    if mode == "decode":
        xc, new_conv = _causal_conv(cfg, p, xp, conv_state)
        xc = F.silu(xc)
        dt, Bc, Cc, A = _ssm_inputs(cfg, p, xc)
        h = cache["ssm"]
        ys = []
        for t in range(S):       # S is 1 for a decode step; a short static loop otherwise
            Abar = torch.exp(dt[:, t, :, None] * A)
            h = Abar * h + (dt[:, t] * xc[:, t].float())[..., None] * Bc[:, t, None, :]
            ys.append(torch.einsum("bds,bs->bd", h, Cc[:, t]))
        y = torch.stack(ys, dim=1)
        new_cache = {"conv": new_conv, "ssm": h}
    else:
        xc, new_conv = _causal_conv(cfg, p, xp, conv_state, n_valid=n_valid)
        xc = F.silu(xc)
        dt, Bc, Cc, A = _ssm_inputs(cfg, p, xc)
        if valid is not None:
            dt = torch.where(valid[..., None], dt, torch.zeros_like(dt))   # pad step == identity
        chunk = min(cfg.mamba.chunk, S)
        if S % chunk != 0:
            chunk = S
        h = cache["ssm"] if cache is not None else torch.zeros((B, dI, dS), dtype=torch.float32,
                                                               device=x.device)
        ys = []
        for c in range(0, S, chunk):
            sl = slice(c, c + chunk)
            y_c, h = _chunk_scan(dt[:, sl], Bc[:, sl], Cc[:, sl], A, xc[:, sl], h)
            ys.append(y_c)
        y = torch.cat(ys, dim=1)
        new_cache = {"conv": new_conv, "ssm": h} if cache is not None else None

    y = y.to(x.dtype) + p["D"].to(x.dtype) * xc
    out = y * F.silu(z)
    out = out @ p["out_proj"].to(x.dtype)
    return out, new_cache
