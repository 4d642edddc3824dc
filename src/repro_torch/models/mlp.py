"""Dense FFN: gated (SwiGLU) or plain MLP. The products stay ``torch.matmul``,
as the JAX package leaves them to XLA."""
from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.models.common import ModelConfig, ParamDef, activation


def mlp_defs(cfg: ModelConfig, d_ff: int = 0) -> dict:
    d, f = cfg.d_model, (d_ff or cfg.d_ff)
    defs = {"w1": ParamDef((d, f)), "w2": ParamDef((f, d))}
    if cfg.gated_mlp:
        defs["w3"] = ParamDef((d, f))
    return defs


def mlp(cfg: ModelConfig, p: Mapping, x: torch.Tensor) -> torch.Tensor:
    h = activation(cfg, x @ p["w1"].to(x.dtype))
    if cfg.gated_mlp:
        h = h * (x @ p["w3"].to(x.dtype))
    return h @ p["w2"].to(x.dtype)
