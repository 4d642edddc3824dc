"""Dense FFN: gated (SwiGLU) or plain MLP. The products go through
``quant.qeinsum`` (``torch.matmul``, or the weight-only int8 product), as the
JAX package leaves them to XLA."""
from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.models.common import NULL, TP, ModelConfig, ParamDef, activation
from repro_torch.models.quant import qeinsum


def mlp_defs(cfg: ModelConfig, d_ff: int = 0) -> dict:
    d, f = cfg.d_model, (d_ff or cfg.d_ff)
    defs = {"w1": ParamDef((d, f), (NULL, TP)), "w2": ParamDef((f, d), (TP, NULL))}
    if cfg.gated_mlp:
        defs["w3"] = ParamDef((d, f), (NULL, TP))
    return defs


def mlp(cfg: ModelConfig, p: Mapping, x: torch.Tensor) -> torch.Tensor:
    h = activation(cfg, qeinsum(x, p["w1"]))
    if cfg.gated_mlp:
        h = h * qeinsum(x, p["w3"])
    return qeinsum(h, p["w2"])
