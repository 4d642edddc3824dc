"""MODEL_FLOPS conventions (the roofline's 'useful compute' numerator): the
torch twin of ``repro/launch/flops.py``, over the port's ``param_defs``.

train:   6 * N_active * tokens      (fwd 2ND + bwd 4ND)
prefill: 2 * N_active * tokens
decode:  2 * N_active * global_batch

N_active excludes the embedding table; MoE expert weights count at
top_k / n_experts. Enc-dec counts encoder params against encoder tokens
(B * n_ctx) and decoder params against decoder tokens separately.
"""
from __future__ import annotations

import math

from repro_torch.models.common import ModelConfig, is_def


def _paths(defs, keys=()):
    """(key path, ParamDef) of every leaf."""
    if is_def(defs):
        yield keys, defs
        return
    for k, v in defs.items():
        yield from _paths(v, keys + (str(k),))


def _count(defs, cfg: ModelConfig):
    total = 0.0
    active = 0.0
    for keys, d in _paths(defs):
        n = float(math.prod(d.shape))
        total += n
        if "embedding" in keys:
            continue  # excluded from N
        frac = 1.0
        if cfg.moe is not None and any("_ffn" == k[-4:] and k.startswith("l") for k in keys):
            lkey = next(k for k in keys if k.endswith("_ffn"))
            pos = int(lkey[1:-4])
            if cfg.layer_has_moe(pos) and keys[-1] in ("w1", "w2", "w3"):
                frac = cfg.moe.top_k / cfg.moe.n_experts
        active += n * frac
    return total, active


def active_params(model):
    """(decoder N_active, encoder N_active); the second is 0.0 without an
    encoder."""
    cfg = model.cfg
    defs = model.param_defs()
    if cfg.encoder is not None:
        _, a_dec = _count(defs["decoder"], cfg)
        _, a_enc = _count(defs["encoder"], cfg)
        return a_dec, a_enc
    _, a = _count(defs, cfg)
    return a, 0.0


def model_flops(model, shape_spec) -> float:
    cfg = model.cfg
    a_dec, a_enc = active_params(model)
    B, S = shape_spec.global_batch, shape_spec.seq_len
    if shape_spec.kind == "train":
        f = 6.0 * a_dec * B * S
        if cfg.encoder is not None:
            f += 6.0 * a_enc * B * cfg.encoder.n_ctx
        return f
    if shape_spec.kind == "prefill":
        f = 2.0 * a_dec * B * S
        if cfg.encoder is not None:
            f += 2.0 * a_enc * B * cfg.encoder.n_ctx
        return f
    if shape_spec.kind == "decode":
        return 2.0 * a_dec * B
    raise ValueError(shape_spec.kind)
