"""Parameter bridge: the JAX package's parameter tree, as numpy arrays, into
the port's tree of tensors.

The caller converts the JAX tree leaf by leaf
(``jax.tree.map(np.asarray, params)``), so this module never sees JAX. numpy
has no bf16: a bf16 leaf arrives either as the ``ml_dtypes`` bfloat16 array
JAX hands out, or as its raw bits in a ``uint16`` array; both become
``torch.bfloat16`` bit for bit. The stacked layout is kept: ``blocks/l0_*``
leaves carry the leading superblock axis, and ``embedding``, ``unembed`` and
``final_norm`` sit at the top level.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.models.common import ModelConfig, ParamDef, is_def
from repro_torch.models.transformer import param_defs


def _leaf(a, want: ParamDef, dtype, device, path: str) -> torch.Tensor:
    a = np.array(a)          # a writable copy: JAX hands out read-only views
    if tuple(a.shape) != tuple(want.shape):
        raise ValueError(f"{path}: shape {a.shape} != expected {want.shape}")
    if a.dtype == np.uint16 or a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def params_from_jax(tree: Mapping, cfg: ModelConfig, device) -> Any:
    """numpy tree -> port tree on ``device`` in ``cfg.param_dtype``; every
    leaf's shape is checked against the port's ParamDefs, and a missing or
    extra key raises."""
    defs = param_defs(cfg)

    def walk(node, d, path):
        if is_def(d):
            return _leaf(node, d, cfg.param_dtype, device, path)
        if set(node) != set(d):
            raise KeyError(f"{path or '/'}: keys {sorted(node)} != expected {sorted(d)}")
        return {k: walk(node[k], d[k], f"{path}/{k}") for k in d}

    return walk(tree, defs, "")
