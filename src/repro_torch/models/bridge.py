"""Parameter bridge: the JAX package's parameter tree, as numpy arrays, into
the port's tree of tensors (``params_from_jax``), and a port tree out to
numpy (``params_to_numpy``, for comparing gradients and updated parameters
with the JAX package's).

The caller converts the JAX tree leaf by leaf
(``jax.tree.map(np.asarray, params)``), so this module never sees JAX. numpy
has no bf16: a bf16 leaf arrives either as the ``ml_dtypes`` bfloat16 array
JAX hands out, or as its raw bits in a ``uint16`` array; both become
``torch.bfloat16`` bit for bit. The stacked layout is kept: ``blocks/l0_*``
leaves carry the leading superblock axis, and ``embedding``, ``unembed`` and
``final_norm`` sit at the top level (under ``decoder``, beside the
``encoder``'s ``blocks`` and ``final_norm``, for an encoder-decoder). A tree that went through the JAX
package's ``quantize_params`` carries a {"q", "s"} dict at each
``QUANT_LEAVES`` key: int8 values of the leaf's shape, which stay int8, and
bf16 scales of that shape with axis ndim - 2 at 1. The Xception classifier's
flat tree (``XceptionConfig``) comes across the same way, its HWIO kernels
as they are.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.models import xception
from repro_torch.models.common import ParamDef, is_def
from repro_torch.models.quant import QUANT_LEAVES, scale_shape
from repro_torch.models.api import get_model


def _tensor(a, shape, path: str) -> torch.Tensor:
    a = np.array(a)          # a writable copy: JAX hands out read-only views
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"{path}: shape {a.shape} != expected {tuple(shape)}")
    if a.dtype == np.uint16 or a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _leaf(a, want: ParamDef, dtype, device, path: str):
    if not isinstance(a, Mapping):
        return _tensor(a, want.shape, path).to(device=device, dtype=dtype)
    key = path.rsplit("/", 1)[-1]
    if key not in QUANT_LEAVES or len(want.shape) < 2 or set(a) != {"q", "s"}:
        raise ValueError(f"{path}: a quantized leaf (keys {sorted(a)}) where a plain one is expected")
    q, s = _tensor(a["q"], want.shape, f"{path}/q"), _tensor(a["s"], scale_shape(want.shape), f"{path}/s")
    if q.dtype != torch.int8 or s.dtype != torch.bfloat16:
        raise ValueError(f"{path}: quantized leaf of {q.dtype} and {s.dtype}, expected int8 and bf16")
    return {"q": q.to(device), "s": s.to(device)}


def params_from_jax(tree: Mapping, cfg, device) -> Any:
    """numpy tree -> port tree on ``device`` in ``cfg.param_dtype`` (a
    quantized leaf keeps its int8 values and bf16 scales); every leaf's shape
    is checked against the port's ParamDefs (``cfg`` a ``ModelConfig`` or an
    ``XceptionConfig``), and a missing or extra key raises."""
    if isinstance(cfg, xception.XceptionConfig):
        defs = xception.param_defs(cfg)
    else:
        defs = get_model(cfg).param_defs()

    def walk(node, d, path):
        if is_def(d):
            return _leaf(node, d, cfg.param_dtype, device, path)
        if set(node) != set(d):
            raise KeyError(f"{path or '/'}: keys {sorted(node)} != expected {sorted(d)}")
        return {k: walk(node[k], d[k], f"{path}/{k}") for k in d}

    return walk(tree, defs, "")


def params_to_numpy(tree: Any) -> Any:
    """Port tree (nested dicts of tensors, on any device) -> the same
    structure of numpy arrays on the host; a bf16 leaf becomes its raw bits
    as ``uint16``, the form ``params_from_jax`` takes back."""
    if isinstance(tree, Mapping):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()
