"""Xception-analog image classifier — the paper's own application model
(the torch twin of ``repro/models/xception.py``).

StraightLine's evaluation serves an Xception image classifier (4 classes:
cats / chook / dogs / horses, 299x299 inputs). The same depthwise-separable
architecture, with configurable width and depth: an entry conv of stride 2,
``n_blocks`` separable blocks (depthwise 3x3, pointwise 1x1, batch
statistics, residual, ReLU), a global mean and a linear head.

The parameter tree keeps the JAX package's layout (HWIO kernels, flat keys),
so trees, checkpoints and gradients compare leaf for leaf; ``forward`` takes
NHWC images as JAX does and permutes views inside. The convolutions are
``F.conv2d`` (cuDNN on the card), as the JAX package computes them with
``lax.conv_general_dilated`` outside any Pallas kernel: the model has no
kernel of its own.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch
import torch.nn.functional as F

from repro_torch.models.common import NULL, ParamDef, init_tree, map_defs

BN_EPS = 1e-5


@dataclass(frozen=True)
class XceptionConfig:
    num_classes: int = 4
    width: int = 32            # entry conv channels
    n_blocks: int = 4          # middle separable blocks
    img_size: int = 64         # reduced from 299 for CPU speed (same structure)
    param_dtype: object = torch.float32


def _conv_def(k: int, cin: int, cout: int) -> ParamDef:
    return ParamDef((k, k, cin, cout), (NULL,) * 4)


def param_defs(cfg: XceptionConfig) -> dict:
    w = cfg.width
    defs = {
        "entry": _conv_def(3, 3, w),
        "entry_b": ParamDef((w,), (NULL,), "zeros"),
    }
    for i in range(cfg.n_blocks):
        defs[f"b{i}_dw"] = ParamDef((3, 3, 1, w), (NULL,) * 4)       # depthwise
        defs[f"b{i}_pw"] = _conv_def(1, w, w)                         # pointwise
        defs[f"b{i}_bn_scale"] = ParamDef((w,), (NULL,), "ones")
        defs[f"b{i}_bn_bias"] = ParamDef((w,), (NULL,), "zeros")
    defs["head"] = ParamDef((w, cfg.num_classes), (NULL, NULL))
    defs["head_b"] = ParamDef((cfg.num_classes,), (NULL,), "zeros")
    return defs


def init(gen: torch.Generator, cfg: XceptionConfig, device) -> dict:
    """Random weights drawn from ``gen`` (a generator on ``device``) in the
    order of ``param_defs``."""
    return init_tree(gen, param_defs(cfg), cfg.param_dtype, device)


def param_shapes(cfg: XceptionConfig) -> dict:
    """The tree's shapes and dtypes as tensors on the ``meta`` device (no
    allocation)."""
    return map_defs(lambda d: torch.empty(d.shape, dtype=cfg.param_dtype, device="meta"), param_defs(cfg))


def same_pads(n: int, k: int, stride: int) -> tuple:
    """XLA's ``"SAME"`` padding of one spatial axis of length ``n``: the
    output is ceil(n / stride) long and the low side gets the smaller half of
    the padding. For stride 2 and an even ``n`` that is (0, 1), which no
    symmetric ``padding=`` of ``F.conv2d`` gives."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w_hwio: torch.Tensor, stride: int = 1, groups: int = 1) -> torch.Tensor:
    """x (B, C, H, W) against a JAX-layout (kh, kw, C / groups, O) kernel
    with XLA's ``"SAME"`` padding."""
    ph, pw = (same_pads(n, k, stride) for n, k in zip(x.shape[2:], w_hwio.shape[:2]))
    if ph[0] != ph[1] or pw[0] != pw[1]:
        x, ph, pw = F.pad(x, (*pw, *ph)), (0, 0), (0, 0)
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), stride=stride, padding=(ph[0], pw[0]), groups=groups)


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(1, -1, 1, 1)


def _sep_block(p: Mapping, i: int, x: torch.Tensor) -> torch.Tensor:
    h = _conv(x, p[f"b{i}_dw"], groups=x.shape[1])
    h = _conv(h, p[f"b{i}_pw"])
    # batch statistics over N, H and W with the population variance (jnp's
    # ddof=0), in training and inference alike: there are no running stats
    mu = h.mean(dim=(0, 2, 3), keepdim=True)
    var = h.var(dim=(0, 2, 3), correction=0, keepdim=True)
    h = (h - mu) * torch.rsqrt(var + BN_EPS)
    h = h * _channel(p[f"b{i}_bn_scale"]) + _channel(p[f"b{i}_bn_bias"])
    return torch.relu(x + h)


def forward_nchw(cfg: XceptionConfig, params: Mapping, x: torch.Tensor) -> torch.Tensor:
    """x: (B, 3, H, W) in either memory layout (each convolution keeps its
    input's) -> logits (B, num_classes)."""
    x = torch.relu(_conv(x, params["entry"], stride=2) + _channel(params["entry_b"]))
    for i in range(cfg.n_blocks):
        x = _sep_block(params, i, x)
    return x.mean(dim=(2, 3)) @ params["head"] + params["head_b"]


def forward(cfg: XceptionConfig, params: Mapping, images) -> torch.Tensor:
    """images: (B, H, W, 3) -> logits (B, num_classes). The NHWC images are
    viewed as NCHW without a copy, which is the ``channels_last`` layout."""
    x = torch.as_tensor(images, dtype=params["entry"].dtype, device=params["entry"].device)
    return forward_nchw(cfg, params, x.permute(0, 3, 1, 2))


def loss_fn(cfg: XceptionConfig, params: Mapping, images, labels):
    """Mean cross-entropy of ``labels`` (B,) and the batch's accuracy:
    ``(loss, {"loss", "acc"})``."""
    logits = forward(cfg, params, images)
    labels = torch.as_tensor(labels, device=logits.device).long()
    logp = torch.log_softmax(logits, dim=-1)
    loss = -torch.take_along_dim(logp, labels[:, None], dim=-1).mean()
    acc = (logits.argmax(dim=-1) == labels).float().mean()
    return loss, {"loss": loss, "acc": acc}


def value_and_grad(cfg: XceptionConfig, params: Mapping, images, labels):
    """((loss, metrics), grads) of ``loss_fn``, as ``jax.value_and_grad(...,
    has_aux=True)`` gives them; ``params`` is not changed."""
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, p, images, labels)
        grads = torch.autograd.grad(loss, list(p.values()))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()}), dict(zip(p, grads))
