"""int8 quantization: weight-only int8 for serving and the int8 KV cache (the
torch twin of ``repro/models/quant.py``).

Weights: a quantized weight is a dict {"q": int8 W, "s": bf16 scales}, the
scale tensor W's shape with the contracting axis (ndim - 2: every product
here is ``x @ W``) reduced to 1, one absmax scale per output channel.
``qeinsum`` computes the product with f32 output and applies the scales
to it. On the card the plain path converts the int8 weight to bf16 (exact
for |q| <= 127) and multiplies with cuBLAS (``torch.mm(..., out_dtype=
torch.float32)``, ``torch.bmm`` for the experts' 3-D weights; f32
accumulation and output), so it reads 1 B a weight,
writes 2 B and reads them back: more weight traffic than a bf16 tree, not
less; a fused W8A16 product would remove the copy. The tree itself halves.
On the CPU the product is f32 throughout.

KV cache: one scale per (token, head), the head dim the reduced axis.
Shared by the dense int8 cache (models/attention.py) and the paged pool's
plain versions (kernels/paged_attention/ref.py), so every storage path
quantizes bit-identically. The write kernel of ``csrc/paged_attention.cu``
does the same arithmetic.

Both quantizers compute the int8 values from the f32 scale with IEEE
division and round-half-to-even (``torch.round``); only then is the scale
stored as bf16. They divide by a tensor on the input's device: on CUDA,
torch divides by a Python scalar as a multiply by its reciprocal, which can
be 1 ulp off x / 127.
"""
from __future__ import annotations

import math
from typing import Any, Mapping, Union

import torch

from repro_torch.models.common import BLOCK, ParamDef, draw_normal, init_param, init_scale, is_def

QuantW = Mapping  # {"q": int8, "s": bf16}

# leaf names eligible for weight-only quantization (attention / MLP / unembed;
# the embedding gather and 1-D params stay floating point)
QUANT_LEAVES = {"wq", "wk", "wv", "wo", "w1", "w2", "w3", "unembed"}


class WeightsInt8Error(ValueError):
    """Weight-only int8 asked of a model whose mixers cannot take it: the
    xLSTM mixers read ``wq``/``wk``/``wv``, ``QUANT_LEAVES`` keys, with a
    plain product, which a quantized dict breaks (in the JAX package alike)."""


# mixers that read a QUANT_LEAVES key outside ``qeinsum`` (models/xlstm.py)
PLAIN_READ_MIXERS = ("mlstm", "slstm")


def check_int8_family(cfg) -> None:
    """Raise ``WeightsInt8Error`` if a mixer of ``cfg`` reads a
    ``QUANT_LEAVES`` key with a plain product (the xLSTM mixers). Every
    other family quantizes as the JAX package's ``quantize_params`` does:
    attention, cross-attention, dense and expert FFNs and the unembed go
    through ``qeinsum``; the Mamba mixer's projections (``in_proj``,
    ``x_proj``, ``dt_proj``, ``out_proj``) are not ``QUANT_LEAVES`` keys and
    stay floating point."""
    plain = sorted({kind for kind in cfg.block_pattern if kind in PLAIN_READ_MIXERS})
    if plain:
        raise WeightsInt8Error(
            f"{cfg.name}: the {plain} mixers read wq/wk/wv with a plain product, which a quantized "
            f"weight breaks (in the JAX package alike); weight-only int8 serves every other mixer")


def quantize_weight(w: torch.Tensor) -> dict:
    """Per output channel absmax int8 over axis ndim - 2: int8 values and
    bf16 scales with that axis kept at 1."""
    wf = w.float()
    amax = wf.abs().amax(dim=w.ndim - 2, keepdim=True)
    scale = (amax / amax.new_tensor(127.0)).clamp_min(1e-12)
    q = torch.round(wf / scale).clamp_(-127, 127).to(torch.int8)
    return {"q": q, "s": scale.to(torch.bfloat16)}


def is_quant(w: Any) -> bool:
    return isinstance(w, Mapping) and "q" in w and "s" in w


def _quantize_into(w: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> None:
    """``quantize_weight(w)`` written into ``q`` and ``s``, one 2-D slice
    and one block of output channels at a time (each channel's scale reads
    only its own column, so the bits are the whole call's)."""
    if w.ndim > 2:
        for i in range(w.shape[0]):
            _quantize_into(w[i], q[i], s[i])
        return
    step = max(1, BLOCK // max(1, w.shape[0]))
    for c in range(0, w.shape[1], step):
        part = quantize_weight(w[:, c:c + step])
        q[:, c:c + step] = part["q"]
        s[:, c:c + step] = part["s"]


def scale_shape(shape) -> tuple:
    """The scales' shape of a quantized weight of ``shape``: axis ndim - 2 at 1."""
    return (*shape[:-2], 1, shape[-1])


def _empty_quant(shape, device) -> dict:
    return {"q": torch.empty(shape, dtype=torch.int8, device=device),
            "s": torch.empty(scale_shape(shape), dtype=torch.bfloat16, device=device)}


def quantize_params(params: Any) -> Any:
    """Replace eligible 2-D and 3-D weight leaves with quantized dicts (by
    key); a tree already quantized comes back as it is."""

    def walk(node):
        if not isinstance(node, Mapping):
            return node
        out = {}
        for k, v in node.items():
            if (k in QUANT_LEAVES and isinstance(v, torch.Tensor) and v.ndim >= 2
                    and v.dtype in (torch.bfloat16, torch.float32, torch.float16)):
                out[k] = _empty_quant(v.shape, v.device)
                _quantize_into(v, out[k]["q"], out[k]["s"])
            else:
                out[k] = walk(v)
        return out

    return walk(params)


def qeinsum(x: torch.Tensor, w: Union[torch.Tensor, QuantW]) -> torch.Tensor:
    """``x @ w``, where w may be a quantized dict; the output dtype follows
    x. A 2-D w (d, f) takes x (..., d), every product the JAX package
    routes through ``qeinsum("...d,df->...f")``; a 3-D w (E, d, f) takes x
    (E, C, d), the expert products ``"ecd,edf->ecf"`` and ``"ecf,efd->ecd"``.
    Quantized: the product with f32 output (on the card the int8 weight
    converted to bf16 and ``torch.mm`` / ``torch.bmm`` with
    ``out_dtype=torch.float32``; on the CPU f32 throughout), times the f32
    scales, rounded once into x's dtype, as JAX's
    ``preferred_element_type=jnp.float32`` path computes it."""
    if isinstance(w, torch.Tensor):
        return x @ w.to(x.dtype)
    q, s = w["q"], w["s"]
    if q.ndim not in (2, 3):
        raise ValueError(f"qeinsum: a quantized weight of {q.ndim} dimensions {tuple(q.shape)}; "
                         f"it takes (d, f) or (E, d, f)")
    if x.device.type == "cpu" or x.dtype == torch.float32:
        y = x.float() @ q.float()
    elif q.ndim == 2:
        y = torch.mm(x.reshape(-1, x.shape[-1]), q.to(x.dtype),
                     out_dtype=torch.float32).reshape(*x.shape[:-1], q.shape[-1])
    else:
        y = torch.bmm(x, q.to(x.dtype), out_dtype=torch.float32)
    # one device operation: the bf16 scales promote to f32 exactly inside the
    # multiply, and the f32 product rounds once, into x's dtype. A 2-D
    # weight's scales (1, f) lose their unit axis; a 3-D one's (E, 1, f)
    # broadcast over the C rows as they are (JAX squeezes only 2-D scales)
    s = s.squeeze(-2) if q.ndim == 2 else s
    return torch.mul(y, s, out=torch.empty(y.shape, dtype=x.dtype, device=y.device))


def quantized_shape_tree(shapes: Any) -> Any:
    """The tree ``quantize_params`` would give for a tree of tensors of the
    parameters' shapes (the dry run's meta stand-ins), without computing
    it: each eligible leaf becomes empty int8 values and bf16 scales on its
    device."""
    def walk(node):
        if not isinstance(node, Mapping):
            return node
        return {k: _empty_quant(v.shape, v.device)
                if k in QUANT_LEAVES and isinstance(v, torch.Tensor) and v.ndim >= 2 else walk(v)
                for k, v in node.items()}

    return walk(shapes)


def quantized_sharding_tree(shardings: Any, shapes: Any) -> Any:
    """The sharding tree matching ``quantize_params`` of a tree of
    ``shapes`` (tensors or anything with a ``shape``) laid out by
    ``shardings`` (``sharding.axes.NamedSharding`` leaves or None): an
    eligible leaf's q keeps the weight's spec and its scale drops the
    sharding of its contracting axis, which is 1 long."""
    from repro_torch.sharding.axes import NamedSharding, P

    def walk(sh_node, shp_node):
        if not isinstance(shp_node, Mapping):
            return sh_node
        out = {}
        for k, v in shp_node.items():
            sh = sh_node[k] if isinstance(sh_node, Mapping) else sh_node
            if k in QUANT_LEAVES and hasattr(v, "shape") and len(v.shape) >= 2:
                if sh is None:
                    out[k] = {"q": None, "s": None}
                else:
                    spec = list(sh.spec) + [None] * (len(v.shape) - len(sh.spec))
                    spec[-2] = None
                    out[k] = {"q": sh, "s": NamedSharding(sh.mesh, P(*spec))}
            else:
                out[k] = walk(sh, v)
        return out

    return walk(shardings, shapes)


def init_quantized(gen: torch.Generator, defs: Any, dtype, device) -> Any:
    """The tree ``quantize_params(init_tree(gen, defs, dtype, device))``
    would give, without the floating-point tree: every leaf is drawn in f32
    in the defs' order and in blocks along its first axis (a superblock's
    slice of a stacked leaf at a time), scaled, cast to ``dtype``, and, at
    a ``QUANT_LEAVES`` key, quantized into preallocated int8 and scale
    leaves. The peak is the quantized tree plus one 2-D slice in ``dtype``
    (the unembed whole) and a few blocks of f32 scratch. On the CPU the
    draws are the whole-leaf draws' when every block holds a multiple of 16
    values (torch's CPU normal fill); on the card they are their own."""

    def leaf(key: str, d: ParamDef):
        if d.init != "normal":
            return init_param(gen, d, dtype, device)
        if key not in QUANT_LEAVES or len(d.shape) < 2:
            return draw_normal(gen, torch.empty(d.shape, dtype=dtype, device=device), init_scale(d))
        qw = _empty_quant(d.shape, device)
        n = math.prod(d.shape[:-2])
        qs, ss = qw["q"].reshape(n, *d.shape[-2:]), qw["s"].reshape(n, 1, d.shape[-1])
        w = torch.empty(d.shape[-2:], dtype=dtype, device=device)
        for i in range(n):
            _quantize_into(draw_normal(gen, w, init_scale(d)), qs[i], ss[i])
        return qw

    def walk(node, key: str = ""):
        if is_def(node):
            return leaf(key, node)
        return {k: walk(v, k) for k, v in node.items()}

    return walk(defs)


# ---------------------------------------------------------------------------
# KV-cache quantization
# ---------------------------------------------------------------------------


def quantize_kv(x: torch.Tensor):
    """Per (token, head) absmax int8. x: (..., hd). Returns (int8 values,
    bf16 scales with the trailing axis reduced to 1)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = (amax / amax.new_tensor(127.0)).clamp_min(1e-8)
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale.float()).to(dtype)
