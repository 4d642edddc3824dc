"""Shared model substrate: config, parameter definitions, norms, embeddings.

The torch twin of ``repro/models/common.py`` for the families ported so far:
the attention-only decoder, its mixture-of-experts FFN, Mamba, xLSTM, the VLM
backbone (token or embedding inputs, M-RoPE) and the whisper encoder-decoder
(layernorm, cross-attention).
Parameters are nested dicts of tensors; ``ParamDef`` trees give shapes,
logical sharding axes and init rules from one source of truth, as in the
JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Mapping, Optional

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    every_k: int = 1            # MoE FFN on layers where (layer_idx % every_k == every_k - 1)
    capacity_factor: float = 1.25
    aux_weight: float = 0.01
    fsdp_experts: bool = False  # shard expert weights over 'data' too; all-gather at use (moe.moe_ffn)


@dataclass(frozen=True)
class MambaCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    chunk: int = 256            # selective-scan chunk length of a prefill
    dt_rank: int = 0            # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMCfg:
    chunk: int = 64             # mLSTM chunk length of the chunkwise prefill
    proj_factor: float = 2.0    # mLSTM up-projection factor
    conv: int = 4               # causal conv width ahead of q and k


@dataclass(frozen=True)
class EncoderCfg:
    """Encoder stack of an encoder-decoder model (whisper). The frontend is a
    stub: callers give precomputed frame embeddings of length ``n_ctx``."""

    n_layers: int
    n_ctx: int
    n_heads: int
    d_ff: int


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    block_pattern: tuple = ("attn",)  # mixer types per superblock
    qkv_bias: bool = False
    pos: str = "rope"           # rope | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: tuple = (16, 24, 24)   # M-RoPE frequency slots of the (t, h, w) streams
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    act: str = "silu"
    gated_mlp: bool = True
    tie_embeddings: bool = False
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    remat: str = "full"         # full | dots | none: what training's backward recomputes (transformer._remat_wrap)
    attn_chunk: int = 1024      # query-chunk size for chunked causal attention
    ce_chunks: int = 8          # sequence chunks of the training cross-entropy (loss.lm_loss)
    kv_quant: bool = False      # int8 KV cache (values + per-(token, head) bf16 scales)
    kv_cache_dtype: Any = None  # None -> compute_dtype
    logit_softcap: float = 0.0
    weights_int8: bool = False  # DecoderLM.init draws weight-only int8 (models/quant.py)
    attn_scores_bf16: bool = False  # the plain attention's scores in bf16 (attention._attend_block); not flash's
    moe_token_gather: bool = False  # sharded MoE under fsdp_experts: gather the tokens, keep experts sharded
    scan_unroll: int = 1        # no effect: the port loops over superblocks in Python, with no scan to unroll
    moe: Optional[MoECfg] = None
    mamba: Optional[MambaCfg] = None
    xlstm: Optional[XLSTMCfg] = None
    encoder: Optional[EncoderCfg] = None
    cross_attn: bool = False    # decoder layers carry cross-attention (encoder-decoder)
    inputs: str = "tokens"      # tokens | embeds (the VLM backbone)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def kv_dtype(self):
        """Storage dtype of non-quantized KV caches and pools."""
        return self.kv_cache_dtype if self.kv_cache_dtype is not None else self.compute_dtype

    @property
    def n_superblocks(self) -> int:
        if self.n_layers % len(self.block_pattern):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"pattern length {len(self.block_pattern)}"
            )
        return self.n_layers // len(self.block_pattern)

    def layer_has_moe(self, pos_in_superblock: int) -> bool:
        if self.moe is None:
            return False
        k = self.moe.every_k
        return pos_in_superblock % k == k - 1

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def resolve_device(device=None) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU:
    ``None`` means ``"cuda"``, and a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
    return dev


# ---------------------------------------------------------------------------
# Parameter definitions: one source of truth for shape, sharding and init
# ---------------------------------------------------------------------------

# Logical axis names of ParamDef dims; sharding.axes.Rules maps them onto a
# mesh's axes.
EMBED = "embed"      # d_model dims of weights -> replicated
TP = "tp"            # tensor-parallel dim (heads, ff, vocab, d_inner, experts) -> 'model'
FSDP = "fsdp"        # fully-sharded dim -> 'data'
STACK = "stack"      # superblock stacking dim -> replicated
NULL = None


@dataclass(frozen=True)
class ParamDef:
    shape: tuple
    axes: tuple           # logical axis per dim (as long as shape)
    init: str = "normal"  # normal | zeros | ones
    scale: float = 0.0    # 0 -> 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.axes) != len(self.shape):
            raise ValueError(f"ParamDef axes {self.axes} do not match shape {self.shape}")

    def fan_in(self) -> int:
        if len(self.shape) == 1:
            return self.shape[0]
        return self.shape[-2]


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def map_defs(fn, defs):
    """Apply ``fn`` to every ParamDef leaf of a nested dict."""
    if is_def(defs):
        return fn(defs)
    return {k: map_defs(fn, v) for k, v in defs.items()}


def init_scale(d: ParamDef) -> float:
    """Standard deviation of a ``normal`` leaf's draw."""
    return d.scale if d.scale else 1.0 / math.sqrt(max(1, d.fan_in()))


# f32 scratch elements a step of a blocked draw (and of the blocked quantizer)
BLOCK = 1 << 26


def draw_normal(gen: torch.Generator, out: torch.Tensor, scale: float) -> torch.Tensor:
    """Fill ``out`` with ``scale`` times standard-normal draws made in f32
    and cast to its dtype. A tensor of more than ``BLOCK`` values is drawn
    in blocks along its leading axes (slices of the first axis, or of the
    second within one slice of the first, and so on), so the f32 scratch
    stays near ``BLOCK`` values whatever the leaf: dbrx-132b's stacked
    expert leaf would otherwise need a 33.8 GB f32 draw. A tensor within
    ``BLOCK`` is one draw."""
    if out.numel() <= BLOCK or out.ndim < 2:
        x = torch.randn(out.shape, generator=gen, dtype=torch.float32, device=out.device)
        return out.copy_(x * scale)
    step = BLOCK // out[0].numel()
    if step == 0:
        for i in range(out.shape[0]):
            draw_normal(gen, out[i], scale)
    else:
        for r in range(0, out.shape[0], step):
            draw_normal(gen, out[r:r + step], scale)
    return out


def init_param(gen: torch.Generator, d: ParamDef, dtype, device) -> torch.Tensor:
    """One leaf: zeros, ones, or normal draws at ``init_scale(d)``. A normal
    leaf within ``BLOCK`` values is one f32 draw (every leaf at smoke size,
    so the CPU's draws are those of the whole-leaf draw); a larger one is
    drawn in blocks (``draw_normal``), so its values on the card are its own
    draw and the peak stays near the tree plus one block."""
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    return draw_normal(gen, torch.empty(d.shape, dtype=dtype, device=device), init_scale(d))


def init_tree(gen: torch.Generator, defs, dtype, device) -> Any:
    """defs: nested dict of ParamDef -> same-structure dict of tensors, drawn
    from ``gen`` in the dicts' insertion order."""
    return map_defs(lambda d: init_param(gen, d, dtype, device), defs)


def shape_tree(defs, dtype, device="meta") -> Any:
    """Empty tensors of the defs' shapes in ``dtype``: on the meta device
    (the default) the dry run's stand-ins, which allocate nothing."""
    return map_defs(lambda d: torch.empty(d.shape, dtype=dtype, device=device), defs)


def stack_defs(defs: Any, n: int) -> Any:
    """Prepend a superblock-stacking dim to every ParamDef in a tree."""
    return map_defs(lambda d: ParamDef((n,) + d.shape, (STACK,) + d.axes, d.init, d.scale), defs)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in f32 (biased variance), cast back."""
    return F.layer_norm(x.float(), x.shape[-1:], w.float(), b.float(), eps).to(x.dtype)


def norm_defs(cfg: ModelConfig, d: int = 0) -> dict:
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"w": ParamDef((d,), (NULL,), "ones"), "b": ParamDef((d,), (NULL,), "zeros")}
    return {"w": ParamDef((d,), (NULL,), "ones")}


def apply_norm(cfg: ModelConfig, p: Mapping, x: torch.Tensor) -> torch.Tensor:
    """layernorm in plain torch, as the JAX package runs it in jnp whatever
    ``use_pallas`` says; rmsnorm through its kernel (the plain version on
    the CPU)."""
    if cfg.norm == "layernorm":
        return layernorm(x, p["w"], p["b"])
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.sharding.axes import is_dtensor

    if is_dtensor(x):
        return rmsnorm_sharded(x, p["w"])
    return rms_ops.rmsnorm(x, p["w"])


def rmsnorm_sharded(x, w):
    """rmsnorm of a DTensor x whose last dim is whole: the kernel wrapper on
    each rank's rows (``local_map``), w replicated. w's gradient is partial
    over the mesh axes that split x's rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.sharding.axes import redistribute

    mesh, xp = x.device_mesh, tuple(x.placements)
    if any(isinstance(pl, Shard) and pl.dim == x.ndim - 1 for pl in xp):
        raise ValueError(f"rmsnorm: the normalised dim of a DTensor must be whole, got {xp}")
    rep = (Replicate(),) * mesh.ndim
    w = redistribute(w, rep)
    w_grad = tuple(Partial() if isinstance(pl, Shard) else Replicate() for pl in xp)
    return local_map(rms_ops.rmsnorm, out_placements=list(xp), in_placements=(xp, rep),
                     in_grad_placements=(xp, w_grad), device_mesh=mesh)(x, w)


def activation(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_defs(cfg: ModelConfig) -> dict:
    d = {"embedding": ParamDef((cfg.vocab_size, cfg.d_model), (TP, NULL), scale=1.0)}
    if not cfg.tie_embeddings:
        d["unembed"] = ParamDef((cfg.d_model, cfg.vocab_size), (NULL, TP))
    return d


def embed_tokens(cfg: ModelConfig, p: Mapping, tokens: torch.Tensor) -> torch.Tensor:
    return p["embedding"][tokens].to(cfg.compute_dtype)


def unembed_weight(cfg: ModelConfig, p: Mapping) -> torch.Tensor:
    if cfg.tie_embeddings:
        return p["embedding"].T
    return p["unembed"]


def dtype_name(dtype) -> str:
    """Telemetry name of a torch dtype, matching numpy's (``bfloat16``)."""
    return str(dtype).replace("torch.", "")
