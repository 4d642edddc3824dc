"""Shared model substrate: config, parameter definitions, norms, embeddings.

The torch twin of ``repro/models/common.py`` for the families ported so far:
the attention-only decoder and xLSTM.
Parameters are nested dicts of tensors; ``ParamDef`` trees give shapes and
init rules from one source of truth, as in the JAX package.
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
class XLSTMCfg:
    chunk: int = 64             # mLSTM chunk length of the chunkwise prefill
    proj_factor: float = 2.0    # mLSTM up-projection factor
    conv: int = 4               # causal conv width ahead of q and k


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | ssm (the families ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    block_pattern: tuple = ("attn",)  # mixer types per superblock
    qkv_bias: bool = False
    pos: str = "rope"
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"
    act: str = "silu"
    gated_mlp: bool = True
    tie_embeddings: bool = False
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    attn_chunk: int = 1024      # query-chunk size for chunked causal attention
    kv_quant: bool = False      # int8 KV cache (values + per-(token, head) bf16 scales)
    kv_cache_dtype: Any = None  # None -> compute_dtype
    logit_softcap: float = 0.0
    xlstm: Optional[XLSTMCfg] = None

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
# Parameter definitions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamDef:
    shape: tuple
    init: str = "normal"  # normal | zeros | ones
    scale: float = 0.0    # 0 -> 1/sqrt(fan_in)

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


def init_param(gen: torch.Generator, d: ParamDef, dtype, device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    scale = d.scale if d.scale else 1.0 / math.sqrt(max(1, d.fan_in()))
    x = torch.randn(d.shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def init_tree(gen: torch.Generator, defs, dtype, device) -> Any:
    """defs: nested dict of ParamDef -> same-structure dict of tensors, drawn
    from ``gen`` in the dicts' insertion order."""
    return map_defs(lambda d: init_param(gen, d, dtype, device), defs)


def stack_defs(defs: Any, n: int) -> Any:
    """Prepend a superblock-stacking dim to every ParamDef in a tree."""
    return map_defs(lambda d: ParamDef((n,) + d.shape, d.init, d.scale), defs)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


def norm_defs(cfg: ModelConfig, d: int = 0) -> dict:
    return {"w": ParamDef((d or cfg.d_model,), "ones")}


def apply_norm(cfg: ModelConfig, p: Mapping, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm={cfg.norm!r} is not ported yet")
    from repro_torch.kernels.rmsnorm import ops as rms_ops

    return rms_ops.rmsnorm(x, p["w"])


def activation(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "gelu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_defs(cfg: ModelConfig) -> dict:
    d = {"embedding": ParamDef((cfg.vocab_size, cfg.d_model), scale=1.0)}
    if not cfg.tie_embeddings:
        d["unembed"] = ParamDef((cfg.d_model, cfg.vocab_size))
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
