"""AdamW from scratch, with quantized optimizer states (the torch twin of
``repro/train/optimizer.py``).

State dtypes:
  * float32  — default.
  * bfloat16 — halves the states' memory.
  * int8     — blockwise-absmax quantized m and sqrt(v) (8-bit-Adam style),
               shape-preserving: q keeps the parameter's shape, the scales
               are per block of the last dim.

Trees are nested dicts of tensors; the update walks the leaves in the JAX
package's flatten order (``train/tree.py``), so the global norm sums them in
its order. Every step is f32 arithmetic, cast back to each parameter's
dtype. ``opt_state_shapes`` gives the dry run's meta stand-ins.

Leaves may be DTensors (a sharded train step, ``launch/steps.py``): each
gradient and state in its parameter's placements, as
``launch/steps.opt_shardings`` lays the states out. The global norm sums
every shard once; each leaf's update runs on the rank's block. An int8
state's q is the parameter's block and its scales (``..., d // block``)
keep the last dim whole, so a block of the last dim that spans ranks is
quantized from the gathered values.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Tuple

import torch

from repro_torch.sharding.axes import full_value, is_dtensor, like
from repro_torch.train.tree import leaves, map_tree, unflatten

QBLOCK = 128


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"   # float32 | bfloat16 | int8


# ---------------------------------------------------------------------------
# Blockwise int8 quantization of state tensors
# ---------------------------------------------------------------------------


def _block_for(d: int) -> int:
    """Largest block <= QBLOCK dividing the last dim (0 => unquantizable)."""
    b = QBLOCK
    while b > 4 and d % b != 0:
        b //= 2
    return b if d % b == 0 and b > 4 else 0


def quantize_blockwise(x: torch.Tensor) -> dict:
    """Shape-preserving int8: q keeps x's shape; the f32 scales are the
    absmax of each block of the last dim over 127, floored at 1e-12; q is
    x / scale rounded half to even and clipped to +-127. A leaf whose last
    dim has no block (``_block_for`` 0) keeps its f32 value as the "scale"
    (x[..., None]) and zeros as q."""
    d = x.shape[-1] if x.ndim else 1
    b = _block_for(d)
    xf = x.float()
    if b == 0:
        return {"q": torch.zeros(x.shape, dtype=torch.int8, device=x.device),
                "scale": xf[..., None] if x.ndim else xf}
    blocks = xf.reshape(*x.shape[:-1], d // b, b)
    scale = torch.clamp(blocks.abs().amax(dim=-1) / 127.0, min=1e-12)      # (..., d // b)
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127).to(torch.int8)
    return {"q": q.reshape(x.shape), "scale": scale}


def dequantize_blockwise(qs: Mapping, shape, dtype=torch.float32) -> torch.Tensor:
    shape = tuple(shape)
    d = shape[-1] if shape else 1
    b = _block_for(d)
    if b == 0:
        return qs["scale"].reshape(shape).to(dtype)
    q = qs["q"].reshape(*shape[:-1], d // b, b).float()
    return (q * qs["scale"][..., None]).reshape(shape).to(dtype)


# ---------------------------------------------------------------------------
# State representation
# ---------------------------------------------------------------------------


def _encode_state(x: torch.Tensor, mode: str, signed: bool):
    if mode == "float32":
        return x.float()
    if mode == "bfloat16":
        return x.to(torch.bfloat16)
    if mode == "int8":
        # v is non-negative: quantize sqrt(v) to compress its dynamic range
        return quantize_blockwise(x if signed else torch.sqrt(x))
    raise ValueError(mode)


def _decode_state(s: Any, shape, mode: str, signed: bool) -> torch.Tensor:
    if mode in ("float32", "bfloat16"):
        return s.float()
    x = dequantize_blockwise(s, shape)
    return x if signed else x * x


def init_opt_state(params: Any, ocfg: OptConfig) -> dict:
    """Zero m and v in the state dtype, and the step count (int32 scalar),
    on the parameters' device. f32 and bf16 states of DTensor parameters
    are DTensors of the same layouts (each rank's zeros); int8 states are
    made whole (``launch/steps.distribute_tree`` lays them out)."""
    def zero(p, signed):
        if is_dtensor(p) and ocfg.state_dtype != "int8":
            return _encode_state(torch.zeros_like(p, dtype=torch.float32), ocfg.state_dtype, signed)
        return _encode_state(torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                             ocfg.state_dtype, signed)

    step_dev = leaves(params)[0].device
    return {
        "m": map_tree(lambda p: zero(p, True), params),
        "v": map_tree(lambda p: zero(p, False), params),
        "step": torch.zeros((), dtype=torch.int32, device=step_dev),
    }


def opt_state_shapes(param_shapes: Any, ocfg: OptConfig, device="meta") -> dict:
    """Empty tensors matching ``init_opt_state`` leaf for leaf (shapes and
    dtypes), on the meta device by default: the dry run's stand-ins, which
    allocate nothing. ``param_shapes`` is any tree of tensors of the
    parameters' shapes."""
    def enc(p):
        if ocfg.state_dtype in ("float32", "bfloat16"):
            return torch.empty(p.shape, dtype=getattr(torch, ocfg.state_dtype), device=device)
        d = p.shape[-1] if p.ndim else 1
        b = _block_for(d)
        sshape = (tuple(p.shape) + (1,) if p.ndim else ()) if b == 0 else tuple(p.shape[:-1]) + (d // b,)
        return {"q": torch.empty(p.shape, dtype=torch.int8, device=device),
                "scale": torch.empty(sshape, dtype=torch.float32, device=device)}

    return {"m": map_tree(enc, param_shapes), "v": map_tree(enc, param_shapes),
            "step": torch.empty((), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# Update
# ---------------------------------------------------------------------------


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, leaves in the
    JAX package's order. DTensor leaves (sharded or replicated, one mesh):
    each rank sums its blocks' squares, a replicated block's over its
    copies, and one all-reduce a mesh axis adds the ranks' sums."""
    flat = leaves(tree)
    if not any(is_dtensor(g) for g in flat):
        sq = [torch.sum(torch.square(g.float())) for g in flat]
        return torch.sqrt(torch.sum(torch.stack(sq)))
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    mesh = flat[0].device_mesh
    sq = []
    for g in flat:
        copies = math.prod(mesh.size(i) for i, a in enumerate(g.placements) if not isinstance(a, Shard))
        sq.append(torch.sum(torch.square(g.to_local().float())) / copies)
    total = torch.sum(torch.stack(sq))
    for i in range(mesh.ndim):
        dist.all_reduce(total, group=mesh.get_group(i))
    return torch.sqrt(total)


def _last_dim_shards(p):
    """(the mesh dims that split the DTensor ``p``'s last dim, outermost
    first; this rank's offset along it)."""
    from torch.distributed.tensor import Shard

    mesh, last = p.device_mesh, p.ndim - 1
    dims = [i for i, a in enumerate(p.placements) if isinstance(a, Shard) and a.dim == last]
    coord, n, i = mesh.get_coordinate(), 1, 0
    for d in dims:
        n, i = n * mesh.size(d), i * mesh.size(d) + coord[d]
    return dims, i * (p.shape[-1] // n)


def _decode_block(s: Any, p, mode: str, signed: bool) -> torch.Tensor:
    """The f32 value of the rank's block of the state ``s`` of the DTensor
    parameter ``p``."""
    if mode in ("float32", "bfloat16"):
        return s.to_local().float()
    q, scale = s["q"].to_local(), s["scale"].to_local()
    d = p.shape[-1] if p.ndim else 1
    b = _block_for(d)
    if b == 0:
        x = scale.reshape(q.shape).float()
    else:
        _, off = _last_dim_shards(p)
        x = q.float() * scale.repeat_interleave(b, dim=-1)[..., off:off + q.shape[-1]]
    return x if signed else x * x


def _encode_block(x: torch.Tensor, p, old: Any, mode: str, signed: bool):
    """The state of f32 block ``x`` of the DTensor parameter ``p``, as
    DTensors laid out as the old state ``old``."""
    from torch.distributed.tensor import Replicate

    if mode in ("float32", "bfloat16"):
        return like(_encode_state(x, mode, signed), old)
    dims, off = _last_dim_shards(p)
    if dims and _block_for(p.shape[-1]):
        # a block may span ranks: quantize the gathered last dim, keep this rank's q
        pl = list(p.placements)
        for i in dims:
            pl[i] = Replicate()
        full = like(x, p).redistribute(p.device_mesh, pl).to_local()
        qs = _encode_state(full, mode, signed)
        qs = {"q": qs["q"][..., off:off + x.shape[-1]].contiguous(), "scale": qs["scale"]}
    else:
        qs = _encode_state(x, mode, signed)
    return {"q": like(qs["q"], old["q"]), "scale": like(qs["scale"], old["scale"])}


def _state_leaves(tree: Any, n: int) -> list:
    """The per-parameter states of an m or v tree, in ``leaves`` order of
    the parameter tree: an int8 state is one {"q", "scale"} dict."""
    out = []

    def walk(node):
        if isinstance(node, dict) and set(node) != {"q", "scale"}:
            for k in sorted(node):
                walk(node[k])
        else:
            out.append(node)

    walk(tree)
    if len(out) != n:
        raise ValueError(f"optimizer state has {len(out)} leaves for {n} parameters")
    return out


@torch.no_grad()
def adamw_update(
    grads: Any,
    opt_state: Mapping,
    params: Any,
    ocfg: OptConfig,
    lr: Optional[torch.Tensor] = None,
) -> Tuple[Any, dict, dict]:
    """Returns (new_params, new_opt_state, stats): clip by the global norm,
    bias-corrected moments, the update with decoupled weight decay, all in
    f32, each parameter cast back to its dtype; stats ``grad_norm`` and
    ``lr``. No tensor of the inputs is written."""
    step_in = opt_state["step"]
    step = full_value(step_in) + 1
    lr = ocfg.lr if lr is None else full_value(lr)
    gnorm = global_norm(grads)
    scale = torch.clamp(ocfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0) if ocfg.clip_norm else 1.0

    bc1 = 1.0 - ocfg.b1 ** step.float()
    bc2 = 1.0 - ocfg.b2 ** step.float()

    flat_p = leaves(params)
    flat_g = leaves(grads)
    flat_m = _state_leaves(opt_state["m"], len(flat_p))
    flat_v = _state_leaves(opt_state["v"], len(flat_p))

    new_p, new_m, new_v = [], [], []
    for g, p, m_s, v_s in zip(flat_g, flat_p, flat_m, flat_v):
        if is_dtensor(p):
            new = _update_block(g, p, m_s, v_s, ocfg, lr, scale, bc1, bc2)
            for out, t in zip((new_p, new_m, new_v), new):
                out.append(t)
            continue
        g = g.float() * scale
        m = _decode_state(m_s, p.shape, ocfg.state_dtype, True)
        v = _decode_state(v_s, p.shape, ocfg.state_dtype, False)
        m = ocfg.b1 * m + (1.0 - ocfg.b1) * g
        v = ocfg.b2 * v + (1.0 - ocfg.b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        upd = mhat / (torch.sqrt(vhat) + ocfg.eps)
        pf = p.float()
        pf = pf - lr * (upd + ocfg.weight_decay * pf)
        new_p.append(pf.to(p.dtype))
        new_m.append(_encode_state(m, ocfg.state_dtype, True))
        new_v.append(_encode_state(v, ocfg.state_dtype, False))

    lr_t = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)
    if is_dtensor(step_in):
        step = like(step, step_in)
    return (
        unflatten(params, new_p),
        {"m": unflatten(params, new_m), "v": unflatten(params, new_v), "step": step},
        {"grad_norm": gnorm, "lr": lr_t},
    )


def _update_block(g, p, m_s, v_s, ocfg: OptConfig, lr, scale, bc1, bc2):
    """``adamw_update``'s arithmetic on the rank's block of the DTensor
    parameter ``p``, whose gradient ``g`` has its placements. Returns the
    new parameter and states as DTensors of the old ones' layouts."""
    if tuple(g.placements) != tuple(p.placements):
        raise ValueError(f"a gradient in {g.placements} for a parameter in {p.placements}")
    gl = g.to_local().float() * scale
    m = _decode_block(m_s, p, ocfg.state_dtype, True)
    v = _decode_block(v_s, p, ocfg.state_dtype, False)
    m = ocfg.b1 * m + (1.0 - ocfg.b1) * gl
    v = ocfg.b2 * v + (1.0 - ocfg.b2) * gl * gl
    upd = (m / bc1) / (torch.sqrt(v / bc2) + ocfg.eps)
    pl = p.to_local()
    pf = pl.float()
    pf = pf - lr * (upd + ocfg.weight_decay * pf)
    new_p = like(pf.to(pl.dtype), p)
    return (new_p, _encode_block(m, p, m_s, ocfg.state_dtype, True),
            _encode_block(v, p, v_s, ocfg.state_dtype, False))


def state_bytes(opt_state: Mapping) -> int:
    """Bytes of every tensor of an optimizer state."""
    return sum(t.numel() * t.element_size() for t in leaves(opt_state))
