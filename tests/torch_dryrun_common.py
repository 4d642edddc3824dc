"""Shared by ``test_torch_dryrun.py``, ``test_torch_dryrun_jamba.py`` and
``test_torch_dryrun_xlstm.py``: one SMOKE step's FLOPs in both packages,
and the closed-form reckoning of where the two programs differ in
structure.

The JAX step is lowered with ``ctx=None`` on one CPU device and compiled;
``HloCost`` counts its dots in the optimised HLO. The port's step runs once
on the CPU's plain path under ``launch/cost.CostCounter`` and once more on
the meta device over the dry run's stand-ins (``launch/steps.lower_*``).
The differences, each reckoned exactly at these shapes:

  * flash (train): the port's ``FlashFn`` backward recomputes the whole
    plain forward, the probabilities' product with V included
    (2 * B * H * S^2 * hd a causal self-attention layer on the flash
    path); XLA drops that product from the checkpointed backward, since
    no gradient reads it.
  * Mamba (train): the gradient of the readout ``einsum("blds,bls->bld",
    h, C)`` with respect to h is an outer product; torch runs it as a
    batched product with a contraction of length 1 (2 * B * S * dI * dS a
    Mamba layer), XLA as an elementwise multiply, not a dot.
  * mLSTM: with a = 2 L^2 DH, b = 2 L DH^2 and c = 2 L DH per head and
    chunk, nc = S / L chunks and BH = B * NH heads, the JAX scan counts
    per chunk 2a + 2b + 2c forward (q k^T, s v, q C, q n, the carry's
    (w k)^T v and n's w k) and 4a + 4b + 3c backward, every chunk alike.
    The port's plain version counts 2a + 2b + c forward (its n update is
    a sum, not a product); its Function's backward recomputes that forward
    and takes the plain autograd's gradients: 4a for q k^T and s v, b for
    q C's dq plus b for dC0 past the first chunk (the first carry is a
    constant), c for q n's dq (a contraction of length 1) plus c for dn0
    past the first chunk, and 2b for the carry update's gradients but in
    the last chunk (its C reaches no loss). A layer differs by
    BH * (2a nc + (2 nc - 3) b - (nc + 1) c) in training and by
    -BH * c * nc in a prefill (JAX's product for n).
  * sLSTM (train): the recurrence's first step multiplies the zero initial
    h, a constant, so the port takes no gradient through it: a layer
    differs by -2 * B * NH * DH * 4 DH (XLA's scan takes every step's).

Nothing else differs: the MoE routing, the VLM and encoder-decoder paths
and every decode and (but xLSTM's) prefill count alike.
"""
import numpy as np
import torch

from repro.configs.registry import get_config as j_get_config
from repro.launch import steps as j_steps
from repro.launch.hlo_analysis import HloCost
from repro.models import get_model as j_get_model
from repro.models.api import ShapeSpec as JShapeSpec
from repro.train.optimizer import OptConfig as JOptConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import cost, steps
from repro_torch.models import get_model
from repro_torch.models.api import ShapeSpec
from repro_torch.train.optimizer import OptConfig, init_opt_state

KINDS = ("train", "prefill", "decode")
B, S = 2, 16           # the SMOKE step's batch and sequence (S covers two attention and mLSTM chunks)


def jax_flops(arch: str, kind: str) -> float:
    """HloCost's FLOPs of the JAX package's step, compiled on one CPU device."""
    model = j_get_model(j_get_config(arch, smoke=True))
    spec = JShapeSpec(kind, kind, S, B)
    if kind == "train":
        low = j_steps.lower_train(model, None, spec, JOptConfig())
    elif kind == "prefill":
        low = j_steps.lower_prefill(model, None, spec)
    else:
        low = j_steps.lower_decode(model, None, spec)
    return HloCost(low.compile().as_text(), 1).cost()["flops"]


def lowered(arch: str, kind: str):
    """The dry run's meta stand-ins of the SMOKE step."""
    model = get_model(get_config(arch, smoke=True))
    spec = ShapeSpec(kind, kind, S, B)
    if kind == "train":
        return steps.lower_train(model, spec, OptConfig())
    if kind == "prefill":
        return steps.lower_prefill(model, spec)
    return steps.lower_decode(model, spec)


def cpu_args(arch: str, kind: str, seed: int = 0):
    """The SMOKE step's arguments on the CPU: seeded parameters, zero
    optimizer states, a zero cache, and inputs drawn with numpy."""
    cfg = get_config(arch, smoke=True)
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    ids = lambda shape: torch.from_numpy(rng.integers(0, cfg.vocab_size, shape).astype(np.int32))  # noqa: E731
    specs = model.input_specs(ShapeSpec(kind, kind, S, B))
    batch = {}
    for name, t in specs.items():
        if name == "positions":
            batch[name] = torch.arange(S, dtype=torch.int32).expand(t.shape).contiguous()
        elif t.is_floating_point():
            batch[name] = torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32)).to(t.dtype)
        else:
            batch[name] = ids(tuple(t.shape))
    if kind == "train":
        return steps.make_train_step(model, OptConfig()), (params, init_opt_state(params, OptConfig()), batch)
    if kind == "prefill":
        return steps.make_prefill_step(model, cap=S), (params, batch)
    batch["cache_index"] = S - 1
    return steps.make_decode_step(model), (params, model.init_cache(B, S, "cpu"), batch)


def port_counts(arch: str, kind: str):
    """(the CPU run's count, the meta trace's count) of the SMOKE step."""
    step, args = cpu_args(arch, kind)
    _, cpu = cost.step_cost(lambda: step(*args), args)
    low = lowered(arch, kind)
    _, meta = cost.step_cost(low, low.args, low.donated)
    return cpu, meta


def structural_delta(arch: str, kind: str) -> int:
    """The port's FLOPs less JAX's, where the programs differ in structure
    (the module's docstring)."""
    cfg = get_config(arch, smoke=True)
    n_sb = cfg.n_superblocks
    layers = {k: sum(x == k for x in cfg.block_pattern) * n_sb for k in ("attn", "mamba", "mlstm", "slstm")}
    delta = 0
    if kind == "train" and cfg.inputs == "tokens":
        # causal self-attention on the flash path (the VLM's positions keep the plain path)
        delta += layers["attn"] * 2 * B * cfg.n_heads * S * S * cfg.hd
    if kind == "train" and cfg.mamba is not None:
        dI, dS = cfg.mamba.expand * cfg.d_model, cfg.mamba.d_state
        delta += layers["mamba"] * 2 * B * S * dI * dS
    if cfg.xlstm is not None:
        NH = cfg.n_heads
        DH = int(cfg.xlstm.proj_factor * cfg.d_model) // NH
        L = min(cfg.xlstm.chunk, S)
        nc = S // L
        a, b, c = 2 * L * L * DH, 2 * L * DH * DH, 2 * L * DH
        if kind == "train":
            delta += layers["mlstm"] * B * NH * (2 * a * nc + (2 * nc - 3) * b - (nc + 1) * c)
            DHs = cfg.d_model // NH
            delta -= layers["slstm"] * 2 * B * NH * DHs * 4 * DHs
        elif kind == "prefill":
            delta -= layers["mlstm"] * B * NH * c * nc
    return delta


def check_cell(arch: str, kind: str) -> None:
    """The meta trace counts what the CPU run counts, exactly; the CPU's
    FLOPs less the reckoned structural difference are within 1 % of
    HloCost's for the JAX step."""
    cpu, meta = port_counts(arch, kind)
    assert (meta["flops"], meta["mem_bytes"]) == (cpu["flops"], cpu["mem_bytes"]), (arch, kind, cpu, meta)
    assert meta["argument_bytes"] == cpu["argument_bytes"]
    want = jax_flops(arch, kind)
    got = cpu["flops"] - structural_delta(arch, kind)
    assert abs(got - want) <= 0.01 * want, (arch, kind, cpu["flops"], structural_delta(arch, kind), want)
