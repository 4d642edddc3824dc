"""Gradients through the port's kernels.

The TPU kernels have no reverse mode (``jax.grad`` through the Pallas
rmsnorm and flash kernels fails), so the reference trains on its plain jnp
path and owes no backward kernel. On the card the port's forward still
launches the hand-written kernel; a ``torch.autograd.Function`` around it
takes its backward from the kernel's plain version (``ref.py``), recomputed
from the saved inputs under ``torch.enable_grad()`` (``plain_grads``). The
Function is taken only when grad is on and an input requires it, so a
serving step launches exactly as before.

A kernel with no Function (the decode kernels and the page-pool writes)
raises where autograd would need a gradient through it (``forward_only``),
rather than return an output that silently carries none.
"""
from __future__ import annotations

import torch


def wants_grad(*tensors: torch.Tensor) -> bool:
    """True where autograd would record a kernel's call: grad mode is on and
    an input requires grad."""
    for t in tensors:
        if t.requires_grad:
            return torch.is_grad_enabled()
    return False


def forward_only(name: str, *tensors: torch.Tensor) -> None:
    """Raise if a gradient would have to flow through a forward-only kernel."""
    if wants_grad(*tensors):
        raise RuntimeError(f"{name}: forward-only kernel (no backward); call it under "
                           f"torch.no_grad() or on tensors that do not require grad")


def plain_grads(fn, inputs, needs, grad_outputs, **kw) -> tuple:
    """Gradients of ``fn(*inputs, **kw)`` (the plain version) for the inputs
    whose ``needs`` is True, given the gradients of its outputs (None for an
    output that got none); None for the others."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(bool(n)) for t, n in zip(inputs, needs)]
        outs = fn(*xs, **kw)
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grad_outputs) if g is not None and o.requires_grad]
        wrt = [x for x, n in zip(xs, needs) if n]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                       allow_unused=True) if pairs else [None] * len(wrt))
    return tuple(next(got) if n else None for n in needs)
