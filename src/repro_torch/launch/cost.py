"""The work of one step, counted as it runs: the port's stand-in for the JAX
package's ``launch/hlo_analysis.py``.

The JAX dry run compiles each step and parses the HLO text XLA prints,
multiplying loop bodies by their trip counts. PyTorch runs a step eagerly
and compiles no whole program, so there is no HLO to read and that module
has no torch analogue. ``CostCounter`` instead watches the step run: it is
a ``TorchDispatchMode``, entered as a context manager around one step, that
sees every ATen operation the step dispatches, on the card, on the CPU or
on the meta device (where nothing is allocated or computed), and counts

  * ``flops``      — 2*M*N*K for every mm, bmm, addmm, baddbmm (and mv,
                     dot) and 2 * out * (C_in / groups * kernel) for every
                     convolution: the products ``HloCost`` counts
                     (``_dot_flops``, ``_conv_flops``);
  * ``mem_bytes``  — the bytes every operation reads and writes, its tensor
                     inputs and outputs: what eager PyTorch moves, with no
                     fusion. Views and allocations count 0;
  * ``peak_bytes`` — the peak of the bytes held by the storages the step
                     creates, each freed when its last tensor is collected,
                     so the activations autograd saves count until the
                     backward releases them.

``step_cost`` adds ``mem_lo_bytes``, the step's arguments read once plus
its new outputs written once, and ``roofline_terms`` turns a count into
seconds at one H100's rates (``core/estimator.py``).

A hand-written kernel is a ctypes call that the dispatch mode cannot see.
Its wrapper is decorated with ``reports(cost_fn)``: under a counter, the
torch operations inside the wrapper (the plain version on the CPU, the
output allocation on the meta device and the card) are not counted, and
``cost_fn``'s FLOPs and bytes are, so the CPU, the meta device and the card
count the same numbers. Their storages still count towards the peak.
Outside a counter the decorator costs one look at torch's dispatch-mode
stack.
"""
from __future__ import annotations

import functools
import weakref
from typing import Any, Callable, Dict, Iterable, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

from repro_torch.core.estimator import HBM_BW, LINK_BW, PEAK_FLOPS

aten = torch.ops.aten

# operations that allocate without writing
_ALLOC = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty, aten.new_empty_strided}


def _tensors(x) -> Iterable[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tree_bytes(tree: Any) -> int:
    """Bytes of every tensor of a nested dict, list or tuple."""
    return sum(nbytes(t) for t in _tensors(tree))


def _mm_flops(func, args, out) -> int:
    """2*M*N*K of a matrix product, from its output's size and the first
    operand's contracting dim."""
    name = func.overloadpacket.__name__
    if name in ("mm", "bmm", "mv", "dot"):
        a = args[0]
    elif name in ("addmm", "baddbmm", "addmv"):
        a = args[1]
    else:
        return 0
    return 2 * max(1, out.numel()) * a.shape[-1]


def _conv_flops(x_shape, w_shape, out_numel: int) -> int:
    """2 * output elements * (input channels a group times the kernel's
    size), for a convolution that is not transposed."""
    k = 1
    for n in w_shape[1:]:
        k *= n
    return 2 * out_numel * k


def _flops(func, args, out) -> int:
    packet = func.overloadpacket
    if packet in (aten.mm, aten.bmm, aten.addmm, aten.baddbmm, aten.mv, aten.addmv, aten.dot):
        return _mm_flops(func, args, out)
    if packet in (aten.convolution, aten._convolution):
        return _conv_flops(args[0].shape, args[1].shape, out.numel())
    if packet is aten.convolution_backward:
        # grad_output, input, weight, ..., output_mask: each input or weight
        # gradient is one product of the forward's size
        grad_out, x, w = args[0], args[1], args[2]
        mask = args[-1]
        return _conv_flops(x.shape, w.shape, grad_out.numel()) * sum(bool(m) for m in mask[:2])
    return 0


def _row_major(t: torch.Tensor) -> bool:
    """The strides of the dims longer than 1 strictly decrease: no dim
    pair of ``t`` can order a pointwise output other than row-major."""
    st = [s for n, s in zip(t.shape, t.stride()) if n > 1]
    return all(a > b for a, b in zip(st, st[1:])) and all(s > 0 for s in st)


def _meta_pointwise(func, args, kwargs):
    """The output of a functional pointwise operation whose tensor operands
    all lie on the meta device in row-major order, without its meta kernel
    (torch runs most of those in Python, a few hundred microseconds each):
    the operands' broadcast shape, contiguous (as the meta kernel lays it
    out when no operand orders its dims otherwise), in the dtype the
    operation gives one-element CPU stand-ins of the operands. None where
    that does not apply, and the meta kernel runs."""
    if kwargs or torch.Tag.pointwise not in func.tags or len(func._schema.returns) != 1 \
            or any(_aliases(func)):
        return None
    shapes = []
    for a in args:
        if isinstance(a, torch.Tensor):
            if not a.is_meta or not _row_major(a):
                return None
            shapes.append(a.shape)
        elif isinstance(a, (list, tuple)):
            return None
    if not shapes:
        return None
    # type promotion reads the operands' dtypes, whether a tensor is 0-dim, and a scalar's type
    key = (func, *((a.dtype, a.ndim == 0) if isinstance(a, torch.Tensor) else type(a) for a in args))
    dtype = _POINTWISE_DTYPE.get(key)
    if dtype is None:
        proxies = [torch.ones((1,) * a.ndim, dtype=a.dtype) if isinstance(a, torch.Tensor) else a for a in args]
        dtype = _POINTWISE_DTYPE[key] = func(*proxies).dtype
    return torch.empty(torch.broadcast_shapes(*shapes), dtype=dtype, device="meta")


_POINTWISE_DTYPE: dict = {}     # (op, operand kinds) -> the output's dtype


def _aliases(func) -> Tuple[bool, ...]:
    """For each return of ``func``: whether it aliases an input (a view, an
    in-place or out= result)."""
    return tuple(r.alias_info is not None for r in func._schema.returns)


class CostCounter(TorchDispatchMode):
    """``with CostCounter() as c: step()`` counts the step's ``flops``,
    ``mem_bytes`` and ``peak_bytes`` (see the module's docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.mem_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._opaque = 0
        self._held: Dict[int, int] = {}     # storage -> bytes, for the storages the step created

    def add(self, flops: int, mem_bytes: int) -> None:
        """Work reported by a kernel's wrapper."""
        self.flops += int(flops)
        self.mem_bytes += int(mem_bytes)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._held.pop(key, 0)

    def _hold(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = s._cdata
        if key in self._held:
            return
        n = s.nbytes()
        self._held[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(s, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = _meta_pointwise(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        alias = _aliases(func)
        for t, a in zip(outs, alias):
            if isinstance(t, torch.Tensor) and not a:
                self._hold(t)
        if self._opaque:
            return out
        if func.overloadpacket in _ALLOC:
            return out
        if all(alias) and alias and not any(r.alias_info.is_write for r in func._schema.returns):
            return out                                  # a view
        first = outs[0] if outs else None
        if isinstance(first, torch.Tensor):
            self.flops += _flops(func, args, first)
        reads = (args, {k: v for k, v in kwargs.items() if k != "out"})
        self.mem_bytes += sum(nbytes(t) for t in _tensors(reads))
        self.mem_bytes += sum(nbytes(t) for t in _tensors(outs))
        return out


def active():
    """The innermost counter entered on this thread (torch's dispatch-mode
    stack, which the autograd engine carries into its backward threads),
    or None."""
    if not torch._C._len_torch_dispatch_stack():
        return None
    return next((m for m in reversed(_get_current_dispatch_mode_stack()) if isinstance(m, CostCounter)), None)


def reports(cost_fn: Callable[..., Tuple[int, int]]):
    """Decorator of a kernel's wrapper: under a counter the wrapper's own
    torch operations are not counted, and ``cost_fn(*args, **kwargs)``'s
    (flops, bytes) are, on every device."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            c = active()
            if c is None:
                return fn(*args, **kwargs)
            c._opaque += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                c._opaque -= 1
            c.add(*cost_fn(*args, **kwargs))
            return out

        return wrapper

    return deco


def roofline_terms(cost: dict) -> dict:
    """The JAX package's formula and keys (``hlo_analysis.roofline_terms``)
    at one H100's rates: the memory term from ``mem_lo_bytes``, the
    eager traffic ``mem_bytes`` beside it as the upper bound."""
    ct = cost["flops"] / PEAK_FLOPS
    mt = cost.get("mem_lo_bytes", cost["mem_bytes"]) / HBM_BW
    mt_hi = cost["mem_bytes"] / HBM_BW
    kt = cost["coll_bytes"] / LINK_BW
    dom = max((ct, "compute"), (mt, "memory"), (kt, "collective"))[1]
    return {
        "compute_s": ct,
        "memory_s": mt,
        "memory_hi_s": mt_hi,
        "collective_s": kt,
        "bound": dom,
        "step_s_lower_bound": max(ct, mt, kt),
    }


def step_cost(run: Callable[[], Any], args: Any, donated: Any = ()) -> Tuple[Any, dict]:
    """Run ``run()`` (one step over the tensors of ``args``) under a counter.
    Returns (its outputs, the count): ``flops``, ``mem_bytes``,
    ``mem_lo_bytes`` (the arguments read once plus the outputs that are new
    storages written once), ``peak_bytes``, ``argument_bytes``,
    ``output_bytes``, ``alias_bytes`` (the bytes of ``donated``: the
    arguments the outputs replace) and ``coll_bytes`` 0 (one card)."""
    arg_keys = {t.untyped_storage()._cdata for t in _tensors(args)}
    with CostCounter() as c:
        out = run()
    outs = list(_tensors(out))
    new_out = sum(nbytes(t) for t in outs if t.untyped_storage()._cdata not in arg_keys)
    arg = tree_bytes(args)
    return out, {
        "flops": c.flops,
        "mem_bytes": c.mem_bytes,
        "mem_lo_bytes": arg + new_out,
        "peak_bytes": c.peak_bytes,
        "argument_bytes": arg,
        "output_bytes": sum(nbytes(t) for t in outs),
        "alias_bytes": tree_bytes(donated),
        "coll_bytes": 0,
    }
