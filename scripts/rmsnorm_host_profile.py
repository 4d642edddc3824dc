#!/usr/bin/env python3
"""Host time of one ``rmsnorm`` wrapper call on an NVIDIA card, step by step.

    PYTHONPATH=src python scripts/rmsnorm_host_profile.py [--calls 10000]

At x (8, 960) bf16 (every norm of smollm-360m's decode step), each step the
wrapper takes is run alone ``--calls`` times between two
``time.perf_counter_ns`` reads, less the same loop around an empty step. Two
launch paths are profiled: the lean one of ``kernels/_build.py`` as the
wrapper runs it, and the earlier one, rebuilt here step for step (a
``torch.device`` comparison per tensor, a dict lookup of the entry point, a
``torch.cuda.Stream`` object per call, a library loaded with ``ctypes.CDLL``,
whose calls release the interpreter lock). The ctypes step launches the kernel;
a ctypes call that launches nothing is timed beside it. Then the whole
wrapper call and ``F.rms_norm`` on the host clock (the
enqueue: no synchronize inside the loop) and on CUDA events over
back-to-back calls. Prints the card's name and power limit, then one JSON
line."""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def per_call_ns(fn, n: int) -> float:
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    return (time.perf_counter_ns() - t0) / n


def events_ms(torch, fn, iters: int = 20, reps: int = 25) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def main() -> int:
    import torch
    from torch.nn import functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels.rmsnorm import ops as rms_ops

    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=10000)
    n = ap.parse_args().calls
    if not torch.cuda.is_available():
        print("rmsnorm_host_profile: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda")
    x = torch.randn(8, 960, device=dev).to(torch.bfloat16)
    w = torch.linspace(0.5, 1.5, 960, device=dev).to(torch.bfloat16)
    D = 960
    out = torch.empty_like(x)
    rms_ops.rmsnorm(x, w)                         # builds the library, resolves the entry point
    torch.cuda.synchronize()
    fn = rms_ops._RT.fn
    code = _build.DTYPE_CODE[x.dtype]
    index = x.get_device()
    # the earlier path loaded the library with ctypes.CDLL, whose calls
    # release the interpreter lock; the lean one with ctypes.PyDLL
    cdll_fn = ctypes.CDLL(str(_build.BUILD_DIR / _build.LIB_NAME)).rt_rmsnorm
    cdll_fn.argtypes, cdll_fn.restype = fn.argtypes, ctypes.c_int
    fns = {"rt_rmsnorm": cdll_fn}
    lock = threading.Lock()

    class Counter:
        launches = 0

    def count():
        with lock:
            Counter.launches += 1

    def earlier_require_cuda(*tensors):
        d = tensors[0].device
        for t in tensors:
            if not t.is_cuda or t.device != d:
                raise ValueError
            if not t.is_contiguous():
                raise ValueError

    def earlier_function(name):
        return fns.get(name)

    def launch():
        fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), 8, D, 1e-6, code, stream)

    stream = _build.stream_ptr(index)
    steps = {
        "earlier": {
            "cpu check (x.device.type)": lambda: x.device.type == "cpu",
            "dtype and shape checks": lambda: (x.dtype not in _build.DTYPE_CODE or w.dtype != x.dtype,
                                               w.shape != (D,)),
            "require_cuda (torch.device compares)": lambda: earlier_require_cuda(x, w),
            "empty_like": lambda: torch.empty_like(x),
            "entry point lookup": lambda: earlier_function("rt_rmsnorm"),
            "data_ptr x3": lambda: (x.data_ptr(), w.data_ptr(), out.data_ptr()),
            "stream (torch.cuda.current_stream(dev).cuda_stream)":
                lambda: torch.cuda.current_stream(x.device).cuda_stream,
            "ctypes call (CDLL, launch)": lambda: cdll_fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), 8,
                                                          D, 1e-6, _build.DTYPE_CODE[x.dtype], stream),
            "count_launch (lock)": count,
            "check": lambda: _build.check(0, "rmsnorm"),
        },
        "lean": {
            "cpu check (x.is_cpu)": lambda: x.is_cpu,
            "dtype and shape checks": lambda: (_build.DTYPE_CODE.get(x.dtype) is None or w.dtype != x.dtype,
                                               w.shape != (D,)),
            "require_cuda (device indices)": lambda: _build.require_cuda("rmsnorm", x, w),
            "empty_like": lambda: torch.empty_like(x),
            "entry point (resolved once)": lambda: rms_ops._RT.fn or rms_ops._RT.resolve(),
            "data_ptr x3": lambda: (x.data_ptr(), w.data_ptr(), out.data_ptr()),
            "stream (raw pointer)": lambda: _build.stream_ptr(index),
            "ctypes call (PyDLL, launch)": launch,
            "count_launch (lock)": count,
            "check": lambda: _build.check(0, "rmsnorm"),
        },
    }
    empty = statistics.median(per_call_ns(lambda: None, n) for _ in range(5))
    result = {"shape": "x (8, 960) bf16", "calls": n, "empty_loop_ns": empty, "paths": {}}
    for path, table in steps.items():
        row = {}
        for name, step in table.items():
            step()
            torch.cuda.synchronize()
            row[name] = statistics.median(per_call_ns(step, n) for _ in range(5)) - empty
            torch.cuda.synchronize()
        row["sum of steps"] = sum(row.values())
        result["paths"][path] = row
    lib = _build.library()
    no_launch = lambda: lib.rt_error_string(0)     # noqa: E731  a ctypes call that launches nothing
    result["ctypes call without a launch (rt_error_string)"] = (
        statistics.median(per_call_ns(no_launch, n) for _ in range(5)) - empty)
    for name, call in (("rmsnorm wrapper", lambda: rms_ops.rmsnorm(x, w)),
                       ("F.rms_norm", lambda: F.rms_norm(x, (D,), w, 1e-6))):
        call()
        torch.cuda.synchronize()
        host = statistics.median(per_call_ns(call, n) for _ in range(5))
        torch.cuda.synchronize()
        result[name] = {"host_enqueue_ns": host, "events_ms": events_ms(torch, call)}
    for path, row in result["paths"].items():
        for name, ns in row.items():
            print(f"  {path:8s} {name:50s} {ns:10.1f} ns")
    print(f"  ctypes call without a launch (rt_error_string): "
          f"{result['ctypes call without a launch (rt_error_string)']:.1f} ns")
    for name in ("rmsnorm wrapper", "F.rms_norm"):
        print(f"  {name}: host enqueue {result[name]['host_enqueue_ns']:.1f} ns per call, "
              f"CUDA events {result[name]['events_ms']:.7f} ms per call")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
