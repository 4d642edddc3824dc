"""Build, load and call the port's CUDA kernels.

On first use, every ``csrc/*.cu`` is compiled by its own ``nvcc`` process
(all started together) for ``sm_90a``, the objects are linked into one
shared library with a plain C interface, and the library is loaded with
``ctypes``. The build goes to ``kernels/build/`` (listed in ``.gitignore``)
and is redone whenever a source is newer than the library. A lock guards the
build: router workers and engine-loop threads may reach a kernel first.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()  # locklint: blocking-ok one build a process: a later caller waits for the nvcc run, then loads its library
_lib: Optional[ctypes.CDLL] = None  # guarded by: _lock
_count_lock = threading.Lock()
build_info: Dict[str, object] = {}  # guarded by: _lock -- seconds and compiler output of this process's build
# the launch counters each wrapper carries (``wrapper.launches``, and
# ``wrapper.leg_launches`` for a kernel with several legs)
_GUARDED = {"launches": "_count_lock", "leg_launches": "_count_lock"}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _stale(lib: Path) -> bool:
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.glob("*.cu*"))
    return newest > lib.stat().st_mtime


def build() -> Tuple[Path, str]:
    """Compile every source in parallel, link one shared library, and return
    (library path, compiler output). Raises with the output on failure."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}-{threading.get_ident()}"
    procs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for src, _, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name} (rc {p.returncode})\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    objs = [obj for _, obj, _ in procs]
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp = BUILD_DIR / f"{LIB_NAME}.{tag}"
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs), "-lcudart"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        log.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        lib = BUILD_DIR / LIB_NAME
        os.replace(tmp, lib)          # atomic: a concurrent process sees old or new
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return lib, "\n".join(log)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib_path = BUILD_DIR / LIB_NAME
            if _stale(lib_path):
                t0 = time.perf_counter()
                lib_path, log = build()
                build_info.update(seconds=time.perf_counter() - t0, log=log)
            else:
                build_info.update(seconds=0.0, log="(library up to date)")
            # PyDLL: a call keeps the interpreter lock, as a torch operator
            # does, so a launch of a few microseconds does not hand the lock
            # to another thread and wait to get it back
            lib = ctypes.PyDLL(str(lib_path))
            lib.rt_error_string.argtypes = [ctypes.c_int]
            lib.rt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


class Entry:
    """A C entry point of the library, resolved once: ``fn`` is None until
    the first ``resolve()``, which builds or loads the library and declares
    the argument types (``ctypes.c_void_p`` for every pointer and the
    stream). A wrapper calls ``(entry.fn or entry.resolve())(...)``, so a
    launch costs one attribute read and no lookup."""

    __slots__ = ("name", "argtypes", "fn")

    def __init__(self, name: str, argtypes: list):
        self.name, self.argtypes, self.fn = name, argtypes, None

    def resolve(self):
        if self.fn is None:
            fn = getattr(library(), self.name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self.fn = fn
        return self.fn


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = library().rt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def stream_ptr(device_index: int) -> int:
    """The calling thread's current stream on that device, as a raw
    pointer: no ``torch.cuda.Stream`` object is built (the call Inductor's
    generated code makes)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def count_launch(wrapper, leg: Optional[str] = None) -> None:
    """Add one to ``wrapper.launches`` and, for a kernel with several legs,
    to ``wrapper.leg_launches[leg]``; engine loops on several threads may
    launch the same kernel at once."""
    with _count_lock:
        wrapper.launches += 1
        if leg is not None:
            wrapper.leg_launches[leg] += 1


def reset_launches(wrapper) -> None:
    """Set a wrapper's launch counts (and its legs') to 0."""
    with _count_lock:
        wrapper.launches = 0
        for leg in getattr(wrapper, "leg_launches", {}):
            wrapper.leg_launches[leg] = 0


def require_cuda(name: str, *tensors: torch.Tensor) -> int:
    """The wrapper's checks common to every kernel: CUDA, one device,
    contiguous. Returns the device's index (for ``stream_ptr``)."""
    index = tensors[0].get_device()
    for t in tensors:
        if not t.is_cuda or t.get_device() != index:
            raise ValueError(f"{name}: every tensor must be on one CUDA device, got "
                             f"{[str(u.device) for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return index
