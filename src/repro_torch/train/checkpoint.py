"""Checkpoints with a manifest, in the JAX package's on-disk layout (the
torch twin of ``repro/train/checkpoint.py``)::

    <dir>/step_000123/
        manifest.json      # leaf shapes, dtypes, step, meta
        arrays/<idx>.npy   # one file per leaf

Leaves are numbered in the JAX package's flatten order (``train/tree.py``),
so a checkpoint written by either package restores into the other. numpy
has no bf16: a bf16 leaf is written as its raw 2 bytes a value (a ``V2``
array, as numpy saves the JAX package's ``ml_dtypes`` bfloat16) with dtype
``bfloat16`` in the manifest, and read back bit for bit. Writes are atomic
(a tmp dir, then ``os.replace``), so a preemption mid-save never corrupts
the latest checkpoint; ``latest_step`` counts completed manifests only.

Sharded trees (DTensor leaves, ``launch/steps.py``): ``save`` writes each
leaf whole (every rank gathers it; rank 0 of the world writes, and every
rank waits until the step is published), and ``restore`` with
``shardings`` (a tree of ``sharding.axes.NamedSharding`` or None) puts each
leaf on the mesh its sharding names, which may differ from the mesh it was
saved from: a checkpoint moves between meshes.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.sharding.axes import is_dtensor
from repro_torch.train.tree import leaves, paths, unflatten


def _to_numpy(t: torch.Tensor):
    """(array to save, manifest dtype name) of one leaf."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view("V2"), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A loaded leaf (C order, as ``save`` writes it) as a tensor of the
    manifest's dtype."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a.astype(np.dtype(dtype_name), copy=False))


def _writer() -> bool:
    """True on the rank that writes: rank 0 of a started world, or a
    process without one."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def save(dir_: str, step: int, tree: Any, meta: Optional[dict] = None) -> str:
    """Write ``tree`` as step ``step`` under ``dir_``; returns the step's
    path. A tree with DTensor leaves is saved by every rank of the world
    together (each leaf gathered whole, rank 0 writing)."""
    flat = leaves(tree)
    if any(is_dtensor(t) for t in flat):
        import torch.distributed as dist

        whole = [t.full_tensor() if is_dtensor(t) else t for t in flat]
        path = _write(dir_, step, unflatten(tree, whole), meta) if _writer() else None
        dist.barrier()
        return str(Path(dir_) / f"step_{step:08d}") if path is None else path
    return _write(dir_, step, tree, meta)


def _write(dir_: str, step: int, tree: Any, meta: Optional[dict]) -> str:
    base = Path(dir_)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:08d}"
    tmp = base / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    (tmp / "arrays").mkdir(parents=True)

    records = []
    flat = leaves(tree)
    for i, leaf in enumerate(flat):
        arr, name = _to_numpy(leaf)
        np.save(tmp / "arrays" / f"{i}.npy", arr)
        records.append({"idx": i, "shape": list(leaf.shape), "dtype": name})
    manifest = {
        "step": step,
        "n_leaves": len(flat),
        "treedef": " ".join(paths(tree)),
        "leaves": records,
        "meta": meta or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish
    return str(final)


def latest_step(dir_: str) -> Optional[int]:
    base = Path(dir_)
    if not base.exists():
        return None
    steps = []
    for p in base.glob("step_*"):
        if (p / "manifest.json").exists():
            steps.append(int(p.name.split("_")[1]))
    return max(steps) if steps else None


def restore(dir_: str, step: int, like: Any, device=None, shardings: Any = None) -> Any:
    """A tree of ``like``'s structure from the checkpoint, each leaf on
    ``device`` (default: the device of ``like``'s leaf), and with
    ``shardings`` (a tree of ``NamedSharding`` or None matching ``like``)
    put on the mesh each leaf's sharding names, as a DTensor of its layout
    (a None sharding keeps the leaf whole). Raises ValueError if the leaf
    count or a shape differs from ``like``'s."""
    path = Path(dir_) / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    ref = leaves(like)
    if manifest["n_leaves"] != len(ref):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, expected {len(ref)}")
    shs = [None] * len(ref) if shardings is None else _sharding_leaves(like, shardings)
    out = []
    for i, (r, sh) in enumerate(zip(ref, shs)):
        t = _from_numpy(np.load(path / "arrays" / f"{i}.npy"), manifest["leaves"][i]["dtype"])
        if tuple(t.shape) != tuple(r.shape):
            raise ValueError(f"leaf {i}: {tuple(t.shape)} != {tuple(r.shape)}")
        t = t.to(r.device if device is None else device)
        out.append(t if sh is None else sh.distribute(t))
    return unflatten(like, out)


def _sharding_leaves(like: Any, shardings: Any) -> list:
    """``shardings``'s entries for ``like``'s leaves, in ``leaves`` order
    (a None or a single sharding covers a whole subtree)."""
    if isinstance(like, dict):
        return [s for k in sorted(like)
                for s in _sharding_leaves(like[k], shardings[k] if isinstance(shardings, dict) else shardings)]
    return [shardings]


def load_meta(dir_: str, step: int) -> dict:
    path = Path(dir_) / f"step_{step:08d}" / "manifest.json"
    return json.loads(path.read_text())["meta"]
