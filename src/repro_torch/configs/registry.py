"""Architecture registry: ``--arch <id>`` resolution for launchers/tests
(the torch twin of ``repro/configs/registry.py``)."""
from __future__ import annotations

from typing import List

from repro_torch.configs import (
    dbrx_132b,
    glm4_9b,
    granite_8b,
    jamba_15_large,
    llama4_maverick,
    qwen2_vl_2b,
    qwen15_32b,
    smollm_360m,
    whisper_large_v3,
    xlstm_350m,
)
from repro_torch.configs.shapes import SHAPES
from repro_torch.models.common import ModelConfig

_MODULES = {
    "xlstm-350m": xlstm_350m,
    "smollm-360m": smollm_360m,
    "glm4-9b": glm4_9b,
    "granite-8b": granite_8b,
    "qwen1.5-32b": qwen15_32b,
    "jamba-1.5-large-398b": jamba_15_large,
    "dbrx-132b": dbrx_132b,
    "llama4-maverick-400b-a17b": llama4_maverick,
    "qwen2-vl-2b": qwen2_vl_2b,
    "whisper-large-v3": whisper_large_v3,
}


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    m = _MODULES[arch]
    return m.SMOKE if smoke else m.FULL


def skip_reason(arch: str, shape_name: str) -> str:
    """Empty string if (arch, shape) runs; otherwise the documented reason."""
    return _MODULES[arch].SKIP_SHAPES.get(shape_name, "")


def cells(include_skipped: bool = True):
    """All 40 (arch, shape) cells; skipped ones flagged with their reason."""
    out = []
    for arch in list_archs():
        for sname, spec in SHAPES.items():
            out.append((arch, spec, skip_reason(arch, sname)))
    return out
