"""Architecture registry: ``--arch <id>`` resolution for launchers/tests.

Only the architectures the port serves so far are registered."""
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
from repro_torch.models.common import ModelConfig

_MODULES = {
    "smollm-360m": smollm_360m,
    "xlstm-350m": xlstm_350m,
    "glm4-9b": glm4_9b,
    "qwen1.5-32b": qwen15_32b,
    "granite-8b": granite_8b,
    "qwen2-vl-2b": qwen2_vl_2b,
    "whisper-large-v3": whisper_large_v3,
    "dbrx-132b": dbrx_132b,
    "llama4-maverick-400b-a17b": llama4_maverick,
    "jamba-1.5-large-398b": jamba_15_large,
}


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    m = _MODULES[arch]
    return m.SMOKE if smoke else m.FULL
