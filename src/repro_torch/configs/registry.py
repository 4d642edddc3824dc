"""Architecture registry: ``--arch <id>`` resolution for launchers/tests.

Only the architectures the port serves so far are registered."""
from __future__ import annotations

from typing import List

from repro_torch.configs import smollm_360m, xlstm_350m
from repro_torch.models.common import ModelConfig

_MODULES = {
    "smollm-360m": smollm_360m,
    "xlstm-350m": xlstm_350m,
}


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    m = _MODULES[arch]
    return m.SMOKE if smoke else m.FULL
