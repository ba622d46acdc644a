"""Uniform functional API over the model families (``repro.models.api``).

Only the dense ``transformer`` family is ported; the others raise.
"""

from __future__ import annotations

import types

from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig

_FAMILIES = {"transformer": transformer}
_WAITING = ("rglru_hybrid", "rwkv6", "whisper")


def get_family(cfg_or_name) -> types.ModuleType:
    name = cfg_or_name.family if isinstance(cfg_or_name, ModelConfig) else cfg_or_name
    if name in _WAITING:
        raise KeyError(f"model family {name!r} is not ported yet (see ROADMAP.md)")
    if name not in _FAMILIES:
        raise KeyError(f"unknown model family {name!r}; have {sorted(_FAMILIES)}")
    return _FAMILIES[name]
