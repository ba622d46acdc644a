"""Uniform functional API over the model families (``repro.models.api``):
the transformer (dense and MoE), ``rglru_hybrid`` (recurrentgemma),
``rwkv6`` and ``whisper``.
"""

from __future__ import annotations

import types

from repro_torch.models import rglru, rwkv6, transformer, whisper
from repro_torch.models.common import ModelConfig

_FAMILIES = {"transformer": transformer, "rglru_hybrid": rglru, "rwkv6": rwkv6,
             "whisper": whisper}
_WAITING: tuple[str, ...] = ()  # none: every family of the reference is ported


def get_family(cfg_or_name) -> types.ModuleType:
    name = cfg_or_name.family if isinstance(cfg_or_name, ModelConfig) else cfg_or_name
    if name not in _FAMILIES:
        raise KeyError(f"unknown model family {name!r}; have {sorted(_FAMILIES)}")
    return _FAMILIES[name]
