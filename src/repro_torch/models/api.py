"""Uniform functional API over the model families (``repro.models.api``).

The dense ``transformer``, the ``rglru_hybrid`` (recurrentgemma) and
``rwkv6`` families are ported; ``whisper`` raises.
"""

from __future__ import annotations

import types

from repro_torch.models import rglru, rwkv6, transformer
from repro_torch.models.common import ModelConfig

_FAMILIES = {"transformer": transformer, "rglru_hybrid": rglru, "rwkv6": rwkv6}
_WAITING = ("whisper",)


def get_family(cfg_or_name) -> types.ModuleType:
    name = cfg_or_name.family if isinstance(cfg_or_name, ModelConfig) else cfg_or_name
    if name in _WAITING:
        raise KeyError(f"model family {name!r} is not ported yet (see ROADMAP.md)")
    if name not in _FAMILIES:
        raise KeyError(f"unknown model family {name!r}; have {sorted(_FAMILIES)}")
    return _FAMILIES[name]
