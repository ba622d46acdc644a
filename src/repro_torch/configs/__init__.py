"""Architecture registry of the port: one module per architecture of the
reference.

The port's own records (``repro.configs`` loads JAX): ``get_config(arch_id)``
returns the full configuration, ``get_smoke_config(arch_id)`` a reduced
same-family one for CPU tests, ``all_configs()`` every full one.  Ids,
their order and the aliases are the reference's.
"""

from __future__ import annotations

import importlib

ARCH_IDS = [
    "phi3_5_moe",
    "moonshot_v1_16b",
    "yi_6b",
    "qwen1_5_0_5b",
    "glm4_9b",
    "gemma3_12b",
    "chameleon_34b",
    "whisper_base",
    "recurrentgemma_2b",
    "rwkv6_3b",
]

# in the reference's registry, not ported yet: none
WAITING: list[str] = []

# the port's own architectures, which the reference's registry lacks
PORT_ONLY = ["moonlight_16b_a3b"]

# canonical external names -> module ids
ALIASES = {
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b",
    "yi-6b": "yi_6b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "glm4-9b": "glm4_9b",
    "gemma3-12b": "gemma3_12b",
    "chameleon-34b": "chameleon_34b",
    "whisper-base": "whisper_base",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "rwkv6-3b": "rwkv6_3b",
}


def _module(arch_id: str):
    arch_id = ALIASES.get(arch_id, arch_id)
    if arch_id not in ARCH_IDS + PORT_ONLY:
        raise KeyError(f"unknown arch {arch_id!r}; have {ARCH_IDS + PORT_ONLY}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get_config(arch_id: str):
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str):
    return _module(arch_id).smoke_config()


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
