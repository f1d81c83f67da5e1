"""Architecture configs the port serves, with the JAX package's registry API.

``get_config(name)`` returns the full production config; ``smoke_config(name)``
the reduced same-family config for CPU tests; ``all_configs()`` every full
config by id. The registry holds the reference's ten archs in its order.
"""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ArchConfig

ARCH_IDS = [
    "xlstm_350m",
    "nemotron_4_340b",
    "gemma3_12b",
    "gemma3_1b",
    "stablelm_3b",
    "granite_moe_3b_a800m",
    "mixtral_8x7b",
    "whisper_base",
    "jamba_v01_52b",
    "phi3_vision_4_2b",
]

# canonical external ids (assignment spelling) -> module names
ALIASES = {
    "xlstm-350m": "xlstm_350m",
    "nemotron-4-340b": "nemotron_4_340b",
    "gemma3-12b": "gemma3_12b",
    "gemma3-1b": "gemma3_1b",
    "stablelm-3b": "stablelm_3b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "mixtral-8x7b": "mixtral_8x7b",
    "whisper-base": "whisper_base",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
}


def _module(name: str):
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; registered: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def smoke_config(name: str) -> ArchConfig:
    return _module(name).SMOKE


def all_configs() -> Dict[str, ArchConfig]:
    return {n: get_config(n) for n in ARCH_IDS}
