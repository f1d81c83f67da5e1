"""Architecture configs the port serves, with the JAX package's registry API.

``get_config(name)`` returns the full production config; ``smoke_config(name)``
the reduced same-family config for CPU tests. Only the archs whose slice has
been ported are registered; nemotron-4-340b waits for its own (ROADMAP.md A.5b).
"""

from __future__ import annotations

import importlib
from repro_torch.models.config import ArchConfig

ARCH_IDS = ["gemma3_1b", "jamba_v01_52b", "xlstm_350m", "granite_moe_3b_a800m", "whisper_base",
            "gemma3_12b", "mixtral_8x7b", "stablelm_3b", "phi3_vision_4_2b"]

# canonical external ids (assignment spelling) -> module names
ALIASES = {
    "gemma3-1b": "gemma3_1b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "xlstm-350m": "xlstm_350m",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "whisper-base": "whisper_base",
    "gemma3-12b": "gemma3_12b",
    "mixtral-8x7b": "mixtral_8x7b",
    "stablelm-3b": "stablelm_3b",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
}


def _module(name: str):
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod_name not in ARCH_IDS:
        raise KeyError(
            f"arch {name!r} is not ported yet (ported: {ARCH_IDS}); see ROADMAP.md queue A"
        )
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def smoke_config(name: str) -> ArchConfig:
    return _module(name).SMOKE
