"""The system under test: the PyTorch/CUDA port, ``repro_torch``.

The only module of the benchmark that imports the program. It builds the
program's config from the configuration's file (the registry's config with
the fields that the file's ``port.set`` names taken from the file: the
depth, and any option the program has that the registry sets otherwise)
and refuses it where a width or the layer pattern differs from the file;
then it hands out the entries that the window drives:
``forward`` (prefill) and ``decode_step`` with ``init_cache`` (decode), at
``impl="auto"``, and the kernels' launch counters.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict

from yardstick.model import Shape, lookup

__all__ = ["Program", "ConfigMismatch"]

# the port's fields that the registry leaves to a default
_DERIVED: Dict[str, Callable[[Any], Any]] = {
    "mamba.dt_rank": lambda c: c.mamba.dt_rank or max(c.d_model // 16, 1),
}


class ConfigMismatch(ValueError):
    """The program's config is not the configuration's file."""


def _attr(cfg: Any, path: str) -> Any:
    if path in _DERIVED:
        return _DERIVED[path](cfg)
    node = cfg
    for part in path.split("."):
        node = getattr(node, part)
    return node


class Program:
    """The port, configured as the file says."""

    def __init__(self, conf: Dict[str, Any], shape: Shape):
        from repro_torch.configs import get_config, smoke_config
        from repro_torch.models import abstract_params, decode_step, forward, init_cache

        port = conf["port"]
        cfg = get_config(port["registry"])
        if port.get("preset") == "smoke":  # the registry's small preset in the file's dtype (tests)
            cfg = dataclasses.replace(smoke_config(port["registry"]), dtype=conf["torch_dtype"],
                                      param_dtype=conf["torch_dtype"])
        cfg = dataclasses.replace(cfg, **{a: lookup(conf, key) for a, key in port["set"].items()})
        wrong = []
        for attr, key in port["fields"].items():
            want, have = lookup(conf, key), _attr(cfg, attr)
            if want != have:
                wrong.append(f"{attr} = {have!r}, the file's {key} = {want!r}")
        for attr, want in port.get("literals", {}).items():
            have = _attr(cfg, attr)
            if want != have:
                wrong.append(f"{attr} = {have!r}, the file says {want!r}")
        kinds = [("attention" if k in ("attn", "local") else k, cfg.layer_is_moe(i))
                 for i, k in enumerate(cfg.layer_kinds())]
        if kinds != list(shape.layers):
            wrong.append(f"layers {kinds} against the file's {list(shape.layers)}")
        if wrong:
            raise ConfigMismatch(f"{port['registry']}: " + "; ".join(wrong))
        self.cfg = cfg
        self._forward, self._decode_step, self._init_cache = forward, decode_step, init_cache
        self.abstract = abstract_params(cfg)
        self._kernels = {name: importlib.import_module(f"repro_torch.kernels.{name}")
                         for name in ("flash_attention", "gmm", "mamba_scan")}

    def forward(self, params, tokens, device):
        return self._forward(self.cfg, params, {"tokens": tokens}, impl="auto", device=device)[0]

    def init_cache(self, batch: int, length: int, device):
        return self._init_cache(self.cfg, batch, length, device=device)

    def decode_step(self, params, cache, token, index: int, device):
        return self._decode_step(self.cfg, params, cache, token, index, impl="auto",
                                 device=device)[0]

    def launches(self) -> Dict[str, int]:
        """Each kernel's launches so far in this process (the program's counters)."""
        return {name: mod.LAUNCHES for name, mod in self._kernels.items()}
