"""Parameters of the JAX package, converted for the port.

The mapping is one to one: the same key paths, the leading stacked-repeat
axis kept, the same dtypes. The JAX tree arrives as numpy arrays (the port
imports nothing of JAX); bf16 arrives as numpy's ``bfloat16`` extension dtype
and is carried over bit for bit.

The reference's optimiser state (its ``OptState`` of ``m`` and ``v`` trees
shaped as the parameters, and ``step``) crosses with
:func:`opt_state_from_jax` into the port's ``OptState``, whose ``m`` and
``v`` are lists in JAX's leaf order (:mod:`repro_torch.tree`).

The DQN's MLP crosses as a list of numpy ``(w, b)`` pairs:
:func:`mlp_params_from_numpy` and :func:`mlp_params_to_numpy`, defined with
the network in :mod:`repro_torch.core.rl.dqn`, are re-exported here.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.rl.dqn import mlp_params_from_numpy, mlp_params_to_numpy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import Params
from repro_torch.models.transformer import abstract_params
from repro_torch.optim import OptState
from repro_torch.tree import leaves

__all__ = ["mlp_params_from_numpy", "mlp_params_to_numpy", "opt_state_from_jax", "params_from_jax",
           "tensor_from_numpy"]


def tensor_from_numpy(a: Any) -> torch.Tensor:
    """A CPU tensor holding ``a``'s values in its dtype (bf16 included)."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _convert(ref: Params, tree: Mapping[str, Any], path: str, device: torch.device) -> Params:
    if set(tree) != set(ref):
        raise KeyError(f"{path or '/'}: keys {sorted(tree)} != expected {sorted(ref)}")
    out: Params = {}
    for k, want in ref.items():
        sub = f"{path}/{k}"
        if isinstance(want, dict):
            if not isinstance(tree[k], Mapping):
                raise TypeError(f"{sub}: expected a subtree")
            out[k] = _convert(want, tree[k], sub, device)
            continue
        t = tensor_from_numpy(tree[k])
        if t.shape != want.shape or t.dtype != want.dtype:
            raise ValueError(
                f"{sub}: got {tuple(t.shape)} {t.dtype}, expected {tuple(want.shape)} {want.dtype}"
            )
        out[k] = t.to(device)
    return out


def params_from_jax(
    cfg: ArchConfig, tree: Mapping[str, Any], *, device: DeviceLike = None
) -> Params:
    """The port's parameters from ``repro.models.init_params(cfg, ...)``'s tree.

    ``tree`` is that tree with every leaf as a numpy array; every key path,
    shape and dtype must match the port's own layout, or this raises.
    """
    return _convert(abstract_params(cfg), tree, "", resolve_device(device))


def _with_dtype(ref: Params, dtype: torch.dtype) -> Params:
    return {k: _with_dtype(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in ref.items()}


def opt_state_from_jax(cfg: ArchConfig, opt_state: Any, *, device: DeviceLike = None) -> OptState:
    """The port's ``OptState`` from the reference's ``AdamW`` state for ``cfg``'s parameters.

    ``opt_state`` is the reference's ``OptState`` with numpy leaves. ``m``
    and ``v`` must have the parameters' key paths and shapes in float32 (the
    optimiser's default state dtype); ``step`` must be a 0-dim int32. Their
    leaves come out in JAX's order.
    """
    dev = resolve_device(device)
    ref = _with_dtype(abstract_params(cfg), torch.float32)
    m = _convert(ref, opt_state.m, "/m", dev)
    v = _convert(ref, opt_state.v, "/v", dev)
    step = np.asarray(opt_state.step)
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"/step: got {step.shape} {step.dtype}, expected () int32")
    return OptState(m=leaves(m), v=leaves(v), step=torch.from_numpy(step.copy()).to(dev))
