"""Train / serve step builders (counterpart of ``repro.distributed.step``).

``make_train_step`` takes one optimiser step from the loss's gradients, with
optional accumulation over microbatches: the leading batch dimension is
split into ``(accum_steps, micro)``, each microbatch's gradients are added in
fp32 and kept in ``grad_accum_dtype``, and the loss and gradients are divided
by ``accum_steps``. Gradients come from autograd through the model's plain
versions (``impl="ref"`` in the trainer, as the reference trains): the
kernels are forward-only, so a step that would launch them raises.

Every step runs on the device its parameters lie on. On a mesh the trees
hold DTensors (:mod:`repro_torch.distributed.sharding`): the step runs under
``implicit_replication`` (a plain tensor made inside the model enters as
replicated), gradients reduce through DTensor's autograd (a ``Partial``
gradient becomes the parameter's placement), and each microbatch is pinned
batch-sharded. With plain tensors none of this runs. The parameter tree's
leaves are walked in JAX's order (:mod:`repro_torch.tree`), so the port's
``AdamW`` (which takes lists) sees the reference's leaf order and the global
gradient norm adds in the reference's order.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.distributed.hints import hint
from repro_torch.kernels import ops
from repro_torch.models import decode_step as model_decode
from repro_torch.models import forward as model_forward
from repro_torch.models import loss_fn as model_loss
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import Params
from repro_torch.optim import AdamW, OptState
from repro_torch.tree import leaves, unflatten

__all__ = ["make_train_step", "make_serve_step", "make_prefill_step", "train_state",
           "from_train_state"]


def _device(params: Params) -> torch.device:
    return params["embed"].device


def _mesh_scope(params: Params):
    """``implicit_replication`` for a tree of DTensors, else a null context."""
    if isinstance(params["embed"], DTensor):
        return implicit_replication()
    return contextlib.nullcontext()


def _value_and_grad(cfg: ArchConfig, params: Params, batch, impl: str, loss_chunk: int = 512):
    """(loss, grads in the params' leaf order) of ``loss_fn`` at ``params``."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    if ops.resolve_impl(impl, flat[0]) == "cuda":
        raise ValueError("the CUDA kernels are forward-only (no backward, as the reference's "
                         "Pallas kernels have no custom_vjp): train at impl='ref'")
    with torch.enable_grad():
        loss = model_loss(cfg, unflatten(params, flat), batch, impl=impl, loss_chunk=loss_chunk,
                          device=flat[0].device)
        grads = torch.autograd.grad(loss, flat)
    # on a mesh each gradient takes its parameter's placements (a Partial sum
    # is reduced, scattered where the parameter is sharded), as the optimiser
    # state mirrors the parameters
    grads = [g.redistribute(p.device_mesh, p.placements) if isinstance(p, DTensor) else g
             for p, g in zip(flat, grads, strict=True)]
    return loss.detach(), grads


def _microbatches(batch: Dict[str, np.ndarray], accum_steps: int) -> List[Dict[str, np.ndarray]]:
    """Split the leading batch dimension into (accum, micro); the i-th micro slice each."""

    def reshape(x):
        b = x.shape[0]
        assert b % accum_steps == 0, (b, accum_steps)
        x = hint(x, None)  # on a mesh the whole batch, split in the global row order
        return x.reshape(accum_steps, b // accum_steps, *x.shape[1:])

    split = {k: reshape(v) for k, v in batch.items()}
    # on a mesh, microbatch i is the global rows i*micro.., sharded over the DP axes
    return [{k: hint(v[i], "dp") for k, v in split.items()} for i in range(accum_steps)]


def make_train_step(
    cfg: ArchConfig,
    optimizer: AdamW,
    accum_steps: int = 1,
    impl: str = "auto",
    grad_accum_dtype: str = "float32",
) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``opt_state`` is the port's ``OptState`` over ``leaves(params)`` (as
    ``optimizer.init(leaves(params))`` makes it). The update is pure: new
    parameters and state are returned, and the caller rebinds its names so
    the old ones are freed. ``metrics`` holds ``loss``, ``grad_norm`` (of
    the unclipped gradients) and ``step`` as device scalars.
    """
    acc_dt = getattr(torch, grad_accum_dtype)

    def train_step(params: Params, opt_state: OptState, batch):
        with _mesh_scope(params):
            return _train_step(params, opt_state, batch)

    def _train_step(params: Params, opt_state: OptState, batch):
        if accum_steps == 1:
            loss, grads = _value_and_grad(cfg, params, batch, impl)
        else:
            dev = _device(params)
            grads = [torch.zeros_like(p, dtype=acc_dt) for p in leaves(params)]
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for mb in _microbatches(batch, accum_steps):
                l, g = _value_and_grad(cfg, params, mb, impl)
                grads = [(a.float() + b.float()).to(acc_dt) for a, b in zip(grads, g, strict=True)]
                loss = loss + l
            grads = [g.float() / accum_steps for g in grads]
            loss = loss / accum_steps

        with torch.no_grad():
            new_leaves, opt_state2 = optimizer.update(grads, opt_state, leaves(params))
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
        metrics = {"loss": loss, "grad_norm": gnorm, "step": opt_state2.step}
        return unflatten(params, new_leaves), opt_state2, metrics

    return train_step


def make_serve_step(cfg: ArchConfig, impl: str = "auto") -> Callable:
    """Returns serve_step(params, cache, token, index) -> (logits, cache).

    One new token per request with the KV cache / recurrent state carried
    (updated in place). ``impl`` picks the route of the ops that have a
    kernel (the attention over the cache, the MoE's expert products,
    cross-attention); the dry-run serves at ``"ref"``, as the reference's
    does.
    """
    ops.resolve_impl(impl, torch.empty(0))  # an unknown impl raises here

    def serve_step(params, cache, token, index, enc_out=None):
        with _mesh_scope(params):
            return model_decode(cfg, params, cache, token, index, enc_out=enc_out, impl=impl,
                                device=_device(params))

    return serve_step


def make_prefill_step(cfg: ArchConfig, impl: str = "auto") -> Callable:
    """Returns prefill_step(params, batch) -> last-position logits."""

    def prefill_step(params, batch):
        with _mesh_scope(params):
            logits, _ = model_forward(cfg, params, batch, impl=impl, device=_device(params))
            return logits[:, -1, :]

    return prefill_step


def train_state(params: Params, opt_state: OptState) -> Dict:
    """The trainer's checkpoint tree ``{"params", "opt"}``, with ``m`` and ``v``
    as trees shaped as ``params``: the reference's keys (``opt/m/blocks/...``)."""
    return {"params": params, "opt": OptState(m=unflatten(params, opt_state.m),
                                              v=unflatten(params, opt_state.v),
                                              step=opt_state.step)}


def from_train_state(state: Dict) -> Tuple[Params, OptState]:
    """(params, the port's ``OptState`` of leaf lists) from :func:`train_state`'s tree."""
    opt = state["opt"]
    return state["params"], OptState(m=leaves(opt.m), v=leaves(opt.v), step=opt.step)
