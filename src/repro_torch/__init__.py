"""PyTorch/CUDA port of the ``repro`` model substrate for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package keeps its module
layout and names so each counterpart is easy to find, imports ``torch`` and
never ``jax`` or ``repro``, and runs its entry points on ``cuda`` unless the
caller passes ``device="cpu"`` (:func:`repro_torch.device.resolve_device`).

Ported so far: the serving paths of gemma3-1b, jamba-v0.1-52b, xlstm-350m
and granite-moe-3b-a800m (:mod:`repro_torch.models`,
:mod:`repro_torch.launch.serve`) with their four kernels written in CUDA
(:mod:`repro_torch.kernels`); the batched MIG simulator
(:mod:`repro_torch.core.batched`); and the on-device DQN repartitioning
trainer (:mod:`repro_torch.core.rl`, :mod:`repro_torch.optim`,
:mod:`repro_torch.launch.train_rl`); the evaluation path
(:mod:`repro_torch.launch.evaluate`); the LM training path
(:mod:`repro_torch.launch.train`: ``loss_fn``, :mod:`repro_torch.distributed`,
:mod:`repro_torch.data`, :mod:`repro_torch.checkpoint`); the paper's host
DQN trainer (``train_rl --backend host``) with the fleet layer
(:mod:`repro_torch.fleet`); the sweep engine (:mod:`repro_torch.sweep`); the
durable scheduler service (:mod:`repro_torch.service`, host code); and the
simulated TPU-pod cluster day (:mod:`repro_torch.cluster`,
:mod:`repro_torch.launch.cluster_sim`,
:mod:`repro_torch.distributed.fault_tolerance`).
"""
