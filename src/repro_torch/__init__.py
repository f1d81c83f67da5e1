"""PyTorch/CUDA port of the ``repro`` model substrate for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package keeps its module
layout and names so each counterpart is easy to find, imports ``torch`` and
never ``jax`` or ``repro``, and runs its entry points on ``cuda`` unless the
caller passes ``device="cpu"`` (:func:`repro_torch.device.resolve_device`).

Ported so far: the serving path of the dense gemma3-1b config
(:mod:`repro_torch.models`, :mod:`repro_torch.launch.serve`) and its one
kernel, flash attention, as a hand-written CUDA kernel
(:mod:`repro_torch.kernels.flash_attention`).
"""
