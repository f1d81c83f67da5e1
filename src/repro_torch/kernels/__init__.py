"""Hand-written Hopper kernels, their plain PyTorch versions, and dispatch.

* :mod:`repro_torch.kernels.ref`             — plain PyTorch versions (CPU path, oracle)
* :mod:`repro_torch.kernels.flash_attention` — wrapper of ``csrc/flash_attention.cu``
* :mod:`repro_torch.kernels.mamba_scan`      — wrapper of ``csrc/mamba_scan.cu``
* :mod:`repro_torch.kernels.mlstm`           — wrapper of ``csrc/mlstm.cu``
* :mod:`repro_torch.kernels.gmm`             — wrapper of ``csrc/gmm.cu``
* :mod:`repro_torch.kernels.decode_attention` — wrapper of ``csrc/decode_attention.cu``
* :mod:`repro_torch.kernels.ops`             — ``impl`` dispatch ("auto" | "cuda" | "ref")
* :mod:`repro_torch.kernels._build`          — nvcc build of ``csrc/*.cu``, loaded with ctypes

Importing these modules needs no ``nvcc`` and no card: a kernel is built at
its first launch. The package exports ``ops`` and ``ref``, as the reference's
does; the wrapper functions stay under their modules, because a package
attribute named like a submodule (``gmm``) would hide that submodule from
``import repro_torch.kernels.gmm as m``.
"""

from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
