"""WebANNS on PyTorch and CUDA: the port of :mod:`repro` to an NVIDIA H100.

The package mirrors ``repro``'s layout module for module (``core/``,
``kernels/``, ``data/``) and never imports it or JAX: the numpy-only
modules it needs are copied. The kernels on the query path are written by
hand for Hopper in ``csrc/`` and built with ``nvcc`` at first use
(:mod:`repro_torch.kernels._build`); on a CPU tensor each op runs its
plain PyTorch version instead.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
