"""QuantEase in PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

This package mirrors the module layout of the JAX package ``repro`` and
computes the same functions.  It imports neither ``jax`` nor ``repro``.

Entry points take an explicit ``device`` (default ``"cuda"``) and raise when
CUDA is absent unless the caller asks for ``"cpu"``; see :mod:`.device`.
Kernels are built from ``kernels/csrc`` with ``nvcc`` at first use.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
