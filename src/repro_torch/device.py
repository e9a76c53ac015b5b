"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import functools

import torch

__all__ = ["resolve_device", "require_on_device", "sm_count"]


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``, refusing CUDA when there is none.

    Also pins full-fp32 matrix products: with TF32 off, every plain fp32
    product on the card runs in fp32, as the JAX reference does.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def require_on_device(t: torch.Tensor, device="cuda", what: str = "params") -> torch.device:
    """``resolve_device(device)``, refusing ``t`` unless it lives there, so
    an entry point never runs silently on another device than asked."""
    dev = resolve_device(device)
    if t.device.type != dev.type or (dev.index is not None and t.device.index != dev.index):
        raise ValueError(
            f"{what} live on {t.device}, but device={str(dev)!r} was asked for; "
            f"move them there or pass device={t.device.type!r}"
        )
    return dev


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the kernel
    planners size their grids by it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count
