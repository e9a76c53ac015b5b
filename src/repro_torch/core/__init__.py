"""Layer-wise PTQ: calibration statistics, the QuantEase solver, the whole-model driver."""

from repro_torch.core.rtn import rtn_quantize

__all__ = ["rtn_quantize"]
