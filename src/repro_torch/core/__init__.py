"""Layer-wise PTQ: calibration statistics, the QuantEase solver, the whole-model driver."""
