"""Optimizers of the LM trainer (port of ``repro.optim``): AdamW and int8
error-feedback gradient compression."""
from repro_torch.optim import adamw, compression
