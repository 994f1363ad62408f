"""Atomic, asynchronous checkpointing of the LM trainer (port of
``repro.checkpoint``)."""
from repro_torch.checkpoint.manager import CheckpointManager
