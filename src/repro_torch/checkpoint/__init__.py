"""Asynchronous checkpoints with atomic commits (counterpart of
``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpointer import Checkpointer
