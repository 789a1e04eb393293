"""Optimizers (counterpart of ``repro.optim``): AdamW with moment-dtype
policies, its schedule and microbatched gradient accumulation."""
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, accumulate_grads, global_norm,
                                     init, schedule, update)
