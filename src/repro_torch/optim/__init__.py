"""Optimizers and samplers of the port (counterpart of ``repro.optim``)."""
from .adamw import (adamw_init, adamw_update, adamw_update_,
                    clip_by_global_norm, global_norm)
from .schedules import cosine_schedule, linear_warmup_cosine
from .sgld import sgld_step

__all__ = ["adamw_init", "adamw_update", "adamw_update_", "global_norm",
           "clip_by_global_norm", "cosine_schedule", "linear_warmup_cosine",
           "sgld_step"]
