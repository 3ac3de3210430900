"""Optimizers and samplers of the port (counterpart of ``repro.optim``)."""
from .adamw import adamw_init, adamw_update, clip_by_global_norm, global_norm
from .schedules import cosine_schedule, linear_warmup_cosine
from .sgld import sgld_step

__all__ = ["adamw_init", "adamw_update", "global_norm", "clip_by_global_norm",
           "cosine_schedule", "linear_warmup_cosine", "sgld_step"]
