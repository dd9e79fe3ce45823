"""Optimizers (:mod:`.adamw`, exported here as the reference's package
exports it; :mod:`.adafactor`) and int8 gradient compression
(:mod:`.compress`)."""
from .adamw import (AdamWConfig, init_state, apply_updates, schedule_lr,
                    global_norm)
from . import compress

__all__ = ["AdamWConfig", "init_state", "apply_updates", "schedule_lr",
           "global_norm", "compress"]
