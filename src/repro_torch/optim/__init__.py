"""The optimizer: AdamW with float32 master weights and global-norm
clipping, updated in place (``adamw``)."""
from .adamw import (AdamWConfig, OptState, abstract_opt_state,
                    adamw_update, clip_by_global_norm, global_norm,
                    init_opt_state, lr_schedule)

__all__ = ["AdamWConfig", "OptState", "abstract_opt_state", "adamw_update",
           "clip_by_global_norm", "global_norm", "init_opt_state",
           "lr_schedule"]
