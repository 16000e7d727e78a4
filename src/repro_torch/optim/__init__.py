from .adamw import (OptConfig, init_opt_state, apply_updates, global_norm,
                    lr_at)

__all__ = ["OptConfig", "init_opt_state", "apply_updates", "global_norm",
           "lr_at"]
