from .adamw import AdamWConfig, adamw_update, global_norm, init_opt_state, lr_at

__all__ = ["AdamWConfig", "adamw_update", "global_norm", "init_opt_state", "lr_at"]
