from .adamw import (AdamWConfig, TrainState, adamw_update, global_norm,
                    init_train_state)

__all__ = ["AdamWConfig", "TrainState", "adamw_update", "global_norm",
           "init_train_state"]
