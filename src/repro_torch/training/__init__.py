"""Training: AdamW with global-norm clipping and a cosine schedule
(``optimizer``), the train step and the host loop (``loop``)."""
from repro_torch.training.loop import make_train_step, train
from repro_torch.training.optimizer import (
    AdamWConfig,
    OptState,
    adamw_update,
    global_norm,
    init_opt_state,
    schedule,
)

__all__ = ["AdamWConfig", "OptState", "adamw_update", "global_norm",
           "init_opt_state", "make_train_step", "schedule", "train"]
