"""Training: train state and optimizer, the alternating and pooled steps,
the loop, checkpoints and the metrics log (counterpart of
``loans_tpu.train``)."""

from loans_tpu_torch.train.checkpoint import (
    list_snapshots,
    load_manifest,
    load_params,
    restore_state,
    save_manifest,
    save_params,
    save_state,
    snapshot_name,
)
from loans_tpu_torch.train.logger import MetricsLog
from loans_tpu_torch.train.loop import (
    Hook,
    Trainer,
    multiplicative_lr_decay,
    two_state_lr_shifter,
)
from loans_tpu_torch.train.state import (
    AdamAmsgrad,
    TrainState,
    create_train_state,
)
from loans_tpu_torch.train.steps import (
    AlternatingConfig,
    alternating_step,
    make_eval_step,
    mse,
    pooled_step,
    to_float01,
)

__all__ = [
    "AdamAmsgrad",
    "AlternatingConfig",
    "Hook",
    "MetricsLog",
    "TrainState",
    "Trainer",
    "alternating_step",
    "create_train_state",
    "list_snapshots",
    "load_manifest",
    "load_params",
    "make_eval_step",
    "mse",
    "multiplicative_lr_decay",
    "pooled_step",
    "restore_state",
    "save_manifest",
    "save_params",
    "save_state",
    "snapshot_name",
    "to_float01",
    "two_state_lr_shifter",
]
