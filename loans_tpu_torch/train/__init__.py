"""Training: train state and optimizers, the alternating, supervised, SSD
and pooled steps, the loop, checkpoints and the metrics log (counterpart of
``loans_tpu.train``)."""

from loans_tpu_torch.train.checkpoint import (
    list_snapshots,
    load_manifest,
    load_params,
    restore_params,
    restore_state,
    save_manifest,
    save_params,
    save_state,
    snapshot_name,
)
from loans_tpu_torch.train.control import CommandChannel, apply_commands
from loans_tpu_torch.train.logger import MetricsLog
from loans_tpu_torch.train.loop import (
    Hook,
    Trainer,
    multiplicative_lr_decay,
    two_state_lr_shifter,
)
from loans_tpu_torch.train.ssd_steps import (
    SSDAdam,
    create_ssd_train_state,
    make_ssd_predict_step,
    ssd_train_step,
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
    supervised_step,
    to_float01,
)

__all__ = [
    "AdamAmsgrad",
    "AlternatingConfig",
    "CommandChannel",
    "Hook",
    "MetricsLog",
    "SSDAdam",
    "TrainState",
    "Trainer",
    "alternating_step",
    "apply_commands",
    "create_ssd_train_state",
    "create_train_state",
    "list_snapshots",
    "load_manifest",
    "load_params",
    "make_eval_step",
    "make_ssd_predict_step",
    "mse",
    "multiplicative_lr_decay",
    "pooled_step",
    "restore_params",
    "restore_state",
    "save_manifest",
    "save_params",
    "save_state",
    "snapshot_name",
    "ssd_train_step",
    "supervised_step",
    "to_float01",
    "two_state_lr_shifter",
]
