from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .trainer import (
    Trainer,
    TrainState,
    apply_gradients,
    create_train_state,
    eval_chunk,
    eval_step,
    make_schedule,
    train_chunk,
    train_chunk_dp,
    train_step,
)

__all__ = [
    "Trainer",
    "TrainState",
    "apply_gradients",
    "create_train_state",
    "eval_chunk",
    "eval_step",
    "latest_checkpoint",
    "load_checkpoint",
    "make_schedule",
    "save_checkpoint",
    "train_chunk",
    "train_chunk_dp",
    "train_step",
]
