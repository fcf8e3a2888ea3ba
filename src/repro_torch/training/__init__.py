"""Training: AdamW, the LR schedule, the train step with gradient
accumulation, npz checkpoints (the port of ``repro.training``)."""

from .checkpoint import load_checkpoint, save_checkpoint
from .optimizer import AdamW, AdamWState
from .train_loop import make_lr_schedule, make_train_step

__all__ = ["load_checkpoint", "save_checkpoint", "AdamW", "AdamWState",
           "make_lr_schedule", "make_train_step"]
