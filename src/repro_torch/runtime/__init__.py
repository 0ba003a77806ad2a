"""Training runtime (PyTorch port): fault-tolerant loop, straggler watch,
write-behind checkpoints, restore on start."""

from .trainer import StepEvent, Trainer, TrainerConfig

__all__ = ["StepEvent", "Trainer", "TrainerConfig"]
