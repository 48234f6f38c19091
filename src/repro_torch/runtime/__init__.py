from .trainer import (FailureInjector, StragglerMonitor, Trainer, TrainerConfig,
                      train_step, trainable)

__all__ = ["FailureInjector", "StragglerMonitor", "Trainer", "TrainerConfig",
           "train_step", "trainable"]
