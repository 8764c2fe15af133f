"""Training on one device over the shared transformer trunk (slice P11)."""

from pilottai_tpu_torch.train.trainer import (
    TrainConfig,
    Trainer,
    TrainState,
    make_optimizer,
    next_token_loss,
    synthetic_batches,
)

__all__ = [
    "TrainConfig",
    "TrainState",
    "Trainer",
    "make_optimizer",
    "next_token_loss",
    "synthetic_batches",
]
