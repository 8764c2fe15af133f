"""Checkpoint/resume of training state (the port's ``TrainCheckpointer``;
model-weight IO lives in ``models/loader.py``)."""

from pilottai_tpu_torch.checkpoint.train_io import TrainCheckpointer

__all__ = ["TrainCheckpointer"]
