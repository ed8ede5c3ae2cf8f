"""Training of the port (the reference's ``training`` package): the
synthetic task, AdamW, the loss and step, the loop, held-out perplexity,
and checkpoints in the reference's layout."""
from repro_torch.training.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.data import SyntheticLMTask
from repro_torch.training.train import (TrainConfig, loss_fn,
                                        make_train_step, train_loop)

__all__ = [
    "adamw_init", "adamw_update", "AdamWConfig", "TrainConfig",
    "make_train_step", "train_loop", "loss_fn", "SyntheticLMTask",
    "save_checkpoint", "load_checkpoint",
]
