"""The training step, K steps a dispatch, the optimizer and the loss weights."""

from unopticalflow_tpu_torch.training.train_step import (
    loss_fn,
    loss_weights_from_config,
    make_multi_train_step,
    make_optimizer,
    set_capturable,
    train_step,
)

__all__ = ["loss_fn", "loss_weights_from_config", "make_multi_train_step",
           "make_optimizer", "set_capturable", "train_step"]
