"""Step functions of the port (port of `repro.train`): the training step
with its state and loss, and the serving steps."""
from .step import (TrainConfig, TrainState, init_train_state, loss_fn,
                   make_serve_decode, make_serve_prefill, make_train_step,
                   train_state_from_jax, train_state_to_tree)

__all__ = ["TrainConfig", "TrainState", "init_train_state", "make_train_step",
           "make_serve_prefill", "make_serve_decode", "loss_fn",
           "train_state_from_jax", "train_state_to_tree"]
