from repro_torch.training.loss import accuracy, cross_entropy
from repro_torch.training.step import (loss_fn, make_decode_step, make_prefill_step,
                                       make_train_step)
from repro_torch.training.train_state import TrainState, create_train_state

__all__ = ["TrainState", "accuracy", "create_train_state", "cross_entropy",
           "loss_fn", "make_decode_step", "make_prefill_step", "make_train_step"]
