"""The training step (port of `repro/training`)."""
from .train_step import (TrainState, init_train_state, loss_and_grads,
                         make_abstract_state, make_train_step,
                         state_shardings, train_state_from_reference)
