from .losses import cross_entropy_loss  # noqa: F401
from .train_step import TrainState, make_train_step, init_train_state  # noqa: F401
