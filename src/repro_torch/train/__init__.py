"""Training of the port's LMs (``repro.train`` counterpart)."""
from repro_torch.train.optimizer import adafactor, adamw, make_schedule  # noqa: F401
from repro_torch.train.trainer import TrainState, make_train_step  # noqa: F401
