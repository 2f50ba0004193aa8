"""Training of the port: losses, the trainer, checkpoints."""
from .losses import relative_h1, relative_l2  # noqa: F401
from .trainer import Trainer, TrainerConfig  # noqa: F401
from . import checkpoint  # noqa: F401
