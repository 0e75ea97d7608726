"""Checkpoints of training state (``repro.checkpoint`` counterpart)."""
from repro_torch.checkpoint.checkpointer import (Checkpointer, restore_pytree,  # noqa: F401
                                                 save_pytree)
