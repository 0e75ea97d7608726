"""Snapshots of nested state (``repro.checkpoint`` counterpart, npz part)."""
from repro_torch.checkpoint.checkpointer import restore_pytree, save_pytree  # noqa: F401
