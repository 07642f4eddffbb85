"""Atomic, resumable, device-independent checkpointing."""

from repro_torch.checkpoint.store import (
    latest_step,
    prune,
    restore,
    restore_pytree,
    save,
    save_pytree,
)
