from .manager import (  # noqa: F401
    CheckpointManager, save_pytree, restore_pytree, restore_flat)
