from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager, latest_step, restore_pytree, save_pytree)
