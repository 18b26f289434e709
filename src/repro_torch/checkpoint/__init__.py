from repro_torch.checkpoint.store import (  # noqa: F401
    CheckpointCorruptError,
    load_checkpoint,
    save_checkpoint,
)
