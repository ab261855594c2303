from dtdl_tpu_torch.ckpt.checkpoint import (  # noqa: F401
    CheckpointCorruptError, Checkpointer, load_weights, save_weights,
)
