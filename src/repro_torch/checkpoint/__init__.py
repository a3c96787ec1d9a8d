"""Checkpoints of the port: the JAX package's npz format, read and written
without JAX (:mod:`repro_torch.checkpoint.io`)."""

from repro_torch.checkpoint.io import (  # noqa: F401
    CorruptCheckpointError,
    checkpoint_step,
    leaf_paths,
    restore_checkpoint,
    restore_ensemble,
    save_checkpoint,
)
