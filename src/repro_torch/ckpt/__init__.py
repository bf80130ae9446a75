"""Checkpoints: atomic, name-keyed ``.npz`` groups (port of ``repro/ckpt``)."""
from repro_torch.ckpt.manager import CheckpointManager  # noqa: F401
