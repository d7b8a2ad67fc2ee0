from .io import CheckpointError, load, save  # noqa: F401
