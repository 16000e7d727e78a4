from .checkpointer import Checkpointer, CheckpointMeta

__all__ = ["Checkpointer", "CheckpointMeta"]
