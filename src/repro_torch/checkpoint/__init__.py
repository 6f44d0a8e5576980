"""Checkpoints of the port (``checkpoint/io.py``)."""
from repro_torch.checkpoint.io import (latest_checkpoint,  # noqa: F401
                                       load_checkpoint,
                                       load_store_checkpoint,
                                       save_checkpoint,
                                       save_store_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint",
           "save_store_checkpoint", "load_store_checkpoint"]
