"""Model components of the port: the shared pieces (``common.py``) and the
sequence track's decoder-only transformer (``blocks.py``,
``transformer.py``, ``registry.py``), the dense family so far."""
from repro_torch.models.registry import Model, build_model

__all__ = ["build_model", "Model"]
