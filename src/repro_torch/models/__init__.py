"""Model components of the port: the shared pieces (``common.py``), the
sequence track's decoder-only transformer (``blocks.py``,
``transformer.py``, with ``moe.py`` and ``mla.py``), the encoder-decoder
(``encdec.py``) and the uniform API (``registry.py``): the dense, MoE,
VLM and encoder-decoder families so far."""
from repro_torch.models.registry import Model, build_model

__all__ = ["build_model", "Model"]
