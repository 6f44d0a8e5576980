"""OLMo 1B dense config (non-parametric LayerNorm). [arXiv:2402.00838]

Assigned spec: 16L d_model=2048 16H (GQA kv=16, i.e. MHA) d_ff=8192 vocab=50304.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    head_dim=128,
    norm="nonparam_ln",      # OLMo: LayerNorm without learnable affine
    act="silu",
    tie_embeddings=True,
    source="arXiv:2402.00838",
)
