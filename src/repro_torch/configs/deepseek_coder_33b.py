"""DeepSeek-Coder 33B dense (llama-arch) config. [arXiv:2401.14196]

Assigned spec: 62L d_model=7168 56H (GQA kv=8) d_ff=19200 vocab=32256.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=19200,
    vocab_size=32256,
    head_dim=128,
    norm="rmsnorm",
    act="silu",
    rope_theta=100_000.0,
    source="arXiv:2401.14196",
)
