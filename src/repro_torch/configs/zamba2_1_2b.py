"""Zamba2 1.2B hybrid (Mamba2 + shared attention blocks). [arXiv:2411.15242]

Assigned spec: 38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000,
ssm_state=64.  Zamba2 interleaves Mamba2 blocks with a *shared* full-attention
block applied periodically (we cycle 5 mamba : 1 shared-attn).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    norm="rmsnorm",
    act="silu",
    ssm=SSMConfig(state_size=64, num_ssm_heads=32, conv_width=4, chunk_size=256, expand=2),
    block_pattern=("mamba", "mamba", "mamba", "mamba", "mamba", "shared_attn"),
    source="arXiv:2411.15242",
)
