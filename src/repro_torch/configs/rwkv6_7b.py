"""RWKV-6 "Finch" 7B attention-free config. [arXiv:2404.05892]

Assigned spec: 32L d_model=4096 (attn-free) d_ff=14336 vocab=65536 —
data-dependent decay time-mix + channel-mix blocks, head size 64.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=0,              # attention-free
    num_kv_heads=0,
    d_ff=14336,
    vocab_size=65536,
    norm="layernorm",
    act="relu_sq",            # rwkv channel-mix uses squared relu
    ssm=SSMConfig(state_size=64, num_ssm_heads=64, chunk_size=256),
    block_pattern=("rwkv",),
    source="arXiv:2404.05892",
)
