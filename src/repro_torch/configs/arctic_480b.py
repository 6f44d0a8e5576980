"""Snowflake Arctic (480B MoE) backbone config.

[hf:Snowflake/snowflake-arctic-base] — dense-MoE hybrid: every layer has a
dense residual FFN in parallel with a 128-expert top-2 MoE FFN.
Assigned spec: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128e top-2 + dense residual.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,               # dense residual FFN hidden
    vocab_size=32000,
    head_dim=128,
    norm="rmsnorm",
    act="silu",
    moe=MoEConfig(
        num_experts=128,
        top_k=2,
        expert_d_ff=4864,
        dense_d_ff=4864,      # dense residual path alongside MoE
        capacity_factor=1.25,
    ),
    block_pattern=("moe",),
    rope_theta=1_000_000.0,
    source="hf:Snowflake/snowflake-arctic-base",
)
