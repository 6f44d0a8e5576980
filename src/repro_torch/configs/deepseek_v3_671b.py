"""DeepSeek-V3 671B MoE config (MLA + shared/routed experts). [arXiv:2412.19437]

Assigned spec: 61L d_model=7168 128H d_ff=2048(moe expert) vocab=129280,
MoE 256e top-8, 1 shared expert, MLA attention, MTP (multi-token prediction
head implemented as an extra scan depth-1 module).
First 3 layers are dense (d_ff=18432 in the release; we keep the assigned
expert d_ff for routed layers and the release's dense d_ff for dense layers).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,         # MLA: per-head latent KV (kv=128 in assignment)
    d_ff=18432,               # dense layers' FFN hidden (first 3 layers)
    vocab_size=129280,
    head_dim=128,
    use_mla=True,
    mla_kv_lora_rank=512,
    mla_q_lora_rank=1536,
    mla_rope_head_dim=64,
    mla_nope_head_dim=128,
    mla_v_head_dim=128,
    norm="rmsnorm",
    act="silu",
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        expert_d_ff=2048,
        num_shared_experts=1,
        capacity_factor=1.25,
    ),
    block_pattern=("dense", "dense", "dense") + ("moe",) * 58,
    rope_theta=10_000.0,
    source="arXiv:2412.19437",
)
