"""Qwen2-VL 7B VLM backbone config (M-RoPE). [arXiv:2409.12191]

Assigned spec: 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064 —
M-RoPE (temporal/height/width rotary sections), dynamic resolution.  The
ViT vision encoder + projector are a STUB per the assignment:
``input_specs()`` supplies precomputed patch embeddings prefixed to text.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    norm="rmsnorm",
    act="silu",
    mrope_sections=(16, 24, 24),   # t/h/w split of head_dim//2 = 64
    vision_prefix_len=256,          # stub patch-embedding prefix tokens
    rope_theta=1_000_000.0,
    source="arXiv:2409.12191",
)
