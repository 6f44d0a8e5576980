"""Whisper large-v3 encoder-decoder backbone config. [arXiv:2212.04356]

Assigned spec: 32L d_model=1280 20H (kv=20, MHA) d_ff=5120 vocab=51866 —
enc-dec; the mel-spectrogram + conv frontend is a STUB per the assignment:
``input_specs()`` supplies precomputed frame embeddings (1500, d_model).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,            # decoder layers
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    head_dim=64,
    norm="layernorm",
    act="gelu",
    is_encoder_decoder=True,
    num_encoder_layers=32,
    encoder_seq_len=1500,
    rope_theta=0.0,           # whisper uses learned/sinusoidal positions
    source="arXiv:2212.04356",
)
