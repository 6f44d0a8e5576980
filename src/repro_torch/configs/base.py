"""Architecture & run configuration of the sequence track.

A copy of ``src/repro/configs/base.py`` (pure data), so that the port
imports nothing of the JAX package; ``get_config`` loads the port's own
copies of the ten config files.

Every assigned architecture gets one ``<id>.py`` in this package exporting
``CONFIG: ArchConfig`` built from the exact public spec (source cited in the
file).  ``reduced()`` derives the CPU-smoke-test variant (2 layers,
d_model<=512, <=4 experts) from the same family so the smoke test exercises
the identical code path as the full config.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0          # routed experts
    top_k: int = 0
    expert_d_ff: int = 0          # per-expert FFN hidden
    num_shared_experts: int = 0   # DeepSeek-style always-on shared experts
    dense_d_ff: int = 0           # Arctic-style dense residual FFN alongside MoE
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    state_size: int = 0           # per-head SSM state (Mamba2) / rwkv head size
    num_ssm_heads: int = 0
    conv_width: int = 4           # Mamba2 local conv
    chunk_size: int = 256         # chunked-scan block length
    expand: int = 2               # Mamba2 inner expansion


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    # attention
    attn_kinds: Tuple[str, ...] = ("full",)   # per-layer pattern, cycled
    rope_theta: float = 10_000.0
    use_mla: bool = False
    mla_kv_lora_rank: int = 512
    mla_q_lora_rank: int = 1536
    mla_rope_head_dim: int = 64
    mla_nope_head_dim: int = 128
    mla_v_head_dim: int = 128
    # norms / misc
    norm: str = "rmsnorm"         # rmsnorm | layernorm | nonparam_ln (olmo)
    act: str = "silu"             # silu (swiglu) | gelu (plain mlp)
    tie_embeddings: bool = False
    # family extras
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    # hybrid (zamba2): pattern of block kinds cycled over layers
    block_pattern: Tuple[str, ...] = ()        # e.g. ("mamba",)*5 + ("shared_attn",)
    # enc-dec (whisper)
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1_500               # whisper frame count after conv stub
    # vlm (qwen2-vl)
    mrope_sections: Tuple[int, ...] = ()       # M-RoPE (t, h, w) split of head_dim/2
    vision_prefix_len: int = 0                 # stub patch-embedding prefix tokens
    # sliding window (used for long_500k dense variant & any swa layers)
    sliding_window: int = 8_192
    # GST (paper technique) integration for train shape
    gst_num_segments: int = 8                  # J
    gst_backprop_segments: int = 1             # S
    gst_keep_prob: float = 0.5                 # p  (SED, Eq. 1)
    gst_num_classes: int = 16                  # property-head output dim
    gst_table_size: int = 4_096                # n_graphs rows in historical table
    # citation
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm" and self.num_heads == 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, length == num_layers."""
        if self.block_pattern:
            pat = self.block_pattern
            return tuple(pat[i % len(pat)] for i in range(self.num_layers))
        if self.family == "ssm":
            return ("rwkv",) * self.num_layers
        if self.family == "moe":
            return ("moe",) * self.num_layers
        return ("attn",) * self.num_layers

    def supports_shape(self, shape: InputShape) -> bool:
        if shape.name == "long_500k":
            # enc-dec decoder context is bounded by design -> documented skip
            return not self.is_encoder_decoder
        return True


def reduced(cfg: ArchConfig) -> ArchConfig:
    """CPU smoke-test variant of the same family (2L, d_model<=512, <=4 experts)."""
    d_model = min(cfg.d_model, 256)
    heads = min(cfg.num_heads, 4) if cfg.num_heads else 0
    kv = min(cfg.num_kv_heads, heads) if heads else 0
    kv = max(kv, 1) if heads else 0
    moe = cfg.moe
    if moe.num_experts:
        moe = replace(
            moe,
            num_experts=min(moe.num_experts, 4),
            top_k=min(moe.top_k, 2),
            expert_d_ff=min(moe.expert_d_ff, 512),
            dense_d_ff=min(moe.dense_d_ff, 512) if moe.dense_d_ff else 0,
            num_shared_experts=min(moe.num_shared_experts, 1),
        )
    ssm = cfg.ssm
    if ssm.state_size or cfg.family in ("ssm", "hybrid"):
        ssm = replace(
            ssm,
            state_size=min(ssm.state_size or 16, 16),
            num_ssm_heads=min(ssm.num_ssm_heads or 4, 4),
            chunk_size=64,
        )
    pattern = cfg.block_pattern
    if pattern:
        # keep one of each kind so the smoke test covers every block type
        kinds = []
        for k in pattern:
            if k not in kinds:
                kinds.append(k)
        pattern = tuple(kinds[:2]) if len(kinds) >= 2 else tuple(kinds)
    return replace(
        cfg,
        num_layers=2,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 1024),
        head_dim=64 if heads else 0,
        moe=moe,
        ssm=ssm,
        block_pattern=pattern,
        num_encoder_layers=2 if cfg.is_encoder_decoder else 0,
        encoder_seq_len=64 if cfg.is_encoder_decoder else cfg.encoder_seq_len,
        mla_kv_lora_rank=min(cfg.mla_kv_lora_rank, 64),
        mla_q_lora_rank=min(cfg.mla_q_lora_rank, 64),
        mla_rope_head_dim=32 if cfg.use_mla else cfg.mla_rope_head_dim,
        mla_nope_head_dim=32 if cfg.use_mla else cfg.mla_nope_head_dim,
        mla_v_head_dim=32 if cfg.use_mla else cfg.mla_v_head_dim,
        mrope_sections=(16, 8, 8) if cfg.mrope_sections else (),
        vision_prefix_len=min(cfg.vision_prefix_len, 16),
        sliding_window=128,
        gst_table_size=64,
        gst_num_segments=4,
        gst_num_classes=5,
        source=cfg.source,
    )


ARCH_IDS = (
    "arctic-480b",
    "internlm2-1.8b",
    "internlm2-20b",
    "zamba2-1.2b",
    "olmo-1b",
    "rwkv6-7b",
    "deepseek-v3-671b",
    "deepseek-coder-33b",
    "whisper-large-v3",
    "qwen2-vl-7b",
)

_MOD_NAMES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MOD_NAMES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MOD_NAMES[arch_id]}")
    return mod.CONFIG


def all_configs() -> dict:
    return {a: get_config(a) for a in ARCH_IDS}
