"""Operations and bytes of the work the cells drive, counted from shapes.

A frozen copy for the benchmark: a later change to the program must not
move the yardstick.  Only useful work is counted: the matmul parameters
(the embedding is a lookup; the untied LM head is never reached by a
segment encode), causal attention over the visible (query, key) pairs,
counted once, and the property head.  Nothing is multiplied for the way a
kernel computes (3xTF32 passes, a masked full square): that is the
kernel's method, not the work.
"""
from __future__ import annotations


def matmul_params(arch: dict) -> int:
    """Weights a token multiplies through in one dense layer stack:
    q, k, v and o projections and the SwiGLU MLP, over every layer."""
    d, h, kv, hd, f = (arch["d_model"], arch["num_heads"],
                       arch["num_kv_heads"], arch["head_dim"], arch["d_ff"])
    mlp = (3 if arch["act"] in ("silu", "swiglu") else 2) * d * f
    return arch["num_layers"] * (2 * d * h * hd + 2 * d * kv * hd + mlp)


def causal_pairs(seq: int) -> int:
    """Visible (query, key) pairs of one causal sequence."""
    return seq * (seq + 1) // 2


def attention_flops(arch: dict, n_seqs: int, seq: int) -> int:
    """Forward FLOPs of causal attention (QK^T and PV) over ``n_seqs``
    sequences of ``seq`` tokens, every layer."""
    return (arch["num_layers"] * 4 * n_seqs * arch["num_heads"]
            * arch["head_dim"] * causal_pairs(seq))


def head_flops(arch: dict, n_docs: int, n_classes: int) -> int:
    """Forward FLOPs of the two-layer MLP head over ``n_docs`` pooled
    documents."""
    d = arch["d_model"]
    return 2 * n_docs * (d * d + d * n_classes)


def encode_flops(arch: dict, n_seqs: int, seq: int) -> int:
    """Forward FLOPs of encoding ``n_seqs`` segments of ``seq`` tokens."""
    return (2 * matmul_params(arch) * n_seqs * seq
            + attention_flops(arch, n_seqs, seq))


def train_step_flops(arch: dict, batch: int, sampled: int, seq: int,
                     n_classes: int) -> int:
    """One GST step: forward and backward (3x the forward) of the
    ``batch * sampled`` segments that carry a gradient, and of the head.
    Stale segments come from the table and cost no encode."""
    fwd = encode_flops(arch, batch * sampled, seq) + head_flops(
        arch, batch, n_classes)
    return 3 * fwd


def predict_flops(arch: dict, n_segments: int, seq: int,
                  n_classes: int) -> int:
    """One prediction request: every segment encoded, pooled, one head."""
    return encode_flops(arch, n_segments, seq) + head_flops(arch, 1,
                                                            n_classes)


def swa_bound_s(arch: dict, n_seqs: int, seq: int, peaks: dict) -> float:
    """Least time of one causal self-attention launch over ``n_seqs``
    sequences (one layer): the larger of its FLOPs at the TF32 peak and its
    bytes (q, k, v read once, the output written once, f32) at the HBM
    peak."""
    h, kv, hd = arch["num_heads"], arch["num_kv_heads"], arch["head_dim"]
    flops = 4 * n_seqs * h * hd * causal_pairs(seq)
    nbytes = 4 * (2 * n_seqs * seq * h * hd + 2 * n_seqs * seq * kv * hd)
    return max(flops / peaks["tf32_flops"], nbytes / peaks["hbm_bytes_per_s"])
