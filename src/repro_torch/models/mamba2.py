"""Mamba2 (SSD) block: chunked-scan forward, O(1)-state decode.

Counterpart of ``src/repro/models/mamba2.py``.  [arXiv:2411.15242 uses
Mamba2 blocks; the SSD form is the Mamba2 paper's.]

State-space recurrence per head h with a scalar decay:
    a_t = exp(A_h * dt_t)                        (A_h < 0, dt_t > 0)
    H_t = a_t * H_{t-1} + dt_t * B_t ⊗ x_t       H: (d_head, d_state)
    y_t = H_t @ C_t + D_h * x_t
with B_t and C_t shared across heads (n_groups = 1).

A full sequence runs the reference's SSD matmul form: attention-like
matmuls inside each chunk, then a loop over the chunks carrying the
state.  Everything here is plain torch, as the reference runs it in jnp
and ``lax.scan``: the reference has no Pallas kernel for the scan.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import dense_init, rmsnorm


def mamba2_dims(cfg: ArchConfig):
    """(d_inner, heads, head dim P, state size N)."""
    d_inner = cfg.ssm.expand * cfg.d_model
    heads = cfg.ssm.num_ssm_heads
    assert d_inner % heads == 0, (d_inner, heads)
    return d_inner, heads, d_inner // heads, cfg.ssm.state_size


def mamba2_params(generator: torch.Generator, cfg: ArchConfig,
                  dtype=torch.float32, lead: Tuple[int, ...] = ()):
    """The reference's parameters and init constants (A = -exp(A_log) with
    A_log = log(linspace(1, 16, H)), dt_bias 0, D 1, conv_w ~ N(0, 1)·0.1,
    conv_b 0), so a random model sees the reference's decays.  ``lead``
    stacks layers."""
    d = cfg.d_model
    d_inner, H, P, N = mamba2_dims(cfg)
    dev = generator.device

    def const(v, *shape):
        return v.to(dtype=dtype, device=dev).expand(*lead, *shape).clone()

    conv_w = torch.empty(*lead, cfg.ssm.conv_width, d_inner, device=dev)
    conv_w.normal_(0.0, 1.0, generator=generator)
    # in_proj emits [x (d_inner), z (d_inner), B (N), C (N), dt (H)]
    return {
        "w_in": dense_init(d, 2 * d_inner + 2 * N + H, generator, dtype,
                           lead=lead),
        "conv_w": conv_w.mul_(0.1).to(dtype),
        "conv_b": const(torch.zeros(()), d_inner),
        "dt_bias": const(torch.zeros(()), H),
        "A_log": const(torch.log(torch.linspace(1.0, 16.0, H)), H),
        "D": const(torch.ones(()), H),
        "out_norm": {"scale": const(torch.ones(()), d_inner)},
        "w_out": dense_init(d_inner, d, generator, dtype,
                            scale=1.0 / math.sqrt(d_inner), lead=lead),
    }


def in_widths(cfg: ArchConfig):
    """The widths of the input projection's five outputs, in its column
    order: xs (d_inner), gate (d_inner), B (N), C (N), dt (H)."""
    d_inner, H, P, N = mamba2_dims(cfg)
    return d_inner, d_inner, N, N, H


def _split_in(p, x, cfg: ArchConfig):
    """(xs, gate, B, C, dt) of the input projection; dt = softplus(dt +
    dt_bias) in f32.  ``F.softplus`` returns its input above 20, where
    ``jax.nn.softplus`` adds log1p(exp(-x)): at most 2.1e-9 apart.  A
    torch function, so a torch function mode may run it its own way: the
    dry run gives each output its own shard (``launch/dryrun.py``)."""
    operands = (x, p["w_in"], p["dt_bias"])
    if has_torch_function(operands):
        return handle_torch_function(_split_in, operands, p, x, cfg)
    return split_in_ops(p, x, cfg)


def split_in_ops(p, x, cfg: ArchConfig):
    """The ops of ``_split_in`` (see there), as plain ops."""
    return split_z(x @ p["w_in"], p["dt_bias"], in_widths(cfg))


def split_z(z, dt_bias, widths):
    """The input projection's output z cut into its five outputs of
    ``widths`` (:func:`in_widths`, or a shard's), dt through the
    softplus with its heads' ``dt_bias``."""
    xs, gate, Bm, Cm, dt = torch.split(z, list(widths), dim=-1)
    return xs, gate, Bm, Cm, F.softplus(dt.float() + dt_bias.float())


def _causal_conv(p, xs, conv_state=None):
    """Depthwise causal conv of width W, then silu.  xs: (B, S, d_inner);
    conv_state: (B, W-1, d_inner), the inputs before xs (zeros where
    None).  Returns (out, the last W-1 inputs: the next conv_state)."""
    W = p["conv_w"].shape[0]
    if conv_state is None:
        conv_state = xs.new_zeros(xs.shape[:1] + (W - 1,) + xs.shape[2:])
    xp = torch.cat([conv_state.to(xs.dtype), xs], dim=1)
    new_state = xp[:, -(W - 1):] if W > 1 else None
    S = xs.shape[1]
    out = sum(xp[:, i:i + S] * p["conv_w"][i] for i in range(W))
    return F.silu(out + p["conv_b"]), new_state


def ssd_chunked(xs, Bm, Cm, dt, A, init_state=None, chunk: int = 256):
    """Chunked SSD scan.

    xs: (B, S, H, P); Bm/Cm: (B, S, N); dt: (B, S, H); A: (H,) negative.
    Returns y: (B, S, H, P) and the final state (B, H, P, N).  As in the
    reference, S must be a multiple of min(chunk, S).  Each three-operand
    product of the reference is contracted a pair at a time (a batched
    matmul over s or n), never through a (B, nc, q, q, H, P) tensor.
    """
    Bsz, S, H, P = xs.shape
    N = Bm.shape[-1]
    chunk = min(chunk, S)
    assert S % chunk == 0, (S, chunk)
    nc = S // chunk

    xs_c = xs.reshape(Bsz, nc, chunk, H, P).float()
    B_c = Bm.reshape(Bsz, nc, chunk, N).float()
    C_c = Cm.reshape(Bsz, nc, chunk, N).float()
    dt_c = dt.reshape(Bsz, nc, chunk, H).float()

    cum = torch.cumsum(A * dt_c, dim=2)                 # L_t (B,nc,q,H) <= 0
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # L_t - L_s (B,nc,t,s,H)
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=xs.device).tril()
    # the mask comes before exp: exp of the (positive, huge) entries above
    # the diagonal would overflow, and inf * 0 is NaN in a gradient
    decay = torch.exp(torch.where(tri[None, None, :, :, None], seg, -1e30))

    # intra-chunk: y[t] = sum_{s<=t} (C_t.B_s) decay[t,s] dt_s x_s
    cb = C_c @ B_c.transpose(-1, -2)                     # (B,nc,t,s)
    m = (cb[..., None] * decay).permute(0, 1, 4, 2, 3)   # (B,nc,H,t,s)
    xdt = (xs_c * dt_c[..., None]).permute(0, 1, 3, 2, 4)  # (B,nc,H,s,P)
    y_intra = (m @ xdt).permute(0, 1, 3, 2, 4)           # (B,nc,t,H,P)

    # each chunk's contribution to the state at its end
    w_end = dt_c * torch.exp(cum[:, :, -1:, :] - cum)    # (B,nc,s,H)
    chunk_state = torch.einsum("bcshp,bcsn->bchpn", xs_c * w_end[..., None],
                               B_c)
    chunk_decay = torch.exp(cum[:, :, -1, :])            # (B,nc,H)

    # the state entering each chunk (the reference's lax.scan)
    state = (torch.zeros(Bsz, H, P, N, dtype=torch.float32, device=xs.device)
             if init_state is None else init_state.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(state)
        state = state * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                # (B,nc,H,P,N)

    # inter-chunk: y[t] += C_t . (exp(L_t) * h_prev)
    y_inter = (torch.einsum("bctn,bchpn->bcthp", C_c, h_prevs)
               * torch.exp(cum)[..., None])
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y.to(xs.dtype), state


def mamba2_forward(p, x, cfg: ArchConfig, init_state=None, conv_state=None):
    """Full-sequence forward.  x: (B, S, d_model).
    Returns (out, (conv_state, ssm_state))."""
    d_inner, H, P, N = mamba2_dims(cfg)
    Bsz, S, _ = x.shape
    xs, gate, Bm, Cm, dt = _split_in(p, x, cfg)
    xs, new_conv = _causal_conv(p, xs, conv_state)
    A = -torch.exp(p["A_log"].float())
    y, state = ssd_chunked(xs.reshape(Bsz, S, H, P), Bm, Cm, dt, A,
                           init_state=init_state, chunk=cfg.ssm.chunk_size)
    y = y + (p["D"].float()[None, None, :, None]
             * xs.reshape(y.shape).float()).to(y.dtype)
    y = rmsnorm(p["out_norm"], y.reshape(Bsz, S, d_inner)) * F.silu(gate)
    return y @ p["w_out"], (new_conv, state)


def mamba2_decode(p, x, conv_state, ssm_state, cfg: ArchConfig):
    """Single-token decode.  x: (B, 1, d_model); conv_state: (B, W-1,
    d_inner); ssm_state: (B, H, P, N).  Returns (out, (conv_state,
    ssm_state)), both new tensors: the caller writes them into its
    cache."""
    d_inner, H, P, N = mamba2_dims(cfg)
    Bsz = x.shape[0]
    xs, gate, Bm, Cm, dt = _split_in(p, x, cfg)
    xs, new_conv = _causal_conv(p, xs, conv_state)
    A = -torch.exp(p["A_log"].float())
    xs_h = xs.reshape(Bsz, H, P).float()
    dt1 = dt[:, 0]                                       # (B, H)
    a = torch.exp(A[None] * dt1)                         # (B, H)
    upd = (xs_h * dt1[..., None])[..., None] * Bm[:, 0].float()[:, None, None, :]
    new_state = ssm_state.float() * a[:, :, None, None] + upd
    y = (new_state @ Cm[:, 0].float()[:, None, :, None])[..., 0]  # (B,H,P)
    y = y + p["D"].float()[None, :, None] * xs_h
    y = y.reshape(Bsz, 1, d_inner).to(x.dtype)
    y = rmsnorm(p["out_norm"], y) * F.silu(gate)
    return y @ p["w_out"], (new_conv, new_state.to(ssm_state.dtype))
