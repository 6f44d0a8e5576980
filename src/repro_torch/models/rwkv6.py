"""RWKV-6 "Finch" block: attention-free time-mix with a data-dependent
decay, and a squared-ReLU channel-mix.  [arXiv:2404.05892]

Counterpart of ``src/repro/models/rwkv6.py``.  A per-head (head size N)
state S ∈ R^{N×N} maps key channels to value channels:
    S_t[n, m] = w_t[n] * S_{t-1}[n, m] + k_t[n] * v_t[m]
    y_t[m]    = Σ_n r_t[n] * (S_{t-1}[n, m] + u[n] * k_t[n] * v_t[m])
where the decay w_t = exp(-exp(w0 + lora(x_t))) depends on the data (the
Finch contribution) and u is the per-channel bonus of the current token.

The recurrence runs token by token, as the reference's ``lax.scan``
does, in plain torch: the reference has no Pallas kernel for it.  The
bonus term (Σ_n r_t[n] u[n] k_t[n]) v_t is computed for every token
before the loop, so a step is y_t = r_t · S_{t-1} (one ``bmm``) and S_t
= w_t ∘ S_{t-1} + k_t ⊗ v_t (a product and one ``addcmul``): three
launches, out of place.  Decode is the same recurrence over one token
with the carried state.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import dense_init


def rwkv_dims(cfg: ArchConfig):
    """(heads H, head size N)."""
    N = cfg.ssm.state_size  # head size (64 for rwkv6-7b)
    return cfg.d_model // N, N


def _full(value, d, dtype, lead, device):
    return torch.full((*lead, d), value, dtype=dtype, device=device)


def rwkv_timemix_params(generator: torch.Generator, cfg: ArchConfig,
                        dtype=torch.float32, lead: Tuple[int, ...] = ()):
    """The reference's time-mix parameters; the decay lora is
    max(32, d / 64) wide.  ``lead`` stacks layers."""
    d = cfg.d_model
    lora = max(32, d // 64)
    dev = generator.device

    def init(d_in, d_out, **kw):
        return dense_init(d_in, d_out, generator, dtype, lead=lead, **kw)

    def full(value):
        return _full(value, d, dtype, lead, dev)

    return {
        # token-shift interpolation weights (the static part)
        "mix_r": full(0.5), "mix_k": full(0.5), "mix_v": full(0.5),
        "mix_w": full(0.5), "mix_g": full(0.5),
        "wr": init(d, d), "wk": init(d, d), "wv": init(d, d),
        "wg": init(d, d),
        "w_decay_a": init(d, lora),          # decay lora in
        "w_decay_b": init(lora, d),          # decay lora out
        "decay_base": full(-0.6),            # w0
        "bonus_u": full(0.3),
        "out_gn_scale": full(1.0),           # per-head group norm
        "out_gn_bias": full(0.0),
        "wo": init(d, d, scale=1.0 / math.sqrt(d)),
    }


def _token_shift(x, prev):
    """x: (B, S, d); prev: (B, d), the token before x (zeros at t = 0).
    Returns x shifted right by one along S."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _group_norm(p, y, H: int, N: int, eps: float = 1e-5):
    """Per-head normalisation of y (B, S, H·N) with the population
    variance (``jnp.var``), then the affine."""
    B, S, d = y.shape
    yh = y.reshape(B, S, H, N).float()
    mu = torch.mean(yh, dim=-1, keepdim=True)
    var = torch.var(yh, dim=-1, keepdim=True, correction=0)
    yh = ((yh - mu) * torch.rsqrt(var + eps)).reshape(B, S, d)
    return (yh * p["out_gn_scale"].float()
            + p["out_gn_bias"].float()).to(y.dtype)


def wkv_scan(wrkv, state=None):
    """The recurrence over S tokens.  wrkv: w, r, k, v stacked, time
    before batch, (4, S, B, H, N); state: (B, H, N, N) or None (zeros);
    all f32.  Returns (y (B, S, H, N) without the bonus term, the last
    state, a new tensor).

    It is a torch function, so a torch function mode may run it its own
    way: the dry run runs it on each device's batch rows and heads
    (``launch/dryrun.py``).  Its ops suit a DTensor of the dry run too:
    one stack lays the four inputs out alike (w first: DTensor then
    keeps r, k and v's heads sharded), and the zero state takes r's
    layout, so every step runs on the local shards."""
    if has_torch_function((wrkv, state)):
        return handle_torch_function(wkv_scan, (wrkv, state), wrkv, state)
    _, S, B, H, N = wrkv.shape
    w, r, k, v = wrkv.reshape(4, S, B * H, N).unbind(0)
    if state is None:
        s = torch.zeros_like(r[0].unsqueeze(-1).expand(B * H, N, N))
    else:
        s = state.reshape(B * H, N, N)
    ys = []
    # S views a tensor, a unit axis where the step's product wants it
    for r_t, k_t, v_t, w_t in zip(r.unsqueeze(2).unbind(0),
                                  k.unsqueeze(3).unbind(0),
                                  v.unsqueeze(2).unbind(0),
                                  w.unsqueeze(3).unbind(0)):
        ys.append(torch.bmm(r_t, s))                     # (B·H, 1, N)
        s = torch.addcmul(s * w_t, k_t, v_t)             # w ∘ S + k ⊗ v
    y = torch.cat(ys, dim=1).reshape(B, H, S, N).transpose(1, 2)
    return y, s.reshape(B, H, N, N)


def rwkv_timemix(p, x, cfg: ArchConfig, state=None, shift_prev=None):
    """x: (B, S, d); state: (B, H, N, N); shift_prev: (B, d).
    Returns (out, (state, last x)); the state is a new tensor."""
    B, S, d = x.shape
    H, N = rwkv_dims(cfg)
    if shift_prev is None:
        shift_prev = x.new_zeros(B, d)
    xp = _token_shift(x, shift_prev)

    def mixed(name):
        m = p[f"mix_{name}"]
        return x * m + xp * (1.0 - m)

    r = (mixed("r") @ p["wr"]).reshape(B, S, H, N).float()
    k = (mixed("k") @ p["wk"]).reshape(B, S, H, N).float()
    v = (mixed("v") @ p["wv"]).reshape(B, S, H, N).float()
    g = mixed("g") @ p["wg"]
    # the data-dependent decay (Finch): w in (0, 1)
    dd = torch.tanh(mixed("w") @ p["w_decay_a"]) @ p["w_decay_b"]
    w = torch.exp(-torch.exp((p["decay_base"] + dd).float())).reshape(
        B, S, H, N)
    u = p["bonus_u"].float().reshape(H, N)

    bonus = (r * u * k).sum(-1, keepdim=True) * v        # (B, S, H, N)
    y, s = wkv_scan(torch.stack([t.transpose(0, 1) for t in (w, r, k, v)]),
                    None if state is None else state.float())
    y = y + bonus
    y = _group_norm(p, y.reshape(B, S, d).to(x.dtype), H, N)
    y = y * F.silu(g)
    return y @ p["wo"], (s, x[:, -1, :])


def rwkv_channelmix_params(generator: torch.Generator, cfg: ArchConfig,
                           dtype=torch.float32, lead: Tuple[int, ...] = ()):
    d, f = cfg.d_model, cfg.d_ff
    dev = generator.device
    return {
        "mix_k": _full(0.5, d, dtype, lead, dev),
        "mix_r": _full(0.5, d, dtype, lead, dev),
        "w_in": dense_init(d, f, generator, dtype, lead=lead),
        "w_rec": dense_init(d, d, generator, dtype, lead=lead),
        "w_out": dense_init(f, d, generator, dtype,
                            scale=1.0 / math.sqrt(f), lead=lead),
    }


def rwkv_channelmix(p, x, shift_prev=None):
    """Returns (out, last x)."""
    B, S, d = x.shape
    if shift_prev is None:
        shift_prev = x.new_zeros(B, d)
    xp = _token_shift(x, shift_prev)
    xk = x * p["mix_k"] + xp * (1.0 - p["mix_k"])
    xr = x * p["mix_r"] + xp * (1.0 - p["mix_r"])
    h = torch.square(torch.relu(xk @ p["w_in"])) @ p["w_out"]
    return torch.sigmoid(xr @ p["w_rec"]) * h, x[:, -1, :]
