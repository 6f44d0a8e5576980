"""Model registry — the reference's uniform API over the architectures
that the port has so far: the dense, MoE, VLM and encoder-decoder
families.

Counterpart of ``src/repro/models/registry.py``.  Model methods:
    init(generator, dtype)                  -> params
    forward(params, batch_inputs)           -> hidden (B, S, d_model)
    forward_with_aux(params, batch_inputs)  -> (hidden, aux loss)
    logits(params, hidden)                  -> (B, S, vocab)
    encode_segment(params, seg_inputs)      -> ((B, d_model), aux)  GST's F
    prefill(params, batch_inputs)           -> (last_logits, caches)
    init_cache(batch, cache_len, dtype)     -> caches
    decode_step(params, token, caches, pos) -> (logits, caches)

``batch_inputs`` is a dict {"tokens": (B, S) integer tensor or array,
optional "patches" (B, P, d) (the VLM's stub patch embeddings), optional
"frames" (B, T, d) (the encoder-decoder's stub frame embeddings)}.
``window`` (sliding-window attention) is a call-time option, as in the
reference.  A ``Model`` runs on its ``device``; with ``use_kernels`` the
causal self-attention of every full-sequence pass (forward,
encode_segment, prefill; the encoder-decoder's decoder) launches the
hand-written sliding-window attention kernel there (its plain version on
the CPU).  MLA attention, the encoder's and the cross-attention run plain
torch, as decode does: the reference has no kernel there.  The ssm and
hybrid families wait for ROADMAP A4 and raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, transformer
from repro_torch.models.common import _A4

FAMILIES = ("dense", "moe", "vlm", "audio")


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    use_kernels: bool = True
    device: torch.device = torch.device("cuda")

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _embeddings(self, inputs, name):
        """inputs[name] (patches or frames) as an f32 tensor on the
        device, or None."""
        x = inputs.get(name)
        if x is None:
            return None
        return torch.as_tensor(x, device=self.device, dtype=torch.float32)

    # -- init -------------------------------------------------------------
    def init(self, generator: torch.Generator, dtype=torch.float32):
        """Random weights drawn from ``generator`` on its device (a
        generator on the card draws billions of weights in seconds), moved
        to the model's device."""
        if self.cfg.is_encoder_decoder:
            params = encdec.init_params(generator, self.cfg, dtype)
        else:
            params = transformer.init_params(generator, self.cfg, dtype)
        if generator.device != self.device:
            params = _to(params, self.device)
        return params

    # -- full-sequence forward (train / GST segment encode) ---------------
    def forward(self, params, inputs: Dict[str, Any], *, window: int = 0):
        return self.forward_with_aux(params, inputs, window=window)[0]

    def forward_with_aux(self, params, inputs: Dict[str, Any], *,
                         window: int = 0):
        cfg = self.cfg
        if cfg.is_encoder_decoder:
            enc_out = encdec.encode(params, cfg,
                                    self._embeddings(inputs, "frames"))
            hidden, _ = encdec.decoder_forward(
                params, cfg, self._tokens(inputs["tokens"]), enc_out,
                use_kernels=self.use_kernels)
            return hidden, torch.zeros((), dtype=torch.float32,
                                       device=self.device)
        hidden, _, aux = transformer.forward_hidden(
            params, cfg, self._tokens(inputs["tokens"]),
            patches=self._embeddings(inputs, "patches"), mode="full",
            window=window, use_kernels=self.use_kernels)
        return hidden, aux

    def logits(self, params, hidden):
        if self.cfg.is_encoder_decoder:
            return hidden @ params["lm_head"]
        return transformer.lm_logits(params, self.cfg, hidden)

    # -- GST backbone F: segment -> embedding ------------------------------
    def encode_segment(self, params, inputs: Dict[str, Any]):
        """Mean-pooled final hidden state = segment embedding h_j (GST's F);
        for the encoder-decoder, the mean of the encoder's output over the
        frames (aux 0)."""
        if self.cfg.is_encoder_decoder:
            enc = encdec.encode(params, self.cfg,
                                self._embeddings(inputs, "frames"))
            return torch.mean(enc, dim=1), torch.zeros(
                (), dtype=torch.float32, device=self.device)
        hidden, aux = self.forward_with_aux(params, inputs)
        return torch.mean(hidden, dim=1), aux

    # -- serving ------------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int, dtype=torch.float32):
        """Zero caches; the encoder-decoder's self-attention cache alone
        (its cross K/V come from ``encdec.cross_kv``)."""
        if self.cfg.is_encoder_decoder:
            return encdec.init_self_cache(self.cfg, batch, cache_len, dtype,
                                          self.device)
        return transformer.init_cache(self.cfg, batch, cache_len, dtype,
                                      self.device)

    def prefill(self, params, inputs: Dict[str, Any], *, window: int = 0):
        cfg = self.cfg
        tokens = self._tokens(inputs["tokens"])
        if cfg.is_encoder_decoder:
            enc_out = encdec.encode(params, cfg,
                                    self._embeddings(inputs, "frames"))
            hidden, kv = encdec.decoder_forward(
                params, cfg, tokens, enc_out, emit_cache=True,
                use_kernels=self.use_kernels)
            logits = hidden[:, -1:] @ params["lm_head"]
            return logits, {"self": {"k": kv[0], "v": kv[1]},
                            "cross": encdec.cross_kv(params, cfg, enc_out)}
        hidden, caches, _ = transformer.forward_hidden(
            params, cfg, tokens, patches=self._embeddings(inputs, "patches"),
            mode="full", window=window, emit_cache=True,
            use_kernels=self.use_kernels)
        logits = transformer.lm_logits(params, cfg, hidden[:, -1:])
        return logits, caches

    def decode_step(self, params, token, caches, cache_pos, *,
                    extras: Optional[Dict[str, Any]] = None,
                    window: int = 0, ring: bool = False,
                    moe_cap_len: int = 0):
        """One token through the model: (logits, caches).  The new cache
        entries are written into ``caches`` in place, and ``caches`` is
        returned (the reference returns a new tree).  ``extras`` is
        accepted and unused, as in the reference.  ``moe_cap_len`` (MoE
        archs): the sequence length the per-row expert capacity is computed
        from; 0 = the allocated cache length.  Pin it to the reference
        sequence length to reproduce a teacher-forced forward when the
        cache is over-allocated."""
        cfg = self.cfg
        token = self._tokens(token)
        cache_pos = torch.as_tensor(cache_pos, device=self.device)
        if cfg.is_encoder_decoder:
            logits, new_self = encdec.decode_step(
                params, cfg, token, caches["self"], caches["cross"], cache_pos)
            return logits, {"self": new_self, "cross": caches["cross"]}
        hidden, new_caches, _ = transformer.forward_hidden(
            params, cfg, token, mode="decode", caches=caches,
            cache_pos=cache_pos, window=window, ring=ring,
            moe_cap_len=moe_cap_len)
        return transformer.lm_logits(params, cfg, hidden), new_caches


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)


def build_model(cfg: ArchConfig, use_kernels: bool = True,
                device="cuda") -> Model:
    """The model of ``cfg`` on ``device`` (raises for ``cuda`` without a
    card).  The ssm and hybrid families are not ported yet."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"the {cfg.family} family ({cfg.name}) {_A4}")
    return Model(cfg, use_kernels, resolve_device(device))
