"""Model registry — the reference's uniform API over the architectures,
for the dense family so far.

Counterpart of ``src/repro/models/registry.py``.  Model methods:
    init(generator, dtype)                  -> params
    forward(params, batch_inputs)           -> hidden (B, S, d_model)
    logits(params, hidden)                  -> (B, S, vocab)
    encode_segment(params, seg_inputs)      -> ((B, d_model), aux)  GST's F
    prefill(params, batch_inputs)           -> (last_logits, caches)
    init_cache(batch, cache_len, dtype)     -> caches
    decode_step(params, token, caches, pos) -> (logits, caches)

``batch_inputs`` is a dict {"tokens": (B, S) integer tensor or array}.
``window`` (sliding-window attention) is a call-time option, as in the
reference.  A ``Model`` runs on its ``device``; with ``use_kernels`` the
causal attention of every full-sequence pass (forward, encode_segment,
prefill) launches the hand-written sliding-window attention kernel there
(its plain version on the CPU).  Decode runs plain torch: the reference
has no kernel there.  The moe, ssm, hybrid, audio and vlm families wait
for ROADMAP A4 and raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.models.common import _A4


@dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    use_kernels: bool = True
    device: torch.device = torch.device("cuda")

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    # -- init -------------------------------------------------------------
    def init(self, generator: torch.Generator, dtype=torch.float32):
        """Random weights drawn from ``generator`` on its device (a
        generator on the card draws the 1.9 B weights of internlm2-1.8b
        in seconds), moved to the model's device."""
        params = transformer.init_params(generator, self.cfg, dtype)
        if generator.device != self.device:
            params = _to(params, self.device)
        return params

    # -- full-sequence forward (train / GST segment encode) ---------------
    def forward(self, params, inputs: Dict[str, Any], *, window: int = 0):
        return self.forward_with_aux(params, inputs, window=window)[0]

    def forward_with_aux(self, params, inputs: Dict[str, Any], *,
                         window: int = 0):
        hidden, _, aux = transformer.forward_hidden(
            params, self.cfg, self._tokens(inputs["tokens"]),
            patches=inputs.get("patches"), mode="full", window=window,
            use_kernels=self.use_kernels)
        return hidden, aux

    def logits(self, params, hidden):
        return transformer.lm_logits(params, self.cfg, hidden)

    # -- GST backbone F: segment -> embedding ------------------------------
    def encode_segment(self, params, inputs: Dict[str, Any]):
        """Mean-pooled final hidden state = segment embedding h_j (GST's F)."""
        hidden, aux = self.forward_with_aux(params, inputs)
        return torch.mean(hidden, dim=1), aux

    # -- serving ------------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int, dtype=torch.float32):
        return transformer.init_cache(self.cfg, batch, cache_len, dtype,
                                      self.device)

    def prefill(self, params, inputs: Dict[str, Any], *, window: int = 0):
        hidden, caches, _ = transformer.forward_hidden(
            params, self.cfg, self._tokens(inputs["tokens"]),
            patches=inputs.get("patches"), mode="full", window=window,
            emit_cache=True, use_kernels=self.use_kernels)
        logits = transformer.lm_logits(params, self.cfg, hidden[:, -1:])
        return logits, caches

    def decode_step(self, params, token, caches, cache_pos, *,
                    window: int = 0, ring: bool = False):
        """One token through the model: (logits, caches).  The new key and
        value are written into ``caches`` in place, and ``caches`` is
        returned (the reference returns a new tree)."""
        hidden, new_caches, _ = transformer.forward_hidden(
            params, self.cfg, self._tokens(token), mode="decode",
            caches=caches,
            cache_pos=torch.as_tensor(cache_pos, device=self.device),
            window=window, ring=ring)
        return transformer.lm_logits(params, self.cfg, hidden), new_caches


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def build_model(cfg: ArchConfig, use_kernels: bool = True,
                device="cuda") -> Model:
    """The model of ``cfg`` on ``device`` (raises for ``cuda`` without a
    card).  Only the dense family is ported."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"encoder-decoder models ({cfg.name}) {_A4}")
    if cfg.family != "dense":
        raise NotImplementedError(f"the {cfg.family} family ({cfg.name}) {_A4}")
    return Model(cfg, use_kernels, resolve_device(device))
