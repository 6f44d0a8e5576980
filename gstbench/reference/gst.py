"""GST-EFD's step and prediction around the encoder, from the paper's
equations (arXiv:2305.12322, Algorithms 1-2, Eq. 1) and AdamW.

Eq. 1 with keep probability p, S sampled of J_i segments: a sampled
(fresh) segment weighs p + (1 - p) J_i / S; a stale one 1 where its SED
draw u <= p and it was ever written, else 0; ⊕ is the weighted sum over
J_i.  The head is relu(h W1 + b1) W2 + b2 under cross-entropy.  The
gradient is clipped to global norm ``max_grad_norm``; AdamW puts eps
outside the root of the bias-corrected second moment and decays the
weights decoupled: p -= lr (m̂ / (√v̂ + eps) + wd p).  The step writes the
fresh embeddings into the table.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from gstbench.reference.model import encode
from gstbench.reference.precision import mm

B1, B2, EPS = 0.9, 0.999, 1e-8


def head(hd: Dict[str, torch.Tensor], h, mode: str):
    return mm(torch.relu(mm(h, hd["w1"], mode) + hd["b1"]), hd["w2"],
              mode) + hd["b2"]


def eta(idx, u, initialized, keep_prob: float, sampled: int):
    """Eq. 1's weights (B, J): every segment valid."""
    B, J = u.shape
    fresh = F.one_hot(idx.long(), J).sum(1).bool()
    stale = (u <= keep_prob) & initialized
    w_fresh = keep_prob + (1.0 - keep_prob) * J / sampled
    return torch.where(fresh, torch.full_like(u, w_fresh), stale.float())


def pooled(h_fresh, idx, table_rows, weights):
    """⊕: the table's rows with the fresh embeddings in their slots,
    weighted by Eq. 1 and averaged over J."""
    B, J, d = table_rows.shape
    rows = torch.arange(B, device=idx.device)[:, None].expand_as(idx)
    comb = table_rows.index_put((rows, idx), h_fresh)
    return (weights[..., None] * comb).sum(1) / J


class Trainer:
    """Three of the program's steps, followed from the same weights,
    table, documents and draws.  ``w`` and ``hd`` are the backbone's and
    the head's leaves by name, trained in place."""

    def __init__(self, arch, gst, w, hd, table_emb, table_init, mode="f32"):
        self.arch, self.gst, self.mode = arch, gst, mode
        self.w, self.hd = w, hd
        self.emb, self.init = table_emb, table_init
        self.names = list(w) + [f"head.{k}" for k in hd]
        self.leaves = list(w.values()) + list(hd.values())
        self.m = [torch.zeros_like(p) for p in self.leaves]
        self.v = [torch.zeros_like(p) for p in self.leaves]
        self.t = 0

    def step(self, tokens, labels, ids, idx, u, batch_keep=None):
        """One step; (loss, clipped gradient's norm by leaf name).
        ``batch_keep``: rows the loss is taken over (a planted fault)."""
        gst, arch = self.gst, self.arch
        B, J, L = tokens.shape
        S = idx.shape[1]
        rows = torch.arange(B, device=tokens.device)[:, None]
        for p in self.leaves:
            p.requires_grad_(True)
        h_s = encode(self.w, arch, tokens[rows, idx].reshape(B * S, L),
                     self.mode).reshape(B, S, -1)
        weights = eta(idx, u, self.init[ids], gst["keep_prob"], S)
        logits = head(self.hd, pooled(h_s, idx, self.emb[ids], weights),
                      self.mode)
        keep = slice(None) if batch_keep is None else batch_keep
        loss = F.cross_entropy(logits[keep], labels[keep].long())
        grads = torch.autograd.grad(loss, self.leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g.detach()
                 for p, g in zip(self.leaves, grads)]
        with torch.no_grad():
            gnorm = torch.sqrt(sum((g * g).sum() for g in grads))
            scale = torch.clamp(gst["max_grad_norm"]
                                / torch.clamp(gnorm, min=1e-9), max=1.0)
            for g in grads:
                g.mul_(scale)
            norms = {n: float(torch.linalg.vector_norm(g))
                     for n, g in zip(self.names, grads)}
            self.adamw(grads)
            self.emb[ids[:, None].expand_as(idx), idx] = h_s.detach()
            self.init[ids[:, None].expand_as(idx), idx] = True
        for p in self.leaves:
            p.requires_grad_(False)
        return float(loss.detach()), norms

    def adamw(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        bc1, bc2 = 1.0 - B1 ** self.t, 1.0 - B2 ** self.t
        lr, wd = self.gst["lr"], self.gst["weight_decay"]
        for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
            m.mul_(B1).add_(g, alpha=1.0 - B1)
            v.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            update = (m / bc1) / ((v / bc2).sqrt() + EPS) + wd * p
            p.sub_(lr * update)


@torch.no_grad()
def predict(w, hd, arch, tokens, mode: str = "f32"):
    """Logits (C,) of one document: tokens (J, L), every segment fresh."""
    return head(hd, encode(w, arch, tokens, mode).mean(0, keepdim=True),
                mode)[0]
