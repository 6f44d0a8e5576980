"""Closed-form estimators of the Taylor-expansion analysis (paper §4, App. A).

Counterpart of ``src/repro/core/theory.py`` on torch tensors.  Theorem 4.1:
with keep ratio p, SED reduces the first-order (bias) term introduced by
stale embeddings by a factor p, while adding a regularization term.  These
estimators compute E[δ] and E[δδᵀ] diagonals under the ET and SED
perturbation distributions by direct enumeration of the probabilities in
Appendix A; ``tests/test_torch_theory.py`` holds them against the JAX
package's and checks a Monte-Carlo run of the port's own sampler
(``core/segment.py``) against them.
"""
from __future__ import annotations

from typing import Tuple

import torch


def delta_moments_et(h, h_tilde, J: int, S: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """E[δ_j] and E[δ_j⊙²] for plain embedding-table training (no SED).

    δ_j = 0 w.p. S/J (segment fresh); δ_j = h̃_j - h_j w.p. (J-S)/J.
    h, h_tilde: (..., d) true / stale embedding of one segment.
    """
    q = (J - S) / J
    diff = h_tilde - h
    return q * diff, q * torch.square(diff)


def delta_moments_sed(h, h_tilde, J: int, S: int, p: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """E[δ_j] and E[δ_j⊙²] under SED (Appendix A):

        δ_j = (1-p)(J-S)/S · h_j        w.p. S/J        (fresh, up-weighted)
        δ_j = -h_j                      w.p. (1-p)(J-S)/J  (stale, dropped)
        δ_j = h̃_j - h_j                w.p. p(J-S)/J      (stale, kept)
    """
    w_fresh = S / J
    w_drop = (1 - p) * (J - S) / J
    w_keep = p * (J - S) / J
    d_fresh = (1 - p) * (J - S) / S * h
    d_drop = -h
    d_keep = h_tilde - h
    mean = w_fresh * d_fresh + w_drop * d_drop + w_keep * d_keep
    second = (w_fresh * torch.square(d_fresh) + w_drop * torch.square(d_drop)
              + w_keep * torch.square(d_keep))
    return mean, second


def bias_reduction_factor(h, h_tilde, J: int, S: int, p: float
                          ) -> torch.Tensor:
    """Ratio ||E[δ^SED]_bias|| / ||E[δ^ET]|| restricted to the stale-difference
    direction — Theorem 4.1 says the h̃-h component scales by exactly p."""
    et_mean, _ = delta_moments_et(h, h_tilde, J, S)
    sed_mean, _ = delta_moments_sed(h, h_tilde, J, S, p)
    # project out the fresh-part contribution (which is mean-zero in h over
    # the dataset); the stale component of SED is p * ET by construction.
    # jnp.vdot flattens its operands: so does the reshape
    diff = (h_tilde - h).reshape(-1)
    denom = torch.clamp_min(torch.vdot(diff, diff), 1e-12)
    et_c = torch.vdot(et_mean.reshape(-1), diff) / denom
    sed_c = torch.vdot((sed_mean - (S / J) * (1 - p) * (J - S) / S * h
                        + (1 - p) * (J - S) / J * h).reshape(-1),
                       diff) / denom
    return sed_c / torch.clamp_min(et_c, 1e-12)
