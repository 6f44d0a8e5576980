"""Online per-row dynamic-embedding forecasting for the tiered store.

Counterpart of ``src/repro/store/forecast.py`` (numpy only, so a copy, not
an import: the port imports nothing of the JAX package).

"Staleness-Alleviated Distributed GNN Training via Online Dynamic-
Embedding Prediction" (Bai et al., PAPERS.md): a historical embedding
that sat in the host tier for ``age`` steps is not served as-is — it is
extrapolated forward by a per-row velocity estimate before the training
step consumes it.  The estimate is maintained ONLINE from the delta
stream the store already computes: every eviction write-back compares
the evicted row against the host copy it faulted in from (the same
comparison the ``--wb-threshold`` delta gate runs), which is one
(Δemb, Δstep) observation per residency — an EMA of Δemb/Δstep is the
row's velocity.

The forecast is strictly read-side: ``apply`` patches the STAGED upload
buffer on fault-in, never the authoritative host arrays, so turning the
flag off (the default — ``--stale-forecast``) leaves every byte of store
state and every staged upload bit-identical.
"""
from __future__ import annotations

import numpy as np


class RowForecaster:
    """Per-row linear (EMA-velocity) extrapolator over the host tier.

    vel[r] ≈ EMA of (emb_evicted - emb_fault_in) / steps_resident — the
    row's drift per training step.  ``observe`` feeds it one eviction's
    delta; ``apply`` extrapolates rows whose age (vs ``now_step``) is at
    least ``min_age`` forward by exactly that age.  An age-0 (or
    never-observed) row forecasts to the identity.
    """

    def __init__(self, n_rows: int, j_max: int, d_h: int, *,
                 alpha: float = 0.5, min_age: int = 1, dtype=np.float32):
        self.alpha = float(alpha)
        self.min_age = int(min_age)
        # velocity is only meaningful for rows that completed >= 1
        # observed residency; _seen gates apply() to those
        self._vel = np.zeros((n_rows, j_max, d_h), dtype)
        self._seen = np.zeros((n_rows, j_max), bool)
        self.observed_rows = 0
        self.forecast_rows = 0

    def observe(self, rows, emb_new, emb_old, age_new, age_old,
                init_new, init_old) -> None:
        """One eviction write-back's delta stream: ``rows`` (n,) global
        row ids, ``*_new`` the evicted device content, ``*_old`` the host
        copy the residency faulted in from (read BEFORE the write-back
        lands).  Slots initialized on both sides contribute a velocity
        observation; fresh initializations have no baseline and only
        reset the EMA gate."""
        rows = np.asarray(rows)
        both = np.asarray(init_new) & np.asarray(init_old)      # (n, J)
        if not both.any():
            return
        elapsed = np.maximum(
            np.asarray(age_new, np.float32) - np.asarray(age_old, np.float32),
            1.0)                                                 # (n, J)
        step_vel = (np.asarray(emb_new, np.float32)
                    - np.asarray(emb_old, np.float32)) / elapsed[..., None]
        prev = self._vel[rows]
        seen = self._seen[rows]                                  # (n, J)
        # first observation seeds the EMA, later ones blend
        blended = np.where(seen[..., None],
                           (1.0 - self.alpha) * prev
                           + self.alpha * step_vel,
                           step_vel)
        self._vel[rows] = np.where(both[..., None], blended, prev)
        self._seen[rows] = seen | both
        self.observed_rows += int(both.any(axis=-1).sum())

    def apply(self, rows, emb, age, init, now_step: int) -> np.ndarray:
        """Extrapolate a staged fault-in buffer forward: rows (n,) global
        ids, emb (n, J, d) the host copies, age (n, J) their last-refresh
        steps.  Slots that are initialized, velocity-observed, and at
        least ``min_age`` steps old get ``emb + vel * age_steps``; all
        others — age 0 included — pass through untouched (the identity
        round-trip contract)."""
        rows = np.asarray(rows)
        age_steps = np.maximum(
            float(now_step) - np.asarray(age, np.float32), 0.0)  # (n, J)
        hit = (np.asarray(init) & self._seen[rows]
               & (age_steps >= self.min_age))                    # (n, J)
        if not hit.any():
            return emb
        out = np.array(emb, np.float32, copy=True)
        fwd = out + self._vel[rows] * age_steps[..., None]
        out = np.where(hit[..., None], fwd, out)
        self.forecast_rows += int(hit.any(axis=-1).sum())
        return out.astype(emb.dtype)

    def stats(self) -> dict:
        return {"observed_rows": self.observed_rows,
                "forecast_rows": self.forecast_rows}
