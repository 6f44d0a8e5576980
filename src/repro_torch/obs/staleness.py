"""Staleness observability of the port — the paper-facing metrics layer.

Counterpart of ``src/repro/obs/staleness.py`` (the same names, buckets
and arithmetic).  GST-EFD's whole contribution is *managing* the
staleness of historical segment embeddings (Eq.-1 η weighting + SED
exist to bound its bias); this module makes that quantity measured instead of implied.  Everything
here is host-side arithmetic over the store's merged age/init view
(``store.ages_init``, one copy of the age/init planes to the host) or
over already-known run shape — nothing runs inside a step.

Published metric families (all through the process-wide registry):

  staleness.row_age           histogram, steps — age of every initialized
                              (row, segment) slot of the table at probe
                              time (``step - age``)
  staleness.effective_age     histogram, steps — the age the training step
                              *experiences* once staleness intelligence is
                              on: age·exp(-λ·age) under --sed-age-weighting
                              (a decayed slot contributes proportionally
                              less signal), 0 for forecast-eligible slots
                              under --stale-forecast.  Published only when
                              either knob is on.
  staleness.init_fraction     gauge — fraction of valid segment slots
                              initialized
  staleness.sed_drop_rate     gauge — the SED effective drop rate: the
                              expected fraction of VALID segments whose
                              Eq.-1 η lands on the dropped branch this
                              epoch (stale share x (1 - keep_prob); the
                              realized Bernoulli mask lives inside the
                              step, where nothing records, and its expectation
                              is exactly this by construction)
  staleness.sed.eligible      counter, segments — stale segments SED could
  staleness.sed.dropped       have dropped / expectation of how many it
                              did drop
  store.wb_skip_rate          gauge — delta-gate write-back skip rate
                              (skipped rows / evictions)
  exchange.bytes.<strategy>.<dtype>
                              counter, bytes — analytic wire traffic per
                              device, keyed by (strategy, payload dtype)
  serve.prediction_staleness  histogram, steps — age distribution of the
                              table rows each served prediction actually
                              read (serve/engine.py records it; the
                              train-while-serve ROADMAP metric, landed
                              first in the offline engine)
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.obs.metrics import (AGE_BUCKETS_STEPS, MetricsRegistry,
                                     get_registry, summarize)


def sed_drop_stats(seg_valid, init_mask, *, num_sampled: int,
                   keep_prob: float) -> Dict[str, float]:
    """SED effective-drop accounting for one batch/epoch of rows.

    seg_valid: (B, J) 0/1 — valid segment slots per row.
    init_mask: (B, J) bool — slots whose historical embedding is
    initialized (uninitialized stale slots get η = 0 regardless of SED,
    so they are not SED-eligible).

    Per row, ``num_sampled`` segments are fresh (encoded this step); the
    remaining valid+initialized ones are served stale and each survives
    with probability ``keep_prob`` (paper Eq. 1).  Returns the eligible
    count, the expected dropped count, and the effective drop rate over
    ALL valid segments — the fraction of the graph's signal SED removes.
    """
    valid = np.asarray(seg_valid) > 0
    init = np.asarray(init_mask) > 0
    n_valid = int(valid.sum())
    per_row_valid = valid.sum(axis=-1)
    per_row_stale = np.maximum((valid & init).sum(axis=-1)
                               - np.minimum(per_row_valid, num_sampled), 0)
    eligible = int(per_row_stale.sum())
    dropped = float(eligible) * (1.0 - keep_prob)
    return {
        "valid_segments": n_valid,
        "sed_eligible": eligible,
        "sed_dropped_expected": dropped,
        "sed_drop_rate": dropped / n_valid if n_valid else 0.0,
    }


def wb_skip_rate(store_stats: Dict) -> float:
    """Delta-gate write-back skip rate from a store stats/counters dict."""
    ev = store_stats.get("evictions", 0)
    return store_stats.get("wb_skipped_rows", 0) / ev if ev else 0.0


def record_exchange_bytes(strategy: str, payload_dtype: str, nbytes: int,
                          registry: Optional[MetricsRegistry] = None) -> None:
    """Wire traffic by (strategy, payload dtype): one counter per pair, so
    a run that re-picks strategies (--exchange=auto per phase) keeps the
    split visible."""
    reg = registry if registry is not None else get_registry()
    reg.inc(f"exchange.bytes.{strategy}.{payload_dtype}", nbytes,
            unit="bytes")


# bucket edges for the patched-rows histogram: patches are tiny by design
# (0 on disjoint schedules, <= B_local*S when adjacent batches fully
# overlap), so the resolution lives at the small end
PATCHED_ROWS_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                        256.0, 1024.0)


def record_prefetch_exchange(strategy: str, payload_dtype: str, nbytes: int,
                             patched_rows: int,
                             registry: Optional[MetricsRegistry] = None,
                             ) -> None:
    """One prefetched train step's exchange telemetry: the analytic wire
    bytes of the prefetch path (``exchange.prefetch.bytes.<strategy>.
    <dtype>`` — same total as inline plus the bucketed patch surcharge)
    and how many write-back rows the fused patch actually repaired in the
    next batch's buffer (host-side count of planned consumers — no device
    readback)."""
    reg = registry if registry is not None else get_registry()
    reg.inc(f"exchange.prefetch.bytes.{strategy}.{payload_dtype}", nbytes,
            unit="bytes")
    reg.histogram("exchange.prefetch.patched_rows",
                  buckets=PATCHED_ROWS_BUCKETS,
                  unit="rows").observe(float(patched_rows))


class StalenessProbe:
    """Periodic staleness snapshot over a store-backed training table.

    ``observe(store, table, step)`` reads the merged age/init view
    (one copy of the age/init planes to the host — call it per epoch /
    per export tick, not per step) and publishes the row-age
    histogram, init fraction, SED drop expectation and delta-gate skip
    rate.  Returns the summary dict it published, for prints/benches.

    The histogram observes every (row, segment) slot age, so its counts
    are bit-consistent with ``store.snapshot()`` ages by construction
    (``ages_init`` and ``snapshot`` agree once write-backs are flushed;
    tests/test_torch_obs.py).
    """

    def __init__(self, *, keep_prob: float = 0.5, num_sampled: int = 1,
                 seg_valid=None, registry: Optional[MetricsRegistry] = None,
                 sed_decay: float = 0.0, forecast: bool = False,
                 forecast_min_age: int = 1):
        self.keep_prob = keep_prob
        self.num_sampled = num_sampled
        # (n_rows, J) validity of the dataset's segment slots; None = every
        # slot counts (geometry without padding info)
        self.seg_valid = None if seg_valid is None else np.asarray(seg_valid)
        self._registry = registry
        # staleness-intelligence knobs: with age-weighted SED the model only
        # *feels* age through exp(-λ·age), and with forecasting a stale row
        # is extrapolated to the present before it is consumed — the
        # effective-age histogram records what the training step actually
        # experiences, next to the raw row_age it is derived from
        self.sed_decay = float(sed_decay)
        self.forecast = bool(forecast)
        self.forecast_min_age = int(forecast_min_age)

    @property
    def registry(self) -> MetricsRegistry:
        return self._registry if self._registry is not None else get_registry()

    def observe(self, store, table, step: int) -> Dict:
        age, init = store.ages_init(table)
        return self.observe_ages(age, init, step)

    def observe_ages(self, age, init, step: int) -> Dict:
        """The pure-array half of ``observe`` (tests feed snapshot ages
        directly to prove bit-consistency)."""
        reg = self.registry
        age = np.asarray(age)
        init = np.asarray(init) > 0
        valid = (np.ones_like(init) if self.seg_valid is None
                 else (self.seg_valid > 0))
        live = init & valid
        ages_steps = (int(step) - age[live]).astype(np.float64)
        hist = reg.histogram("staleness.row_age", buckets=AGE_BUCKETS_STEPS,
                             unit="steps")
        hist.observe_many(ages_steps)
        eff = None
        if self.sed_decay > 0.0 or self.forecast:
            # the age the step EXPERIENCES: η-decay scales a stale slot's
            # contribution by exp(-λ·age), so its effective age (the age
            # weighted by how much of it survives into the loss) is
            # age·exp(-λ·age); a forecast-eligible slot is extrapolated to
            # the present, so its effective age is 0.  Published only when
            # a knob is on — default telemetry streams stay identical.
            eff = ages_steps * np.exp(-self.sed_decay * ages_steps)
            if self.forecast:
                eff = np.where(ages_steps >= self.forecast_min_age, 0.0, eff)
            reg.histogram("staleness.effective_age",
                          buckets=AGE_BUCKETS_STEPS,
                          unit="steps").observe_many(eff)
        n_valid = int(valid.sum())
        init_frac = float(live.sum()) / n_valid if n_valid else 0.0
        reg.set("staleness.init_fraction", init_frac)
        sed = sed_drop_stats(valid, init, num_sampled=self.num_sampled,
                             keep_prob=self.keep_prob)
        reg.inc("staleness.sed.eligible", sed["sed_eligible"], unit="segments")
        reg.inc("staleness.sed.dropped", sed["sed_dropped_expected"],
                unit="segments")
        reg.set("staleness.sed_drop_rate", sed["sed_drop_rate"])
        out = {
            "step": int(step),
            "row_age_steps": summarize(ages_steps),
            "init_fraction": init_frac,
            **sed,
        }
        if eff is not None:
            out["effective_age_steps"] = summarize(eff)
        return out

    def observe_store_counters(self, store_stats: Dict) -> None:
        """Publish the delta-gate skip rate gauge from a store stats dict
        (the counters themselves stream through store/base.py)."""
        self.registry.set("store.wb_skip_rate", wb_skip_rate(store_stats))


def sed_age_bound(*, j_max: int, num_sampled: int,
                  steps_per_epoch: int, safety: float = 2.0) -> float:
    """The SED-implied row-age bound the CI obs gate asserts p99 against.

    Under Algorithm 1 every graph is visited once per epoch and
    ``num_sampled`` of its ``j_max`` segment slots are re-encoded (age
    reset), so a slot's refresh interval is geometric with mean
    ``j_max / num_sampled`` epochs; the Algorithm-2 refresh pass
    (gst_ef/gst_efd) additionally rewrites EVERY slot before finetuning.
    p99 of a geometric(p = num_sampled/j_max) is ~ln(100)/p visits; in
    steps that is ``ln(100) * j_max / num_sampled * steps_per_epoch``.
    ``safety`` doubles it so the gate flags broken staleness bookkeeping
    (ages never advancing, refresh not landing), not sampling noise.
    """
    p = min(max(num_sampled, 1) / max(j_max, 1), 1.0)
    return float(np.log(100.0) / p * steps_per_epoch * safety)
