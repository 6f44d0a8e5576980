"""GST train steps of the kernel path held against the plain path.

Both paths run on the same device from the same state and take the same
draws; after each step the plain path's state is copied into the kernel
path's, so every step is compared from the same state.  Per step: the
kernel step's launches, the loss (rtol 1e-4, atol 1e-5), the gradients
(from the Adam first moment) 1e-4, the parameters after the step 1e-4
where a gradient is at least 1e-6 (Adam's eps 1e-8 turns float noise in an
exactly-zero gradient into a step of up to lr), the table 1e-5 with ages
and flags equal.  The tolerances are the reference's
(``tests/test_fused_path.py:48,73,185``).

The comparison must reach Eq. 1's stale branch: at least one step must
keep a stale segment of the table (initialized, not sampled, not dropped),
so that η's stale term, and with a decay its age term, weigh on both
paths.  The caller makes this so by showing a batch again.

``dist_step_parity`` does the same for the distributed step
(``dist/train.py``): every shard's replica and table shard compared, the
write-path bits the same on both paths (drawn per (step, shard)), and,
with a compressed payload, the table held to one grid step of the wire
format where it would be 1e-5: the two paths' write-backs differ in
float noise, which can move a stochastically rounded value to the next
grid point.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

import numpy as np

from repro_torch.core import gst as G
from repro_torch.core import segment as seg
from repro_torch.kernels import ops

TOL = 1e-5
GRAD_TOL = 1e-4
ADAM_B1 = 0.9      # make_optimizer's first-moment decay


def copy_state(dst: G.TrainState, src: G.TrainState) -> G.TrainState:
    """Set ``dst`` to ``src`` in place (parameters, Adam moments and
    count, table, step)."""
    with torch.no_grad():
        pairs = list(zip(G.train_params(dst), G.train_params(src)))
        pairs += list(zip(dst.opt_state["mu"], src.opt_state["mu"]))
        pairs += list(zip(dst.opt_state["nu"], src.opt_state["nu"]))
        pairs += list(zip(dst.table, src.table))
        for a, b in pairs:
            a.copy_(b)
    return dst._replace(opt_state=dict(dst.opt_state,
                                       step=src.opt_state["step"]),
                        step=src.step)


def _launched(counts: dict) -> dict:
    """The kernels launched at least once (a count of 0 and no entry are
    the same prediction)."""
    return {k: v for k, v in counts.items() if v}


def kept_stale(table, batch: G.GSTBatch, draws, keep_prob: float) -> int:
    """The stale segments that enter Eq. 1 with η > 0 in a step: valid,
    not sampled, initialized in ``table`` and kept by SED."""
    idx, u = draws
    valid = batch.seg_valid.float()
    fresh = seg.sampled_mask(idx.to(valid.device), valid.shape[1]) * valid
    init = table.initialized[batch.graph_ids].float()
    kept = (u.to(valid.device) <= keep_prob).float()
    return int(torch.sum(valid * (1.0 - fresh) * init * kept))


def table_tol(emb: torch.Tensor, payload_dtype: str = "f32") -> torch.Tensor:
    """The table's tolerance: TOL, plus one grid step of the wire format
    (a bf16 ulp of the value, or the row's int8 scale)."""
    if payload_dtype == "bf16":
        return TOL + emb.abs() * 2.0 ** -8
    if payload_dtype == "int8":
        return TOL + emb.abs().amax(dim=(1, 2), keepdim=True) / 127.0
    return torch.full_like(emb, TOL)


@torch.no_grad()
def compare_states(st_k: G.TrainState, st_p: G.TrainState,
                   mu_prev: Sequence[torch.Tensor],
                   payload_dtype: str = "f32") -> float:
    """One step's gradients, parameters and table, kernel against plain
    path; returns the largest parameter difference held to GRAD_TOL."""
    worst = 0.0
    for pk, pp, mk, mp, m0 in zip(
            G.train_params(st_k), G.train_params(st_p),
            st_k.opt_state["mu"], st_p.opt_state["mu"], mu_prev):
        gk = (mk - ADAM_B1 * m0) / (1.0 - ADAM_B1)
        gp = (mp - ADAM_B1 * m0) / (1.0 - ADAM_B1)
        torch.testing.assert_close(gk, gp, rtol=GRAD_TOL, atol=GRAD_TOL)
        held = (gk.abs() >= 1e-6) | (gp.abs() >= 1e-6)
        torch.testing.assert_close(pk[held], pp[held], rtol=0, atol=GRAD_TOL)
        diff = (pk - pp)[held].abs()
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
    if payload_dtype == "f32":
        torch.testing.assert_close(st_k.table.emb, st_p.table.emb, rtol=TOL,
                                   atol=TOL)
    elif not bool(((st_k.table.emb - st_p.table.emb).abs()
                   <= table_tol(st_p.table.emb, payload_dtype)).all()):
        raise AssertionError("table differs by more than one grid step")
    if not (torch.equal(st_k.table.age, st_p.table.age) and torch.equal(
            st_k.table.initialized, st_p.table.initialized)):
        raise AssertionError("table ages or flags differ")
    return worst


def kernel_step_parity(kernel: Tuple, plain: Tuple,
                       batches: List[G.GSTBatch],
                       generator: torch.Generator, want_launches: dict, *,
                       keep_prob: float = 0.5, num_sampled: int = 1
                       ) -> Tuple[float, int]:
    """Run ``kernel = (state, step)`` and ``plain = (state, step)`` over
    ``batches``, one step each, with draws from ``generator``; raise
    AssertionError where they differ, where a kernel step's launches are
    not ``want_launches``, or where no step kept a stale segment.  Returns
    (the largest parameter difference, the stale segments kept)."""
    (st_k, step_k), (st_p, step_p) = kernel, plain
    worst, n_stale = 0.0, 0
    for i, batch in enumerate(batches):
        draws = (seg.sample_segments(generator, batch.seg_valid.cpu(),
                                     num_sampled),
                 torch.rand(batch.seg_valid.shape, generator=generator))
        n_stale += kept_stale(st_p.table, batch, draws, keep_prob)
        mu_prev = [m.clone() for m in st_p.opt_state["mu"]]
        ops.reset_kernel_launches()
        st_k, m_k = step_k(st_k, batch, draws=draws)
        counts = ops.kernel_launches()
        if _launched(counts) != _launched(want_launches):
            raise AssertionError(f"step {i}: launches {counts}, want "
                                 f"{want_launches}")
        st_p, m_p = step_p(st_p, batch, draws=draws)
        torch.testing.assert_close(m_k["loss"], m_p["loss"], rtol=GRAD_TOL,
                                   atol=TOL)
        worst = max(worst, compare_states(st_k, st_p, mu_prev))
        st_k = copy_state(st_k, st_p)
    if n_stale == 0:
        raise AssertionError("no compared step kept a stale segment: Eq. 1's "
                             "stale branch went unchecked")
    return worst, n_stale


def dist_step_parity(kernel: Tuple, plain: Tuple, batches: List,
                     generator: torch.Generator, want_launches: dict, *,
                     keep_prob: float = 0.5, num_sampled: int = 1
                     ) -> Tuple[float, int]:
    """``kernel = (ctx, states, step)`` and ``plain = (ctx, states, step)``
    (``dist/train.py``, the same shards and exchange, ``use_kernels`` True
    and False) over host ``batches`` (numpy ``GSTBatch``es of the global
    batch), one step each, with the global batch's draws from
    ``generator``; raise AssertionError where they differ, where the
    replicas of a path differ, where a kernel step's launches (all shards
    together) are not ``want_launches``, or where no step kept a stale
    segment.  Returns (the largest parameter difference, the stale
    segments kept)."""
    from repro_torch.dist import train as DT

    (ctx_k, sts_k, step_k), (ctx_p, sts_p, step_p) = kernel, plain
    dtype = ctx_p.payload_dtype if ctx_p.num_shards > 1 else "f32"
    worst, n_stale = 0.0, 0
    for i, hb in enumerate(batches):
        valid = torch.from_numpy(np.asarray(hb.seg_valid))
        draws = (seg.sample_segments(generator, valid, num_sampled),
                 torch.rand(valid.shape, generator=generator))
        ids = torch.from_numpy(np.asarray(hb.graph_ids).astype(np.int64))
        n_stale += kept_stale(DT.host_table(ctx_p, sts_p),
                              G.GSTBatch(None, valid, ids, None), draws,
                              keep_prob)
        draws = tuple(d.numpy() for d in draws)
        mu_prev = [[m.clone() for m in s.opt_state["mu"]] for s in sts_p]
        ops.reset_kernel_launches()
        sts_k, m_k = step_k(sts_k, DT.shard_batch(ctx_k, hb), draws=draws)
        counts = ops.kernel_launches()
        if _launched(counts) != _launched(want_launches):
            raise AssertionError(f"step {i}: launches {counts}, want "
                                 f"{want_launches}")
        sts_p, m_p = step_p(sts_p, DT.shard_batch(ctx_p, hb), draws=draws)
        torch.testing.assert_close(m_k["loss"], m_p["loss"], rtol=GRAD_TOL,
                                   atol=TOL)
        for sts in (sts_k, sts_p):
            for st in sts[1:]:
                for a, b in zip(G.train_params(sts[0]), G.train_params(st)):
                    if not torch.equal(a, b):
                        raise AssertionError(f"step {i}: replicas differ")
        for r, (st_k, st_p) in enumerate(zip(sts_k, sts_p)):
            worst = max(worst, compare_states(st_k, st_p, mu_prev[r], dtype))
        sts_k = [copy_state(a, b) for a, b in zip(sts_k, sts_p)]
    if n_stale == 0:
        raise AssertionError("no compared step kept a stale segment: Eq. 1's "
                             "stale branch went unchecked")
    return worst, n_stale
