"""A run with its timed path broken underneath comes out not correct:
once for each fault a cell can have (one chip: no exchange to leave
out)."""
from __future__ import annotations

import pytest
import torch

from gstbench import testing as T


def _unchanged_state(monkeypatch):
    """The step returns its state unchanged: no update, no table write."""
    from repro_torch.core import embedding_table
    from repro_torch.optim import adamw

    def no_update(params, grads, state, **kw):
        return params, {**state, "step": state["step"] + 1}, {
            "grad_norm": torch.zeros(())}

    monkeypatch.setattr(adamw, "adamw_update", no_update)
    monkeypatch.setattr(embedding_table, "update_sampled",
                        lambda table, *a, **k: table)


def _half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from repro_torch.core import gst
    real = gst.ce_loss

    def half(logits, labels):
        n = logits.shape[0] // 2
        return real(logits[:n], labels[:n])

    monkeypatch.setattr(gst, "ce_loss", half)


def _altered_write(monkeypatch):
    """An answer altered where it is produced: one written row moved."""
    from repro_torch.core import embedding_table
    real = embedding_table.update_sampled

    def altered(table, graph_ids, seg_idx, h_new, step, **kw):
        h_new = h_new.clone()
        h_new[0, 0, 0] += 1e-2 * h_new[0, 0].norm()
        return real(table, graph_ids, seg_idx, h_new, step, **kw)

    monkeypatch.setattr(embedding_table, "update_sampled", altered)


def _altered_logit(monkeypatch):
    """An answer altered where it is produced: one logit moved."""
    from repro_torch.core import gst
    real = gst.head_apply

    def altered(p, h, mode):
        out = real(p, h, mode).clone()
        out[..., 0] += 1e-2 * out.abs().max()
        return out

    monkeypatch.setattr(gst, "head_apply", altered)


TRAIN = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
         "altered_write": _altered_write}


@pytest.mark.parametrize("workload", T.cells_of("train_efd"))
@pytest.mark.parametrize("fault", sorted(TRAIN))
def test_train_faults_fail(monkeypatch, workload, fault):
    TRAIN[fault](monkeypatch)
    r = T.execute(workload)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", T.cells_of("predict"))
def test_altered_logit_fails(monkeypatch, workload):
    _altered_logit(monkeypatch)
    r = T.execute(workload)
    assert not r["correct"], r["checks"]
