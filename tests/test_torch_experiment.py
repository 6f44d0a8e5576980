"""The port's end-to-end graph-track runner (``run_experiment``) and its CLI
against the JAX package's.

Both packages build the same split, batches and padded segments from the
same numpy generators; JAX's initial weights are handed to the port
(``weights``), and the ``draws`` hook replays JAX's per-epoch keys
(``jax.random.key(epoch)`` folded with the step, as
src/repro/graphs/experiment.py:184 and src/repro/core/gst.py:248 make
them).  Train and test metrics agree within 1e-4 (tests/test_fused_path.py:185)
and both run the finetuning phase.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import TRACKS, jax_draws, np_tree  # noqa: E402
from repro.core import gst as JG  # noqa: E402
from repro.graphs.experiment import run_experiment as jax_run  # noqa: E402
from repro.graphs.gnn import GNNConfig as JGNNConfig  # noqa: E402
from repro.graphs.gnn import gnn_init as jgnn_init  # noqa: E402
from repro_torch.graphs.experiment import (  # noqa: E402
    run_experiment, run_in_lockstep)
from repro_torch.launch import train  # noqa: E402

SMALL = dict(n_graphs=16, max_seg_nodes=24, hidden=8, batch_size=4,
             epochs=2, finetune_epochs=1)


def _jax_weights(dataset, backbone, hidden, seed=0):
    """The initial weights of JAX's run_experiment
    (src/repro/graphs/experiment.py:102-104)."""
    head_mode, _, _, n_out = TRACKS[dataset]
    key = jax.random.key(seed)
    bb = jgnn_init(key, JGNNConfig(backbone=backbone, n_feat=8, hidden=hidden))
    head = JG.head_init(jax.random.fold_in(key, 1), hidden, n_out, head_mode)
    return np_tree(bb), np_tree(head)


@pytest.mark.parametrize("dataset", ["malnet", "tpugraphs"])
def test_run_experiment_matches_jax(dataset):
    kw = dict(dataset=dataset, backbone="sage", variant="gst_efd", **SMALL)
    want = jax_run(**kw)
    got = run_experiment(
        device="cpu", weights=_jax_weights(dataset, "sage", SMALL["hidden"]),
        draws=lambda epoch, step, sv: jax_draws(jax.random.key(epoch), step,
                                                sv, 1), **kw)
    assert got.finetuned and want.finetuned
    assert got.train_steps == 2 * (12 // 4) and got.finetune_steps == 12 // 4
    np.testing.assert_allclose(got.train_metric, want.train_metric,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.test_metric, want.test_metric,
                               rtol=1e-4, atol=1e-4)
    assert np.isfinite(got.ms_per_iter) and got.store_stats["misses"] == 0


def test_own_draws_are_reproducible():
    kw = dict(dataset="malnet", backbone="gcn", variant="gst_ed",
              device="cpu", **SMALL)
    a, b = run_experiment(**kw), run_experiment(**kw)
    assert (a.train_metric, a.test_metric) == (b.train_metric, b.test_metric)
    assert not a.finetuned and np.isfinite(a.test_metric)


LOCKSTEP = [dict(dataset="tpugraphs", backbone="sage", variant="gst"),
            dict(dataset="tpugraphs", backbone="sage", variant="gst_e"),
            dict(dataset="malnet", backbone="gcn", variant="gst_efd")]


def test_runs_in_lockstep_end_as_they_do_alone():
    """Each run of ``run_in_lockstep`` gives what it gives alone: metrics,
    per-epoch losses, step counts and the final table bitwise (the
    gst_efd run with its finetuning phase)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        kws = [dict(kw, device="cpu", **SMALL) for kw in LOCKSTEP]
        alone = [run_experiment(**kw) for kw in kws]
        together = run_in_lockstep(kws)
    finally:
        torch.set_num_threads(threads)
    for a, b in zip(alone, together):
        assert (a.variant, a.train_metric, a.test_metric, a.epoch_losses,
                a.train_steps, a.finetune_steps, a.finetuned) == \
            (b.variant, b.train_metric, b.test_metric, b.epoch_losses,
             b.train_steps, b.finetune_steps, b.finetuned)
        for x, y in zip(a.table, b.table):
            assert torch.equal(x, y)
        assert np.isfinite(b.ms_per_iter)
    assert [r.finetuned for r in together] == [False, False, True]


def test_lockstep_takes_one_step_of_each_in_turn():
    """The train steps go one of each run in turn, the run that goes
    first rotating: the step's ``draws`` hook records whose step it is."""
    order = []

    def draws(name):
        def fn(epoch, step, seg_valid):
            order.append((name, step))
            b, j = seg_valid.shape
            return np.zeros((b, 1), np.int64), np.full((b, j), 0.5, np.float32)
        return fn

    kws = [dict(kw, device="cpu", draws=draws(kw["variant"]), **SMALL)
           for kw in LOCKSTEP]
    together = run_in_lockstep(kws)
    names = [kw["variant"] for kw in LOCKSTEP]
    steps = together[0].train_steps
    assert [r.train_steps for r in together] == [steps] * 3
    assert order == [(names[(t + k) % 3], t) for t in range(steps)
                     for k in range(3)]


@pytest.mark.parametrize("variant", list(JG.VARIANTS))
def test_cli_trains_every_variant_on_cpu(variant, capsys):
    r = train.main(["--track", "graph", "--device", "cpu", "--variant",
                    variant, "--n-graphs", "32", "--epochs", "1",
                    "--finetune-epochs", "1"])
    assert np.isfinite(r.train_metric) and np.isfinite(r.test_metric)
    assert r.finetuned == JG.VARIANTS[variant].finetune_head
    assert f"sage {variant} [kernels] on cpu" in capsys.readouterr().out


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device works here")
    with pytest.raises(RuntimeError, match="is_available"):
        run_experiment(**SMALL)
    with pytest.raises(RuntimeError, match="is_available"):
        train.main(["--n-graphs", "16", "--epochs", "1"])


@pytest.mark.parametrize("kw", [dict(table_device_rows=16),
                                dict(wb_threshold=0.1),
                                dict(stale_forecast=True)])
def test_tiered_store_options_not_ported(kw):
    """The tiered-store options, once refused, now run (the name is kept
    from when they raised).  The cap alone (4 of the 12 training rows:
    the batch) trains bitwise like the uncapped run; the gate and the
    forecaster act only on a capped table, so with them the table is
    capped too: finite metrics, and the gate's or the forecaster's
    counters moved."""
    kw = dict(kw, table_device_rows=4)
    base = run_experiment(device="cpu", variant="gst_efd", **SMALL)
    r = run_experiment(device="cpu", variant="gst_efd", **SMALL, **kw)
    st = r.store_stats
    assert np.isfinite(r.train_metric) and np.isfinite(r.test_metric)
    assert r.finetuned and st["backend"] == "TieredStore"
    assert st["device_rows"] == 4 and st["evictions"] > 0
    if "wb_threshold" in kw:
        assert st["wb_threshold"] == 0.1 and st["wb_skipped_rows"] > 0
    elif "stale_forecast" in kw:
        assert st["forecast"]["observed_rows"] > 0
    else:
        assert (r.train_metric, r.test_metric) == (base.train_metric,
                                                   base.test_metric)
