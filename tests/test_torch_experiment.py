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
from repro_torch.graphs.experiment import run_experiment  # noqa: E402
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
    with pytest.raises(NotImplementedError, match="store slice"):
        run_experiment(device="cpu", **SMALL, **kw)
