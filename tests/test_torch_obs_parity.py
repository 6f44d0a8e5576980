"""The port's telemetry streams against the JAX package's own runs (CPU,
small):

  * ``run_experiment`` replayed against JAX's (JAX's weights and draws):
    the summaries' ``staleness.*`` and ``store.*`` are equal, and so are
    the metric names;
  * ``train_dist``'s ``exchange.bytes.*`` (and the lane's
    ``exchange.prefetch.bytes.*``) totals equal the JAX CLI's at the same
    geometry (a subprocess on a forced 2-device host, as
    tests/test_torch_dist.py runs the reference), and equal the bytes the
    port's comm counted;
  * the serving replay's stream has the JAX CLI's records and counters
    (latency by name and count: a host time).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.obs as J  # noqa: E402
import repro_torch.obs as P  # noqa: E402
from _torch_parity import TRACKS, jax_draws, np_tree  # noqa: E402
from repro.core import gst as JG  # noqa: E402
from repro.graphs.experiment import run_experiment as jax_run  # noqa: E402
from repro.graphs.gnn import GNNConfig as JGNNConfig  # noqa: E402
from repro.graphs.gnn import gnn_init as jgnn_init  # noqa: E402
from repro.launch import serve_graphs as jserve_graphs  # noqa: E402
from repro.obs.trace import null_tracer as jnull_tracer  # noqa: E402
from repro_torch.graphs.experiment import run_experiment  # noqa: E402
from repro_torch.launch import serve_graphs, train_dist  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(n_graphs=16, max_seg_nodes=24, hidden=8, batch_size=4,
             epochs=2, finetune_epochs=1)
DIST = ["--device", "cpu", "--devices", "2", "--exchange", "ring",
        "--payload-dtype", "int8", "--epochs", "2", "--finetune-epochs", "1",
        "--n-graphs", "32"]
SERVE = ["--requests", "24", "--unique", "8", "--duplicate-rate", "0.6"]


@pytest.fixture(autouse=True)
def _clean_globals():
    for mod, nt in ((J, jnull_tracer), (P, P.null_tracer)):
        mod.set_registry(mod.null_registry())
        mod.set_tracer(nt())
    yield
    for mod, nt in ((J, jnull_tracer), (P, P.null_tracer)):
        mod.set_registry(mod.null_registry())
        mod.set_tracer(nt())


def _summary(path):
    return json.loads(Path(path).read_text().splitlines()[-1])


def _jax_weights(dataset, hidden, seed=0):
    head_mode, _, _, n_out = TRACKS[dataset]
    key = jax.random.key(seed)
    bb = jgnn_init(key, JGNNConfig(backbone="sage", n_feat=8, hidden=hidden))
    head = JG.head_init(jax.random.fold_in(key, 1), hidden, n_out, head_mode)
    return np_tree(bb), np_tree(head)


@pytest.mark.parametrize("dataset,decay", [("malnet", 0.0),
                                           ("tpugraphs", 0.1)])
def test_run_experiment_staleness_and_store_match_jax(dataset, decay):
    kw = dict(dataset=dataset, backbone="sage", variant="gst_efd",
              sed_age_weighting=decay, **SMALL)
    jobs = J.Obs(metrics=True)
    jax_run(obs=jobs, **kw)
    want = jobs.close()["metrics"]
    pobs = P.Obs(metrics=True)
    run_experiment(device="cpu", obs=pobs,
                   weights=_jax_weights(dataset, SMALL["hidden"]),
                   draws=lambda epoch, step, sv: jax_draws(
                       jax.random.key(epoch), step, sv, 1), **kw)
    got = pobs.close()["metrics"]
    assert sorted(got) == sorted(want)
    shared = [k for k in got if k.startswith(("staleness.", "store."))]
    assert "staleness.row_age" in shared and "store.lookups" in shared
    assert ("staleness.effective_age" in shared) == (decay > 0)
    assert {k: got[k] for k in shared} == {k: want[k] for k in shared}


@pytest.fixture(scope="module")
def jax_dist_streams(tmp_path_factory):
    """The JAX CLI's summaries, inline and prefetched (two processes at
    once), on a forced 2-device host (the CLI forces it; the tier-1
    process sees one device)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    runs = {}
    for prefetch in (False, True):
        path = tmp_path_factory.mktemp("jax_dist") / "s.jsonl"
        argv = [a for a in DIST if a not in ("--device", "cpu")]
        argv += ["--metrics-out", str(path)] + (
            ["--prefetch-lookups"] if prefetch else [])
        runs[prefetch] = path, subprocess.Popen(
            [sys.executable, "-m", "repro.launch.train_dist", *argv],
            cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
    out = {}
    for prefetch, (path, proc) in runs.items():
        try:
            _, err = proc.communicate(timeout=600)
        finally:
            proc.kill()
        assert proc.returncode == 0, err[-4000:]
        out[prefetch] = _summary(path)["metrics"]
    return out


@pytest.mark.parametrize("prefetch", [False, True])
def test_train_dist_exchange_bytes_match_jax(jax_dist_streams, prefetch,
                                             tmp_path):
    want = jax_dist_streams[prefetch]
    out = str(tmp_path / "s.jsonl")
    r = train_dist.main(DIST + ["--metrics-out", out] + (
        ["--prefetch-lookups"] if prefetch else []))
    got = _summary(out)["metrics"]
    assert sorted(got) == sorted(want)
    exch = [k for k in got if k.startswith("exchange.")
            and "patched_rows" not in k]
    assert "exchange.bytes.ring.int8" in exch
    assert len(exch) == 1 + prefetch
    for k in exch + ["feeder.batches", "store.lookups", "store.hits",
                     "store.wb_skip_rate"]:
        assert got[k] == want[k], k
    # one shard's counted bytes: what the registry recorded, a step at a time
    assert got["exchange.bytes.ring.int8"] == sum(r.epoch_exchange_bytes)
    if prefetch:
        assert got["exchange.prefetch.patched_rows"]["count"] == \
            want["exchange.prefetch.patched_rows"]["count"] == r.train_steps


def test_serve_graphs_counters_match_jax(tmp_path):
    jout, pout = str(tmp_path / "j.jsonl"), str(tmp_path / "p.jsonl")
    jserve_graphs.main(SERVE + ["--metrics-out", jout])
    serve_graphs.main(SERVE + ["--device", "cpu", "--metrics-out", pout])
    want, got = _summary(jout), _summary(pout)
    assert sorted(got) == sorted(want)
    wm, gm = want["metrics"], got["metrics"]
    assert sorted(gm) == sorted(wm)
    for k, v in gm.items():
        if k == "serve.latency_ms":            # a host time: by name only
            assert v["count"] == wm[k]["count"]
        else:
            assert v == wm[k], k
    for p, j in zip(Path(pout).read_text().splitlines(),
                    Path(jout).read_text().splitlines()):
        p, j = json.loads(p), json.loads(j)
        assert sorted(p) == sorted(j)
        if p["type"] == "tick":
            assert p["step"] == j["step"] and sorted(p["delta"]) == \
                sorted(j["delta"])
