"""The port's three graph CLIs with telemetry on, held against the JAX
package's gate (CPU, small; the streams against the JAX package's own
runs: tests/test_torch_obs_parity.py):

  * ``launch.train --track graph``, ``launch.train_dist`` (2 shards, ring /
    int8, inline and ``--prefetch-lookups``) and ``launch.serve_graphs``
    write streams and traces that the JAX package's gate
    (``repro.obs.gate.main``, unchanged) and the port's both pass, with
    ``--expect-dist``/``--expect-prefetch`` on the distributed ones; both
    fail the same stream cut before its summary;
  * ``--mem-probe`` raises on every CLI, as does telemetry of a torchrun
    run;
  * telemetry on vs off is bitwise equal (losses, metrics, final table)
    with equal launch counts: graph, distributed inline and prefetched,
    and the sequence track (the counterpart of tests/test_obs.py::
    test_train_step_jaxpr_identical_with_obs_installed).
"""
import argparse
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro.obs as J  # noqa: E402
import repro_torch.obs as P  # noqa: E402
from repro.obs import gate as jgate  # noqa: E402
from repro.obs.trace import null_tracer as jnull_tracer  # noqa: E402
from repro_torch.graphs.experiment import (load_datasets,  # noqa: E402
                                           run_experiment)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve_graphs, train, train_dist  # noqa: E402
from repro_torch.obs import gate as pgate  # noqa: E402

SMALL = dict(n_graphs=16, max_seg_nodes=24, hidden=8, batch_size=4,
             epochs=2, finetune_epochs=1)
DIST = ["--device", "cpu", "--devices", "2", "--exchange", "ring",
        "--payload-dtype", "int8", "--epochs", "2", "--finetune-epochs", "1",
        "--n-graphs", "32"]
GRAPH = ["--track", "graph", "--device", "cpu", "--epochs", "2",
         "--finetune-epochs", "1", "--n-graphs", "32"]
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


def _gates(argv):
    return jgate.main(argv), pgate.main(argv)


def _run_cli(cli, tmp_path):
    """Run one port CLI with a stream and a trace: (its result, the gate
    arguments its stream passes)."""
    out, trace = str(tmp_path / "s.jsonl"), str(tmp_path / "t.json")
    obs = ["--metrics-out", out, "--trace-out", trace]
    if cli == "train":
        r = train.main(GRAPH + obs)
        _, ds, _ = load_datasets("malnet", 32, 64)
        gate = ["--train-jsonl", out, "--j-max", str(ds.j_max),
                "--num-sampled", "1",
                "--steps-per-epoch", str(r.train_steps // 2)]
    elif cli.startswith("train_dist"):
        prefetch = cli.endswith("prefetch")
        r = train_dist.main(DIST + obs + (["--prefetch-lookups"] if prefetch
                                          else []))
        gate = ["--train-jsonl", out, "--expect-dist"] + (
            ["--expect-prefetch"] if prefetch else [])
    else:
        r = serve_graphs.main(SERVE + ["--device", "cpu"] + obs)
        gate = ["--serve-jsonl", out, "--serve-p99-ms", "60000",
                "--max-encode-launches", str(r["encode_launches"])]
    return r, gate + ["--trace", trace], out


@pytest.mark.parametrize("cli", ["train", "train_dist",
                                 "train_dist_prefetch", "serve_graphs"])
def test_cli_streams_pass_both_gates_and_cut_streams_fail(cli, tmp_path,
                                                          capsys):
    _, gate, out = _run_cli(cli, tmp_path)
    assert _gates(gate) == (0, 0)
    printed = capsys.readouterr().out
    assert printed.count("all ") >= 2 and "[obs] " in printed
    lines = Path(out).read_text().splitlines()
    assert json.loads(lines[0])["type"] == "meta"
    assert json.loads(lines[-1])["type"] == "summary"
    Path(out).write_text("\n".join(lines[:-1]) + "\n")
    assert _gates(gate) == (1, 1)
    assert "no summary record" in capsys.readouterr().err


def _seq_args(extra):
    ap = train.build_parser()
    return ap.parse_args(["--track", "seq", "--device", "cpu", "--arch",
                          "internlm2-1.8b", "--reduced", "--steps", "6",
                          "--n-docs", "16", "--batch-size", "4",
                          "--log-every", "2", *extra])


def _run_path(path, obs_argv):
    """One run of ``path`` (telemetry per ``obs_argv``): (losses, metrics,
    the final table as a tuple of host tensors, the launch counts)."""
    ops.reset_kernel_launches()
    if path == "graph":
        obs = P.Obs.from_args(train.build_parser().parse_args(obs_argv))
        try:
            r = run_experiment(device="cpu", dataset="malnet",
                               variant="gst_efd", obs=obs, **SMALL)
        finally:
            obs.close()
        out = (r.epoch_losses, (r.train_metric, r.test_metric),
               tuple(r.table))
    elif path.startswith("dist"):
        r = train_dist.main(DIST + obs_argv + (
            ["--prefetch-lookups"] if path.endswith("prefetch") else []))
        out = (r.epoch_losses, r.train_metric, r.host_table())
    else:
        args = _seq_args(obs_argv)
        obs = P.Obs.from_args(args)
        try:
            r = train.train_seq(args, obs=obs, log=lambda *a, **k: None)
        finally:
            obs.close()
        out = (r.losses, r.metrics,
               tuple(t.clone() for t in r.state.table))
    return out, dict(ops.kernel_launches())


@pytest.mark.parametrize("path", ["graph", "dist", "dist_prefetch", "seq"])
def test_telemetry_on_off_bitwise(path, tmp_path):
    # one intra-op thread: on the CPU the sequence track's backward
    # reduces over threads in a varying order, so two runs differ in the
    # last bits with nothing else changed
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        off, off_launches = _run_path(path, [])
        assert not P.get_registry().enabled and not P.get_tracer().enabled
        on, on_launches = _run_path(path, [
            "--metrics-out", str(tmp_path / "s.jsonl"),
            "--trace-out", str(tmp_path / "t.json"),
            "--torch-trace-annotations"])
    finally:
        torch.set_num_threads(threads)
    assert on[:2] == off[:2]
    assert all(torch.equal(a, b) for a, b in zip(on[2], off[2]))
    assert on_launches == off_launches
    stream = Path(tmp_path / "s.jsonl").read_text().splitlines()
    assert json.loads(stream[-1])["type"] == "summary"
    trace = json.loads((tmp_path / "t.json").read_text())
    assert any(ev["name"] == "train.step" for ev in trace["traceEvents"])


@pytest.mark.parametrize("cli", ["train", "train_dist", "serve_graphs"])
def test_mem_probe_raises_on_every_cli(cli):
    argv = ["--mem-probe"]
    with pytest.raises(NotImplementedError, match="A3b"):
        if cli == "train":
            train.main(GRAPH + argv)
        elif cli == "train_dist":
            train_dist.main(DIST + argv)
        else:
            serve_graphs.main(SERVE + ["--device", "cpu"] + argv)
    assert not P.get_registry().enabled


def test_torchrun_telemetry_is_refused(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    args = argparse.Namespace(metrics=True)
    with pytest.raises(NotImplementedError, match="torchrun"):
        train_dist.run(args)
