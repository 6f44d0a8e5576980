"""The port's paper tables (``repro_torch.paper``) against the reference's
entries, ``benchmarks/paper_tables.py`` (loaded from its path):

  * every entry that trains makes the reference's ``run_experiment``
    calls, argument for argument and in order (plus ``device``), and
    emits its rows, for ``quick`` and the full suite (both packages'
    ``run_experiment`` replaced by a recorder returning stub results);
  * ``fig1_memory`` and ``kernels`` on the CPU: the reference's row
    names, and GST's bytes below the full step's at the largest J;
  * ``roofline`` without the port's dry-run JSON prints only the missing
    row and opens no file (not the reference's TPU JSON either); with it,
    the reference's rows from the same JSON, the H100's constants named;
  * with networkx hidden, the ``louvain`` row says that BFS ran;
  * ``python -m repro_torch.paper.run`` prints the reference runner's
    header, rows and timing lines, and imports no JAX.

``tests/test_torch_paper_parity.py`` holds ``run_experiment`` itself
against JAX's at each table argument.
"""
import builtins
import importlib.util
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import repro.graphs.experiment as JE  # noqa: E402
import repro_torch.graphs.experiment as PE  # noqa: E402
from repro_torch.graphs.partition import bfs_partition, partition_graph  # noqa: E402
from repro_torch.paper import paper_tables as PT  # noqa: E402
from repro_torch.paper import run  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TRAINING = ["table1", "table2", "table3", "fig3", "fig4", "table6"]


@pytest.fixture(scope="module")
def ref():
    """``benchmarks/paper_tables.py``, loaded from its path."""
    spec = importlib.util.spec_from_file_location(
        "_reference_paper_tables", ROOT / "benchmarks" / "paper_tables.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recorder(calls):
    """A ``run_experiment`` stand-in: records its keyword arguments and
    returns metrics that differ from call to call."""
    def fake(**kw):
        calls.append(kw)
        i = len(calls)
        return SimpleNamespace(train_metric=i / 64, test_metric=i / 128,
                               ms_per_iter=i * 1.5)
    return fake


@pytest.mark.parametrize("quick", [True, False])
@pytest.mark.parametrize("name", TRAINING)
def test_entry_makes_the_reference_calls_and_rows(ref, name, quick,
                                                  monkeypatch, capsys):
    want_calls, got_calls = [], []
    monkeypatch.setattr(JE, "run_experiment", _recorder(want_calls))
    monkeypatch.setattr(PE, "run_experiment", _recorder(got_calls))
    want = ref.ALL_BENCHES[name](quick=quick)
    want_out = capsys.readouterr().out
    got = PT.ALL_BENCHES[name](quick=quick, device="cpu")
    got_out = capsys.readouterr().out
    assert want_calls and len(got_calls) == len(want_calls)
    assert all(kw.pop("device") == "cpu" for kw in got_calls)
    assert got_calls == want_calls
    assert got == want and got_out == want_out


def _reference_fig1_names(ref, quick, monkeypatch, capsys):
    """The reference's Figure 1 rows with its setup and XLA's compile
    stubbed out: its names and order, no compile."""
    compiled = SimpleNamespace(memory_analysis=lambda: SimpleNamespace(
        temp_size_in_bytes=1))
    jitted = SimpleNamespace(lower=lambda *a: SimpleNamespace(
        compile=lambda: compiled))
    monkeypatch.setattr(ref, "_fig1_setup", lambda variant, J: (0, 0, 0))
    monkeypatch.setattr(ref, "jax", SimpleNamespace(
        jit=lambda f: jitted, random=SimpleNamespace(key=lambda s: s)))
    rows = ref.fig1_memory(quick=quick)
    capsys.readouterr()
    return [r[0] for r in rows]


@pytest.mark.parametrize("quick", [True, False])
def test_fig1_memory_rows_are_the_reference_rows(ref, quick, monkeypatch,
                                                 capsys):
    """Names and order, the port's measurement stubbed out as the
    reference's compile is."""
    setups = []
    monkeypatch.setattr(PT, "_fig1_setup", lambda variant, J, dev: (
        setups.append((variant, J, dev.type)), (None, ()))[1])
    monkeypatch.setattr(PT, "measure_call", lambda step, args: (
        {"temp_bytes": 1, "mode": "accounting"}, None))
    rows = PT.fig1_memory(quick=quick, device="cpu")
    assert [r[0] for r in rows] == _reference_fig1_names(ref, quick,
                                                         monkeypatch, capsys)
    assert setups == [(v, J, "cpu") for v in ("full", "gst_efd")
                      for J in ([4, 8, 16] if quick else [2, 4, 8, 16, 32])]


def test_fig1_memory_on_cpu(capsys):
    """The quick sweep measured (accounting mode): GST's step below the
    full step's at the largest J, the full step growing with J."""
    rows = PT.fig1_memory(quick=True, device="cpu")
    assert all(r[2] == "accounting_temp_bytes" and r[1] > 0 for r in rows)
    by = {r[0]: r[1] for r in rows}
    assert by["fig1/temp_bytes/gst_efd/J=16"] < by["fig1/temp_bytes/full/J=16"]
    assert by["fig1/temp_bytes/full/J=16"] > 2 * by["fig1/temp_bytes/full/J=4"]


def test_kernels_on_cpu(ref, capsys):
    want = [r[0] for r in ref.kernels_bench(quick=True)]
    rows = PT.kernels_bench(quick=True, device="cpu")
    assert [r[0] for r in rows] == want == [
        "kernels/segment_spmm_ref_us", "kernels/sed_pool_ref_us",
        "kernels/swa_ref_us"]
    assert all(r[1] > 0 and r[2].endswith(";plain;cpu") for r in rows)
    assert [r[2].split(";")[0] for r in rows] == [
        "m=128,d=128,e=1024", "B=64,J=16,d=256", "S=512,W=256"]


def test_roofline_prints_only_the_missing_row(tmp_path, monkeypatch,
                                              capsys):
    (tmp_path / ".scratch").mkdir()
    for f in ("roofline_unrolled.json", "dryrun_single.json"):
        (tmp_path / ".scratch" / f).write_text("[]")
    monkeypatch.chdir(tmp_path)

    def no_open(*a, **k):
        raise AssertionError(f"roofline opened {a}")

    monkeypatch.setattr(builtins, "open", no_open)
    rows = PT.roofline_table(quick=False, device="cpu")
    monkeypatch.undo()
    assert len(rows) == 1 and rows[0][:2] == ("roofline/missing", 0.0)
    assert "repro_torch.launch.dryrun" in rows[0][2]
    assert capsys.readouterr().out.splitlines() == [
        f"roofline/missing,0.0,{rows[0][2]}"]


def test_roofline_rows_equal_the_references_on_the_same_json(ref, tmp_path,
                                                              capsys):
    import json

    def row(arch, shape, terms, ratio=None, status="ok"):
        r = {"arch": arch, "shape": shape, "status": status,
             "terms_seconds": dict(zip(("compute", "memory", "collective"),
                                       terms)),
             "dominant": ("compute", "memory", "collective")[
                 max(range(3), key=lambda i: terms[i])]}
        if ratio is not None:
            r["useful_flops_ratio"] = ratio
        return r

    path = tmp_path / "dry.json"
    path.write_text(json.dumps([
        row("internlm2-1.8b", "train_4k", (0.0593, 0.544, 0.139), 0.81234567),
        row("internlm2-1.8b", "decode_32k", (1.49e-4, 1.895, 1.41e-3)),
        {"arch": "whisper-large-v3", "shape": "long_500k",
         "mesh": "single", "status": "skipped (DESIGN.md §Skips)"},
        {"arch": "arctic-480b", "shape": "long_500k", "mesh": "single",
         "status": "FAIL: aten.scatter_.src"}]))
    want = ref.roofline_table(path=str(path))
    got = PT.roofline_table(device="cpu", path=str(path))
    assert len(got) == len(want) == 7
    assert [r[:2] for r in got] == [r[:2] for r in want]
    for g, w in zip(got, want):
        assert g[2].startswith(w[2].split("/")[0])
        assert "H100 9.89e+14 FLOP/s bf16" in g[2] and "3.35e+12" in g[2]
        assert not any(tpu in g[2] for tpu in ("TPU", "197", "819"))
    out = capsys.readouterr().out.splitlines()
    assert out[-len(got):] == [f"{n},{v},{d}" for n, v, d in got]


def test_louvain_row_says_bfs_ran_without_networkx(monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(PE, "run_experiment", _recorder(calls))
    try:
        import networkx  # noqa: F401
        present = "test_acc"
    except ImportError:
        present = "test_acc;partition=bfs(networkx absent)"
    rows = PT.table6_partitioners(quick=False, device="cpu")
    assert {r[0]: r[2] for r in rows}["table6/partition/louvain"] == present

    monkeypatch.setitem(sys.modules, "networkx", None)
    rows = PT.table6_partitioners(quick=False, device="cpu")
    derived = {r[0]: r[2] for r in rows}
    assert derived == {
        "table6/partition/bfs": "test_acc",
        "table6/partition/louvain": "test_acc;partition=bfs(networkx absent)",
        "table6/partition/random": "test_acc",
        "table6/partition/vertex_cut": "test_acc"}
    # and BFS is what ran
    g = PE.D.make_malnet_like(n_graphs=1, seed=0)[0]
    got = partition_graph(len(g.x), g.edges, 32, "louvain", 0)
    want = bfs_partition(len(g.x), g.edges, 32, 0)
    assert [s.tolist() for s in got] == [s.tolist() for s in want]


def test_run_quick_table3_prints_header_and_rows(monkeypatch, capsys):
    """The runner at --quick --only table3 on the CPU, its runs cut small
    (24 graphs, 3 epochs, hidden 8: 6 timed steps a variant)."""
    real = PE.run_experiment

    def small(**kw):
        return real(**dict(kw, n_graphs=24, epochs=3, hidden=8,
                           max_seg_nodes=24))

    monkeypatch.setattr(PE, "run_experiment", small)
    out = run.main(["--quick", "--only", "table3,nope", "--device", "cpu"])
    cap = capsys.readouterr()
    lines = cap.out.splitlines()
    variants = ["full", "gst", "gst_one", "gst_e", "gst_efd"]
    assert lines[0] == "name,value,derived"
    assert [ln.split(",")[0] for ln in lines[1:6]] == [
        f"table3/ms_per_iter/{v}" for v in variants]
    assert all(math.isfinite(float(ln.split(",")[1])) and
               ln.endswith(",median_train_iter_ms") for ln in lines[1:6])
    assert lines[6].startswith("# table3 done in ")
    assert lines[7].startswith("# total ") and len(lines) == 8
    assert "unknown benchmark 'nope'" in cap.err
    assert list(out) == ["table3"] and len(out["table3"]) == 5


def test_run_module_imports_no_jax_and_defaults_to_the_card():
    code = (
        "import runpy, sys\n"
        "sys.argv = ['run', '--only', 'roofline', '--device', 'cpu']\n"
        "runpy.run_module('repro_torch.paper.run', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'repro', 'benchmarks'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "name,value,derived"
    assert lines[1].startswith("roofline/missing,0.0,")
    assert lines[2] == "# roofline done in 0s" and lines[3] == "# total 0s"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default device works here")
    with pytest.raises(RuntimeError, match="is_available"):
        run.main(["--only", "roofline"])
