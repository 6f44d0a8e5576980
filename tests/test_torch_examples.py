"""The port's example scripts run on the CPU and import no JAX:
examples/serve_batched_torch.py serves the five reduced families;
examples/llm_segment_training_torch.py trains the ~27M-parameter
internlm2-family backbone with GST+EFD; examples/quickstart_torch.py and
examples/tpugraphs_ranking_torch.py run the graph track's pipeline and
its four ranking variants, here at small sizes."""
import os
import runpy
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SERVE_BATCHED = ROOT / "examples" / "serve_batched_torch.py"
LLM_TRAINING = ROOT / "examples" / "llm_segment_training_torch.py"
QUICKSTART = ROOT / "examples" / "quickstart_torch.py"
RANKING = ROOT / "examples" / "tpugraphs_ranking_torch.py"
NO_REFERENCE = (
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'repro', 'benchmarks'))\n"
    "assert not bad, bad\n")


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def test_serve_batched_runs_on_the_cpu_without_jax():
    code = (
        "import runpy, sys\n"
        f"g = runpy.run_path({str(SERVE_BATCHED)!r})\n"
        "out = g['main'](['--device', 'cpu'])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "for arch, gen in out.items():\n"
        "    print('GEN', arch, gen.shape, int(gen.min()), int(gen.max()))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    gens = [line.split() for line in proc.stdout.splitlines()
            if line.startswith("GEN")]
    assert [g[1] for g in gens] == runpy.run_path(str(SERVE_BATCHED))["ARCHS"]
    assert all(" ".join(g[2:4]) == "(2, 8)" and int(g[4]) >= 0
               for g in gens), gens
    assert "zamba2-1.2b" in proc.stdout and "ms/step" in proc.stdout


def test_serve_batched_cli_runs_and_defaults_to_the_card():
    proc = subprocess.run([sys.executable, str(SERVE_BATCHED), "--device",
                           "cpu"], cwd=ROOT, env=_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len([line for line in proc.stdout.splitlines()
                if "generated 8 tokens/seq x2" in line]) == 5
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    main = runpy.run_path(str(SERVE_BATCHED))["main"]
    with pytest.raises(RuntimeError, match="is_available"):
        main([])


def test_llm_segment_training_runs_two_steps_on_the_cpu_without_jax():
    code = (
        "import runpy, sys\n"
        f"g = runpy.run_path({str(LLM_TRAINING)!r})\n"
        "acc = g['main'](2, 'cpu', 1)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ACC', acc)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert "27M params on cpu" in lines[0]
    assert sum(line.startswith("step ") for line in lines) == 2
    acc = float(lines[-1].split()[1])
    assert 0.0 <= acc <= 1.0
    if not torch.cuda.is_available():
        main = runpy.run_path(str(LLM_TRAINING))["main"]
        with pytest.raises(RuntimeError, match="is_available"):
            main(1)


def test_quickstart_runs_small_on_the_cpu_without_jax():
    code = (
        "import runpy, sys\n"
        f"g = runpy.run_path({str(QUICKSTART)!r})\n"
        "acc = g['main'](n_graphs=24, n_train=16, max_seg_nodes=32, "
        "hidden=8, epochs=10, finetune_epochs=1, device='cpu')\n"
        + NO_REFERENCE + "print('ACC', acc)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("16 train graphs, J_max=")
    assert lines[0].endswith("segments of <= 32 nodes, on cpu")
    assert lines[1].startswith("epoch 10: loss=")
    assert lines[2].startswith("test accuracy: ")
    acc = float(lines[-1].split()[1])
    assert 0.0 <= acc <= 1.0 and f"{acc:.3f}" in lines[2]
    if not torch.cuda.is_available():
        main = runpy.run_path(str(QUICKSTART))["main"]
        with pytest.raises(RuntimeError, match="is_available"):
            main()


def test_tpugraphs_ranking_runs_small_on_the_cpu_without_jax():
    """Four variants at 32 graphs, 2 epochs (6 timed steps each): the
    reference's columns, and its assertion that gst's step is slower
    than gst_e's (gst re-encodes every segment, gst_e one)."""
    code = (
        "import runpy, sys\n"
        f"g = runpy.run_path({str(RANKING)!r})\n"
        "r = g['main'](n_graphs=32, epochs=2, device='cpu')\n"
        + NO_REFERENCE +
        "print('OK', sorted(r))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0] == "variant      train_OPA  test_OPA  ms/iter"
    rows = [ln.split() for ln in lines[1:5]]
    assert [r[0] for r in rows] == ["gst", "gst_one", "gst_e", "gst_efd"]
    for r in rows:
        train_opa, test_opa, ms = map(float, r[1:])
        assert 0.0 <= train_opa <= 1.0 and 0.0 <= test_opa <= 1.0 and ms > 0
    assert lines[5] == "OK ['gst', 'gst_e', 'gst_efd', 'gst_one']"
