"""The port's example scripts run on the CPU and import no JAX:
examples/serve_batched_torch.py serves the five reduced families;
examples/llm_segment_training_torch.py trains the ~27M-parameter
internlm2-family backbone with GST+EFD."""
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
