"""The port stands alone: ``src/repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package ``repro``."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
IMPORT_RE = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:[\s.,]|$)",
                       re.MULTILINE)


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_port_module_pulls_in_no_jax():
    mods = list(_port_modules())
    assert {"repro_torch.serve.engine", "repro_torch.graphs.experiment",
            "repro_torch.launch.train", "repro_torch.kernels.sed_pool",
            "repro_torch.optim.adamw", "repro_torch.kernels.quant",
            "repro_torch.dist", "repro_torch.dist.comm",
            "repro_torch.dist.exchange", "repro_torch.dist.table",
            "repro_torch.dist.train", "repro_torch.dist.pipeline",
            "repro_torch.launch.train_dist", "repro_torch.configs",
            "repro_torch.configs.base", "repro_torch.configs.internlm2_1_8b",
            "repro_torch.kernels.swa_attention", "repro_torch.models",
            "repro_torch.models.common", "repro_torch.models.blocks",
            "repro_torch.models.transformer", "repro_torch.models.registry",
            "repro_torch.launch.serve", "repro_torch.data",
            "repro_torch.data.tokens", "repro_torch.obs",
            "repro_torch.obs.export", "repro_torch.obs.gate",
            "repro_torch.obs.staleness", "repro_torch.obs.bench_diff"
            } <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_no_jax_or_repro_import_in_port_sources():
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "examples" / "serve_batched_torch.py",
        ROOT / "examples" / "llm_segment_training_torch.py"]
    assert len(files) > 10
    offenders = {str(f.relative_to(ROOT)): IMPORT_RE.findall(f.read_text())
                 for f in files if IMPORT_RE.search(f.read_text())}
    assert not offenders, offenders


def test_import_pattern_catches_what_it_should():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from repro.graphs import data", "import repro",
                 "    from repro.kernels.ops import x"):
        assert IMPORT_RE.search(line), line
    for line in ("import repro_torch", "from repro_torch.graphs import data",
                 "import jaxlib_free_name_x", "# not an import of jax"):
        assert not IMPORT_RE.search(line), line
