"""Build and load the port's CUDA kernels (nvcc into a shared library with a
plain C interface, loaded with ctypes).

Every ``*.cu`` file under ``csrc/`` is compiled at first use, for Hopper
only (``sm_90a``), into ``build/kernels/<name>-<hash>.so`` at the repo root,
keyed by a hash of the sources and the flags, so an edited source rebuilds
and an unchanged one loads the library already built.  No PyTorch header
is compiled (a source that includes them takes minutes to build, one with a
C interface seconds).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin): the CUDA kernels need the "
                           "CUDA toolkit to build")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its content and flags."""
    digest = hashlib.sha256()
    digest.update(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh", ".h"):
            digest.update(path.name.encode())
            digest.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; return its path.

    The compiler's report (registers, shared memory, spills from
    ``-Xptxas -v``) is kept beside the library as ``<lib>.log``."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = Path(tmp) / out.name
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp_out), str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                               f"{name}.cu:\n{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp_out, out)   # atomic: a concurrent loader sees all or nothing
    return out


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(build(name)))
        return lib
