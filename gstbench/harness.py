"""What every path of the benchmark shares: the files found by name, the
port's configuration built from a cell's file, the traced
part of a window, memory readings and the comparison against limits.

Nothing here imports the program at module level: ``port()`` puts the
checkout's ``src/`` on ``sys.path`` and imports ``repro_torch`` when a run
asks for it.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
GIB = float(1 << 30)

# modules that no run of the port may load: compared by whole top-level
# name, so ``repro_torch`` is not ``repro``
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A Python file loaded by its path (metric readers and traffic kinds
    are named after what they serve, dots and dashes included)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the port's runs must not
    load."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def port():
    """The program's package, imported from the checkout's ``src/``."""
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").exists():
        raise FileNotFoundError(f"the port is not in this checkout: {src}")
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    import repro_torch
    return repro_torch


def arch_of(cfg: dict) -> dict:
    """The sizes of a configuration file under the port's names."""
    return {"name": cfg["name"], "d_model": cfg["hidden_size"],
            "num_layers": cfg["num_hidden_layers"],
            "num_heads": cfg["num_attention_heads"],
            "num_kv_heads": cfg["num_key_value_heads"],
            "head_dim": cfg["head_dim"], "d_ff": cfg["intermediate_size"],
            "vocab_size": cfg["vocab_size"], "act": cfg["hidden_act"],
            "norm": cfg["norm"],
            "norm_eps": cfg.get("rms_norm_eps", cfg.get("layer_norm_eps")),
            "rope_theta": cfg["rope_theta"],
            "tie_embeddings": cfg["tie_word_embeddings"]}


# the norm epsilons the port fixes (models/common.py): a file that states
# another cannot be run as it says
PORT_EPS = {"rmsnorm": 1e-6, "nonparam_ln": 1e-5}


def port_config(arch: dict, gst: dict):
    """The port's ``ArchConfig`` of a configuration file."""
    if not math.isclose(arch["norm_eps"], PORT_EPS[arch["norm"]]):
        raise ValueError(f"{arch['name']}: the port runs {arch['norm']} at "
                         f"eps {PORT_EPS[arch['norm']]}, the file states "
                         f"{arch['norm_eps']}")
    port()
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(
        name=arch["name"], family="dense", num_layers=arch["num_layers"],
        d_model=arch["d_model"], num_heads=arch["num_heads"],
        num_kv_heads=arch["num_kv_heads"], d_ff=arch["d_ff"],
        vocab_size=arch["vocab_size"], head_dim=arch["head_dim"],
        norm=arch["norm"], act=arch["act"], rope_theta=arch["rope_theta"],
        tie_embeddings=arch["tie_embeddings"],
        gst_num_segments=gst["segments"],
        gst_backprop_segments=gst["sampled"],
        gst_keep_prob=gst["keep_prob"], gst_num_classes=gst["classes"])


@dataclass
class Cell:
    """One run of one cell: what the files say and what the run needs."""
    name: str
    cfg: dict                  # configs/<config>.json
    arch: dict                 # its sizes under the port's names
    traffic: dict              # traffic/<mix>.json
    seed: int
    seconds: float
    trace: bool
    device: str                # "cuda" on the chip; "cpu" in the tests
    t0: float                  # when the run began (host clock)
    peaks: Optional[dict] = None
    excluded_s: float = 0.0    # check work done before the window
    marks: List[tuple] = field(default_factory=list)   # set-up by phase

    def mark(self, name: str) -> None:
        self.marks.append((name, time.perf_counter() - self.t0))

    @property
    def gst(self) -> dict:
        return self.cfg["gst"]


def synchronize(device: str) -> None:
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


def free_device(device: str) -> None:
    """Return what the program held to the allocator and the card."""
    gc.collect()
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def peak_bytes(device: str) -> int:
    if device != "cuda":
        return 0
    import torch
    return int(torch.cuda.max_memory_allocated())


class Traced:
    """The traced part of a window: ``units`` steps or requests, after
    ``skip`` of them, under ``torch.profiler``; summarised in memory, no
    trace file.  Off (``enabled`` False) it costs one comparison a unit."""

    def __init__(self, enabled: bool, skip: int, units: int, device: str):
        self.enabled, self.skip, self.units = enabled, skip, units
        self.device = device
        self.summary = None
        self._prof = None
        self._range = None
        self.traced: List[int] = []

    def before(self, i: int) -> None:
        if not self.enabled or self.summary is not None:
            return
        if i == self.skip and self._prof is None:
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            synchronize(self.device)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            self._range = torch.profiler.record_function("gstbench.window")
            self._range.__enter__()

    def after(self, i: int) -> None:
        if self._prof is None or self.summary is not None:
            return
        self.traced.append(i)
        if len(self.traced) == self.units:
            from gstbench import trace
            synchronize(self.device)
            self._range.__exit__(None, None, None)
            self._prof.__exit__(None, None, None)
            self.summary = trace.summarize(self._prof, "gstbench.window")
            self._prof = self._range = None

    def span(self, name: str):
        if self._prof is None:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)


def compare(readings: Dict[str, float], limits: Dict[str, float]) -> dict:
    """Each number compared beside its limit; a number that is not finite
    or is missing fails."""
    out = {}
    for name, limit in limits.items():
        value = readings.get(name, float("nan"))
        ok = math.isfinite(value) and value <= limit
        out[name] = {"value": value, "limit": limit, "ok": ok}
    return out


def norm_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[Callable[[str], bool]] = None) -> Dict[str, float]:
    """Per leaf: the gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    names = [n for n in ref if keep is None or keep(n)]
    med = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names}
