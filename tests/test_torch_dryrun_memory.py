"""The dry run's memory count does not follow Python's collector (ROADMAP
§C24).

A storage of a traced step is freed in the count (``obs/memory.py::
LiveBytes``) when the step drops its last reference to it, as the card's
caching allocator frees it.  A storage that a reference cycle holds waits
for the collector instead, and when the collector runs depends on what
else the process has allocated.  DTensor re-raises a refused call inside
its own ``except``: the exception's traceback and the frame that caught it
form a cycle that holds every frame above (``f_back``: the model's layers)
and their tensors.  ``launch/dryrun.py::DTensorCalls.partitioned`` clears
those frames and keeps no exception past its return, and
``roofline/analysis.py::analyze_trace`` traces with the collector off and
reports what a ``gc.collect()`` after the trace frees
(``memory_analysis.collector_bytes``):

  * rows that retry calls DTensor cannot place (internlm2-1.8b's 8 KV
    heads over the 16-way 'model' axis at decode, whisper-large-v3's 20
    heads at prefill), cut in depth, on the production mesh
    single(16,16): the same temp bytes, to the byte, whether the caller's
    collector is off, at threshold 1 or at its default, and
    ``collector_bytes`` 0 (before the repair: 4.43e9 against 2.28e9 B for
    internlm2-1.8b);
  * after a retried call, in the forward or in a backward, with the
    collector off, no frame of its caller is left and a tensor local to
    the caller dies when the caller returns;
  * ``analyze_trace`` runs the step with the collector off and gives it
    back as it found it, also when the step raises;
  * a storage only the collector frees stays visible in the row;
  * ``launch/dryrun_compare.py`` holds sweeps to each other row by row:
    the counts to the first sweep's, two named sweeps' temp and peak
    bytes to each other, every ``collector_bytes`` to 0.
"""
import gc
import json
import types
import weakref
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import Shard, distribute_tensor  # noqa: E402

from repro_torch.configs.base import INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun, dryrun_compare  # noqa: E402
from repro_torch.launch.mesh import fake_mesh, \
    make_production_mesh  # noqa: E402
from repro_torch.roofline.analysis import analyze_trace  # noqa: E402

# (arch, shape, layers, seq_len or None): rows with calls DTensor refuses
# at the production mesh's 16-way 'model' axis, cut to trace in seconds
RETRIED = {
    "internlm2-1.8b-decode": ("internlm2-1.8b", "decode_32k", 2, None),
    "whisper-large-v3-prefill": ("whisper-large-v3", "prefill_32k", 1,
                                 1024),
}


def _set_collector(thresholds):
    """The collector off (None), or on at these thresholds."""
    if thresholds is None:
        gc.disable()
    else:
        gc.enable()
        gc.set_threshold(*thresholds)


def _trace(arch, shape_name, layers, seq_len):
    cfg = get_config(arch)
    cfg = replace(cfg, num_layers=layers,
                  num_encoder_layers=layers if cfg.is_encoder_decoder else 0)
    shape = INPUT_SHAPES[shape_name]
    if seq_len:
        shape = replace(shape, seq_len=seq_len)
    with make_production_mesh(device="cpu") as mesh:
        return dryrun.trace_one(cfg, shape, mesh, mesh_name="single(16,16)",
                                device="cpu", verbose=False)


@pytest.mark.parametrize("row", list(RETRIED))
def test_temp_bytes_do_not_follow_the_collector(row):
    arch, shape_name, layers, seq_len = RETRIED[row]
    was, default = gc.isenabled(), gc.get_threshold()
    settings = {"off": None, "threshold 1": (1,) + default[1:],
                "default": default}
    rows = {}
    try:
        for name, thresholds in settings.items():
            _set_collector(thresholds)
            rows[name] = _trace(arch, shape_name, layers, seq_len)
    finally:
        gc.set_threshold(*default)
        (gc.enable if was else gc.disable)()
    assert not dist.is_initialized()
    assert all(r["replicated_calls"] for r in rows.values())   # retried
    mem = {k: r["memory_analysis"] for k, r in rows.items()}
    for k, m in mem.items():
        assert rows[k]["flops_per_device"] == rows["off"]["flops_per_device"]
        assert m["temp_bytes"] == mem["off"]["temp_bytes"], (k, mem)
        assert m["peak_bytes"] == mem["off"]["peak_bytes"], (k, mem)
    assert all(m["collector_bytes"] == 0 for m in mem.values()), mem


def _renorm_step(w):
    return torch.renorm(w, 2, 0, 1e30) * 3.0


class _Renormed(torch.autograd.Function):
    """×3, whose backward runs ``aten.renorm`` (no DTensor strategy)."""

    @staticmethod
    def forward(ctx, x):
        return x * 3.0

    @staticmethod
    def backward(ctx, g):
        return _renorm_step(g)


def _renorm_grad(w):
    g, = torch.autograd.grad(_Renormed.apply(w * 2.0).sum(), [w])
    return g


@pytest.mark.parametrize("where", ["forward", "backward"])
def test_a_retried_call_lets_go_of_its_frames(where):
    step = _renorm_step if where == "forward" else _renorm_grad
    refs = []

    def caller(w):
        local = torch.empty(64)       # a tensor of the caller's frame
        refs.append(weakref.ref(local))
        return step(w)

    was = gc.isenabled()
    gc.disable()
    try:
        with fake_mesh((2, 2), ("data", "model"), "cpu") as mesh:
            with dryrun.fake_trace() as calls:
                w = distribute_tensor(torch.empty(8, 4), mesh,
                                      [Shard(0), Shard(1)])
                if where == "backward":
                    w = w.requires_grad_()
                out = caller(w)
            assert out.shape == (8, 4)
            assert calls.replicated == {
                "renorm over data,model" if where == "forward"
                else "aten.renorm.default over data,model": 1}
            assert refs[0]() is None
            assert not [o for o in gc.get_objects()
                        if type(o) is types.FrameType
                        and o.f_code is caller.__code__]
    finally:
        if was:
            gc.enable()


@pytest.mark.parametrize("enabled", [True, False])
def test_analyze_trace_turns_the_collector_off_and_back(enabled):
    seen = []

    def step(x):
        seen.append(gc.isenabled())
        return x * 2.0

    def failing(x):
        seen.append(gc.isenabled())
        raise ValueError("the step failed")

    was = gc.isenabled()
    try:
        (gc.enable if enabled else gc.disable)()
        rep, out = analyze_trace(step, (torch.ones(4),), chips=1)
        assert torch.equal(out, torch.full((4,), 2.0))
        assert gc.isenabled() == enabled
        with pytest.raises(ValueError, match="the step failed"):
            analyze_trace(failing, (torch.ones(4),), chips=1)
        assert gc.isenabled() == enabled
    finally:
        (gc.enable if was else gc.disable)()
    assert seen == [False, False]
    assert rep["memory_analysis"]["collector_bytes"] == 0


def test_a_storage_only_the_collector_frees_stays_visible():
    def step(x):
        y = x * 2.0                   # 64 B, held by a cycle
        box = [y]
        box.append(box)
        return x + 1.0                # 64 B, the step's output

    rep, _ = analyze_trace(step, (torch.ones(16),), chips=1)
    mem = rep["memory_analysis"]
    assert mem["collector_bytes"] == 64
    assert mem["temp_bytes"] == 128           # not subtracted


def _sweep(tmp_path, name, temp, collector=0, flops=1.0):
    rows = [{"arch": "a", "shape": s, "mesh": "single(16,16)",
             "status": "ok", "flops_per_device": flops,
             "bytes_per_device": 2.0,
             "collective_bytes_per_device": {"total": 3.0},
             "collective_op_counts": {"all-gather": 1},
             "memory_analysis": {"temp_bytes": t, "peak_bytes": t + 10,
                                 "collector_bytes": collector}}
            for s, t in zip(("decode_32k", "prefill_32k"), temp)]
    rows.append({"arch": "a", "shape": "long_500k", "mesh": "single(16,16)",
                 "status": "skipped (DESIGN.md §Skips)"})
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(rows))
    return f"{name}={path}"


@pytest.mark.parametrize("case, rc", [
    ("repeatable", 0), ("second_run_moved", 1), ("collector_bytes", 1),
    ("flops_moved", 1)])
def test_sweeps_compare_row_by_row(tmp_path, capsys, case, rc):
    """``launch/dryrun_compare.py``: the counts held to the basis, the
    temp bytes that moved listed, the repeat and ``collector_bytes``
    gated."""
    parent = _sweep(tmp_path, "parent", (100, 200))
    change = _sweep(tmp_path, "change", (100, 150),
                    collector=7 if case == "collector_bytes" else 0,
                    flops=2.0 if case == "flops_moved" else 1.0)
    again = _sweep(tmp_path, "change2", (100, 151 if case ==
                                         "second_run_moved" else 150))
    got = dryrun_compare.main([parent, change, again, "--same-memory",
                               "change,change2"])
    out = capsys.readouterr().out
    assert got == rc
    assert "parent: 3 rows, {'ok': 2, 'skipped': 1}" in out
    assert "| a | prefill_32k | single(16,16) | temp_bytes | 2.0000e+02 | " \
           "1.5000e+02 |" in out
    assert "decode_32k | single(16,16) | temp_bytes" not in out
    assert ("collector_bytes 7" in out) == (case == "collector_bytes")
    assert ("equal in 2 of 2 ok rows" in out.split("change vs parent")[1]
            .splitlines()[0]) == (case != "flops_moved")
