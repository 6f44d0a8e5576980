"""The port's dry run (``launch/dryrun.py``) on rwkv6-7b (the RWKV-6 recurrence), reduced, at train
and decode, on a fake (2, 2) mesh, each to an ``ok`` row with the
reference's keys (the checks of tests/test_torch_dryrun.py, where
internlm2-1.8b's rows are; a file an arch for the per-file time budget).
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_dryrun import check_row, trace_small  # noqa: E402


@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
def test_rwkv6_traces_ok(shape_name):
    cfg, row = trace_small("rwkv6-7b", shape_name)
    check_row(cfg, shape_name, row)
