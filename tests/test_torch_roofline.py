"""The port's roofline (``roofline/analysis.py``) against the JAX
package's (``src/repro/roofline/analysis.py``):

  * ``param_counts`` and ``model_flops`` equal the reference's on every
    arch's full-size parameter shapes (``jax.eval_shape`` and the port's
    meta-device init allocate nothing);
  * ``analyze_trace`` of one matmul counts its FLOPs and its operand and
    result bytes exactly, views nothing;
  * a hand-placed DTensor matmul on a fake (2, 2) mesh records one
    all-gather of the expected bytes, as ``CommDebugMode`` counts it;
  * the report's terms, dominant term and useful-FLOPs figures follow the
    reference's formulas, given the same per-device counts and constants;
  * the port's constants are the H100's, no TPU figure among them.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.distributed.tensor import (Replicate, Shard,  # noqa: E402
                                      distribute_tensor)
from torch.distributed.tensor.debug import CommDebugMode  # noqa: E402

import repro.roofline.analysis as JR  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch.mesh import fake_mesh  # noqa: E402
from repro_torch.launch.specs import param_shapes  # noqa: E402
from repro_torch.roofline import analysis as R  # noqa: E402


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_and_model_flops_match(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    model = jbuild_model(jcfg)
    jt = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                           jnp.bfloat16))
    want = JR.param_counts(jt, jcfg.moe.top_k, jcfg.moe.num_experts)
    got = R.param_counts(param_shapes(cfg), cfg.moe.top_k,
                         cfg.moe.num_experts)
    assert got == want
    if cfg.moe.num_experts:
        assert got[1] < got[0]
    for kind in ("train", "infer"):
        assert R.model_flops(got[1], 4096.0, kind) == JR.model_flops(
            want[1], 4096.0, kind)


def test_analyze_trace_counts_one_matmul_exactly():
    a, b = torch.randn(64, 32), torch.randn(32, 48)
    rep, out = R.analyze_trace(lambda x, y: (x @ y).t(), (a, b), chips=1)
    assert out.shape == (48, 64)
    assert rep["flops_per_device"] == 2 * 64 * 32 * 48
    # A and B read once, the product written once; the transpose is a view
    assert rep["bytes_per_device"] == 4 * (64 * 32 + 32 * 48 + 64 * 48)
    assert rep["collective_bytes_per_device"]["total"] == 0.0
    mem = rep["memory_analysis"]
    assert mem["arg_bytes"] == 4 * (64 * 32 + 32 * 48)
    assert mem["temp_bytes"] == mem["accounting_bound_bytes"] == 4 * 64 * 48


def test_dtensor_matmul_records_the_expected_collective():
    with fake_mesh((2, 2), ("data", "model"), "cpu") as mesh:
        x = distribute_tensor(torch.randn(8, 16, 32), mesh,
                              [Shard(0), Replicate()])
        w = distribute_tensor(torch.randn(32, 64), mesh,
                              [Shard(0), Shard(1)])
        with CommDebugMode() as comm:
            rep, out = R.analyze_trace(lambda a, b: a @ b, (x, w), chips=4)
        assert out.placements == (Shard(0), Shard(2))
    counts = rep["collective_op_counts"]
    assert counts["all-gather"] == comm.get_total_counts() == 1
    assert sum(counts.values()) == 1
    # the weight's two row shards gathered: (16, 32) of f32 per device
    assert rep["collective_bytes_per_device"]["all-gather"] == 32 * 32 * 4
    # the local product: (4, 16, 32) @ (32, 32)
    assert rep["flops_per_device"] == 2 * 4 * 16 * 32 * 32
    assert rep["flops_global"] == 4 * rep["flops_per_device"]


class _Compiled:
    """What the reference's ``analyze_compiled`` reads of an executable."""

    def __init__(self, flops, nbytes, hlo):
        self._cost = {"flops": flops, "bytes accessed": nbytes}
        self._hlo = hlo

    def cost_analysis(self):
        return self._cost

    def as_text(self):
        return self._hlo

    def memory_analysis(self):
        return None


@pytest.mark.parametrize("flops,nbytes,coll", [
    (3.2e12, 1.1e9, 2.0e6), (1.0e9, 4.0e11, 0.0), (1.0e6, 1.0e3, 8.0e9)])
def test_terms_follow_the_reference_formulas(flops, nbytes, coll):
    n = int(coll // 4)
    hlo = (f"  %ag = f32[{n}] all-gather(f32[{n // 16}] %p), dimensions={{0}}"
           if n else "")
    hw = dict(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)
    want = JR.analyze_compiled(_Compiled(flops, nbytes, hlo), chips=256,
                               hw=JR.HW(**hw), n_active=1.9e9,
                               tokens=131072, kind="train")
    got = R.roofline_report(chips=256, flops_dev=flops, bytes_dev=nbytes,
                            coll={"all-gather": float(n * 4)},
                            counts={"all-gather": int(bool(n))},
                            mem_stats={}, hw=R.HW(**hw), n_active=1.9e9,
                            tokens=131072, kind="train")
    for k in ("chips", "flops_per_device", "flops_global",
              "bytes_per_device", "dominant", "model_flops",
              "useful_flops_ratio", "mfu_upper_bound"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    for k, v in want["terms_seconds"].items():
        assert got["terms_seconds"][k] == pytest.approx(v, rel=1e-12), k
    assert got["collective_bytes_per_device"]["total"] == \
        want["collective_bytes_per_device"]["total"]
    assert set(want) <= set(got)


def test_constants_are_the_h100s():
    hw = R.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == (989e12, 3.35e12, 450e9)
    assert {hw.peak_flops, hw.hbm_bw, hw.link_bw}.isdisjoint(
        {197e12, 819e9, 50e9})
