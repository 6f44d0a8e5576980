"""The port's production-mesh dry run (``launch/dryrun.py``) on the CPU,
on a fake (2, 2) ("data", "model") mesh with reduced configs and small
shapes (the counterpart of tests/test_sharding_launch.py's lowering on
the debug mesh; the full sizes on the production meshes are the chip's
and the CLI's):

  * internlm2-1.8b at train and decode traces to an ``ok`` row with the
    reference's keys (``trace_s`` for ``lower_s``/``compile_s``), FLOPs
    at least those of its projections and, at decode, at most 1.10 × the
    plain step's split over the devices (and × the closed form,
    ``dryrun.analytic_flops``), ``useful_flops_ratio`` positive;
    zamba2-1.2b and rwkv6-7b: tests/test_torch_dryrun_{zamba2,rwkv6}.py;
  * the reference's five exact rewrites act through their flags, each
    traced on a row that runs it and recorded in ``opts``;
    ``--no-unroll`` raises, and ``--head-aligned-sharding`` acts;
  * no process group is left after a trace, and a mesh refuses to start
    beside one;
  * ``run_one`` skips exactly the pairs the reference skips.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES,  # noqa: E402
                                      InputShape, get_config, reduced)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch.mesh import fake_mesh, make_debug_mesh, \
    make_production_mesh  # noqa: E402
from repro_torch.models import common, mla, moe  # noqa: E402

SMALL = {"train_4k": InputShape("train_4k", 16, 4, "train"),
         "prefill_32k": InputShape("prefill_32k", 16, 4, "prefill"),
         "decode_32k": InputShape("decode_32k", 32, 4, "decode")}
# the keys of a row of src/repro/launch/dryrun.py::run_one (its
# analyze_compiled report and what run_one adds), less lower_s/compile_s
REF_KEYS = {"chips", "flops_per_device", "flops_global", "bytes_per_device",
            "collective_bytes_per_device", "collective_op_counts",
            "terms_seconds", "dominant", "memory_analysis", "model_flops",
            "useful_flops_ratio", "mfu_upper_bound", "arch", "shape", "mesh",
            "status", "variant", "opts", "params_total", "params_active",
            "tokens_per_step"}
# a serving row's FLOPs a device over the plain step's split over the
# devices (ROADMAP §C15)
CEILING = 1.10
# the rules' projections: the weights a step multiplies by (the embedding
# is a lookup, the conv a depthwise filter)
_PROJ = [pat for pat, _ in SH._RULES if "embed" not in pat
         and "conv_w" not in pat]


def projection_params(cfg, train: bool) -> int:
    """Parameters of the projections a step multiplies by; GST's train
    step encodes segments and never reaches the LM head."""
    import re

    from repro_torch.launch.specs import param_shapes

    out = {}
    SH._tree_map_with_path(lambda p, leaf: out.__setitem__(p, leaf),
                           param_shapes(cfg))
    return sum(leaf.numel() for p, leaf in out.items()
               if any(re.search(pat, p) for pat in _PROJ)
               and not (train and p.endswith("lm_head")))


def trace_small(arch, shape_name, replace=None, mesh_shape=(2, 2), **kw):
    cfg = reduced(get_config(arch))
    if replace:
        cfg = dataclasses.replace(cfg, **replace)
    with fake_mesh(mesh_shape, ("data", "model"), "cpu") as mesh:
        row = dryrun.trace_one(cfg, SMALL[shape_name], mesh,
                               mesh_name="fake(%d,%d)" % mesh_shape,
                               device="cpu", verbose=False, **kw)
    assert not dist.is_initialized()
    return cfg, row


def check_row(cfg, shape_name, row, chips=4, mesh="fake(2,2)"):
    shape = SMALL[shape_name]
    assert row["status"] == "ok"
    assert REF_KEYS | {"trace_s"} <= set(row)
    assert ("decode_plan" in row) == (shape.kind == "decode")
    assert row["chips"] == chips and row["mesh"] == mesh
    assert row["opts"]["use_kernels"] is False
    train = shape.kind == "train"
    assert row["variant"] == ("gst_efd" if train else None)
    assert row["useful_flops_ratio"] > 0
    floor = (6 if train else 2) * projection_params(cfg, train) * \
        row["tokens_per_step"]
    assert row["flops_global"] >= floor
    if not train:
        # the ceiling: no device repeats work that the step's split over
        # the batch and 'model' gives another (the plain step's FLOPs over
        # the devices it splits over; a dense decoder's closed form too)
        assert row["flops_per_device"] <= \
            CEILING * row["plain_flops_per_device"]
        if cfg.family in ("dense", "vlm"):
            assert row["flops_per_device"] <= CEILING * \
                dryrun.analytic_flops(cfg, shape) / row["work_split"]
    assert row["collective_bytes_per_device"]["total"] > 0
    mem = row["memory_analysis"]
    assert mem["peak_bytes"] == mem["arg_bytes"] + mem["temp_bytes"] > 0


@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
def test_internlm2_traces_ok_with_the_reference_keys(shape_name):
    cfg, row = trace_small("internlm2-1.8b", shape_name)
    check_row(cfg, shape_name, row)


def test_head_aligned_sharding_acts():
    # reduced internlm2's 4 heads of 64 on an 8-way model axis: the 256
    # columns of wq divide, the heads do not, so the override replicates
    # the attention projections over 'model'
    cfg = reduced(get_config("internlm2-1.8b"))
    with fake_mesh((1, 8), ("data", "model"), "cpu") as mesh:
        over = SH.head_aligned_overrides(cfg, mesh)
        wq = ("runs/0/attn/wq", (2, 256, 256))
        assert SH.spec_for_path(mesh, *wq) == (None, "data", "model")
        assert SH.spec_for_path(mesh, *wq, over) == (None, "data", None)
        rows = [dryrun.trace_one(cfg, SMALL["decode_32k"], mesh,
                                 mesh_name="fake(1,8)", device="cpu",
                                 head_aligned=h, verbose=False)
                for h in (False, True)]
    assert [r["opts"]["head_aligned"] for r in rows] == [False, True]
    assert all(r["status"] == "ok" for r in rows)
    # replicated attention weights: more of them on each device
    assert rows[1]["memory_analysis"]["arg_bytes"] > \
        rows[0]["memory_analysis"]["arg_bytes"]


@pytest.mark.parametrize("flag", [["--no-unroll"]])
def test_speed_switches_raise(flag):
    with pytest.raises(ValueError, match="cannot act in the port"):
        dryrun.main(["--arch", "internlm2-1.8b", "--shape", "train_4k",
                     "--device", "cpu", *flag])


# flag -> (arch, its reduced config's changes, a shape whose step runs the
# switched code, the mesh, what opts records).  A new op's first
# placements send DTensor's redistribute planner into a search of seconds
# on a (2, 2) mesh: the rows take a model axis of 1 (the gather dispatch
# with sharded experts: tests/test_torch_dryrun_faults.py, C11; the full
# meshes: the chip's sweep)
SWITCH_ROWS = {
    "--dispatch gather": ("arctic-480b", None, "prefill_32k", (2, 1),
                          {"dispatch": "gather"}),
    "--cache-update onehot": ("internlm2-1.8b", None, "decode_32k", (2, 1),
                              {"cache_update": "onehot"}),
    # 16 tokens in chunks of 8 (the test sets ATTN_CHUNK)
    "--attn-impl chunked": ("internlm2-1.8b", None, "prefill_32k", (2, 1),
                            {"attn_impl": "chunked"}),
    "--mla-naive": ("deepseek-v3-671b", None, "decode_32k", (2, 1),
                    {"mla_absorbed": False}),
    "--gqa grouped": ("internlm2-1.8b", {"num_kv_heads": 2}, "decode_32k",
                      (2, 1), {"gqa": "grouped"}),
}


@pytest.mark.parametrize("flag", list(SWITCH_ROWS))
def test_speed_switches_act(flag, monkeypatch):
    """Each flag of the reference's exact rewrites, parsed as the CLI
    parses it, traces an ok row with the switch recorded in ``opts`` (and
    the port's defaults beside it), the models' attributes restored."""
    arch, replace, shape_name, mesh_shape, want = SWITCH_ROWS[flag]
    monkeypatch.setattr(common, "ATTN_CHUNK", 8)
    args = dryrun.build_parser().parse_args(flag.split())
    switches = {name: getattr(args, name) for name in dryrun.SWITCHES}
    before = (moe.DISPATCH_MODE, common.CACHE_UPDATE, common.ATTN_IMPL,
              common.GQA_IMPL, mla.ABSORBED_DECODE)
    _, row = trace_small(arch, shape_name, replace, mesh_shape, **switches)
    assert (moe.DISPATCH_MODE, common.CACHE_UPDATE, common.ATTN_IMPL,
            common.GQA_IMPL, mla.ABSORBED_DECODE) == before
    assert row["status"] == "ok"
    defaults = {"dispatch": "einsum", "cache_update": "dus",
                "attn_impl": "naive", "mla_absorbed": True, "unroll": True,
                "gqa": "repeat", "use_kernels": False, "head_aligned": False}
    assert row["opts"] == {**defaults, **want}


def test_no_group_is_left_and_a_mesh_refuses_a_live_group():
    assert not dist.is_initialized()
    with make_production_mesh(device="cpu") as mesh:
        assert mesh.size() == 256 and dist.get_world_size() == 256
        with pytest.raises(RuntimeError, match="already initialised"):
            with make_production_mesh(multi_pod=True, device="cpu"):
                pass
    assert not dist.is_initialized()
    with make_debug_mesh("cpu") as mesh:
        assert mesh.shape == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        with fake_mesh((2, 2), ("data", "model"), "cpu"):
            raise ValueError("a trace that fails")
    assert not dist.is_initialized()


def test_run_one_skips_what_the_reference_skips():
    skipped = set()
    for arch in ARCH_IDS:
        for name, shape in INPUT_SHAPES.items():
            if not jget_config(arch).supports_shape(shape):
                row = dryrun.run_one(arch, name, False, device="cpu")
                assert row["status"].startswith("skipped")
                skipped.add((arch, name))
            assert get_config(arch).supports_shape(shape) == \
                jget_config(arch).supports_shape(shape)
    assert skipped == {("whisper-large-v3", "long_500k")}
    assert not dist.is_initialized()


def test_local_scatter_writes_the_shards_it_may():
    """The in-place scatter of a decode step's cache write on the local
    shards (torch versions whose DTensor has no scatter strategy, or none
    that keeps a sequence-sharded target): the plain scatter's values on
    a real 1x1 mesh, the target sharded along its batch or along the
    scatter dim; refused where the scatter dim is sharded and an index
    names two slots of a row."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    gen = torch.Generator().manual_seed(0)
    cache = torch.randn(4, 8, 3, generator=gen)
    new = torch.randn(4, 1, 3, generator=gen)
    at = torch.tensor([0, 7, 3, 3]).reshape(4, 1, 1).expand(4, 1, 3)
    want = cache.clone().scatter_(1, at, new)
    with make_debug_mesh("cpu") as mesh:
        c = distribute_tensor(cache.clone(), mesh, [Shard(0), Replicate()])
        assert dryrun._local_scatter(c, 1, at, new)
        assert torch.equal(c.full_tensor(), want)
        seq = distribute_tensor(cache.clone(), mesh, [Replicate(), Shard(1)])
        assert dryrun._local_scatter(seq, 1, at, new)
        assert torch.equal(seq.full_tensor(), want)
        two = torch.zeros(4, 2, 3, dtype=torch.long)
        assert not dryrun._local_scatter(seq, 1, two, new.expand(4, 2, 3))
    assert not dist.is_initialized()
