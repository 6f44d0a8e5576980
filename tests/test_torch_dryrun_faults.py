"""The dry run's faults found on the production mesh (ROADMAP §C7–C10),
each pinned on the CPU with reduced configs on fake meshes (the checks
of tests/test_torch_dryrun.py):

  * C7: an op that autograd runs (a backward's) and DTensor has no
    strategy for is gathered inside the graph, counted in
    ``replicated_calls`` under its aten name, and its gradient is the
    plain one on the real 1x1 mesh; arctic-480b's train step traces on a
    (1, 8) mesh, whose 8-way model axis does not divide the reduced 4
    heads (the full size's 56 over 16), its backward traced, and gathers
    only the forward's head unflattens: its einsums run on the local
    shards (``dryrun._local_einsum``), so the MoE dispatch's gradient no
    longer meets the views that DTensor could not take at the operands'
    placements (torch 2.13: gathered by ``AtenCalls`` before ROADMAP
    §C15);
  * C8: a decode write into a cache sharded along its slots goes to the
    shard that owns the slot (owner computes), the plain ``scatter_``'s
    values (on the 1x1 mesh: tests/test_torch_dryrun.py::
    test_local_scatter_writes_the_shards_it_may); deepseek-v3's
    long-context decode (``seq_shard``) traces;
  * C9: on the (pod, data, model) mesh the FSDP dims live on one
    flattened pod·data dim, each shard the reference's
    (``src/repro/launch/sharding.py``), and internlm2-1.8b's train and
    decode rows trace;
  * C10: rwkv6's token loop (``models/rwkv6.py::wkv_scan``) runs on each
    device's batch and heads (``launch/dryrun.py::LOCAL_CALLS``), and a
    loop longer than ``LOOP_STEPS`` runs at 2 and 3 steps and is counted
    at its length (``counted_loop``).  Reduced rwkv6-7b (one layer) at S
    16: the
    train and prefill rows, the loop counted from its short runs, give
    the FLOPs, bytes a device and collectives (counts and bytes) of the
    plain DTensor trace, whose every step is a DTensor call; the whole
    local loop and the counted loop give the same, and their memory
    accounting too, with a backward or without.

  * C11: the gather dispatch (``--dispatch gather``,
    ``models/moe.py::_gather_dispatch``) keeps its expert input's batch
    sharded over 'data', as the einsum dispatch does: fewer FLOPs a
    device than the einsum dispatch on a mesh whose model axis shards
    the experts.

Every train row keeps ``check_row``'s floor of 6·N_proj·tokens FLOPs: the
backward was traced.  One file, so that one process pays DTensor's first
trace once.
"""
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from torch.distributed.tensor import (DTensor, Shard,  # noqa: E402
                                      distribute_tensor)

import repro.launch.sharding as JSH  # noqa: E402
from repro_torch.configs.base import (InputShape, get_config,  # noqa: E402
                                      reduced)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.launch.mesh import (POD_DATA, dtensor_mesh,  # noqa: E402
                                     fake_mesh, make_debug_mesh)
from repro_torch.models.rwkv6 import wkv_scan  # noqa: E402
from repro_torch.roofline.analysis import analyze_trace  # noqa: E402
from test_torch_dryrun import SMALL, check_row  # noqa: E402
from test_torch_sharding_launch import _ref_local  # noqa: E402

LONG = InputShape("long_500k", 64, 1, "decode")
POD = ((2, 2, 2), ("pod", "data", "model"))
S16 = {"train_4k": InputShape("train_4k", 16 * 4, 4, "train"),
       "prefill_32k": InputShape("prefill_32k", 16, 4, "prefill")}
COUNTS = ("flops_global", "bytes_per_device", "collective_op_counts",
          "collective_bytes_per_device")


class Renormed(torch.autograd.Function):
    """×3, whose backward runs ``aten.renorm`` (no DTensor strategy in
    torch 2.13) on the incoming gradient: an identity at this max norm."""

    @staticmethod
    def forward(ctx, x):
        return x * 3.0

    @staticmethod
    def backward(ctx, g):
        return torch.renorm(g, 2, 0, 1e30) * 3.0


def renorm_step(w, v):
    loss = (Renormed.apply(w * 2.0) * v).sum()
    g, = torch.autograd.grad(loss, [w])
    return g


def test_backward_op_without_strategy_is_gathered_in_the_graph():
    with fake_mesh((2, 2), ("data", "model"), "cpu") as mesh:
        with dryrun.fake_trace() as calls:
            place = [Shard(0), Shard(1)]
            w = distribute_tensor(torch.empty(8, 4), mesh,
                                  place).requires_grad_()
            v = distribute_tensor(torch.empty(8, 4), mesh, place)
            rep, g = analyze_trace(renorm_step, (w, v), chips=4)
    assert g.shape == (8, 4)
    assert calls.replicated == {"aten.renorm.default over data,model": 1}
    # the gradient's gather is counted: the graph ran the backward
    assert rep["collective_op_counts"]["all-gather"] >= 1
    assert not dist.is_initialized()
    # the same step for real on the 1x1 mesh: the plain gradient
    gen = torch.Generator().manual_seed(0)
    x, y = torch.randn(8, 4, generator=gen), torch.randn(8, 4, generator=gen)
    want = renorm_step(x.clone().requires_grad_(), y)
    with make_debug_mesh("cpu") as mesh:
        calls = dryrun.DTensorCalls()
        w = distribute_tensor(x.clone(), mesh, place).requires_grad_()
        with calls:
            g = renorm_step(w, distribute_tensor(y, mesh, place))
        assert torch.equal(g.full_tensor(), want)
    assert calls.replicated == {"aten.renorm.default over data,model": 1}


def test_owner_scatter_writes_the_slots_its_shard_holds():
    """A cache split along its slots into four shards: each shard's write
    at its offset, put back together, is the plain ``scatter_``."""
    gen = torch.Generator().manual_seed(1)
    cache = torch.randn(3, 16, 2, generator=gen)
    new = torch.randn(3, 1, 2, generator=gen)
    at = torch.tensor([0, 9, 15]).reshape(3, 1, 1).expand(3, 1, 2)
    want = cache.clone().scatter_(1, at, new)
    shards = [c.clone() for c in cache.chunk(4, dim=1)]
    for i, shard in enumerate(shards):
        dryrun._owner_scatter(shard, 1, at, new, 4 * i)
    assert torch.equal(torch.cat(shards, dim=1), want)


def test_deepseek_long_context_decode_traces_sequence_sharded():
    cfg = reduced(get_config("deepseek-v3-671b"))
    with fake_mesh((2, 2), ("data", "model"), "cpu") as mesh:
        row = dryrun.trace_one(cfg, LONG, mesh, mesh_name="fake(2,2)",
                               device="cpu", verbose=False)
    assert row["status"] == "ok" and row["decode_plan"]["seq_shard"]
    # the latent and rope caches of both layers, each written by its owner,
    # and the MoE layer's experts on their shards (C17)
    assert row["local_scatter_calls"] == {
        "scatter_": 2 * cfg.num_layers,
        "_decode_experts": sum("moe" in k for k in cfg.layer_kinds())}
    assert row["flops_global"] > 0 and \
        row["collective_bytes_per_device"]["total"] > 0


def _leaves(spec_tree, sh_tree, val_tree, out):
    if isinstance(val_tree, torch.Tensor):
        out.append((tuple(spec_tree.shape), sh_tree, val_tree))
    elif isinstance(val_tree, dict):
        for k in val_tree:
            _leaves(spec_tree[k], sh_tree[k], val_tree[k], out)
    elif isinstance(val_tree, (list, tuple)):
        for i, v in enumerate(val_tree):
            _leaves(spec_tree[i], sh_tree[i], v, out)
    return out


@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
def test_multi_pod_rows_trace_with_the_reference_shards(shape_name):
    cfg = reduced(get_config("internlm2-1.8b"))
    shape = SMALL[shape_name]
    jmesh = AbstractMesh(*POD)
    with fake_mesh(*POD, "cpu") as mesh:
        flat = dtensor_mesh(mesh)
        assert flat.mesh_dim_names == (POD_DATA, "model")
        assert flat.shape == (4, 2) and flat.size() == mesh.size()
        spec = SP.build_step_spec(cfg, shape, mesh, device="cpu")
        # the parameters' specs are the reference's on the pod mesh
        params = spec.args[0]["backbone"] if shape.kind == "train" \
            else spec.args[0]
        SH._tree_map_with_path(lambda p, leaf: _same_spec(jmesh, mesh, p,
                                                          leaf), params)
        with dryrun.fake_trace():
            args = SP.materialize(spec, mesh, "cpu")
            leaves = _leaves(spec.args, spec.shardings, args, [])
        assert leaves
        for full, sh, t in leaves:
            assert isinstance(t, DTensor) and t.device_mesh is flat
            assert tuple(t.to_local().shape) == _ref_local(
                jmesh, sh or (), full)
        row = dryrun.trace_one(cfg, shape, mesh, mesh_name="fake(2,2)",
                               device="cpu", verbose=False)
    assert not dist.is_initialized()
    check_row(cfg, shape_name, row, chips=8)


def _same_spec(jmesh, mesh, path, leaf):
    shape = tuple(leaf.shape)
    assert SH.spec_for_path(mesh, path, shape) == tuple(
        JSH.spec_for_path(jmesh, path, shape)), path


def test_arctic_train_traces_on_an_uneven_head_split():
    cfg = reduced(get_config("arctic-480b"))
    assert cfg.num_heads % 8
    with fake_mesh((1, 8), ("data", "model"), "cpu") as mesh:
        row = dryrun.trace_one(cfg, SMALL["train_4k"], mesh,
                               mesh_name="fake(1,8)", device="cpu",
                               verbose=False)
    assert not dist.is_initialized()
    check_row(cfg, "train_4k", row, chips=8, mesh="fake(1,8)")
    assert set(row["replicated_calls"]) == {"reshape over model"}


def _row(cfg, shape):
    with fake_mesh((2, 2), ("data", "model"), "cpu") as mesh:
        row = dryrun.trace_one(cfg, shape, mesh, mesh_name="fake(2,2)",
                               device="cpu", verbose=False)
    assert not dist.is_initialized()
    return row


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k"])
def test_local_loop_counts_what_the_plain_trace_counts(shape_name,
                                                       monkeypatch):
    # one layer: the plain trace dispatches each of its steps to DTensor
    cfg = replace(reduced(get_config("rwkv6-7b")), num_layers=1)
    shape = S16[shape_name]
    if shape.kind == "train":     # a segment is 16 tokens: 16 steps
        assert shape.seq_len // cfg.gst_num_segments == 16
    monkeypatch.setattr(dryrun, "LOOP_STEPS", 3)
    counted = _row(cfg, shape)
    monkeypatch.setattr(dryrun, "LOOP_STEPS", 16)
    whole = _row(cfg, shape)
    # the loop alone run op by op; a train step's segment gather keeps its
    # runner (C21)
    monkeypatch.delitem(dryrun.LOCAL_CALLS, wkv_scan)
    plain = _row(cfg, shape)
    gather = {"gather_segments": 1} if shape.kind == "train" else {}
    assert counted["local_scatter_calls"] == whole["local_scatter_calls"] \
        == {"wkv_scan": cfg.num_layers, **gather}
    assert plain["local_scatter_calls"] == gather
    for key in COUNTS:
        assert counted[key] == plain[key], key
        assert whole[key] == plain[key], key
    assert whole["memory_analysis"] == plain["memory_analysis"]
    # the counted loop's storages are extrapolated from its short runs,
    # exact with a backward too: the short runs, whose inputs are views of
    # the loop's, go with the loop's backward (kept until the graph was
    # dropped, they held that input's storage: +2.1% here)
    assert counted["memory_analysis"] == plain["memory_analysis"]
    if shape.kind == "train":
        check_row(cfg, "train_4k", counted)    # the backward is counted


def test_gather_dispatch_keeps_the_batch_sharded():
    """C11: a one-layer arctic-480b with 32 experts on a (4, 16) mesh
    (the experts over the 16-way model axis), prefill: the gather
    dispatch's scatter and gather along the flattened (expert, slot)
    cells keep the expert input sharded over 'data' by batch, so it
    traces fewer FLOPs a device than the einsum dispatch (its dispatch
    and combine einsums gone).  Scattered by ``index_put``, the expert
    input came out replicated over 'data' and every device ran every
    row's experts: ×1.22 the einsum dispatch's FLOPs here, ×14.7 a device
    on the card's full-size train_4k rows."""
    cfg = reduced(get_config("arctic-480b"))
    cfg = replace(cfg, num_layers=1, moe=replace(cfg.moe, num_experts=32))
    flops = {}
    for mode in ("einsum", "gather"):
        with fake_mesh((4, 16), ("data", "model"), "cpu") as mesh:
            row = dryrun.trace_one(
                cfg, InputShape("prefill_32k", 64, 8, "prefill"), mesh,
                mesh_name="fake(4,16)", device="cpu", verbose=False,
                dispatch=mode)
        assert row["status"] == "ok" and row["opts"]["dispatch"] == mode
        flops[mode] = row["flops_per_device"]
    assert flops["gather"] < flops["einsum"]
