"""The dry run splits each step's work over 'model' as the reference's
shardings do (ROADMAP §C12–C15), pinned on the CPU at cuts of the full
configs on fake meshes (the full rows: ``chip_smoke.py`` ``dryrun`` and the
sweeps on the card):

  * C15: internlm2-1.8b prefill, reduced on a fake (2, 4) mesh and at full
    width cut to 2 layers (S 4096, B 32) on single(16,16), counts at most
    1.10 × the closed form a device (``dryrun.analytic_flops``) and the
    plain step's FLOPs split over the devices, with every projection
    matmul at its shard's width (a column-parallel product's output holds
    N/16 columns, a row-parallel product's input K/16) and no contraction
    that drops an operand's shard (``gathered_calls``); at decode the
    attention runs 1/16 of the heads on each device.  DTensor carried the
    row-parallel products' partial sums on and gathered the next
    projection's weight: ×2.57 the closed form at the reduced row, ×9.68
    at the 2-layer cut;
  * C16: where the query heads do not divide the 16-way axis
    (qwen2-vl-7b's 28 at the 2-layer decode row), each device runs a
    block of ceil(28 / 16) heads under the same ceiling, where the
    unflatten was gathered and every device ran all 28: ×5.76;
  * C13: grouped GQA at the 2-layer long_500k row counts at most 1.05 ×
    repeat's FLOPs a device, its bytes no higher (the query heads' unflatten
    into (8 KV, 2) over a 16-way axis was gathered: ×3.9);
  * C14: the chunked prefill at the 2-layer S 4096 row counts at most 1.05
    × the naive row's FLOPs a device, its collective bytes no higher;
  * C12: the gather dispatch of arctic-480b at full width cut to 1 layer
    (prefill S 1024, B 32) moves no more bytes and collective bytes a
    device than the einsum dispatch, with fewer FLOPs: each device
    scatters and gathers its own experts' pairs; and the expert runs'
    outputs sum to the whole dispatch's on plain tensors;
  * C18: a stack of a sharded tensor's copies (a prefill's stacked
    caches) is split as the tensor is.
"""
import dataclasses
from contextlib import contextmanager

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import (DTensor, Shard,  # noqa: E402
                                      distribute_tensor)
from torch.overrides import TorchFunctionMode  # noqa: E402

from repro_torch.configs.base import (InputShape, MoEConfig,  # noqa: E402
                                      get_config, reduced)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import fake_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402

SINGLE = ((16, 16), ("data", "model"))
CEILING = 1.10
SAME = 1.05
PREFILL = InputShape("prefill_32k", 4096, 32, "prefill")
DECODE = InputShape("decode_32k", 32768, 128, "decode")


class Products(TorchFunctionMode):
    """The traced step's matmuls on a 2-D ``DTensor`` weight, as (its
    placements, its shape, the input's and the output's local shapes), and
    its attention einsums' (equation, output's local shape)."""

    def __init__(self):
        super().__init__()
        self.matmuls, self.einsums = [], []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", "")
        if name in ("matmul", "__matmul__") and isinstance(
                args[1], DTensor) and args[1].ndim == 2:
            self.matmuls.append((args[1].placements, tuple(args[1].shape),
                                 tuple(args[0].to_local().shape),
                                 tuple(out.to_local().shape)))
        elif name == "einsum" and isinstance(out, DTensor):
            self.einsums.append((args[0], tuple(out.to_local().shape)))
        return out


def trace(cfg, shape, mesh_shape=SINGLE[0], **switches):
    """(the dry run's row of ``cfg`` at ``shape`` on a fake (data, model)
    mesh, the step's ``Products``)."""
    products = Products()
    inner = dryrun.fake_trace

    @contextmanager
    def recorded():
        with inner() as calls, products:
            yield calls

    dryrun.fake_trace = recorded
    try:
        with fake_mesh(mesh_shape, SINGLE[1], "cpu") as mesh:
            row = dryrun.trace_one(cfg, shape, mesh, mesh_name="fake",
                                   device="cpu", verbose=False, **switches)
    finally:
        dryrun.fake_trace = inner
    assert not dist.is_initialized()
    assert row["status"] == "ok"
    return row, products


def cut(arch, layers):
    return dataclasses.replace(get_config(arch), num_layers=layers)


_ROWS = {}


def row_of(key, cfg, shape, mesh_shape=SINGLE[0], **switches):
    """One trace a key for the file (the naive prefill serves C15 and C14)."""
    if key not in _ROWS:
        _ROWS[key] = trace(cfg, shape, mesh_shape, **switches)
    return _ROWS[key]


def check_projections(products, n_model: int):
    """Each projection matmul at its shard's width over 'model' (the mesh's
    last dim)."""
    assert products.matmuls
    for place, (K, N), x_local, out_local in products.matmuls:
        p = place[-1]
        if isinstance(p, Shard) and p.dim == 1:       # column-parallel
            assert out_local[-1] == N // n_model, (place, K, N, out_local)
        elif isinstance(p, Shard) and p.dim == 0:     # row-parallel
            assert x_local[-1] == K // n_model, (place, K, N, x_local)


def check_ceiling(cfg, shape, row, split):
    """At most 1.10 × the closed form and × the plain step, each over the
    ``split`` devices the step's batch and 'model' split it over."""
    assert row["work_split"] == split
    analytic = dryrun.analytic_flops(cfg, shape) / split
    assert row["flops_per_device"] <= CEILING * analytic
    assert row["flops_per_device"] <= CEILING * row["plain_flops_per_device"]
    assert row["gathered_calls"] == {}


def test_c15_reduced_prefill_runs_at_the_shards():
    cfg = reduced(get_config("internlm2-1.8b"))
    shape = InputShape("prefill_32k", 64, 8, "prefill")
    row, products = row_of("reduced", cfg, shape, (2, 4))
    check_ceiling(cfg, shape, row, 8)
    check_projections(products, 4)


def test_c15_full_width_prefill_runs_at_the_shards():
    cfg = cut("internlm2-1.8b", 2)
    row, products = row_of("naive", cfg, PREFILL)
    check_ceiling(cfg, PREFILL, row, 256)
    check_projections(products, 16)


def test_c15_decode_attends_a_sixteenth_of_the_heads():
    cfg = cut("internlm2-1.8b", 2)
    row, products = row_of("decode", cfg, DECODE)
    check_ceiling(cfg, DECODE, row, 256)
    check_projections(products, 16)
    logits = [out for eq, out in products.einsums
              if eq.startswith("bqhd,bkhd->bhqk")]
    assert len(logits) == cfg.num_layers
    assert all(out[1] == cfg.num_heads // 16 for out in logits)


def test_c16_heads_that_do_not_divide_split_in_blocks():
    """qwen2-vl-7b's 28 query heads on the 16-way axis: each device runs
    a block of ceil(28 / 16) = 2 (the last devices none), not all 28."""
    cfg = cut("qwen2-vl-7b", 2)
    assert cfg.num_heads % 16
    row, products = row_of("uneven", cfg, DECODE)
    check_ceiling(cfg, DECODE, row, 256)
    logits = [out for eq, out in products.einsums
              if eq.startswith("bqhd,bkhd->bhqk")]
    assert len(logits) == cfg.num_layers
    assert all(out[1] == -(-cfg.num_heads // 16) for out in logits)


def test_c13_grouped_long_context_decode_counts_what_repeat_counts():
    cfg = cut("internlm2-1.8b", 2)
    shape = InputShape("long_500k", 524288, 1, "decode")
    rows = {gqa: trace(cfg, shape, gqa=gqa)[0]
            for gqa in ("repeat", "grouped")}
    rep, grp = rows["repeat"], rows["grouped"]
    assert grp["opts"]["gqa"] == "grouped"
    assert grp["flops_per_device"] <= SAME * rep["flops_per_device"]
    assert grp["bytes_per_device"] <= rep["bytes_per_device"]
    # each device's query head against the one KV head it reads
    assert grp["local_scatter_calls"] == {"_grouped_attn": cfg.num_layers}


def test_c14_chunked_prefill_counts_what_naive_counts(monkeypatch):
    cfg = cut("internlm2-1.8b", 2)
    naive, _ = row_of("naive", cfg, PREFILL)
    chunked, _ = trace(cfg, PREFILL, attn_impl="chunked")
    assert chunked["opts"]["attn_impl"] == "chunked"
    assert chunked["flops_per_device"] <= SAME * naive["flops_per_device"]
    assert chunked["collective_bytes_per_device"]["total"] <= \
        naive["collective_bytes_per_device"]["total"]
    assert chunked["gathered_calls"] == {}


def test_c12_gather_dispatch_moves_no_more_than_einsum():
    cfg = cut("arctic-480b", 1)
    shape = InputShape("prefill_32k", 1024, 32, "prefill")
    rows = {mode: trace(cfg, shape, dispatch=mode)[0]
            for mode in ("einsum", "gather")}
    ein, gat = rows["einsum"], rows["gather"]
    assert gat["local_scatter_calls"]["_gather_dispatch"] == 1
    assert gat["flops_per_device"] < ein["flops_per_device"]
    assert gat["bytes_per_device"] <= ein["bytes_per_device"]
    assert gat["collective_bytes_per_device"]["total"] <= \
        ein["collective_bytes_per_device"]["total"]


def test_c18_a_stack_is_split_as_its_layers():
    """``t.new_empty((n,) + t.shape)`` of a sharded t, a prefill's stacked
    caches: split as t is, one dim on (DTensor made it whole on every
    device, and each layer's cache was gathered into it)."""
    with fake_mesh((2, 4), SINGLE[1], "cpu") as mesh:
        with dryrun.fake_trace() as calls:
            t = distribute_tensor(torch.empty(8, 6, 4), mesh,
                                  [Shard(0), Shard(2)])
            stack = t.new_zeros((3,) + tuple(t.shape))
            stack[1] = t
    assert stack.placements == (Shard(1), Shard(3))
    assert tuple(stack.to_local().shape) == (3, 4, 6, 1)
    assert calls.replicated == {}


@pytest.mark.parametrize("runs", [2, 4])
def test_gather_dispatch_expert_runs_sum_to_the_whole(runs):
    """``moe.gather_dispatch_ops`` over runs of the experts (``first``),
    what each device of the dry run computes, sums to the whole
    dispatch's output, a pair's dropped share included."""
    gen = torch.Generator().manual_seed(runs)
    cfg = MoEConfig(num_experts=8, top_k=2, expert_d_ff=16,
                    capacity_factor=0.75)
    p = moe.moe_params(gen, 12, cfg, "silu")
    x = torch.randn(3, 20, 12, generator=gen)
    logits = (x @ p["router"]).float()
    gates, mask, _ = moe._top_k_gating(logits, cfg.top_k)
    cap = moe.capacity(20, cfg)
    pos = torch.cumsum(mask, dim=1) * mask - 1.0
    keep = (pos < cap) & (mask > 0)
    pos_c = torch.clamp(pos, 0, cap - 1).long()
    args = (x, gates, pos_c, keep, cap, cfg.top_k, "silu")
    whole = moe.gather_dispatch_ops(p["experts"], *args)
    n = cfg.num_experts // runs
    parts = sum(moe.gather_dispatch_ops(
        {k: v[i * n:(i + 1) * n] for k, v in p["experts"].items()}, *args,
        first=i * n) for i in range(runs))
    torch.testing.assert_close(parts, whole, rtol=1e-6, atol=1e-6)
