"""Traffic kind ``train_efd``: GST-EFD training through the port's step.

Set-up builds the port's objects as ``launch/train.py::seq_setup`` does
(the model twice: the encode that trains without the attention kernel,
which has no backward, the no-grad one with it), around the benchmark's
seeded weights and a table that a first epoch has filled.  It then drives
that same state through the window's own feed and call for the checked
steps, and reads what the check compares: each step's loss, the first
gradient from AdamW's first moment, each leaf's change after the checked
steps, and the table rows those steps wrote.  The window runs the same
loop, closed, one step after another; a step completes when its loss has
been read on the host.  Once the window has closed and the peak memory
is read, the program's state is freed and the reference follows the
checked steps from the same weights, table, documents and draws.
"""
from __future__ import annotations

import math
import statistics
import time
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch

from gstbench import docs as D
from gstbench import flops, harness as H, weights as W
from gstbench.reference import gst as R
from gstbench.reference.precision import matmul_precision

# the change of leaves whose first gradient in the reference is below
# this share of the median leaf's is round-off alone (an unused LM head,
# moved by weight decay): left out of the change by this rule, not by name
ZERO_GRAD = 1e-3

# this kind's parameters at the sizes of the CPU tests (``testing.py``)
TINY = {"n_docs": 32, "seg_len": 16, "batch": 4}


def corpus(cell: H.Cell) -> Dict[str, np.ndarray]:
    tr, gst = cell.traffic, cell.gst
    return D.property_docs(tr["n_docs"], gst["segments"], tr["seg_len"],
                           cell.arch["vocab_size"], gst["classes"],
                           tr["topic_band_share"], cell.seed, tag=1)


def step_ids(cell: H.Cell, order: np.ndarray, i: int) -> np.ndarray:
    """Documents of step ``i``: the next batch of the seed's order."""
    B = cell.traffic["batch"]
    return order[np.arange(i * B, (i + 1) * B) % len(order)]


def doc_order(cell: H.Cell) -> np.ndarray:
    return np.random.default_rng([cell.seed, 2]).permutation(
        cell.traffic["n_docs"])


def draws(cell: H.Cell, i: int):
    gst = cell.gst
    return W.train_draws(cell.seed, i, cell.traffic["batch"],
                         gst["segments"], gst["sampled"], cell.device)


def start_table(cell: H.Cell):
    """(emb, initialized) the run starts from."""
    tr, gst = cell.traffic, cell.gst
    shape = (tr["n_docs"], gst["segments"])
    if tr["table"] == "prefilled":
        return (W.table(*shape, cell.arch["d_model"], tr["table_std"],
                        cell.seed, cell.device),
                torch.ones(shape, dtype=torch.bool, device=cell.device))
    return (torch.zeros(shape + (cell.arch["d_model"],), device=cell.device),
            torch.zeros(shape, dtype=torch.bool, device=cell.device))


def build(cell: H.Cell):
    """The program's state, step and feed around the benchmark's inputs."""
    H.port()
    from repro_torch.core import gst as G
    from repro_torch.models import build_model
    from repro_torch.models.common import ParamTree
    from repro_torch.optim import make_optimizer
    from repro_torch.store import DeviceStore

    arch, gst, tr = cell.arch, cell.gst, cell.traffic
    dev = torch.device(cell.device)
    cfg = H.port_config(arch, gst)
    cell.mark("imports")
    model = build_model(cfg, use_kernels=True, device=dev)
    graded = build_model(cfg, use_kernels=False, device=dev)
    backbone = ParamTree(W.backbone(arch, cell.seed, dev))
    head = G.Head(arch["d_model"], gst["classes"], "mlp",
                  torch.Generator(dev)).to(dev)
    with torch.no_grad():
        for k, t in W.head(arch, gst["classes"], cell.seed, dev).items():
            getattr(head, k).copy_(t)
    opt = make_optimizer("adamw", lr=gst["lr"],
                         weight_decay=gst["weight_decay"],
                         max_grad_norm=gst["max_grad_norm"])
    store = DeviceStore(tr["n_docs"], gst["segments"], arch["d_model"],
                        device=dev)
    table = store.init_device_table()
    emb, init = start_table(cell)
    table.emb.copy_(emb)
    table.initialized.copy_(init)
    del emb, init
    state = G.TrainState(backbone, head, None, table, 0)
    state = state._replace(opt_state=opt.init(G.train_params(state)))

    def encode(bb, seg_inputs):
        return graded.encode_segment(bb.tree, seg_inputs)

    def recompute(bb, seg_inputs):
        return model.encode_segment(bb.tree, seg_inputs)

    step = G.make_train_step(encode, opt, G.VARIANTS[gst["variant"]],
                             num_sampled=gst["sampled"],
                             keep_prob=gst["keep_prob"], use_kernels=True,
                             recompute_fn=recompute)
    cell.mark("weights and state")
    docs = corpus(cell)
    cell.mark("documents")
    return SimpleNamespace(model=model, graded=graded, state=state,
                           step=step, store=store, docs=docs,
                           order=doc_order(cell), host_s=[])


def one_step(cell: H.Cell, prog, i: int, tracer: H.Traced) -> float:
    """Step ``i`` through the feed and the call the window drives; the
    loss as read on the host."""
    from repro_torch.launch.train import seq_batch
    ids = step_ids(cell, prog.order, i)
    t = time.perf_counter()
    with tracer.span("gst.prepare"):
        table, slots = prog.store.prepare(prog.state.table, ids, step=i)
    with tracer.span("gst.batch"):
        d = prog.docs
        batch = seq_batch(prog.model, ({"tokens": d["tokens"][ids]},
                                       d["seg_valid"][ids],
                                       ids.astype(np.int32),
                                       d["labels"][ids]),
                          slots, cell.seed, i)
    prog.host_s.append(time.perf_counter() - t)
    with tracer.span("gst.step"):
        prog.state, m = prog.step(prog.state._replace(table=table), batch,
                                  draws=draws(cell, i))
    with tracer.span("gst.loss_read"):
        return float(m["loss"])


def named_leaves(state):
    return ([(n, p) for n, p in state.backbone.named_parameters()]
            + [(f"head.{n}", p) for n, p in state.head.named_parameters()])


def start_leaf(cell: H.Cell, name: str) -> torch.Tensor:
    if name.startswith("head."):
        return W.head(cell.arch, cell.gst["classes"], cell.seed,
                      cell.device)[name[5:]]
    return W.backbone_leaf(cell.arch, cell.seed, name, cell.device)


def written_rows(cell: H.Cell, order, emb: torch.Tensor) -> np.ndarray:
    """The table rows the checked steps wrote: (steps, B, S, d) on the
    host."""
    out = []
    for i in range(cell.traffic["checked_steps"]):
        ids = torch.as_tensor(step_ids(cell, order, i), device=emb.device)
        idx = draws(cell, i)[0]
        out.append(emb[ids[:, None].expand_as(idx), idx].cpu().numpy())
    return np.stack(out)


def checked_steps(cell: H.Cell, prog) -> dict:
    """Drive the checked steps and read what the check compares.  The
    seconds spent reading (not the steps) go to ``cell.excluded_s``."""
    off = H.Traced(False, 0, 0, cell.device)
    losses, grad = [], {}
    for i in range(cell.traffic["checked_steps"]):
        losses.append(one_step(cell, prog, i, off))
        if i == 0:
            t = time.perf_counter()
            b1 = 0.9   # optim/adamw.py's default, which make_optimizer keeps
            for (name, _), mu in zip(named_leaves(prog.state),
                                     prog.state.opt_state["mu"]):
                grad[name] = float(torch.linalg.vector_norm(mu)) / (1 - b1)
            cell.excluded_s += time.perf_counter() - t
    t = time.perf_counter()
    change = {}
    with torch.no_grad():
        for name, p in named_leaves(prog.state):
            p0 = start_leaf(cell, name)
            change[name] = float(torch.linalg.vector_norm(p - p0))
            del p0
    rows = written_rows(cell, prog.order, prog.state.table.emb)
    cell.excluded_s += time.perf_counter() - t
    cell.mark("checked steps")
    return {"losses": losses, "grad": grad, "change": change, "rows": rows}


def window(cell: H.Cell, prog) -> dict:
    """Steps one after another for ``cell.seconds``; every step's
    segments over the whole window's time."""
    tr = cell.traffic
    tracer = H.Traced(cell.trace, tr["trace_skip"], tr["trace_units"],
                      cell.device)
    H.synchronize(cell.device)
    setup_s = time.perf_counter() - cell.t0 - cell.excluded_s
    prog.host_s = []
    n = failed = 0
    i = tr["checked_steps"]
    t0 = time.perf_counter()
    while True:
        tracer.before(n)
        loss = one_step(cell, prog, i, tracer)
        tracer.after(n)
        failed += not math.isfinite(loss)
        n, i = n + 1, i + 1
        if time.perf_counter() - t0 >= cell.seconds and (
                not tracer.enabled or tracer.summary is not None):
            break
    window_s = time.perf_counter() - t0
    peak = H.peak_bytes(cell.device)
    gst = cell.gst
    segs = tr["batch"] * gst["segments"]
    step_flops = flops.train_step_flops(cell.arch, tr["batch"],
                                        gst["sampled"], tr["seg_len"],
                                        gst["classes"])
    return {
        "attempted": n, "failed": failed, "peak_bytes": peak,
        "end_to_end": {"train_segments_per_s": n * segs / window_s,
                       "peak_mem_gib": peak / H.GIB, "setup_s": setup_s},
        "record": {"kind": "train", "trace": tracer.summary,
                   "units": len(tracer.traced),
                   "flops": step_flops * len(tracer.traced),
                   "host_s": prog.host_s,
                   "peaks": cell.peaks},
    }


def reference(cell: H.Cell, mode: str = "f32",
              batch_keep: Optional[slice] = None) -> dict:
    """The reference over the checked steps from the benchmark's inputs:
    the same readings as ``checked_steps``."""
    arch, gst, tr = cell.arch, cell.gst, cell.traffic
    dev = cell.device
    w = {leaf.name: W.make_leaf(leaf, cell.seed, W.BACKBONE_TAG + i, dev)
         for i, leaf in enumerate(W.backbone_leaves(arch))}
    hd = W.head(arch, gst["classes"], cell.seed, dev)
    emb, init = start_table(cell)
    trainer = R.Trainer(arch, gst, w, hd, emb, init, mode)
    docs, order = corpus(cell), doc_order(cell)
    losses, grad = [], {}
    with matmul_precision(mode):
        for i in range(tr["checked_steps"]):
            ids = step_ids(cell, order, i)
            idx, u = draws(cell, i)
            loss, norms = trainer.step(
                torch.as_tensor(docs["tokens"][ids], device=dev),
                torch.as_tensor(docs["labels"][ids], device=dev),
                torch.as_tensor(ids, device=dev), idx, u, batch_keep)
            losses.append(loss)
            if i == 0:
                grad = norms
    change = {}
    with torch.no_grad():
        for name, p in zip(trainer.names, trainer.leaves):
            p0 = start_leaf(cell, name)
            change[name] = float(torch.linalg.vector_norm(p - p0))
            del p0
    rows = written_rows(cell, order, emb)
    del trainer, w, hd, emb, init
    H.free_device(cell.device)
    return {"losses": losses, "grad": grad, "change": change, "rows": rows}


def readings(prog: dict, ref: dict) -> dict:
    """Every gap the check can read: a step's loss and the table rows it
    wrote, by step; the first gradient's and the change's worst leaf."""
    med = statistics.median(ref["grad"].values())
    moved = [n for n in ref["grad"] if ref["grad"][n] >= ZERO_GRAD * med]
    grad = H.norm_gaps(prog["grad"], ref["grad"])
    change = H.norm_gaps(prog["change"], ref["change"],
                         keep=lambda n: n in moved)
    a, b = prog["rows"], ref["rows"]
    rows = (np.linalg.norm(a - b, axis=-1)
            / np.maximum(np.linalg.norm(b, axis=-1), 1e-30))
    out = {f"loss{k + 1}": abs(x - y) / abs(y) for k, (x, y) in
           enumerate(zip(prog["losses"], ref["losses"]))}
    out.update({f"table{k + 1}": float(r.max()) for k, r in enumerate(rows)})
    out["grad_norm"] = max(grad.values())
    out["grad_leaf"] = max(grad, key=grad.get)
    out["change_norm"] = max(change.values())
    out["change_leaf"] = max(change, key=change.get)
    out["change_median"] = statistics.median(change.values())
    return out


# what the check compares of the readings.  The third step's loss and
# table rows are read but not compared: AdamW at lr 1e-3 moves nearly
# every weight by about lr a step whatever its gradient's size, so
# round-off that flips a near-zero gradient's sign moves a weight by
# 2 lr, and by the third step such flips spread the gap between sound
# runs over three decades, to within a few times of what the TF32
# control reads, or past it (PERF.md gives the readings); the first two
# steps, steady, are compared
COMPARED = {"loss_step1": "loss1", "loss_step2": "loss2",
            "table_step1": "table1", "table_step2": "table2",
            "grad_norm": "grad_norm", "change_norm": "change_norm"}


def numbers(prog: dict, ref: dict) -> dict:
    """The numbers compared."""
    r = readings(prog, ref)
    return {k: r[x] for k, x in COMPARED.items()}


def detail(prog: dict, ref: dict) -> list:
    """Every reading and the losses, for the run's standard error."""
    return [f"losses program {prog['losses']!r} reference {ref['losses']!r}",
            f"readings {readings(prog, ref)!r}"]


def run(cell: H.Cell) -> dict:
    prog = build(cell)
    seen = checked_steps(cell, prog)
    out = window(cell, prog)
    del prog
    H.free_device(cell.device)
    t = time.perf_counter()
    ref = reference(cell)
    out["numbers"] = numbers(seen, ref)
    out["detail"] = detail(seen, ref)
    out["check_s"] = time.perf_counter() - t
    return out
