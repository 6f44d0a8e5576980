"""Traffic kind ``predict``: whole-document property prediction.

One client sends a document, waits for its logits on the host, and sends
the next (closed loop).  A request drives the calls the port's eval step
makes, with every segment fresh as at test time (Algorithm 2):
``Model.encode_segment`` over the document's J segments (the attention
kernel on), the pooling kernel with every segment fresh (as
``core/gst.py::_fused_plain_pool`` calls ``kernels/ops.py::sed_aggregate``)
and ``core/gst.py::head_apply``.  Latency runs from the tokens leaving the
client to the logits on the host.  Once the window has closed, a sample
of its requests drawn from the seed, the longest among them, is held
against the reference.
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from gstbench import docs as D
from gstbench import flops, harness as H, weights as W
from gstbench.reference import gst as R
from gstbench.reference.precision import matmul_precision

# this kind's parameters at the sizes of the CPU tests (``testing.py``)
TINY = {"n_docs": 16, "seg_len": 16, "max_segments": 4, "cycle": 8,
        "sample": 4}


def corpus(cell: H.Cell):
    tr, gst = cell.traffic, cell.gst
    return D.property_docs(tr["n_docs"], tr["max_segments"], tr["seg_len"],
                           cell.arch["vocab_size"], gst["classes"],
                           tr["topic_band_share"], cell.seed, tag=5)


def schedule(cell: H.Cell, n: int) -> np.ndarray:
    tr = cell.traffic
    return D.request_segments(tr["max_segments"], tr["cycle"], n, cell.seed,
                              tag=6)


def build(cell: H.Cell):
    H.port()
    from repro_torch.core import gst as G
    from repro_torch.models import build_model

    arch, gst = cell.arch, cell.gst
    dev = torch.device(cell.device)
    cell.mark("imports")
    model = build_model(H.port_config(arch, gst), use_kernels=True,
                        device=dev)
    head = G.Head(arch["d_model"], gst["classes"], "mlp",
                  torch.Generator(dev)).to(dev)
    with torch.no_grad():
        for k, t in W.head(arch, gst["classes"], cell.seed, dev).items():
            getattr(head, k).copy_(t)
    head.requires_grad_(False)
    valid = {j: torch.ones((1, j), device=dev)
             for j in range(1, cell.traffic["max_segments"] + 1)}
    params = W.backbone(arch, cell.seed, dev)
    cell.mark("weights")
    docs = corpus(cell)
    cell.mark("documents")
    return SimpleNamespace(model=model, params=params, head=head,
                           valid=valid, docs=docs)


def request(cell: H.Cell, prog, tokens: np.ndarray, tracer: H.Traced):
    """One document through the port: (logits on the host, seconds)."""
    from repro_torch.core import gst as G
    from repro_torch.kernels import ops
    j = tokens.shape[0]
    t0 = time.perf_counter()
    with torch.no_grad():
        with tracer.span("gst.send"):
            x = torch.from_numpy(tokens).to(prog.model.device)
        with tracer.span("gst.encode"):
            h, _ = prog.model.encode_segment(prog.params, {"tokens": x})
        with tracer.span("gst.pool_head"):
            v = prog.valid[j]
            pooled = ops.sed_aggregate(h[None], v, v, torch.zeros_like(v),
                                       keep_prob=1.0, num_sampled=1,
                                       agg=cell.gst["agg"], use_kernels=True)
            logits = G.head_apply(prog.head, pooled, "mlp")
        with tracer.span("gst.read"):
            out = logits[0].cpu()
    return out, time.perf_counter() - t0


def window(cell: H.Cell, prog) -> dict:
    tr = cell.traffic
    off = H.Traced(False, 0, 0, cell.device)
    docs = prog.docs["tokens"]
    for j in range(tr["max_segments"], 0, -1):       # every shape, once
        request(cell, prog, docs[-1, :j], off)
    cell.mark("warm-up")
    tracer = H.Traced(cell.trace, tr["trace_skip"], tr["trace_units"],
                      cell.device)
    H.synchronize(cell.device)
    setup_s = time.perf_counter() - cell.t0 - cell.excluded_s
    js = schedule(cell, 1 << 16)
    done, lat, logits = [], [], []
    t0 = time.perf_counter()
    while True:
        i = len(done)
        tracer.before(i)
        doc = i % tr["n_docs"]
        out, s = request(cell, prog, docs[doc, :js[i]], tracer)
        tracer.after(i)
        done.append((doc, int(js[i])))
        lat.append(s)
        logits.append(out)
        if time.perf_counter() - t0 >= cell.seconds and (
                not tracer.enabled or tracer.summary is not None):
            break
    window_s = time.perf_counter() - t0
    peak = H.peak_bytes(cell.device)
    failed = sum(not bool(torch.isfinite(x).all()) for x in logits)
    segs = sum(j for _, j in done)
    traced = [done[i][1] for i in tracer.traced]
    L = tr["seg_len"]
    record = {"kind": "predict", "trace": tracer.summary,
              "units": len(traced),
              "flops": sum(flops.predict_flops(cell.arch, j, L,
                                               cell.gst["classes"])
                           for j in traced),
              "peaks": cell.peaks}
    if cell.peaks:
        record["swa_bound_s"] = sum(
            cell.arch["num_layers"] * flops.swa_bound_s(cell.arch, j, L,
                                                        cell.peaks)
            for j in traced)
    return {
        "attempted": len(done), "failed": failed, "peak_bytes": peak,
        "end_to_end": {
            "predict_segments_per_s": segs / window_s,
            "predict_p95_ms": float(np.percentile(np.asarray(lat) * 1e3,
                                                  95)),
            "peak_mem_gib": peak / H.GIB, "setup_s": setup_s},
        "record": record, "done": done, "logits": logits,
    }


def sample(cell: H.Cell, done) -> list:
    """Indices of the requests the check compares: drawn from the seed,
    and the first of the longest."""
    k = min(cell.traffic["sample"], len(done))
    rng = np.random.default_rng([cell.seed, 7])
    longest = max(range(len(done)), key=lambda i: (done[i][1], -i))
    pick = set(rng.choice(len(done), size=k, replace=False).tolist())
    pick.discard(longest)
    return [longest] + sorted(pick)[:k - 1]


def reference(cell: H.Cell, requests, mode: str = "f32") -> list:
    """The reference's logits for (doc, J) requests."""
    arch, gst = cell.arch, cell.gst
    w = {leaf.name: W.make_leaf(leaf, cell.seed, W.BACKBONE_TAG + i,
                                cell.device)
         for i, leaf in enumerate(W.backbone_leaves(arch))}
    hd = W.head(arch, gst["classes"], cell.seed, cell.device)
    docs = corpus(cell)["tokens"]
    out = []
    with matmul_precision(mode):
        for doc, j in requests:
            x = torch.as_tensor(docs[doc, :j], device=cell.device)
            out.append(R.predict(w, hd, arch, x, mode).cpu())
    del w, hd
    H.free_device(cell.device)
    return out


def logit_gap(prog: list, ref: list) -> float:
    """Widest logit error of a request over its largest reference logit."""
    return max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
               for a, b in zip(prog, ref))


def run(cell: H.Cell) -> dict:
    prog = build(cell)
    out = window(cell, prog)
    del prog
    H.free_device(cell.device)
    t = time.perf_counter()
    pick = sample(cell, out["done"])
    ref = reference(cell, [out["done"][i] for i in pick])
    out["numbers"] = {"logits": logit_gap([out["logits"][i] for i in pick],
                                          ref)}
    out["picked"] = [out["done"][i] for i in pick]
    out["detail"] = [f"requests compared (doc, J): {out['picked']!r}"]
    out["check_s"] = time.perf_counter() - t
    del out["done"], out["logits"]
    return out
