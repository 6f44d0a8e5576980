"""GNN backbones of the port: GCN, SAGE, GraphGPS-lite.

Counterpart of ``src/repro/graphs/gnn.py``.  GraphGym-style design space
(paper Table 5): pre-process MLP layers, message passing layers,
post-process MLP layers, PReLU, mean aggregation.  The backbone maps one
padded segment to one embedding (mean-pooled over valid nodes); a batch of
segments is a leading dimension.

Parameters live in ``nn.Module``s whose names follow the JAX pytree paths
(``pre.0.w``, ``mp.1.w_self``, ``mp.0.prelu.a``), weights in the JAX layout
(d_in, d_out), so ``load_jax_params`` carries JAX-initialised weights over.
The tensor code is plain functions over those modules.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict

import torch
from torch import nn

from repro_torch.kernels.ops import batched_neighbor_sum
from repro_torch.models.common import dense_init, load_jax_params  # noqa: F401


@dataclass(frozen=True)
class GNNConfig:
    backbone: str = "sage"       # gcn | sage | gps
    n_feat: int = 8
    hidden: int = 64
    n_pre: int = 1
    n_mp: int = 2
    n_post: int = 1
    num_heads: int = 4           # gps global attention heads
    use_kernels: bool = False    # route neighbor aggregation through the
                                 # batched segment-SpMM kernel: ONE launch
                                 # per message-passing layer over all N
                                 # segments.  gcn + sage only; gps runs the
                                 # plain path (its per-edge vector messages
                                 # don't fit the scalar-edge-weight SpMM).


class PReLU(nn.Module):
    def __init__(self):
        super().__init__()
        self.a = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x):
        return torch.where(x >= 0, x, self.a * x)


class Dense(nn.Module):
    """Pre/post-process layer: prelu(h @ w + b)."""

    def __init__(self, d_in: int, d_out: int, gen: torch.Generator):
        super().__init__()
        self.w = nn.Parameter(dense_init(d_in, d_out, gen))
        self.b = nn.Parameter(torch.zeros(d_out))
        self.prelu = PReLU()

    def forward(self, h):
        return self.prelu(h @ self.w + self.b)


class Attention(nn.Module):
    def __init__(self, d: int, gen: torch.Generator):
        super().__init__()
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, nn.Parameter(dense_init(d, d, gen)))


class MPLayer(nn.Module):
    """One message-passing layer's parameters, by backbone."""

    def __init__(self, cfg: GNNConfig, gen: torch.Generator):
        super().__init__()
        d = cfg.hidden
        if cfg.backbone == "gcn":
            self.w = nn.Parameter(dense_init(d, d, gen))
        elif cfg.backbone == "sage":
            self.w_self = nn.Parameter(dense_init(d, d, gen))
            self.w_nbr = nn.Parameter(dense_init(d, d, gen))
        elif cfg.backbone == "gps":
            self.w_msg = nn.Parameter(dense_init(d, d, gen))
            self.w_gate_src = nn.Parameter(dense_init(d, d, gen))
            self.w_gate_dst = nn.Parameter(dense_init(d, d, gen))
            self.attn = Attention(d, gen)
            self.mlp_in = nn.Parameter(dense_init(d, 2 * d, gen))
            self.mlp_out = nn.Parameter(dense_init(2 * d, d, gen))
        else:
            raise ValueError(cfg.backbone)
        self.prelu = PReLU()


class GNN(nn.Module):
    def __init__(self, cfg: GNNConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        dims = [cfg.n_feat] + [cfg.hidden] * cfg.n_pre
        self.pre = nn.ModuleList(Dense(dims[i], dims[i + 1], gen)
                                 for i in range(cfg.n_pre))
        self.mp = nn.ModuleList(MPLayer(cfg, gen) for _ in range(cfg.n_mp))
        self.post = nn.ModuleList(Dense(cfg.hidden, cfg.hidden, gen)
                                  for _ in range(cfg.n_post))

    def forward(self, seg_inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return encode_segments(self, self.cfg, seg_inputs)


def gnn_init(cfg: GNNConfig, generator: torch.Generator, device) -> GNN:
    """A GNN with weights drawn from ``generator`` (on the CPU), on ``device``."""
    return GNN(cfg, generator).to(device)


# ---------------------------------------------------------------------------
# plain path (the reference): every op in plain torch
# ---------------------------------------------------------------------------


def _gather_rows(h, idx):
    """h (N, m, d), idx (N, e) int64 -> h[n, idx[n, e]] (N, e, d)."""
    return torch.gather(h, 1, idx[..., None].expand(-1, -1, h.shape[-1]))


def _segment_sum(vals, idx, m: int):
    """Scatter-add vals (N, e[, d]) at node ids idx (N, e) -> (N, m[, d])."""
    out = vals.new_zeros((vals.shape[0], m) + tuple(vals.shape[2:]))
    if vals.dim() == 3:
        idx = idx[..., None].expand_as(vals)
    return out.scatter_add_(1, idx, vals)


def _agg_mean(h_src, dst, edge_valid, m: int):
    """Masked mean aggregation of messages at dst nodes."""
    summed = _segment_sum(h_src * edge_valid[..., None], dst, m)
    deg = _segment_sum(edge_valid, dst, m)
    return summed / deg.clamp_min(1.0)[..., None], deg


def _mp_layer(p: MPLayer, cfg: GNNConfig, h, src, dst, edge_valid, node_valid):
    m = h.shape[1]
    nv = node_valid[..., None]
    if cfg.backbone == "gcn":
        # symmetric-normalized aggregation with self loops
        norm = torch.rsqrt(_segment_sum(edge_valid, dst, m) + 1.0)
        msg = _gather_rows(h * norm[..., None], src) * edge_valid[..., None]
        agg = _segment_sum(msg, dst, m) * norm[..., None]
        return p.prelu((h * (norm ** 2)[..., None] + agg) @ p.w) * nv
    if cfg.backbone == "sage":
        mean_nbr, _ = _agg_mean(_gather_rows(h, src), dst, edge_valid, m)
        return p.prelu(h @ p.w_self + mean_nbr @ p.w_nbr) * nv
    if cfg.backbone == "gps":
        # local: gated message passing (GatedGCN-flavored)
        h_src, h_dst = _gather_rows(h, src), _gather_rows(h, dst)
        gate = torch.sigmoid(h_src @ p.w_gate_src + h_dst @ p.w_gate_dst)
        local, _ = _agg_mean(gate * (h_src @ p.w_msg), dst, edge_valid, m)
        # global: exact masked self-attention over segment nodes
        N, d, H = h.shape[0], cfg.hidden, cfg.num_heads
        hd = d // H
        q = (h @ p.attn.wq).reshape(N, m, H, hd)
        k = (h @ p.attn.wk).reshape(N, m, H, hd)
        v = (h @ p.attn.wv).reshape(N, m, H, hd)
        logits = torch.einsum("nqhd,nkhd->nhqk", q, k) / math.sqrt(hd)
        logits = torch.where(node_valid[:, None, None, :] > 0, logits,
                             torch.full_like(logits, -1e30))
        probs = torch.softmax(logits, dim=-1)
        glob = torch.einsum("nhqk,nkhd->nqhd", probs, v).reshape(N, m, d) \
            @ p.attn.wo
        h = h + local + glob
        h = h + p.prelu(h @ p.mlp_in) @ p.mlp_out
        return h * nv
    raise ValueError(cfg.backbone)


def _readout(params: GNN, h, nv):
    for lp in params.post:
        h = lp(h)
    h = h * nv[..., None]
    return h.sum(dim=1) / nv.sum(dim=1).clamp_min(1.0)[:, None]


def _encode_one(params: GNN, cfg: GNNConfig, x, edges, edge_valid, node_valid):
    """The reference encoder over a batch of padded segments (the JAX
    package vmaps it per segment; here the batch is a leading dimension)."""
    src, dst = edges[..., 0].long(), edges[..., 1].long()
    h = x
    for lp in params.pre:
        h = lp(h)
    h = h * node_valid[..., None]
    for lp in params.mp:
        h = _mp_layer(lp, cfg, h, src, dst, edge_valid, node_valid)
    return _readout(params, h, node_valid)


# ---------------------------------------------------------------------------
# kernel path
# ---------------------------------------------------------------------------


def _encode_batched(params: GNN, cfg: GNNConfig, seg_inputs):
    """Every message-passing layer is ONE batched segment-SpMM launch over
    all N padded segments.  Same function as ``_encode_one`` (asserted in
    tests/test_torch_gnn.py); gcn/sage only.

    GCN's symmetric normalization folds into the kernel's scalar edge
    weights:  w_e = norm[src_e] · norm[dst_e] · edge_valid_e, so
    Σ_e w_e h[src_e] = norm[v] · Σ_{e→v} norm[src_e] h[src_e].
    """
    x = seg_inputs["x"]                       # (N, m, F)
    edges = seg_inputs["edges"]               # (N, e, 2) int32
    ev = seg_inputs["edge_valid"]             # (N, e)
    nv = seg_inputs["node_valid"]             # (N, m)
    src = edges[..., 0].to(torch.int32).contiguous()
    dst = edges[..., 1].to(torch.int32).contiguous()
    src_l, dst_l = src.long(), dst.long()
    m = x.shape[1]

    h = x
    for lp in params.pre:
        h = lp(h)
    h = h * nv[..., None]
    # degree / norm / edge weights depend only on the graph structure —
    # loop-invariant across message-passing layers, computed once
    if cfg.backbone == "gcn":
        norm = torch.rsqrt(_segment_sum(ev, dst_l, m) + 1.0)     # (N, m)
        w = (torch.gather(norm, 1, src_l) * torch.gather(norm, 1, dst_l)
             * ev).contiguous()
    elif cfg.backbone == "sage":
        deg_c = _segment_sum(ev, dst_l, m).clamp_min(1.0)
        w = ev.contiguous()
    else:
        raise ValueError(f"batched kernel path does not support "
                         f"backbone={cfg.backbone!r}")
    for lp in params.mp:
        agg = batched_neighbor_sum(h, src, dst, w)
        if cfg.backbone == "gcn":
            h = lp.prelu((h * (norm ** 2)[..., None] + agg) @ lp.w)
        else:
            h = lp.prelu(h @ lp.w_self + (agg / deg_c[..., None]) @ lp.w_nbr)
        h = h * nv[..., None]
    return _readout(params, h, nv)


def encode_segments(params: GNN, cfg: GNNConfig,
                    seg_inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Single-bucket encode entry point: one flat batch of padded segments
    (tensors (N, m, ...) of ONE padding shape, on one device) -> embeddings
    (N, hidden).

    The unit of work of the serving engine (serve/engine.py encodes one
    padded-CSR bucket per call): cfg.use_kernels (gcn/sage) routes through
    the kernel path — one SpMM launch per message-passing layer for the
    whole batch — otherwise (or for gps) the plain path.
    """
    if cfg.use_kernels and cfg.backbone in ("gcn", "sage"):
        return _encode_batched(params, cfg, seg_inputs)
    return _encode_one(params, cfg, seg_inputs["x"], seg_inputs["edges"],
                       seg_inputs["edge_valid"], seg_inputs["node_valid"])


def make_encode_fn(cfg: GNNConfig) -> Callable:
    """Returns encode_fn(params, seg_inputs) -> (emb (N, hidden), aux = 0.),
    the GST core's backbone interface (a thin wrapper around
    ``encode_segments`` adding the aux-loss slot)."""

    def encode(params: GNN, seg_inputs):
        emb = encode_segments(params, cfg, seg_inputs)
        return emb, emb.new_zeros((), dtype=torch.float32)

    return encode
