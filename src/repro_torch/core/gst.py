"""GST train/eval/refresh/finetune step builders: the paper's Algorithms 1-2.

Counterpart of ``src/repro/core/gst.py``.  Generic over the backbone:
``encode_fn(backbone, seg_inputs_flat)`` maps a flat batch of segments
(leading dim N) to embeddings (N, d_h) plus an auxiliary loss.

Variants (paper §5.1 "Methods"):
    full     — all segments require grad (Full Graph Training analogue)
    gst      — sampled segments with grad; rest recomputed without grad
    gst_one  — only sampled segments, no aggregation of the rest
    gst_e    — historical embedding table for the rest
    gst_ef   — +E with head finetuning at the end (schedule, same step)
    gst_ed   — +E with Stale Embedding Dropout (Eq. 1)
    gst_efd  — the complete method

Where the JAX package's step is a pure function of (state, batch, rng)
jitted with the state donated, the port's step runs eagerly and updates
the parameters, the optimizer moments and the table in place; it returns
the new ``TrainState`` (the same modules and table, the next host step).
Randomness comes from an explicit ``torch.Generator``, or from an injected
draw ``(idx (B, S), u (B, J))``: the parity tests pass JAX's own draws,
``split(fold_in(rng, step))`` as ``src/repro/core/gst.py:248-284`` makes
them.

Data parallelism (``dist/train.py``): where the JAX step takes an
``axis_name`` and ``pmean``s over it inside ``shard_map``, the port's
steps take a ``comm`` (``dist/comm.py``) and average the gradients, the
loss and the metric through ``comm.all_reduce_mean``; a batch carrying
``batch_pos`` draws per row (``segment.per_row_keys``), so every shard
samples what the single-device step samples for its rows.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch import nn
from torch.overrides import handle_torch_function, has_torch_function

from repro_torch.core import embedding_table as tbl
from repro_torch.core import segment as seg
from repro_torch.kernels import ops as kops
from repro_torch.models.common import dense_init


# ---------------------------------------------------------------------------
# variants
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GSTVariant:
    name: str
    use_table: bool          # E: stale embeddings come from the table
    recompute_stale: bool    # GST: no-grad forward for non-sampled segments
    use_sed: bool            # D: Eq. 1 dropout/up-weighting
    sampled_only: bool       # GST-One: drop all non-sampled segments
    finetune_head: bool      # F: head finetuning phase at end of training


VARIANTS: Dict[str, GSTVariant] = {
    "full":    GSTVariant("full", False, False, False, False, False),
    "gst":     GSTVariant("gst", False, True, False, False, False),
    "gst_one": GSTVariant("gst_one", False, False, False, True, False),
    "gst_e":   GSTVariant("gst_e", True, False, False, False, False),
    "gst_ef":  GSTVariant("gst_ef", True, False, False, False, True),
    "gst_ed":  GSTVariant("gst_ed", True, False, True, False, False),
    "gst_efd": GSTVariant("gst_efd", True, False, True, False, True),
}


# ---------------------------------------------------------------------------
# heads and losses
# ---------------------------------------------------------------------------


class Head(nn.Module):
    """mode 'mlp': 2-layer MLP graph head F' (w1, b1, w2, b2).  mode
    'segment_sum': linear per-segment scalar head (w, b) — part of F, with
    F' = Σ (paper §5.3)."""

    def __init__(self, d_h: int, num_out: int, mode: str,
                 gen: torch.Generator):
        super().__init__()
        self.mode = mode
        if mode == "mlp":
            self.w1 = nn.Parameter(dense_init(d_h, d_h, gen))
            self.b1 = nn.Parameter(torch.zeros(d_h))
            self.w2 = nn.Parameter(dense_init(d_h, num_out, gen))
            self.b2 = nn.Parameter(torch.zeros(num_out))
        else:
            self.w = nn.Parameter(dense_init(d_h, 1, gen))
            self.b = nn.Parameter(torch.zeros(1))

    def forward(self, h):
        return head_apply(self, h, self.mode)


def head_init(d_h: int, num_out: int, mode: str, generator: torch.Generator,
              device) -> Head:
    return Head(d_h, num_out, mode, generator).to(device)


def head_apply(p: Head, h: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "mlp":
        z = torch.relu(h @ p.w1 + p.b1)
        return z @ p.w2 + p.b2
    return (h @ p.w + p.b)[..., 0]


def ce_loss(logits, labels):
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    acc = (torch.argmax(logits, -1) == labels).float()
    return torch.mean(nll), torch.mean(acc)


def pairwise_hinge_loss(preds, labels):
    """PairwiseHinge within batch (paper Appendix B) + OPA metric."""
    dy = preds[:, None] - preds[None, :]
    gt = (labels[:, None] > labels[None, :]).float()
    n_pairs = torch.clamp(torch.sum(gt), min=1.0)
    loss = torch.sum(gt * torch.clamp(1.0 - dy, min=0.0)) / n_pairs
    opa = torch.sum(gt * (dy > 0)) / n_pairs
    return loss, opa


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def gather_segments(seg_inputs: Dict[str, torch.Tensor], idx: torch.Tensor):
    """Tensors (B, J, ...) gathered at idx (B, S) -> (B, S, ...).  A torch
    function, so a torch function mode may run it its own way: the dry run
    keeps each output in its input's layout (``launch/dryrun.py``)."""
    operands = (*seg_inputs.values(), idx)
    if has_torch_function(operands):
        return handle_torch_function(gather_segments, operands, seg_inputs,
                                     idx)
    return gather_segments_ops(seg_inputs, idx)


def gather_segments_ops(seg_inputs: Dict[str, torch.Tensor],
                        idx: torch.Tensor):
    """The ops of ``gather_segments`` (see there), as plain ops."""
    b_idx = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return {k: x[b_idx, idx] for k, x in seg_inputs.items()}


def _flatten_bs(tree: Dict[str, torch.Tensor]):
    return {k: x.reshape((-1,) + tuple(x.shape[2:])) for k, x in tree.items()}


class GSTBatch(NamedTuple):
    """One batch of segmented inputs, on one device.

    seg_inputs: dict of tensors (B, J_max, ...) — per-segment model inputs.
    seg_valid:  (B, J_max) float32 1/0.
    graph_ids:  (B,) int64 row in the historical table.
    labels:     (B,) int32 (ce) or float32 (ranking).
    batch_pos:  optional (B,) int64 CPU tensor, each row's position in the
                GLOBAL batch: the draws are then made per row
                (``segment.per_row_keys``), so a data-parallel shard of the
                batch samples what the whole batch samples on one device.
    """
    seg_inputs: Any
    seg_valid: torch.Tensor
    graph_ids: torch.Tensor
    labels: torch.Tensor
    batch_pos: Optional[torch.Tensor] = None


class TrainState(NamedTuple):
    backbone: nn.Module
    head: Head
    opt_state: Any
    table: tbl.EmbeddingTable
    step: int


def train_params(state: TrainState):
    """The trainable tensors of a train step, in the optimizer's order:
    the backbone's parameters, then the head's."""
    return list(state.backbone.parameters()) + list(state.head.parameters())


def _fused_sed_pool(h, seg_valid, fresh_mask, drop_mask, stale_valid, *,
                    keep_prob: float, num_sampled: int, agg: str,
                    ages=None, decay: float = 0.0):
    """Eq. 1 η-weighting + ⊕ pooling in ONE fused kernel pass (sed_pool).

    Uninitialized stale slots are folded into the drop mask (η = 0), which is
    exactly what the reference path's ``eta * where(fresh, 1, stale_valid)``
    correction does.  ``ages``/``decay`` thread the optional staleness decay
    into the kernel's stale branch (ref.sed_eta).
    """
    drop_arg = 1.0 - (1.0 - drop_mask) * stale_valid.float()
    return kops.sed_aggregate(
        h, seg_valid.float(), fresh_mask.float(), drop_arg, ages,
        keep_prob=keep_prob, num_sampled=num_sampled, agg=agg, decay=decay,
        use_kernels=True)


def _fused_plain_pool(h, seg_valid, *, agg: str):
    """η = 1 pooling through the same fused kernel (eval / finetune path):
    with keep_prob = 1 every Eq.-1 weight collapses to the validity mask."""
    valid = seg_valid.float()
    return kops.sed_aggregate(h, valid, valid, torch.zeros_like(valid),
                              keep_prob=1.0, num_sampled=1, agg=agg,
                              use_kernels=True)


def _scalar_head_preds(scal, seg_valid, eta, agg: str, pool=None):
    """Pool (B, J) per-segment scalar predictions into (B,) graph preds.

    pool: optional fused (B, J, 1) -> (B, 1) kernel pooling (already carrying
    its η weighting); None = the reference η-weighted sum.
    """
    if pool is not None:
        return pool(scal[..., None])[..., 0]
    if agg == "mean":
        return torch.sum(scal * eta, dim=-1) / torch.clamp(
            torch.sum(seg_valid, -1), min=1.0)
    return torch.sum(scal * eta, dim=-1)


def _mlp_loss(loss_pair, loss_kind, out, labels):
    if loss_kind == "ce":
        return loss_pair(out, labels)
    return loss_pair(out[..., 0] if out.dim() > 1 else out, labels)


def _pmean(comm, tensors):
    """The mean of each tensor over the shards of ``comm`` (JAX's
    ``jax.lax.pmean``), through ONE ``all_reduce_mean`` of the tensors
    flattened into one f32 vector; the tensors as they are without a comm."""
    if comm is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    mean = comm.all_reduce_mean(flat)
    out, at = [], 0
    for t in tensors:
        out.append(mean[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return out


def _grads(loss, params):
    """d loss / d params; zeros for a parameter the loss does not reach
    (as jax.grad gives)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------


def make_train_step(
    encode_fn: Callable,
    optimizer,
    variant: GSTVariant,
    *,
    num_sampled: int = 1,
    keep_prob: float = 0.5,
    head_mode: str = "mlp",
    loss_kind: str = "ce",
    agg: str = "mean",
    aux_weight: float = 1e-2,
    use_kernels: bool = False,
    table_lookup: Optional[Callable] = None,
    table_update: Optional[Callable] = None,
    table_lookup_age: Optional[Callable] = None,
    sed_decay: float = 0.0,
    comm=None,
    recompute_fn: Optional[Callable] = None,
):
    """Returns ``step(state, batch, generator=None, draws=None) -> (state,
    metrics)`` implementing Algorithm 1 (gst*) / Algorithm 2 lines 1-10
    (e-variants).

    recompute_fn: the encode of the ``gst`` variant's stale re-encode of
    every segment, run without a gradient (default ``encode_fn``); a
    backbone whose kernels have no backward encodes there through them
    and through their plain versions in ``encode_fn``.

    use_kernels: for the SED variants (gst_ed / gst_efd) the Eq.-1
    η-weighting and the ⊕ pooling run as ONE fused sed_pool launch over
    the (B, J, d) tensor instead of the plain composition.

    table_lookup / table_update: alternative historical-table accessors
    with the signatures of ``tbl.lookup`` / ``tbl.update_sampled``.

    sed_decay / table_lookup_age: λ of the staleness decay exp(-λ·age)
    folded into the stale branch of Eq. 1.  ``table_lookup_age(table,
    graph_ids) -> (B, J)`` reads the per-segment step of the last write
    (the distributed step injects its exchange's ``lookup_ages``); the
    default reads ``table.age``.  λ = 0 (the default) reads no ages.

    comm: the shard's communicator when the step is one shard of a
    data-parallel step: gradients, loss and metric are averaged over the
    shards before the (replicated) optimizer update.

    The step draws the sampled segments and the SED uniforms from
    ``generator`` (per row where the batch carries ``batch_pos``), unless
    ``draws = (idx (B, S), u (B, J))`` hands them in.
    """
    S = num_sampled
    loss_pair = ce_loss if loss_kind == "ce" else pairwise_hinge_loss
    fused_sed = use_kernels and variant.use_sed and not variant.sampled_only
    t_lookup = table_lookup or tbl.lookup
    t_update = table_update or tbl.update_sampled
    use_age = variant.use_sed and variant.use_table and sed_decay > 0.0
    t_age = table_lookup_age or (lambda table, ids: table.age[ids])
    n_shards = 1 if comm is None else comm.size
    recompute = recompute_fn or encode_fn

    def step(state: TrainState, batch: GSTBatch, generator=None, draws=None):
        B, J = batch.seg_valid.shape
        dev = batch.seg_valid.device
        if draws is None and generator is None:
            raise ValueError("the train step needs a generator or draws")
        row_keys = None
        if draws is None and batch.batch_pos is not None:
            row_keys = seg.per_row_keys(generator, batch.batch_pos,
                                        B * n_shards)
        if draws is None:
            if row_keys is None:
                idx = seg.sample_segments(generator, batch.seg_valid, S)
            else:
                idx = seg.sample_segments_rowwise(row_keys, batch.seg_valid,
                                                  S)                # (B, S)
        else:
            idx = torch.as_tensor(draws[0], device=dev).long()
        fresh_mask = seg.sampled_mask(idx, J) * batch.seg_valid       # (B, J)
        sampled_inputs = _flatten_bs(gather_segments(batch.seg_inputs, idx))

        # ---- stale embeddings (no grad) ---------------------------------
        age_steps = None
        if variant.use_table:
            h_stale, initialized = t_lookup(state.table, batch.graph_ids)
            stale_valid = batch.seg_valid * initialized.to(
                batch.seg_valid.dtype)
            if use_age:
                age_steps = torch.clamp(
                    state.step - t_age(state.table, batch.graph_ids),
                    min=0).float()
        elif variant.recompute_stale:
            with torch.no_grad():
                h_all, _ = recompute(state.backbone,
                                     _flatten_bs(batch.seg_inputs))
            h_stale = h_all.reshape(B, J, -1)
            stale_valid = batch.seg_valid
        else:  # full / gst_one: no stale path
            h_stale = None
            stale_valid = torch.zeros_like(batch.seg_valid)

        # ---- SED / η weights (Eq. 1) ------------------------------------
        drop_mask = None
        if variant.use_sed:
            if draws is None and row_keys is None:
                eta, drop_mask = seg.sed_weights(generator, batch.seg_valid,
                                                 fresh_mask, keep_prob, S)
            elif draws is None:
                eta, drop_mask = seg.sed_weights_rowwise(
                    row_keys, batch.seg_valid, fresh_mask, keep_prob, S)
            else:
                eta, drop_mask = seg._sed_from_uniform(
                    torch.as_tensor(draws[1], device=dev), batch.seg_valid,
                    fresh_mask, keep_prob, S)
            if fused_sed:
                # the sed_pool kernel builds η from the masks and the ages
                # (_fused_sed_pool); the plain η is never read
                eta = None
            else:
                # uninitialized stale -> 0
                eta = eta * torch.where(fresh_mask > 0, 1.0,
                                        stale_valid.float())
                if age_steps is not None:
                    # staleness decay on the stale branch only — fresh
                    # segments have age 0 by definition (ref.sed_eta)
                    eta = eta * torch.where(fresh_mask > 0, 1.0,
                                            torch.exp(-sed_decay * age_steps))
        elif variant.sampled_only:
            eta = fresh_mask
        elif variant.name == "full":
            eta = batch.seg_valid.float()
        else:
            eta = (fresh_mask + (1.0 - fresh_mask) * stale_valid).float()

        params = train_params(state)
        with torch.enable_grad():
            if variant.name == "full":
                h_flat, aux = encode_fn(state.backbone,
                                        _flatten_bs(batch.seg_inputs))
                h_comb = h_flat.reshape(B, J, -1)
            else:
                h_s_flat, aux = encode_fn(state.backbone, sampled_inputs)
                h_s = h_s_flat.reshape(B, S, -1)
                if h_stale is None:
                    base = h_s.new_zeros((B, J, h_s.shape[-1]))
                else:
                    base = h_stale.to(h_s.dtype)
                # scatter fresh embeddings over the stale base
                b_idx = torch.arange(B, device=dev)[:, None].expand(B, S)
                h_comb = base.index_put((b_idx, idx), h_s)

            if head_mode == "segment_sum":
                # per-segment scalar predictions; F' = Σ (paper §5.3)
                scal = head_apply(state.head, h_comb, "segment_sum")  # (B, J)
                pool = (lambda x: _fused_sed_pool(
                    x, batch.seg_valid, fresh_mask, drop_mask, stale_valid,
                    keep_prob=keep_prob, num_sampled=S, agg=agg,
                    ages=age_steps, decay=sed_decay)
                ) if fused_sed else None
                preds = _scalar_head_preds(scal, batch.seg_valid, eta, agg,
                                           pool)
                loss, metric = loss_pair(preds, batch.labels)
            else:
                if variant.sampled_only:
                    # GST-One: mean over the sampled segments only
                    h_graph = torch.sum(
                        h_comb * fresh_mask[..., None].to(h_comb.dtype), 1) / S
                elif fused_sed:
                    h_graph = _fused_sed_pool(
                        h_comb, batch.seg_valid, fresh_mask, drop_mask,
                        stale_valid, keep_prob=keep_prob, num_sampled=S,
                        agg=agg, ages=age_steps, decay=sed_decay)
                else:
                    h_graph = seg.aggregate(h_comb, eta, batch.seg_valid, agg)
                out = head_apply(state.head, h_graph, "mlp")
                loss, metric = _mlp_loss(loss_pair, loss_kind, out,
                                         batch.labels)
            total = loss + aux_weight * aux
        grads = _grads(total, params)
        # data-parallel: per-shard means -> global means (the replicas stay
        # equal because every shard applies the same averaged update)
        *grads, total, metric = _pmean(comm, grads + [total.detach(),
                                                      metric.detach()])
        _, new_opt, opt_metrics = optimizer.update(params, grads,
                                                   state.opt_state)

        if variant.use_table:
            d = h_comb.shape[-1]
            h_s_new = torch.gather(h_comb.detach(), 1,
                                   idx[..., None].expand(B, S, d))  # (B,S,d)
            t_update(state.table, batch.graph_ids, idx, h_s_new, state.step)

        new_state = state._replace(opt_state=new_opt, step=state.step + 1)
        metrics = {"loss": total.detach(), "metric": metric.detach(),
                   **opt_metrics}
        return new_state, metrics

    return step


def make_eval_step(encode_fn: Callable, *, head_mode: str = "mlp",
                   loss_kind: str = "ce", agg: str = "mean",
                   use_kernels: bool = False, comm=None):
    """Test-time: every segment fresh (paper's P(⊕ h_j, y) distribution).
    ``comm``: loss and metric averaged over the shards."""
    loss_pair = ce_loss if loss_kind == "ce" else pairwise_hinge_loss

    @torch.no_grad()
    def step(state: TrainState, batch: GSTBatch):
        B, J = batch.seg_valid.shape
        h_flat, _ = encode_fn(state.backbone, _flatten_bs(batch.seg_inputs))
        h_all = h_flat.reshape(B, J, -1)
        eta = batch.seg_valid.float()
        if head_mode == "segment_sum":
            scal = head_apply(state.head, h_all, "segment_sum")
            pool = (lambda x: _fused_plain_pool(x, batch.seg_valid, agg=agg)
                    ) if use_kernels else None
            preds = _scalar_head_preds(scal, batch.seg_valid, eta, agg, pool)
            loss, metric = loss_pair(preds, batch.labels)
        else:
            if use_kernels:
                h_graph = _fused_plain_pool(h_all, batch.seg_valid, agg=agg)
            else:
                h_graph = seg.aggregate(h_all, eta, batch.seg_valid, agg)
            out = head_apply(state.head, h_graph, "mlp")
            loss, metric = _mlp_loss(loss_pair, loss_kind, out, batch.labels)
        loss, metric = _pmean(comm, [loss, metric])
        return {"loss": loss, "metric": metric}

    return step


def make_refresh_step(encode_fn: Callable,
                      table_update_all: Optional[Callable] = None):
    """Algorithm 2 line 12: refresh T with the final backbone (in place).

    table_update_all: alternative writer with the ``tbl.update_all``
    signature (the distributed step injects its exchange's)."""
    t_update_all = table_update_all or tbl.update_all

    @torch.no_grad()
    def step(state: TrainState, batch: GSTBatch):
        B, J = batch.seg_valid.shape
        h_flat, _ = encode_fn(state.backbone, _flatten_bs(batch.seg_inputs))
        h_all = h_flat.reshape(B, J, -1)
        table = t_update_all(state.table, batch.graph_ids, h_all,
                             batch.seg_valid, state.step)
        return state._replace(table=table)

    return step


def make_finetune_step(optimizer, *, head_mode: str = "mlp",
                       loss_kind: str = "ce", agg: str = "mean",
                       use_kernels: bool = False,
                       table_lookup: Optional[Callable] = None, comm=None):
    """Algorithm 2 lines 13-18: train F' only, inputs from the (fresh) table.

    Supports both heads: the MLP graph head F' (pool then predict) and the
    per-segment scalar head of the TpuGraphs track (predict then Σ / mean).
    The optimizer state covers the head's parameters only.
    ``table_lookup`` (the distributed step injects its exchange's) and
    ``comm`` as in ``make_train_step``.
    """
    loss_pair = ce_loss if loss_kind == "ce" else pairwise_hinge_loss
    t_lookup = table_lookup or tbl.lookup

    def step(state: TrainState, batch: GSTBatch):
        h_all, _ = t_lookup(state.table, batch.graph_ids)
        h_all = h_all.float()
        eta = batch.seg_valid.float()
        if head_mode != "segment_sum":
            if use_kernels:
                h_graph = _fused_plain_pool(h_all, batch.seg_valid, agg=agg)
            else:
                h_graph = seg.aggregate(h_all, eta, batch.seg_valid, agg)

        params = list(state.head.parameters())
        with torch.enable_grad():
            if head_mode == "segment_sum":
                scal = head_apply(state.head, h_all, "segment_sum")  # (B, J)
                pool = (lambda x: _fused_plain_pool(x, batch.seg_valid,
                                                    agg=agg)
                        ) if use_kernels else None
                preds = _scalar_head_preds(scal, batch.seg_valid, eta, agg,
                                           pool)
                loss, metric = loss_pair(preds, batch.labels)
            else:
                out = head_apply(state.head, h_graph, "mlp")
                loss, metric = _mlp_loss(loss_pair, loss_kind, out,
                                         batch.labels)
        grads = _grads(loss, params)
        *grads, loss, metric = _pmean(comm, grads + [loss.detach(),
                                                     metric.detach()])
        _, new_opt, _ = optimizer.update(params, grads, state.opt_state)
        return state._replace(opt_state=new_opt, step=state.step + 1), \
            {"loss": loss.detach(), "metric": metric.detach()}

    return step
