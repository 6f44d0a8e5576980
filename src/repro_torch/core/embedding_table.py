"""Historical segment-embedding table T : (row, segment slot) -> R^{d_h}.

Counterpart of ``src/repro/core/embedding_table.py``: the table, its
graph-addressed reads and writes (the train, refresh and finetune steps)
and its slot-addressed view (the serving cache).  Where the JAX package
donates the table through jit, the port updates it in place under
``torch.no_grad()``: a write costs no copy of the table.

``mode="drop"`` on the writes is the counterpart of JAX's ``.at[].set(...,
mode="drop")``: rows outside ``[0, n)`` are skipped, which is how a table
shard ignores the rows another shard owns (the distributed exchange points
them at row ``n``).  torch raises on such rows instead, so the drop is a
selection made explicitly, before the scatter.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class EmbeddingTable(NamedTuple):
    emb: torch.Tensor          # (n, J_max, d_h)
    age: torch.Tensor          # (n, J_max) int32 — step of last refresh
    initialized: torch.Tensor  # (n, J_max) bool — written at least once


def init_table(n_rows: int, j_max: int, d_h: int, dtype=torch.float32,
               device="cpu") -> EmbeddingTable:
    return EmbeddingTable(
        emb=torch.zeros(n_rows, j_max, d_h, dtype=dtype, device=device),
        age=torch.zeros(n_rows, j_max, dtype=torch.int32, device=device),
        initialized=torch.zeros(n_rows, j_max, dtype=torch.bool,
                                device=device),
    )


def lookup(table: EmbeddingTable, graph_ids: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """graph_ids: (B,) -> (emb (B, J, d), initialized (B, J))."""
    return table.emb[graph_ids], table.initialized[graph_ids]


def _in_range(table: EmbeddingTable, graph_ids: torch.Tensor, mode):
    """Positions of the rows a write keeps: all of them, or (``mode="drop"``)
    those inside the table."""
    if mode is None:
        return None
    if mode != "drop":
        raise ValueError(f"mode must be None or 'drop', not {mode!r}")
    n = table.emb.shape[0]
    return torch.nonzero((graph_ids >= 0) & (graph_ids < n)).reshape(-1)


def _put_scalar(t: torch.Tensor, index, value) -> None:
    """``t[index] = value`` for a Python scalar, in place.  The scalar is
    filled on t's device: an indexing assignment of a Python scalar to a
    CUDA tensor copies it from the host and waits for the copy."""
    t.index_put_(index, torch.full((), value, dtype=t.dtype, device=t.device))


@torch.no_grad()
def update_sampled(table: EmbeddingTable, graph_ids: torch.Tensor,
                   seg_idx: torch.Tensor, h_new: torch.Tensor,
                   step: int, *, mode: Optional[str] = None) -> EmbeddingTable:
    """Write back fresh embeddings of the sampled segments, in place.

    graph_ids: (B,); seg_idx: (B, S); h_new: (B, S, d) (written detached).
    ``mode="drop"`` skips rows outside the table.
    """
    keep = _in_range(table, graph_ids, mode)
    if keep is not None:
        graph_ids, seg_idx, h_new = graph_ids[keep], seg_idx[keep], h_new[keep]
    graph_ids, seg_idx = graph_ids.long(), seg_idx.long()
    b_idx = graph_ids[:, None].expand(seg_idx.shape)
    table.emb[b_idx, seg_idx] = h_new.to(table.emb.dtype)
    _put_scalar(table.age, (b_idx, seg_idx), step)
    _put_scalar(table.initialized, (b_idx, seg_idx), True)
    return table


@torch.no_grad()
def update_all(table: EmbeddingTable, graph_ids: torch.Tensor,
               h_all: torch.Tensor, seg_valid: torch.Tensor,
               step: int, *, mode: Optional[str] = None) -> EmbeddingTable:
    """Refresh every segment of the given graphs, in place (the
    head-finetuning phase): emb from h_all (B, J, d), initialized from
    seg_valid (B, J).  ``mode="drop"`` skips rows outside the table."""
    keep = _in_range(table, graph_ids, mode)
    if keep is not None:
        graph_ids, h_all, seg_valid = graph_ids[keep], h_all[keep], seg_valid[keep]
    graph_ids = graph_ids.long()
    table.emb[graph_ids] = h_all.to(table.emb.dtype)
    _put_scalar(table.age, (graph_ids,), step)
    table.initialized[graph_ids] = seg_valid.bool()
    return table


# ---------------------------------------------------------------------------
# slot-addressed view (serving cache): rows are cache SLOTS, one segment
# each (segment slot 0), keyed host-side by segment content hash
# ---------------------------------------------------------------------------


def lookup_rows(table: EmbeddingTable, rows: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """rows: (B,) slot ids -> (emb (B, d), initialized (B,))."""
    return table.emb[rows, 0], table.initialized[rows, 0]


@torch.no_grad()
def update_rows(table: EmbeddingTable, rows: torch.Tensor, h_new: torch.Tensor,
                step: int) -> EmbeddingTable:
    """Write h_new (B, d) into slots (B,) in place.  Repeated rows must
    carry repeated values (pow2 padding repeats the last pair), so the
    write is deterministic.  An empty row set is a no-op."""
    if rows.shape[0]:
        table.emb[rows, 0] = h_new.to(table.emb.dtype)
        table.age[rows, 0] = step
        table.initialized[rows, 0] = True
    return table


@torch.no_grad()
def evict_rows(table: EmbeddingTable, rows: torch.Tensor) -> EmbeddingTable:
    """Mark slots free (initialized=False) in place; embeddings are left
    where they are and overwritten on reuse.  An empty row set is a no-op."""
    if rows.shape[0]:
        table.initialized[rows, 0] = False
    return table
