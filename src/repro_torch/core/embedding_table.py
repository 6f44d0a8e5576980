"""Historical segment-embedding table T : (row, segment slot) -> R^{d_h}.

Counterpart of ``src/repro/core/embedding_table.py``: the table, its
graph-addressed reads and writes (the train, refresh and finetune steps)
and its slot-addressed view (the serving cache).  Where the JAX package
donates the table through jit, the port updates it in place under
``torch.no_grad()``: a write costs no copy of the table.  ``mode="drop"``
(writes that skip rows owned by another shard) lands with the distributed
slice.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

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


@torch.no_grad()
def update_sampled(table: EmbeddingTable, graph_ids: torch.Tensor,
                   seg_idx: torch.Tensor, h_new: torch.Tensor,
                   step: int) -> EmbeddingTable:
    """Write back fresh embeddings of the sampled segments, in place.

    graph_ids: (B,); seg_idx: (B, S); h_new: (B, S, d) (written detached).
    """
    b_idx = graph_ids[:, None].expand(seg_idx.shape)
    table.emb[b_idx, seg_idx] = h_new.to(table.emb.dtype)
    table.age[b_idx, seg_idx] = step
    table.initialized[b_idx, seg_idx] = True
    return table


@torch.no_grad()
def update_all(table: EmbeddingTable, graph_ids: torch.Tensor,
               h_all: torch.Tensor, seg_valid: torch.Tensor,
               step: int) -> EmbeddingTable:
    """Refresh every segment of the given graphs, in place (the
    head-finetuning phase): emb from h_all (B, J, d), initialized from
    seg_valid (B, J)."""
    table.emb[graph_ids] = h_all.to(table.emb.dtype)
    table.age[graph_ids] = step
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
