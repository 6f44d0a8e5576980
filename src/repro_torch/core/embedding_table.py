"""Historical segment-embedding table T : (row, segment slot) -> R^{d_h}.

Counterpart of ``src/repro/core/embedding_table.py:21-37,77-98`` (the table
and its slot-addressed view, which the serving cache uses).  Where the JAX
package donates the table through jit, the port updates it in place under
``torch.no_grad()``: a write costs no copy of the table.
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
