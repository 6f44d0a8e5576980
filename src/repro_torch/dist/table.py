"""Row-sharded historical table geometry.

Counterpart of ``src/repro/dist/table.py``.  The dense table T (n_graphs,
J_max, d_h) is partitioned block-wise on the row axis: shard k owns rows
[k·R, (k+1)·R) with R = ceil(n / D), the row count padded to D·R (padding
rows are never referenced: graph ids are < n).  Each shard holds its own
(R, J, d) tables.  HOW the shards exchange lookups and write-backs is a
strategy of ``dist/exchange.py``; the ring entry points below are the
reference's original API over the ring strategy.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.core import embedding_table as tbl
from repro_torch.dist.exchange import RingExchange
from repro_torch.kernels.ops import pad_leading
from repro_torch.store.base import padded_rows, rows_per_shard  # noqa: F401


def pad_table(table: tbl.EmbeddingTable, num_shards: int) -> tbl.EmbeddingTable:
    """Pad the row axis to a multiple of the shard count (no-op if aligned)."""
    n_pad = padded_rows(table.emb.shape[0], num_shards)
    return tbl.EmbeddingTable(*(pad_leading(x, n_pad) for x in table))


def unpad_table(table: tbl.EmbeddingTable, n_rows: int) -> tbl.EmbeddingTable:
    return tbl.EmbeddingTable(table.emb[:n_rows], table.age[:n_rows],
                              table.initialized[:n_rows])


def split_table(table: tbl.EmbeddingTable,
                num_shards: int) -> List[tbl.EmbeddingTable]:
    """The D shards of a table, each its own (R, J, d) tensors."""
    padded = pad_table(table, num_shards)
    R = padded.emb.shape[0] // num_shards
    return [tbl.EmbeddingTable(*(x[k * R:(k + 1) * R].clone()
                                 for x in padded))
            for k in range(num_shards)]


def join_tables(shards, n_rows: int) -> tbl.EmbeddingTable:
    """The full table from its D shards (in rank order), padding stripped."""
    return unpad_table(tbl.EmbeddingTable(*(
        torch.cat([s[i] for s in shards]) for i in range(3))), n_rows)


# ---------------------------------------------------------------------------
# the ring entry points (thin wrappers over the ring strategy)
# ---------------------------------------------------------------------------


def _ring(comm, rows: int) -> RingExchange:
    return RingExchange(comm=comm, num_shards=comm.size, rows=rows)


def ring_lookup(table, graph_ids, *, comm, rows: int):
    """Distributed ``tbl.lookup`` over the ring (see RingExchange)."""
    return _ring(comm, rows).lookup(table, graph_ids)


def ring_update_sampled(table, graph_ids, seg_idx, h_new, step, *, comm,
                        rows: int):
    """Distributed ``tbl.update_sampled`` over the ring."""
    return _ring(comm, rows).update_sampled(table, graph_ids, seg_idx, h_new,
                                            step)


def ring_update_all(table, graph_ids, h_all, seg_valid, step, *, comm,
                    rows: int):
    """Distributed ``tbl.update_all`` over the ring."""
    return _ring(comm, rows).update_all(table, graph_ids, h_all, seg_valid,
                                        step)
