"""Table-exchange strategies for the row-sharded historical table.

Counterpart of ``src/repro/dist/exchange.py`` (all but
``measured_exchange_bytes``, which reads a jaxpr: the comm's byte counters
take its place).  Shard k owns rows
[k·R, (k+1)·R) of the table (``dist/table.py``); a strategy answers a
shard's lookups and applies its write-backs on GLOBAL row ids against the
shard's local (R, J, d) table, through the shard's ``Comm``
(``dist/comm.py``):

  ``ring``      D ppermute hops of the (ids, payload) buffers; every shard
                answers or applies the rows it owns as the buffer passes.
                D hops for lookups (answers come home), D-1 for writes.
  ``alltoall``  queries all_gather to every shard, each answers the rows
                it owns, one all_to_all brings the dense answer block home;
                writes all_gather and each shard applies its own rows.
  ``bucketed``  owner-direct: rows sorted into (D, cap) per-owner buckets,
                one all_to_all there (and one back for lookups).  ``cap``
                is planned on the host (``plan_capacity``).

Every strategy is pure row selection and single-owner scatter, so at f32
lookups and writes are BIT-exact against the dense single-device table
ops, and the same training run prints the same losses through any of
them.  Each strategy carries an analytic per-shard bytes model
(``*_bytes``), whose conventions are the comm's counters.

Where JAX clamps an out-of-range gather and drops an out-of-range scatter
(``mode="drop"``), torch raises; every such site is explicit here: gathers
clamp their row, the table writes of rows a shard does not own go through
``mode="drop"`` with row ``rows`` meaning "dropped", and the buckets
scatter overflow into a spare slot that is cut off.  Ragged global batches
are padded with the sentinel id ``num_shards · rows`` (``pad_ragged``),
which every write drops and every lookup answers with zeros.

Compressed traffic (``payload_dtype``): lookup answers and write-back rows
cross the collectives as bf16 or int8 with a per-row scale
(``PayloadCodec``), packed and unpacked by the hand-written kernels of
``kernels/quant.py`` on the card.  Lookups round to nearest even;
write-backs round stochastically with bits drawn per (seed, step, shard).
At one shard nothing crosses a wire and the codec is the f32 identity.

The prefetch lane (``--prefetch-lookups``): ``prefetch_lookup`` is the
lookup for batch k+1, issued before step k runs, so it reads the table
before step k writes it; ``update_sampled_patch`` is step k's write-back
fused with a patch of that prefetched buffer by the rows it writes.  Ring
and alltoall patch from the write payload that already visits every
shard (no added bytes); bucketed sends each written row whose id
reappears in the next batch one more hop, to the shard that prefetched it
(``next_dest``, planned on the host by ``consumer_shards`` in buckets of
``patch_cap``, ``plan_patch_capacity``).  At f32 the patched buffer is
bitwise a lookup of the written table; at bf16/int8 it holds the table's
stored (write-rounded) value, without the read path's re-rounding.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import embedding_table as tbl
from repro_torch.kernels import quant as Q
from repro_torch.kernels.ops import (PAYLOAD_DTYPES, dequantize_payload,
                                     quantize_payload)

EXCHANGES = ("ring", "alltoall", "bucketed")

_WIRE_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16,
               "int8": torch.int8}


# ---------------------------------------------------------------------------
# payload wire format
# ---------------------------------------------------------------------------


class PayloadCodec:
    """Wire format of the embedding payloads that cross the collectives
    (``src/repro/dist/exchange.py:112-190``).

    ``f32`` is the identity.  ``bf16`` parts are ``(values,)``; ``int8``
    parts are ``(values int8, scale f32)`` with one scale per LEADING row,
    0 for all-zero rows, so sentinel rows decode to exact zeros.  Reads
    round to nearest even; writes round stochastically with uint32 bits
    drawn from a generator on the payload's device seeded by (seed, step,
    shard): deterministic given the step, distinct per shard.
    ``bits_fn(step, shard, shape)`` replaces the draw with an array of
    uint32 bits (the parity tests pass the JAX package's).  ``use_kernels``
    False packs with the plain versions on any device.
    """

    def __init__(self, dtype: str = "f32", *, shard: int = 0,
                 use_kernels: bool = True, seed: int = 0x6E57,
                 bits_fn: Optional[Callable] = None):
        if dtype not in PAYLOAD_DTYPES:
            raise ValueError(f"unknown payload dtype {dtype!r}: expected "
                             f"one of {PAYLOAD_DTYPES}")
        self.dtype = dtype
        self.shard = shard
        self.use_kernels = use_kernels
        self.seed = seed
        self.bits_fn = bits_fn

    @property
    def itemsize(self) -> int:
        return {"f32": 4, "bf16": 2, "int8": 1}[self.dtype]

    @property
    def scale_bytes(self) -> int:
        """Per-leading-row side-channel bytes riding next to the values."""
        return 4 if self.dtype == "int8" else 0

    def row_bytes(self, n_elem: int) -> int:
        """Wire bytes of one leading row holding n_elem f32 elements."""
        return n_elem * self.itemsize + self.scale_bytes

    def encode_zeros(self, shape, device) -> Tuple[torch.Tensor, ...]:
        """Encoded parts of an all-zero (B, ...) buffer."""
        v = torch.zeros(shape, dtype=_WIRE_DTYPE[self.dtype], device=device)
        if self.dtype == "int8":
            return v, torch.zeros(shape[:1], dtype=torch.float32,
                                  device=device)
        return (v,)

    def encode_read(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Lookup-answer packing: round to nearest even."""
        if self.dtype == "f32":
            return (x,)
        return quantize_payload(x.contiguous(), dtype=self.dtype,
                                use_kernels=self.use_kernels)

    def rand_bits(self, step: int, shape, device) -> torch.Tensor:
        """The write path's uint32 bits (as int32) for (step, this shard)."""
        if self.bits_fn is not None:
            bits = np.asarray(self.bits_fn(step, self.shard, tuple(shape)),
                              np.uint32).view(np.int32)
            return torch.from_numpy(bits.copy()).to(device)
        state = np.random.SeedSequence([self.seed, int(step), self.shard])
        gen = torch.Generator(device).manual_seed(
            int(state.generate_state(1, np.uint64)[0] >> 1))
        return torch.randint(0, 2 ** 32, tuple(shape), generator=gen,
                             device=device, dtype=torch.int64).to(torch.int32)

    def encode_write(self, x: torch.Tensor, step) -> Tuple[torch.Tensor, ...]:
        """Write-back packing: stochastic rounding, bits from (seed, step,
        shard)."""
        if self.dtype == "f32":
            return (x,)
        bits = self.rand_bits(int(step), x.shape, x.device)
        return quantize_payload(x.contiguous(), bits, dtype=self.dtype,
                                use_kernels=self.use_kernels)

    def decode(self, parts) -> torch.Tensor:
        parts = tuple(parts)
        if self.dtype == "f32":
            return parts[0]
        return dequantize_payload(tuple(p.contiguous() for p in parts),
                                  dtype=self.dtype,
                                  use_kernels=self.use_kernels)


def _rows_where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """``where(mask, a, b)`` with the (B,) mask broadcast over a's rows."""
    return torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


# ---------------------------------------------------------------------------
# strategy base
# ---------------------------------------------------------------------------


class Exchange:
    """One strategy bound to one shard: its ``comm`` (None for a bytes
    model only), the shard count and ``rows`` per shard (owner arithmetic
    is ``id // rows``).

    ``cap`` (bucketed only): per-(shard, owner) bucket capacity; None falls
    back to the local batch size, always safe.  A batch needing more than
    ``cap`` rows of one owner would lose rows, so callers validate planned
    caps with ``required_capacity``.

    ``payload_dtype``: the wire format (``PayloadCodec``), forced to the
    f32 identity at one shard (``src/repro/dist/exchange.py:233``).
    ``use_kernels``/``bits_fn``: passed to the codec.

    ``patch_cap`` (bucketed only): per-(shard, consumer) bucket capacity
    of the prefetch patch hop; None falls back to the local batch size.
    Validate a planned one with ``required_patch_capacity``.
    """

    name = "?"

    def __init__(self, *, comm=None, num_shards: int, rows: int,
                 cap: Optional[int] = None, payload_dtype: str = "f32",
                 use_kernels: bool = True,
                 bits_fn: Optional[Callable] = None,
                 patch_cap: Optional[int] = None):
        if comm is not None and comm.size != num_shards:
            raise ValueError(f"comm has {comm.size} shards, not {num_shards}")
        self.comm = comm
        self.num_shards = num_shards
        self.rows = rows
        self.cap = cap
        self.patch_cap = patch_cap
        self.payload_dtype = "f32" if num_shards <= 1 else payload_dtype
        self.codec = PayloadCodec(self.payload_dtype,
                                  shard=comm.rank if comm else 0,
                                  use_kernels=use_kernels, bits_fn=bits_fn)

    @property
    def me(self) -> int:
        return self.comm.rank

    @property
    def sentinel(self) -> int:
        """Row id of ragged padding: out of every shard's range, so writes
        drop it and lookups answer zeros (``pad_ragged``)."""
        return self.num_shards * self.rows

    # -- table ops (one shard) -----------------------------------------------

    def lookup(self, table: tbl.EmbeddingTable, graph_ids
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def lookup_ages(self, table: tbl.EmbeddingTable, graph_ids
                    ) -> torch.Tensor:
        """Distributed read of ``table.age`` (R, J) int32 for global
        ``graph_ids`` (B,): the age-weighted SED input, exact int32 on the
        wire, 0 for rows nobody owns."""
        raise NotImplementedError

    def update_sampled(self, table: tbl.EmbeddingTable, graph_ids, seg_idx,
                       h_new, step) -> tbl.EmbeddingTable:
        raise NotImplementedError

    def update_all(self, table: tbl.EmbeddingTable, graph_ids, h_all,
                   seg_valid, step) -> tbl.EmbeddingTable:
        raise NotImplementedError

    # -- the prefetch lane (lookahead lookup + fused write-back patch) --------

    def prefetch_lookup(self, table: tbl.EmbeddingTable, graph_ids
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The lookup of the NEXT batch, issued before the current step:
        the same collectives and bytes as ``lookup``, earlier.  The answer
        is stale by the rows the current step writes back, which
        ``update_sampled_patch`` repairs."""
        return self.lookup(table, graph_ids)

    def update_sampled_patch(self, table: tbl.EmbeddingTable, graph_ids,
                             seg_idx, h_new, step, pref, next_ids,
                             next_dest=None):
        """``update_sampled`` fused with a patch of ``pref``, the next
        batch's prefetched ``(emb (B, J, d), initialized (B, J))``, read
        before this write.  ``next_ids``: this shard's (B,) slice of the
        next batch's ids (sentinel slots are never patched).
        ``next_dest`` (bucketed only): the host-planned (B_local,)
        consumer shard of each write row (``consumer_shards``;
        ``num_shards`` = none).  Returns ``(table, (emb, init))``: at f32
        the pair is bitwise ``lookup(table, next_ids)``; at bf16/int8 it
        holds the stored (write-rounded) values without the read-side
        re-rounding (``src/repro/dist/exchange.py:280-302``)."""
        raise NotImplementedError

    def _local_update_patch(self, table, graph_ids, seg_idx, h_new, step,
                            pref, next_ids):
        """One shard: the local write and the local patch."""
        table = self._local_update_sampled(table, graph_ids, seg_idx, h_new,
                                           step)
        return table, self._apply_patch(pref[0], pref[1], next_ids,
                                        graph_ids, seg_idx, h_new)

    def _apply_patch(self, pref_emb, pref_init, next_ids, g_ids, g_sidx,
                     g_h):
        """Write the decoded rows ``(g_ids (G,), g_sidx (G, S), g_h (G, S,
        d))`` into the prefetched ``(B, J, d)`` buffer wherever their id
        appears in ``next_ids`` (B,); local, no collectives.  Write-side
        sentinels are masked and a sentinel in ``next_ids`` exceeds every
        real id, so padding never matches.  Ids are unique within a batch,
        so a next-batch row matches at most one write row (the reference's
        ``argmax`` over the bool match matrix: here over its int8 copy).
        The reference's ``mode="drop"`` column J becomes a spare column,
        written by the rows without a match and cut off."""
        B, J = pref_init.shape[:2]
        match = ((g_ids[:, None] == next_ids[None, :])
                 & (g_ids[:, None] < self.sentinel))          # (G, B)
        has = match.any(dim=0)
        g_of = torch.argmax(match.to(torch.int8), dim=0)       # (B,)
        idx_j = torch.where(has[:, None], g_sidx[g_of].long(),
                            torch.full_like(g_sidx[g_of].long(), J))
        b_idx = torch.arange(B, device=idx_j.device)[:, None].expand(
            idx_j.shape)
        emb = torch.cat([pref_emb, pref_emb.new_zeros(
            (B, 1) + tuple(pref_emb.shape[2:]))], dim=1)
        emb[b_idx, idx_j] = g_h[g_of].to(emb.dtype)
        init = torch.cat([pref_init, pref_init.new_zeros((B, 1))], dim=1)
        init[b_idx, idx_j] = True
        return emb[:, :J], init[:, :J]

    # -- analytic per-shard bytes (the comm's counting conventions) -----------

    def lookup_bytes(self, b_local: int, j_max: int, d_h: int) -> int:
        raise NotImplementedError

    def update_sampled_bytes(self, b_local: int, s: int, d_h: int) -> int:
        raise NotImplementedError

    def update_all_bytes(self, b_local: int, j_max: int, d_h: int) -> int:
        raise NotImplementedError

    # -- pack/unpack launches (the kernels' counts, per call of an op) ------

    def _codec_calls(self, op: str) -> Tuple[int, int]:
        """(packs, unpacks) one call of ``op`` makes on this shard."""
        return (1, 1)

    def codec_launches(self, op: str) -> Dict[str, int]:
        """The payload kernels one call of ``op`` ("lookup",
        "prefetch_lookup", "update_sampled", "update_sampled_patch",
        "update_all") launches on this shard, by name
        (``kernels/quant.py``); none at f32 and for ``lookup_ages``."""
        if self.payload_dtype == "f32" or op == "lookup_ages":
            return {}
        if op == "prefetch_lookup":
            op = "lookup"
        packs, unpacks = self._codec_calls(op)
        bf16 = self.payload_dtype == "bf16"
        if op == "lookup":
            pack = Q.PACK_BF16_DET if bf16 else Q.PACK_INT8_DET
        else:
            pack = Q.PACK_BF16 if bf16 else Q.PACK_INT8
        return {pack: packs, Q.UNPACK_BF16 if bf16 else Q.UNPACK_INT8: unpacks}

    def train_step_bytes(self, b_local: int, j_max: int, s: int, d_h: int,
                         *, use_table: bool) -> int:
        """Per-shard exchange traffic of one train step (lookup + sampled
        write-back when the variant uses the table)."""
        if not use_table:
            return 0
        return (self.lookup_bytes(b_local, j_max, d_h)
                + self.update_sampled_bytes(b_local, s, d_h))

    def prefetch_lookup_bytes(self, b_local: int, j_max: int,
                              d_h: int) -> int:
        """The lookup's collectives: prefetch moves bytes earlier, it adds
        none."""
        return self.lookup_bytes(b_local, j_max, d_h)

    def patch_bytes(self, b_local: int, s: int, d_h: int) -> int:
        """Bytes ``update_sampled_patch`` sends beyond ``update_sampled``:
        0 where the write payload already visits every shard (ring,
        alltoall); bucketed overrides."""
        return 0

    def update_sampled_patch_bytes(self, b_local: int, s: int,
                                   d_h: int) -> int:
        return (self.update_sampled_bytes(b_local, s, d_h)
                + self.patch_bytes(b_local, s, d_h))

    def prefetch_train_step_bytes(self, b_local: int, j_max: int, s: int,
                                  d_h: int, *, use_table: bool) -> int:
        """Per-shard exchange traffic of one PREFETCHED train step: the next
        batch's lookup and the fused write-back and patch; ``patch_bytes``
        more than ``train_step_bytes``."""
        if not use_table:
            return 0
        return (self.prefetch_lookup_bytes(b_local, j_max, d_h)
                + self.update_sampled_patch_bytes(b_local, s, d_h))

    # -- local fallbacks (one shard: no collectives) --------------------------

    def _local_lookup(self, table, graph_ids):
        mine = (graph_ids // self.rows) == 0
        local = torch.clamp(graph_ids, 0, self.rows - 1).long()
        e, i = tbl.lookup(table, local)
        return _rows_where(mine, e, torch.zeros_like(e)), \
            _rows_where(mine, i, torch.zeros_like(i))

    def _local_lookup_ages(self, table, graph_ids):
        mine = (graph_ids // self.rows) == 0
        local = torch.clamp(graph_ids, 0, self.rows - 1).long()
        a = table.age[local]
        return _rows_where(mine, a, torch.zeros_like(a))

    def _local_write_rows(self, graph_ids):
        mine = (graph_ids // self.rows) == 0
        return torch.where(mine, graph_ids,
                           torch.full_like(graph_ids, self.rows))  # dropped

    def _local_update_sampled(self, table, graph_ids, seg_idx, h_new, step):
        return tbl.update_sampled(table, self._local_write_rows(graph_ids),
                                  seg_idx, h_new, step, mode="drop")

    def _local_update_all(self, table, graph_ids, h_all, seg_valid, step):
        return tbl.update_all(table, self._local_write_rows(graph_ids),
                              h_all, seg_valid, step, mode="drop")

    def _owned_rows(self, ids):
        """(local row clamped into the shard, owned-by-me mask) of ids."""
        local = torch.clamp(ids - self.me * self.rows, 0, self.rows - 1)
        return local.long(), (ids // self.rows) == self.me

    def _write_rows(self, ids):
        """Local row of each id this shard owns, ``rows`` (dropped) else."""
        local, mine = self._owned_rows(ids)
        return torch.where(mine, ids - self.me * self.rows,
                           torch.full_like(ids, self.rows))


def _wire_ids(ids: torch.Tensor) -> torch.Tensor:
    """Row ids and segment indices travel as int32, as in the reference
    (its bytes models count 4 bytes an id)."""
    return ids.to(torch.int32)


# ---------------------------------------------------------------------------
# ring
# ---------------------------------------------------------------------------


class RingExchange(Exchange):
    """D-hop ring (``src/repro/dist/exchange.py:422-565``): the (ids,
    payload) buffers hop with shift +1 and every shard answers or applies
    the rows it owns as the buffer passes.  Lookups pack their answers in
    place at each stop (D read-packs) and decode once at home; writes pack
    once at the source and decode at each of the D stops."""

    name = "ring"

    def _codec_calls(self, op):
        # lookups pack at each of the D stops and unpack once at home;
        # writes pack once at the source and unpack at each stop
        D = self.num_shards
        return (D, 1) if op == "lookup" else (1, D)

    def lookup(self, table, graph_ids):
        D = self.num_shards
        B = graph_ids.shape[0]
        parts = self.codec.encode_zeros((B,) + tuple(table.emb.shape[1:]),
                                        table.emb.device)
        init = torch.zeros((B,) + tuple(table.initialized.shape[1:]),
                           dtype=table.initialized.dtype,
                           device=table.initialized.device)
        ids = _wire_ids(graph_ids)
        for _ in range(D):
            local, mine = self._owned_rows(ids)
            e, i = tbl.lookup(table, local)
            e_parts = self.codec.encode_read(e)
            parts = tuple(_rows_where(mine, ep, p)
                          for p, ep in zip(parts, e_parts))
            init = _rows_where(mine, i, init)
            if D > 1:
                ids, init, *parts = self.comm.ppermute((ids, init, *parts))
        return self.codec.decode(parts), init

    def lookup_ages(self, table, graph_ids):
        D = self.num_shards
        if D == 1:
            return self._local_lookup_ages(table, graph_ids)
        B = graph_ids.shape[0]
        ages = torch.zeros((B,) + tuple(table.age.shape[1:]),
                           dtype=table.age.dtype, device=table.age.device)
        ids = _wire_ids(graph_ids)
        for _ in range(D):
            local, mine = self._owned_rows(ids)
            ages = _rows_where(mine, table.age[local], ages)
            ids, ages = self.comm.ppermute((ids, ages))
        return ages

    def update_sampled(self, table, graph_ids, seg_idx, h_new, step):
        D = self.num_shards
        if D == 1:
            return self._local_update_sampled(table, graph_ids, seg_idx,
                                              h_new, step)
        ids, sidx = _wire_ids(graph_ids), _wire_ids(seg_idx)
        parts = self.codec.encode_write(h_new, step)
        for t in range(D):
            table = tbl.update_sampled(table, self._write_rows(ids), sidx,
                                       self.codec.decode(parts), step,
                                       mode="drop")
            if t < D - 1:   # write buffers need no homecoming hop
                ids, sidx, *parts = self.comm.ppermute((ids, sidx, *parts))
        return table

    def update_sampled_patch(self, table, graph_ids, seg_idx, h_new, step,
                             pref, next_ids, next_dest=None):
        """The write-back and the patch on the SAME D-1 hops
        (``src/repro/dist/exchange.py:499-521``): each shard decodes the
        passing buffer once, applies the rows it owns and patches its
        prefetched buffer with all of them; no added bytes."""
        D = self.num_shards
        if D == 1:
            return self._local_update_patch(table, graph_ids, seg_idx,
                                            h_new, step, pref, next_ids)
        emb, init = pref
        ids, sidx = _wire_ids(graph_ids), _wire_ids(seg_idx)
        parts = self.codec.encode_write(h_new, step)
        for t in range(D):
            h_dec = self.codec.decode(parts)
            table = tbl.update_sampled(table, self._write_rows(ids), sidx,
                                       h_dec, step, mode="drop")
            emb, init = self._apply_patch(emb, init, next_ids, ids, sidx,
                                          h_dec)
            if t < D - 1:
                ids, sidx, *parts = self.comm.ppermute((ids, sidx, *parts))
        return table, (emb, init)

    def update_all(self, table, graph_ids, h_all, seg_valid, step):
        D = self.num_shards
        if D == 1:
            return self._local_update_all(table, graph_ids, h_all, seg_valid,
                                          step)
        ids, sv = _wire_ids(graph_ids), seg_valid
        parts = self.codec.encode_write(h_all, step)
        for t in range(D):
            table = tbl.update_all(table, self._write_rows(ids),
                                   self.codec.decode(parts), sv, step,
                                   mode="drop")
            if t < D - 1:
                ids, sv, *parts = self.comm.ppermute((ids, sv, *parts))
        return table

    def lookup_bytes(self, b_local, j_max, d_h):
        # D hops of the (ids i32, init bool, payload) buffer
        if self.num_shards <= 1:
            return 0
        per_hop = b_local * (4 + j_max + self.codec.row_bytes(j_max * d_h))
        return self.num_shards * per_hop

    def update_sampled_bytes(self, b_local, s, d_h):
        if self.num_shards <= 1:
            return 0
        per_hop = b_local * (4 + s * 4 + self.codec.row_bytes(s * d_h))
        return (self.num_shards - 1) * per_hop

    def update_all_bytes(self, b_local, j_max, d_h):
        if self.num_shards <= 1:
            return 0
        per_hop = b_local * (4 + j_max * 4
                             + self.codec.row_bytes(j_max * d_h))
        return (self.num_shards - 1) * per_hop


# ---------------------------------------------------------------------------
# alltoall
# ---------------------------------------------------------------------------


class AllToAllExchange(Exchange):
    """Full-buffer dissemination (``src/repro/dist/exchange.py:573-708``):
    queries all_gather to every shard, each answers the (D, B) block for
    the rows it owns (zeros elsewhere: an all-zero row packs to scale 0),
    and ONE all_to_all brings the answers home, where the requester selects
    its owner's answer by direct indexing.  Writes all_gather the (ids,
    payload) buffers and every shard applies the rows it owns."""

    name = "alltoall"

    def _answer_home(self, answers, owner_of_row, B):
        """(D·B, ...) answers -> this shard's (B, ...) rows of the owners."""
        D = self.num_shards
        back = self.comm.all_to_all(tuple(answers))
        r = torch.arange(B, device=owner_of_row.device)
        return tuple(a.reshape((D, B) + tuple(a.shape[1:]))[owner_of_row, r]
                     for a in back)

    def lookup(self, table, graph_ids):
        D = self.num_shards
        if D == 1:
            return self._local_lookup(table, graph_ids)
        B = graph_ids.shape[0]
        all_ids = self.comm.all_gather(_wire_ids(graph_ids)).reshape(-1)
        local, owned = self._owned_rows(all_ids)
        e, i = tbl.lookup(table, local)
        e = _rows_where(owned, e, torch.zeros_like(e))
        i = _rows_where(owned, i, torch.zeros_like(i))
        parts = self.codec.encode_read(e)                    # leading D·B
        owner = torch.clamp(graph_ids // self.rows, 0, D - 1).long()
        *parts_home, init = self._answer_home((*parts, i), owner, B)
        return self.codec.decode(parts_home), init

    def lookup_ages(self, table, graph_ids):
        D = self.num_shards
        if D == 1:
            return self._local_lookup_ages(table, graph_ids)
        B = graph_ids.shape[0]
        all_ids = self.comm.all_gather(_wire_ids(graph_ids)).reshape(-1)
        local, owned = self._owned_rows(all_ids)
        a = table.age[local]
        a = _rows_where(owned, a, torch.zeros_like(a))
        owner = torch.clamp(graph_ids // self.rows, 0, D - 1).long()
        return self._answer_home((a,), owner, B)[0]

    def _gathered_writes(self, graph_ids, *payloads):
        """all_gather the write buffers: (the gathered ids, their local
        write rows, *flat payloads); the fused patch reuses the ids."""
        ids, *flat = self.comm.all_gather((_wire_ids(graph_ids), *payloads))
        ids = ids.reshape(-1)
        flat = [p.reshape((-1,) + tuple(p.shape[2:])) for p in flat]
        return (ids, self._write_rows(ids), *flat)

    def update_sampled(self, table, graph_ids, seg_idx, h_new, step):
        if self.num_shards == 1:
            return self._local_update_sampled(table, graph_ids, seg_idx,
                                              h_new, step)
        parts = self.codec.encode_write(h_new, step)
        _, local_row, sidx, *eparts = self._gathered_writes(
            graph_ids, _wire_ids(seg_idx), *parts)
        return tbl.update_sampled(table, local_row, sidx,
                                  self.codec.decode(eparts), step,
                                  mode="drop")

    def update_sampled_patch(self, table, graph_ids, seg_idx, h_new, step,
                             pref, next_ids, next_dest=None):
        """The write-back and the patch on the SAME all_gathers
        (``src/repro/dist/exchange.py:653-671``): every shard receives the
        whole write buffer, so the patch is a local scatter over it; no
        added bytes."""
        if self.num_shards == 1:
            return self._local_update_patch(table, graph_ids, seg_idx,
                                            h_new, step, pref, next_ids)
        parts = self.codec.encode_write(h_new, step)
        ids, local_row, sidx, *eparts = self._gathered_writes(
            graph_ids, _wire_ids(seg_idx), *parts)
        h_dec = self.codec.decode(eparts)
        table = tbl.update_sampled(table, local_row, sidx, h_dec, step,
                                   mode="drop")
        return table, self._apply_patch(pref[0], pref[1], next_ids, ids,
                                        sidx, h_dec)

    def update_all(self, table, graph_ids, h_all, seg_valid, step):
        if self.num_shards == 1:
            return self._local_update_all(table, graph_ids, h_all, seg_valid,
                                          step)
        parts = self.codec.encode_write(h_all, step)
        _, local_row, sv, *eparts = self._gathered_writes(graph_ids,
                                                          seg_valid, *parts)
        return tbl.update_all(table, local_row, self.codec.decode(eparts),
                              sv, step, mode="drop")

    def lookup_bytes(self, b_local, j_max, d_h):
        if self.num_shards <= 1:
            return 0
        # ids all_gather + (payload, init bool) answers all_to_all
        return (self.num_shards - 1) * b_local * (
            4 + self.codec.row_bytes(j_max * d_h) + j_max)

    def update_sampled_bytes(self, b_local, s, d_h):
        if self.num_shards <= 1:
            return 0
        # (ids, seg_idx, payload) all_gathered to every shard
        return (self.num_shards - 1) * b_local * (
            4 + s * 4 + self.codec.row_bytes(s * d_h))

    def update_all_bytes(self, b_local, j_max, d_h):
        if self.num_shards <= 1:
            return 0
        # (ids, payload, seg_valid f32) all_gathered to every shard
        return (self.num_shards - 1) * b_local * (
            4 + self.codec.row_bytes(j_max * d_h) + j_max * 4)


# ---------------------------------------------------------------------------
# bucketed
# ---------------------------------------------------------------------------


class BucketedExchange(Exchange):
    """Owner-direct (``src/repro/dist/exchange.py:711-918``): the local
    rows are stable-sorted by owner into (D, cap) buckets; ONE all_to_all
    delivers each bucket to its owner, which answers (one all_to_all back)
    or applies it.  Each row travels one hop there and one home, so the
    traffic scales with ``cap``, not with the shard count."""

    name = "bucketed"

    def _codec_calls(self, op):
        # the fused patch decodes its patch buckets once more
        return (1, 2) if op == "update_sampled_patch" else (1, 1)

    def _plan_by(self, key):
        """(order, sorted key, rank within key) of a (B,) routing key
        (``src/repro/dist/exchange.py:731``).  A key may be num_shards
        (the patch's "no consumer"): ``_bucket`` drops those rows."""
        key = key.long()
        order = torch.argsort(key, stable=True)
        sk = key[order]
        pos = torch.arange(sk.shape[0], device=sk.device) \
            - torch.searchsorted(sk, sk, side="left")
        return order, sk, pos

    def _plan(self, graph_ids):
        """(order, sorted owner, rank within owner) of the local rows."""
        return self._plan_by(torch.clamp(graph_ids // self.rows, 0,
                                         self.num_shards - 1))

    def _bucket(self, cap, so, pos, x_sorted, fill):
        """(D, cap, ...) buckets of x_sorted at [key, rank]; a rank at or
        beyond ``cap`` or a key past the last shard (JAX's mode="drop")
        lands in one spare slot past the buckets, which is cut off."""
        D = self.num_shards
        flat = torch.where((pos < cap) & (so < D), so * cap + pos,
                           torch.full_like(pos, D * cap))
        b = torch.full((D * cap + 1,) + tuple(x_sorted.shape[1:]), fill,
                       dtype=x_sorted.dtype, device=x_sorted.device)
        b[flat] = x_sorted
        return b[:D * cap].reshape((D, cap) + tuple(x_sorted.shape[1:]))

    def _queries(self, graph_ids):
        """Bucket the local ids by owner and send each bucket to its owner:
        (plan, cap, the (D·cap,) ids this shard owns or sentinels)."""
        cap = self.cap or graph_ids.shape[0]
        order, so, pos = self._plan(graph_ids)
        ids = self._bucket(cap, so, pos, _wire_ids(graph_ids)[order],
                           self.sentinel)
        return (order, so, pos), cap, self.comm.all_to_all(ids).reshape(-1)

    def _home(self, plan, cap, answers):
        """(D·cap, ...) answers -> the local rows in their original order
        (a rank beyond ``cap`` reads the last slot, as JAX clamps)."""
        order, so, pos = plan
        inv = torch.argsort(order, stable=True)
        pos = torch.clamp(pos, max=cap - 1)
        back = self.comm.all_to_all(tuple(answers))
        return tuple(a.reshape((self.num_shards, cap) + tuple(a.shape[1:]))
                     [so, pos][inv] for a in back)

    def lookup(self, table, graph_ids):
        if self.num_shards == 1:
            return self._local_lookup(table, graph_ids)
        plan, cap, q = self._queries(graph_ids)
        local, owned = self._owned_rows(q)         # sentinels never owned
        e, i = tbl.lookup(table, local)
        e = _rows_where(owned, e, torch.zeros_like(e))   # scale 0 under int8
        i = _rows_where(owned, i, torch.zeros_like(i))
        parts = self.codec.encode_read(e)                # leading D·cap
        *parts_home, init = self._home(plan, cap, (*parts, i))
        return self.codec.decode(parts_home), init

    def lookup_ages(self, table, graph_ids):
        if self.num_shards == 1:
            return self._local_lookup_ages(table, graph_ids)
        plan, cap, q = self._queries(graph_ids)
        local, owned = self._owned_rows(q)
        a = table.age[local]
        a = _rows_where(owned, a, torch.zeros_like(a))
        return self._home(plan, cap, (a,))[0]

    def _bucketed_writes(self, graph_ids, *payloads):
        cap = self.cap or graph_ids.shape[0]
        order, so, pos = self._plan(graph_ids)
        bufs = [self._bucket(cap, so, pos, _wire_ids(graph_ids)[order],
                             self.sentinel)]
        bufs += [self._bucket(cap, so, pos, p[order], 0) for p in payloads]
        q, *flat = self.comm.all_to_all(tuple(bufs))
        flat = [b.reshape((-1,) + tuple(b.shape[2:])) for b in flat]
        return (self._write_rows(q.reshape(-1)), *flat)

    def update_sampled(self, table, graph_ids, seg_idx, h_new, step):
        if self.num_shards == 1:
            return self._local_update_sampled(table, graph_ids, seg_idx,
                                              h_new, step)
        parts = self.codec.encode_write(h_new, step)
        local_row, sidx, *eparts = self._bucketed_writes(
            graph_ids, _wire_ids(seg_idx), *parts)
        return tbl.update_sampled(table, local_row, sidx,
                                  self.codec.decode(eparts), step,
                                  mode="drop")

    def update_sampled_patch(self, table, graph_ids, seg_idx, h_new, step,
                             pref, next_ids, next_dest=None):
        """The owner-direct write-back, then the patch hop
        (``src/repro/dist/exchange.py:824-863``): owner-direct writes never
        reach the shards that prefetched the rows, so each write row with
        a consumer in the next batch (``next_dest``, planned on the host)
        travels once more, consumer-direct, in (D, patch_cap) buckets of
        its encoded payload, decoded again for the patch.  Rows without a
        consumer (``next_dest == num_shards``) never travel."""
        if self.num_shards == 1:
            return self._local_update_patch(table, graph_ids, seg_idx,
                                            h_new, step, pref, next_ids)
        if next_dest is None:
            raise ValueError(
                "bucketed update_sampled_patch needs next_dest: the "
                "host-planned consumer shard of each write row "
                "(consumer_shards)")
        sidx = _wire_ids(seg_idx)
        parts = self.codec.encode_write(h_new, step)
        local_row, w_sidx, *eparts = self._bucketed_writes(graph_ids, sidx,
                                                           *parts)
        table = tbl.update_sampled(table, local_row, w_sidx,
                                   self.codec.decode(eparts), step,
                                   mode="drop")
        cap = self.patch_cap or graph_ids.shape[0]
        order, sd, pos = self._plan_by(next_dest)
        bufs = [self._bucket(cap, sd, pos, _wire_ids(graph_ids)[order],
                             self.sentinel),
                self._bucket(cap, sd, pos, sidx[order], 0)]
        bufs += [self._bucket(cap, sd, pos, p[order], 0) for p in parts]
        q_ids, q_sidx, *q_parts = [
            b.reshape((-1,) + tuple(b.shape[2:]))
            for b in self.comm.all_to_all(tuple(bufs))]
        return table, self._apply_patch(pref[0], pref[1], next_ids, q_ids,
                                        q_sidx, self.codec.decode(q_parts))

    def update_all(self, table, graph_ids, h_all, seg_valid, step):
        if self.num_shards == 1:
            return self._local_update_all(table, graph_ids, h_all, seg_valid,
                                          step)
        parts = self.codec.encode_write(h_all, step)
        local_row, sv, *eparts = self._bucketed_writes(graph_ids, seg_valid,
                                                       *parts)
        return tbl.update_all(table, local_row, self.codec.decode(eparts),
                              sv, step, mode="drop")

    def _cap(self, b_local: int) -> int:
        return self.cap if self.cap is not None else b_local

    def lookup_bytes(self, b_local, j_max, d_h):
        if self.num_shards <= 1:
            return 0
        # id buckets one hop there + (payload, init bool) one hop back
        return (self.num_shards - 1) * self._cap(b_local) * (
            4 + self.codec.row_bytes(j_max * d_h) + j_max)

    def update_sampled_bytes(self, b_local, s, d_h):
        if self.num_shards <= 1:
            return 0
        return (self.num_shards - 1) * self._cap(b_local) * (
            4 + s * 4 + self.codec.row_bytes(s * d_h))

    def update_all_bytes(self, b_local, j_max, d_h):
        if self.num_shards <= 1:
            return 0
        return (self.num_shards - 1) * self._cap(b_local) * (
            4 + self.codec.row_bytes(j_max * d_h) + j_max * 4)

    def patch_bytes(self, b_local, s, d_h):
        # one consumer-direct all_to_all of (ids, seg_idx, payload)
        # patch_cap-sized buckets
        if self.num_shards <= 1:
            return 0
        c = self.patch_cap if self.patch_cap is not None else b_local
        return (self.num_shards - 1) * c * (
            4 + s * 4 + self.codec.row_bytes(s * d_h))


# ---------------------------------------------------------------------------
# construction / auto selection
# ---------------------------------------------------------------------------

_STRATEGIES = {cls.name: cls
               for cls in (RingExchange, AllToAllExchange, BucketedExchange)}


def make_exchange(name: str, *, comm=None, num_shards: int, rows: int,
                  cap: Optional[int] = None, payload_dtype: str = "f32",
                  use_kernels: bool = True,
                  bits_fn: Optional[Callable] = None,
                  patch_cap: Optional[int] = None) -> Exchange:
    """Strategy by name.  "auto" is the launcher's policy: resolve it with
    ``select_exchange`` (it needs the batch geometry) first."""
    if name == "auto":
        raise ValueError(
            '"auto" must be resolved before building steps: call '
            "select_exchange(num_shards, b_local, j_max, s, d_h) with the "
            "batch geometry and pass the returned strategy name")
    if name not in _STRATEGIES:
        raise ValueError(f"unknown exchange strategy {name!r}: expected "
                         f"one of {EXCHANGES} or 'auto'")
    return _STRATEGIES[name](comm=comm, num_shards=num_shards, rows=rows,
                             cap=cap, payload_dtype=payload_dtype,
                             use_kernels=use_kernels, bits_fn=bits_fn,
                             patch_cap=patch_cap)


def select_exchange(num_shards: int, b_local: int, j_max: int, s: int,
                    d_h: int, *, cap: Optional[int] = None,
                    payload_dtype: str = "f32") -> str:
    """The "--exchange=auto" policy: the strategy with the fewest analytic
    per-shard train-step bytes at this (shard count, payload dtype); the
    first of EXCHANGES wins ties, so one shard stays on the ring.  ``cap``
    defaults to the uniform-owner estimate ceil(b_local / num_shards)."""
    if num_shards <= 1:
        return "ring"
    cap_est = cap if cap is not None else -(-b_local // num_shards)
    best_name, best_bytes = None, None
    for name in EXCHANGES:
        ex = make_exchange(name, num_shards=num_shards, rows=1, cap=cap_est,
                           payload_dtype=payload_dtype)
        b = ex.train_step_bytes(b_local, j_max, s, d_h, use_table=True)
        if best_bytes is None or b < best_bytes:
            best_name, best_bytes = name, b
    return best_name


# ---------------------------------------------------------------------------
# host-side planning: ragged batches + bucket capacity
# ---------------------------------------------------------------------------


def pad_ragged(num_shards: int, rows: int, ids, *payloads):
    """Pad a GLOBAL exchange batch to a shard-divisible size: ids with the
    sentinel ``num_shards · rows`` (writes drop it, lookups answer zeros),
    payloads with zeros.  Returns ``(padded_ids, *padded_payloads,
    n_real)``; slice exchange results back to ``[:n_real]``."""
    ids = np.asarray(ids)
    B = ids.shape[0]
    Bp = -(-B // num_shards) * num_shards
    if Bp == B:
        return (ids, *[np.asarray(p) for p in payloads], B)
    out = [np.concatenate(
        [ids, np.full(Bp - B, num_shards * rows, ids.dtype)])]
    for p in payloads:
        p = np.asarray(p)
        out.append(np.concatenate(
            [p, np.zeros((Bp - B,) + p.shape[1:], p.dtype)]))
    return (*out, B)


def required_capacity(global_ids, *, num_shards: int, rows: int) -> int:
    """Smallest per-(shard, owner) bucket capacity that fits ONE global
    batch under the contiguous batch split (shard k gets batch rows
    [k·B_local, (k+1)·B_local)).  Sentinel ids count against the last
    shard's bucket, matching the clipped owner arithmetic."""
    ids = np.asarray(global_ids).ravel()
    if ids.size % num_shards:
        ids = pad_ragged(num_shards, rows, ids)[0]
    per_dev = ids.reshape(num_shards, -1)
    owner = np.clip(per_dev // rows, 0, num_shards - 1)
    cap = 1
    for dev in range(num_shards):
        counts = np.bincount(owner[dev], minlength=num_shards)
        cap = max(cap, int(counts.max()))
    return cap


def plan_capacity(id_batches: Iterable, *, num_shards: int,
                  rows: int) -> int:
    """Bucket capacity covering EVERY batch of an id schedule: the
    host-side planning that makes ``bucketed`` beat the ring."""
    cap = 1
    for ids in id_batches:
        cap = max(cap, required_capacity(ids, num_shards=num_shards,
                                         rows=rows))
    return cap


def consumer_shards(cur_ids, next_ids, *, num_shards: int,
                    rows: int) -> np.ndarray:
    """For each row of the CURRENT global batch, the shard whose slice of
    the NEXT global batch holds the same id (the bucketed patch's
    ``next_dest``), under the contiguous batch split; ``num_shards`` where
    no shard does.  Sentinel rows on either side never match; ragged
    batches are sentinel-padded first, as on the device."""
    sent = num_shards * rows
    cur = np.asarray(cur_ids).ravel()
    if cur.size % num_shards:
        cur = pad_ragged(num_shards, rows, cur)[0]
    nxt = np.asarray(next_ids).ravel()
    if nxt.size % num_shards:
        nxt = pad_ragged(num_shards, rows, nxt)[0]
    b_next = nxt.size // num_shards
    shard_of = {int(r): i // b_next for i, r in enumerate(nxt)
                if int(r) != sent}
    return np.asarray([shard_of.get(int(r), num_shards) for r in cur],
                      np.int32)


def required_patch_capacity(cur_ids, next_ids, *, num_shards: int,
                            rows: int) -> int:
    """Smallest per-(shard, consumer) patch bucket capacity for ONE
    (batch k, batch k+1) pair: how many of one shard's write rows reappear
    in one consumer shard's slice of the next batch."""
    dest = consumer_shards(cur_ids, next_ids, num_shards=num_shards,
                           rows=rows)
    cap = 1
    for per_dev in dest.reshape(num_shards, -1):
        real = per_dev[per_dev < num_shards]
        if real.size:
            cap = max(cap, int(np.bincount(real).max()))
    return cap


def plan_patch_capacity(id_batches: Iterable, *, num_shards: int,
                        rows: int) -> int:
    """Patch bucket capacity covering every CONSECUTIVE pair of an id
    schedule (step k patches batch k+1's buffer)."""
    cap = 1
    batches = [np.asarray(b) for b in id_batches]
    for a, b in zip(batches, batches[1:]):
        cap = max(cap, required_patch_capacity(a, b, num_shards=num_shards,
                                               rows=rows))
    return cap
