"""The historical-embedding store of the port: ``DeviceStore`` keeps the
whole table in device memory, ``TieredStore`` a bounded set of hot rows on
the device over a host-RAM tier, with the eviction write-backs landing on
an ``AsyncHostWriter`` thread (``delta_gate`` and ``RowForecaster`` are
its optional write-back admission and fault-in forecast).  Steps see only
a plain ``EmbeddingTable`` of device rows; a capped store trains bitwise
like the device-resident one (tests/test_torch_store.py)."""
from repro_torch.store.base import (DeviceStore, EmbeddingStore,  # noqa: F401
                                    PreparedMigration, StoreCounters,
                                    device_rows_per_shard, padded_rows,
                                    rows_per_shard)
from repro_torch.store.forecast import RowForecaster  # noqa: F401
from repro_torch.store.slots import SlotMap  # noqa: F401
from repro_torch.store.tiered import TieredStore  # noqa: F401
from repro_torch.store.writeback import AsyncHostWriter, delta_gate  # noqa: F401

__all__ = [
    "AsyncHostWriter", "DeviceStore", "EmbeddingStore", "PreparedMigration",
    "RowForecaster", "SlotMap", "StoreCounters", "TieredStore", "delta_gate",
    "device_rows_per_shard", "padded_rows", "rows_per_shard",
]
