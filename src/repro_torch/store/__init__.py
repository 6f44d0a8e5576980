"""The historical-embedding store of the port: ``DeviceStore`` (the whole
table in device memory) over ``SlotMap`` slot bookkeeping.  ``TieredStore``
is not ported yet."""
from repro_torch.store.base import DeviceStore, EmbeddingStore, StoreCounters  # noqa: F401
from repro_torch.store.slots import SlotMap  # noqa: F401
