"""Host↔device transfer pricing of the residency ladder (the port's copy of
the reference's ``FetchModel`` in ``serving/hoststore.py``). The offload
baseline prices its LRU misses and prefetches with it; the reference's
``HostExpertStore`` (DynaExq's host tier) is not ported yet and will price
its fetches with the same model."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class FetchModel:
    """Deterministic host↔device transfer-cost model: bytes over ``gbps``
    (16.0, PCIe gen4 x16, is the paper's A6000; give the card's measured
    pinned copy rate to price this card's link). Layered on measured
    compute so backend comparisons reflect transfer volume, not noise."""

    gbps: float = 16.0

    @property
    def bytes_per_s(self) -> float:
        return self.gbps * 1e9

    def stall_s(self, demand_bytes: int, overlap_bytes: int = 0,
                compute_s: float = 0.0) -> float:
        """Critical-path seconds: demand fetches always stall; overlapped
        (prefetch) bytes hide under ``compute_s`` and only their spill
        stalls."""
        spill = max(0.0, overlap_bytes - compute_s * self.bytes_per_s)
        return (demand_bytes + spill) / self.bytes_per_s
