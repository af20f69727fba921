"""NVMe cost model + admission/eviction policies for the hybrid store.

Without an NVMe device at hand, the *protocol* (tier bit, LRU metadata,
async eviction, ≤1 IO per cold miss) is implemented for real in
core/hybrid_store.py against a file-backed np.memmap, and this module supplies
the device cost model used by benchmarks to report what the same access
pattern would cost on the paper's hardware.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DeviceCostModel:
    """Seconds-per-access cost model."""
    name: str
    read_latency_s: float          # per-IO latency
    read_bw_Bps: float             # sustained sequential read bandwidth
    queue_depth: int = 32          # concurrent IOs the device sustains
    write_bw_Bps: float = 0.0      # sustained sequential write bandwidth
    #                                (0.0 == symmetric with reads)

    def batch_read_seconds(self, n_ios: int, bytes_per_io: int) -> float:
        """Cost of n random reads issued at full queue depth."""
        if n_ios <= 0:
            return 0.0
        latency_limited = self.read_latency_s * n_ios / self.queue_depth
        bw_limited = n_ios * bytes_per_io / self.read_bw_Bps
        return max(latency_limited, bw_limited)

    def rewrite_seconds(self, n_rows: int, bytes_per_row: int) -> float:
        """Cost of one compaction pass over ``n_rows`` live rows: a
        queue-depth random gather from the old file plus a sequential
        stream into the fresh one.  This is the background IO the hybrid
        store's ``compact()`` spends to reclaim garbage — benchmarks
        charge it here so the reclaim-vs-IO trade-off is visible on the
        paper's hardware, not just on the host's page cache."""
        if n_rows <= 0:
            return 0.0
        write_bw = self.write_bw_Bps or self.read_bw_Bps
        return (self.batch_read_seconds(n_rows, bytes_per_row)
                + n_rows * bytes_per_row / write_bw)


# Typical datacenter parts (public spec sheets).
NVME_GEN4 = DeviceCostModel("nvme-gen4", read_latency_s=80e-6,
                            read_bw_Bps=3.5e9, queue_depth=128,
                            write_bw_Bps=2.8e9)
DDR5 = DeviceCostModel("ddr5", read_latency_s=90e-9, read_bw_Bps=60e9,
                       queue_depth=64)


@dataclasses.dataclass
class TierStats:
    lookups: int = 0
    hot_hits: int = 0
    cold_misses: int = 0
    not_found: int = 0
    admissions: int = 0
    evictions: int = 0
    cold_bytes_read: int = 0
    hot_bytes_read: int = 0
    # --- online garbage accounting (cold-store compaction) ---
    # every copy-on-write supersede and every delete leaves its old cold
    # row behind; those bytes accrue here until a compaction pass rewrites
    # the live rows into a fresh file and resets the counter
    garbage_bytes: int = 0
    cold_file_bytes: int = 0       # current cold file size (grows + compacts)
    compactions: int = 0
    compaction_rows_rewritten: int = 0
    compaction_bytes_reclaimed: int = 0

    @property
    def hit_rate(self) -> float:
        den = self.hot_hits + self.cold_misses
        return self.hot_hits / den if den else 0.0

    @property
    def garbage_fraction(self) -> float:
        """Fraction of the cold file holding superseded/orphaned rows —
        the compaction trigger signal."""
        if self.cold_file_bytes <= 0:
            return 0.0
        return self.garbage_bytes / self.cold_file_bytes

    def modeled_seconds(self, bytes_per_value: int,
                        hot: DeviceCostModel = DDR5,
                        cold: DeviceCostModel = NVME_GEN4) -> float:
        return (hot.batch_read_seconds(self.hot_hits, bytes_per_value)
                + cold.batch_read_seconds(self.cold_misses, bytes_per_value))

    def modeled_compaction_seconds(self, bytes_per_value: int,
                                   cold: DeviceCostModel = NVME_GEN4
                                   ) -> float:
        """Modeled background IO all compaction passes so far spent
        rewriting live rows (gather from the old file + sequential stream
        into the new one)."""
        return cold.rewrite_seconds(self.compaction_rows_rewritten,
                                    bytes_per_value)
