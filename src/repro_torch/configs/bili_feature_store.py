"""The paper's own workload: a high-traffic item-feature table
(§3.2 Latency: 40M items, 1KB per item, ~700k key-seeks/s peak) served by
the NeighborKV batch-query architecture."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class FeatureStoreConfig:
    name: str = "bili-feature-store"
    n_items: int = 40_000_000
    value_bytes: int = 1024
    hot_fraction: float = 0.1
    max_shard_bytes: int = 1 << 32          # 4 GB shards
    load_factor: float = 0.8
    peak_kps: int = 700_000


CONFIG = FeatureStoreConfig()
SMOKE = FeatureStoreConfig(name="bili-feature-store-smoke", n_items=20_000,
                           value_bytes=64, max_shard_bytes=1 << 18)
