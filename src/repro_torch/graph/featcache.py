"""Device-resident hot-feature cache (static, degree-ordered) + frontier
deduplication.

Port of the static half of ``repro/graph/featcache.py``.  Two levers keep
rows off the host->device link:

  * power-law frontiers are dominated by hub nodes, so the top-K hottest
    node features (``GraphDataset.feature_hotness``) are pinned in device
    memory, and
  * with-replacement sampling re-references the same vertices many times
    per mini-batch, so only one row per *unique* node id is gathered and
    shipped (the paper's Feature Duplicator, Section IV-C, run on the device
    after the interconnect).

``compact_lookup`` dedups a frontier and classifies its unique ids against
the cache; the on-device combine (``kernels.ops.assemble_features``) expands
the shipped unique-miss rows back into the positional layer-0 input.

The host hot block is a torch tensor in the transfer dtype (``float32`` or
``bfloat16``); ``data_on(device)`` places it once per device.  The dynamic
refresh (``cache_refresh``), the sharded plane and hotness tracking are not
ported yet (ROADMAP, next slice): the cache version stays 0.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..annotations import guarded_by, requires_lock
from .storage import FeatureSource, as_feature_source

__all__ = ["CacheLookup", "CacheStats", "FeatureCache", "build_cache",
           "compact_lookup", "wire_row_bytes", "to_transfer_dtype"]

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _torch_dtype(transfer_dtype: str) -> torch.dtype:
    if transfer_dtype not in _TORCH_DTYPES:
        raise ValueError(f"unsupported transfer dtype {transfer_dtype!r}; "
                         f"have {sorted(_TORCH_DTYPES)}")
    return _TORCH_DTYPES[transfer_dtype]


def wire_row_bytes(feat_dim: int, transfer_dtype: str) -> int:
    """Bytes one feature row occupies on the wire (the transfer dtype)."""
    return int(feat_dim) * _torch_dtype(transfer_dtype).itemsize


def to_transfer_dtype(rows: np.ndarray, transfer_dtype: str) -> torch.Tensor:
    """Host rows as a torch tensor in the transfer dtype.  float32 -> bf16
    rounds to nearest even, the same bits ``ml_dtypes`` gives the
    reference."""
    t = torch.from_numpy(np.ascontiguousarray(rows))
    dtype = _torch_dtype(transfer_dtype)
    return t if t.dtype == dtype else t.to(dtype)


@dataclasses.dataclass
class CacheLookup:
    """Result of partitioning one frontier against the cache.

    ``slots``/``miss_index`` describe the full [N]-row frontier the GNN
    consumes; under dedup the miss block holds one row per unique miss id,
    so several positions share a ``miss_index`` entry.
    """
    ids: np.ndarray         # int64 [N] the queried node ids (positional)
    slots: np.ndarray       # int32 [N] cache slot per position, -1 = miss
    miss_index: np.ndarray  # int32 [N] row into the miss block (0 for hits)
    miss_ids: np.ndarray    # int64 [M] node ids to gather on the host
    unique_ids: np.ndarray  # int64 [U] deduped frontier (== ids, dedup off)
    inverse: np.ndarray     # int32 [N] position -> row in unique_ids
    version: int = 0        # cache version the lookup was classified at

    @property
    def num_rows(self) -> int:
        return int(self.ids.shape[0])

    @property
    def num_unique(self) -> int:
        return int(self.unique_ids.shape[0])

    @property
    def num_miss(self) -> int:
        """Rows in the miss block (unique misses under dedup)."""
        return int(self.miss_ids.shape[0])

    @property
    def num_hit(self) -> int:
        """Frontier *positions* served by the cache."""
        return int(np.count_nonzero(self.slots >= 0))

    @property
    def miss_positions(self) -> int:
        return self.num_rows - self.num_hit

    @property
    def dup_miss_rows(self) -> int:
        """Positional miss rows that alias an already-shipped unique row."""
        return self.miss_positions - self.num_miss

    @property
    def hit_rate(self) -> float:
        return self.num_hit / max(self.num_rows, 1)

    @property
    def dup_factor(self) -> float:
        return self.num_rows / max(self.num_unique, 1)


@dataclasses.dataclass
class CacheStats:
    lookups: int = 0
    hit_rows: int = 0        # frontier positions served by the cache
    miss_rows: int = 0       # frontier positions not in the cache
    unique_rows: int = 0     # unique ids across lookups
    saved_bytes: int = 0     # host->device bytes avoided by cache hits
    dedup_saved_bytes: int = 0  # bytes avoided by shipping unique misses

    @property
    def total_rows(self) -> int:
        return self.hit_rows + self.miss_rows

    @property
    def hit_rate(self) -> float:
        return self.hit_rows / max(self.total_rows, 1)

    def merge(self, other: "CacheStats") -> None:
        self.lookups += other.lookups
        self.hit_rows += other.hit_rows
        self.miss_rows += other.miss_rows
        self.unique_rows += other.unique_rows
        self.saved_bytes += other.saved_bytes
        self.dedup_saved_bytes += other.dedup_saved_bytes


def compact_lookup(ids: np.ndarray,
                   slot_of: Optional[np.ndarray] = None) -> CacheLookup:
    """Deduplicate a frontier and (optionally) classify it against a cache:
    unique ids + int32 inverse map once, the uniques classified against
    ``slot_of`` (all-miss when ``None``), the per-unique verdicts broadcast
    back to positions — one miss row per unique miss."""
    ids = np.asarray(ids, dtype=np.int64)
    unique_ids, inverse = np.unique(ids, return_inverse=True)
    inverse = inverse.astype(np.int32)
    if slot_of is None:
        uniq_slots = np.full(unique_ids.shape[0], -1, dtype=np.int32)
    else:
        uniq_slots = slot_of[unique_ids]
    is_miss = uniq_slots < 0
    # rank of each unique miss among the misses = its row in the miss block
    uniq_miss_index = np.cumsum(is_miss, dtype=np.int32)
    uniq_miss_index = np.where(is_miss, uniq_miss_index - 1, 0
                               ).astype(np.int32)
    return CacheLookup(ids=ids, slots=uniq_slots[inverse],
                       miss_index=uniq_miss_index[inverse],
                       miss_ids=unique_ids[is_miss],
                       unique_ids=unique_ids, inverse=inverse)


def positional_lookup(ids: np.ndarray, slot_of: np.ndarray) -> CacheLookup:
    """Legacy (dedup off) classification: one miss row per miss position,
    in frontier order."""
    ids = np.asarray(ids, dtype=np.int64)
    slots = slot_of[ids]
    is_miss = slots < 0
    miss_index = np.cumsum(is_miss, dtype=np.int32)
    miss_index = np.where(is_miss, miss_index - 1, 0).astype(np.int32)
    return CacheLookup(ids=ids, slots=slots, miss_index=miss_index,
                       miss_ids=ids[is_miss], unique_ids=ids,
                       inverse=np.arange(ids.shape[0], dtype=np.int32))


# one lock covers the stats windows, the memoized device blocks and the
# in-flight pin counts.  Deliberately undeclared: slot_of, cached_ids,
# version and the host block (written once in __init__, read-only after:
# the static cache never refreshes), capacity/feat_dim/row_bytes.
@guarded_by("_lock", "stats", "epoch_stats", "_device_data", "_inflight")
class FeatureCache:
    """Top-K hot-row cache over any ``FeatureSource``: ``capacity`` rows
    chosen by descending ``hotness``, materialized once on the host in
    ``transfer_dtype`` and placed per device on first use."""

    def __init__(self, source: "FeatureSource | np.ndarray",
                 hotness: np.ndarray, capacity: int,
                 transfer_dtype: str = "float32"):
        source = as_feature_source(source)
        num_nodes, feat_dim = source.shape
        capacity = int(max(0, min(capacity, num_nodes)))
        hotness = np.asarray(hotness, dtype=np.float64)
        if hotness.shape[0] != num_nodes:
            raise ValueError("hotness must have one entry per node")
        # stable order so equal-hotness ties are deterministic across runs
        order = np.argsort(-hotness, kind="stable")[:capacity]
        self.source = source
        self.transfer_dtype = transfer_dtype
        self.cached_ids = np.ascontiguousarray(order.astype(np.int64))
        self.capacity = capacity
        self.num_nodes = int(num_nodes)
        self.feat_dim = int(feat_dim)
        self.row_bytes = wire_row_bytes(feat_dim, transfer_dtype)
        self.slot_of = np.full(num_nodes, -1, dtype=np.int32)
        self.slot_of[self.cached_ids] = np.arange(capacity, dtype=np.int32)
        self.host_rows = to_transfer_dtype(source.take(self.cached_ids),
                                           transfer_dtype)
        self._expected_hit_rate = (float(hotness[self.cached_ids].sum())
                                   / max(float(hotness.sum()), 1e-12))
        self.version = 0
        self.stats = CacheStats()        # lifetime totals
        self.epoch_stats = CacheStats()  # the measurement window
        self._lock = threading.Lock()
        self._device_data: Dict[Tuple[str, int], torch.Tensor] = {}
        # in-flight lookup pins: version -> count not yet released
        self._inflight: Dict[int, int] = {}

    @property
    def nbytes(self) -> int:
        """Device bytes pinned by the hot block (per trainer device)."""
        return self.host_rows.numel() * self.host_rows.element_size()

    @property
    def expected_hit_rate(self) -> float:
        """Design-time hit-rate estimate (hotness mass covered) — feeds the
        performance model's Eq. 7/8 cache term before any measurement."""
        return self._expected_hit_rate

    def measured_hit_rate(self) -> float:
        """Measured positional hit rate over the current window (the
        lifetime rate before any lookup landed in it)."""
        with self._lock:
            if self.epoch_stats.total_rows:
                return self.epoch_stats.hit_rate
            return self.stats.hit_rate

    def data_on(self, device: torch.device,
                version: Optional[int] = None) -> torch.Tensor:
        """The [K, F] hot block resident on ``device``, placed once per
        (device, version) and memoized.  The static cache has one version;
        asking for another is a consistency bug and raises."""
        ver = self.version if version is None else int(version)
        if ver != self.version:
            raise RuntimeError(f"cache version {ver} does not exist (static "
                               f"cache, version {self.version})")
        key = (str(device), ver)
        with self._lock:
            arr = self._device_data.get(key)
            if arr is None:
                # placed under the lock so two trainer threads never ship
                # the same [K, F] block twice; runs once per device
                arr = self.host_rows.to(device)
                self._device_data[key] = arr
        return arr

    # --------------------------------------------------------------- lookup

    def lookup(self, ids: np.ndarray, dedup: bool = True,
               record: bool = True, pin: bool = False) -> CacheLookup:
        """Partition one frontier into cached slots and miss rows.

        ``dedup=True`` classifies only the frontier's unique ids and
        compacts the miss block to one row per unique miss; ``dedup=False``
        keeps one miss row per frontier position.  Stats count positions.
        ``record=False`` defers accounting to ``record_lookup`` (the loader
        records only once its gather succeeded).  ``pin=True`` registers
        the lookup as in flight until ``release_lookup``.
        """
        if pin:
            with self._lock:
                self._inflight[self.version] = \
                    self._inflight.get(self.version, 0) + 1
        if dedup:
            look = compact_lookup(ids, self.slot_of)
        else:
            look = positional_lookup(ids, self.slot_of)
        look.version = self.version
        if record:
            self.record_lookup(look)
        return look

    def release_lookup(self, look: CacheLookup) -> None:
        """Release one ``lookup(pin=True)`` registration (a no-op for an
        unpinned lookup)."""
        with self._lock:
            self._release_locked(int(look.version))

    @requires_lock("_lock")
    def _release_locked(self, version: int) -> None:
        n = self._inflight.get(version)
        if n is None:
            return
        if n > 1:
            self._inflight[version] = n - 1
        else:
            del self._inflight[version]

    def inflight(self) -> int:
        """Pinned lookups not yet released (observability for tests)."""
        with self._lock:
            return sum(self._inflight.values())

    def record_lookup(self, look: CacheLookup) -> None:
        """Account one classified lookup into both stats windows."""
        delta = CacheStats(
            lookups=1, hit_rows=look.num_hit,
            miss_rows=look.miss_positions, unique_rows=look.num_unique,
            saved_bytes=look.num_hit * self.row_bytes,
            dedup_saved_bytes=look.dup_miss_rows * self.row_bytes)
        with self._lock:
            self.stats.merge(delta)
            self.epoch_stats.merge(delta)


def build_cache(dataset, fraction: float,
                transfer_dtype: str = "float32") -> Optional[FeatureCache]:
    """Cache of ``fraction`` of the dataset's nodes (None when <= 0)."""
    if fraction <= 0.0:
        return None
    capacity = int(round(dataset.num_nodes * min(fraction, 1.0)))
    if capacity == 0:
        return None
    return FeatureCache(dataset.feature_source, dataset.feature_hotness(),
                        capacity, transfer_dtype=transfer_dtype)
