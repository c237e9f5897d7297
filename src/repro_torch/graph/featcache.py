"""Device-resident hot-feature cache (degree-ordered at boot, refreshed
from observed traffic) + frontier deduplication.

Port of ``repro/graph/featcache.py`` (the replicated ``FeatureCache``).  Two
levers keep rows off the host->device link:

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
``bfloat16``); ``data_on(device)`` places it once per (device, version).

The cache boots static and adapts: with ``track_hotness`` on, every lookup
feeds decayed per-slot / per-uncached-node counters (float32 numpy, the
same ``np.add.at`` calls as the reference, so the counters are bit-equal),
and ``stage()`` / ``commit()`` swap the coldest slots for strictly hotter
observed rows.  ``commit`` scatters the admitted rows into every placed
device block with ``kernels.ops.update_cache_rows`` (K5, or K6 at
``kernel_pipeline_depth`` 2..4 on a card) and bumps ``version``.  Every
``CacheLookup`` records the version it was classified at, and
``data_on(device, version=v)`` serves that version's block: old versions
are rebuilt from an O(swapped rows) undo log, retired once no pinned
lookup can reference them (or past ``keep_versions``).

On a card a new version block is written on the committing thread's
stream; its CUDA event travels with the block and ``data_on`` makes the
caller's current stream wait on it.  Blocks are never written in place:
a commit clones the block first, so a combine still reading an old version
reads the old rows.

``ShardedFeatureCache`` partitions the hot set across the accelerators:
``ShardPlacement`` gives every node one owner shard (SplitMix64 hash or
contiguous hotness ranks), each shard is an ordinary ``FeatureCache`` over
the ids it owns (versions, pins and refresh unchanged), and
``lookup_union`` classifies every trainer's frontier as a local-shard hit,
a peer-shard hit (pulled with ``dist.exchange_peer_rows``) or a fresh host
miss (gathered once for the union of the trainers by
``FeatureLoader.load_union``).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..annotations import guarded_by, requires_lock
from ..dist.collectives import ring_order
from ..kernels.ops import update_cache_rows
from .storage import FeatureSource, as_feature_source

__all__ = ["CacheLookup", "CacheStats", "FeatureCache", "ShardLookup",
           "ShardPlacement", "ShardedFeatureCache", "UnionLookup",
           "build_cache", "build_sharded_cache", "compact_lookup",
           "wire_row_bytes", "to_transfer_dtype"]

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


@dataclasses.dataclass
class _StagedRefresh:
    """A planned-and-gathered refresh awaiting its cheap ``commit()``.

    ``base_version`` pins the slot table the plan was computed against: a
    commit (from any path) bumps the version, so a plan staged against an
    older table is stale and discarded instead of applied."""
    base_version: int
    top: np.ndarray       # admitted candidate ids (may be empty)
    cold: np.ndarray      # victim slot indices, int64, same length
    rows: torch.Tensor    # gathered admitted rows in transfer dtype


# one lock covers the (slot_of, version) pair, the hotness counters, the
# stats windows, the staged plan and the version-retention state (undo log,
# floor, placed device blocks and their ready events, pins).
# Deliberately undeclared: source/capacity/num_nodes/feat_dim/row_bytes/
# transfer_dtype (immutable), track_hotness/keep_versions/
# kernel_pipeline_depth/refresh_* (config knobs, set before any worker
# thread starts).
@guarded_by("_lock", "slot_of", "version", "cached_ids", "stats",
            "epoch_stats", "stage_failures", "refreshes",
            "refresh_swapped_rows", "_staged", "_slot_hot", "_node_hot",
            "_host_rows", "_undo", "_floor", "_device_data", "_devices",
            "_inflight", "_pin_used")
class FeatureCache:
    """Top-K hot-row cache over any ``FeatureSource``: ``capacity`` rows
    chosen by descending ``hotness`` at boot, materialized on the host in
    ``transfer_dtype`` and placed per device on first use; ``refresh()``
    then adapts the resident set to the observed access distribution, with
    versioned device blocks for in-flight consistency."""

    def __init__(self, source: "FeatureSource | np.ndarray",
                 hotness: np.ndarray, capacity: int,
                 transfer_dtype: str = "float32",
                 refresh_decay: float = 0.5,
                 max_refresh_frac: float = 0.25,
                 refresh_hysteresis: float = 1.25):
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
        self._host_rows = to_transfer_dtype(
            self._maintenance_take(self.cached_ids), transfer_dtype)
        self._expected_hit_rate = (float(hotness[self.cached_ids].sum())
                                   / max(float(hotness.sum()), 1e-12))
        self.stats = CacheStats()        # lifetime totals
        self.epoch_stats = CacheStats()  # since the last refresh (feedback)
        self._lock = threading.Lock()
        self.version = 0
        self.keep_versions = 2           # the trainer sizes it to tfp_depth+2
        self.kernel_pipeline_depth = 1   # 2..4: K6, the multi-buffered scatter
        self.refresh_decay = float(refresh_decay)
        self.max_refresh_frac = float(max_refresh_frac)
        # admission hysteresis: a candidate must be hotter than its victim
        # by this factor to swap, so a hub set oscillating at the boundary
        # does not thrash; 1.0 is the plain strictly-hotter policy
        self.refresh_hysteresis = float(refresh_hysteresis)
        self.refreshes = 0               # commits that moved rows
        self.refresh_swapped_rows = 0
        self.fault_injector = None       # optional FaultInjector (hook:
                                         #   "refresh.stage")
        self.stage_failures = 0          # stage() attempts that raised
        self._staged: Optional[_StagedRefresh] = None
        # decayed hotness estimates: frontier positions observed per cached
        # slot / per uncached node.  Opt-in (the trainer turns it on with
        # cache_refresh); the full-length estimate allocates lazily
        self.track_hotness = False
        self._slot_hot = np.zeros(capacity, dtype=np.float32)
        self._node_hot: Optional[np.ndarray] = None
        # version retention: ``_undo[v]`` holds (victim slots, their
        # version-v rows), the delta that rebuilds the version-v host block
        # from version v+1; ``_floor`` is the lowest rebuildable version
        self._undo: Dict[int, Tuple[np.ndarray, torch.Tensor]] = {}
        self._floor = 0
        # (device, version) -> (block, CUDA event its writer recorded or
        # None when it was complete on return)
        self._device_data: Dict[Tuple[str, int],
                                Tuple[torch.Tensor, Optional[Any]]] = {}
        self._devices: Dict[str, torch.device] = {}
        # in-flight lookup pins: version -> count not yet released.  Once
        # any caller pins, drained versions retire eagerly on release;
        # keep_versions stays the hard bound either way
        self._inflight: Dict[int, int] = {}
        self._pin_used = False

    def _maintenance_take(self, rows: np.ndarray) -> np.ndarray:
        """Gather rows as cache maintenance (the boot block, a refresh's
        admitted rows): on a source with stall accounting (``MmapFeatures``)
        they stay out of the cold/warm and prefetch-hit counters, which
        measure the load stage and feed the mapping's re-price."""
        ctx = getattr(self.source, "untracked_gathers", None)
        if ctx is None:
            return self.source.take(rows)
        with ctx():
            return self.source.take(rows)

    # ------------------------------------------------------------- plumbing

    @property
    def nbytes(self) -> int:
        """Device bytes pinned by the hot block (per trainer device)."""
        with self._lock:
            return self._host_rows.numel() * self._host_rows.element_size()

    @property
    def host_rows(self) -> torch.Tensor:
        """The current version's host block (never written in place)."""
        with self._lock:
            return self._host_rows

    @property
    def expected_hit_rate(self) -> float:
        """Design-time hit-rate estimate (hotness mass covered) — feeds the
        performance model's Eq. 7/8 cache term before any measurement."""
        return self._expected_hit_rate

    def measured_hit_rate(self) -> float:
        """Measured positional hit rate over the current epoch window
        (reset by a commit that moved rows; the lifetime rate before any
        lookup landed in it)."""
        with self._lock:
            if self.epoch_stats.total_rows:
                return self.epoch_stats.hit_rate
            return self.stats.hit_rate

    def slot_hotness(self) -> np.ndarray:
        """Decayed per-slot hotness estimate (copy)."""
        with self._lock:
            return self._slot_hot.copy()

    def uncached_hotness(self, ids: np.ndarray) -> np.ndarray:
        """Decayed hotness estimate of (uncached) node ids (copy)."""
        ids = np.asarray(ids, dtype=np.int64)
        with self._lock:
            if self._node_hot is None:
                return np.zeros(ids.shape[0], dtype=np.float32)
            return self._node_hot[ids].copy()

    def data_on(self, device, version: Optional[int] = None) -> torch.Tensor:
        """The [K, F] hot block on ``device`` at ``version`` (default:
        current), placed once per (device, version).  An old version's
        host block is rebuilt by applying the undo log backwards from the
        current one; a version below the retention floor raises.  On a
        card the caller's current stream waits for the commit that wrote
        the block."""
        device = torch.device(device)
        with self._lock:
            ver = self.version if version is None else int(version)
            key = (str(device), ver)
            entry = self._device_data.get(key)
            if entry is None:
                if ver < self._floor or ver > self.version:
                    raise RuntimeError(
                        f"cache version {ver} retired (current "
                        f"{self.version}, keep_versions="
                        f"{self.keep_versions}): a lookup outlived the "
                        f"refresh retention window — raise keep_versions")
                host = self._host_rows
                if ver < self.version:
                    # each undo entry restores the rows its bump evicted
                    host = host.clone()
                    for v in range(self.version - 1, ver - 1, -1):
                        slots, old_rows = self._undo[v]
                        host[torch.from_numpy(slots).long()] = old_rows
                # placed under the lock so two trainer threads never ship
                # the same [K, F] block twice; once per (device, version).
                # A pageable host->device copy is complete on return
                entry = (host.to(device), None)  # noqa: RPT103 - memoized once per (device, version)
                self._device_data[key] = entry
                self._devices[str(device)] = device
        block, ready = entry
        if ready is not None:
            torch.cuda.current_stream(device).wait_event(ready)
        return block

    # --------------------------------------------------------------- lookup

    def lookup(self, ids: np.ndarray, dedup: bool = True,
               record: bool = True, pin: bool = False) -> CacheLookup:
        """Partition one frontier into cached slots and miss rows.

        ``dedup=True`` classifies only the frontier's unique ids and
        compacts the miss block to one row per unique miss; ``dedup=False``
        keeps one miss row per frontier position.  Stats count positions.
        The (slot table, version) pair is snapshotted atomically, and the
        lookup records the version it was classified at.  ``record=False``
        defers accounting to ``record_lookup`` (the loader records only
        once its gather succeeded).  ``pin=True`` registers the version as
        in flight, atomically with the snapshot, until ``release_lookup``.
        """
        slot_of, ver = self.snapshot(pin=1 if pin else 0)
        if dedup:
            look = compact_lookup(ids, slot_of)
        else:
            look = positional_lookup(ids, slot_of)
        look.version = ver
        if record:
            self.record_lookup(look)
        return look

    def snapshot(self, pin: int = 0) -> Tuple[np.ndarray, int]:
        """Atomically snapshot the (slot table, version) pair; ``pin``
        registers that many in-flight references at that version (each
        owing one ``release_version``).  A commit swaps the table
        reference and never writes the array, so the table is immutable."""
        with self._lock:
            if pin:
                self._pin_used = True
                self._inflight[self.version] = \
                    self._inflight.get(self.version, 0) + int(pin)
            return self.slot_of, self.version

    def release_lookup(self, look: CacheLookup) -> None:
        """Release one ``lookup(pin=True)`` registration (a no-op for an
        unpinned lookup).  When the last pin at a version drops, every
        retained block and undo entry below the oldest pinned version
        retires at once."""
        self.release_version(int(look.version))

    def release_version(self, version: int) -> None:
        """Release one pinned reference at ``version``."""
        with self._lock:
            ver = int(version)
            n = self._inflight.get(ver)
            if n is None:
                return
            if n > 1:
                self._inflight[ver] = n - 1
            else:
                del self._inflight[ver]
            self._retire_below_floor()

    @requires_lock("_lock")
    def _retire_below_floor(self) -> None:
        # without any pin the keep_versions window in commit() is the only
        # retirement
        if not self._pin_used:
            return
        floor = min(self._inflight) if self._inflight else self.version
        floor = min(floor, self.version)   # never retire the current block
        if floor > self._floor:
            self._floor = floor
        for key in [k for k in self._device_data if k[1] < self._floor]:
            del self._device_data[key]
        for v in [v for v in self._undo if v < self._floor]:
            del self._undo[v]

    def inflight(self) -> int:
        """Pinned lookups not yet released."""
        with self._lock:
            return sum(self._inflight.values())

    def retained_versions(self) -> List[int]:
        """Sorted cache versions still rebuildable (current included)."""
        with self._lock:
            return list(range(self._floor, self.version + 1))

    def retained_bytes(self) -> int:
        """Host bytes held by the undo log: O(swapped rows per retained
        version); the live current block is excluded."""
        with self._lock:
            return sum(slots.nbytes + rows.numel() * rows.element_size()
                       for slots, rows in self._undo.values())

    def record_lookup(self, look: CacheLookup) -> None:
        """Account one classified lookup: both stats windows and, with
        ``track_hotness``, the hotness counters (one count per frontier
        position), atomically under the cache lock.  A lookup classified
        at an older version lands its counts on the current tables, as in
        the reference."""
        delta = CacheStats(
            lookups=1, hit_rows=look.num_hit,
            miss_rows=look.miss_positions, unique_rows=look.num_unique,
            saved_bytes=look.num_hit * self.row_bytes,
            dedup_saved_bytes=look.dup_miss_rows * self.row_bytes)
        hit = look.slots >= 0
        with self._lock:
            self.stats.merge(delta)
            self.epoch_stats.merge(delta)
            if self.track_hotness:
                if self._node_hot is None:
                    self._node_hot = np.zeros(self.num_nodes,
                                              dtype=np.float32)
                if self.capacity:
                    np.add.at(self._slot_hot, look.slots[hit],
                              np.float32(1.0))
                np.add.at(self._node_hot, look.ids[~hit], np.float32(1.0))

    def record_access(self, hit_slots: np.ndarray, hit_counts: np.ndarray,
                      miss_ids: np.ndarray, miss_counts: np.ndarray,
                      lookups: int = 1) -> None:
        """Account a pre-aggregated, position-weighted access pattern: the
        sharded plane records each shard's share of a union lookup in one
        call.  ``hit_slots`` / ``miss_ids`` are unique entries and
        ``*_counts`` the frontier positions that referenced each, the same
        quantities ``record_lookup`` derives from a ``CacheLookup``."""
        hit_rows = int(hit_counts.sum()) if hit_counts.size else 0
        miss_rows = int(miss_counts.sum()) if miss_counts.size else 0
        delta = CacheStats(
            lookups=int(lookups), hit_rows=hit_rows, miss_rows=miss_rows,
            unique_rows=int(hit_slots.shape[0] + miss_ids.shape[0]),
            saved_bytes=hit_rows * self.row_bytes)
        with self._lock:
            self.stats.merge(delta)
            self.epoch_stats.merge(delta)
            if self.track_hotness:
                if self._node_hot is None:
                    self._node_hot = np.zeros(self.num_nodes,
                                              dtype=np.float32)
                if self.capacity and hit_slots.size:
                    np.add.at(self._slot_hot, hit_slots,
                              hit_counts.astype(np.float32))
                if miss_ids.size:
                    np.add.at(self._node_hot, miss_ids,
                              miss_counts.astype(np.float32))

    def stats_snapshot(self) -> Tuple[CacheStats, CacheStats]:
        """(lifetime, epoch-window) stats copies, taken atomically."""
        with self._lock:
            return (dataclasses.replace(self.stats),
                    dataclasses.replace(self.epoch_stats))

    # -------------------------------------------------------------- refresh

    @property
    def staged_ready(self) -> bool:
        """True when a staged refresh awaits its ``commit()``."""
        with self._lock:
            return self._staged is not None

    @property
    def staged_swaps(self) -> int:
        """Swap count of the currently staged plan (0 when none)."""
        with self._lock:
            return 0 if self._staged is None else \
                int(self._staged.top.shape[0])

    def stage(self, max_swap: Optional[int] = None) -> int:
        """Plan the next refresh and gather its admitted rows, the
        expensive half.

        Under the lock: the hottest observed uncached candidates pair
        hottest-first against the coldest-first slots, and a pair swaps
        only while the candidate is hotter than ``refresh_hysteresis`` x
        its victim (a monotone predicate, so the swap set is a prefix); at
        most ``max_swap`` rows (default ``max_refresh_frac`` of capacity).
        The admitted-row gather then runs with the lock released, so it
        can run in a background thread while lookups proceed.  The plan is
        pinned to the version it was computed against and dropped if a
        commit lands first.  A gather that raises, or an injected
        ``refresh.stage`` fault, counts in ``stage_failures`` and leaves no
        plan: the cache keeps serving its version and the trainer retries
        at the next drift boundary.  Returns the planned swap count."""
        if self.fault_injector is not None:
            try:
                self.fault_injector.fire("refresh.stage")
            except BaseException:
                # counted under the lock: health() reads it from the main
                # thread while an async stage runs in the background
                with self._lock:
                    self.stage_failures += 1
                raise
        with self._lock:
            if self.capacity == 0:
                return 0
            cap = self.capacity
            k_max = max(1, int(round(cap * self.max_refresh_frac)))
            if max_swap is not None:
                k_max = int(max_swap)
            k_max = max(0, min(k_max, cap))
            # candidates: observed-miss ids that are (still) uncached
            if self._node_hot is None:       # no tracked traffic yet
                cand = np.zeros(0, dtype=np.int64)
            else:
                cand = np.flatnonzero(self._node_hot > 0.0).astype(np.int64)
                cand = cand[self.slot_of[cand] < 0]
            top = cold = np.zeros(0, dtype=np.int64)
            n_swap = 0
            if k_max and cand.shape[0]:
                k = min(k_max, cand.shape[0])
                top = cand[np.argpartition(-self._node_hot[cand], k - 1)[:k]]
                # hottest first, ties broken by id for determinism
                top = top[np.lexsort((top, -self._node_hot[top]))]
                # coldest slots first, ties broken by cached id
                cold = np.lexsort((self.cached_ids, self._slot_hot)
                                  )[:k].astype(np.int64)
                n_swap = int(np.count_nonzero(
                    self._node_hot[top] > np.float32(self.refresh_hysteresis)
                    * self._slot_hot[cold]))
            top, cold = top[:n_swap], cold[:n_swap]
            base = self.version
            host_dtype = self._host_rows.dtype
        if n_swap:
            try:
                rows = to_transfer_dtype(self._maintenance_take(top),
                                         self.transfer_dtype)
            except Exception:
                with self._lock:
                    self.stage_failures += 1
                raise
        else:
            rows = torch.zeros((0, self.feat_dim), dtype=host_dtype)
        with self._lock:
            if self.version != base:
                # a commit landed while we gathered: the plan was computed
                # against a retired table
                self._staged = None
                return 0
            self._staged = _StagedRefresh(base, top, cold, rows)
            return n_swap

    def discard_staged(self) -> int:
        """Drop a staged-but-uncommitted plan; the cache keeps serving the
        current version.  Returns the swaps discarded."""
        with self._lock:
            plan, self._staged = self._staged, None
            return 0 if plan is None else int(plan.top.shape[0])

    def commit(self) -> int:
        """Apply the staged refresh, the cheap half: table swaps and device
        row scatters, no source access.

        Each pair is re-validated against the commit-time counters (a
        victim that heated up while the gather ran is spared).  When rows
        move: a new host block is built copy-on-write (in-flight CPU
        combines keep reading the old one), the evicted rows go to the
        undo log, every placed current-version device block is cloned and
        scatter-updated (``kernels.ops.update_cache_rows``) into the new
        version's block, ``version`` is bumped, versions past
        ``keep_versions`` or below the oldest pin retire, and the epoch
        stats window resets.  Every commit of a live plan is a hotness
        window boundary (the counters decay); a stale or absent plan
        returns 0 and changes nothing.  Returns the rows swapped."""
        with self._lock:
            plan, self._staged = self._staged, None
            if plan is None or plan.base_version != self.version:
                return 0
            top, cold, rows = plan.top, plan.cold, plan.rows
            n_swap = int(top.shape[0])
            if n_swap:
                keep = (self._node_hot[top]
                        > np.float32(self.refresh_hysteresis)
                        * self._slot_hot[cold])
                top, cold = top[keep], cold[keep]
                rows = rows[torch.from_numpy(keep)]
                n_swap = int(top.shape[0])
            if n_swap:
                evicted = self.cached_ids[cold].copy()
                new_slot_of = self.slot_of.copy()
                new_slot_of[evicted] = -1
                new_slot_of[top] = cold.astype(np.int32)
                new_cached = self.cached_ids.copy()
                new_cached[cold] = top
                cold_t = torch.from_numpy(cold)
                new_host = self._host_rows.clone()
                new_host[cold_t] = rows
                slots32 = cold.astype(np.int32)
                self._undo[self.version] = (slots32,
                                            self._host_rows[cold_t])
                # estimates travel with their nodes
                admit_est = self._node_hot[top].copy()
                self._node_hot[evicted] = self._slot_hot[cold]
                self._slot_hot[cold] = admit_est
                self._node_hot[top] = 0.0
                new_ver = self.version + 1
                # device scatters under the lock: they must be atomic with
                # the table/version swap, or a lookup could pair the new
                # table with an un-updated block
                for dev_key, dev in self._devices.items():
                    entry = self._device_data.get((dev_key, self.version))
                    if entry is not None:
                        self._device_data[(dev_key, new_ver)] = \
                            self._scatter_block(entry, rows, slots32, dev)
                self.slot_of = new_slot_of
                self.cached_ids = new_cached
                self._host_rows = new_host
                self.version = new_ver
                # retire versions no in-flight lookup can still reference
                low = new_ver - max(int(self.keep_versions), 1) + 1
                if low > self._floor:
                    self._floor = low
                for key in [key for key in self._device_data
                            if key[1] < self._floor]:
                    del self._device_data[key]
                for v in [v for v in self._undo if v < self._floor]:
                    del self._undo[v]
                # pins leaked past the window (a batch that never reached
                # its release) can no longer be served: age them out so
                # one leak does not disable eager retirement for good
                for v in [v for v in self._inflight if v < low]:
                    del self._inflight[v]
                self._retire_below_floor()
                self.epoch_stats = CacheStats()
                self.refreshes += 1
                self.refresh_swapped_rows += n_swap
            # window boundary: old hotness fades relative to the next epoch
            self._slot_hot *= np.float32(self.refresh_decay)
            if self._node_hot is not None:
                self._node_hot *= np.float32(self.refresh_decay)
            return n_swap

    @requires_lock("_lock")
    def _scatter_block(self, entry, rows: torch.Tensor, slots: np.ndarray,
                       dev: torch.device):
        """The next version of one placed block: a clone of ``entry``'s
        block with ``rows`` scattered to ``slots``, on the calling thread's
        current stream.  On a card the old block is marked as used by that
        stream (the allocator must not hand its memory out while the clone
        still reads it) and an event marks when the new one is written."""
        cur, ready = entry
        if dev.type != "cuda":
            return (update_cache_rows(cur, rows, slots,
                                      self.kernel_pipeline_depth), None)
        stream = torch.cuda.current_stream(dev)
        if ready is not None:
            stream.wait_event(ready)
        block = update_cache_rows(cur, rows.to(dev), slots,  # noqa: RPT103 - atomic O(swap) commit by design
                                  self.kernel_pipeline_depth)
        cur.record_stream(stream)
        done = torch.cuda.Event()
        done.record(stream)
        return block, done

    def refresh(self, max_swap: Optional[int] = None) -> int:
        """One-shot refresh: ``stage()`` + ``commit()`` back to back (one
        counter decay per call).  Returns the rows swapped."""
        self.stage(max_swap)
        return self.commit()


def build_cache(dataset, fraction: float,
                transfer_dtype: str = "float32",
                refresh_decay: float = 0.5,
                max_refresh_frac: float = 0.25,
                refresh_hysteresis: float = 1.25) -> Optional[FeatureCache]:
    """Cache of ``fraction`` of the dataset's nodes (None when <= 0)."""
    if fraction <= 0.0:
        return None
    capacity = int(round(dataset.num_nodes * min(fraction, 1.0)))
    if capacity == 0:
        return None
    return FeatureCache(dataset.feature_source, dataset.feature_hotness(),
                        capacity, transfer_dtype=transfer_dtype,
                        refresh_decay=refresh_decay,
                        max_refresh_frac=max_refresh_frac,
                        refresh_hysteresis=refresh_hysteresis)


# ---------------------------------------------------------------------------
# Sharded hot-feature plane: disjoint per-accelerator shards and the union
# classification (port of repro/graph/featcache.py:890-1316).


def _mix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer: a deterministic avalanching id hash, so hash
    placement spreads hub nodes uniformly across shards."""
    z = x.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


class ShardPlacement:
    """Disjoint, exhaustive node id -> shard ownership.

    ``hash``: SplitMix64-mixed id modulo ``n_shards`` (hubs spread
    uniformly; the default).  ``degree``: contiguous hotness-rank ranges,
    shard 0 owning the hottest ceil(N/n) nodes.  Both are pure functions of
    (num_nodes, n_shards, policy, hotness), so every shard and trainer
    derives the same owner table."""

    POLICIES = ("hash", "degree")

    def __init__(self, num_nodes: int, n_shards: int,
                 policy: str = "hash",
                 hotness: Optional[np.ndarray] = None):
        if policy not in self.POLICIES:
            raise ValueError(f"unknown shard placement {policy!r} "
                             f"(choose from {self.POLICIES})")
        self.num_nodes = int(num_nodes)
        self.n_shards = int(max(1, n_shards))
        self.policy = policy
        if policy == "hash":
            ids = np.arange(self.num_nodes, dtype=np.uint64)
            owner = (_mix64(ids) % np.uint64(self.n_shards)).astype(np.int32)
        else:
            if hotness is None:
                raise ValueError("degree placement needs a hotness vector")
            hotness = np.asarray(hotness, dtype=np.float64)
            # stable order: equal-hotness ties deterministic across runs
            rank = np.argsort(-hotness, kind="stable")
            span = max(1, -(-self.num_nodes // self.n_shards))
            owner = np.empty(self.num_nodes, dtype=np.int32)
            owner[rank] = (np.arange(self.num_nodes) // span
                           ).astype(np.int32)
        self.owner = owner

    def owner_of(self, ids: np.ndarray) -> np.ndarray:
        """Owning shard ordinal per id (int32)."""
        return self.owner[np.asarray(ids, dtype=np.int64)]


@dataclasses.dataclass
class ShardLookup:
    """One trainer's frontier classified against the sharded plane.

    ``look`` is a ``CacheLookup`` against the trainer's LOCAL shard:
    ``slots`` index the local block (-1 otherwise), ``miss_index`` points
    into the combined transfer source ``[peer rows (ring order) | fresh host
    rows]`` and ``miss_ids`` holds only the fresh ids the host gathers.
    ``peer_requests`` name the rows to pull from each peer shard, at that
    shard's classification version."""
    look: CacheLookup
    shard: int                    # the trainer's own shard ordinal
    peer_requests: List[Tuple[int, np.ndarray, int]]
    pinned: List[Tuple[int, int]]  # (shard, version) pins to release
    peer_rows: int = 0            # unique rows pulled from peer shards
    peer_positions: int = 0       # frontier positions served by peers
    local_positions: int = 0      # frontier positions served locally


@dataclasses.dataclass
class UnionLookup:
    """All trainers' classifications for one batch, plus the per-shard
    accounting deferred until the union gather succeeded (as
    ``lookup(record=False)`` defers a replicated lookup's)."""
    per_trainer: Dict[str, ShardLookup]
    record_payload: List[tuple]


# the lock covers only the memoized merged slot table; the shards guard
# their own state, and placement / row_bytes / shards are immutable after
# construction
@guarded_by("_lock", "_merged_key", "_merged_table")
class ShardedFeatureCache:
    """Partitioned hot-feature plane: ``n_shards`` disjoint per-device
    ``FeatureCache`` shards over one source, n times the rows at the same
    per-device budget.

    A frontier position resolves in priority order: local shard hit (on the
    trainer's device), peer shard hit (one row hop via
    ``dist.exchange_peer_rows``), host miss (gathered once for the union of
    all trainers' fresh sets by ``FeatureLoader.load_union``).  Each shard
    keeps its own version and pin protocol; a union lookup snapshots every
    shard once and pins one reference per trainer, so a refresh of any
    shard mid-pipeline is invisible as in the replicated cache."""

    def __init__(self, source: "FeatureSource | np.ndarray",
                 hotness: np.ndarray, capacity_per_shard: int,
                 n_shards: int, placement: str = "hash",
                 transfer_dtype: str = "float32", **refresh_kw):
        source = as_feature_source(source)
        num_nodes, feat_dim = source.shape
        hotness = np.asarray(hotness, dtype=np.float64)
        if hotness.shape[0] != num_nodes:
            raise ValueError("hotness must have one entry per node")
        self.num_nodes = int(num_nodes)
        self.feat_dim = int(feat_dim)
        self.n_shards = int(max(1, n_shards))
        self.transfer_dtype = transfer_dtype
        self.row_bytes = wire_row_bytes(feat_dim, transfer_dtype)
        self.placement = ShardPlacement(num_nodes, self.n_shards,
                                        placement, hotness)
        hmin = float(hotness.min()) if num_nodes else 0.0
        self.shards: List[FeatureCache] = []
        for d in range(self.n_shards):
            owned = self.placement.owner == d
            # owned hotness shifted strictly positive and the rest zeroed:
            # the shard's top-K pick never takes an id it does not own
            h_d = np.where(owned, hotness - hmin + 1.0, 0.0)
            cap_d = int(min(int(capacity_per_shard), int(owned.sum())))
            self.shards.append(
                FeatureCache(source, h_d, cap_d,
                             transfer_dtype=transfer_dtype, **refresh_kw))
        mass = sum(float(hotness[s.cached_ids].sum()) for s in self.shards)
        self._expected_hit_rate = mass / max(float(hotness.sum()), 1e-12)
        self._lock = threading.Lock()
        self._merged_key: Optional[tuple] = None
        self._merged_table: Optional[np.ndarray] = None

    # ------------------------------------------------------------ plumbing

    @property
    def capacity(self) -> int:
        """Resident rows across the shards."""
        return sum(s.capacity for s in self.shards)

    @property
    def nbytes(self) -> int:
        """Device bytes pinned across ALL shards (one shard per device: the
        per-device budget is one shard's block)."""
        return sum(s.nbytes for s in self.shards)

    @property
    def expected_hit_rate(self) -> float:
        """Hotness mass covered by the union of the shards: the design-time
        (local + peer) hit estimate for Eq. 7/8."""
        return self._expected_hit_rate

    @property
    def version(self) -> int:
        """Sum of the shard versions: moves whenever any shard commits."""
        return sum(s.snapshot()[1] for s in self.shards)

    @property
    def slot_of(self) -> np.ndarray:
        """Merged id -> slot table (the slot in the OWNER shard's block;
        >= 0 means resident somewhere in the plane), memoized per vector
        of shard versions."""
        snaps = [s.snapshot() for s in self.shards]
        key = tuple(v for _, v in snaps)
        with self._lock:
            if key == self._merged_key and self._merged_table is not None:
                return self._merged_table
        merged = np.full(self.num_nodes, -1, dtype=np.int32)
        for table, _ in snaps:
            resident = table >= 0
            # shards own disjoint id sets: the scatters cannot collide
            merged[resident] = table[resident]
        with self._lock:
            self._merged_key, self._merged_table = key, merged
            return self._merged_table

    # knobs forwarded to every shard

    @property
    def keep_versions(self) -> int:
        return self.shards[0].keep_versions

    @keep_versions.setter
    def keep_versions(self, value: int) -> None:
        for s in self.shards:
            s.keep_versions = value

    @property
    def track_hotness(self) -> bool:
        return self.shards[0].track_hotness

    @track_hotness.setter
    def track_hotness(self, value: bool) -> None:
        for s in self.shards:
            s.track_hotness = value

    @property
    def kernel_pipeline_depth(self) -> int:
        return self.shards[0].kernel_pipeline_depth

    @kernel_pipeline_depth.setter
    def kernel_pipeline_depth(self, value: int) -> None:
        for s in self.shards:
            s.kernel_pipeline_depth = value

    @property
    def fault_injector(self):
        return self.shards[0].fault_injector

    @fault_injector.setter
    def fault_injector(self, value) -> None:
        for s in self.shards:
            s.fault_injector = value

    # aggregated observability

    @property
    def stage_failures(self) -> int:
        return sum(s.stage_failures for s in self.shards)

    @property
    def refreshes(self) -> int:
        return sum(s.refreshes for s in self.shards)

    @property
    def refresh_swapped_rows(self) -> int:
        return sum(s.refresh_swapped_rows for s in self.shards)

    @property
    def staged_ready(self) -> bool:
        return any(s.staged_ready for s in self.shards)

    def measured_hit_rate(self) -> float:
        """Positional (local + peer) hit rate over the shards' current
        epoch windows, or their lifetime totals before any window filled."""
        epoch_hit = epoch_tot = life_hit = life_tot = 0
        for s in self.shards:
            life, epoch = s.stats_snapshot()
            epoch_hit += epoch.hit_rows
            epoch_tot += epoch.total_rows
            life_hit += life.hit_rows
            life_tot += life.total_rows
        if epoch_tot:
            return epoch_hit / epoch_tot
        return life_hit / max(life_tot, 1)

    def retained_versions(self) -> Dict[int, List[int]]:
        """Per-shard retained versions."""
        return {d: s.retained_versions() for d, s in enumerate(self.shards)}

    def retained_bytes(self) -> int:
        """Undo-log bytes summed across the shards."""
        return sum(s.retained_bytes() for s in self.shards)

    # -------------------------------------------------------- union lookup

    def lookup_union(self, frontiers: Dict[str, np.ndarray],
                     ordinals: Dict[str, int], pin: bool = False,
                     record: bool = True) -> UnionLookup:
        """Classify every trainer's frontier against the plane in one pass:
        local-shard hits, peer-shard hits (grouped per owner in ring order
        from the trainer's ordinal) and fresh host misses.

        Every shard is snapshotted once and, with ``pin=True``, pinned once
        per trainer; the trainer releases a batch's pins with
        ``release_union`` after its combine.  With ``record=False`` the
        per-shard accounting travels in the payload and ``record_union``
        applies it later (the loader records after its gather)."""
        npin = len(frontiers) if pin else 0
        snaps = [s.snapshot(pin=npin) for s in self.shards]
        tables = [t for t, _ in snaps]
        vers = [v for _, v in snaps]
        owner_all = self.placement.owner
        acc: List[Dict[str, Any]] = [
            {"hs": [], "hc": [], "mi": [], "mc": [], "lk": 0}
            for _ in range(self.n_shards)]
        per: Dict[str, ShardLookup] = {}
        for name in sorted(frontiers):
            me = int(ordinals[name])
            ids = np.asarray(frontiers[name], dtype=np.int64)
            uniq, inverse = np.unique(ids, return_inverse=True)
            inverse = inverse.astype(np.int32)
            counts = np.bincount(inverse, minlength=uniq.shape[0])
            owner = owner_all[uniq]
            uslots = np.full(uniq.shape[0], -1, dtype=np.int32)
            for d in range(self.n_shards):
                sel = owner == d
                if sel.any():
                    uslots[sel] = tables[d][uniq[sel]]
            hit = uslots >= 0
            # combined transfer-source row per unique: peer rows first
            # (ring order from me, each group in id order), then the fresh
            # host rows; the transfer stage concatenates in the same order
            u_midx = np.zeros(uniq.shape[0], dtype=np.int32)
            base = 0
            peer_requests: List[Tuple[int, np.ndarray, int]] = []
            peer_rows = peer_pos = 0
            for p in ring_order(self.n_shards, me):
                sel = hit & (owner == p)
                k = int(np.count_nonzero(sel))
                if k:
                    u_midx[sel] = base + np.arange(k, dtype=np.int32)
                    peer_requests.append(
                        (p, uslots[sel].astype(np.int32), vers[p]))
                    peer_rows += k
                    peer_pos += int(counts[sel].sum())
                    base += k
            fresh = ~hit
            n_fresh = int(np.count_nonzero(fresh))
            if n_fresh:
                u_midx[fresh] = base + np.arange(n_fresh, dtype=np.int32)
            local_sel = hit & (owner == me)
            slots_u = np.where(local_sel, uslots,
                               np.int32(-1)).astype(np.int32)
            look = CacheLookup(
                ids=ids, slots=slots_u[inverse],
                miss_index=u_midx[inverse], miss_ids=uniq[fresh],
                unique_ids=uniq, inverse=inverse, version=vers[me])
            per[name] = ShardLookup(
                look=look, shard=me, peer_requests=peer_requests,
                pinned=([(d, vers[d]) for d in range(self.n_shards)]
                        if pin else []),
                peer_rows=peer_rows, peer_positions=peer_pos,
                local_positions=int(counts[local_sel].sum()))
            # hotness and stats land on the OWNER shard (position-weighted),
            # so refresh admission only considers owned ids and the shards
            # stay disjoint through every refresh
            for d in range(self.n_shards):
                seld = owner == d
                h = seld & hit
                m = seld & fresh
                a = acc[d]
                a["lk"] += 1
                if h.any():
                    a["hs"].append(uslots[h])
                    a["hc"].append(counts[h])
                if m.any():
                    a["mi"].append(uniq[m])
                    a["mc"].append(counts[m])
        payload = []
        for d, a in enumerate(acc):
            payload.append((
                d,
                np.concatenate(a["hs"]) if a["hs"] else
                np.zeros(0, dtype=np.int32),
                np.concatenate(a["hc"]) if a["hc"] else
                np.zeros(0, dtype=np.int64),
                np.concatenate(a["mi"]) if a["mi"] else
                np.zeros(0, dtype=np.int64),
                np.concatenate(a["mc"]) if a["mc"] else
                np.zeros(0, dtype=np.int64),
                a["lk"]))
        union = UnionLookup(per_trainer=per, record_payload=payload)
        if record:
            self.record_union(union)
        return union

    def record_union(self, union: UnionLookup) -> None:
        """Apply a deferred union lookup's per-shard accounting."""
        for d, hs, hc, mi, mc, lk in union.record_payload:
            self.shards[d].record_access(hs, hc, mi, mc, lookups=lk)
        union.record_payload = []

    def release_union(self, shard_look: ShardLookup) -> None:
        """Release one trainer's per-shard pins of one batch."""
        for d, ver in shard_look.pinned:
            self.shards[d].release_version(ver)
        shard_look.pinned = []

    # ------------------------------------------------------------- refresh
    # shard by shard: each stages (plans and gathers) and commits its own
    # owned rows, so disjointness holds and each keeps its own versions

    def stage(self, max_swap: Optional[int] = None) -> int:
        return sum(s.stage(max_swap) for s in self.shards)

    def commit(self) -> int:
        return sum(s.commit() for s in self.shards)

    def discard_staged(self) -> int:
        return sum(s.discard_staged() for s in self.shards)

    def refresh(self, max_swap: Optional[int] = None) -> int:
        self.stage(max_swap)
        return self.commit()


def build_sharded_cache(dataset, fraction: float, n_shards: int,
                        placement: str = "hash",
                        transfer_dtype: str = "float32",
                        refresh_decay: float = 0.5,
                        max_refresh_frac: float = 0.25,
                        refresh_hysteresis: float = 1.25
                        ) -> Optional[ShardedFeatureCache]:
    """Sharded plane at the per-device budget of ``build_cache``:
    ``fraction`` of the nodes per shard, so n shards hold up to n times the
    replicated rows (None when the budget rounds to 0)."""
    if fraction <= 0.0 or n_shards < 1:
        return None
    capacity = int(round(dataset.num_nodes * min(fraction, 1.0)))
    if capacity == 0:
        return None
    return ShardedFeatureCache(
        dataset.feature_source, dataset.feature_hotness(), capacity,
        n_shards, placement=placement, transfer_dtype=transfer_dtype,
        refresh_decay=refresh_decay, max_refresh_frac=max_refresh_frac,
        refresh_hysteresis=refresh_hysteresis)
