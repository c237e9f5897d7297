"""Feature Loader (paper Section III-A) — cache- and dedup-aware host gather.

Port of ``repro/graph/featload.py`` (the ``load``, ``load_compact`` and
``load_union`` paths and the recent-rows LRU).  Runs on the host: given a
sampled ``MiniBatch`` it gathers feature rows from the dataset's
``FeatureSource`` for the Data Transfer stage.

  * ``load``         — the full positional frontier (the CPU trainer reads
    it in place from host memory; dedup-off, cache-off accelerators ship
    it whole),
  * ``load_compact`` — the deduped transfer path: the frontier's unique ids
    are classified against the optional device cache and only *unique miss*
    rows are gathered and shipped; the on-device combine expands them.
  * ``load_union``   — the sharded-plane load: every accelerator trainer's
    frontier is classified against the ``ShardedFeatureCache`` in one union
    lookup, the union of their fresh-miss sets is gathered once, and each
    trainer's block gets only its slice (the multicast).  The accounting
    models the physical route of a node with one card per trainer: a union
    row crosses PCIe once (``bytes``), its extra copies and the peer-shard
    row hops ride the accelerator interconnect (``ici_bytes``).
  * the recent-rows LRU (``recent_batches`` > 0 and a ``recent_key``) —
    cross-iteration device-side dedup: ``load_compact`` remembers the unique
    ids shipped to each consumer over its last few batches, does not gather
    or ship again the rows still resident on its device (the transfer stage
    re-reads them there), and drops that history whenever the cache version
    moves.

Rows come back as torch tensors in the transfer dtype (``float32`` or
``bfloat16``).  ``stats.bytes`` counts only bytes shipped host->device;
every avoided ship lands in exactly one counter (``saved_bytes`` local
cache hits, ``peer_saved_bytes`` peer-shard hits, ``dedup_saved_bytes``
in-batch duplicates, ``union_saved_bytes`` rows shared between trainers of
a union gather, ``recent_saved_bytes`` rows still resident from a recent
batch), so shipped + saved bytes always rebuild the one-row-per-position
baseline (plus bucket padding, tracked in ``padding_bytes``) — the same
accounting as the reference.

On a disk-tier source (``MmapFeatures``) every load also records
``stall_seconds``: the gather threads' seconds on cold pages (the source's
``cold_gather_seconds`` delta around the gather), the share of the load the
window prefetcher did not hide.  When the source is partitioned (anything
with ``partition_rows``), the chunked gather cuts the request only at
partition boundaries, so each pool thread faults its own windows, and
scatters the rows back into request order.

A batch sampled on the device carries its frontier as a device tensor: the
trainer brings it to the host once, in the sample stage, and hands it to
``load`` / ``load_compact`` / ``load_union`` (``frontier=`` /
``frontiers=``), so the loader syncs with the device no second time.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..annotations import guarded_by
from .featcache import (CacheLookup, FeatureCache, ShardedFeatureCache,
                        ShardLookup, compact_lookup, to_transfer_dtype,
                        wire_row_bytes)
from .sampler import MiniBatch
from .storage import GraphDataset

__all__ = ["FeatureLoader", "LoadStats", "MissBlock", "ShardMissBlock"]


@dataclasses.dataclass
class LoadStats:
    rows: int = 0            # rows shipped (gathered uniques + any padding)
    bytes: int = 0           # bytes shipped host->device
    seconds: float = 0.0
    total_rows: int = 0      # frontier positions requested (hits + misses)
    unique_rows: int = 0     # unique ids among the requested positions
    hit_rows: int = 0        # positions served from the device cache
    saved_bytes: int = 0     # transfer bytes avoided by LOCAL cache hits
    dedup_saved_bytes: int = 0  # transfer bytes avoided by deduplication
    padding_bytes: int = 0   # share of `bytes` that is shape-bucket padding
    peer_rows: int = 0       # unique rows pulled from peer shards
    peer_saved_bytes: int = 0   # transfer bytes avoided by peer-shard hits
    union_saved_bytes: int = 0  # transfer bytes avoided by the cross-trainer
                             #   union gather (each shared row ships once)
    ici_bytes: int = 0       # bytes on the accelerator interconnect of a
                             #   node with one card per trainer (peer row
                             #   hops + multicast fan-out copies): a model
    recent_rows: int = 0     # unique rows skipped: still device-resident
                             #   from a recent batch (cross-iteration LRU)
    recent_saved_bytes: int = 0  # transfer bytes those skips avoided
    stall_seconds: float = 0.0  # gather-thread seconds spent faulting cold
                             #   storage pages (disk-tier gathers the window
                             #   prefetcher did not pre-warm), summed over
                             #   the chunked gather's pool threads, so it can
                             #   exceed the wall-clock `seconds`; 0 on
                             #   RAM-resident sources

    @property
    def hit_rate(self) -> float:
        return self.hit_rows / max(self.total_rows, 1)

    @property
    def dup_factor(self) -> float:
        """Measured duplication factor (positions per unique id, >= 1)."""
        return self.total_rows / max(self.unique_rows, 1)

    def merge(self, other: "LoadStats") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))


@dataclasses.dataclass
class _ShippedBlock:
    """Recent-rows LRU entry: the unique ids one batch freshly shipped to a
    consumer device and, once its transfer stage ran, the device tensor
    holding them.  ``array`` is written once by that transfer stage and read
    only by later batches' transfer stages, which run in batch order, so a
    batch that matched this entry at load time finds it filled."""
    ids: np.ndarray          # sorted unique ids of the shipped fresh rows
    version: int             # cache version the ship was classified at
    array: Optional[torch.Tensor] = None  # [>= len(ids), F] device rows


@dataclasses.dataclass
class MissBlock:
    """Host-side output of a compact load: ``rows`` is the [M, F] unique-miss
    block and ``lookup`` the positional tables the on-device combine reads
    (many positions may point at one row of ``rows``).

    With the recent-rows LRU, ``miss_index`` addresses the combined source
    ``[recent segments... | fresh rows]``: ``recent`` lists (entry, row
    indices) pairs to re-read from earlier batches' device tensors, and
    ``shipped`` is this batch's own entry, whose ``array`` the transfer
    stage fills."""
    rows: torch.Tensor
    lookup: CacheLookup
    recent: List[Tuple[_ShippedBlock, np.ndarray]] = \
        dataclasses.field(default_factory=list)
    shipped: Optional[_ShippedBlock] = None

    @property
    def num_rows(self) -> int:
        return self.lookup.num_rows


@dataclasses.dataclass
class ShardMissBlock(MissBlock):
    """One trainer's block of a sharded-plane ``load_union``: ``rows`` holds
    only its slice of the union gather (its fresh host misses), ``lookup``
    indexes the local shard block and the combined ``[peer rows | fresh
    rows]`` source, and ``shard`` carries the peer requests and per-shard
    version pins the transfer stage resolves."""
    shard: Optional[ShardLookup] = None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# the load and transfer pipeline stages run in different threads and both
# account into the same stats windows; every merge runs under _stats_lock.
# The recent-rows history is touched by the load stage and by drop_recent
# (from other threads), under _recent_lock; an entry's ``array`` is outside
# it (one writer, the transfer stage, in batch order).
@guarded_by("_stats_lock", "stats", "window", "host_stats")
@guarded_by("_recent_lock", "_recent")
class FeatureLoader:
    def __init__(self, dataset: GraphDataset, transfer_dtype: str = "float32",
                 num_threads: int = 1,
                 cache: Optional[Union[FeatureCache,
                                       ShardedFeatureCache]] = None,
                 dedup: bool = True, recent_batches: int = 0):
        self.dataset = dataset
        self.source = dataset.feature_source
        self.transfer_dtype = transfer_dtype
        self.num_threads = max(1, int(num_threads))  # DRM's balance_thread knob
        self.cache = cache
        self.dedup = dedup
        self.recent_batches = max(0, int(recent_batches))
        # consumer key -> its last `recent_batches` shipped blocks
        self._recent: Dict[object, Deque[_ShippedBlock]] = {}
        self._recent_lock = threading.Lock()
        self.stats = LoadStats()       # transfer path (rows that cross PCIe)
        self.window = LoadStats()      # transfer path since the last
                                       #   refresh (the drift feedback's)
        self.host_stats = LoadStats()  # CPU-trainer direct host reads
        self._stats_lock = threading.Lock()
        # chunked-gather pool: created lazily, reused across loads
        self._pool: Optional[cf.ThreadPoolExecutor] = None
        self._pool_size = 0
        self._row_bytes = wire_row_bytes(dataset.feat_dim, transfer_dtype)

    def _account(self, dest: str, delta: LoadStats) -> None:
        with self._stats_lock:
            target: LoadStats = getattr(self, dest)
            target.merge(delta)
            if dest == "stats":        # transfer path also feeds the window
                self.window.merge(delta)

    def reset_window(self) -> None:
        """Start a fresh measurement window (after a cache refresh, so the
        drift feedback sees only post-refresh traffic)."""
        with self._stats_lock:
            self.window = LoadStats()

    def snapshot_stats(self) -> LoadStats:
        """Consistent copy of the cumulative transfer-path stats."""
        return self.snapshot("stats")

    def snapshot(self, which: str = "stats") -> LoadStats:
        """Consistent copy of one stats window: ``"stats"`` (cumulative
        transfer path), ``"window"`` (the measurement window) or
        ``"host_stats"`` (the CPU trainer's host reads)."""
        if which not in ("stats", "window", "host_stats"):
            raise ValueError(f"unknown stats window {which!r}")
        with self._stats_lock:
            return dataclasses.replace(getattr(self, which))

    def _get_pool(self) -> cf.ThreadPoolExecutor:
        if self._pool is None or self._pool_size != self.num_threads:
            if self._pool is not None:
                self._pool.shutdown(wait=False)
            self._pool = cf.ThreadPoolExecutor(
                self.num_threads, thread_name_prefix="featload")
            self._pool_size = self.num_threads
        return self._pool

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
            self._pool_size = 0

    def _source_stall(self) -> float:
        """Cumulative cold-page seconds the source reports (0 on RAM-resident
        sources): the delta around a gather is its storage stall.  The pool
        threads finish inside the gather call, so the delta is race-free
        while loads run from one stage thread (the pipeline's contract)."""
        return float(getattr(self.source, "cold_gather_seconds", 0.0))

    def _split_chunks(self, rows: np.ndarray
                      ) -> Tuple[List[np.ndarray], Optional[np.ndarray]]:
        """Split a gather into per-thread chunks.

        For a partitioned source (anything with ``partition_rows``) the
        split is partition-aligned: the rows are grouped by partition and
        cut only at partition boundaries, so each pool thread faults its own
        mmap windows (an ``array_split`` of a frontier in arbitrary order
        makes every thread touch every window).  Returns ``(chunks,
        order)``, ``order`` being the permutation that sorted the rows
        (``None`` for the order-preserving split of other sources)."""
        prows = int(getattr(self.source, "partition_rows", 0) or 0)
        if prows <= 0:
            return np.array_split(rows, self.num_threads), None
        part_id = rows // prows
        order = np.argsort(part_id, kind="stable")
        sorted_rows = rows[order]
        n = rows.shape[0]
        # candidate cuts: the partition boundaries of the sorted stream; the
        # first one at or after each equal-share target
        bounds = np.flatnonzero(np.diff(part_id[order])) + 1
        cand = np.concatenate([bounds, [n]])
        targets = np.arange(1, self.num_threads) * n // self.num_threads
        cuts = np.unique(cand[np.searchsorted(cand, targets)])
        chunks = [c for c in np.split(sorted_rows, cuts) if c.shape[0]]
        return chunks, order

    def _gather(self, rows: np.ndarray) -> np.ndarray:
        if self.num_threads == 1 or rows.shape[0] < 2 * self.num_threads:
            return self.source.take(rows)
        # chunked gather: numpy gathers in several OS threads overlap page
        # faults
        chunks, order = self._split_chunks(rows)
        parts = list(self._get_pool().map(self.source.take, chunks))
        gathered = np.concatenate(parts, axis=0)
        if order is None:
            return gathered
        out = np.empty_like(gathered)
        out[order] = gathered      # scatter back into request order
        return out

    def _frontier(self, batch: MiniBatch,
                  frontier: Optional[np.ndarray] = None) -> np.ndarray:
        """The batch's innermost frontier as host ids: ``frontier`` when the
        caller already brought it to the host, else a device batch's ids
        come over here, since the loader classifies and gathers on the
        host."""
        if frontier is not None:
            return np.asarray(frontier)
        f = batch.frontier(len(batch.fanouts))
        return f.cpu().numpy() if isinstance(f, torch.Tensor) else \
            np.asarray(f)

    def load(self, batch: MiniBatch, to_device: bool = True,
             frontier: Optional[np.ndarray] = None) -> torch.Tensor:
        """Gather features for the innermost frontier (layer-0 inputs).
        ``to_device=False`` marks a CPU-trainer load, accounted in
        ``host_stats`` since its rows never cross the interconnect;
        ``frontier`` is the batch's frontier already on the host."""
        t0 = time.perf_counter()
        stall0 = self._source_stall()
        ids = self._frontier(batch, frontier)
        x = to_transfer_dtype(self._gather(ids), self.transfer_dtype)
        dt = time.perf_counter() - t0
        n = int(x.shape[0])
        self._account("stats" if to_device else "host_stats",
                      LoadStats(rows=n, bytes=_nbytes(x), seconds=dt,
                                total_rows=n, unique_rows=n,
                                stall_seconds=self._source_stall() - stall0))
        return x

    def note_transfer_padding(self, rows: int, nbytes: int) -> None:
        """Account padding rows the transfer stage ships beyond the gathered
        misses (shape bucketing): they cross PCIe, so they count as shipped
        traffic even though no host gather produced them."""
        self._account("stats", LoadStats(rows=rows, bytes=nbytes,
                                         padding_bytes=nbytes))

    def drop_recent(self, key: object = None) -> None:
        """Drop the recent-rows history of ``key`` (every consumer when
        ``None``): a consumer whose transfer stage stopped filling its
        entries must never be matched against again."""
        with self._recent_lock:
            if key is None:
                self._recent.clear()
            else:
                self._recent.pop(key, None)

    def _match_recent(self, key: object, look: CacheLookup):
        """Split ``look``'s unique misses into rows resident in the
        consumer's recent shipped blocks (at the SAME cache version) and
        fresh ids, and remap the positional ``miss_index`` onto the
        combined ``[recent segments... | fresh]`` layout.  Planning only:
        ``look`` is not changed here."""
        miss = look.miss_ids
        with self._recent_lock:
            dq = self._recent.get(key)
            entries = [e for e in (dq or ())
                       if e.version == look.version and e.ids.shape[0]]
            if dq is not None and len(entries) != len(dq):
                # a refresh moved the version: the history is dropped (the
                # rows are value-identical, but residency never outlives
                # the version it was priced at)
                dq.clear()
                dq.extend(entries)
        taken = np.zeros(miss.shape[0], dtype=bool)
        combined = np.empty(miss.shape[0], dtype=np.int32)
        sources: List[Tuple[_ShippedBlock, np.ndarray]] = []
        base = 0
        # newest entry first: consecutive batches share the most rows
        for e in reversed(entries):
            if bool(taken.all()):
                break
            pos = np.searchsorted(e.ids, miss)
            pos = np.minimum(pos, e.ids.shape[0] - 1)
            m = (~taken) & (e.ids[pos] == miss)
            k = int(np.count_nonzero(m))
            if not k:
                continue
            sources.append((e, pos[m].astype(np.int32)))
            combined[m] = base + np.arange(k, dtype=np.int32)
            base += k
            taken |= m
        fresh_mask = ~taken
        n_fresh = int(np.count_nonzero(fresh_mask))
        combined[fresh_mask] = base + np.arange(n_fresh, dtype=np.int32)
        new_miss_index = np.where(
            look.slots >= 0, np.int32(0),
            combined[look.miss_index]).astype(np.int32)
        return miss[fresh_mask], sources, new_miss_index

    def load_compact(self, batch: MiniBatch, pin: bool = False,
                     recent_key: object = None,
                     frontier: Optional[np.ndarray] = None) -> MissBlock:
        """Deduped transfer-path load: gather one row per unique miss id.

        With a cache only the frontier's unique ids are classified and only
        unique misses gathered; without one every unique id is a miss.
        With ``dedup=False`` a cache is required and one row per miss
        position ships.  The lookup only classifies here; cache and loader
        stats are committed together after the gather succeeded, against
        the original classification.  ``pin=True`` registers the lookup as
        in flight: the consumer calls ``cache.release_lookup(block.lookup)``
        once after the combine.  ``recent_key`` (with ``recent_batches`` >
        0) engages the recent-rows LRU: misses still resident on that
        consumer's device are neither gathered nor shipped, ``recent`` says
        where the combine re-reads them, and ``shipped`` registers this
        batch's fresh rows for later batches.  ``frontier`` is the batch's
        frontier already on the host.
        """
        t0 = time.perf_counter()
        stall0 = self._source_stall()
        frontier = self._frontier(batch, frontier)
        if self.cache is not None:
            look = self.cache.lookup(frontier, dedup=self.dedup,
                                     record=False, pin=pin)
            row_bytes = self.cache.row_bytes
        else:
            if not self.dedup:
                raise RuntimeError(
                    "load_compact without a FeatureCache requires dedup")
            look = compact_lookup(frontier)
            row_bytes = self._row_bytes
        use_recent = (recent_key is not None and self.recent_batches > 0
                      and self.dedup)
        if use_recent:
            fresh_ids, recent_src, new_miss_index = \
                self._match_recent(recent_key, look)
        else:
            fresh_ids, recent_src, new_miss_index = look.miss_ids, [], None
        rows = to_transfer_dtype(self._gather(fresh_ids),
                                 self.transfer_dtype)
        dt = time.perf_counter() - t0
        if self.cache is not None:
            self.cache.record_lookup(look)
        n_recent = look.num_miss - int(fresh_ids.shape[0])
        self._account("stats", LoadStats(
            rows=int(rows.shape[0]), bytes=_nbytes(rows), seconds=dt,
            total_rows=look.num_rows, unique_rows=look.num_unique,
            hit_rows=look.num_hit,
            saved_bytes=look.num_hit * row_bytes,
            dedup_saved_bytes=look.dup_miss_rows * row_bytes,
            recent_rows=n_recent, recent_saved_bytes=n_recent * row_bytes,
            stall_seconds=self._source_stall() - stall0))
        shipped = None
        if use_recent:
            # the lookup now addresses the combined source layout; this
            # batch's fresh rows join the consumer's history
            look.miss_ids = fresh_ids
            look.miss_index = new_miss_index
            shipped = _ShippedBlock(ids=fresh_ids, version=look.version)
            with self._recent_lock:
                dq = self._recent.get(recent_key)
                if dq is None or dq.maxlen != self.recent_batches:
                    dq = deque(dq or (), maxlen=self.recent_batches)
                    self._recent[recent_key] = dq
                dq.append(shipped)
        return MissBlock(rows=rows, lookup=look, recent=recent_src,
                         shipped=shipped)

    def load_union(self, batches: Dict[str, MiniBatch],
                   ordinals: Dict[str, int], pin: bool = False,
                   frontiers: Optional[Dict[str, np.ndarray]] = None
                   ) -> Dict[str, ShardMissBlock]:
        """Sharded-plane load: ONE host gather for the union of every
        accelerator trainer's fresh-miss set.

        Needs a ``ShardedFeatureCache``.  All frontiers are classified in
        one ``lookup_union`` (local / peer / fresh per trainer, every shard
        pinned once per trainer when ``pin``), the union of the fresh sets
        is gathered once, and each trainer's block gets only its slice.

        The accounting models the physical route of a node with one card
        per trainer: a union row crosses PCIe once (``bytes``); its copies
        for the other trainers sharing it, and the peer-shard row hops, ride
        the accelerator interconnect (``ici_bytes``).  ``union_saved_bytes``
        is the PCIe traffic avoided against independent per-trainer dedup
        gathers.  Per-shard stats and hotness are recorded only after the
        gather succeeded, as in ``load_compact``.  ``frontiers`` holds the
        batches' frontiers already on the host (by name, any subset)."""
        cache = self.cache
        if not isinstance(cache, ShardedFeatureCache):
            raise RuntimeError("load_union requires a ShardedFeatureCache")
        t0 = time.perf_counter()
        stall0 = self._source_stall()
        host = frontiers or {}
        ids = {name: self._frontier(b, host.get(name))
               for name, b in batches.items()}
        union = cache.lookup_union(ids, ordinals, pin=pin, record=False)
        fresh_sets = [sl.look.miss_ids
                      for sl in union.per_trainer.values()
                      if sl.look.miss_ids.shape[0]]
        if fresh_sets:
            union_ids = np.unique(np.concatenate(fresh_sets))
        else:
            union_ids = np.zeros(0, dtype=np.int64)
        rows = to_transfer_dtype(self._gather(union_ids), self.transfer_dtype)
        dt = time.perf_counter() - t0
        cache.record_union(union)
        row_bytes = cache.row_bytes
        out: Dict[str, ShardMissBlock] = {}
        tot_pos = tot_uniq = tot_local = 0
        tot_peer_pos = tot_peer_rows = tot_fresh = dup_pos = 0
        for name in sorted(union.per_trainer):
            sl = union.per_trainer[name]
            look = sl.look
            # the trainer's multicast slice: the union rows are sorted by id
            # and miss_ids is a sorted subset, so searchsorted is exact
            idx = np.searchsorted(union_ids, look.miss_ids)
            out[name] = ShardMissBlock(rows=rows[torch.from_numpy(idx)],
                                       lookup=look, shard=sl)
            tot_pos += look.num_rows
            tot_uniq += look.num_unique
            tot_local += look.num_hit
            tot_peer_pos += sl.peer_positions
            tot_peer_rows += sl.peer_rows
            tot_fresh += look.num_miss
            dup_pos += (look.miss_positions - sl.peer_positions
                        - look.num_miss)
        multicast_extra = tot_fresh - int(union_ids.shape[0])
        self._account("stats", LoadStats(
            rows=int(union_ids.shape[0]), bytes=_nbytes(rows), seconds=dt,
            total_rows=tot_pos, unique_rows=tot_uniq,
            hit_rows=tot_local + tot_peer_pos,
            saved_bytes=tot_local * row_bytes,
            dedup_saved_bytes=dup_pos * row_bytes,
            peer_rows=tot_peer_rows,
            peer_saved_bytes=tot_peer_pos * row_bytes,
            union_saved_bytes=multicast_extra * row_bytes,
            ici_bytes=(tot_peer_rows + multicast_extra) * row_bytes,
            stall_seconds=self._source_stall() - stall0))
        return out
