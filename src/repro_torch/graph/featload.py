"""Feature Loader (paper Section III-A) — cache- and dedup-aware host gather.

Port of ``repro/graph/featload.py`` (the ``load`` and ``load_compact``
paths).  Runs on the host: given a sampled ``MiniBatch`` it gathers feature
rows from the dataset's ``FeatureSource`` for the Data Transfer stage.

  * ``load``         — the full positional frontier (the CPU trainer reads
    it in place from host memory; dedup-off, cache-off accelerators ship
    it whole),
  * ``load_compact`` — the deduped transfer path: the frontier's unique ids
    are classified against the optional device cache and only *unique miss*
    rows are gathered and shipped; the on-device combine expands them.

Rows come back as torch tensors in the transfer dtype (``float32`` or
``bfloat16``).  ``stats.bytes`` counts only bytes shipped host->device;
every avoided ship lands in exactly one counter (``saved_bytes`` cache
hits, ``dedup_saved_bytes`` in-batch duplicates), so shipped + saved bytes
always rebuild the one-row-per-position baseline (plus bucket padding,
tracked in ``padding_bytes``) — the same accounting as the reference.
The union gather, the recent-rows LRU and stall accounting for disk tiers
are not ported yet (ROADMAP).
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..annotations import guarded_by
from .featcache import (CacheLookup, FeatureCache, compact_lookup,
                        to_transfer_dtype, wire_row_bytes)
from .sampler import MiniBatch
from .storage import GraphDataset

__all__ = ["FeatureLoader", "LoadStats", "MissBlock"]


@dataclasses.dataclass
class LoadStats:
    rows: int = 0            # rows shipped (gathered uniques + any padding)
    bytes: int = 0           # bytes shipped host->device
    seconds: float = 0.0
    total_rows: int = 0      # frontier positions requested (hits + misses)
    unique_rows: int = 0     # unique ids among the requested positions
    hit_rows: int = 0        # positions served from the device cache
    saved_bytes: int = 0     # transfer bytes avoided by cache hits
    dedup_saved_bytes: int = 0  # transfer bytes avoided by deduplication
    padding_bytes: int = 0   # share of `bytes` that is shape-bucket padding

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
class MissBlock:
    """Host-side output of a compact load: ``rows`` is the [M, F] unique-miss
    block and ``lookup`` the positional tables the on-device combine reads
    (many positions may point at one row of ``rows``)."""
    rows: torch.Tensor
    lookup: CacheLookup

    @property
    def num_rows(self) -> int:
        return self.lookup.num_rows


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# the load and transfer pipeline stages run in different threads and both
# account into the same stats windows; every merge runs under _stats_lock
@guarded_by("_stats_lock", "stats", "window", "host_stats")
class FeatureLoader:
    def __init__(self, dataset: GraphDataset, transfer_dtype: str = "float32",
                 num_threads: int = 1,
                 cache: Optional[FeatureCache] = None,
                 dedup: bool = True):
        self.dataset = dataset
        self.source = dataset.feature_source
        self.transfer_dtype = transfer_dtype
        self.num_threads = max(1, int(num_threads))  # DRM's balance_thread knob
        self.cache = cache
        self.dedup = dedup
        self.stats = LoadStats()       # transfer path (rows that cross PCIe)
        self.window = LoadStats()      # transfer path, measurement window
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

    def _gather(self, rows: np.ndarray) -> np.ndarray:
        if self.num_threads == 1 or rows.shape[0] < 2 * self.num_threads:
            return self.source.take(rows)
        # chunked gather: numpy gathers in several OS threads overlap
        chunks = np.array_split(rows, self.num_threads)
        parts = list(self._get_pool().map(self.source.take, chunks))
        return np.concatenate(parts, axis=0)

    def _frontier(self, batch: MiniBatch) -> np.ndarray:
        return np.asarray(batch.frontier(len(batch.fanouts)))

    def load(self, batch: MiniBatch, to_device: bool = True) -> torch.Tensor:
        """Gather features for the innermost frontier (layer-0 inputs).
        ``to_device=False`` marks a CPU-trainer load, accounted in
        ``host_stats`` since its rows never cross the interconnect."""
        t0 = time.perf_counter()
        frontier = self._frontier(batch)
        x = to_transfer_dtype(self._gather(frontier), self.transfer_dtype)
        dt = time.perf_counter() - t0
        n = int(x.shape[0])
        self._account("stats" if to_device else "host_stats",
                      LoadStats(rows=n, bytes=_nbytes(x), seconds=dt,
                                total_rows=n, unique_rows=n))
        return x

    def note_transfer_padding(self, rows: int, nbytes: int) -> None:
        """Account padding rows the transfer stage ships beyond the gathered
        misses (shape bucketing): they cross PCIe, so they count as shipped
        traffic even though no host gather produced them."""
        self._account("stats", LoadStats(rows=rows, bytes=nbytes,
                                         padding_bytes=nbytes))

    def load_compact(self, batch: MiniBatch, pin: bool = False) -> MissBlock:
        """Deduped transfer-path load: gather one row per unique miss id.

        With a cache only the frontier's unique ids are classified and only
        unique misses gathered; without one every unique id is a miss.
        With ``dedup=False`` a cache is required and one row per miss
        position ships.  The lookup only classifies here; cache and loader
        stats are committed together after the gather succeeded.
        ``pin=True`` registers the lookup as in flight: the consumer calls
        ``cache.release_lookup(block.lookup)`` once after the combine.
        """
        t0 = time.perf_counter()
        frontier = self._frontier(batch)
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
        rows = to_transfer_dtype(self._gather(look.miss_ids),
                                 self.transfer_dtype)
        dt = time.perf_counter() - t0
        if self.cache is not None:
            self.cache.record_lookup(look)
        self._account("stats", LoadStats(
            rows=int(rows.shape[0]), bytes=_nbytes(rows), seconds=dt,
            total_rows=look.num_rows, unique_rows=look.num_unique,
            hit_rows=look.num_hit,
            saved_bytes=look.num_hit * row_bytes,
            dedup_saved_bytes=look.dup_miss_rows * row_bytes))
        return MissBlock(rows=rows, lookup=look)
