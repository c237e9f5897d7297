"""Graph storage: host-resident topology and the ``FeatureSource`` layer.

Port of ``repro/graph/storage.py``.  The paper keeps the graph and its
feature matrix in host memory (Section III-B): device memory (16-80 GB)
cannot hold graphs like MAG240M (202 GB of features).  Everything here is
numpy on the host; device code only ever sees gathered mini-batch tensors,
and for the same seed every array is bit-identical to the reference.

Feature storage is behind the ``FeatureSource`` protocol — a minimal
row-gather interface (``take(rows)`` + shape/dtype metadata) with four
interchangeable backends:

  * ``DenseFeatures``       — one materialized ndarray (small graphs),
  * ``HashedFeatures``      — lazily computed rows (nothing materialized),
  * ``PartitionedFeatures`` — fixed-size row partitions gathered per
                              partition; each partition is an independent
                              RAM blob,
  * ``MmapFeatures``        — the out-of-core tier: the same fixed-size
                              row partitions spilled to per-partition disk
                              blobs and opened lazily as read-only
                              ``np.memmap`` windows.  The spill writer
                              buffers at most ONE partition at a time, so
                              a feature matrix larger than host RAM (the
                              MAG240M 202 GB case) streams through a
                              bounded buffer, and a gather's working set
                              is only the touched partition windows.

All backends return byte-identical rows for the same node ids, so the
choice is purely a capacity/locality knob.  The device-side hot-row cache
(``featcache.FeatureCache``) and the miss-only ``FeatureLoader``
(``featload``) sit on top of this protocol and never see a concrete
backend; composing ``FeatureCache`` over ``MmapFeatures`` gives the full
three-tier hierarchy the paper targets (hot rows pinned on the card, warm
rows in the OS page cache, cold rows on disk).  A gathered block is always
a fresh array (``np.take`` copies): no tensor is ever built on a memmap
view, whose pages an eviction's ``MADV_DONTNEED`` may drop.

Backend selection is ``make_dataset(feature_backend=...)``: ``"dense"`` |
``"hashed"`` | ``"partitioned"`` | ``"mmap"`` (with ``spill_dir=`` to place
the blobs; a private temp dir, removed on GC/exit, is used otherwise) |
``"auto"``.

Datasets are synthetic, size-parameterized power-law graphs standing in for
ogbn-products / ogbn-papers100M / MAG240M (homo).  The *full* Table-III stats
are kept in the registry; smoke/bench runs instantiate scaled-down versions
with the same degree-distribution shape.

Failure model & degraded modes (``MmapFeatures``)
-------------------------------------------------

A transient ``OSError`` from a window gather (``take`` / ``prefetch_rows``)
is retried with bounded, jittered exponential backoff under a per-call
deadline (knobs ``io_retry_attempts`` / ``io_retry_base`` /
``io_retry_max_delay`` / ``io_retry_deadline``; counters ``io_retries``,
``io_retry_seconds``, ``io_errors``).  A *permanently* unreadable window
on the ``take`` path falls back to a bounded re-gather from the spill's
backing source (``fallback_source``, set by ``spill()``; counters
``fallback_gathers`` / ``fallback_rows``, hard cap
``fallback_row_budget`` — past it the original error is raised).
madvise/fadvise hint failures are advisory: they increment
``madvise_failures`` / ``fadvise_failures`` and never fail a gather.  An
``OSError`` (e.g. ENOSPC) during ``spill()`` removes the partial
partition blobs (no orphaned tempdirs) and raises an error naming the
spill dir and bytes written.  Deterministic fault injection hooks:
``storage.take``, ``storage.prefetch``, ``storage.madvise``,
``storage.fadvise``, ``storage.spill`` (see ``graph/faults.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Protocol, Tuple

import numpy as np

from ..annotations import guarded_by, requires_lock

__all__ = [
    "CSRGraph",
    "FeatureSource",
    "DenseFeatures",
    "HashedFeatures",
    "PartitionedFeatures",
    "MmapFeatures",
    "as_feature_source",
    "GraphDataset",
    "synth_powerlaw_graph",
    "make_dataset",
    "DATASET_STATS",
    "TRAIN_SPLIT",
]


@dataclasses.dataclass
class CSRGraph:
    """Compressed-sparse-row adjacency (out-neighbors), host resident."""

    indptr: np.ndarray   # int64 [num_nodes + 1]
    indices: np.ndarray  # int32/int64 [num_edges]

    @property
    def num_nodes(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def nbytes(self) -> int:
        return self.indptr.nbytes + self.indices.nbytes


class FeatureSource(Protocol):
    """Minimal host-side feature storage interface: ``take`` returns a fresh
    ``[len(rows), feat_dim]`` array in ``dtype`` for any int array of node
    ids (duplicates and arbitrary order allowed)."""

    shape: Tuple[int, int]

    @property
    def dtype(self) -> np.dtype: ...

    def take(self, rows: np.ndarray) -> np.ndarray: ...


class DenseFeatures:
    """FeatureSource over one materialized host ndarray."""

    def __init__(self, array: np.ndarray):
        if array.ndim != 2:
            raise ValueError(f"expected [N, F] features, got {array.shape}")
        self.array = array
        self.shape = tuple(array.shape)

    @property
    def dtype(self) -> np.dtype:
        return self.array.dtype

    @property
    def nbytes(self) -> int:
        return self.array.nbytes

    def take(self, rows: np.ndarray) -> np.ndarray:
        return np.take(self.array, np.asarray(rows, dtype=np.int64), axis=0)

    def __getitem__(self, rows):
        return self.take(np.atleast_1d(rows))


class PartitionedFeatures:
    """FeatureSource split into fixed-size row partitions.

    The feature matrix is stored as ``ceil(N / partition_rows)`` independent
    blobs; a gather groups the requested rows by partition, gathers within
    each touched partition, and scatters results back into request order.
    This is the layout an mmap/out-of-core backend needs (each partition is
    one file / one madvise window) and bounds the working set of a gather
    to the touched partitions only.
    """

    def __init__(self, parts: List[np.ndarray], partition_rows: int,
                 num_rows: int):
        if not parts:
            raise ValueError("need at least one partition")
        self.parts = parts
        self.partition_rows = int(partition_rows)
        self.shape = (int(num_rows), int(parts[0].shape[1]))

    @classmethod
    def from_source(cls, src: "FeatureSource | np.ndarray",
                    partition_rows: int = 65536) -> "PartitionedFeatures":
        src = as_feature_source(src)
        n = src.shape[0]
        partition_rows = max(1, int(partition_rows))
        parts = [src.take(np.arange(lo, min(lo + partition_rows, n),
                                    dtype=np.int64))
                 for lo in range(0, n, partition_rows)]
        return cls(parts, partition_rows, n)

    @property
    def dtype(self) -> np.dtype:
        return self.parts[0].dtype

    @property
    def num_partitions(self) -> int:
        return len(self.parts)

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.parts)

    def take(self, rows: np.ndarray) -> np.ndarray:
        rows = np.asarray(rows, dtype=np.int64)
        part_id = rows // self.partition_rows
        offset = rows - part_id * self.partition_rows
        out = np.empty((rows.shape[0], self.shape[1]), dtype=self.dtype)
        for pid in np.unique(part_id):
            sel = part_id == pid
            out[sel] = np.take(self.parts[pid], offset[sel], axis=0)
        return out

    def __getitem__(self, rows):
        return self.take(np.atleast_1d(rows))


_MMAP_MANIFEST = "manifest.json"
_MMAP_FORMAT = "mmap-features-v1"
_PAGE_BYTES = 4096          # granularity of the touched-page accounting


# Deliberately UNGUARDED shared state (left out of the declarations, so
# the lint does not police it):
#   * _page_touched — gather-side updates only ever SET bits, so the
#     concurrent chunked gathers stay correct lock-free (see __init__);
#     evictions clear a window's bits under _win_lock anyway.
#   * last_gather_page_bytes — documented last-writer-wins monitor.
#   * spill_peak_buffered_rows / fallback_source / fault_injector /
#     lru_windows / io_retry_* knobs — configured before threads exist.
@guarded_by("_win_lock", "_parts", "_prefetched", "_pinned",
            "pin_blocked_evictions", "madvise_calls",
            "madvise_dontneed_calls", "madvise_failures",
            "window_evictions", "evicted_window_bytes",
            "prefetched_window_bytes", "cold_fault_page_bytes",
            "cold_gather_seconds", "warm_gather_seconds",
            "prefetch_hit_windows", "prefetch_miss_windows")
@guarded_by("_io_lock", "io_retries", "io_retry_seconds", "io_errors",
            "fallback_gathers", "fallback_rows", "fadvise_failures",
            "_retry_rng")
class MmapFeatures:
    """Out-of-core FeatureSource: row partitions in per-partition disk blobs.

    The feature matrix is stored as ``ceil(N / partition_rows)`` raw binary
    files plus a JSON manifest, created by the chunked spill writer
    (``MmapFeatures.spill``) which buffers AT MOST one partition of rows at
    a time — so any ``FeatureSource`` (e.g. lazily-computed
    ``HashedFeatures`` at MAG240M scale) can be materialized to disk with
    bounded host RAM.  Partitions are opened lazily as read-only
    ``np.memmap`` windows, hinted ``madvise(MADV_RANDOM)`` at open
    (guarded for platforms without madvise) so the kernel does not read
    ahead past the touched rows; ``take`` groups the requested rows by
    partition,
    so a gather faults only the touched windows (and, at page granularity,
    only the touched rows within them) instead of paging the whole matrix.

    Accounting read by ``chip_smoke.py``'s outofcore phase and the tests:

      * ``spill_peak_buffered_rows`` — max rows the spill writer ever held
        (must be <= ``partition_rows``: the bounded-RAM guarantee),
      * ``resident_window_bytes``    — bytes of mapped (lazily opened)
        partition windows: address space, an upper bound on residency,
      * ``touched_page_bytes``       — cumulative unique 4 KiB pages the
        gathers actually faulted (page-granular residency estimate; the
        quantity that stays O(touched rows) instead of O(N*F)).

    Bounded page cache (``lru_windows > 0``): open windows live in a
    small LRU; opening one past the bound evicts the least-recently-used
    window by hinting its pages ``MADV_DONTNEED`` (clean, file-backed —
    the kernel drops them immediately instead of waiting for reclaim) and
    dropping the map reference (the underlying mmap closes once no
    in-flight gather still holds it, so a concurrent gather on an evicted
    window simply re-faults pages and stays bit-identical).  Page-cache
    residency is therefore O(lru_windows × window_bytes) instead of
    "whatever the kernel keeps".  Eviction clears the window's touch
    bits: its pages are gone, a future gather re-faults them cold.

    Background prefetch (``prefetch_rows``): pre-faults exactly the pages
    a future ``take(rows)`` will touch (readahead gather through the same
    LRU, result discarded) so the consumer's gather hits warm pages.  ``take`` accounts which of its pages were
    already faulted (by a prefetch or an earlier gather) vs faulted cold
    on the critical path:

      * ``prefetched_window_bytes`` — page bytes newly faulted by
        ``prefetch_rows`` calls,
      * ``evicted_window_bytes``    — bytes of windows evicted by the LRU,
      * ``cold_fault_page_bytes``   — page bytes ``take`` had to fault
        itself (the load-stage stall a prefetcher exists to hide), with
        the wall time spent on such cold windows in
        ``cold_gather_seconds``,
      * ``prefetch_hit_rate``       — fraction of ``take`` window touches
        served by a still-warm prefetched window.

    Reopening an existing spill directory is just ``MmapFeatures(path)``.
    """

    is_disk_resident = True   # the perf model prices loads at storage bw

    def __init__(self, spill_dir: str, lru_windows: int = 0):
        self.spill_dir = str(spill_dir)
        path = os.path.join(self.spill_dir, _MMAP_MANIFEST)
        with open(path) as fh:
            m = json.load(fh)
        if m.get("format") != _MMAP_FORMAT:
            raise ValueError(f"{path}: not a {_MMAP_FORMAT} spill directory")
        self.shape = (int(m["num_rows"]), int(m["feat_dim"]))
        self._dtype = np.dtype(str(m["dtype"]))
        self.partition_rows = int(m["partition_rows"])
        self.num_partitions = int(m["num_partitions"])
        # lazily opened windows in LRU order (insertion order = recency:
        # _part() reinserts on access); guarded by _win_lock because the
        # loader's pool threads, the background WindowPrefetcher and the
        # consumer all open/evict concurrently
        self._parts: Dict[int, np.memmap] = {}
        self._win_lock = threading.Lock()
        self.lru_windows = int(lru_windows)      # 0 = unbounded (legacy)
        self._prefetched: set = set()            # warm (prefetched) pids
        # prefetch-pinned windows: prefetched but not yet gathered from.
        # The LRU trim skips them so a tight lru_windows bound cannot
        # throw away prefetch work before its consumer arrives; the pin
        # releases on the first post-prefetch take() touching the window
        self._pinned: set = set()
        self.pin_blocked_evictions = 0           # trims blocked on pins
        self.spill_peak_buffered_rows = 0        # set by spill()
        self.madvise_calls = 0                   # windows hinted MADV_RANDOM
        self.madvise_dontneed_calls = 0          # evictions that dropped pages
        self.window_evictions = 0
        self.evicted_window_bytes = 0            # bytes of evicted windows
        self.prefetched_window_bytes = 0         # page bytes prefetch faulted
        self.cold_fault_page_bytes = 0           # page bytes take() faulted
        self.cold_gather_seconds = 0.0           # take() time on cold windows
        self.warm_gather_seconds = 0.0           # take() time on warm windows
        self.prefetch_hit_windows = 0            # take() touches of warm pids
        self.prefetch_miss_windows = 0
        self.gather_windows_touched = 0          # take() window touches
                                                 #   (load-stage working-set
                                                 #   signal for knob tuning)
        # per-thread exclusion from the stall/prefetch counters: background
        # maintenance gathers (cache boot, staged-refresh admission) are
        # not load-stage traffic and must not skew the stall metrics the
        # task mapping re-prices on (page-touch accounting still applies —
        # the pages really do become warm)
        self._untracked = threading.local()
        # ---- fault tolerance (see module docstring: failure model) ----
        self.fault_injector = None               # optional FaultInjector
        self.io_retry_attempts = 3               # tries per window gather
        self.io_retry_base = 0.005               # first backoff (seconds)
        self.io_retry_max_delay = 0.25           # per-sleep cap
        self.io_retry_deadline = 5.0             # per-call retry budget
        self.io_retries = 0                      # sleeps taken before success
        self.io_retry_seconds = 0.0              # wall time spent backing off
        self.io_errors = 0                       # OSErrors seen (incl retried)
        self.fallback_source = None              # spill() sets the backing src
        self.fallback_row_budget = 1 << 20       # max rows served by fallback
        self.fallback_gathers = 0                # window gathers that fell back
        self.fallback_rows = 0                   # rows served by the fallback
        self.madvise_failures = 0                # madvise hints that errored
        self.fadvise_failures = 0                # posix_fadvise that errored
        self._io_lock = threading.Lock()
        # deterministic jitter: backoff sleeps are reproducible run-to-run
        self._retry_rng = np.random.default_rng(0x10C0FFEE)
        self._owned_tmp: Optional[tempfile.TemporaryDirectory] = None
        self._row_bytes = self.shape[1] * self._dtype.itemsize
        # pages per partition *file* (files are page-aligned independently)
        self._pages_per_part = (
            -(-self.partition_rows * self._row_bytes // _PAGE_BYTES) + 1)
        # cumulative touched-page bitmap: one byte per 4 KiB page, i.e.
        # 1/4096 of the matrix size — bookkeeping stays negligible next to
        # the one-partition spill buffer even at MAG240M scale.  Updates
        # only ever set bits, so concurrent take() calls (the loader's
        # chunked gather) stay correct without a lock.
        self._page_touched = np.zeros(
            max(self.num_partitions, 0) * self._pages_per_part, dtype=bool)
        # pages of the most recent take() CALL — under the loader's
        # multi-threaded chunked gather each chunk is its own take(), so
        # this is per-chunk and last-writer-wins there; for a whole-gather
        # working set, diff touched_page_bytes around the gather or call
        # take() directly
        self.last_gather_page_bytes = 0

    # --------------------------------------------------------- spill writer

    @classmethod
    def spill(cls, src: "FeatureSource | np.ndarray",
              spill_dir: Optional[str] = None,
              partition_rows: int = 65536,
              lru_windows: int = 0,
              fault_injector=None) -> "MmapFeatures":
        """Materialize ``src`` into per-partition disk blobs, one partition
        buffered at a time, and return the mmap-backed view.

        ``spill_dir=None`` spills into a private temporary directory that
        is removed when the returned object is garbage-collected (or at
        interpreter exit).

        An ``OSError`` while writing (ENOSPC being the canonical case)
        removes every partition blob written so far — and the owned
        temp dir, when the writer created one — then re-raises with the
        spill dir and bytes written named, so a failed spill never
        leaves orphaned blob files behind.  The backing ``src`` is kept
        as ``fallback_source`` on the returned view: a window blob that
        later turns unreadable degrades to a bounded re-gather from it.
        """
        src = as_feature_source(src)
        n, f = src.shape
        partition_rows = max(1, int(partition_rows))
        owned = None
        if spill_dir is None:
            owned = tempfile.TemporaryDirectory(prefix="repro-torch-featspill-")
            spill_dir = owned.name
        os.makedirs(spill_dir, exist_ok=True)
        num_parts = -(-n // partition_rows)
        peak = 0
        bytes_written = 0
        pid = -1
        try:
            for pid in range(num_parts):
                lo = pid * partition_rows
                hi = min(lo + partition_rows, n)
                # the ONLY RAM the writer holds: one partition's rows
                buf = np.ascontiguousarray(
                    src.take(np.arange(lo, hi, dtype=np.int64)))
                peak = max(peak, buf.shape[0])
                if fault_injector is not None:
                    fault_injector.fire("storage.spill")
                buf.tofile(os.path.join(spill_dir, cls._part_name(pid)))
                bytes_written += int(buf.nbytes)
                dtype = buf.dtype
                del buf
        except OSError as e:
            # no orphans: drop every blob this spill managed to write
            for q in range(pid + 1):
                with contextlib.suppress(OSError):
                    os.remove(os.path.join(spill_dir, cls._part_name(q)))
            if owned is not None:
                with contextlib.suppress(OSError):
                    owned.cleanup()
            raise OSError(
                e.errno,
                f"feature spill to {spill_dir!r} failed at partition "
                f"{max(pid, 0)}/{num_parts} after {bytes_written} bytes "
                f"written: {e.strerror or e}") from e
        if num_parts == 0:
            dtype = np.dtype(src.dtype)
        manifest = {"format": _MMAP_FORMAT, "num_rows": int(n),
                    "feat_dim": int(f), "dtype": np.dtype(dtype).str,
                    "partition_rows": partition_rows,
                    "num_partitions": num_parts}
        with open(os.path.join(spill_dir, _MMAP_MANIFEST), "w") as fh:
            json.dump(manifest, fh)
        out = cls(spill_dir, lru_windows=lru_windows)
        out.spill_peak_buffered_rows = peak
        out._owned_tmp = owned
        out.fallback_source = src
        out.fault_injector = fault_injector
        return out

    @staticmethod
    def _part_name(pid: int) -> str:
        return f"part-{pid:05d}.bin"

    # -------------------------------------------------------------- gathers

    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    @property
    def nbytes_on_disk(self) -> int:
        return self.shape[0] * self.shape[1] * self._dtype.itemsize

    @property
    def resident_window_bytes(self) -> int:
        """Bytes of currently mapped (touched) partition windows."""
        with self._win_lock:
            return sum(int(p.nbytes) for p in self._parts.values())

    @property
    def open_windows(self) -> int:
        """Currently mapped partition windows (<= ``lru_windows`` when the
        LRU bound is set)."""
        with self._win_lock:
            return len(self._parts)

    @property
    def window_bytes(self) -> int:
        """Bytes of one full partition window (the LRU bound's unit)."""
        return self.partition_rows * self._row_bytes

    @property
    def touched_page_bytes(self) -> int:
        """Unique pages faulted by gathers and still accounted resident
        (page-granular residency estimate; an LRU eviction clears its
        window's bits — those pages were dropped).  Cumulative when
        ``lru_windows == 0`` (the legacy meaning)."""
        return int(np.count_nonzero(self._page_touched)) * _PAGE_BYTES

    @property
    def prefetch_hit_rate(self) -> float:
        """Fraction of ``take`` window touches whose window was warm from
        a prior ``prefetch_rows`` (and not since evicted).  Snapshotted
        under ``_win_lock`` so a concurrent gather cannot tear the
        hit/total pair (a rate > 1.0 would be possible otherwise)."""
        with self._win_lock:
            hits = self.prefetch_hit_windows
            tot = hits + self.prefetch_miss_windows
        return hits / max(tot, 1)

    def reset_touch_stats(self) -> None:
        self._page_touched[:] = False
        self.last_gather_page_bytes = 0

    def set_lru_windows(self, n: int) -> None:
        """Re-bound the window LRU at runtime (DRM knob auto-tuning) and
        trim immediately when tightening — ``_part()`` would trim on the
        next access anyway, but an immediate trim makes the page-cache
        effect of an accepted knob move visible within its trial window
        rather than one gather later."""
        self.lru_windows = max(0, int(n))
        with self._win_lock:
            if self.lru_windows <= 0:
                return
            while len(self._parts) > self.lru_windows:
                old = next((p for p in self._parts
                            if p not in self._pinned), None)
                if old is None:
                    self.pin_blocked_evictions += 1
                    break
                self._evict_window(old, self._parts[old])

    @contextlib.contextmanager
    def untracked_gathers(self):
        """Context manager: this thread's ``take`` calls are excluded
        from the cold/warm stall and prefetch-hit counters (maintenance
        gathers — the cache boot block, staged-refresh admission rows —
        are not load-stage traffic).  Touch/residency accounting still
        applies: the gathered pages genuinely become warm.  Reentrant
        (restores the previous flag, not False)."""
        prev = getattr(self._untracked, "flag", False)
        self._untracked.flag = True
        try:
            yield
        finally:
            self._untracked.flag = prev

    def reset_prefetch_stats(self) -> None:
        """Zero the prefetch/stall counters (not the touch bitmap)."""
        with self._win_lock:
            self.prefetched_window_bytes = 0
            self.cold_fault_page_bytes = 0
            self.cold_gather_seconds = 0.0
            self.warm_gather_seconds = 0.0
            self.prefetch_hit_windows = 0
            self.prefetch_miss_windows = 0

    # ------------------------------------------------- retrying I/O plumbing

    def _retry_io(self, fn: Callable[[], "np.ndarray"], op: str):
        """Run one window I/O operation with bounded, jittered exponential
        backoff on transient ``OSError``: up to ``io_retry_attempts``
        tries within a per-call ``io_retry_deadline``.  Every error is
        counted in ``io_errors``; every backoff sleep in ``io_retries`` /
        ``io_retry_seconds``.  Jitter comes from a seeded rng, so backoff
        timing is reproducible run-to-run.  The fault-injection hook
        fires inside the attempt (before ``fn``), so a scheduled
        transient fault is consumed by the attempt it targets and the
        next attempt proceeds clean."""
        deadline = time.monotonic() + self.io_retry_deadline
        backoff = self.io_retry_base
        attempts = max(1, int(self.io_retry_attempts))
        for attempt in range(attempts):
            try:
                if self.fault_injector is not None:
                    self.fault_injector.fire(op)
                return fn()
            except OSError:
                with self._io_lock:
                    self.io_errors += 1
                    jitter = 1.0 + float(self._retry_rng.random())
                budget = deadline - time.monotonic()
                if attempt == attempts - 1 or budget <= 0:
                    raise
                sleep = min(backoff * jitter, self.io_retry_max_delay, budget)
                time.sleep(sleep)
                with self._io_lock:
                    self.io_retries += 1
                    self.io_retry_seconds += sleep
                backoff *= 2.0

    def _fallback_gather(self, pid: int, offset: np.ndarray,
                         err: OSError) -> np.ndarray:
        """Degraded path for a window unreadable past the retry budget:
        re-gather the rows from the spill's backing ``fallback_source``
        (global ids reconstructed from the partition coordinates), under
        a hard ``fallback_row_budget`` so a totally broken storage tier
        still fails loudly instead of silently re-running the whole
        spill's source forever."""
        src = self.fallback_source
        if src is None:
            raise err
        n = int(offset.shape[0])
        with self._io_lock:
            if self.fallback_rows + n > self.fallback_row_budget:
                raise OSError(
                    err.errno,
                    f"window {pid} under {self.spill_dir!r} is unreadable "
                    f"and the fallback gather budget is exhausted "
                    f"({self.fallback_rows} rows served, "
                    f"{n} more requested > fallback_row_budget="
                    f"{self.fallback_row_budget}): {err}") from err
            self.fallback_gathers += 1
            self.fallback_rows += n
        rows = pid * self.partition_rows + np.asarray(offset, dtype=np.int64)
        return np.ascontiguousarray(src.take(rows), dtype=self._dtype)

    def _gather_window(self, pid: int, offset: np.ndarray, op: str
                       ) -> Tuple[np.ndarray, bool]:
        """One window gather with retries, then the bounded fallback.
        Returns ``(rows, used_fallback)`` — fallback rows never came from
        the blob, so the caller must skip page-touch accounting."""
        try:
            return self._retry_io(
                lambda: np.take(self._part(pid), offset, axis=0), op), False
        except OSError as e:
            return self._fallback_gather(pid, offset, e), True

    @requires_lock("_win_lock")
    def _madvise(self, mm: np.memmap, advice_name: str) -> bool:
        """Issue one madvise hint on a window (caller holds ``_win_lock``).
        Purely advisory and guarded — platforms without ``mmap.madvise``
        (or numpy builds not exposing the underlying map) skip, and a
        kernel that rejects the hint only increments ``madvise_failures``;
        gather results are identical either way (property-tested)."""
        import mmap as _mmap
        advice = getattr(_mmap, advice_name, None)
        base = getattr(mm, "_mmap", None)
        if advice is None or base is None:
            return False
        try:
            if self.fault_injector is not None:
                self.fault_injector.fire("storage.madvise")
            base.madvise(advice)
            return True
        except (OSError, ValueError):
            # advisory failure: counted, never raised — the gather works
            # without the hint, just with worse readahead behaviour
            self.madvise_failures += 1
            return False

    @requires_lock("_win_lock")
    def _madvise_random(self, mm: np.memmap) -> None:
        """``MADV_RANDOM`` disables readahead, so a sparse gather faults
        only the touched pages instead of dragging untouched neighbour
        rows into the page cache.  Caller holds ``_win_lock``."""
        if self._madvise(mm, "MADV_RANDOM"):
            self.madvise_calls += 1

    @requires_lock("_win_lock")
    def _evict_window(self, pid: int, mm: np.memmap) -> None:
        """Drop one window from the LRU (held under ``_win_lock``):
        ``MADV_DONTNEED`` releases its clean file-backed pages immediately
        (instead of trusting kernel reclaim), then the map reference is
        dropped — the underlying mmap closes once no in-flight gather
        still holds it, so a gather racing the eviction just re-faults
        pages and stays bit-identical."""
        if self._madvise(mm, "MADV_DONTNEED"):
            self.madvise_dontneed_calls += 1
        self.window_evictions += 1
        self.evicted_window_bytes += int(mm.nbytes)
        self._prefetched.discard(pid)
        self._pinned.discard(pid)
        # the pages are gone: a future gather faults them cold again
        base = pid * self._pages_per_part
        self._page_touched[base:base + self._pages_per_part] = False
        del self._parts[pid]

    def _part(self, pid: int) -> np.memmap:
        with self._win_lock:
            mm = self._parts.pop(pid, None)
            if mm is None:
                lo = pid * self.partition_rows
                rows = min(self.partition_rows, self.shape[0] - lo)
                mm = np.memmap(
                    os.path.join(self.spill_dir, self._part_name(pid)),
                    dtype=self._dtype, mode="r",
                    shape=(rows, self.shape[1]))
                self._madvise_random(mm)
            self._parts[pid] = mm              # (re)insert at the MRU end
            # trim on every access, not just opens: lru_windows may have
            # been tightened after windows were already mapped (e.g. the
            # cache boot gather runs before the trainer sets the bound)
            if self.lru_windows > 0:
                while len(self._parts) > self.lru_windows:
                    # LRU-ordered victim scan, skipping the newcomer and
                    # prefetch-pinned windows (not-yet-consumed prefetch
                    # work must survive even a bound == working-set size)
                    old = next((p for p in self._parts
                                if p != pid and p not in self._pinned),
                               None)
                    if old is None:
                        # every candidate is pinned: run over-bound until
                        # their gathers release them (counted, not silent)
                        self.pin_blocked_evictions += 1
                        break
                    self._evict_window(old, self._parts[old])
            return mm

    @requires_lock("_win_lock")
    def _note_touch_window(self, pid: int, offset: np.ndarray
                           ) -> Tuple[int, int]:
        """Mark one window's pages touched by ``offset`` rows; returns
        (page bytes this call spans, page bytes newly faulted).  Caller
        holds ``_win_lock`` (both gather paths account under it)."""
        off_b = offset * self._row_bytes
        first = off_b // _PAGE_BYTES
        last = (off_b + self._row_bytes - 1) // _PAGE_BYTES
        base = pid * self._pages_per_part
        # a row spans first..last inclusive — wide rows (> 2 pages) touch
        # interior pages too, so enumerate the whole span
        span = self._row_bytes // _PAGE_BYTES + 1
        parts = []
        for j in range(span + 1):
            pg = first + j
            parts.append(np.where(pg <= last, base + pg, np.int64(-1)))
        pages = np.unique(np.concatenate(parts))
        pages = pages[pages >= 0]
        fresh = int(np.count_nonzero(~self._page_touched[pages]))
        self._page_touched[pages] = True
        return int(pages.shape[0]) * _PAGE_BYTES, fresh * _PAGE_BYTES

    def _split_parts(self, rows: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        if rows.min() < 0 or rows.max() >= self.shape[0]:
            raise IndexError(
                f"row ids out of range [0, {self.shape[0]})")
        part_id = rows // self.partition_rows
        return part_id, rows - part_id * self.partition_rows

    def prefetch_rows(self, rows: np.ndarray) -> int:
        """Pre-fault the pages a future ``take(rows)`` will touch.

        Groups the rows by partition, opens each touched window through
        the LRU and runs a readahead gather of exactly the requested rows
        (result discarded) so precisely the needed pages are resident
        when the consumer's gather arrives.  Deliberately NOT a
        whole-window ``MADV_WILLNEED``: an untargeted hint covers the
        entire mapping, so the kernel would stream the full window blob
        and the background thread would compete for the very storage
        bandwidth it exists to hide (the windows stay ``MADV_RANDOM``
        from open).  Safe to call concurrently with ``take`` (this is
        the WindowPrefetcher's worker-thread entry point).  Returns the
        page bytes newly faulted (also accumulated into
        ``prefetched_window_bytes``)."""
        rows = np.asarray(rows, dtype=np.int64)
        if rows.shape[0] == 0:
            return 0
        part_id, offset = self._split_parts(rows)
        total_new = 0
        for pid in np.unique(part_id):
            pid = int(pid)
            sel = part_id == pid
            # readahead gather, discarded; transient I/O errors retried
            self._retry_io(
                lambda p=pid, o=offset[sel]: np.take(self._part(p), o,
                                                     axis=0),
                "storage.prefetch")
            with self._win_lock:
                _, new = self._note_touch_window(pid, offset[sel])
                self._prefetched.add(pid)
                self._pinned.add(pid)
                self.prefetched_window_bytes += new
            total_new += new
        return total_new

    def take(self, rows: np.ndarray) -> np.ndarray:
        rows = np.asarray(rows, dtype=np.int64)
        out = np.empty((rows.shape[0], self.shape[1]), dtype=self._dtype)
        if rows.shape[0] == 0:
            return out
        part_id, offset = self._split_parts(rows)
        tracked = not getattr(self._untracked, "flag", False)
        gather_pages = 0
        for pid in np.unique(part_id):
            pid = int(pid)
            sel = part_id == pid
            # snapshot warmth under the lock: the prefetch worker adds to
            # _prefetched and the LRU discards from it concurrently, and a
            # set mutating mid-__contains__ has no defined answer
            with self._win_lock:
                warm = pid in self._prefetched
            t0 = time.perf_counter()
            block, fell_back = self._gather_window(pid, offset[sel],
                                                   "storage.take")
            out[sel] = block
            dt = time.perf_counter() - t0
            if fell_back:
                # rows came from the backing source, not the blob: no
                # pages were faulted here, so skip touch/stall accounting
                continue
            with self._win_lock:
                touched, fresh = self._note_touch_window(pid, offset[sel])
                gather_pages += touched
                # first post-prefetch gather: the prefetched data reached
                # its consumer, the window is evictable again
                self._pinned.discard(pid)
                if not tracked:
                    continue
                # stall accounting: pages nobody faulted before this
                # gather are the cold reads a prefetcher exists to hide
                self.gather_windows_touched += 1
                self.cold_fault_page_bytes += fresh
                if warm:
                    self.prefetch_hit_windows += 1
                else:
                    self.prefetch_miss_windows += 1
                if fresh:
                    self.cold_gather_seconds += dt
                else:
                    self.warm_gather_seconds += dt
        self.last_gather_page_bytes = gather_pages
        return out

    def __getitem__(self, rows):
        return self.take(np.atleast_1d(rows))

    def drop_page_cache(self) -> None:
        """Best-effort page-cache drop of every partition blob
        (``posix_fadvise(POSIX_FADV_DONTNEED)`` on the files, guarded) —
        used by benchmarks to measure genuinely cold gathers right after
        a spill wrote (and therefore page-cached) the blobs."""
        fadvise = getattr(os, "posix_fadvise", None)
        dontneed = getattr(os, "POSIX_FADV_DONTNEED", None)
        if fadvise is None or dontneed is None:  # pragma: no cover
            return
        for pid in range(self.num_partitions):
            path = os.path.join(self.spill_dir, self._part_name(pid))
            try:
                if self.fault_injector is not None:
                    self.fault_injector.fire("storage.fadvise")
                fd = os.open(path, os.O_RDONLY)
                try:
                    os.fsync(fd)
                    fadvise(fd, 0, 0, dontneed)
                finally:
                    os.close(fd)
            except OSError:
                # advisory: a file we cannot re-open/fadvise just stays
                # page-cached — counted so chaos tests can see it happened
                with self._io_lock:
                    self.fadvise_failures += 1

    def close(self) -> None:
        """Drop all mapped windows (their pages become reclaimable)."""
        with self._win_lock:
            self._parts.clear()
            self._prefetched.clear()
            self._pinned.clear()



def as_feature_source(features) -> "FeatureSource":
    """Normalize a bare ndarray to the protocol."""
    if isinstance(features, np.ndarray):
        return DenseFeatures(features)
    if hasattr(features, "take") and hasattr(features, "shape"):
        return features
    raise TypeError(f"not a FeatureSource: {type(features)!r}")


class HashedFeatures:
    """Deterministic lazily-computed node features: each row is a
    splitmix-style hash of (node id, column, seed) mapped to [-1, 1), so a
    feature matrix too large to materialize is never built."""

    def __init__(self, num_nodes: int, feat_dim: int, seed: int = 0,
                 dtype=np.float32):
        self.shape = (num_nodes, feat_dim)
        self.dtype = np.dtype(dtype)
        self._seed = np.uint64((seed * 0x9E3779B97F4A7C15 + 0xDEADBEEF)
                               & 0xFFFFFFFFFFFFFFFF)
        self._cols = np.arange(feat_dim, dtype=np.uint64)

    @property
    def nbytes_virtual(self) -> int:
        return self.shape[0] * self.shape[1] * self.dtype.itemsize

    def take(self, rows: np.ndarray) -> np.ndarray:
        """Gather feature rows (vectorized splitmix-style hash -> [-1, 1))."""
        rows = np.asarray(rows, dtype=np.uint64)
        x = (rows[:, None] * np.uint64(0x9E3779B97F4A7C15)
             + self._cols[None, :] * np.uint64(0xBF58476D1CE4E5B9)
             + self._seed)
        x ^= x >> np.uint64(31)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(29)
        return ((x >> np.uint64(11)).astype(np.float64)
                / float(1 << 53) * 2.0 - 1.0).astype(self.dtype)

    def materialize(self, chunk_rows: int = 1 << 18) -> np.ndarray:
        """All rows as one array, hashed in chunks so the uint64/float64
        temporaries stay bounded (same bytes as ``take(arange(N))``)."""
        n, f = self.shape
        out = np.empty((n, f), dtype=self.dtype)
        for lo in range(0, n, chunk_rows):
            hi = min(lo + chunk_rows, n)
            out[lo:hi] = self.take(np.arange(lo, hi))
        return out

    def __getitem__(self, rows):
        return self.take(np.atleast_1d(rows))


@dataclasses.dataclass
class GraphDataset:
    name: str
    graph: CSRGraph
    features: "FeatureSource | np.ndarray"
    labels: np.ndarray          # int32 [num_nodes]
    num_classes: int
    feat_dim: int
    layer_dims: Tuple[int, int, int]   # (f0, f1, f2), Table III

    @property
    def num_nodes(self) -> int:
        return self.graph.num_nodes

    @property
    def num_edges(self) -> int:
        return self.graph.num_edges

    @property
    def feature_source(self) -> "FeatureSource":
        return as_feature_source(self.features)

    def take_features(self, rows: np.ndarray) -> np.ndarray:
        return self.feature_source.take(rows)

    def feature_hotness(self) -> np.ndarray:
        """Expected per-node gather frequency under neighbor sampling:
        in-edge mass (how often a node is a sampled neighbor) + 1 (a
        uniformly drawn batch target).  The hot cache ranks by it."""
        counts = np.bincount(
            np.asarray(self.graph.indices, dtype=np.int64),
            minlength=self.num_nodes).astype(np.float64)
        return counts + 1.0


def synth_powerlaw_graph(num_nodes: int, avg_degree: float,
                         seed: int = 0, hub_exponent: float = 2.5,
                         ) -> CSRGraph:
    """Vectorized synthetic power-law multigraph: Zipf-shaped out-degrees,
    destinations drawn toward hub nodes through ``floor(N * u**hub_exponent)``
    mapped by a random permutation.  O(E) time and memory."""
    rng = np.random.default_rng(seed)
    n = int(num_nodes)
    target_edges = int(round(n * avg_degree))
    raw = rng.pareto(1.3, size=n) + 1.0
    deg = np.maximum(1, np.round(raw * (target_edges / raw.sum()))
                     ).astype(np.int64)
    np.minimum(deg, max(8, n // 4), out=deg)
    m = int(deg.sum())
    u = rng.random(m)
    hub_rank = np.minimum((u ** hub_exponent * n).astype(np.int64), n - 1)
    perm = rng.permutation(n).astype(np.int64)
    dst = perm[hub_rank]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    idx_dtype = np.int32 if n < 2**31 else np.int64
    return CSRGraph(indptr=indptr, indices=dst.astype(idx_dtype))


# name -> (num_nodes, num_edges, f0, f1, f2, num_classes)   [Table III]
DATASET_STATS: Dict[str, Tuple[int, int, int, int, int, int]] = {
    "ogbn-products":    (2_449_029,    61_859_140,   100, 256,  47,  47),
    "ogbn-papers100M":  (111_059_956,  1_615_685_872, 128, 256, 172, 172),
    "mag240m-homo":     (121_751_666,  1_297_748_926, 756, 256, 153, 153),
}

# training-split sizes (OGB official splits; an "epoch" iterates these)
TRAIN_SPLIT: Dict[str, int] = {
    "ogbn-products": 196_615,
    "ogbn-papers100M": 1_207_179,
    "mag240m-homo": 1_112_392,
}


def make_dataset(name: str, scale: float = 1.0, seed: int = 0,
                 materialize_features: Optional[bool] = None,
                 feature_backend: str = "auto",
                 partition_rows: int = 65536,
                 spill_dir: Optional[str] = None,
                 mmap_lru_windows: int = 0) -> GraphDataset:
    """Instantiate a (possibly scaled-down) Table-III dataset.

    ``scale`` shrinks |V| while keeping the average degree and the feature
    widths.  ``feature_backend``: ``"dense"`` | ``"hashed"`` |
    ``"partitioned"`` | ``"mmap"`` (out-of-core: the features spilled to
    per-partition blobs under ``spill_dir`` — a private temp dir when None —
    with bounded spill RAM and lazily mapped windows) | ``"auto"`` (dense
    when the matrix fits 2 GiB, hashed otherwise).  ``mmap_lru_windows``
    bounds the mmap backend's open windows (0 = unbounded): the LRU evicts
    with ``MADV_DONTNEED``, so page-cache residency stays
    O(lru_windows x window_bytes).
    """
    if name not in DATASET_STATS:
        raise KeyError(f"unknown dataset {name!r}; have {list(DATASET_STATS)}")
    nv, ne, f0, f1, f2, ncls = DATASET_STATS[name]
    n = max(1000, int(nv * scale))
    avg_deg = ne / nv
    graph = synth_powerlaw_graph(n, avg_deg, seed=seed)
    if materialize_features is not None:
        feature_backend = "dense" if materialize_features else "hashed"
    if feature_backend == "auto":
        feature_backend = "dense" if n * f0 * 4 <= 2 * 2**30 else "hashed"
    hashed = HashedFeatures(n, f0, seed=seed)
    if feature_backend == "dense":
        feats: "FeatureSource | np.ndarray" = hashed.materialize()
    elif feature_backend == "hashed":
        feats = hashed
    elif feature_backend == "partitioned":
        feats = PartitionedFeatures.from_source(hashed,
                                                partition_rows=partition_rows)
    elif feature_backend == "mmap":
        feats = MmapFeatures.spill(hashed, spill_dir=spill_dir,
                                   partition_rows=partition_rows,
                                   lru_windows=mmap_lru_windows)
    else:
        raise ValueError(f"unknown feature_backend {feature_backend!r}")
    rng = np.random.default_rng(seed + 1)
    labels = rng.integers(0, ncls, size=n, dtype=np.int32)
    return GraphDataset(name=name, graph=graph, features=feats,
                        labels=labels, num_classes=ncls, feat_dim=f0,
                        layer_dims=(f0, f1, f2))
