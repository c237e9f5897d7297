"""The port's out-of-core storage tier against the JAX package's.

The same numpy inputs, made from a seed, go to ``repro.graph`` and to
``repro_torch.graph``: ``PartitionedFeatures`` and ``MmapFeatures`` return
rows bit-equal to each other and to the dense rows; the spill writes blobs
and a manifest with equal sha256 and each package opens the other's spill;
one seeded sequence of ``take`` / ``prefetch_rows`` / ``set_lru_windows``
calls leaves every storage counter and the window LRU's order equal after
every call (widths 100 and 2,100 f32: a 8,400-byte row spans three pages);
the same ``FaultInjector`` schedules give equal retry, fallback and hint
counters; ``make_dataset`` gives the reference's rows for every backend.
The cases of ``tests/test_storage_mmap.py`` that test the storage module
follow, run against the port."""
import errno
import gc
import glob
import hashlib
import json
import mmap as mmap_mod
import os

import hypothesis.strategies as st
import numpy as np
import pytest
import torch
from hypothesis import given, settings

import repro.graph as rg
import repro_torch.graph as tg
from repro_torch.graph import (DenseFeatures, FeatureCache, FeatureLoader,
                               HashedFeatures, MmapFeatures,
                               PartitionedFeatures, make_dataset)

# (width, rows): a 100-f32 row spans at most two pages, a 2,100-f32 row
# (8,400 B) spans three, the wide-row branch of the page accounting
SHAPES = [(100, 1500), (2100, 300)]
PART_ROWS = [1, 7, 1024]


def _requests(n, prows, seed):
    """Seeded requests: random with duplicates, every partition's first and
    last row, the reverse of that, and one single row."""
    rng = np.random.default_rng(seed)
    edges = []
    for lo in range(0, n, prows):
        edges += [lo, min(lo + prows, n) - 1]
    edges = np.asarray(edges, dtype=np.int64)
    return [rng.integers(0, n, 3 * n // 2).astype(np.int64),
            np.concatenate([edges, edges[::-1], [n - 1, n - 1, 0]]),
            np.array([n // 2], dtype=np.int64)]


def _sha(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


# ------------------------------------------------------------------ rows


@pytest.mark.parametrize("prows", PART_ROWS)
@pytest.mark.parametrize("f,n", SHAPES, ids=lambda x: str(x))
def test_rows_bit_equal_across_backends_and_packages(tmp_path, f, n, prows):
    rh, ph = rg.HashedFeatures(n, f, seed=3), tg.HashedFeatures(n, f, seed=3)
    dense = ph.take(np.arange(n))
    assert dense.tobytes() == rh.take(np.arange(n)).tobytes()
    srcs = {
        "ref_part": rg.PartitionedFeatures.from_source(rh, prows),
        "port_part": tg.PartitionedFeatures.from_source(ph, prows),
        "ref_mmap": rg.MmapFeatures.spill(rh, str(tmp_path / "r"), prows),
        "port_mmap": tg.MmapFeatures.spill(ph, str(tmp_path / "p"), prows),
    }
    for rows in _requests(n, prows, seed=prows + f):
        want = dense[rows].tobytes()
        for name, src in srcs.items():
            got = src.take(rows)
            assert got.dtype == np.float32 and got.shape == (rows.size, f)
            assert got.tobytes() == want, name
    empty = np.empty(0, dtype=np.int64)
    for name in ("ref_mmap", "port_mmap"):
        out = srcs[name].take(empty)
        assert out.shape == (0, f) and out.dtype == np.float32
        for bad in (n, -1):
            with pytest.raises(IndexError):
                srcs[name].take(np.array([bad], dtype=np.int64))
    assert srcs["port_part"].take(empty).shape == (0, f)
    assert srcs["port_part"].num_partitions == -(-n // prows)
    for name in ("ref_mmap", "port_mmap"):
        srcs[name].close()


# ------------------------------------------------------------ spill files


@pytest.mark.parametrize("prows", [7, 1024])
def test_spill_files_equal_and_cross_readable(tmp_path, prows):
    n, f = 1500, 100
    rd, pd = str(tmp_path / "ref"), str(tmp_path / "port")
    ref = rg.MmapFeatures.spill(rg.HashedFeatures(n, f, seed=1), rd, prows)
    port = tg.MmapFeatures.spill(tg.HashedFeatures(n, f, seed=1), pd, prows)
    names = sorted(os.listdir(rd))
    assert names == sorted(os.listdir(pd))
    assert "manifest.json" in names
    assert len([x for x in names if x.startswith("part-")]) == -(-n // prows)
    for name in names:
        assert _sha(os.path.join(rd, name)) == _sha(os.path.join(pd, name)), \
            name
    assert port.spill_peak_buffered_rows == ref.spill_peak_buffered_rows
    assert 0 < port.spill_peak_buffered_rows <= prows
    rows = np.random.default_rng(0).integers(0, n, 900).astype(np.int64)
    want = ref.take(rows).tobytes()
    for src in (tg.MmapFeatures(rd), rg.MmapFeatures(pd)):
        assert src.shape == (n, f) and src.partition_rows == prows
        assert src.take(rows).tobytes() == want
        src.close()


# --------------------------------------------------------------- counters

COUNTERS = ("touched_page_bytes", "last_gather_page_bytes",
            "prefetched_window_bytes", "cold_fault_page_bytes",
            "window_evictions", "evicted_window_bytes",
            "pin_blocked_evictions", "prefetch_hit_windows",
            "prefetch_miss_windows", "gather_windows_touched",
            "open_windows", "resident_window_bytes", "prefetch_hit_rate",
            "madvise_calls", "madvise_dontneed_calls", "madvise_failures",
            "lru_windows")


def _state(src):
    return ({c: getattr(src, c) for c in COUNTERS}, list(src._parts),
            sorted(src._pinned), sorted(src._prefetched))


def _ops(n, prows, seed, steps=60):
    """A seeded sequence of storage calls: gathers and prefetches of a few
    windows each (so the LRU sees reuse), and occasional re-bounds."""
    rng = np.random.default_rng(seed)
    nparts = -(-n // prows)
    out = []
    for _ in range(steps):
        kind = rng.choice(["take", "prefetch", "lru"], p=[0.5, 0.4, 0.1])
        if kind == "lru":
            out.append(("lru", int(rng.integers(0, 5))))
            continue
        pids = rng.choice(nparts, size=int(rng.integers(1, 4)))
        lo = pids * prows
        rows = np.concatenate([
            p + rng.integers(0, min(prows, n - p), int(rng.integers(1, 40)))
            for p in lo]).astype(np.int64)
        out.append((kind, rows))
    return out


@pytest.mark.parametrize("lru", [0, 1, 3])
@pytest.mark.parametrize("f,n", SHAPES, ids=lambda x: str(x))
def test_storage_counters_equal_after_every_call(tmp_path, f, n, lru):
    prows = 64 if f == 100 else 16
    base = rg.MmapFeatures.spill(rg.HashedFeatures(n, f, seed=2),
                                 str(tmp_path / "s"), prows)
    base.close()
    ref = rg.MmapFeatures(base.spill_dir, lru_windows=lru)
    port = tg.MmapFeatures(base.spill_dir, lru_windows=lru)
    assert _state(ref) == _state(port)
    for i, (kind, arg) in enumerate(_ops(n, prows, seed=lru * 7 + f)):
        if kind == "take":
            a, b = ref.take(arg), port.take(arg)
            assert a.tobytes() == b.tobytes()
        elif kind == "prefetch":
            assert ref.prefetch_rows(arg) == port.prefetch_rows(arg)
        else:
            ref.set_lru_windows(arg)
            port.set_lru_windows(arg)
        assert _state(ref) == _state(port), (i, kind)
    assert port.window_evictions > 0 or lru == 0
    ref.reset_prefetch_stats()
    port.reset_prefetch_stats()
    assert _state(ref) == _state(port)
    ref.close()
    port.close()


# ---------------------------------------------------------- failure model

def _pkg_pair(tmp_path, spec, prows=64, n=600, f=32, **attrs):
    """One spill per package, each with its own package's injector built
    from the same schedule; ``attrs`` are set on both sources."""
    out = []
    for pkg, name in ((rg, "ref"), (tg, "port")):
        inj = pkg.FaultInjector([spec], seed=0)
        src = pkg.MmapFeatures.spill(pkg.HashedFeatures(n, f, seed=5),
                                     str(tmp_path / name), prows,
                                     fault_injector=inj)
        for k, v in attrs.items():
            setattr(src, k, v)
        out.append((src, inj))
    return out


FAULT_COUNTERS = ("io_errors", "io_retries", "io_retry_seconds",
                  "fallback_gathers", "fallback_rows", "madvise_failures",
                  "madvise_calls", "fadvise_failures", "touched_page_bytes")


def _faults(src):
    return {c: getattr(src, c) for c in FAULT_COUNTERS}


@pytest.mark.parametrize("case", ["transient", "fallback", "madvise"])
def test_failure_model_counters_equal(tmp_path, case):
    spec = {"transient": dict(op="storage.take", kind="transient",
                              start=0, count=2),
            "fallback": dict(op="storage.take", kind="permanent", start=3),
            "madvise": dict(op="storage.madvise", kind="permanent")}[case]
    (ref, rinj), (port, pinj) = _pkg_pair(tmp_path, spec)
    rows = np.random.default_rng(4).integers(0, 600, 400).astype(np.int64)
    want = rg.HashedFeatures(600, 32, seed=5).take(rows).tobytes()
    for _ in range(2):
        assert ref.take(rows).tobytes() == want
        assert port.take(rows).tobytes() == want
        assert _faults(ref) == _faults(port)
    assert rinj.report() == pinj.report()
    if case == "transient":
        assert port.io_retries == 2 and port.fallback_gathers == 0
    elif case == "fallback":
        assert port.fallback_gathers > 0
        assert port.fallback_rows < port.fallback_row_budget
    else:
        assert port.madvise_failures > 0 and port.madvise_calls == 0


def test_fallback_budget_exhaustion_equal(tmp_path):
    spec = dict(op="storage.take", kind="permanent")
    (ref, rinj), (port, pinj) = _pkg_pair(tmp_path, spec,
                                          fallback_row_budget=40)
    rows = np.arange(0, 600, 5, dtype=np.int64)
    errs = []
    for src in (ref, port):
        with pytest.raises(OSError, match="fallback gather budget") as ei:
            src.take(rows)
        errs.append(str(ei.value).replace(src.spill_dir, "<dir>"))
    assert errs[0] == errs[1]
    assert _faults(ref) == _faults(port)
    assert port.fallback_rows <= 40 and port.io_errors > 0
    assert rinj.report() == pinj.report()


def test_fadvise_failures_equal(tmp_path):
    spec = dict(op="storage.fadvise", kind="permanent", errno=errno.EBADF)
    (ref, _), (port, _) = _pkg_pair(tmp_path, spec)
    ref.drop_page_cache()
    port.drop_page_cache()
    assert port.fadvise_failures == ref.fadvise_failures \
        == port.num_partitions


def test_spill_enospc_equal_and_leaves_no_blob(tmp_path):
    msgs = []
    for pkg, name in ((rg, "ref"), (tg, "port")):
        inj = pkg.FaultInjector([pkg.FaultSpec(
            op="storage.spill", kind="permanent", start=2,
            errno=errno.ENOSPC)])
        spill = tmp_path / name
        with pytest.raises(OSError) as ei:
            pkg.MmapFeatures.spill(pkg.HashedFeatures(600, 32, seed=5),
                                   spill_dir=str(spill), partition_rows=64,
                                   fault_injector=inj)
        assert ei.value.errno == errno.ENOSPC
        msgs.append(str(ei.value).replace(str(spill), "<dir>"))
        assert glob.glob(str(spill / "part-*.bin")) == []
        assert not (spill / "manifest.json").exists()
    assert msgs[0] == msgs[1]
    assert f"after {2 * 64 * 32 * 4} bytes" in msgs[1]


def test_fault_schedule_json_loads_in_both_packages(tmp_path):
    sched = [dict(op="storage.take", kind="transient", start=3, count=2,
                  errno=errno.ENOSPC),
             dict(op="prefetch.worker", kind="kill", start=1),
             dict(op="storage.prefetch", kind="delay", delay=0.01,
                  probability=0.5)]
    ref = rg.FaultInjector(sched, seed=7)
    port = tg.FaultInjector(sched, seed=7)
    assert ref.to_json() == port.to_json()
    path = tmp_path / "schedule.json"
    path.write_text(ref.to_json())
    for pkg in (rg, tg):
        loaded = pkg.FaultInjector.from_json(str(path))
        assert loaded.to_json() == ref.to_json()
    assert [s.to_dict() for s in tg.FaultInjector.from_json(
        json.loads(ref.to_json())).schedule] == [s.to_dict()
                                                 for s in ref.schedule]

    # one probabilistic schedule fires on the same calls in both packages
    def pattern(pkg):
        inj = pkg.FaultInjector([dict(op="storage.take", count=300,
                                      probability=0.4)], seed=11)
        out = []
        for _ in range(300):
            try:
                inj.fire("storage.take")
                out.append(0)
            except OSError:
                out.append(1)
        return out, inj.report()
    assert pattern(rg) == pattern(tg)
    assert 0 < sum(pattern(tg)[0]) < 300


# ------------------------------------------------------------ make_dataset


@pytest.mark.parametrize("backend",
                         ["dense", "hashed", "partitioned", "mmap", "auto"])
def test_make_dataset_rows_equal_reference(tmp_path, backend):
    kw = dict(scale=0.001, seed=0, feature_backend=backend,
              partition_rows=300)
    if backend == "mmap":
        ref = rg.make_dataset("ogbn-products", spill_dir=str(tmp_path / "r"),
                              **kw)
        port = tg.make_dataset("ogbn-products",
                               spill_dir=str(tmp_path / "p"), **kw)
    else:
        ref = rg.make_dataset("ogbn-products", **kw)
        port = tg.make_dataset("ogbn-products", **kw)
    assert type(port.features).__name__ == type(ref.features).__name__
    assert np.array_equal(port.graph.indptr, ref.graph.indptr)
    assert np.array_equal(port.labels, ref.labels)
    rows = np.concatenate([np.arange(0, port.num_nodes, 3),
                           np.arange(port.num_nodes)[::-7]]).astype(np.int64)
    assert port.take_features(rows).tobytes() == \
        ref.take_features(rows).tobytes()
    if backend == "mmap":
        assert port.features.is_disk_resident
        assert port.features.lru_windows == 0


# ------------------------------- the reference's storage cases, on the port

N, F, PROWS = 1000, 32, 96  # deliberately ragged: 1000 % 96 != 0
_CACHED = None


def _sources():
    global _CACHED
    if _CACHED is None:
        hashed = HashedFeatures(N, F, seed=3)
        dense = DenseFeatures(hashed.take(np.arange(N)))
        mm = MmapFeatures.spill(hashed, partition_rows=PROWS)
        _CACHED = (dense, mm)
    return _CACHED


@pytest.fixture(scope="module")
def sources():
    return _sources()


@given(st.lists(st.integers(0, N - 1), min_size=0, max_size=400))
@settings(max_examples=30, deadline=None)
def test_mmap_parity_property(rows):
    dense, mm = _sources()
    rows = np.asarray(rows, dtype=np.int64)
    a, b = dense.take(rows), mm.take(rows)
    assert a.tobytes() == b.tobytes()
    assert a.dtype == b.dtype and a.shape == b.shape


def test_mmap_parity_partition_boundaries(sources):
    dense, mm = sources
    edges = []
    for pid in range(mm.num_partitions):
        lo = pid * PROWS
        edges += [lo, min(lo + PROWS, N) - 1]
    rows = np.array(edges + [N - 1, N - 1, 0] + edges[::-1], dtype=np.int64)
    assert dense.take(rows).tobytes() == mm.take(rows).tobytes()


def test_mmap_empty_request(sources):
    dense, mm = sources
    out = mm.take(np.empty(0, dtype=np.int64))
    assert out.shape == (0, F) and out.dtype == dense.dtype


def test_mmap_out_of_range_raises(sources):
    _, mm = sources
    with pytest.raises(IndexError):
        mm.take(np.array([N], dtype=np.int64))
    with pytest.raises(IndexError):
        mm.take(np.array([-1], dtype=np.int64))


def test_spill_reopen_round_trip(sources):
    dense, mm = sources
    reopened = MmapFeatures(mm.spill_dir)
    assert reopened.shape == mm.shape
    assert reopened.dtype == mm.dtype
    assert reopened.partition_rows == mm.partition_rows
    rows = np.arange(0, N, 3, dtype=np.int64)
    assert reopened.take(rows).tobytes() == dense.take(rows).tobytes()
    reopened.close()


def test_spill_bounded_ram_and_layout(sources):
    _, mm = sources
    assert 0 < mm.spill_peak_buffered_rows <= PROWS
    assert mm.num_partitions == -(-N // PROWS)
    assert mm.shape == (N, F)
    assert mm.nbytes_on_disk == N * F * 4
    last = mm._part(mm.num_partitions - 1)
    assert last.shape[0] == N - (mm.num_partitions - 1) * PROWS


def test_lazy_windows_and_touch_accounting(sources):
    _, mm = sources
    fresh = MmapFeatures(mm.spill_dir)
    assert fresh.resident_window_bytes == 0
    fresh.take(np.arange(8, dtype=np.int64))
    assert fresh.resident_window_bytes == PROWS * F * 4
    assert 0 < fresh.last_gather_page_bytes <= PROWS * F * 4 + 4096
    assert fresh.touched_page_bytes >= fresh.last_gather_page_bytes
    fresh.reset_touch_stats()
    assert fresh.touched_page_bytes == 0
    fresh.close()
    assert fresh.resident_window_bytes == 0


def test_madvise_random_on_window_open(sources):
    dense, mm = sources
    fresh = MmapFeatures(mm.spill_dir)
    assert fresh.madvise_calls == 0
    rows = np.arange(0, N, 7, dtype=np.int64)
    assert fresh.take(rows).tobytes() == dense.take(rows).tobytes()
    if hasattr(mmap_mod, "MADV_RANDOM"):
        assert fresh.madvise_calls == len(fresh._parts) > 0
        before = fresh.madvise_calls
        fresh.take(rows[:5])
        assert fresh.madvise_calls == before
    fresh.close()


def _window_nbytes(mm, pid):
    rows = min(mm.partition_rows, mm.shape[0] - pid * mm.partition_rows)
    return rows * mm.shape[1] * mm.dtype.itemsize


@given(st.integers(1, 5),
       st.lists(st.integers(0, -(-N // PROWS) - 1), min_size=1,
                max_size=60))
@settings(max_examples=30, deadline=None)
def test_window_lru_bound_order_and_accounting(k, pids):
    dense, base = _sources()
    mm = MmapFeatures(base.spill_dir, lru_windows=k)
    model: dict = {}
    expect_evicted = expect_count = 0
    for pid in pids:
        mm.take(np.array([pid * PROWS], dtype=np.int64))
        model.pop(pid, None)
        model[pid] = True
        while len(model) > k:
            old = next(iter(model))
            del model[old]
            expect_evicted += _window_nbytes(mm, old)
            expect_count += 1
        assert mm.open_windows == len(model) <= k
        assert list(mm._parts) == list(model)
    assert mm.evicted_window_bytes == expect_evicted
    assert mm.window_evictions == expect_count
    rows = np.arange(0, N, 3, dtype=np.int64)
    assert mm.take(rows).tobytes() == dense.take(rows).tobytes()
    assert mm.open_windows <= max(k, 1)
    mm.close()


def test_window_lru_eviction_issues_dontneed(sources):
    _, base = sources
    mm = MmapFeatures(base.spill_dir, lru_windows=1)
    for pid in range(3):
        mm.take(np.array([pid * PROWS], dtype=np.int64))
    assert mm.window_evictions == 2
    if hasattr(mmap_mod, "MADV_DONTNEED"):
        assert mm.madvise_dontneed_calls == 2
    mm.close()


def test_window_lru_tightened_after_open_trims_on_access(sources):
    _, base = sources
    mm = MmapFeatures(base.spill_dir)
    mm.take(np.arange(0, N, 7, dtype=np.int64))
    assert mm.open_windows == mm.num_partitions
    mm.lru_windows = 2
    mm.take(np.array([0], dtype=np.int64))
    assert mm.open_windows <= 2
    mm.close()


def test_window_lru_zero_is_unbounded(sources):
    _, base = sources
    mm = MmapFeatures(base.spill_dir)
    mm.take(np.arange(0, N, 7, dtype=np.int64))
    assert mm.window_evictions == 0
    assert mm.evicted_window_bytes == 0
    assert mm.open_windows == mm.num_partitions
    mm.close()


def test_prefetch_rows_warms_pages_and_counters(sources):
    dense, base = sources
    mm = MmapFeatures(base.spill_dir, lru_windows=4)
    rng = np.random.default_rng(11)
    rows = np.unique(rng.integers(0, 2 * PROWS, 120)).astype(np.int64)
    new = mm.prefetch_rows(rows)
    assert new > 0 and mm.prefetched_window_bytes == new
    cold0 = mm.cold_fault_page_bytes
    assert mm.take(rows).tobytes() == dense.take(rows).tobytes()
    assert mm.cold_fault_page_bytes == cold0
    assert mm.prefetch_hit_rate == 1.0
    mm.take(np.array([3 * PROWS], dtype=np.int64))
    assert mm.cold_fault_page_bytes > cold0
    assert mm.prefetch_miss_windows == 1
    assert mm.prefetch_rows(rows) == 0
    mm.reset_prefetch_stats()
    assert mm.prefetched_window_bytes == 0
    assert mm.prefetch_hit_rate == 0.0
    mm.close()


def test_prefetch_rows_out_of_range_raises(sources):
    _, base = sources
    mm = MmapFeatures(base.spill_dir)
    with pytest.raises(IndexError):
        mm.prefetch_rows(np.array([N], dtype=np.int64))
    assert mm.prefetch_rows(np.empty(0, dtype=np.int64)) == 0
    mm.close()


def test_eviction_makes_pages_cold_again(sources):
    dense, base = sources
    mm = MmapFeatures(base.spill_dir, lru_windows=1)
    rows = np.arange(8, dtype=np.int64)
    mm.take(rows)
    cold1 = mm.cold_fault_page_bytes
    mm.take(rows)
    assert mm.cold_fault_page_bytes == cold1
    mm.take(np.array([PROWS], dtype=np.int64))
    out = mm.take(rows)
    assert mm.cold_fault_page_bytes > cold1
    assert out.tobytes() == dense.take(rows).tobytes()
    mm.close()


def test_prefetch_pinned_window_survives_lru_pressure(sources):
    dense, base = sources
    mm = MmapFeatures(base.spill_dir, lru_windows=2)
    rng = np.random.default_rng(5)
    rows = np.unique(rng.integers(0, 2 * PROWS, 100)).astype(np.int64)
    mm.prefetch_rows(rows)
    mm.take(np.array([2 * PROWS], dtype=np.int64))
    mm.take(np.array([3 * PROWS], dtype=np.int64))
    assert 0 in mm._parts and 1 in mm._parts
    assert mm.pin_blocked_evictions >= 1
    assert mm.open_windows == 3
    cold0 = mm.cold_fault_page_bytes
    assert mm.take(rows).tobytes() == dense.take(rows).tobytes()
    assert mm.cold_fault_page_bytes == cold0
    assert mm.prefetch_hit_windows >= 2
    assert not mm._pinned
    mm.take(np.array([4 * PROWS], dtype=np.int64))
    assert mm.open_windows <= 2
    mm.close()


def test_unpinned_eviction_order_unchanged(sources):
    _, base = sources
    mm = MmapFeatures(base.spill_dir, lru_windows=2)
    for pid in range(4):
        mm.take(np.array([pid * PROWS], dtype=np.int64))
        assert mm.open_windows <= 2
    assert mm.window_evictions == 2
    assert mm.pin_blocked_evictions == 0
    mm.close()


def test_owned_tempdir_spill_cleans_up_on_gc():
    mm = MmapFeatures.spill(HashedFeatures(64, 4, seed=0), partition_rows=16)
    spill = mm.spill_dir
    assert os.path.exists(os.path.join(spill, "manifest.json"))
    del mm
    gc.collect()
    assert not os.path.exists(spill)


def test_reopen_rejects_non_spill_dir(tmp_path):
    with pytest.raises(FileNotFoundError):
        MmapFeatures(str(tmp_path))
    (tmp_path / "manifest.json").write_text(json.dumps({"format": "x"}))
    with pytest.raises(ValueError, match="mmap-features-v1"):
        MmapFeatures(str(tmp_path))


def test_partitioned_from_dense_array():
    arr = np.random.default_rng(0).standard_normal((50, 6)).astype(
        np.float32)
    pf = PartitionedFeatures.from_source(arr, partition_rows=8)
    assert pf.num_partitions == 7 and pf.nbytes == arr.nbytes
    rows = np.array([49, 0, 8, 7, 7, 31], dtype=np.int64)
    assert np.array_equal(pf.take(rows), arr[rows])
    assert np.array_equal(pf[3], arr[[3]])
    with pytest.raises(ValueError):
        PartitionedFeatures([], 8, 0)


def test_feature_cache_over_mmap(sources):
    dense, mm = sources
    hotness = np.arange(N, 0, -1, dtype=np.float64)  # node 0 hottest
    cache = FeatureCache(mm, hotness, capacity=64)
    assert np.array_equal(np.sort(cache.cached_ids), np.arange(64))
    ids = np.array([0, 63, 64, N - 1, 0, 500], dtype=np.int64)
    look = cache.lookup(ids)
    hit = look.slots >= 0
    got = np.empty((ids.shape[0], F), np.float32)
    got[hit] = cache.host_rows[torch.from_numpy(look.slots[hit])].numpy()
    got[~hit] = mm.take(look.miss_ids)[look.miss_index[~hit]]
    assert np.array_equal(got, dense.take(ids))


def test_make_dataset_mmap_matches_dense(tmp_path):
    kw = dict(scale=0.001, seed=0, partition_rows=512)
    ds_m = make_dataset("ogbn-products", feature_backend="mmap",
                        spill_dir=str(tmp_path / "spill"), **kw)
    ds_d = make_dataset("ogbn-products", feature_backend="dense",
                        scale=0.001, seed=0)
    assert isinstance(ds_m.features, MmapFeatures)
    rows = np.arange(0, ds_m.num_nodes, 7, dtype=np.int64)
    assert np.array_equal(ds_m.take_features(rows), ds_d.take_features(rows))


def test_loader_partition_aligned_chunks_disjoint(tmp_path):
    ds = make_dataset("ogbn-products", scale=0.002, seed=0,
                      feature_backend="mmap",
                      spill_dir=str(tmp_path / "spill"), partition_rows=256)
    loader = FeatureLoader(ds, num_threads=4)
    rng = np.random.default_rng(1)
    rows = rng.integers(0, ds.num_nodes, 4000).astype(np.int64)
    chunks, order = loader._split_chunks(rows)
    assert order is not None
    touched = [set(np.unique(c // 256).tolist()) for c in chunks]
    for i in range(len(touched)):
        for j in range(i + 1, len(touched)):
            assert not (touched[i] & touched[j]), "windows overlap"
    assert sum(c.shape[0] for c in chunks) == rows.shape[0]
    assert np.array_equal(loader._gather(rows), ds.take_features(rows))
    loader.close()


def test_loader_unpartitioned_split_unchanged():
    ds = make_dataset("ogbn-products", scale=0.001, seed=0,
                      feature_backend="dense")
    loader = FeatureLoader(ds, num_threads=3)
    rows = np.arange(300, dtype=np.int64)[::-1].copy()
    chunks, order = loader._split_chunks(rows)
    assert order is None
    assert np.array_equal(np.concatenate(chunks), rows)
    assert np.array_equal(loader._gather(rows), ds.take_features(rows))
    loader.close()
