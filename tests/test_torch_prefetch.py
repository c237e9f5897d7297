"""The port's window prefetcher, fault hooks and disk-tier trainer paths
against the JAX package's.

The reference's ``tests/test_prefetch.py`` and the storage and prefetch
cases of ``tests/test_faults.py`` run against the port; one submit sequence
goes to both packages' ``WindowPrefetcher`` over a recording source and
leaves the same recorded rows and counters; the loader's partition-aligned
split equals the reference's; the trainer over an mmap spill (scale 0.003,
layers (100, 64, 47), fanouts (4, 3), 1,024-row partitions, the host
sampler) gives losses within 1e-4 of the reference's (the tolerance of
``tests/test_torch_trainer.py``), the same initial assignment on the disk
tier, equal feature traffic and the reference's ``storage_io()`` and
``health()`` keys; inside the port, losses are bit-identical across dense,
mmap, mmap with prefetch, and mmap with prefetch and a window LRU bound; a
deleted blob degrades the prefetcher alike in both packages."""
import errno
import json
import os
import threading
import time

import numpy as np
import pytest

import repro.core as rc
import repro.graph as rg
import repro_torch.core as tc
import repro_torch.graph as tg
from repro.graph.featload import FeatureLoader as RefLoader
from repro_torch.core import HybridConfig, HybridGNNTrainer
from repro_torch.core.perfmodel import (PLATFORMS, WorkloadSpec,
                                        initial_task_mapping, t_load)
from repro_torch.core.pipeline import PipelineItem, PrefetchPipeline, Stage
from repro_torch.graph import (DenseFeatures, FaultInjector, FaultSpec,
                               FeatureCache, FeatureLoader, GNNConfig,
                               HashedFeatures, LoadStats, MmapFeatures,
                               NumpySampler, WindowPrefetcher, WorkerKilled,
                               build_cache, make_dataset)

N, F, PROWS = 600, 32, 64


def _mmap_pair(tmp_path, name="spill", lru=0, injector=None):
    hashed = HashedFeatures(N, F, seed=5)
    dense = DenseFeatures(hashed.take(np.arange(N)))
    mm = MmapFeatures.spill(hashed, spill_dir=str(tmp_path / name),
                            partition_rows=PROWS, lru_windows=lru,
                            fault_injector=injector)
    return dense, mm


class _StubSource:
    """Minimal prefetchable source for error/queue tests."""

    shape = (N, F)

    def __init__(self, delay=0.0, fail=False):
        self.calls = 0
        self.delay = delay
        self.fail = fail
        self.window_evictions = 0
        self.seen = []                  # rows each worker call received

    def prefetch_rows(self, rows):
        self.calls += 1
        self.seen.append(np.asarray(rows).copy())
        if self.delay:
            time.sleep(self.delay)
        if self.fail:
            raise RuntimeError("spill blob gone")


# ------------------------------------------------ parity with the reference


class _Gated(_StubSource):
    """Records every worker call; the worker waits at ``gate``."""

    def __init__(self):
        super().__init__()
        self.gate = threading.Event()
        self.gate.set()

    def prefetch_rows(self, rows):
        self.gate.wait(30.0)
        _StubSource.prefetch_rows(self, rows)


def _drive(pkg):
    """One seeded submit sequence: dedup with evictions moving on the
    source, then a blocked worker under a full queue (drops)."""
    src = _Gated()
    pf = pkg.WindowPrefetcher(src, max_queue=2, dedup_history=2)
    rng = np.random.default_rng(9)
    ok = []
    for i in range(14):
        rows = np.unique(rng.integers(0, 300, 120))
        if i % 5 == 4:
            src.window_evictions += 1
        ok.append(pf.submit(rows))
        assert pf.wait_idle(30.0)
    src.gate.clear()
    ok.append(pf.submit(np.arange(500, 520)))   # the worker takes it, waits
    for _ in range(500):
        if pf._q.empty():
            break
        time.sleep(0.01)
    for i in range(6):                          # 2 queue, 4 drop
        ok.append(pf.submit(np.unique(rng.integers(0, 600, 50)) + i))
    src.gate.set()
    assert pf.wait_idle(30.0)
    out = dict(ok=ok, seen=[s.tolist() for s in src.seen],
               dropped=pf.dropped, skipped=pf.resubmitted_rows_skipped,
               submitted=pf.submitted, completed=pf.completed)
    pf.close()
    return out


def test_prefetcher_submit_sequence_matches_reference():
    ref, port = _drive(rg), _drive(tg)
    assert port == ref
    assert port["dropped"] == 4 and port["skipped"] > 0


def test_split_chunks_match_reference(tmp_path):
    ref = rg.make_dataset("ogbn-products", scale=0.002, seed=0,
                          feature_backend="mmap", partition_rows=256,
                          spill_dir=str(tmp_path / "r"))
    port = tg.make_dataset("ogbn-products", scale=0.002, seed=0,
                           feature_backend="mmap", partition_rows=256,
                           spill_dir=str(tmp_path / "p"))
    rng = np.random.default_rng(2)
    for threads in (2, 3, 4, 7):
        rl, pl = RefLoader(ref, num_threads=threads), \
            FeatureLoader(port, num_threads=threads)
        for n in (14, 500, 4000):
            rows = rng.integers(0, port.num_nodes, n).astype(np.int64)
            (rch, ro), (pch, po) = rl._split_chunks(rows), \
                pl._split_chunks(rows)
            assert np.array_equal(ro, po)
            assert [c.tolist() for c in rch] == [c.tolist() for c in pch]
            assert pl._gather(rows).tobytes() == rl._gather(rows).tobytes()
        rl.close()
        pl.close()


G = dict(model="sage", layer_dims=(100, 64, 47), fanouts=(4, 3),
         num_classes=47, agg_impl="pallas_fused")
PARITY = dict(total_batch=256, n_accel=1, hybrid=True, use_drm=False,
              tfp_depth=2, seed=0, cache_fraction=0.2,
              use_accel_sampler=False, accel_platform="rtx-a5000",
              cache_drift_threshold=1.0)


@pytest.mark.parametrize("knobs", [
    {}, {"prefetch_windows": 4},
    {"prefetch_windows": 4, "mmap_lru_windows": 3}],
    ids=["cold", "prefetch", "prefetch_lru"])
def test_trainer_over_mmap_matches_reference(tmp_path, knobs):
    def ds(pkg, name):
        return pkg.make_dataset("ogbn-products", scale=0.003, seed=0,
                                feature_backend="mmap", partition_rows=1024,
                                spill_dir=str(tmp_path / name))
    cfg = dict(PARITY, **knobs)
    ref = rc.HybridGNNTrainer(ds(rg, "r"), rg.GNNConfig(**G),
                              rc.HybridConfig(**cfg))
    port = tc.HybridGNNTrainer(ds(tg, "p"), tg.GNNConfig(**G),
                               tc.HybridConfig(**cfg), device="cpu")
    port.set_params({k: np.asarray(v) for k, v in ref.params.items()})
    assert ref.feature_tier == port.feature_tier == "disk"
    assert port.prefetch_overlap == ref.prefetch_overlap
    ra, pa = ref.runtime.assignment, port.runtime.assignment
    assert (pa.cpu_batch, pa.accel_batch) == (ra.cpu_batch, ra.accel_batch)
    want = initial_task_mapping(
        PLATFORMS["epyc-7763"], PLATFORMS["rtx-a5000"], 1, 256,
        (4, 3), (100, 64, 47), model="sage",
        cache_hit_rate=port.cache.expected_hit_rate,
        dedup_factor=port.measured_dedup_alpha, feature_tier="disk",
        prefetch_overlap=port.prefetch_overlap)
    assert (pa.cpu_batch, pa.accel_batch) == (want["cpu"],
                                              want["accel_each"])
    assert port.dataset.features.lru_windows == \
        knobs.get("mmap_lru_windows", 0)
    rh, ph = ref.train(4), port.train(4)
    assert [m.assignment for m in rh] == [m.assignment for m in ph]
    np.testing.assert_allclose([m.loss for m in ph], [m.loss for m in rh],
                               rtol=0, atol=1e-4)
    rt, pt = ref.feature_traffic(), port.feature_traffic()
    assert {k: rt[k] for k in pt} == pt
    assert set(port.storage_io()) == set(ref.storage_io())
    rhl, phl = ref.health(), port.health()
    assert phl["status"] == rhl["status"] == "ok"
    assert set(phl["components"]) == set(rhl["components"])
    for comp, fields in rhl["components"].items():
        assert set(phl["components"][comp]) == set(fields)
    assert all(m.times.t_load_stall >= 0.0 for m in ph)
    if knobs:
        assert port.storage_io()["prefetch_submitted"] == 4.0
    ref.close()
    port.close()


# -------------------------------------------- bit identity inside the port


def _gnn(ds, fanouts=(4, 3)):
    return GNNConfig(model="sage", layer_dims=ds.layer_dims,
                     fanouts=fanouts, num_classes=ds.num_classes)


def _port_trainer(tmp_path, backend, name, **knobs):
    kw = ({} if backend == "dense" else
          dict(spill_dir=str(tmp_path / name), partition_rows=1024))
    ds = make_dataset("ogbn-products", scale=0.003, seed=0,
                      feature_backend=backend, **kw)
    cfg = dict(total_batch=128, n_accel=2, hybrid=False, use_drm=False,
               tfp_depth=2, seed=0, cache_fraction=0.2,
               use_accel_sampler=False)
    cfg.update(knobs)
    return HybridGNNTrainer(ds, GNNConfig(**G), HybridConfig(**cfg),
                            device="cpu")


def _run_port(tmp_path, backend, name, iters=4, **knobs):
    tr = _port_trainer(tmp_path, backend, name, **knobs)
    hist = tr.train(iters)
    tr.close()
    return [m.loss for m in hist], tr


def test_port_losses_bit_identical_dense_mmap_prefetch_lru(tmp_path):
    dense, trd = _run_port(tmp_path, "dense", "d")
    mm, trm = _run_port(tmp_path, "mmap", "m")
    pf, trp = _run_port(tmp_path, "mmap", "p", prefetch_windows=4)
    lru, trl = _run_port(tmp_path, "mmap", "l", prefetch_windows=4,
                         mmap_lru_windows=3)
    assert dense == mm == pf == lru
    assert trd.feature_tier == "ram"
    assert trm.feature_tier == trp.feature_tier == trl.feature_tier == "disk"
    assert trm.dataset.features.touched_page_bytes > 0
    io = trl.storage_io()
    assert io["prefetch_submitted"] > 0 and io["window_evictions"] > 0
    assert io["open_windows"] <= 3 + io["pin_blocked_evictions"]
    assert trd.storage_io()["prefetched_window_bytes"] == 0.0
    assert trd.feature_traffic() == trl.feature_traffic()


def test_port_hybrid_losses_bit_identical_prefetch_off_on_bounded(tmp_path):
    """The hybrid mapping prices the disk tier by the prefetch overlap (0
    with prefetch off, 1 with it on), so the three runs start from
    different model shares; run (a) takes (b)'s shares, and then the
    prefetcher and the window bound change no bit of the losses."""
    knobs = dict(hybrid=True, n_accel=1, total_batch=256,
                 cache_drift_threshold=1.0)
    trs = [_port_trainer(tmp_path, "mmap", name, **knobs, **extra)
           for name, extra in (("a", {}), ("b", dict(prefetch_windows=4)),
                               ("c", dict(prefetch_windows=4,
                                          mmap_lru_windows=3)))]
    shares = [(t.runtime.assignment.cpu_batch,
               t.runtime.assignment.accel_batch) for t in trs]
    assert [t.prefetch_overlap for t in trs] == [0.0, 1.0, 1.0]
    assert shares[1] == shares[2] and shares[1][0] > 0
    trs[0].runtime.assignment.cpu_batch = shares[1][0]
    trs[0].runtime.assignment.accel_batch = shares[1][1]
    losses, trained = [], []
    for t in trs:
        hist = t.train(4)
        t.close()
        losses.append([m.loss for m in hist])
        trained.append([m.shares for m in hist])
    assert trained[0] == trained[1] == trained[2]
    assert all(s["cpu"] > 0 for s in trained[0])
    assert losses[0] == losses[1] == losses[2]


def test_hybrid_mapping_prices_disk_tier(tmp_path):
    ds = make_dataset("ogbn-products", scale=0.003, seed=0,
                      feature_backend="mmap",
                      spill_dir=str(tmp_path / "spill"), partition_rows=1024)
    cfg = HybridConfig(total_batch=256, n_accel=2, hybrid=True,
                       use_drm=True, tfp_depth=2, share_quantum=32, seed=0,
                       cache_fraction=0.2, use_accel_sampler=False)
    tr = HybridGNNTrainer(ds, GNNConfig(**G), cfg, device="cpu")
    assert tr.feature_tier == "disk"
    hist = tr.train(4)
    assert all(np.isfinite(m.loss) for m in hist)
    for m in hist:
        cpu_b, accel_b = m.assignment
        assert cpu_b + accel_b * cfg.n_accel == cfg.total_batch
    tr.close()


# -------------------------------------------- degraded modes, both packages


def _degrade_run(pkg, core, tmp_path, name, delete, **over):
    ds = pkg.make_dataset("ogbn-products", scale=0.003, seed=0,
                          feature_backend="mmap", partition_rows=1024,
                          spill_dir=str(tmp_path / name))
    if delete:
        os.remove(os.path.join(ds.features.spill_dir, "part-00001.bin"))
    cfg = dict(PARITY, prefetch_windows=2, prefetch_restart_budget=0,
               **over)
    kw = {"device": "cpu"} if core is tc else {}
    tr = core.HybridGNNTrainer(ds, pkg.GNNConfig(**G),
                               core.HybridConfig(**cfg), **kw)
    return tr


def test_deleted_blob_degrades_prefetcher_in_both_packages(tmp_path):
    runs = {}
    w0 = None
    for pkg, core, name, delete in ((rg, rc, "r", True), (tg, tc, "p", True),
                                    (tg, tc, "clean", False)):
        tr = _degrade_run(pkg, core, tmp_path, name, delete=delete)
        if w0 is None:
            w0 = {k: np.asarray(v) for k, v in tr.params.items()}
        else:
            tr.set_params(w0)
        hist = tr.train(6)
        tr.close()
        runs[name] = (tr, [m.loss for m in hist])
    (ref, rl), (port, pl), (clean, cl) = runs["r"], runs["p"], runs["clean"]
    assert port.prefetcher.failed and ref.prefetcher.failed
    rh, ph = ref.health(), port.health()
    assert ph["degraded"] == rh["degraded"] == ["prefetcher"]
    assert ph["status"] == "degraded"
    (ev,) = ph["events"]
    assert "synchronously" in ev["action"]
    assert port._measured_prefetch_overlap() == 0.0
    # the load path's fallback gathers the deleted window's rows from the
    # spill's backing source: the same bytes, so the same losses
    assert port.storage_io()["fallback_gathers"] > 0
    assert ph["components"]["storage"]["fallback_rows"] > 0
    np.testing.assert_allclose(pl, rl, rtol=0, atol=1e-4)
    assert pl == cl
    assert clean.health()["status"] == "ok"


def test_fail_fast_close_raises_in_both_packages(tmp_path):
    for pkg, core, name in ((rg, rc, "r"), (tg, tc, "p")):
        tr = _degrade_run(pkg, core, tmp_path, name, delete=False,
                          degrade_on_failure=False)
        tr.prefetcher.error = RuntimeError("late prefetch failure")
        with pytest.raises(RuntimeError, match="prefetch worker failed"):
            tr.close()
        tr.close()              # the latch raised once: idempotent now


# ---------------------------------- the reference's prefetch cases, ported


def test_prefetcher_prefaults_and_gather_is_warm(tmp_path):
    dense, mm = _mmap_pair(tmp_path)
    rows = np.random.default_rng(0).integers(0, N, 400).astype(np.int64)
    pf = WindowPrefetcher(mm, max_queue=4)
    assert pf.submit(rows)
    assert pf.wait_idle(30.0)
    assert pf.completed == 1
    assert mm.prefetched_window_bytes > 0
    cold0 = mm.cold_fault_page_bytes
    out = mm.take(rows)
    assert mm.cold_fault_page_bytes == cold0
    assert mm.prefetch_hit_rate == 1.0
    assert out.tobytes() == dense.take(rows).tobytes()
    pf.close()


def test_prefetcher_requires_prefetchable_source():
    with pytest.raises(TypeError, match="prefetch_rows"):
        WindowPrefetcher(DenseFeatures(np.zeros((8, 4), np.float32)))


def test_prefetcher_full_queue_drops_not_blocks():
    pf = WindowPrefetcher(_StubSource(delay=0.2), max_queue=1)
    sent = [pf.submit(np.arange(4)) for _ in range(8)]
    assert sent[0] and not all(sent)
    assert pf.dropped == sent.count(False) > 0
    assert pf.wait_idle(30.0)
    pf.close()


def test_dedup_strips_already_warm_rows():
    src = _StubSource()
    pf = WindowPrefetcher(src, max_queue=4, dedup_history=2)
    a, b = np.arange(0, 100), np.arange(50, 150)
    assert pf.submit(a) and pf.wait_idle(30.0)
    assert pf.submit(b) and pf.wait_idle(30.0)
    assert pf.resubmitted_rows_skipped == 50
    assert np.array_equal(src.seen[0], a)
    assert np.array_equal(src.seen[1], np.arange(100, 150))
    assert pf.submit(np.arange(120, 140))
    assert pf.wait_idle(30.0)
    assert src.calls == 2
    assert pf.resubmitted_rows_skipped == 70
    pf.close()


def test_dedup_history_window_ages_out():
    src = _StubSource()
    pf = WindowPrefetcher(src, max_queue=4, dedup_history=1)
    a, b = np.arange(0, 50), np.arange(50, 100)
    for rows in (a, b, a):
        assert pf.submit(rows) and pf.wait_idle(30.0)
    assert src.calls == 3
    assert np.array_equal(src.seen[2], a)
    assert pf.resubmitted_rows_skipped == 0
    pf.close()


def test_dedup_history_clears_on_source_eviction():
    src = _StubSource()
    pf = WindowPrefetcher(src, max_queue=4, dedup_history=4)
    rows = np.arange(0, 80)
    assert pf.submit(rows) and pf.wait_idle(30.0)
    src.window_evictions += 1
    assert pf.submit(rows) and pf.wait_idle(30.0)
    assert src.calls == 2
    assert np.array_equal(src.seen[1], rows)
    assert pf.resubmitted_rows_skipped == 0
    pf.close()


class _RacingSource(_StubSource):
    """``window_evictions`` moves between submit()'s pre-strip read and its
    post-strip re-check (reads: 1 init, 2 submit(a), 3-4 submit(b))."""

    def __init__(self):
        self._ev_reads = 0
        super().__init__()

    @property
    def window_evictions(self):
        self._ev_reads += 1
        return 0 if self._ev_reads < 4 else 1

    @window_evictions.setter
    def window_evictions(self, v):
        pass


def test_eviction_during_dedup_strip_falls_back_to_full_rows():
    src = _RacingSource()
    pf = WindowPrefetcher(src, max_queue=4, dedup_history=2)
    a, b = np.arange(0, 100), np.arange(50, 150)
    assert pf.submit(a) and pf.wait_idle(30.0)
    assert pf.submit(b) and pf.wait_idle(30.0)
    assert np.array_equal(src.seen[1], b)
    assert pf.resubmitted_rows_skipped == 0
    assert pf.submit(a) and pf.wait_idle(30.0)
    assert np.array_equal(src.seen[2], np.arange(0, 50))
    assert pf.resubmitted_rows_skipped == 50
    pf.close()


def test_dedup_off_by_default():
    src = _StubSource()
    pf = WindowPrefetcher(src, max_queue=4)
    rows = np.arange(0, 30)
    assert pf.submit(rows) and pf.wait_idle(30.0)
    assert pf.submit(rows) and pf.wait_idle(30.0)
    assert src.calls == 2
    assert pf.resubmitted_rows_skipped == 0
    pf.close()


def test_dropped_submit_leaves_no_warm_marks():
    src = _Gated()
    src.gate.clear()
    pf = WindowPrefetcher(src, max_queue=1, dedup_history=4)
    assert pf.submit(np.arange(0, 10))
    for _ in range(500):
        if pf._q.empty():
            break
        time.sleep(0.01)
    assert pf.submit(np.arange(10, 20))
    fresh = np.arange(100, 160)
    assert not pf.submit(fresh)
    src.gate.set()
    assert pf.wait_idle(30.0)
    assert pf.submit(fresh)
    assert pf.wait_idle(30.0)
    assert any(np.array_equal(s, fresh) for s in src.seen)
    pf.close()


def test_dedup_real_mmap_cuts_prefetch_volume(tmp_path):
    dense, mm = _mmap_pair(tmp_path, name="spill-dedup")
    rng = np.random.default_rng(3)
    a = rng.integers(0, N // 2, 200).astype(np.int64)
    b = np.concatenate([a[:100], rng.integers(N // 2, N, 100)])
    pf = WindowPrefetcher(mm, max_queue=4, dedup_history=2)
    assert pf.submit(np.unique(a)) and pf.wait_idle(30.0)
    assert pf.submit(np.unique(b)) and pf.wait_idle(30.0)
    assert pf.resubmitted_rows_skipped > 0
    assert mm.take(b).tobytes() == dense.take(b).tobytes()
    assert mm.prefetch_hit_rate == 1.0
    pf.close()


def test_prefetcher_error_latches_and_raises_on_next_submit(tmp_path):
    _, mm = _mmap_pair(tmp_path, name="spill-err")
    os.remove(os.path.join(mm.spill_dir, MmapFeatures._part_name(1)))
    pf = WindowPrefetcher(mm, max_queue=4)
    bad = np.arange(PROWS, 2 * PROWS, dtype=np.int64)
    assert pf.submit(bad)
    assert pf.wait_idle(30.0)
    assert pf.error is not None
    with pytest.raises(RuntimeError, match="prefetch worker failed"):
        pf.submit(bad)
    pf.close()


def test_prefetcher_error_surfaces_through_pipeline_without_deadlock():
    pf = WindowPrefetcher(_StubSource(fail=True), max_queue=2)
    produced = []

    def gen(n):
        for i in range(n):
            produced.append(i)
            yield PipelineItem(seq=i, payload=i)

    def sample(item):
        pf.submit(np.arange(4))
        time.sleep(0.005)
        return item

    pipe = PrefetchPipeline([Stage("sample", sample)], depth=2)
    with pytest.raises(RuntimeError, match="prefetch worker failed"):
        list(pipe.run(gen(100)))
    assert len(produced) < 50
    pf.close()
    pf2 = WindowPrefetcher(_StubSource(), max_queue=2)

    def sample2(item):
        pf2.submit(np.arange(4))
        return item

    pipe2 = PrefetchPipeline([Stage("sample", sample2)], depth=2)
    assert [it.seq for it in pipe2.run(
        PipelineItem(seq=i, payload=i) for i in range(5))] == list(range(5))
    pf2.close()


def test_prefetcher_close_idempotent_under_half_drained_queue():
    pf = WindowPrefetcher(_StubSource(delay=0.1), max_queue=8)
    for _ in range(6):
        pf.submit(np.arange(4))
    t0 = time.perf_counter()
    pf.close()
    pf.close()
    assert time.perf_counter() - t0 < 10.0
    assert not pf._thread.is_alive()
    assert not pf.submit(np.arange(4))


def test_prefetcher_wait_idle_reports_completion():
    pf = WindowPrefetcher(_StubSource(delay=0.05), max_queue=4)
    pf.submit(np.arange(4))
    assert not pf.wait_idle(0.001)
    assert pf.wait_idle(30.0)
    assert pf.completed == pf.submitted == 1
    pf.resize(1)
    assert pf.max_queue == 1 and pf._q.maxsize == 1
    pf.close()


def test_eq7_prefetch_overlap_discount():
    host = PLATFORMS["epyc-7763"]

    def w(ov, tier="disk"):
        return WorkloadSpec(1024, (10, 5), (128, 256, 172),
                            feature_tier=tier, prefetch_overlap=ov)
    t_off, t_half, t_full = (t_load(w(v), host, 1) for v in (0.0, 0.5, 1.0))
    t_ram = t_load(w(0.0, tier="ram"), host, 1)
    assert t_off > t_half > t_full
    assert t_full == pytest.approx(t_ram)
    assert t_load(w(1.0, tier="ram"), host, 1) == t_ram


def test_mapping_accepts_prefetch_overlap():
    host, accel = PLATFORMS["epyc-7763"], PLATFORMS["h100-sxm"]
    kw = dict(fanouts=(10, 5), layer_dims=(128, 256, 172),
              feature_tier="disk")
    m0 = initial_task_mapping(host, accel, 2, 1024, **kw)
    m1 = initial_task_mapping(host, accel, 2, 1024, prefetch_overlap=1.0,
                              **kw)
    for m in (m0, m1):
        assert m["cpu"] + 2 * m["accel_each"] <= 1024
        assert m["accel_each"] >= 0 and m["cpu"] >= 0
    # hiding the storage stream makes the host's load cheaper: the CPU
    # trainer never gets a smaller share with it
    assert m1["cpu"] >= m0["cpu"]


def test_trainer_wires_background_io(tmp_path):
    ds = make_dataset("ogbn-products", scale=0.002, seed=0,
                      feature_backend="mmap",
                      spill_dir=str(tmp_path / "spill"), partition_rows=512)
    cfg = HybridConfig(total_batch=128, n_accel=2, hybrid=False,
                       use_drm=False, tfp_depth=2, seed=0,
                       use_accel_sampler=False, cache_fraction=0.2,
                       prefetch_windows=2, mmap_lru_windows=4)
    tr = HybridGNNTrainer(ds, _gnn(ds), cfg, device="cpu")
    assert tr.prefetcher is not None
    assert tr.loader.source.lru_windows == 4
    assert tr.prefetch_overlap == 1.0
    hist = tr.train(4)
    assert all(np.isfinite(m.loss) for m in hist)
    io = tr.storage_io()
    assert io["prefetch_submitted"] > 0
    assert io["open_windows"] <= 4
    assert all(m.times.t_load_stall >= 0.0 for m in hist)
    tr.close()
    tr.close()


def test_trainer_storage_io_exposes_dedup_and_pin_counters(tmp_path):
    ds = make_dataset("ogbn-products", scale=0.002, seed=0,
                      feature_backend="mmap",
                      spill_dir=str(tmp_path / "spill"), partition_rows=512)
    cfg = HybridConfig(total_batch=128, n_accel=2, hybrid=False,
                       use_drm=False, tfp_depth=2, seed=0,
                       use_accel_sampler=False, prefetch_windows=2,
                       prefetch_dedup_history=2)
    tr = HybridGNNTrainer(ds, _gnn(ds), cfg, device="cpu")
    hist = tr.train(4)
    assert all(np.isfinite(m.loss) for m in hist)
    io = tr.storage_io()
    assert io["resubmitted_rows_skipped"] > 0
    assert io["pin_blocked_evictions"] >= 0.0
    tr.close()


def test_trainer_without_mmap_has_no_prefetcher():
    ds = make_dataset("ogbn-products", scale=0.002, seed=0,
                      feature_backend="dense")
    cfg = HybridConfig(total_batch=128, n_accel=1, hybrid=False,
                       use_drm=False, tfp_depth=0, seed=0,
                       use_accel_sampler=False, prefetch_windows=4,
                       mmap_lru_windows=4)
    tr = HybridGNNTrainer(ds, _gnn(ds), cfg, device="cpu")
    assert tr.prefetcher is None
    assert tr.prefetch_overlap == 0.0 and tr.feature_tier == "ram"
    assert tr.storage_io()["prefetched_window_bytes"] == 0.0
    assert "prefetcher" not in tr.health()["components"]
    tr.close()


def test_boot_and_refresh_gathers_excluded_from_stall_stats(tmp_path):
    ds = make_dataset("ogbn-products", scale=0.002, seed=0,
                      feature_backend="mmap",
                      spill_dir=str(tmp_path / "spill"), partition_rows=512)
    cfg = HybridConfig(total_batch=128, n_accel=2, hybrid=False,
                       use_drm=False, tfp_depth=0, seed=0,
                       use_accel_sampler=False, cache_fraction=0.2,
                       prefetch_windows=2, mmap_lru_windows=4)
    tr = HybridGNNTrainer(ds, _gnn(ds), cfg, device="cpu")
    src = tr.loader.source
    assert src.prefetch_miss_windows == 0
    assert src.cold_fault_page_bytes == 0
    assert src.cold_gather_seconds == 0.0
    assert src.touched_page_bytes > 0          # the pages did become warm
    assert tr._measured_prefetch_overlap() == 1.0
    tr.close()
    hashed = HashedFeatures(N, F, seed=5)
    mm = MmapFeatures.spill(hashed, spill_dir=str(tmp_path / "spill2"),
                            partition_rows=PROWS)
    cache = FeatureCache(mm, np.arange(N, 0, -1, np.float64), 40)
    cache.track_hotness = True
    rng = np.random.default_rng(0)
    for _ in range(4):
        cache.lookup(rng.integers(100, N, 200).astype(np.int64))
    before = (mm.cold_fault_page_bytes, mm.prefetch_miss_windows,
              mm.cold_gather_seconds, mm.warm_gather_seconds)
    assert cache.stage() > 0
    assert cache.commit() > 0
    assert (mm.cold_fault_page_bytes, mm.prefetch_miss_windows,
            mm.cold_gather_seconds, mm.warm_gather_seconds) == before


def test_prefetch_submits_cpu_full_frontier_and_accel_misses(tmp_path):
    ds = make_dataset("ogbn-products", scale=0.002, seed=0,
                      feature_backend="mmap",
                      spill_dir=str(tmp_path / "spill"), partition_rows=512)
    cfg = HybridConfig(total_batch=128, n_accel=1, hybrid=True,
                       use_drm=False, tfp_depth=0, seed=0,
                       use_accel_sampler=False, cache_fraction=0.2,
                       prefetch_windows=2)
    tr = HybridGNNTrainer(ds, _gnn(ds), cfg, device="cpu")
    tr.runtime.assignment.cpu_batch = 64
    tr.runtime.assignment.accel_batch = 64
    got = []
    tr.prefetcher.submit = lambda ids: got.append(np.asarray(ids))
    item = tr._stage_sample(tr._make_payload(0))
    parts = []
    for name, mb in item.payload["minibatch"].items():
        ids = np.unique(np.asarray(mb.frontier(2)))
        if name != "cpu":
            ids = ids[tr.cache.slot_of[ids] < 0]
        parts.append(ids)
    expect = np.unique(np.concatenate(parts))
    assert len(got) == 1
    assert np.array_equal(got[0], expect)
    cpu_ids = np.unique(np.asarray(item.payload["minibatch"]["cpu"]
                                   .frontier(2)))
    cached_cpu = cpu_ids[tr.cache.slot_of[cpu_ids] >= 0]
    assert cached_cpu.size > 0 and np.isin(cached_cpu, got[0]).all()
    tr.close()


def test_device_sampled_frontier_reaches_prefetch_and_load_once(tmp_path):
    """With the device sampler (here on the host device) the sample stage
    brings each device batch's frontier over once: the prefetch submit
    and the load stage both read that array, and the loads equal a
    reload from the batch itself."""
    ds = make_dataset("ogbn-products", scale=0.002, seed=0,
                      feature_backend="mmap",
                      spill_dir=str(tmp_path / "spill"), partition_rows=512)
    cfg = HybridConfig(total_batch=128, n_accel=1, hybrid=True,
                       use_drm=False, tfp_depth=0, seed=0,
                       use_accel_sampler=True, cache_fraction=0.2,
                       prefetch_windows=2)
    tr = HybridGNNTrainer(ds, _gnn(ds), cfg, device="cpu")
    tr.runtime.assignment.cpu_batch = 64
    tr.runtime.assignment.accel_batch = 64
    tr.runtime.assignment.sample_frac_accel = 1.0
    got = []
    tr.prefetcher.submit = lambda ids: got.append(np.asarray(ids))
    item = tr._stage_sample(tr._make_payload(0))
    p = item.payload
    assert sorted(p["host_frontier"]) == sorted(p["device_sampled"]) == \
        ["accel0", "cpu"]
    for name, mb in p["minibatch"].items():
        assert np.array_equal(p["host_frontier"][name],
                              mb.frontier(2).numpy())
    assert len(got) == 1
    calls = []
    orig = tr.loader._frontier
    tr.loader._frontier = lambda b, f=None: (calls.append(f is not None),
                                             orig(b, f))[1]
    tr._stage_load(item)
    assert calls and all(calls)
    assert p["t"]["t_load_stall"] >= 0.0
    tr.close()


def test_overlap_drift_alone_triggers_mapping_reprice(tmp_path):
    ds = make_dataset("ogbn-products", scale=0.002, seed=0,
                      feature_backend="mmap",
                      spill_dir=str(tmp_path / "spill"), partition_rows=512)
    cfg = HybridConfig(total_batch=256, n_accel=2, hybrid=True,
                       use_drm=False, tfp_depth=0, seed=0,
                       use_accel_sampler=False, cache_fraction=0.2,
                       prefetch_windows=2)
    tr = HybridGNNTrainer(ds, _gnn(ds), cfg, device="cpu")
    assert tr._model_prefetch_overlap == 1.0
    rb = tr.cache.row_bytes
    with tr.loader._stats_lock:
        tr.loader.window.merge(LoadStats(
            rows=10, bytes=10 * rb, total_rows=1000, unique_rows=1000,
            hit_rows=500, saved_bytes=500 * rb))
    tr._model_hit_rate = tr.loader.snapshot("window").hit_rate
    src = tr.loader.source
    src.prefetch_miss_windows = 100
    assert tr._measured_prefetch_overlap() == 0.0
    assert tr._maybe_refresh_mapping()
    assert tr._model_prefetch_overlap == 0.0
    assert not tr._maybe_refresh_mapping()
    tr.close()


def test_close_raises_latched_background_errors(tmp_path):
    ds = make_dataset("ogbn-products", scale=0.002, seed=0,
                      feature_backend="mmap",
                      spill_dir=str(tmp_path / "spill"), partition_rows=512)
    cfg = HybridConfig(total_batch=128, n_accel=2, hybrid=False,
                       use_drm=False, tfp_depth=0, seed=0,
                       use_accel_sampler=False, cache_fraction=0.2,
                       cache_refresh=True, async_refresh=True,
                       prefetch_windows=2, degrade_on_failure=False)
    tr = HybridGNNTrainer(ds, _gnn(ds), cfg, device="cpu")
    with tr._state_lock:
        tr._refresh_error = RuntimeError("late stage failure")
    with pytest.raises(RuntimeError, match="async cache-refresh"):
        tr.close()
    tr.prefetcher.error = RuntimeError("late prefetch failure")
    with pytest.raises(RuntimeError, match="prefetch worker failed"):
        tr.close()
    tr.close()


def test_health_report_shape_on_clean_run(tmp_path):
    ds = make_dataset("ogbn-products", scale=0.002, seed=0,
                      feature_backend="mmap", partition_rows=512)
    cfg = HybridConfig(total_batch=128, n_accel=2, hybrid=False,
                       use_drm=False, tfp_depth=0, seed=0,
                       use_accel_sampler=False, cache_fraction=0.2,
                       prefetch_windows=2)
    tr = HybridGNNTrainer(ds, _gnn(ds), cfg, device="cpu")
    tr.train(2)
    h = tr.health()
    assert h["status"] == "ok" and h["degraded"] == [] and h["events"] == []
    assert h["components"]["prefetcher"]["healthy"]
    assert h["components"]["storage"]["io_errors"] == 0
    tr.close()
    assert set(tr.storage_io()) >= {
        "io_retries", "io_retry_seconds", "io_errors", "fallback_gathers",
        "fallback_rows", "madvise_failures", "fadvise_failures"}


# ------------------------------- the reference's fault cases, ported


def test_spec_matching_and_kinds():
    s = FaultSpec(op="storage.take", kind="transient", start=2, count=3)
    assert [s.matches(i) for i in range(7)] == [
        False, False, True, True, True, False, False]
    p = FaultSpec(op="storage.take", kind="permanent", start=4)
    assert not p.matches(3) and p.matches(4) and p.matches(4000)
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec(op="x", kind="flaky")


def test_injector_fires_on_exact_call_indices():
    inj = FaultInjector([FaultSpec(op="storage.take", kind="transient",
                                   start=1, count=2)])
    hits = []
    for i in range(5):
        try:
            inj.fire("storage.take")
            hits.append(False)
        except OSError as e:
            assert e.errno == errno.EIO and f"call {i}" in str(e)
            hits.append(True)
    assert hits == [False, True, True, False, False]
    inj.fire("storage.prefetch")
    rep = inj.report()
    assert rep["calls"] == {"storage.take": 5, "storage.prefetch": 1}
    assert rep["injected"] == {"storage.take": 2}
    assert rep["faults_raised"] == 2


def test_injector_delay_and_kill():
    inj = FaultInjector([
        FaultSpec(op="storage.prefetch", kind="delay", delay=0.05, count=1),
        FaultSpec(op="prefetch.worker", kind="kill", start=0, count=1,
                  message="simulated worker death"),
    ])
    t0 = time.perf_counter()
    inj.fire("storage.prefetch")
    assert time.perf_counter() - t0 >= 0.04
    with pytest.raises(WorkerKilled, match="simulated worker death"):
        inj.fire("prefetch.worker")
    inj.fire("prefetch.worker")
    rep = inj.report()
    assert rep["delays_injected"] == 1
    assert rep["total_delay_seconds"] == pytest.approx(0.05)
    assert not isinstance(WorkerKilled("x"), Exception)


def test_injector_json_roundtrip(tmp_path):
    inj = FaultInjector([FaultSpec(op="storage.take", start=3, count=2,
                                   errno=errno.ENOSPC)], seed=7)
    path = str(tmp_path / "schedule.json")
    with open(path, "w") as fh:
        fh.write(inj.to_json())
    for loaded in (FaultInjector.from_json(path),
                   FaultInjector.from_json(json.loads(inj.to_json()))):
        assert loaded.seed == 7
        assert loaded.schedule == inj.schedule
    bare = FaultInjector.from_json([{"op": "storage.prefetch"}])
    assert bare.schedule == [FaultSpec(op="storage.prefetch")]


def test_probabilistic_spec_is_deterministic():
    def pattern(seed):
        inj = FaultInjector([FaultSpec(op="storage.take", kind="transient",
                                       start=0, count=200,
                                       probability=0.5)], seed=seed)
        out = []
        for _ in range(200):
            try:
                inj.fire("storage.take")
                out.append(0)
            except OSError:
                out.append(1)
        return out
    a, b, c = pattern(3), pattern(3), pattern(4)
    assert a == b and a != c and 0 < sum(a) < 200


def test_take_retries_transient_fault_bit_identical(tmp_path):
    inj = FaultInjector([FaultSpec(op="storage.take", kind="transient",
                                   start=0, count=2)])
    dense, mm = _mmap_pair(tmp_path, injector=inj)
    rows = np.random.default_rng(0).integers(0, N, 300).astype(np.int64)
    assert mm.take(rows).tobytes() == dense.take(rows).tobytes()
    assert mm.io_errors == 2 and mm.io_retries == 2
    assert mm.io_retry_seconds > 0.0
    assert mm.fallback_gathers == 0


def test_take_exhausts_retries_and_raises_without_fallback(tmp_path):
    inj = FaultInjector([FaultSpec(op="storage.take", kind="permanent")])
    _, mm = _mmap_pair(tmp_path, injector=inj)
    mm.fallback_source = None
    with pytest.raises(OSError):
        mm.take(np.arange(10, dtype=np.int64))
    assert mm.io_errors == mm.io_retry_attempts
    assert mm.io_retries == mm.io_retry_attempts - 1


def test_take_falls_back_to_backing_source(tmp_path):
    inj = FaultInjector([FaultSpec(op="storage.take", kind="permanent")])
    dense, mm = _mmap_pair(tmp_path, injector=inj)
    rows = np.random.default_rng(1).integers(0, N, 200).astype(np.int64)
    assert mm.take(rows).tobytes() == dense.take(rows).tobytes()
    assert mm.fallback_gathers > 0
    assert mm.fallback_rows == rows.shape[0]
    assert mm.touched_page_bytes == 0


def test_fallback_budget_exhaustion_raises(tmp_path):
    inj = FaultInjector([FaultSpec(op="storage.take", kind="permanent")])
    _, mm = _mmap_pair(tmp_path, injector=inj)
    mm.fallback_row_budget = 8
    with pytest.raises(OSError, match="fallback gather budget"):
        mm.take(np.arange(32, dtype=np.int64))


def test_prefetch_rows_retries_transient_fault(tmp_path):
    inj = FaultInjector([FaultSpec(op="storage.prefetch", kind="transient",
                                   start=0, count=1)])
    _, mm = _mmap_pair(tmp_path, injector=inj)
    mm.prefetch_rows(np.arange(PROWS, dtype=np.int64))
    assert mm.io_retries == 1
    assert mm.prefetched_window_bytes > 0


def test_madvise_failure_counted_not_raised(tmp_path):
    inj = FaultInjector([FaultSpec(op="storage.madvise", kind="permanent")])
    dense, mm = _mmap_pair(tmp_path, injector=inj)
    rows = np.arange(0, N, 3, dtype=np.int64)
    assert mm.take(rows).tobytes() == dense.take(rows).tobytes()
    assert mm.madvise_failures > 0
    assert mm.madvise_calls == 0


def test_fadvise_failure_counted_not_raised(tmp_path):
    inj = FaultInjector([FaultSpec(op="storage.fadvise", kind="permanent",
                                   errno=errno.EBADF)])
    dense, mm = _mmap_pair(tmp_path, injector=inj)
    mm.drop_page_cache()
    assert mm.fadvise_failures == mm.num_partitions
    rows = np.arange(50, dtype=np.int64)
    assert mm.take(rows).tobytes() == dense.take(rows).tobytes()


def test_loader_pool_fault_surfaces_once_stats_intact():
    ds = make_dataset("ogbn-products", scale=0.002, seed=0,
                      feature_backend="mmap", partition_rows=128)
    src = ds.feature_source
    cache = build_cache(ds, 0.2)
    src.fault_injector = FaultInjector([FaultSpec(
        op="storage.take", kind="transient", start=0, count=1)])
    src.io_retry_attempts = 1
    src.fallback_source = None
    loader = FeatureLoader(ds, num_threads=2, cache=cache)
    sampler = NumpySampler(ds.graph, fanouts=(4, 3), seed=0)
    tgt = np.arange(64, dtype=np.int64)
    mb = sampler.sample(tgt, ds.labels[tgt])
    stats0 = loader.snapshot()
    look0 = cache.stats_snapshot()[0]
    with pytest.raises(OSError):
        loader.load_compact(mb)
    assert loader.snapshot() == stats0
    assert cache.stats_snapshot()[0] == look0
    assert loader.snapshot("window").total_rows == 0
    block = loader.load_compact(mb)
    assert block.rows.shape[0] == loader.snapshot().rows
    assert cache.stats_snapshot()[0].lookups == 1
    loader.close()


def test_prefetcher_restarts_killed_worker_within_budget(tmp_path):
    inj = FaultInjector([FaultSpec(op="prefetch.worker", kind="kill",
                                   start=0, count=1)])
    _, mm = _mmap_pair(tmp_path)
    pf = WindowPrefetcher(mm, restart_budget=2, restart_backoff=0.001,
                          raise_on_failure=False, fault_injector=inj)
    rows = np.arange(PROWS, dtype=np.int64)
    assert pf.submit(rows)
    assert pf.wait_idle(10.0)
    assert isinstance(pf.error, WorkerKilled)
    assert pf.submit(rows)
    assert pf.wait_idle(10.0)
    assert pf.restarts == 1 and pf.completed == 1
    assert pf.healthy and not pf.failed
    pf.close()


def test_prefetcher_fails_permanently_past_budget(tmp_path):
    inj = FaultInjector([FaultSpec(op="prefetch.worker", kind="kill",
                                   count=1 << 30)])
    _, mm = _mmap_pair(tmp_path)
    pf = WindowPrefetcher(mm, restart_budget=1, restart_backoff=0.001,
                          raise_on_failure=False, fault_injector=inj)
    rows = np.arange(PROWS, dtype=np.int64)
    ok = []
    for _ in range(4):
        ok.append(pf.submit(rows))
        pf.wait_idle(10.0)
    assert pf.failed and not pf.healthy
    assert ok[-1] is False
    assert pf.restarts == 1
    assert not pf.submit(rows)
    pf.close()


def test_prefetcher_failed_raises_under_strict_contract(tmp_path):
    inj = FaultInjector([FaultSpec(op="prefetch.worker", kind="kill")])
    _, mm = _mmap_pair(tmp_path)
    pf = WindowPrefetcher(mm, restart_budget=0, fault_injector=inj)
    rows = np.arange(PROWS, dtype=np.int64)
    pf.submit(rows)
    pf.wait_idle(10.0)
    with pytest.raises(RuntimeError, match="prefetch worker failed") as ei:
        pf.submit(rows)
    assert isinstance(ei.value.__cause__, WorkerKilled)
    pf.close()


# ---------------------------------------------------- stress interleavings


def _stress_run(n_accel, depth, stressed, iters=3):
    ds = make_dataset("ogbn-products", scale=0.002, seed=0,
                      feature_backend="mmap", partition_rows=512)
    cfg = HybridConfig(
        total_batch=96, n_accel=n_accel, hybrid=(n_accel == 0),
        use_drm=False, tfp_depth=depth, seed=0, use_accel_sampler=False,
        cache_fraction=0.2, cache_refresh=stressed,
        cache_drift_threshold=0.0, async_refresh=stressed,
        prefetch_windows=2 if stressed else 0,
        mmap_lru_windows=3 if stressed else 0)
    tr = HybridGNNTrainer(ds, _gnn(ds), cfg, device="cpu")
    tr.train(iters)
    losses = [m.loss for m in tr.history]
    tr.close()
    ds.features.close()
    return losses, tr


@pytest.mark.stress
@pytest.mark.parametrize("n_accel", [0, 1, 2])
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_stress_interleavings_bit_identical(n_accel, depth):
    base, _ = _stress_run(n_accel, depth=2, stressed=False)
    stressed, tr = _stress_run(n_accel, depth=depth, stressed=True)
    assert np.array_equal(base, stressed), (n_accel, depth)
    if n_accel > 0:
        io = tr.storage_io()
        assert io["prefetch_submitted"] > 0
        assert io["open_windows"] <= 3 + io["pin_blocked_evictions"]


@pytest.mark.stress
def test_mid_gather_eviction_never_corrupts_inflight_gather(tmp_path):
    dense, mm = _mmap_pair(tmp_path, name="spill-race", lru=1)
    rng = np.random.default_rng(7)
    rows = [rng.integers(0, N, 500).astype(np.int64) for _ in range(4)]
    truth = [dense.take(r).tobytes() for r in rows]
    stop = threading.Event()
    errors = []

    def hammer():
        i = 0
        while not stop.is_set():
            mm.take(np.array([(i * PROWS) % N], dtype=np.int64))
            i += 1

    def reader(idx):
        try:
            for _ in range(10):
                if mm.take(rows[idx]).tobytes() != truth[idx]:
                    errors.append(f"reader {idx} corrupted")
                    return
        except Exception as e:  # pragma: no cover - failure path
            errors.append(repr(e))

    threads = [threading.Thread(target=hammer) for _ in range(2)] + \
        [threading.Thread(target=reader, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads[2:]:
        t.join(60.0)
    stop.set()
    for t in threads[:2]:
        t.join(60.0)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert mm.window_evictions > 0


@pytest.mark.stress
def test_staged_commit_between_load_and_transfer_bit_identical():
    """A staged refresh commit lands while batches sit between the load and
    transfer stages, with the prefetcher and the LRU racing underneath:
    the versioned lookups keep the losses bit-identical."""
    def run(force):
        ds = make_dataset("ogbn-products", scale=0.002, seed=0,
                          feature_backend="mmap", partition_rows=512)
        cfg = HybridConfig(total_batch=96, n_accel=2, hybrid=False,
                           use_drm=False, tfp_depth=2, seed=0,
                           use_accel_sampler=False, cache_fraction=0.2,
                           prefetch_windows=2, mmap_lru_windows=3)
        tr = HybridGNNTrainer(ds, _gnn(ds), cfg, device="cpu")
        if force:
            orig = tr._stage_transfer
            fired = []

            def transfer(item):
                if not fired and item.payload["iteration"] == 2:
                    fired.append(True)
                    tr.cache.track_hotness = True
                    cold = np.flatnonzero(tr.cache.slot_of < 0)[:48]
                    for _ in range(6):
                        tr.cache.lookup(np.repeat(cold, 4))
                    assert tr.cache.stage() > 0
                    assert tr.cache.commit() > 0
                    tr.loader.reset_window()
                return orig(item)

            tr._stage_transfer = transfer
        tr.train(6)
        losses = [m.loss for m in tr.history]
        ver = tr.cache.version
        tr.close()
        ds.features.close()
        return losses, ver

    base, _ = run(False)
    forced, ver = run(True)
    assert np.array_equal(base, forced)
    assert ver > 0
