"""The port's failure model against the JAX package's: the pipeline
watchdog and stage hooks, refresh failures, ``health()``, the chaos
scenarios and trainer failures.

The reference's watchdog, hook, refresh-failure, health and chaos cases
(``tests/test_faults.py``) and its trainer-failure case
(``tests/test_hybrid_system.py``) run against the port.  Beside them the
same wedge, schedule or failure goes to both packages: the same
``PipelineStallError`` diagnosis (stage, queue depths, completions), the
same ``health()`` records, the same injector report and timing-free
``storage_io()`` counters under one JSON schedule, the same assignments
after ``inject_failure``, and losses within 1e-4 of the reference's (the
tolerance of ``tests/test_torch_trainer.py``).  Inside the port, transient
faults and a refresh that always fails leave the losses bit-identical to
a clean run.  A wedged stage sleeps ``WEDGE`` seconds (the reference's
cases sleep 30): long past every watchdog here, short enough that the
stranded daemon thread ends soon after its case."""
import time

import numpy as np
import pytest

import repro.core as rc
import repro.graph as rg
import repro_torch.core as tc
import repro_torch.graph as tg
from repro_torch.core import (HybridConfig, HybridGNNTrainer,
                              PipelineStallError, PrefetchPipeline, Stage)
from repro_torch.graph import FaultInjector, FaultSpec, GNNConfig, LoadStats

WEDGE = 5.0

TRANSIENT = {"seed": 0, "schedule": [
    {"op": "storage.take", "kind": "transient", "start": 0, "count": 1},
    {"op": "storage.take", "kind": "transient", "start": 7, "count": 2},
    {"op": "storage.prefetch", "kind": "transient", "start": 1,
     "count": 1}]}


def _gnn(pkg, ds, fanouts=(4, 3)):
    return pkg.GNNConfig(model="sage", layer_dims=ds.layer_dims,
                         fanouts=fanouts, num_classes=ds.num_classes)


def _params(tr):
    return {k: np.asarray(v) for k, v in tr.params.items()}


# ------------------------------------------------------- pipeline watchdog


def _items(n, core=tc):
    return [core.PipelineItem(seq=i, payload=i) for i in range(n)]


def test_watchdog_raises_naming_wedged_stage():
    def wedge(item):
        if item.seq == 2:
            time.sleep(WEDGE)           # a dead mount, a wedged gather
        return item

    pipe = PrefetchPipeline([Stage("sample", lambda it: it),
                             Stage("load", wedge)],
                            depth=2, watchdog_seconds=0.5)
    t0 = time.perf_counter()
    with pytest.raises(PipelineStallError) as ei:
        list(pipe.run(_items(8)))
    assert time.perf_counter() - t0 < WEDGE   # a diagnosis, not a hang
    err = ei.value
    assert err.stage == "load"
    assert err.stalled_seconds >= 0.5
    assert set(err.queue_depths) == {"sample_in", "load_in", "output_in"}
    assert err.completed["load"] == 2   # items 0, 1 passed; 2 wedged
    assert "wedged" in str(err) and "'load'" in str(err)


def test_watchdog_quiet_on_clean_and_sequential_runs():
    stages = [Stage("a", lambda it: it), Stage("b", lambda it: it)]
    for depth in (0, 2):
        pipe = PrefetchPipeline(stages, depth=depth, watchdog_seconds=0.2)
        out = list(pipe.run(_items(30)))
        assert [o.seq for o in out] == list(range(30))


def test_injected_delay_backs_queues_up_into_storm():
    # a delay on the last stage wedges it; the bounded queues upstream
    # fill behind it and the watchdog's snapshot shows the backlog
    inj = FaultInjector([FaultSpec(op="pipeline.slow", kind="delay",
                                   start=1, count=1, delay=WEDGE)])
    pipe = PrefetchPipeline([Stage("fast", lambda it: it),
                             Stage("slow", lambda it: it)],
                            depth=1, watchdog_seconds=0.5,
                            fault_injector=inj)
    with pytest.raises(PipelineStallError) as ei:
        list(pipe.run(_items(8)))
    assert ei.value.stage == "slow"
    assert ei.value.queue_depths["slow_in"] == 1   # full behind the wedge


def test_injected_stage_error_uses_failure_protocol():
    inj = FaultInjector([FaultSpec(op="pipeline.load", kind="transient",
                                   start=1, count=1)])
    pipe = PrefetchPipeline([Stage("load", lambda it: it)], depth=2,
                            fault_injector=inj)
    with pytest.raises(OSError):
        list(pipe.run(_items(6)))
    assert isinstance(pipe._error, OSError)
    # the pipeline is reusable after the failure (per-run state)
    pipe.fault_injector = None
    assert len(list(pipe.run(_items(6)))) == 6
    assert pipe._error is None


def _diagnose(core, pkg, case):
    if case == "stage_sleep":
        def wedge(item):
            if item.seq == 2:
                time.sleep(WEDGE)
            return item
        pipe = core.PrefetchPipeline([core.Stage("sample", lambda it: it),
                                      core.Stage("load", wedge)],
                                     depth=2, watchdog_seconds=0.5)
    else:
        inj = pkg.FaultInjector([pkg.FaultSpec(
            op="pipeline.slow", kind="delay", start=1, count=1,
            delay=WEDGE)])
        pipe = core.PrefetchPipeline([core.Stage("fast", lambda it: it),
                                      core.Stage("slow", lambda it: it)],
                                     depth=1, watchdog_seconds=0.5,
                                     fault_injector=inj)
    with pytest.raises(core.PipelineStallError) as ei:
        list(pipe.run(_items(8, core)))
    e = ei.value
    return (e.stage, e.queue_depths, e.completed, e.watchdog_seconds,
            str(e).split(": no progress")[0])


@pytest.mark.parametrize("case", ["stage_sleep", "injected_delay"])
def test_watchdog_diagnosis_matches_reference(case):
    assert _diagnose(tc, tg, case) == _diagnose(rc, rg, case)


# ------------------------------------------- trainer-level degraded modes


def _small_trainer(pkg=tg, core=tc, fault_injector=None, **over):
    ds = pkg.make_dataset("ogbn-products", scale=0.002, seed=0,
                          feature_backend="mmap", partition_rows=512)
    cfg = dict(total_batch=128, n_accel=2, hybrid=False, use_drm=False,
               tfp_depth=0, seed=0, use_accel_sampler=False,
               cache_fraction=0.2)
    cfg.update(over)
    kw = {"device": "cpu"} if core is tc else {}
    return core.HybridGNNTrainer(ds, _gnn(pkg, ds), core.HybridConfig(**cfg),
                                 fault_injector=fault_injector, **kw)


def _break_refresh(tr, stats_cls, how, injector=None):
    """Make every refresh stage fail: a source whose gather raises, or
    ``injector``'s ``refresh.stage`` fault; then arm the drift signal
    twice."""
    if how == "refresh_stage_fault":
        tr.cache.fault_injector = injector
    else:
        def bad_take(rows):
            raise RuntimeError("spill blob gone")
        tr.cache.source = type("Broken", (), {
            "take": staticmethod(bad_take), "shape": tr.cache.source.shape,
            "dtype": np.float32})()
    rb = tr.cache.row_bytes
    v0 = tr.cache.version
    for i in range(2):
        tr.loader.window.merge(stats_cls(
            rows=20, bytes=20 * rb, total_rows=100, unique_rows=80,
            hit_rows=70, saved_bytes=70 * rb))
        tr._model_hit_rate = 0.99
        assert not tr._maybe_refresh_cache()   # degrades, never raises
        assert tr._refresh_failures == i + 1
    return v0


def test_refresh_failure_degrades_then_disables():
    tr = _small_trainer(cache_refresh=True, cache_drift_threshold=0.0,
                        refresh_failure_budget=2)
    tr.train(2)
    v0 = _break_refresh(tr, LoadStats, "broken_source")
    assert tr._refresh_disabled                # budget spent: off for good
    assert tr.cache.version == v0              # old version kept serving
    assert tr.cache._staged is None            # failed plan was discarded
    h = tr.health()
    assert h["status"] == "degraded" and "refresh" in h["degraded"]
    assert not h["components"]["refresh"]["enabled"]
    assert not tr._maybe_refresh_cache()       # disabled: cheap no-op now
    tr.close()


@pytest.mark.parametrize("how", ["broken_source", "refresh_stage_fault"])
def test_refresh_failure_health_matches_reference(how):
    out = []
    for pkg, core in ((rg, rc), (tg, tc)):
        inj = None
        if how == "refresh_stage_fault":
            inj = pkg.FaultInjector([pkg.FaultSpec(op="refresh.stage",
                                                   kind="permanent")])
        tr = _small_trainer(pkg, core, cache_refresh=True,
                            cache_drift_threshold=0.0,
                            refresh_failure_budget=2)
        tr.train(2)
        _break_refresh(tr, pkg.LoadStats, how, inj)
        assert tr._refresh_disabled
        out.append((tr.health(), tr.cache.stage_failures, tr.cache.version,
                    inj.report() if inj is not None else None))
        tr.close()
    (rh, rfail, rver, rrep), (ph, pfail, pver, prep) = out
    assert ph == rh
    assert ph["status"] == "degraded"
    assert [e["component"] for e in ph["events"]] == ["refresh"]
    assert (pfail, pver, prep) == (rfail, rver, rrep)


def test_failing_refresh_losses_bit_identical_to_refresh_off():
    """A permanent ``refresh.stage`` fault: refresh disables itself after
    its budget, no version is committed, and the losses equal a
    refresh-off twin's bit for bit."""
    inj = FaultInjector([FaultSpec(op="refresh.stage", kind="permanent")])
    on = _small_trainer(fault_injector=inj, cache_refresh=True,
                        cache_drift_threshold=0.0, refresh_failure_budget=2)
    off = _small_trainer()
    off.set_params(_params(on))
    lon, loff = ([m.loss for m in tr.train(6)] for tr in (on, off))
    assert lon == loff
    assert on._refresh_disabled and on.cache.version == 0
    assert on.cache.stage_failures == 2
    assert inj.report()["injected"] == {"refresh.stage": 2}
    (ev,) = on.health()["events"]
    assert ev["component"] == "refresh" and "disabled" in ev["action"]
    on.close()
    off.close()


def test_health_report_matches_reference_on_clean_run():
    hs = []
    for pkg, core in ((rg, rc), (tg, tc)):
        tr = _small_trainer(pkg, core, prefetch_windows=2,
                            cache_refresh=True)
        tr.train(2)
        hs.append(tr.health())
        tr.close()
    assert hs[1] == hs[0]
    assert set(hs[1]["components"]) == {"prefetcher", "refresh", "storage"}


# ------------------------------------------------------------ chaos suite


def _chaos_run(injector, pkg=tg, core=tc, w0=None, **over):
    ds = pkg.make_dataset("ogbn-products", scale=0.002, seed=0,
                          feature_backend="mmap", partition_rows=512)
    cfg = dict(total_batch=128, n_accel=2, hybrid=False, use_drm=False,
               tfp_depth=2, seed=0, use_accel_sampler=False,
               cache_fraction=0.2, prefetch_windows=2)
    cfg.update(over)
    kw = {"device": "cpu"} if core is tc else {}
    tr = core.HybridGNNTrainer(ds, _gnn(pkg, ds), core.HybridConfig(**cfg),
                               fault_injector=injector, **kw)
    if w0 is not None:
        tr.set_params(w0)
    return tr


@pytest.mark.chaos
def test_chaos_transient_faults_bit_identical_losses():
    """Transient storage faults the retries absorb are invisible to
    training: losses bit-identical to a fault-free twin."""
    def run(injector):
        tr = _chaos_run(injector)
        hist = tr.train(4)
        losses = [m.loss for m in hist]
        io = dict(tr.storage_io())
        tr.close()
        return losses, io

    inj = FaultInjector.from_json(TRANSIENT)
    clean_losses, clean_io = run(None)
    fault_losses, fault_io = run(inj)
    assert fault_losses == clean_losses            # bit-identical
    assert fault_io["io_retries"] >= 3             # the faults did happen
    assert fault_io["io_errors"] >= 3
    assert clean_io["io_errors"] == 0
    assert inj.report()["faults_raised"] >= 3


@pytest.mark.chaos
def test_chaos_prefetcher_death_mid_epoch_degrades():
    """A prefetch worker killed past its restart budget mid-run: training
    completes on synchronous loads, health() reports it and the overlap
    re-prices to zero."""
    inj = FaultInjector([FaultSpec(op="prefetch.worker", kind="kill",
                                   start=2, count=1 << 30)])
    tr = _chaos_run(inj, prefetch_restart_budget=1)
    hist = tr.train(8)                  # survives the mid-epoch death
    assert len(hist) == 8
    assert all(np.isfinite(m.loss) for m in hist)
    assert tr.prefetcher.failed and not tr.prefetcher.healthy
    assert tr._measured_prefetch_overlap() == 0.0
    h = tr.health()
    assert h["status"] == "degraded"
    assert "prefetcher" in h["degraded"]
    (ev,) = [e for e in h["events"] if e["component"] == "prefetcher"]
    assert "synchronously" in ev["action"]
    assert h["components"]["prefetcher"]["restarts"] == 1
    tr.close()                          # degraded close stays clean


@pytest.mark.chaos
def test_chaos_watchdog_converts_wedged_stage_to_diagnosis():
    """An injected wedge in the TFP load stage raises a diagnostic
    PipelineStallError within the watchdog deadline instead of hanging
    the epoch."""
    inj = FaultInjector([FaultSpec(op="pipeline.load", kind="delay",
                                   start=2, count=1, delay=WEDGE)])
    tr = _chaos_run(inj, prefetch_windows=0, pipeline_watchdog_seconds=1.0)
    t0 = time.perf_counter()
    with pytest.raises(PipelineStallError) as ei:
        tr.train(8)
    assert time.perf_counter() - t0 < WEDGE
    assert ei.value.stage == "load"
    assert ei.value.watchdog_seconds == 1.0


# storage_io() counters that no thread timing moves: retries, errors and
# fallbacks count scheduled faults, the windows are opened once each
_IO_EXACT = ("io_retries", "io_errors", "fallback_gathers", "fallback_rows",
             "madvise_failures", "fadvise_failures", "window_evictions",
             "pin_blocked_evictions", "open_windows", "prefetch_submitted")


@pytest.mark.chaos
def test_chaos_schedule_matches_reference():
    """One JSON schedule in both packages: the same injector report, the
    same timing-free storage counters, losses within 1e-4.  Sequential
    stages, so every hook's call sequence is the same in both."""
    out, w0 = [], None
    for pkg, core in ((rg, rc), (tg, tc)):
        inj = pkg.FaultInjector.from_json(TRANSIENT)
        tr = _chaos_run(inj, pkg, core, w0=w0, tfp_depth=0)
        if w0 is None:
            w0 = _params(tr)
        hist = tr.train(4)
        tr.close()
        io = tr.storage_io()
        out.append(([m.loss for m in hist], inj.report(),
                    {k: io[k] for k in _IO_EXACT}, tr.health()["status"]))
    (rl, rrep, rio, rst), (pl, prep, pio, pst) = out
    assert prep == rrep
    assert prep["faults_raised"] == 4 and prep["calls"]["pipeline.load"] == 4
    assert pio == rio
    assert pst == rst == "ok"
    np.testing.assert_allclose(pl, rl, rtol=0, atol=1e-4)


# ----------------------------------------------------- trainer failures


def _products(pkg):
    return pkg.make_dataset("ogbn-products", scale=0.003, seed=0)


G = dict(model="sage", layer_dims=(100, 64, 47), fanouts=(4, 3),
         num_classes=47)


def test_trainer_failure_is_survived():
    """Kill accel0 at iteration 2: the system drops it, rebalances, and
    keeps training."""
    ds = _products(tg)
    hcfg = HybridConfig(total_batch=128, n_accel=2, hybrid=True,
                        use_drm=True, tfp_depth=0, share_quantum=16, seed=2)
    tr = HybridGNNTrainer(ds, GNNConfig(**G), hcfg, device="cpu")
    tr.inject_failure("accel0", at_iteration=2)
    hist = tr.train(8)
    assert len(hist) == 8
    assert all(np.isfinite(m.loss) for m in hist[3:])
    assert "accel0" in tr._failed
    cpu_b, accel_b = hist[-1].assignment
    assert cpu_b + accel_b * tr.runtime.assignment.n_accel \
        == hcfg.total_batch
    assert all("accel0" not in m.shares for m in hist[3:])
    assert tr.health()["components"]["trainers"] == {"failed": ["accel0"]}


@pytest.mark.parametrize("hybrid", [True, False], ids=["hybrid", "accel"])
def test_trainer_failure_matches_reference(hybrid):
    cfg = dict(total_batch=128, n_accel=2, hybrid=hybrid, use_drm=False,
               tfp_depth=0, share_quantum=16, seed=2,
               use_accel_sampler=False)
    ref = rc.HybridGNNTrainer(_products(rg), rg.GNNConfig(**G),
                              rc.HybridConfig(**cfg))
    port = tc.HybridGNNTrainer(_products(tg), tg.GNNConfig(**G),
                               tc.HybridConfig(**cfg), device="cpu")
    port.set_params(_params(ref))
    for tr in (ref, port):
        tr.inject_failure("accel0", at_iteration=2)
    rh, ph = ref.train(6), port.train(6)
    assert [m.assignment for m in ph] == [m.assignment for m in rh]
    assert port._failed == ref._failed == {"accel0"}
    assert port.runtime.assignment.n_accel == ref.runtime.assignment.n_accel
    assert port.health() == ref.health()
    np.testing.assert_allclose([m.loss for m in ph], [m.loss for m in rh],
                               rtol=0, atol=1e-4)


def test_dead_batch_gives_zero_update_and_nan_loss():
    """A batch whose every trainer died before it trained: a zero update
    and a NaN loss, in both packages."""
    out = []
    for pkg, core in ((rg, rc), (tg, tc)):
        cfg = core.HybridConfig(total_batch=128, n_accel=2, hybrid=False,
                                use_drm=False, tfp_depth=0, seed=2,
                                use_accel_sampler=False)
        kw = {"device": "cpu"} if core is tc else {}
        tr = core.HybridGNNTrainer(_products(pkg), pkg.GNNConfig(**G), cfg,
                                   **kw)
        tr._failed.update({"accel0", "accel1"})
        item = core.PipelineItem(seq=0, payload={
            "iteration": 0, "shares": {"accel0": 64, "accel1": 64},
            "minibatch": {"accel0": None, "accel1": None}})
        grads, times, metrics = tr._run_trainers(item)
        assert set(grads) == set(tr.params)
        assert all(not np.asarray(g).any() for g in grads.values())
        out.append((times, np.isnan(metrics["loss"]),
                    np.isnan(metrics["acc"])))
    assert out[1] == out[0] == ({"t_tc": 0.0, "t_ta": 0.0}, True, True)


def test_lone_trainer_death_raises_in_both_packages():
    """The reference's Synchronizer divides by the batch's total weight,
    which is 0 when the batch's only trainer dies at that iteration; the
    port keeps the reference's behaviour (ROADMAP §3)."""
    for pkg, core in ((rg, rc), (tg, tc)):
        cfg = core.HybridConfig(total_batch=128, n_accel=1, hybrid=False,
                                use_drm=False, tfp_depth=0, seed=2,
                                use_accel_sampler=False)
        kw = {"device": "cpu"} if core is tc else {}
        tr = core.HybridGNNTrainer(_products(pkg), pkg.GNNConfig(**G), cfg,
                                   **kw)
        tr.inject_failure("accel0", at_iteration=1)
        with pytest.raises(ZeroDivisionError):
            tr.train(3)
        assert tr._failed == {"accel0"}
