"""The port's model-predictive knob autotuner against the JAX package's,
and the port's GNN training CLI.

The reference's ``tests/test_autotune.py`` runs against the port (search,
rollback, bounds, and losses bit-identical with the tuner on and off at 0,
1 and 2 accelerators).  Beside it the same inputs go to both packages:
``CalibratedKnobModel.predict`` returns the same float over the
``knob_neighbors`` of several states; two ``KnobAutoTuner``s fed one
``StageTimes`` sequence (a 3x regression in it) keep the same log, moves,
rollbacks and report; a knob trajectory forced on both trainers leaves the
same source, prefetcher, cache and thread settings; and one run's
counter-derived ``SignalSnapshot`` fields are equal.  The platform rows are
ones both packages have (``epyc-7763``, ``rtx-a5000``).  The CLI runs on
the CPU at scale 2e-4 with the autotuner, a trainer failure and a fault
schedule."""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.core as rc
import repro.core.perfmodel as rpm
import repro.graph as rg
import repro_torch.core as tc
import repro_torch.core.perfmodel as tpm
import repro_torch.graph as tg
from repro_torch.core import (HybridConfig, HybridGNNTrainer,
                              KnobAutoTuner, KnobState, knob_neighbors)
from repro_torch.core.perfmodel import CalibratedKnobModel
from repro_torch.graph import GNNConfig, make_dataset


def _engine(core=tc):
    return core.DRMEngine(core.Assignment(
        cpu_batch=128, accel_batch=128, n_accel=1, sample_frac_accel=0.0,
        threads={"sample": 2, "load": 2, "train": 2}))


def _bounds(core=tc):
    return core.KnobBounds(prefetch_windows=(0, 64),
                           mmap_lru_windows=(1, 64), min_stage_threads=1,
                           total_threads=6, refresh_period=(1, 16),
                           refresh_frac=(0.05, 0.5))


def _times(scale=1.0, core=tc):
    return core.StageTimes(t_sa=0.005 * scale, t_sc=0.01 * scale,
                           t_load=0.08 * scale, t_tran=0.004 * scale,
                           t_tc=0.03 * scale, t_ta=0.008 * scale,
                           t_load_stall=0.04 * scale)


SIG = dict(t_sc=0.01, t_sa=0.005, t_load=0.08, t_load_stall=0.04,
           t_tran=0.004, t_tc=0.03, t_ta=0.008, dup_factor=1.5,
           hit_rate=0.6, prefetch_hit_rate=0.0, prefetch_drop_rate=0.0,
           touched_windows=16, loaded_rows_per_iter=1000,
           refresh_bytes_per_iter=1e6, hit_decay_per_iter=0.001,
           row_bytes=4, disk_tier=True)


def _model(pm, ref, **sig):
    """One calibrated model on the shared platform rows."""
    return pm.CalibratedKnobModel(
        host=pm.PLATFORMS["epyc-7763"], accel=pm.PLATFORMS["rtx-a5000"],
        ref=ref, signals=pm.SignalSnapshot(**dict(SIG, **sig)))


def _fixed_model(ref: KnobState) -> CalibratedKnobModel:
    """A fixed objective over knob space, so greedy descent is monotone."""
    return _model(tpm, ref)


def test_predicted_time_non_increasing_across_accepted():
    """With a fixed predictor and no measured regressions every accepted
    proposal's predicted time is below its baseline by min_gain, and the
    search converges."""
    start = KnobState(prefetch_windows=0, mmap_lru_windows=1)
    model = _fixed_model(start)
    tuner = KnobAutoTuner(_engine(), _bounds(), interval=2,
                          warmup_windows=0, min_gain=0.02)
    current = start
    for _ in range(40):
        nxt = tuner.step(_times(), lambda mean, n: model, current)
        if nxt is not None:
            current = nxt
    assert tuner.accepted, "fixed beatable model must yield accepted moves"
    assert tuner.rollbacks == 0  # constant measured walls: nothing regresses
    preds = [tuner.accepted[0].baseline_predicted] + \
        [t.predicted for t in tuner.accepted]
    for a, b in zip(preds, preds[1:]):
        assert b <= a * (1.0 - tuner.min_gain) + 1e-12, \
            f"accepted move raised predicted time {a} -> {b}"
    prop = tuner.engine.propose_knobs(model, current, tuner.bounds,
                                      min_gain=tuner.min_gain)
    assert prop is None


def test_rejected_proposal_rolls_back_exactly():
    """A trial whose measured window regresses past the hysteresis band
    returns the exact pre-move state, and the move is vetoed."""
    start = KnobState(prefetch_windows=0, mmap_lru_windows=1)
    model = _fixed_model(start)
    tuner = KnobAutoTuner(_engine(), _bounds(), interval=1,
                          warmup_windows=0, hysteresis=0.10)
    prop = tuner.step(_times(), lambda mean, n: model, start)
    assert prop is not None and prop != start
    back = tuner.step(_times(scale=3.0), lambda mean, n: model, prop)
    assert back == start
    assert tuner.rollbacks == 1 and not tuner.accepted
    rolled_move = [m for ev, m in tuner.log if ev == "rollback"][0]
    assert rolled_move in tuner.report()["vetoed"]
    nxt = tuner.step(_times(), lambda mean, n: model, start)
    if nxt is not None:
        assert tuner._trial.move != rolled_move


class _HostileModel:
    """Rewards the most extreme knob state it sees, trying to drag the
    search out of bounds."""

    def predict(self, k: KnobState) -> float:
        return -(k.prefetch_windows * 1e6 + k.mmap_lru_windows * 1e3
                 + k.load_threads * 1e2 + k.refresh_period
                 + k.refresh_frac)


def test_knob_bounds_respected_under_hostile_predictor():
    bounds = _bounds()
    tuner = KnobAutoTuner(_engine(), bounds, interval=1, warmup_windows=0)
    current = KnobState(prefetch_windows=0, mmap_lru_windows=1)
    total0 = current.total_threads
    for _ in range(60):
        nxt = tuner.step(_times(), lambda mean, n: _HostileModel(), current)
        if nxt is not None:
            current = nxt
        assert bounds.contains(current)
        assert current.total_threads == total0
    assert current.prefetch_windows == bounds.prefetch_windows[1]
    assert current.mmap_lru_windows == bounds.mmap_lru_windows[1]


def _autotune_run(tmp_path, n_accel, auto):
    ds = make_dataset("ogbn-papers100M", scale=2e-4, seed=0,
                      feature_backend="mmap", partition_rows=2048,
                      spill_dir=str(tmp_path / f"spill-{auto}"),
                      mmap_lru_windows=1)
    gnn = GNNConfig(fanouts=(3, 3), layer_dims=ds.layer_dims, model="sage")
    cfg = HybridConfig(total_batch=128, n_accel=n_accel,
                       hybrid=(n_accel == 0), use_drm=False, tfp_depth=2,
                       seed=0, mmap_lru_windows=1, initial_threads=(4, 1, 1),
                       auto_tune=auto, autotune_interval=2,
                       autotune_warmup_windows=0)
    tr = HybridGNNTrainer(ds, gnn, cfg, device="cpu")
    hist = tr.train(8)
    rep = tr.autotune_report()
    tr.close()
    return [m.loss for m in hist], rep


@pytest.mark.parametrize("n_accel", [0, 1, 2])
def test_losses_bit_identical_autotune_on_off(n_accel, tmp_path):
    """Knob moves never touch RNG streams or batch composition: the
    tuner-on run's losses equal the static twin's bit for bit."""
    on, rep_on = _autotune_run(tmp_path, n_accel, True)
    off, rep_off = _autotune_run(tmp_path, n_accel, False)
    assert on == off, f"autotune on/off losses diverged at n_accel={n_accel}"
    assert rep_on["enabled"] and not rep_off["enabled"]


# ---------------------------------------------- parity with the reference


STATES = [
    dict(prefetch_windows=0, mmap_lru_windows=1),
    dict(prefetch_windows=4, mmap_lru_windows=8, sample_threads=3,
         load_threads=2, train_threads=1, refresh_period=2,
         refresh_frac=0.1),
    dict(prefetch_windows=16, mmap_lru_windows=0, refresh_period=8,
         refresh_frac=0.4),
]
SIGNALS = [
    {},
    dict(prefetch_hit_rate=0.7, prefetch_drop_rate=0.2, t_load_stall=0.06),
    dict(disk_tier=False, hit_decay_per_iter=0.0, t_sa=0.2),
]


@pytest.mark.parametrize("case", range(3))
def test_knob_model_predict_matches_reference(case):
    state, sig = STATES[case], SIGNALS[case]
    bounds = dict(prefetch_windows=(0, 64), mmap_lru_windows=(1, 64),
                  min_stage_threads=1, total_threads=6,
                  refresh_period=(1, 16), refresh_frac=(0.05, 0.5))
    rk, pk = rpm.KnobState(**state), tpm.KnobState(**state)
    rm, pm = _model(rpm, rk, **sig), _model(tpm, pk, **sig)
    rn = rc.knob_neighbors(rk, rpm.KnobBounds(**bounds))
    pn = knob_neighbors(pk, tpm.KnobBounds(**bounds))
    assert [(m, dataclasses.asdict(k)) for m, k in pn] == \
        [(m, dataclasses.asdict(k)) for m, k in rn]
    assert pn, "every state here has neighbours"
    for (_, p), (_, r) in zip(pn, rn):
        assert pm.predict(p) == rm.predict(r)
        assert pm._coverage(p) == rm._coverage(r)
        assert pm._stall(p) == rm._stall(r)
        assert pm._staleness_rows(p) == rm._staleness_rows(r)
    assert pm.predict(pk) == rm.predict(rk)


def _drive_tuner(core, pm):
    """Feed one StageTimes sequence (a 3x regression in its second
    window); the model is recalibrated from each window's mean at the
    current knobs."""
    tuner = core.KnobAutoTuner(_engine(core), _bounds(core), interval=2,
                               warmup_windows=1, hysteresis=0.10,
                               veto_windows=2)
    current = pm.KnobState(prefetch_windows=0, mmap_lru_windows=1,
                           sample_threads=4, load_threads=1,
                           train_threads=1)
    scales = [1.0, 1.0, 1.0, 1.0, 3.0, 3.0] + [1.0] * 30

    def model_fn(mean, n):
        return _model(pm, current, t_sc=mean.t_sc, t_sa=mean.t_sa,
                      t_load=mean.t_load, t_load_stall=mean.t_load_stall,
                      t_tran=mean.t_tran, t_tc=mean.t_tc, t_ta=mean.t_ta,
                      loaded_rows_per_iter=1000.0 * n)

    trail = []
    for s in scales:
        nxt = tuner.step(_times(s, core), model_fn, current)
        if nxt is not None:
            current = nxt
        trail.append(dataclasses.asdict(current))
    moves = [(t.move, dataclasses.asdict(t.knobs), t.predicted,
              t.baseline_predicted, t.baseline_wall, t.measured_wall)
             for t in tuner.accepted]
    return tuner.log, moves, tuner.rollbacks, tuner.trials, \
        tuner.report(), trail


def test_tuner_matches_reference():
    ref = _drive_tuner(rc, rpm)
    port = _drive_tuner(tc, tpm)
    assert port == ref
    log, moves, rollbacks, trials, report, _ = port
    assert rollbacks >= 1 and moves and trials >= 2
    assert ("rollback", [m for e, m in log if e == "try"][0]) in log


def _knob_trainer(core, pkg, tmp_path, name, **over):
    ds = pkg.make_dataset("ogbn-products", scale=0.003, seed=0,
                          feature_backend="mmap", partition_rows=1024,
                          spill_dir=str(tmp_path / name))
    cfg = dict(total_batch=128, n_accel=2, hybrid=False, use_drm=False,
               tfp_depth=0, seed=0, use_accel_sampler=False,
               cache_fraction=0.2, cache_refresh=True,
               cache_drift_threshold=1.0)
    cfg.update(over)
    gnn = pkg.GNNConfig(model="sage", layer_dims=ds.layer_dims,
                        fanouts=(4, 3), num_classes=ds.num_classes)
    kw = {"device": "cpu"} if core is tc else {}
    return core.HybridGNNTrainer(ds, gnn, core.HybridConfig(**cfg), **kw)


TRAJECTORY = [dict(prefetch_windows=2), dict(prefetch_windows=0),
              dict(mmap_lru_windows=3), dict(refresh_period=2),
              dict(refresh_frac=0.1, sample_threads=3, load_threads=2,
                   train_threads=1)]


def _knob_effects(tr):
    pf = tr.prefetcher
    return (tr.loader.source.lru_windows, pf is not None,
            pf.max_queue if pf is not None else None,
            tr.cache.max_refresh_frac, dict(tr.runtime.assignment.threads),
            tr._refresh_period, dataclasses.asdict(tr._knobs))


def test_apply_knobs_matches_reference(tmp_path):
    ref = _knob_trainer(rc, rg, tmp_path, "r")
    port = _knob_trainer(tc, tg, tmp_path, "p")
    static = _knob_trainer(tc, tg, tmp_path, "s")
    port.set_params({k: np.asarray(v) for k, v in ref.params.items()})
    static.set_params({k: np.asarray(v) for k, v in ref.params.items()})
    assert _knob_effects(port) == _knob_effects(ref)
    losses = {"p": [], "s": [], "r": []}
    for move in TRAJECTORY:
        for tr, pm, key in ((ref, rpm, "r"), (port, tpm, "p")):
            k = dataclasses.replace(tr._knobs, **move)
            assert isinstance(k, pm.KnobState)
            tr._apply_knobs(k)
            losses[key] += [m.loss for m in tr.train(1)]
        losses["s"] += [m.loss for m in static.train(1)]
        assert _knob_effects(port) == _knob_effects(ref), move
    assert port.prefetcher is None and port.loader.source.lru_windows == 3
    assert losses["p"] == losses["s"]
    np.testing.assert_allclose(losses["p"], losses["r"], rtol=0, atol=1e-4)
    for tr in (ref, port, static):
        tr.close()


_COUNTER_FIELDS = ("dup_factor", "hit_rate", "touched_windows",
                   "loaded_rows_per_iter", "row_bytes", "disk_tier",
                   "refresh_bytes_per_iter", "hit_decay_per_iter",
                   "prefetch_drop_rate")


def test_knob_model_inputs_match_reference(tmp_path):
    """Over one sequential run, the counter-derived fields of the
    SignalSnapshot the trainer calibrates are the reference's; the time
    fields are not compared."""
    out = []
    for core, pkg, name in ((rc, rg, "r"), (tc, tg, "p")):
        tr = _knob_trainer(core, pkg, tmp_path, name, prefetch_windows=2,
                           mmap_lru_windows=4)
        sigs = []
        for _ in range(2):
            tr.train(3)
            m = tr._build_knob_model(core.StageTimes(t_load=0.01), 3)
            sigs.append({f: getattr(m.signals, f) for f in _COUNTER_FIELDS})
        tr.close()
        out.append(sigs)
    assert out[1] == out[0]
    assert out[1][0]["disk_tier"] and out[1][0]["touched_windows"] >= 1
    assert out[1][1]["dup_factor"] > 1.0


# -------------------------------------------------------------------- CLI


def test_train_gnn_cli_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train_gnn
    sched = tmp_path / "faults.json"
    sched.write_text(json.dumps({"seed": 0, "schedule": [
        {"op": "storage.take", "kind": "transient", "start": 0,
         "count": 1},
        {"op": "storage.prefetch", "kind": "transient", "start": 1,
         "count": 1}]}))
    res = train_gnn.main([
        "--device", "cpu", "--scale", "2e-4", "--iters", "8",
        "--batch", "256", "--n-accel", "2", "--feature-backend", "mmap",
        "--spill-dir", str(tmp_path / "spill"), "--prefetch-windows", "2",
        "--cache-fraction", "0.2", "--cache-refresh", "--auto-tune",
        "--autotune-interval", "2", "--inject-failure", "3",
        "--fault-schedule", str(sched), "--pipeline-watchdog", "60",
        "--ckpt-dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert len(res["losses"]) == 8 and np.all(np.isfinite(res["losses"]))
    assert res["failed"] == ["accel0"]
    assert "survived failures: ['accel0']" in out
    assert "health: " in out and "autotune: " in out
    assert "faults injected: " in out
    assert res["faults"]["faults_raised"] == 2
    assert res["storage_io"]["io_retries"] == 2.0
    assert res["autotune"]["enabled"]


def test_train_gnn_default_device_requires_cuda(monkeypatch):
    from repro_torch.launch import train_gnn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_gnn.main(["--dataset", "ogbn-products", "--scale", "5e-4",
                        "--iters", "1"])
