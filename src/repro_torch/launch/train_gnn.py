"""GNN training CLI (port of ``examples/hybrid_gnn_training.py``): train a
2-layer GraphSAGE/GCN with hidden 256, the paper's model setup, on a
synthetic graph scaled from a Table-III dataset, through the whole hybrid
system: the CPU and accelerator trainers, DRM, two-stage prefetching, the
hot-feature cache, the out-of-core tier, checkpoints, fault injection and
the knob autotuner.

``python -m repro_torch.launch.train_gnn --model sage --iters 200
--scale 2e-4 [--device cpu]``

Runs the accelerator trainers on ``cuda:0`` unless ``--device`` says
otherwise; the tensor's device picks each kernel or its plain version, so
the reference's ``--cache-assemble`` has no counterpart.  ``main`` returns
the run's readings (losses, shares, health, autotune report, injected
faults) as a dict.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import HybridConfig, HybridGNNTrainer
from repro_torch.graph import FaultInjector, GNNConfig, make_dataset


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train_gnn")
    ap.add_argument("--model", default="sage", choices=["sage", "gcn"])
    ap.add_argument("--dataset", default="ogbn-papers100M")
    ap.add_argument("--scale", type=float, default=2e-4)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--fanouts", default="10,5")
    ap.add_argument("--n-accel", type=int, default=2)
    ap.add_argument("--agg-impl", default="dense",
                    choices=["dense", "segsum", "pallas", "pallas_fused"])
    ap.add_argument("--cache-fraction", type=float, default=0.0,
                    help="pin this fraction of the hottest node features "
                         "on each accelerator (0 = off)")
    ap.add_argument("--cache-sharding", default="replicated",
                    choices=["replicated", "sharded"],
                    help="'sharded' partitions the hot set into disjoint "
                         "per-accelerator shards; peer shards serve local "
                         "misses and the host gathers the union of all "
                         "trainers' misses once (losses stay bit-identical "
                         "to replicated)")
    ap.add_argument("--shard-placement", default="hash",
                    choices=["hash", "degree"],
                    help="shard placement: 'hash' spreads rows uniformly, "
                         "'degree' keeps contiguous hotness-rank ranges")
    ap.add_argument("--recent-rows-batches", type=int, default=0,
                    help="re-read the last N batches' shipped rows on the "
                         "device instead of shipping them again (0 = off)")
    ap.add_argument("--cache-refresh", action="store_true",
                    help="dynamic cache refresh: swap the coldest slots for "
                         "hotter uncached rows when the measured hit rate "
                         "drifts from the priced one (versioned lookups "
                         "keep batches in flight bit-identical)")
    ap.add_argument("--cache-refresh-frac", type=float, default=0.25,
                    help="max fraction of cache slots swapped per refresh")
    ap.add_argument("--cache-refresh-decay", type=float, default=0.5,
                    help="hotness-counter decay at each refresh window "
                         "boundary (1.0 = never forget)")
    ap.add_argument("--cache-drift-threshold", type=float, default=0.05,
                    help="measured-vs-priced hit-rate drift that triggers "
                         "a refresh and a task-mapping re-price")
    ap.add_argument("--feature-backend", default="auto",
                    choices=["auto", "dense", "hashed", "partitioned",
                             "mmap"],
                    help="feature storage tier: dense/hashed/partitioned "
                         "live in RAM; 'mmap' spills per-partition blobs "
                         "to disk and maps their windows lazily")
    ap.add_argument("--spill-dir", default=None,
                    help="where 'mmap' puts its partition blobs (default: "
                         "a private temp dir, removed on exit)")
    ap.add_argument("--prefetch-windows", type=int, default=0,
                    help="background window-prefetch queue depth: batch "
                         "i+1's frontier is pre-faulted while batch i "
                         "trains (0 = off; needs --feature-backend mmap)")
    ap.add_argument("--prefetch-dedup-history", type=int, default=2,
                    help="strip rows of the last N submitted frontiers "
                         "from new prefetch submits (0 = off)")
    ap.add_argument("--kernel-pipeline-depth", type=int, default=1,
                    help="combine/scatter kernel copy-ring depth: 1 = K1/K5, "
                         "2-4 = K4/K6 (the same bits at every depth)")
    ap.add_argument("--mmap-lru-windows", type=int, default=0,
                    help="bound on open mmap partition windows, evicted "
                         "with MADV_DONTNEED (0 = unbounded)")
    ap.add_argument("--async-refresh", action="store_true",
                    help="stage the refresh's row gather in a background "
                         "thread; the boundary only commits")
    ap.add_argument("--auto-tune", action="store_true",
                    help="model-predictive knob autotuning of prefetch "
                         "depth, window LRU, stage threads and refresh "
                         "cadence/fraction, each move verified against the "
                         "measured iteration time and rolled back on a "
                         "regression (losses stay bit-identical)")
    ap.add_argument("--autotune-interval", type=int, default=3,
                    help="iterations per autotuner measurement window")
    ap.add_argument("--cache-refresh-period", type=int, default=1,
                    help="iteration boundaries between cache drift checks")
    ap.add_argument("--inject-failure", type=int, default=0,
                    help="kill accel0 at this iteration (0 = off)")
    ap.add_argument("--fault-schedule", default=None,
                    help="JSON fault schedule file (a list of FaultSpec "
                         "dicts or {'seed':..,'schedule':..}) injecting "
                         "errors, delays or worker kills at named hooks "
                         "(storage.take, prefetch.worker, refresh.stage, "
                         "pipeline.<stage>, ...), replayable by call index")
    ap.add_argument("--pipeline-watchdog", type=float, default=0.0,
                    help="seconds a pipeline stage may stay wedged before "
                         "a PipelineStallError names it (0 = off)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device of the accelerator trainers "
                         "(default: cuda:0)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = _parser().parse_args(argv)
    fanouts = tuple(int(x) for x in args.fanouts.split(","))
    ds = make_dataset(args.dataset, scale=args.scale, seed=0,
                      feature_backend=args.feature_backend,
                      spill_dir=args.spill_dir,
                      mmap_lru_windows=args.mmap_lru_windows)
    print(f"{ds.name}: |V|={ds.num_nodes:,} |E|={ds.num_edges:,} "
          f"dims={ds.layer_dims}")
    if args.feature_backend == "mmap":
        src = ds.features
        print(f"out-of-core features: {src.num_partitions} partitions of "
              f"{src.partition_rows} rows under {src.spill_dir} "
              f"(spill buffered <= {src.spill_peak_buffered_rows} rows)")
    gnn = GNNConfig(model=args.model, layer_dims=ds.layer_dims,
                    fanouts=fanouts, num_classes=ds.num_classes,
                    agg_impl=args.agg_impl)
    hcfg = HybridConfig(total_batch=args.batch, n_accel=args.n_accel,
                        hybrid=True, use_drm=True, tfp_depth=2, lr=3e-3,
                        cache_fraction=args.cache_fraction,
                        cache_sharding=args.cache_sharding,
                        shard_placement=args.shard_placement,
                        recent_rows_batches=args.recent_rows_batches,
                        cache_refresh=args.cache_refresh,
                        cache_refresh_frac=args.cache_refresh_frac,
                        cache_refresh_decay=args.cache_refresh_decay,
                        cache_drift_threshold=args.cache_drift_threshold,
                        async_refresh=args.async_refresh,
                        prefetch_windows=args.prefetch_windows,
                        prefetch_dedup_history=args.prefetch_dedup_history,
                        kernel_pipeline_depth=args.kernel_pipeline_depth,
                        mmap_lru_windows=args.mmap_lru_windows,
                        pipeline_watchdog_seconds=args.pipeline_watchdog,
                        auto_tune=args.auto_tune,
                        autotune_interval=args.autotune_interval,
                        cache_refresh_period=args.cache_refresh_period,
                        ckpt_every=50 if args.ckpt_dir else 0)
    injector = None
    if args.fault_schedule:
        injector = FaultInjector.from_json(args.fault_schedule)
        print(f"!! fault schedule armed: {len(injector.schedule)} specs "
              f"(seed {injector.seed}) from {args.fault_schedule}")
    tr = HybridGNNTrainer(ds, gnn, hcfg, device=args.device,
                          fault_injector=injector)
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=2)
        tr.set_checkpoint_callback(
            lambda step, p, o: mgr.save(step, {"params": p, "opt": o}))
    if args.inject_failure:
        tr.inject_failure("accel0", args.inject_failure)
        print(f"!! will inject accel0 failure at iter {args.inject_failure}")

    try:
        hist = tr.train(args.iters)
    finally:
        if mgr is not None:
            mgr.finalize()
    for m in hist[:: max(args.iters // 10, 1)]:
        t = m.times
        print(f"it {m.iteration:4d} loss {m.loss:.3f} acc {m.acc:.3f} "
              f"| samp {t.t_sc*1e3:5.1f} load {t.t_load*1e3:5.1f} "
              f"tran {t.t_tran*1e3:5.1f} tc {t.t_tc*1e3:6.1f} "
              f"ta {t.t_ta*1e3:6.1f} ms | {m.mteps:6.2f} MTEPS "
              f"| shares {m.assignment}")
    accs = [m.acc for m in hist[-20:]]
    print(f"\nfinal: loss {hist[-1].loss:.3f}  acc(last20) "
          f"{np.mean(accs):.3f}  mean {tr.mean_mteps():.2f} MTEPS")
    if tr.cache is not None:
        tf = tr.feature_traffic()
        print(f"feature cache: hit {tf['hit_rate']:.3f} "
              f"(model {tr.cache.expected_hit_rate:.3f}), shipped "
              f"{tf['shipped_bytes']/1e6:.1f} MB, saved "
              f"{tf['saved_bytes']/1e6:.1f} MB "
              f"({tf['reduction']:.2f}x reduction)")
        if args.cache_sharding == "sharded" and hasattr(tr.cache, "shards"):
            print(f"sharded plane: {len(tr.cache.shards)} shards "
                  f"({args.shard_placement}), {tr.cache.capacity} resident "
                  f"rows, peer-served {tf['peer_rows']:.0f} rows "
                  f"({tf['peer_saved_bytes']/1e6:.1f} MB off PCIe), union "
                  f"gather saved {tf['union_saved_bytes']/1e6:.1f} MB, "
                  f"ICI {tf['ici_bytes']/1e6:.1f} MB")
        if args.recent_rows_batches:
            print(f"recent-rows LRU: {tf['recent_rows']:.0f} rows reused "
                  f"on device ({tf['recent_saved_bytes']/1e6:.1f} MB not "
                  f"re-shipped)")
        if args.cache_refresh:
            print(f"cache refresh: {tr.cache.refreshes} refreshes moved "
                  f"{tr.cache.refresh_swapped_rows} rows "
                  f"(version {tr.cache.version}, windowed hit "
                  f"{tr.cache.measured_hit_rate():.3f})")
    io = tr.storage_io()
    if args.prefetch_windows or args.mmap_lru_windows:
        print(f"storage I/O: stall {io['load_stall_seconds']*1e3:.1f} ms "
              f"({io['cold_fault_page_bytes']/1e6:.1f} MB cold), prefetch "
              f"hit {io['prefetch_hit_rate']:.2f} "
              f"({io['prefetched_window_bytes']/1e6:.1f} MB pre-faulted), "
              f"evicted {io['evicted_window_bytes']/1e6:.1f} MB over "
              f"{io['window_evictions']:.0f} window evictions")
        if "resubmitted_rows_skipped" in io:
            print(f"prefetch dedup: "
                  f"{io['resubmitted_rows_skipped']:.0f} already-warm rows "
                  f"stripped from resubmits")
    rep = tr.autotune_report()
    if args.auto_tune:
        k = rep["knobs"]
        print(f"autotune: {rep['trials']} trials, {rep['accepted']} "
              f"accepted, {rep['rollbacks']} rolled back -> prefetch "
              f"{k['prefetch_windows']}, lru {k['mmap_lru_windows']}, "
              f"threads {k['sample_threads']}/{k['load_threads']}/"
              f"{k['train_threads']}, refresh 1/{k['refresh_period']} "
              f"@ {k['refresh_frac']:.2f}")
        for mv in rep.get("moves", []):
            print(f"  + {mv['move']}: predicted "
                  f"{mv['baseline_predicted']*1e3:.2f} -> "
                  f"{mv['predicted']*1e3:.2f} ms, measured "
                  f"{mv['baseline_wall']*1e3:.2f} -> "
                  f"{mv['measured_wall']*1e3:.2f} ms")
    h = tr.health()
    failed = h["components"].get("trainers", {}).get("failed", [])
    if failed:
        print(f"survived failures: {failed}")
    line = f"health: {h['status']}"
    if h["events"]:
        line += " — " + "; ".join(
            f"{e['component']} (it {e['iteration']}): {e['action']}"
            for e in h["events"])
    st = h["components"].get("storage", {})
    if st.get("io_errors") or st.get("fallback_gathers"):
        line += (f" | storage: {st['io_errors']} I/O errors, "
                 f"{st['io_retries']} retried, "
                 f"{st['fallback_gathers']} fallback gathers")
    print(line)
    faults = injector.report() if injector is not None else None
    if faults is not None:
        print(f"faults injected: {faults}")
    tr.close()
    return {"losses": [m.loss for m in hist],
            "assignments": [m.assignment for m in hist],
            "failed": failed, "health": h, "autotune": rep,
            "storage_io": io, "faults": faults}


if __name__ == "__main__":
    main()
