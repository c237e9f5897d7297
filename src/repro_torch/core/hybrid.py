"""Hybrid GNN training system (paper Sections III + IV glued together).

Port of ``repro/core/hybrid.py``'s main path.  ``HybridGNNTrainer`` wires
the logical components of Fig. 3/4 into the pipelined runtime:

  Mini-batch Sampler (host numpy; the first batches on
    the card when the CSR fits there)                   -> stage "sample"
  Feature Loader (dedup + hot-cache lookup, host gather) -> stage "load"
  Data Transfer (pinned host->device copies + the
    on-device combine, the paper's Feature Duplicator)  -> stage "transfer"
  GNN Trainers (the CPU trainer on the host, n accelerator trainers on the
    card, unequal shares, one thread each)               -> consumer
  Synchronizer (share-weighted gradient average, Listing 1)
  Runtime + DRM (per-stage times -> next iteration's assignment)

The CPU trainer is the paper's host trainer: it runs in torch on CPU
tensors, so its layers take the plain versions of the kernels.  The
accelerator trainers' inputs, parameters and kernels live on the card;
logical accelerator i runs on ``cuda:i % device_count``.  The authoritative
parameters and the AdamW state live on the first accelerator's device; the
CPU trainer gets a host copy each iteration and its gradients move back for
the average.

Times: the transfer stage issues its copies and the combine on a stream of
its own and waits for that stream before it stops its clock; a trainer
waits for its device's current stream.  ``t_tran`` and ``t_train`` (the
DRM's inputs) therefore measure finished work, as the reference times
after ``block_until_ready``.

The hot-feature cache is dynamic under ``cache_refresh``: at an iteration
boundary whose measured window hit rate drifted past
``cache_drift_threshold``, the cache swaps its coldest slots for hotter
observed rows (``FeatureCache.refresh``; with ``async_refresh`` the row
gather is staged in a background thread and committed at a later
boundary), re-prices the mapping and resets the measurement window.  Every
batch in flight combines against the cache version its lookup was
classified at, so losses are bit-identical with refresh on or off.  The
commit writes the new version block on the training thread's stream and
the combine reads it on the transfer stream: the block's event orders the
two, and the combine marks the block as used by the transfer stream so
its memory is not reused while the combine reads it.  With
``recent_rows_batches`` > 0 rows still resident from an accelerator's last
batches are re-read on the device instead of shipped again (invalidated by
any refresh).

``cache_sharding="sharded"`` (with two or more accelerators and a cache)
partitions the hot set into disjoint per-accelerator shards
(``ShardedFeatureCache``, hash or degree placement): n shards hold n times
the rows at the same per-device budget.  The load stage classifies every
accelerator's frontier in one union lookup and gathers the union of their
host misses once; the transfer stage pulls the rows resident on peer
shards (``dist.exchange_peer_rows``) and combines them with the local
shard and the fresh rows.  Sharding moves bytes, never values: losses are
bit-identical to the replicated cache.  ``kernel_pipeline_depth`` (1..4)
reaches every combine, every peer gather (K1 at 1, K4 at 2..4) and the
cache's refresh scatter (K5 at 1, K6 at 2..4); every depth gives the same
bits.

With ``use_accel_sampler`` (the default, as in the reference) a CSR under
1 GiB is put on the sampling device, and the sample stage draws the first
``round(sample_frac_accel * n)`` of an iteration's n batches there
(``sample_minibatch_torch``, timed as ``t_sa``); the DRM moves that share
from the measured ``t_sa`` and ``t_sc``.  ``compression`` quantizes the
averaged gradients before the optimizer, as the reference's sync path
does, and ``ckpt_every`` hands the parameters and optimizer state to the
callback given to ``set_checkpoint_callback``.

The out-of-core storage tier runs under the same trainer: over an
``MmapFeatures`` source (``make_dataset(feature_backend="mmap")``) the
trainer prices Eq. 7 at storage bandwidth (``feature_tier="disk"``),
``mmap_lru_windows`` bounds the source's open windows (wired before the
cache's boot gather), and ``prefetch_windows`` > 0 starts a
``WindowPrefetcher``: the sample stage hands it each batch's unique
frontier (an accelerator's cache hits removed) one stage before the load
stage gathers it, so the gather finds warm pages.  The load stage reports
the residual cold-page seconds as ``t_load_stall``, which the DRM reads;
the measured prefetch hit rate re-prices the mapping's ``prefetch_overlap``
when it drifts.  A prefetch worker that fails past
``prefetch_restart_budget`` restarts is reported by ``health()`` and the
loads go on synchronously (``degrade_on_failure=False`` raises instead).
All of it is invisible to the losses.  ``storage_io()`` reports the tier's
counters.

Failure model: ``fault_injector`` (a ``graph.faults.FaultInjector``)
reaches the source, the cache (``refresh.stage``), the prefetcher and the
pipeline (``pipeline.<stage>``); a refresh that keeps failing is disabled
after ``refresh_failure_budget`` tries, and ``pipeline_watchdog_seconds``
turns a wedged stage into a ``PipelineStallError``.  ``inject_failure``
kills a trainer at an iteration: it submits zero gradients at weight 0,
drops out of later payloads, and its share folds into the CPU trainer's.
``health()`` reports every degraded component and failed trainer.

With ``auto_tune`` a ``KnobAutoTuner`` closes the DRM loop over the
performance-only knobs (prefetch depth, window LRU, stage threads, refresh
cadence and fraction): each window of ``autotune_interval`` iterations
calibrates a ``CalibratedKnobModel``, applies the best predicted move and
keeps or rolls it back on the next measured window.  No knob touches
shares, RNG streams or batch composition, so losses are bit-identical with
the tuner on or off; ``autotune_report()`` gives the trajectory.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..annotations import guarded_by
from ..device import accel_devices, resolve_device, synchronize, to_device
from ..dist.collectives import exchange_peer_rows
from ..graph.featcache import (ShardPlacement, ShardedFeatureCache,
                               build_cache, build_sharded_cache,
                               compact_lookup)
from ..graph.featload import FeatureLoader, MissBlock, ShardMissBlock
from ..graph.models import (GNNConfig, init_params, loss_fn,
                            params_from_numpy)
from ..graph.prefetch import WindowPrefetcher
from ..graph.sampler import MiniBatch, NumpySampler, sample_minibatch_torch
from ..graph.storage import GraphDataset
from ..kernels.ops import assemble_features, assemble_features_sharded
from ..optim.compression import (CompressionSpec, compress_grads,
                                 decompress_grads)
from ..optim.optimizers import adamw, apply_updates
from .drm import Assignment, KnobAutoTuner, StageTimes
from .perfmodel import (PLATFORMS, CalibratedKnobModel, KnobBounds,
                        KnobState, SignalSnapshot, initial_task_mapping)
from .pipeline import PipelineItem, PrefetchPipeline, Stage
from .protocol import Runtime, Synchronizer, TrainerHandle

__all__ = ["HybridConfig", "HybridGNNTrainer", "IterationMetrics"]

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """The reference's configuration, field for field (``cache_assemble``
    aside: here the tensor's device picks the kernel or its plain
    version)."""
    total_batch: int = 1024
    n_accel: int = 1
    hybrid: bool = True               # CPU trainer participates
    use_drm: bool = True
    tfp_depth: int = 2                # 0 = sequential (no TFP)
    use_accel_sampler: bool = True    # sample on the card when the CSR
                                      #   is under 1 GiB
    compression: str = "none"         # sync-path gradient compression:
                                      #   none | bf16 | int8
    feature_dtype: str = "float32"    # transfer dtype: float32 | bfloat16
    cache_fraction: float = 0.0       # device hot-feature cache (0 = off)
    cache_sharding: str = "replicated"  # | "sharded": a disjoint hot shard
                                      #   per accelerator (n_accel >= 2)
    shard_placement: str = "hash"     # sharded placement: hash | degree
    recent_rows_batches: int = 0
    kernel_pipeline_depth: int = 1    # 1..4: K1/K5 at 1, K4/K6 above
    cache_refresh: bool = False
    cache_refresh_frac: float = 0.25
    cache_refresh_decay: float = 0.5
    cache_drift_threshold: float = 0.05  # measured-vs-priced hit-rate drift
                                      #   that triggers a mapping re-price
    cache_refresh_hysteresis: float = 1.25
    async_refresh: bool = False
    prefetch_windows: int = 0
    prefetch_dedup_history: int = 2
    mmap_lru_windows: int = 0
    dedup: bool = True                # ship unique rows only
    degrade_on_failure: bool = True
    prefetch_restart_budget: int = 2
    refresh_failure_budget: int = 3
    pipeline_watchdog_seconds: float = 0.0
    cache_refresh_period: int = 1
    auto_tune: bool = False
    autotune_interval: int = 3
    autotune_hysteresis: float = 0.10
    autotune_min_gain: float = 0.02
    autotune_warmup_windows: int = 1
    initial_threads: Optional[Tuple[int, int, int]] = None
    lr: float = 1e-3
    share_quantum: int = 64
    drm_damping: float = 0.25
    seed: int = 0
    host_platform: str = "epyc-7763"
    accel_platform: str = "h100-sxm"
    ckpt_every: int = 0               # call the checkpoint callback every
                                      #   N iterations (0 = never)
    ckpt_dir: Optional[str] = None    # for the caller; the trainer does not
                                      #   read it

    def __post_init__(self):
        if self.compression not in CompressionSpec.METHODS:
            raise ValueError(f"compression {self.compression!r}")
        if self.feature_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"feature_dtype {self.feature_dtype!r}")
        if self.cache_sharding not in ("replicated", "sharded"):
            raise ValueError(f"cache_sharding {self.cache_sharding!r}")
        if self.shard_placement not in ShardPlacement.POLICIES:
            raise ValueError(f"shard_placement {self.shard_placement!r}")
        if not 1 <= self.kernel_pipeline_depth <= 4:
            raise ValueError(f"kernel_pipeline_depth must be in 1..4, got "
                             f"{self.kernel_pipeline_depth}")


@dataclasses.dataclass
class IterationMetrics:
    iteration: int
    loss: float
    acc: float
    times: StageTimes
    t_sync: float
    edges: int
    assignment: Tuple[int, int]       # (cpu_batch, accel_batch_each) after
                                      #   this iteration's DRM step
    shares: Dict[str, int] = dataclasses.field(default_factory=dict)
                                      # rows each trainer trained this time
    cache_hit_rate: float = 0.0       # measured cache hit rate (window)
    cache_version: int = 0            # hot-cache version after this
                                      #   iteration's boundary (> 0 once a
                                      #   refresh moved rows)
    device_sampled: Tuple[str, ...] = ()  # trainers whose batch was
                                      #   sampled on the device
    sample_frac_accel: float = 0.0    # the DRM's device-sampling share
                                      #   after this iteration's step

    @property
    def iter_time(self) -> float:
        return self.times.iteration_time()

    @property
    def mteps(self) -> float:
        t = self.iter_time
        return self.edges / t / 1e6 if t > 0 else 0.0


# Deliberately unguarded: _fail_at (written before the run by
# inject_failure, only read during it), _refresh_failures /
# _refresh_disabled / _staged_feedback / _refresh_thread, the refresh and
# autotune bookkeeping (touched only at iteration boundaries on the
# training thread; the refresh worker writes nothing but _refresh_error,
# which is declared), and everything the pipeline hands through
# PipelineItem payloads (queue happens-before).
@guarded_by("_state_lock", "_failed", "_degraded", "_refresh_error")
class HybridGNNTrainer:
    """Hybrid CPU + accelerator trainer.  ``device=None`` runs the
    accelerator trainers on ``cuda:0`` (raising without CUDA); pass
    ``device="cpu"`` to run every trainer on the host."""

    def __init__(self, dataset: GraphDataset, gnn_cfg: GNNConfig,
                 cfg: HybridConfig, device=None, fault_injector=None):
        self.dataset = dataset
        self.gnn_cfg = gnn_cfg
        self.cfg = cfg
        self.fault_injector = fault_injector
        self.device = resolve_device(device)
        self.cpu_device = torch.device("cpu")
        self.accel_devices = accel_devices(self.device, cfg.n_accel)
        self._rng = np.random.default_rng(cfg.seed)
        self._epoch_perm = self._rng.permutation(dataset.num_nodes)
        self._cursor = 0
        self._transfer_streams: Dict[torch.device, Any] = {}
        # failed trainers (added by trainer threads), the degraded-mode
        # record (component -> event) and the async refresh worker's
        # latched error, shared with health() and those threads
        self._state_lock = threading.Lock()
        self._failed: set = set()
        self._fail_at: Dict[str, int] = {}
        self._degraded: Dict[str, Dict[str, Any]] = {}
        self._refresh_failures = 0        # consecutive stage() failures
        self._refresh_disabled = False    # budget spent: refresh is off

        # --- parameters / optimizer (one authoritative copy, on the card) ---
        gen = torch.Generator().manual_seed(cfg.seed)
        self.optimizer = adamw(cfg.lr)
        self.set_params(init_params(gnn_cfg, gen, device=self.device))
        self.compression = CompressionSpec(cfg.compression)
        self._ckpt_cb = None

        # --- samplers: host numpy, and the device's when the CSR fits -------
        self.cpu_sampler = NumpySampler(dataset.graph, gnn_cfg.fanouts,
                                        seed=cfg.seed + 1)
        self._dev_topology: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._sample_stream = None
        if cfg.use_accel_sampler and dataset.graph.nbytes() < (1 << 30):
            g = dataset.graph
            self._dev_topology = (
                to_device(np.ascontiguousarray(g.indptr, np.int64),
                          self.device),
                to_device(np.ascontiguousarray(g.indices), self.device))
            self._sample_gen = torch.Generator(
                device=self.device).manual_seed(cfg.seed + 2)
            if self.device.type == "cuda":
                self._sample_stream = torch.cuda.Stream(self.device)

        # --- background storage I/O (disk tier) ------------------------------
        # the window LRU bounds the page cache and the prefetcher pre-faults
        # a batch's windows one stage before its gather; both are no-ops on
        # RAM-resident sources.  Wired BEFORE the cache: its boot gather
        # streams through the source and must already respect the bound
        src = dataset.feature_source
        if cfg.mmap_lru_windows > 0 and hasattr(src, "lru_windows"):
            src.lru_windows = int(cfg.mmap_lru_windows)
        if fault_injector is not None and hasattr(src, "fault_injector"):
            src.fault_injector = fault_injector
        self.prefetcher: Optional[WindowPrefetcher] = \
            self._build_prefetcher(cfg.prefetch_windows)

        # --- feature store: device hot cache + dedup loader ------------------
        # "sharded" partitions the hot set across the accelerators; below
        # two there is nothing to partition and the cache stays replicated
        refresh_kw = dict(transfer_dtype=cfg.feature_dtype,
                          refresh_decay=cfg.cache_refresh_decay,
                          max_refresh_frac=cfg.cache_refresh_frac,
                          refresh_hysteresis=cfg.cache_refresh_hysteresis)
        if (cfg.cache_sharding == "sharded" and cfg.n_accel >= 2
                and cfg.cache_fraction > 0.0):
            self.cache = build_sharded_cache(
                dataset, cfg.cache_fraction, n_shards=cfg.n_accel,
                placement=cfg.shard_placement, **refresh_kw)
        else:
            self.cache = build_cache(dataset, cfg.cache_fraction,
                                     **refresh_kw)
        self._sharded = isinstance(self.cache, ShardedFeatureCache)
        self.loader = FeatureLoader(dataset, transfer_dtype=cfg.feature_dtype,
                                    cache=self.cache, dedup=cfg.dedup,
                                    recent_batches=cfg.recent_rows_batches)
        # design-time Eq. 7 overlap: a running prefetcher is assumed to hide
        # the storage stream (as TFP assumes for the whole load stage); the
        # re-price reads the measured prefetch hit rate instead, and its
        # drift alone also triggers one (_maybe_refresh_mapping)
        self.prefetch_overlap = 1.0 if self.prefetcher is not None else 0.0
        self._model_prefetch_overlap = self.prefetch_overlap
        # out-of-core features gather through host storage, not RAM: Eq. 7
        # is priced at storage bandwidth
        self.feature_tier = ("disk" if getattr(self.loader.source,
                                               "is_disk_resident", False)
                             else "ram")
        # async staged refresh: one stage() gather in flight at most
        self._refresh_thread: Optional[threading.Thread] = None
        self._refresh_error: Optional[BaseException] = None
        self._staged_feedback: Optional[Tuple[float, float]] = None
        if self.cache is not None:
            if fault_injector is not None:
                self.cache.fault_injector = fault_injector
            self.cache.kernel_pipeline_depth = cfg.kernel_pipeline_depth
            # the hotness counters cost two scattered adds per lookup and a
            # 4 B/node estimate: only when the refresh policy reads them
            self.cache.track_hotness = cfg.cache_refresh
            # with TFP depth d at most d batches sit between load
            # (classification) and transfer (combine), and at most one
            # refresh fires per consumed iteration: d+2 versions cover them
            self.cache.keep_versions = max(2, cfg.tfp_depth + 2)
        # measured duplication factor alpha from one probe mini-batch (its
        # own sampler and rng: the training streams stay untouched)
        self.measured_dedup_alpha = (
            self._probe_dup_factor() if (cfg.dedup and cfg.hybrid) else 1.0)

        # --- initial task mapping from the performance model (design time) ---
        hit_rate = self.cache.expected_hit_rate if self.cache else 0.0
        self._model_hit_rate = hit_rate   # rate the current mapping is priced on
        if cfg.hybrid and cfg.n_accel == 0:
            mapping = {"cpu": cfg.total_batch, "accel_each": 0}
        elif cfg.hybrid:
            mapping = initial_task_mapping(
                PLATFORMS[cfg.host_platform], PLATFORMS[cfg.accel_platform],
                cfg.n_accel, cfg.total_batch, gnn_cfg.fanouts,
                gnn_cfg.layer_dims, model=gnn_cfg.model,
                cache_hit_rate=hit_rate,
                dedup_factor=self.measured_dedup_alpha,
                feature_tier=self.feature_tier,
                prefetch_overlap=self.prefetch_overlap)
        else:
            mapping = {"cpu": 0,
                       "accel_each": cfg.total_batch // max(cfg.n_accel, 1)}
        thr = cfg.initial_threads or (2, 2, 2)
        assignment = Assignment(
            cpu_batch=mapping["cpu"], accel_batch=mapping["accel_each"],
            n_accel=cfg.n_accel,
            sample_frac_accel=0.5 if self._dev_topology is not None else 0.0,
            threads={"sample": int(thr[0]), "load": int(thr[1]),
                     "train": int(thr[2])})
        self.runtime = Runtime(assignment, use_drm=cfg.use_drm,
                               damping=cfg.drm_damping,
                               share_quantum=cfg.share_quantum)
        # refresh cadence and the measured admission traffic the Eq. 7/8
        # re-price reads; the staleness rate is the knob autotuner's input
        self._refresh_period = max(1, int(cfg.cache_refresh_period))
        self._iters_done = 0
        self._iters_since_refresh = 0
        self._refresh_bytes_per_iter = 0.0
        self._hit_decay_per_iter = 0.0

        # --- model-predictive knob autotuning (closes the DRM loop) ----------
        self._last_load_stats = self.loader.snapshot_stats()
        self._last_windows_touched = int(
            getattr(src, "gather_windows_touched", 0))
        self.autotuner: Optional[KnobAutoTuner] = None
        self._knobs = KnobState(
            prefetch_windows=(cfg.prefetch_windows
                              if self.prefetcher is not None else 0),
            mmap_lru_windows=int(getattr(src, "lru_windows", 0)),
            sample_threads=int(thr[0]), load_threads=int(thr[1]),
            train_threads=int(thr[2]),
            refresh_period=self._refresh_period,
            refresh_frac=float(cfg.cache_refresh_frac))
        if cfg.auto_tune:
            # a range opens only where its subsystem exists; the others
            # stay frozen at their current value
            can_prefetch = hasattr(src, "prefetch_rows")
            can_lru = hasattr(src, "lru_windows")
            lru0 = self._knobs.mmap_lru_windows
            refresh_on = cfg.cache_refresh and self.cache is not None
            bounds = KnobBounds(
                prefetch_windows=(0, 64) if can_prefetch else (0, 0),
                # lru 0 is unbounded: the search may bound it, never
                # below one window
                mmap_lru_windows=(1, 4096) if can_lru else (lru0, lru0),
                min_stage_threads=1,
                total_threads=self._knobs.total_threads,
                refresh_period=((1, 16) if refresh_on
                                else (self._refresh_period,
                                      self._refresh_period)),
                refresh_frac=((0.05, 0.5) if refresh_on
                              else (self._knobs.refresh_frac,
                                    self._knobs.refresh_frac)))
            self.autotuner = KnobAutoTuner(
                self.runtime.drm, bounds,
                interval=cfg.autotune_interval,
                hysteresis=cfg.autotune_hysteresis,
                min_gain=cfg.autotune_min_gain,
                warmup_windows=cfg.autotune_warmup_windows)
        self.history: List[IterationMetrics] = []

    # ------------------------------------------------------------ utilities

    def set_params(self, params: Mapping[str, Any]) -> None:
        """Replace the parameters (tensors or array-likes, e.g. weights
        carried across from the reference) and restart the optimizer."""
        arrays = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                      else v) for k, v in params.items()}
        self.params: Params = params_from_numpy(arrays, self.device)
        self.opt_state = self.optimizer.init(self.params)

    def _build_prefetcher(self, windows: int
                          ) -> Optional[WindowPrefetcher]:
        """The background window prefetcher, or None when the knob is off or
        the source cannot page-fault.  Shared by ``__init__`` and the
        autotuner's ``prefetch_windows`` moves."""
        src = self.dataset.feature_source
        if windows <= 0 or not hasattr(src, "prefetch_rows"):
            return None
        return WindowPrefetcher(
            src, max_queue=int(windows),
            dedup_history=self.cfg.prefetch_dedup_history,
            restart_budget=self.cfg.prefetch_restart_budget,
            raise_on_failure=not self.cfg.degrade_on_failure,
            fault_injector=self.fault_injector)

    def _probe_dup_factor(self) -> float:
        """alpha = unique-miss / positional-miss frontier rows of one probe
        mini-batch at the accelerator-only share, classified against the
        cache exactly like the transfer path."""
        probe_n = max(1, self.cfg.total_batch // max(self.cfg.n_accel, 1))
        rng = np.random.default_rng(self.cfg.seed + 17)
        tgt = rng.integers(0, self.dataset.num_nodes, probe_n)
        sampler = NumpySampler(self.dataset.graph, self.gnn_cfg.fanouts,
                               seed=self.cfg.seed + 17)
        mb = sampler.sample(tgt, self.dataset.labels[tgt])
        frontier = mb.frontier(len(self.gnn_cfg.fanouts))
        look = compact_lookup(
            frontier, self.cache.slot_of if self.cache is not None else None)
        if look.miss_positions == 0:      # fully cached probe: no traffic
            return 1.0
        return look.num_miss / look.miss_positions

    def inject_failure(self, trainer_name: str, at_iteration: int) -> None:
        """Fault-tolerance hook: trainer ``trainer_name`` dies at iteration
        ``at_iteration`` of the next ``train`` call."""
        self._fail_at[trainer_name] = at_iteration

    def set_checkpoint_callback(self, cb) -> None:
        """``cb(iteration, params, opt_state)`` runs after every
        ``ckpt_every``-th iteration."""
        self._ckpt_cb = cb

    def _next_targets(self, n: int) -> np.ndarray:
        if self._cursor + n > len(self._epoch_perm):
            self._epoch_perm = self._rng.permutation(self.dataset.num_nodes)
            self._cursor = 0
        out = self._epoch_perm[self._cursor:self._cursor + n]
        self._cursor += n
        return out

    def _accel_device(self, name: str) -> torch.device:
        """Device of accelerator trainer ``name`` ("accelN" -> ordinal N)."""
        ordinal = int(name[len("accel"):])
        return self.accel_devices[ordinal % len(self.accel_devices)]

    def _transfer_stream(self, dev: torch.device):
        s = self._transfer_streams.get(dev)
        if s is None:
            s = self._transfer_streams[dev] = torch.cuda.Stream(dev)
        return s

    def _active_trainers(self) -> List[Tuple[str, str]]:
        """[(name, kind)] of the trainers with a share, failed ones out."""
        out = []
        cpu_b, accel_b = self.runtime.quantized_shares()
        with self._state_lock:
            failed = set(self._failed)
        if cpu_b > 0 and "cpu" not in failed:
            out.append(("cpu", "cpu"))
        for i in range(self.cfg.n_accel):
            name = f"accel{i}"
            if name not in failed and accel_b > 0:
                out.append((name, "accel"))
        return out

    # ------------------------------------------------------- pipeline stages

    def _make_payload(self, it: int) -> PipelineItem:
        cpu_b, accel_b = self.runtime.quantized_shares()
        shares = {name: (cpu_b if kind == "cpu" else accel_b)
                  for name, kind in self._active_trainers()}
        payload = {"iteration": it, "shares": shares, "minibatch": {},
                   "features": {}, "t": {},
                   "targets": {n: self._next_targets(b)
                               for n, b in shares.items()}}
        return PipelineItem(seq=it, payload=payload)

    def _stage_sample(self, item: PipelineItem) -> PipelineItem:
        """Sample every trainer's batch: the first ``round(frac * n)``
        names in payload order ("cpu" first) on the device, the rest on the
        host, as the reference routes them (Python's ``round`` halves to
        even: at two trainers and frac 0.5 the CPU trainer's batch is the
        one sampled on the device)."""
        p = item.payload
        frac = self.runtime.assignment.sample_frac_accel
        names = list(p["targets"])
        n_dev = (int(round(frac * len(names)))
                 if self._dev_topology is not None else 0)
        t_sc = t_sa = 0.0
        # a device batch's frontier ids, brought to the host once here: the
        # prefetch submit below and the load stage's gather both read them
        p["host_frontier"] = {}
        for i, name in enumerate(names):
            tgt = p["targets"][name]
            labels = self.dataset.labels[tgt]
            t0 = time.perf_counter()
            if i < n_dev:
                p["minibatch"][name], p["host_frontier"][name] = \
                    self._sample_on_device(tgt, labels)
                t_sa += time.perf_counter() - t0
            else:
                p["minibatch"][name] = self.cpu_sampler.sample(tgt, labels)
                t_sc += time.perf_counter() - t0
        p["t"]["t_sc"], p["t"]["t_sa"] = t_sc, t_sa
        p["device_sampled"] = tuple(names[:n_dev])
        self._submit_prefetch(p)
        return item

    def _submit_prefetch(self, p: Dict[str, Any]) -> None:
        """TFP lookahead into background storage I/O: this batch's frontier
        is known one stage before its load-stage gather runs, so the ids the
        gather will touch (unique, minus the rows an accelerator's cache
        serves; the CPU trainer reads its whole frontier from the source)
        go to the window prefetcher.  ``submit`` never blocks (a full queue
        drops).  With ``degrade_on_failure`` a worker dead past its restart
        budget just stops being fed: loads run synchronously, the overlap
        re-prices to 0 and ``health()`` reports the component; otherwise
        ``submit`` raises through the pipeline's stage-failure protocol."""
        pf = self.prefetcher
        if pf is None or not p["minibatch"] or pf.failed:
            return
        depth = len(self.gnn_cfg.fanouts)
        parts = []
        for name, mb in p["minibatch"].items():
            ids = p["host_frontier"].get(name)
            ids = np.unique(mb.frontier(depth) if ids is None else ids)
            if name != "cpu" and self.cache is not None:
                ids = ids[self.cache.slot_of[ids] < 0]
            parts.append(ids)
        pf.submit(np.unique(np.concatenate(parts)))
        if pf.failed:
            self._note_degraded(
                "prefetcher", pf.errors[0] if pf.errors else None,
                action="window prefetch disabled; loads run synchronously "
                       "and prefetch_overlap re-prices to 0")

    def _sample_on_device(self, tgt: np.ndarray, labels: np.ndarray
                          ) -> Tuple[MiniBatch, np.ndarray]:
        """One batch from the device sampler and its innermost frontier on
        the host, returned once the sampler's work is done (``t_sa`` stops
        there, as the reference's ``block_until_ready``).  On a card it runs
        on a stream of its own, the frontier's copy to pinned host memory
        included, and one synchronize of that stream covers both: waiting
        for the default stream would also wait for the trainers' kernels
        queued there.  Since the host has waited, the consumers need no
        event; the batch is marked as used by the default stream, where the
        trainer reads it and cross-device copies run, so its memory is not
        handed back to the sampling stream before then."""
        dev = self.device
        with torch.cuda.stream(self._sample_stream):
            mb = sample_minibatch_torch(
                self._sample_gen, *self._dev_topology,
                to_device(tgt, dev), to_device(labels, dev),
                self.gnn_cfg.fanouts)
            front = mb.frontier(len(self.gnn_cfg.fanouts))
            if self._sample_stream is not None:
                host = torch.empty(front.shape, dtype=front.dtype,
                                   pin_memory=True)
                front = host.copy_(front, non_blocking=True)
        if self._sample_stream is not None:
            self._sample_stream.synchronize()
            mb.record_stream(torch.cuda.default_stream(dev))
        return mb, front.numpy()

    def _stage_load(self, item: PipelineItem) -> PipelineItem:
        p = item.payload
        self.loader.num_threads = self.runtime.assignment.threads.get("load", 1)
        host = p["host_frontier"]
        t0 = time.perf_counter()
        stall0 = self._load_stall()
        # sharded plane: ONE union lookup and host gather serve every
        # accelerator trainer of the batch (each unique miss row gathered
        # once and handed to each trainer that needs it)
        accel_mbs = {n: mb for n, mb in p["minibatch"].items() if n != "cpu"}
        if self._sharded and accel_mbs:
            ordinals = {n: int(n[len("accel"):]) for n in accel_mbs}
            p["features"].update(self.loader.load_union(
                accel_mbs, ordinals, pin=True, frontiers=host))
        for name, mb in p["minibatch"].items():
            if self._sharded and name != "cpu":
                continue      # served by the union gather above
            # accelerator trainers take the compact transfer path (unique
            # miss rows against the on-device hot cache, or plain unique
            # rows when uncached); the CPU trainer's "device" is host
            # memory, so it reads its full positional frontier in place
            if name != "cpu" and (self.cache is not None or self.cfg.dedup):
                p["features"][name] = self.loader.load_compact(
                    mb, pin=self.cache is not None,
                    recent_key=(name if self.cfg.recent_rows_batches > 0
                                else None),
                    frontier=host.get(name))
            else:
                p["features"][name] = self.loader.load(
                    mb, to_device=(name != "cpu"), frontier=host.get(name))
        p["t"]["t_load"] = time.perf_counter() - t0
        # the storage stall share of the load (cold pages the prefetcher did
        # not hide), which the DRM reads through StageTimes
        p["t"]["t_load_stall"] = self._load_stall() - stall0
        return item

    def _load_stall(self) -> float:
        """The loader's cumulative cold-page seconds, both windows."""
        return (self.loader.snapshot("stats").stall_seconds
                + self.loader.snapshot("host_stats").stall_seconds)

    def _ship_rows(self, rows: torch.Tensor, bucket_cap: int,
                   dev: torch.device) -> torch.Tensor:
        """Copy a block's host rows to ``dev``, padded to a 128-row bucket
        (never past ``bucket_cap``), as the reference pads them to bound
        its compiled shapes; the padding crosses the link, so it is charged
        to the shipped bytes and the two packages account identically."""
        m = int(rows.shape[0])
        bucket = min(-(-m // 128) * 128, bucket_cap)
        if m < bucket:
            pad = bucket - m
            rows = torch.cat([rows, rows.new_zeros((pad, rows.shape[1]))])
            self.loader.note_transfer_padding(
                pad, pad * rows.shape[1] * rows.element_size())
        return to_device(rows, dev)

    def _cache_block(self, cache, dev: torch.device,
                     version: int) -> torch.Tensor:
        """``cache``'s block on ``dev`` at the version a lookup was
        classified at (a refresh since the load stage must not rebind its
        slots).  On a card the current stream reads it: its memory must not
        be reused before that read ran, even once the version retires."""
        block = cache.data_on(dev, version=version)
        if dev.type == "cuda":
            block.record_stream(torch.cuda.current_stream(dev))
        return block

    def _assemble(self, block: MissBlock, dev: torch.device) -> torch.Tensor:
        """Ship the unique-miss rows + index tables and combine them with
        the cached rows into the positional layer-0 input on ``dev``."""
        look = block.lookup
        miss = self._ship_rows(block.rows, look.num_rows, dev)
        if block.shipped is not None:
            # publish the device rows for the recent-rows LRU; only later
            # batches' transfer stages (in batch order) read them, and the
            # padding rows sit past every index they use
            block.shipped.array = miss
        if block.recent:
            # rows still resident from recent batches, re-read on the
            # device ahead of the fresh block: [recent segments | fresh]
            segs = [torch.index_select(e.array, 0, to_device(idx, dev))
                    for e, idx in block.recent]
            miss = torch.cat(segs + [miss])
        slots = to_device(look.slots, dev)
        miss_index = to_device(look.miss_index, dev)
        cache_data = None
        if self.cache is not None:
            cache_data = self._cache_block(self.cache, dev, look.version)
            self.cache.release_lookup(look)
        return assemble_features(cache_data, miss, slots, miss_index,
                                 self.cfg.kernel_pipeline_depth)

    def _assemble_sharded(self, block: ShardMissBlock,
                          dev: torch.device) -> torch.Tensor:
        """Sharded-plane combine: the layer-0 input is assembled from the
        LOCAL shard block (slot hits), the rows pulled from peer shards (in
        ring order) and the fresh rows the union gather shipped, the
        combined source ``[peer rows | fresh rows]`` the union lookup's
        ``miss_index`` addresses.  Every shard block is read at the version
        the lookup pinned, so a refresh mid-pipeline stays invisible."""
        sl = block.shard
        look = block.lookup
        depth = self.cfg.kernel_pipeline_depth
        miss = self._ship_rows(block.rows, max(look.num_rows, 1), dev)
        local = self._cache_block(self.cache.shards[sl.shard], dev,
                                  look.version)
        # each peer gather runs on the owner's device at the pinned
        # version; only the requested rows hop to this device
        peers = exchange_peer_rows(
            sl.peer_requests,
            lambda peer, ver: self.cache.shards[peer].data_on(
                self._accel_device(f"accel{peer}"), version=ver),
            dev, depth)
        x = assemble_features_sharded(
            local, peers + [miss], to_device(look.slots, dev),
            to_device(look.miss_index, dev), depth)
        # the combine and the peer gathers are queued on their blocks:
        # release every shard pin so drained versions retire eagerly
        self.cache.release_union(sl)
        return x

    def _stage_transfer(self, item: PipelineItem) -> PipelineItem:
        p = item.payload
        t0 = time.perf_counter()
        streams = []
        # the payload's own trainers (the DRM may have re-quantized a share
        # to 0 since it was sampled), minus the ones that died since
        with self._state_lock:
            failed = set(self._failed)
        for name in list(p["features"]):
            if name in failed:
                continue
            if name == "cpu":
                dev, stream = self.cpu_device, None
            else:
                dev = self._accel_device(name)
                stream = (self._transfer_stream(dev) if dev.type == "cuda"
                          else None)
            with torch.cuda.stream(stream):
                feat = p["features"][name]
                if isinstance(feat, ShardMissBlock):
                    x = self._assemble_sharded(feat, dev)
                elif isinstance(feat, MissBlock):
                    x = self._assemble(feat, dev)
                else:
                    x = to_device(feat, dev)
                p["features"][name] = x
                p["minibatch"][name] = p["minibatch"][name].to(dev)
            if stream is not None:
                streams.append(stream)
        for s in streams:
            s.synchronize()
        p["t"]["t_tran"] = time.perf_counter() - t0
        return item

    # ------------------------------------------------------------- training

    def _grad(self, params: Params, batch: MiniBatch, x0: torch.Tensor
              ) -> Tuple[Params, Dict[str, torch.Tensor]]:
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss, acc = loss_fn(leaves, self.gnn_cfg, batch, x0)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return (dict(zip(leaves, grads)),
                {"loss": loss.detach(), "acc": acc.detach()})

    def _run_trainers(self, item: PipelineItem
                      ) -> Tuple[Params, Dict[str, float], Dict[str, float]]:
        p = item.payload
        # exactly the trainers this batch was sampled for, minus any that
        # have failed since
        with self._state_lock:
            failed = set(self._failed)
        names = [n for n in p["minibatch"] if n not in failed]
        if not names:         # every trainer of this batch has died
            zero = {k: torch.zeros_like(v) for k, v in self.params.items()}
            return (zero, {"t_tc": 0.0, "t_ta": 0.0},
                    {"loss": float("nan"), "acc": float("nan")})
        sync = Synchronizer(len(names), self.device)
        results: Dict[str, Dict[str, Any]] = {}
        errors: List[BaseException] = []
        host_params = ({k: v.to(self.cpu_device)
                        for k, v in self.params.items()}
                       if "cpu" in names else None)

        def work(idx: int, name: str) -> None:
            if self._fail_at.get(name) == p["iteration"]:
                # an injected death, not an error: zero gradients at
                # weight 0, and the trainer leaves later payloads
                with self._state_lock:
                    self._failed.add(name)
                sync.submit(idx, {k: torch.zeros_like(v)
                                  for k, v in self.params.items()}, 0.0)
                results[name] = {"loss": float("nan"), "acc": float("nan"),
                                 "t_train": 0.0, "failed": True}
                return
            try:
                kind = "cpu" if name == "cpu" else "accel"
                dev = (self.cpu_device if kind == "cpu"
                       else self._accel_device(name))
                params = (host_params if kind == "cpu"
                          else {k: v.to(dev) for k, v in self.params.items()})
                handle = TrainerHandle(name=name, kind=kind, device=dev,
                                       grad_fn=self._grad, index=idx)
                results[name] = handle.run(
                    sync, params, float(p["shares"][name]),
                    p["minibatch"][name], p["features"][name])
            except BaseException as e:  # re-raised on the training thread
                errors.append(e)

        threads = [threading.Thread(target=work, args=(i, n))
                   for i, n in enumerate(names)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        avg = sync.all_reduce()
        # stage-time bookkeeping for the DRM engine
        t_tc = max((m["t_train"] for n, m in results.items()
                    if n == "cpu"), default=0.0)
        t_ta = max((m["t_train"] for n, m in results.items()
                    if n != "cpu"), default=0.0)
        ok = {n: m for n, m in results.items() if not m.get("failed")}
        w = {n: float(p["shares"][n]) for n in ok}
        wsum = max(sum(w.values()), 1e-9)
        loss = sum(float(m["loss"]) * w[n] for n, m in ok.items()) / wsum
        acc = sum(float(m["acc"]) * w[n] for n, m in ok.items()) / wsum
        return avg, {"t_tc": t_tc, "t_ta": t_ta}, {"loss": loss, "acc": acc}

    def _apply_update(self, grads: Params) -> float:
        t0 = time.perf_counter()
        if self.compression.method != "none":
            comp = compress_grads(grads, self.compression)
            grads = decompress_grads(comp, self.compression, self.params)
        updates, self.opt_state = self.optimizer.update(
            grads, self.opt_state, self.params)
        self.params = apply_updates(self.params, updates)
        synchronize(self.device)
        return time.perf_counter() - t0

    # ------------------------------------------- measured-hit-rate feedback

    def _window_alpha(self, stats) -> float:
        """Eq. 7/8 alpha from measured window stats: unique-miss /
        positional-miss rows."""
        miss_positions = stats.total_rows - stats.hit_rows
        if not (self.cfg.dedup and miss_positions > 0):
            return 1.0
        dedup_saved_rows = stats.dedup_saved_bytes // self.cache.row_bytes
        return 1.0 - dedup_saved_rows / miss_positions

    def _measured_prefetch_overlap(self) -> float:
        """Eq. 7's overlap term from measurement: the fraction of the load
        stage's window touches the prefetcher served warm (the design-time
        estimate before any disk traffic)."""
        if self.prefetcher is None or self.prefetcher.failed:
            # a dead prefetcher hides nothing: every disk touch is a cold
            # fault, so the mapping prices the full storage penalty
            return 0.0
        src = self.loader.source
        touches = (getattr(src, "prefetch_hit_windows", 0)
                   + getattr(src, "prefetch_miss_windows", 0))
        if touches == 0:
            return self.prefetch_overlap
        return float(src.prefetch_hit_rate)

    def _sharded_pricing(self, measured: float) -> Tuple[float, float, float]:
        """Split a measured hit rate into its (local, peer) parts and derive
        the union multicast factor from the window stats: the sharded
        plane's Eq. 7/8 terms.  The window's hit rate counts local AND peer
        positions (neither touches the host), so the model's
        ``cache_hit_rate`` gets the local part only."""
        if not self._sharded:
            return measured, 0.0, 1.0
        win = self.loader.snapshot("window")
        if win.total_rows == 0:
            return measured, 0.0, 1.0
        rb = self.cache.row_bytes
        peer = (win.peer_saved_bytes / rb) / win.total_rows
        shipped = win.bytes - win.padding_bytes
        denom = shipped + win.union_saved_bytes
        uf = shipped / denom if denom > 0 else 1.0
        return max(measured - peer, 0.0), peer, uf

    def _reprice_mapping(self, measured: float, alpha: float) -> None:
        """Re-run the initial task mapping with a measured hit rate and
        alpha and hand the shares to the runtime (the DRM fine-tunes from
        there)."""
        overlap = self._measured_prefetch_overlap()
        local, peer, uf = self._sharded_pricing(measured)
        mapping = initial_task_mapping(
            PLATFORMS[self.cfg.host_platform],
            PLATFORMS[self.cfg.accel_platform],
            self.cfg.n_accel, self.cfg.total_batch,
            self.gnn_cfg.fanouts, self.gnn_cfg.layer_dims,
            model=self.gnn_cfg.model, cache_hit_rate=local,
            dedup_factor=alpha, feature_tier=self.feature_tier,
            prefetch_overlap=overlap, peer_hit_rate=peer, union_factor=uf,
            refresh_bytes_per_iter=self._refresh_bytes_per_iter)
        self._model_prefetch_overlap = overlap
        a = self.runtime.assignment
        n = max(self.cfg.n_accel, 1)
        a.accel_batch = mapping["accel_each"]
        a.cpu_batch = self.cfg.total_batch - a.accel_batch * n
        self._model_hit_rate = measured
        self.measured_dedup_alpha = alpha

    def _maybe_refresh_cache(self) -> bool:
        """Dynamic cache refresh on the drift signal: when the measured
        window hit rate drifts past ``cache_drift_threshold`` from the rate
        the mapping was priced with, swap the coldest slots for the hottest
        observed uncached rows.  When rows move the mapping is re-priced at
        once on the drifted measurement and the window resets.  Returns
        True when the refresh moved rows."""
        if self.cache is None or not self.cfg.cache_refresh \
                or self._refresh_disabled:
            return False
        if self.cfg.async_refresh:
            return self._async_refresh_step()
        win = self.loader.snapshot("window")
        if win.total_rows == 0:
            return False
        measured = win.hit_rate
        if abs(measured - self._model_hit_rate) <= \
                self.cfg.cache_drift_threshold:
            return False
        try:
            swapped = self.cache.refresh()
        except Exception as e:
            # degraded mode: the current version keeps serving; retry at
            # the next drift boundary (bounded by the budget)
            self._handle_refresh_failure(e)
            return False
        self._refresh_failures = 0
        self._finish_refresh(swapped, measured, self._window_alpha(win))
        return swapped > 0

    def _handle_refresh_failure(self, err: BaseException,
                                context: Optional[str] = None) -> None:
        """Shared refresh-failure protocol (sync and async): discard any
        staged plan, count the consecutive failure, then re-raise
        (``degrade_on_failure=False``) or degrade: retry at the next drift
        boundary until ``refresh_failure_budget`` consecutive failures
        disable refresh for the rest of the run."""
        self._refresh_failures += 1
        if self.cache is not None:
            self.cache.discard_staged()
        if not self.cfg.degrade_on_failure:
            if context is not None:
                raise RuntimeError(context) from err
            raise err
        if self._refresh_failures >= self.cfg.refresh_failure_budget \
                and not self._refresh_disabled:
            self._refresh_disabled = True
            self._note_degraded(
                "refresh", err,
                action=f"dynamic cache refresh disabled after "
                       f"{self._refresh_failures} consecutive stage "
                       f"failures; serving cache version "
                       f"{self.cache.version if self.cache else 0}")

    def _finish_refresh(self, swapped: int, measured: float,
                        alpha: float) -> None:
        """Post-refresh bookkeeping of the sync and async paths: when rows
        moved, the measured admission traffic (swapped rows over the
        iterations since the last refresh) and staleness rate, then the
        re-price (or, without a mapping, the drift anchor) and a fresh
        measurement window."""
        with self._state_lock:
            any_failed = bool(self._failed)
        reprice = (self.cfg.hybrid and self.cfg.n_accel > 0
                   and not any_failed)
        if swapped:
            iters = max(self._iters_since_refresh, 1)
            self._refresh_bytes_per_iter = (
                swapped * self.cache.row_bytes / iters)
            self._hit_decay_per_iter = (
                max(self._model_hit_rate - measured, 0.0) / iters)
            self._iters_since_refresh = 0
            if reprice:
                self._reprice_mapping(measured, alpha)
            else:
                # no mapping to re-price: anchor the drift signal on the
                # measured rate so a converged cache stops re-triggering
                self._model_hit_rate = measured
            self.loader.reset_window()
        elif not reprice:
            # nothing hotter was uncached: anchor here too, or the armed
            # signal re-runs the O(num_nodes) candidate scan every
            # iteration (hybrid runs leave it to the mapping feedback)
            self._model_hit_rate = measured

    def _async_refresh_step(self) -> bool:
        """One boundary step of the staged refresh:

          idle + drift     -> snapshot the drifted measurement and start
                              ``stage()`` (the row gather) in a background
                              thread;
          stage running    -> nothing;
          stage finished   -> ``commit()`` and the usual bookkeeping on the
                              measurement snapshotted at stage time.

        Losses stay bit-identical to the sync path and to refresh off:
        whatever boundary the commit lands on, batches in flight combine
        against the version their lookup was classified at."""
        t = self._refresh_thread
        if t is not None:
            if t.is_alive():
                return False
            self._refresh_thread = None
            with self._state_lock:
                err, self._refresh_error = self._refresh_error, None
            if err is not None:
                self._staged_feedback = None
                self._handle_refresh_failure(
                    err, context="async cache-refresh stage() failed")
                return False
            measured, alpha = self._staged_feedback
            self._staged_feedback = None
            swapped = self.cache.commit()
            self._refresh_failures = 0
            self._finish_refresh(swapped, measured, alpha)
            return swapped > 0
        win = self.loader.snapshot("window")
        if win.total_rows == 0:
            return False
        measured = win.hit_rate
        if abs(measured - self._model_hit_rate) <= \
                self.cfg.cache_drift_threshold:
            return False
        self._staged_feedback = (measured, self._window_alpha(win))

        def run_stage():
            try:
                self.cache.stage()
            except BaseException as e:  # surfaced at the next boundary
                with self._state_lock:
                    self._refresh_error = e

        self._refresh_thread = threading.Thread(
            target=run_stage, daemon=True, name="cache-refresh-stage")
        self._refresh_thread.start()
        return False

    def _maybe_refresh_mapping(self) -> bool:
        """When the loader's measured transfer-path hit rate drifts more
        than ``cache_drift_threshold`` from the rate the mapping was priced
        with, re-price it with the measured rate and alpha.  The measured
        prefetch overlap has its own drift trigger: an underperforming
        prefetcher (queue-full drops, windows evicted before their gather)
        re-prices the storage penalty even when the hit rate is stable.
        Returns True when it re-priced.  After a trainer failure the shares
        stay where the failure folded them."""
        with self._state_lock:
            any_failed = bool(self._failed)
        if not (self.cfg.hybrid and self.cache is not None) or any_failed:
            return False
        stats = self.loader.snapshot("window")
        if stats.total_rows == 0:
            return False
        measured = stats.hit_rate
        hit_drift = abs(measured - self._model_hit_rate) > \
            self.cfg.cache_drift_threshold
        overlap_drift = (
            self.prefetcher is not None
            and abs(self._measured_prefetch_overlap()
                    - self._model_prefetch_overlap)
            > self.cfg.cache_drift_threshold)
        if not (hit_drift or overlap_drift):
            return False
        self._reprice_mapping(measured, self._window_alpha(stats))
        return True

    # ------------------------------------------- model-predictive knob loop

    def _build_knob_model(self, mean_times: StageTimes,
                          iters: int) -> CalibratedKnobModel:
        """Calibrate the Eq. 7/8 knob model on one measured window: the
        mean stage times anchor it at the current knobs, and the window's
        counter deltas (dup factor, hit rate, prefetch hit and drop rates,
        touched windows, refresh admission, hit decay) let ``predict``
        re-price only the knob-sensitive components."""
        src = self.loader.source
        cum = self.loader.snapshot_stats()
        prev = self._last_load_stats
        self._last_load_stats = cum
        d_total = max(cum.total_rows - prev.total_rows, 0)
        d_unique = max(cum.unique_rows - prev.unique_rows, 1)
        d_hit = max(cum.hit_rows - prev.hit_rows, 0)
        wt = int(getattr(src, "gather_windows_touched", 0))
        d_windows = max(wt - self._last_windows_touched, 0)
        self._last_windows_touched = wt
        pf = self.prefetcher
        drop_rate = 0.0
        if pf is not None and pf.submitted + pf.dropped > 0:
            drop_rate = pf.dropped / (pf.submitted + pf.dropped)
        row_bytes = (self.cache.row_bytes if self.cache is not None
                     else self.dataset.feat_dim * 4)
        return CalibratedKnobModel(
            host=PLATFORMS[self.cfg.host_platform],
            accel=PLATFORMS[self.cfg.accel_platform],
            ref=self._knobs,
            signals=SignalSnapshot(
                t_sc=mean_times.t_sc, t_sa=mean_times.t_sa,
                t_load=mean_times.t_load,
                t_load_stall=mean_times.t_load_stall,
                t_tran=mean_times.t_tran, t_tc=mean_times.t_tc,
                t_ta=mean_times.t_ta,
                dup_factor=(d_total / d_unique if d_total else 1.0),
                hit_rate=(d_hit / d_total if d_total else 0.0),
                prefetch_hit_rate=self._measured_prefetch_overlap(),
                prefetch_drop_rate=drop_rate,
                touched_windows=max(d_windows // max(iters, 1), 1),
                loaded_rows_per_iter=d_unique / max(iters, 1),
                refresh_bytes_per_iter=self._refresh_bytes_per_iter,
                hit_decay_per_iter=self._hit_decay_per_iter,
                row_bytes=int(row_bytes),
                disk_tier=(self.feature_tier == "disk")))

    def _apply_knobs(self, k: KnobState) -> None:
        """Apply an accepted (or rolled-back) knob state at an iteration
        boundary: stage threads through the assignment (the loader's pool
        rebuilds at its next gather), the prefetch queue by resize, rebuild
        or close, the window LRU by the source's immediate trim, the
        refresh cadence by the boundary gate and its fraction by the
        cache's admission bound.  Never touches shares, RNG streams or
        batch composition, so losses stay bit-identical to a static run.
        A sample stage running meanwhile holds its own reference to the
        old prefetcher (``_submit_prefetch``), and a closed one drops."""
        prev, self._knobs = self._knobs, k
        a = self.runtime.assignment
        a.threads["sample"] = k.sample_threads
        a.threads["load"] = k.load_threads
        a.threads["train"] = k.train_threads
        src = self.loader.source
        if k.mmap_lru_windows != prev.mmap_lru_windows:
            if hasattr(src, "set_lru_windows"):
                src.set_lru_windows(k.mmap_lru_windows)
            elif hasattr(src, "lru_windows"):
                src.lru_windows = int(k.mmap_lru_windows)
        if k.prefetch_windows != prev.prefetch_windows:
            with self._state_lock:
                pf_dead = "prefetcher" in self._degraded
            if k.prefetch_windows <= 0:
                pf, self.prefetcher = self.prefetcher, None
                if pf is not None:
                    pf.close()
            elif self.prefetcher is not None:
                self.prefetcher.resize(k.prefetch_windows)
            elif not pf_dead:
                self.prefetcher = self._build_prefetcher(k.prefetch_windows)
        self._refresh_period = max(1, k.refresh_period)
        if self.cache is not None and k.refresh_frac != prev.refresh_frac:
            shards = self.cache.shards if self._sharded else [self.cache]
            for sh in shards:
                sh.max_refresh_frac = float(k.refresh_frac)

    def _maybe_autotune(self, times: StageTimes) -> None:
        """One boundary step of the knob autotuner: feed the measured
        times; a closing window may hand back a state to apply, a new trial
        move or the exact pre-move state of a trial that regressed past the
        hysteresis band."""
        if self.autotuner is None:
            return
        nxt = self.autotuner.step(times, self._build_knob_model,
                                  self._knobs)
        if nxt is not None:
            self._apply_knobs(nxt)

    def autotune_report(self) -> Dict[str, Any]:
        """The autotuner's trajectory and the knob state it holds."""
        out: Dict[str, Any] = {
            "enabled": self.autotuner is not None,
            "knobs": dataclasses.asdict(self._knobs),
        }
        if self.autotuner is not None:
            out.update(self.autotuner.report())
        return out

    # ----------------------------------------------------------------- train

    def train(self, num_iterations: int) -> List[IterationMetrics]:
        stages = [Stage("sample", self._stage_sample),
                  Stage("load", self._stage_load),
                  Stage("transfer", self._stage_transfer)]
        pipe = PrefetchPipeline(
            stages, depth=self.cfg.tfp_depth,
            watchdog_seconds=self.cfg.pipeline_watchdog_seconds,
            fault_injector=self.fault_injector)
        payloads = (self._make_payload(i) for i in range(num_iterations))
        for item in pipe.run(payloads):
            p = item.payload
            grads, ttimes, metrics = self._run_trainers(item)
            t_sync = self._apply_update(grads)
            times = StageTimes(
                t_sa=p["t"].get("t_sa", 0.0), t_sc=p["t"].get("t_sc", 0.0),
                t_load=p["t"].get("t_load", 0.0),
                t_tran=p["t"].get("t_tran", 0.0),
                t_tc=ttimes["t_tc"], t_ta=ttimes["t_ta"],
                t_load_stall=p["t"].get("t_load_stall", 0.0))
            # failed trainers: the dead accelerators' rows fold into the
            # CPU share, and their recent-rows history is freed
            with self._state_lock:
                failed = set(self._failed)
            if failed:
                a = self.runtime.assignment
                dead_accel = sum(1 for n in failed if n != "cpu")
                if dead_accel and a.n_accel > self.cfg.n_accel - dead_accel:
                    a.cpu_batch += a.accel_batch * dead_accel
                    a.n_accel = self.cfg.n_accel - dead_accel
                for n in failed:
                    self.loader.drop_recent(n)
            self.runtime.end_iteration(times)
            self._iters_done += 1
            self._iters_since_refresh += 1
            # refresh first: when it moves rows it resets the window, so
            # the mapping feedback then sees the post-refresh rate; the
            # cadence knob gates how often the drift check runs at all
            if self._iters_done % self._refresh_period == 0:
                self._maybe_refresh_cache()
            self._maybe_refresh_mapping()
            self._maybe_autotune(times)
            edges = sum(mb.edges_traversed()
                        for mb in p["minibatch"].values())
            self.history.append(IterationMetrics(
                iteration=p["iteration"], loss=metrics["loss"],
                acc=metrics["acc"], times=times, t_sync=t_sync, edges=edges,
                assignment=self.runtime.quantized_shares(),
                shares=dict(p["shares"]),
                cache_hit_rate=(self.cache.measured_hit_rate()
                                if self.cache else 0.0),
                cache_version=self.cache.version if self.cache else 0,
                device_sampled=p["device_sampled"],
                sample_frac_accel=self.runtime.assignment.sample_frac_accel))
            if (self.cfg.ckpt_every and self._ckpt_cb
                    and (p["iteration"] + 1) % self.cfg.ckpt_every == 0):
                self._ckpt_cb(p["iteration"], self.params, self.opt_state)
        # a background failure after the last boundary (the final staged
        # gather, the final prefetch) would otherwise vanish
        self._raise_background_errors()
        return self.history

    def _raise_background_errors(self) -> None:
        """Surface latched background failures: a finished async
        ``stage()`` through the refresh-failure protocol, and a prefetch
        worker's error.  Fail-fast mode (``degrade_on_failure=False``)
        raises; otherwise they are recorded for ``health()``."""
        if (self._refresh_thread is None
                or not self._refresh_thread.is_alive()):
            self._refresh_thread = None
            with self._state_lock:
                err, self._refresh_error = self._refresh_error, None
            if err is not None:
                self._handle_refresh_failure(
                    err, context="async cache-refresh stage() failed")
        pf = self.prefetcher
        if pf is not None and pf.error is not None:
            if not self.cfg.degrade_on_failure:
                err, pf.error = pf.error, None
                raise RuntimeError(
                    "window prefetch worker failed; storage tier is broken"
                ) from err
            if pf.failed:
                self._note_degraded(
                    "prefetcher", pf.errors[0] if pf.errors else pf.error,
                    action="window prefetch disabled; loads run "
                           "synchronously")

    def close(self) -> None:
        """Stop the window prefetcher, join an in-flight refresh stage,
        release the loader's gather pool, then surface any failure they
        latched.  Idempotent once the latched errors have raised."""
        if self.prefetcher is not None:
            self.prefetcher.close()
        t = self._refresh_thread
        if t is not None:
            t.join(timeout=30.0)
        self.loader.close()
        self._raise_background_errors()

    def _note_degraded(self, component: str,
                       error: Optional[BaseException],
                       action: str = "") -> None:
        """Record one component's permanent degradation (the first failure
        per component wins) for ``health()``."""
        with self._state_lock:
            if component in self._degraded:
                return
            self._degraded[component] = {
                "component": component,
                "error": repr(error) if error is not None else "",
                "action": action,
                "iteration": len(self.history),
            }

    def health(self) -> Dict[str, Any]:
        """Degraded-mode report: ``status`` ("ok" until a component
        degraded for good), one event per degraded component, and live
        counters: the prefetcher's supervision, the dynamic refresh's
        failure budget, the storage tier's retries, fallbacks and hint
        failures, and the failed trainers."""
        comp: Dict[str, Any] = {}
        pf = self.prefetcher
        if pf is not None:
            comp["prefetcher"] = {
                "healthy": pf.healthy,
                "failed": pf.failed,
                "restarts": int(pf.restarts),
                "errors": len(pf.errors),
            }
        if self.cache is not None and self.cfg.cache_refresh:
            comp["refresh"] = {
                "enabled": not self._refresh_disabled,
                "stage_failures": int(self.cache.stage_failures),
                "consecutive_failures": int(self._refresh_failures),
            }
        src = self.loader.source
        if hasattr(src, "io_retries"):
            comp["storage"] = {
                "io_errors": int(src.io_errors),
                "io_retries": int(src.io_retries),
                "io_retry_seconds": float(src.io_retry_seconds),
                "fallback_gathers": int(src.fallback_gathers),
                "fallback_rows": int(src.fallback_rows),
                "madvise_failures": int(src.madvise_failures),
                "fadvise_failures": int(src.fadvise_failures),
            }
        with self._state_lock:
            failed = sorted(self._failed)
            degraded = sorted(self._degraded)
            events = [dict(e) for e in self._degraded.values()]
        if failed:
            comp["trainers"] = {"failed": failed}
        return {
            "status": "degraded" if degraded else "ok",
            "degraded": degraded,
            "events": events,
            "components": comp,
        }

    # ------------------------------------------------------------- reporting

    def storage_io(self) -> Dict[str, float]:
        """The storage tier's accounting, the reference's keys (zeros on RAM
        tiers): the mmap source's prefetch, eviction and fault-tolerance
        counters, the load stage's cumulative stall the prefetcher did not
        hide, and the prefetcher's own counters when it runs."""
        src = self.loader.source
        out = {
            "load_stall_seconds": self._load_stall(),
            "cold_fault_page_bytes":
                float(getattr(src, "cold_fault_page_bytes", 0)),
            "prefetched_window_bytes":
                float(getattr(src, "prefetched_window_bytes", 0)),
            "evicted_window_bytes":
                float(getattr(src, "evicted_window_bytes", 0)),
            "window_evictions": float(getattr(src, "window_evictions", 0)),
            "pin_blocked_evictions":
                float(getattr(src, "pin_blocked_evictions", 0)),
            "open_windows": float(getattr(src, "open_windows", 0)),
            "prefetch_hit_rate":
                float(getattr(src, "prefetch_hit_rate", 0.0)),
            "io_retries": float(getattr(src, "io_retries", 0)),
            "io_retry_seconds": float(getattr(src, "io_retry_seconds", 0.0)),
            "io_errors": float(getattr(src, "io_errors", 0)),
            "fallback_gathers": float(getattr(src, "fallback_gathers", 0)),
            "fallback_rows": float(getattr(src, "fallback_rows", 0)),
            "madvise_failures": float(getattr(src, "madvise_failures", 0)),
            "fadvise_failures": float(getattr(src, "fadvise_failures", 0)),
        }
        pf = self.prefetcher
        if pf is not None:
            out["prefetch_submitted"] = float(pf.submitted)
            out["prefetch_completed"] = float(pf.completed)
            out["prefetch_dropped"] = float(pf.dropped)
            out["resubmitted_rows_skipped"] = float(
                pf.resubmitted_rows_skipped)
        return out

    def mean_mteps(self, skip: int = 2) -> float:
        hist = self.history[skip:] or self.history
        return float(np.mean([m.mteps for m in hist]))

    def mean_iter_time(self, skip: int = 2) -> float:
        hist = self.history[skip:] or self.history
        return float(np.mean([m.iter_time for m in hist]))

    def feature_traffic(self) -> Dict[str, float]:
        """Cumulative feature-movement accounting for the whole run, the
        reference's keys: ``shipped_bytes`` crossed host->device (unique
        misses plus bucket padding), ``saved_bytes`` the (local) cache
        absorbed, ``dedup_saved_bytes`` frontier dedup absorbed,
        ``peer_saved_bytes`` peer shards served (``peer_rows`` rows),
        ``union_saved_bytes`` the union gather's sharing absorbed,
        ``recent_saved_bytes`` the recent-rows LRU absorbed (``recent_rows``
        rows), ``host_read_bytes`` the CPU trainer read in place.  Shipped
        (minus padding) + the saved terms rebuild the one-row-per-position
        baseline.  ``ici_bytes`` models the peer hops and multicast copies
        on the interconnect of a node with one card per trainer."""
        s = self.loader.snapshot()
        host = self.loader.snapshot("host_stats")
        baseline = ((s.bytes - s.padding_bytes) + s.saved_bytes
                    + s.dedup_saved_bytes + s.peer_saved_bytes
                    + s.union_saved_bytes + s.recent_saved_bytes)
        return {
            "shipped_rows": float(s.rows),
            "shipped_bytes": float(s.bytes),
            "saved_bytes": float(s.saved_bytes),
            "dedup_saved_bytes": float(s.dedup_saved_bytes),
            "peer_rows": float(s.peer_rows),
            "peer_saved_bytes": float(s.peer_saved_bytes),
            "union_saved_bytes": float(s.union_saved_bytes),
            "ici_bytes": float(s.ici_bytes),
            "recent_rows": float(s.recent_rows),
            "recent_saved_bytes": float(s.recent_saved_bytes),
            "padding_bytes": float(s.padding_bytes),
            "host_read_bytes": float(host.bytes),
            "hit_rate": s.hit_rate,
            "dup_factor": s.dup_factor,
            "reduction": baseline / max(s.bytes, 1),
        }
