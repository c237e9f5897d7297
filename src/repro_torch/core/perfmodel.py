"""Performance model (paper Section V, Eqs. 5-13).

Port of ``repro/core/perfmodel.py``: the stage model, the design-time
task mapping, the epoch-time model of Table 6 and the knob-space model of
the autotuner (``CalibratedKnobModel``).
Predicts per-stage times from algorithmic parameters (mini-batch edge and
vertex counts, layer widths) and platform data, and derives the *initial*
coarse-grained task mapping (CPU vs accelerator mini-batch shares).  The
DRM engine fine-tunes that mapping at run time from measured stage times.

``PLATFORMS`` keeps the paper's Table II rows and adds NVIDIA's H100 from
its datasheet.  Throughput metric: MTEPS (Eq. 5).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Sequence, Tuple

__all__ = ["PlatformSpec", "PLATFORMS", "WorkloadSpec", "StagePrediction",
           "predict", "initial_task_mapping", "mteps",
           "platform_for_device_name", "calibrate_sampling",
           "predict_epoch_time",
           "KnobState", "KnobBounds", "SignalSnapshot",
           "CalibratedKnobModel"]


@dataclasses.dataclass(frozen=True)
class PlatformSpec:
    """One compute device + its memory/interconnect (paper Table II rows)."""
    name: str
    peak_tflops: float          # fp32
    mem_bw_gbps: float          # device-local memory bandwidth (GB/s)
    interconnect_gbps: float    # PCIe (accelerators) / n.a. for CPU
    onchip_mb: float
    mac_parallelism: int        # N in Eq. 12 (MACs per cycle)
    freq_ghz: float
    pipelined_agg_update: bool  # the ⊕ operator in Eq. 10: True -> max
    # host storage (NVMe/SSD) read bandwidth, for disk-resident features
    # (the out-of-core MmapFeatures tier).  0 = knob unset: Eq. 7 falls
    # back to memory bandwidth, i.e. features are assumed RAM-resident.
    storage_bw_gbps: float = 0.0
    # accelerator-to-accelerator interconnect (ICI/NVLink) bandwidth, used
    # by the sharded feature plane to price peer-shard row hops separately
    # from host PCIe.  0 = knob unset: peer traffic falls back to the PCIe
    # figure (interconnect_gbps), i.e. no fast device fabric.
    ici_gbps: float = 0.0


PLATFORMS: Dict[str, PlatformSpec] = {
    # paper Table II (effective PCIe bandwidths: gen4 x16 burst ~16 GB/s;
    # host storage: one PCIe gen4 x4 NVMe, ~7 GB/s sequential read)
    "epyc-7763":  PlatformSpec("epyc-7763", 3.6, 205.0, 0.0, 256.0,
                               1472, 2.45, False, storage_bw_gbps=7.0),
    "rtx-a5000":  PlatformSpec("rtx-a5000", 27.8, 768.0, 16.0, 6.0,
                               13900, 2.0, False),
    "alveo-u250": PlatformSpec("alveo-u250", 0.6, 77.0, 16.0, 54.0,
                               2048, 0.3, True),
    # NVIDIA H100 datasheet rows: a design-time start that the DRM corrects
    # from measured stage times.  fp32 outside the tensor cores (67 / 51
    # TFLOP/s = SMs x 128 lanes x 2 x boost clock), HBM rate, 50 MB L2,
    # PCIe gen5 x16 derated like the Table II rows (64 GB/s raw -> 32),
    # NVLink per direction.
    "h100-sxm":   PlatformSpec("h100-sxm", 67.0, 3350.0, 32.0, 50.0,
                               132 * 128, 1.98, False, ici_gbps=450.0),
    "h100-pcie":  PlatformSpec("h100-pcie", 51.0, 2000.0, 32.0, 50.0,
                               114 * 128, 1.75, False, ici_gbps=300.0),
}


def platform_for_device_name(name: str) -> str:
    """The ``PLATFORMS`` row for a card name as ``nvidia-smi`` or
    ``torch.cuda.get_device_name`` print it (the SXM row for any other
    H100, and for cards the table does not know)."""
    return "h100-pcie" if "H100" in name and "PCIe" in name else "h100-sxm"


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Algorithmic parameters of one training iteration (per trainer)."""
    batch_size: int
    fanouts: Tuple[int, ...]          # (25, 10)
    layer_dims: Tuple[int, ...]       # (f0, f1, f2)
    feat_bytes: int = 4               # S_feat
    model: str = "sage"
    # fraction of loaded rows served by the device-resident feature cache
    # (featcache.FeatureCache): scales the Eq. 7/8 gather/transfer traffic
    # by (1 - h).  0 reproduces the paper's uncached equations exactly.
    # At design time this is the cache's expected_hit_rate; at runtime the
    # feedback loop re-prices with the measured rate over the
    # *post-refresh window* (the loader's window stats reset when a
    # dynamic cache refresh moves rows), so a refreshed cache is priced at
    # the rate it actually serves rather than a lifetime average.
    cache_hit_rate: float = 0.0
    # frontier duplication factor alpha = unique-miss rows / positional
    # miss rows: the deduped transfer path gathers/ships one row per
    # unique miss, so Eq. 7/8 traffic scales by alpha on top of (1 - h).
    # Both the design-time probe (HybridGNNTrainer._probe_dup_factor,
    # which classifies one probe frontier against the cache) and the
    # runtime loader stats (_maybe_refresh_mapping) use this same
    # unique-miss/miss-positions definition — hub ids are both the
    # most-cached and the most-duplicated, so the naive unique/total
    # ratio would double-count the overlap the cache term (1 - h)
    # already removed.  1 reproduces the paper's positional
    # (one-row-per-position) equations exactly.
    dedup_factor: float = 1.0
    # where the feature matrix lives on the host: "ram" (the paper's
    # baseline) or "disk" (out-of-core MmapFeatures) — Eq. 7 prices the
    # gather at min(memory, storage) bandwidth for the disk tier.
    feature_tier: str = "ram"
    # fraction of the disk tier's storage stream hidden by the background
    # window prefetcher (it pre-faults batch i+1's partition windows
    # while batch i trains, the way TFP hides the whole load stage behind
    # compute).  Eq. 7's storage penalty — the gap between pricing at
    # storage vs memory bandwidth — is discounted by this factor: 0 (no
    # prefetcher) reproduces the plain disk-tier pricing, 1 means the
    # storage stream fully overlaps and only the RAM-speed gather stays
    # exposed.  At runtime the feedback loop re-prices with the measured
    # prefetch hit rate.  Ignored on the "ram" tier.
    prefetch_overlap: float = 0.0
    # sharded hot-feature plane (ShardedFeatureCache): fraction of loaded
    # rows served from a *peer* device's shard over the accelerator
    # interconnect instead of the local shard or the host.  Peer rows
    # never touch the host gather or PCIe (Eqs. 7/8) but do cross the
    # ICI, so t_trans prices them at ici_gbps.  0 = replicated cache.
    peer_hit_rate: float = 0.0
    # union-gather multicast factor: unique rows in the *union* of all
    # trainers' miss sets / sum of per-trainer unique misses.  The host
    # gathers and ships the union once (Eq. 7 and the PCIe leg of Eq. 8
    # scale by this), then the rows a trainer needs but did not receive
    # directly are fanned out over ICI.  1 = per-trainer dedup only
    # (replicated plane); < 1 only when trainers' frontiers overlap.
    union_factor: float = 1.0
    # dynamic-cache refresh admission traffic, amortized per iteration:
    # swapped_rows x row_bytes / iterations-between-refreshes.  The
    # admission gather streams from the same host tier the load stage
    # reads (Eq. 7) and the scatter-update block crosses PCIe to every
    # device (Eq. 8) — the term the static equations were missing once
    # the cache became dynamic.  0 reproduces the static-cache pricing.
    refresh_bytes_per_iter: float = 0.0

    def frontier_sizes(self) -> Tuple[int, ...]:
        out = [self.batch_size]
        cur = self.batch_size
        for f in self.fanouts:
            cur = cur * (1 + f)
            out.append(cur)
        return tuple(out)

    def edges_per_layer(self) -> Tuple[int, ...]:
        """|E^l| for hop l consumed by GNN layer L-l (sampled edge counts)."""
        sizes = self.frontier_sizes()
        return tuple(sizes[l] * self.fanouts[l] for l in range(len(self.fanouts)))

    def total_edges(self) -> int:
        return sum(self.edges_per_layer())

    def loaded_rows(self) -> int:
        return self.frontier_sizes()[-1]

    def miss_rows(self) -> float:
        """Expected rows actually gathered+shipped after local cache hits,
        peer-shard hits and frontier deduplication (unique misses only)."""
        miss = max(1.0 - self.cache_hit_rate - self.peer_hit_rate, 0.0)
        return self.loaded_rows() * miss * self.dedup_factor

    def peer_rows(self) -> float:
        """Expected rows served from peer shards over the ICI (deduped the
        same way as host misses — one hop per unique peer row)."""
        return self.loaded_rows() * self.peer_hit_rate * self.dedup_factor

    def model_bytes(self) -> int:
        """Σ_l f^{l-1} × f^l × S_feat (Eq. 13 numerator)."""
        tot = 0
        for fin, fout in zip(self.layer_dims[:-1], self.layer_dims[1:]):
            fin_eff = 2 * fin if self.model == "sage" else fin
            tot += fin_eff * fout
        return tot * self.feat_bytes


@dataclasses.dataclass
class StagePrediction:
    t_samp: float
    t_load: float
    t_trans: float
    t_prop: float
    t_sync: float

    @property
    def t_execution(self) -> float:       # Eq. 6
        return max(self.t_samp, self.t_load, self.t_trans, self.t_prop)

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self) | {"t_execution": self.t_execution}


def t_load(w: WorkloadSpec, host: PlatformSpec, n_trainers: int) -> float:
    """Eq. 7 extended with the cache term: only the expected cache-miss
    rows are gathered from host memory (hit rows live on-device).

    For disk-resident features (``w.feature_tier == "disk"``, the
    out-of-core MmapFeatures tier) the gather streams through the host
    storage device, so the stage is priced at min(memory, storage)
    bandwidth; a platform without the ``storage_bw_gbps`` knob falls back
    to memory bandwidth (RAM-resident assumption).  The background window
    prefetcher overlaps the storage stream with the previous iteration's
    compute, so only ``(1 - prefetch_overlap)`` of the storage *penalty*
    (the excess over the RAM-speed gather) stays exposed on the load
    stage — the same discount TFP applies to the stage as a whole.

    With the union-gather multicast (sharded plane) the host gathers the
    *union* of the trainers' miss sets once instead of each trainer's set
    separately, so the per-trainer traffic scales by ``union_factor``.

    ``refresh_bytes_per_iter`` (dynamic-cache admission traffic) rides
    the same host gather stream once per plane — the refresh gathers the
    admitted rows from the very tier (RAM or disk) the load stage reads,
    so it is priced inside the tier term, storage penalty and prefetch
    discount included."""
    num = (n_trainers * w.miss_rows() * w.layer_dims[0] * w.feat_bytes
           * min(max(w.union_factor, 0.0), 1.0)
           + max(w.refresh_bytes_per_iter, 0.0))
    t_mem = num / (host.mem_bw_gbps * 1e9)
    if w.feature_tier == "disk" and host.storage_bw_gbps > 0.0:
        bw = min(host.mem_bw_gbps, host.storage_bw_gbps)
        t_disk = num / (bw * 1e9)
        overlap = min(max(w.prefetch_overlap, 0.0), 1.0)
        return t_mem + (t_disk - t_mem) * (1.0 - overlap)
    return t_mem


def t_trans(w: WorkloadSpec, accel: PlatformSpec) -> float:
    """Eq. 8 extended with the cache and sharding terms.

    PCIe leg: only the union share of the miss rows is shipped from the
    host (the union-gather sends each unique row once, to one device).
    ICI leg: the multicast fan-out copies (rows this trainer needs that
    arrived on another device first) plus the peer-shard row hops cross
    the accelerator interconnect, priced at ``ici_gbps`` (falling back to
    PCIe bandwidth when the platform has no fast fabric).  The two legs
    use different links and overlap, so the stage time is their max.

    ``refresh_bytes_per_iter`` (dynamic-cache admission traffic) lands on
    the PCIe leg: the scatter-update block of every refresh crosses the
    host->device link on top of the miss stream it competes with."""
    row_bytes = w.layer_dims[0] * w.feat_bytes
    uf = min(max(w.union_factor, 0.0), 1.0)
    t_pcie = ((w.miss_rows() * uf * row_bytes
               + max(w.refresh_bytes_per_iter, 0.0))
              / (accel.interconnect_gbps * 1e9))
    ici_rows = w.miss_rows() * (1.0 - uf) + w.peer_rows()
    if ici_rows <= 0.0:
        return t_pcie
    ici_bw = accel.ici_gbps if accel.ici_gbps > 0.0 else accel.interconnect_gbps
    t_ici = ici_rows * row_bytes / (ici_bw * 1e9)
    return max(t_pcie, t_ici)


def t_aggregate(w: WorkloadSpec, dev: PlatformSpec, layer: int) -> float:
    """Eq. 11 — |E^{l-1}| × f^l × S_feat / BW_mem  (hop edge traffic)."""
    edges = w.edges_per_layer()[::-1]  # GNN layer l consumes hop L-l
    f_in = w.layer_dims[layer - 1]
    return edges[layer - 1] * f_in * w.feat_bytes / (dev.mem_bw_gbps * 1e9)


def t_update(w: WorkloadSpec, dev: PlatformSpec, layer: int) -> float:
    """Eq. 12 — |V^l| × f^l × f^{l+1} / (N × freq)."""
    sizes = w.frontier_sizes()[::-1]   # V^l for GNN layer l output
    v_l = sizes[layer]
    f_in = w.layer_dims[layer - 1] * (2 if w.model == "sage" else 1)
    f_out = w.layer_dims[layer]
    return v_l * f_in * f_out / (dev.mac_parallelism * dev.freq_ghz * 1e9)


def t_trainer(w: WorkloadSpec, dev: PlatformSpec) -> float:
    """Eq. 10 — forward + backward over L layers; ⊕ = max when pipelined."""
    L = len(w.layer_dims) - 1
    op = max if dev.pipelined_agg_update else (lambda a, b: a + b)
    fwd = sum(op(t_aggregate(w, dev, l), t_update(w, dev, l))
              for l in range(1, L + 1))
    bwd = t_update(w, dev, 1) + sum(op(t_aggregate(w, dev, l),
                                       t_update(w, dev, l))
                                    for l in range(2, L + 1))
    return fwd + bwd


def t_sync(w: WorkloadSpec, accel: PlatformSpec,
           compression_ratio: float = 1.0) -> float:
    """Eq. 13 — model gathered+scattered over PCIe (factor 2)."""
    return 2 * w.model_bytes() * compression_ratio / (
        accel.interconnect_gbps * 1e9)


def predict(host: PlatformSpec, accel: PlatformSpec, n_accel: int,
            w_cpu: WorkloadSpec, w_accel: WorkloadSpec,
            t_samp: float = 0.0,
            compression_ratio: float = 1.0) -> StagePrediction:
    """Full-system prediction for one iteration (n_accel accelerator
    trainers, each running ``w_accel``, plus one CPU trainer w/ ``w_cpu``)."""
    # the CPU trainer reads host memory directly and never benefits from
    # the device cache, so its load term is priced with its own workload
    # (cache_hit_rate belongs to w_accel only)
    tl = (t_load(w_accel, host, n_accel)
          + t_load(w_cpu, host, 1 if w_cpu.batch_size > 0 else 0))
    tt = t_trans(w_accel, accel) if n_accel else 0.0
    prop_cpu = t_trainer(w_cpu, host) if w_cpu.batch_size > 0 else 0.0
    prop_acc = t_trainer(w_accel, accel) if n_accel else 0.0
    tp = max(prop_cpu, prop_acc) + t_sync(w_accel, accel, compression_ratio)
    return StagePrediction(t_samp=t_samp, t_load=tl, t_trans=tt, t_prop=tp,
                           t_sync=t_sync(w_accel, accel, compression_ratio))


def mteps(total_edges: int, t_execution: float) -> float:
    """Eq. 5 — million traversed edges per second."""
    return total_edges / t_execution / 1e6


def initial_task_mapping(host: PlatformSpec, accel: PlatformSpec,
                         n_accel: int, total_batch: int,
                         fanouts: Tuple[int, ...],
                         layer_dims: Tuple[int, ...],
                         model: str = "sage",
                         cache_hit_rate: float = 0.0,
                         dedup_factor: float = 1.0,
                         feature_tier: str = "ram",
                         prefetch_overlap: float = 0.0,
                         peer_hit_rate: float = 0.0,
                         union_factor: float = 1.0,
                         refresh_bytes_per_iter: float = 0.0
                         ) -> Dict[str, int]:
    """Coarse-grained design-time mapping (paper §IV-A first paragraph).

    Chooses the CPU trainer's mini-batch share so the predicted CPU
    propagation time matches the accelerators' bundled transfer+propagation
    time; solved by scanning the (integer) share space with the performance
    model — robust for any platform pair, no closed form needed.

    ``cache_hit_rate`` is the device cache's design-time hit estimate
    (``FeatureCache.expected_hit_rate``) and ``dedup_factor`` the measured
    frontier duplication factor alpha (unique-miss rows / positional miss
    rows — the same definition at design time, from a cache-classified
    probe mini-batch, and at runtime, from measured loader stats): both
    shrink the accelerators' load/transfer terms, which shifts the optimum
    toward larger accelerator shares.  The CPU trainer reads host memory
    directly and benefits from neither (its rows never cross PCIe).

    ``feature_tier="disk"`` prices every trainer's load stage (CPU and
    accelerator alike — they gather from the same host FeatureSource) at
    the host's storage bandwidth, shifting work toward whichever side
    hides the slower gather better; ``prefetch_overlap`` discounts the
    disk tier's storage penalty by the fraction the background window
    prefetcher hides (both trainer kinds gather through the same
    prefetched page cache, so both carry it).

    ``peer_hit_rate`` and ``union_factor`` are the sharded-plane terms
    (peer-shard service rate and union-gather multicast factor): both
    shrink the accelerators' host-side load/PCIe terms (peer rows ride
    the ICI instead), again shifting the optimum toward larger
    accelerator shares.  The CPU trainer carries neither.

    ``refresh_bytes_per_iter`` is the dynamic cache's measured admission
    traffic (swapped rows x row bytes amortized over the drift interval):
    it taxes the host gather and the PCIe leg the accelerators depend on,
    shifting the optimum toward the CPU trainer under refresh churn.
    """
    best: Tuple[float, int] = (float("inf"), 0)
    step = max(1, total_batch // 64)
    for cpu_share in range(0, total_batch // 2 + 1, step):
        accel_share = (total_batch - cpu_share) // max(n_accel, 1)
        w_cpu = WorkloadSpec(cpu_share, fanouts, layer_dims, model=model,
                             feature_tier=feature_tier,
                             prefetch_overlap=prefetch_overlap)
        w_acc = WorkloadSpec(accel_share, fanouts, layer_dims, model=model,
                             cache_hit_rate=cache_hit_rate,
                             dedup_factor=dedup_factor,
                             feature_tier=feature_tier,
                             prefetch_overlap=prefetch_overlap,
                             peer_hit_rate=peer_hit_rate,
                             union_factor=union_factor,
                             refresh_bytes_per_iter=refresh_bytes_per_iter)
        pred = predict(host, accel, n_accel, w_cpu, w_acc)
        if pred.t_execution < best[0]:
            best = (pred.t_execution, cpu_share)
    cpu_share = best[1]
    return {"cpu": cpu_share,
            "accel_each": (total_batch - cpu_share) // max(n_accel, 1)}


# --------------------------------------------------------------------------
# Knob-space model for the online DRM autotuner (the reference's
# docs/drm-autotuning.md describes it)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KnobState:
    """The knob vector the DRM's online autotuner searches.

    Every knob here is performance-only: none touches RNG streams, batch
    composition or assembled feature values, so any trajectory through
    knob space leaves training losses bit-identical to a static run.
    Workload *shares* (cpu/accel batch split) are deliberately absent —
    those stay with Algorithm 1's balance_work and the mapping re-price.
    """
    prefetch_windows: int = 0     # WindowPrefetcher queue depth (0 = off)
    mmap_lru_windows: int = 0     # MmapFeatures window bound (0 = unbounded)
    sample_threads: int = 2       # Assignment.threads["sample"]
    load_threads: int = 2         # Assignment.threads["load"] (gather pool)
    train_threads: int = 2        # Assignment.threads["train"]
    refresh_period: int = 1       # iterations between refresh drift checks
    refresh_frac: float = 0.25    # max fraction of cache slots swapped

    @property
    def total_threads(self) -> int:
        return self.sample_threads + self.load_threads + self.train_threads


@dataclasses.dataclass(frozen=True)
class KnobBounds:
    """Hard feasibility box for autotuner proposals.

    Defaults freeze every subsystem-dependent knob (``lo == hi``): the
    trainer widens exactly the ranges whose subsystems exist (a prefetch
    range only when the source can ``prefetch_rows``, refresh ranges only
    with a dynamic cache).  Thread knobs are bounded by conservation —
    the proposal must keep the total thread count and give every stage at
    least ``min_stage_threads`` — matching balance_thread's invariant.
    """
    prefetch_windows: Tuple[int, int] = (0, 0)
    mmap_lru_windows: Tuple[int, int] = (0, 0)
    min_stage_threads: int = 1
    total_threads: int = 6
    refresh_period: Tuple[int, int] = (1, 1)
    refresh_frac: Tuple[float, float] = (0.25, 0.25)

    def contains(self, k: KnobState) -> bool:
        def _in(v, box):
            return box[0] <= v <= box[1]
        return (_in(k.prefetch_windows, self.prefetch_windows)
                and _in(k.mmap_lru_windows, self.mmap_lru_windows)
                and _in(k.refresh_period, self.refresh_period)
                and _in(k.refresh_frac, self.refresh_frac)
                and min(k.sample_threads, k.load_threads,
                        k.train_threads) >= self.min_stage_threads
                and k.total_threads == self.total_threads)


@dataclasses.dataclass(frozen=True)
class SignalSnapshot:
    """Measured signals for one autotune window (stage-time means plus
    counter deltas), the calibration input of ``CalibratedKnobModel``.

    Time fields mirror ``drm.StageTimes`` (kept scalar here so the model
    layer stays import-free of the DRM layer).  Counter-derived fields
    are window deltas normalized per iteration where noted.
    """
    t_sc: float = 0.0
    t_sa: float = 0.0
    t_load: float = 0.0
    t_load_stall: float = 0.0     # exposed storage stall inside t_load
    t_tran: float = 0.0
    t_tc: float = 0.0
    t_ta: float = 0.0
    dup_factor: float = 1.0       # LoadStats.dup_factor over the window
    hit_rate: float = 0.0         # cache hit rate over the window
    prefetch_hit_rate: float = 0.0   # warm window touches / all touches
    prefetch_drop_rate: float = 0.0  # queue-full drops / submits
    touched_windows: float = 0.0  # mmap windows the load stage touches/iter
    loaded_rows_per_iter: float = 0.0
    refresh_bytes_per_iter: float = 0.0  # admission traffic at ref knobs
    hit_decay_per_iter: float = 0.0      # hit-rate points lost per
                                         # iteration since the last refresh
    row_bytes: int = 4
    disk_tier: bool = False


@dataclasses.dataclass(frozen=True)
class CalibratedKnobModel:
    """Eq. 7/8-grounded predictor over the autotuner's knob space.

    Anchored on measurement: stage times come from a real window at the
    reference knobs ``ref`` and only the knob-sensitive *components* are
    re-priced —

      * CPU-stage compute scales inversely with the stage's thread share
        (balance_thread's own assumption),
      * the exposed storage stall is split out of ``t_load`` and scaled
        by the prefetch subsystem's predicted coverage: queue depth sets
        the drop rate of the advisory (lossy) submit path, and the window
        LRU must hold the per-iteration working set or a prefetched
        window is evicted before its gather (Eq. 7's storage penalty x
        (1 - overlap) term, with overlap now a function of the knobs),
      * refresh cadence/frac trade the measured admission traffic
        (priced at the tier and PCIe bandwidths — the Eq. 7/8 refresh
        term) against hit-rate staleness (a slower cadence lets the
        measured decay run longer, and the extra unique misses are
        priced as load + transfer traffic).

    The predictor is advisory: the autotuner verifies every accepted move
    against *measured* iteration time and rolls back past the hysteresis
    band, so a mis-calibrated sensitivity costs one trial window, never a
    run.
    """
    host: PlatformSpec
    accel: PlatformSpec
    ref: KnobState
    signals: SignalSnapshot
    overlap_cap: float = 0.95     # prefetch can never hide the last 5%

    # ------------------------------------------------------------ pricing

    def _load_bw(self) -> float:
        s = self.signals
        bw = self.host.mem_bw_gbps
        if s.disk_tier and self.host.storage_bw_gbps > 0.0:
            bw = min(bw, self.host.storage_bw_gbps)
        return max(bw, 1e-3) * 1e9

    def _pcie_bw(self) -> float:
        return max(self.accel.interconnect_gbps, 1e-3) * 1e9

    def _coverage(self, k: KnobState) -> float:
        """Predicted fraction of the storage stall the prefetch subsystem
        hides at knobs ``k`` (the Eq. 7 overlap term as a knob function)."""
        if k.prefetch_windows <= 0:
            return 0.0
        s, r = self.signals, self.ref
        if r.prefetch_windows > 0 and s.prefetch_drop_rate > 0.0:
            # the submit path is lossy: a full queue drops the request.
            # Halving the depth roughly doubles the measured drop rate,
            # doubling it halves it (M/M/1-ish occupancy scaling).
            drop = min(s.prefetch_drop_rate
                       * r.prefetch_windows / k.prefetch_windows, 1.0)
        else:
            # no measurement at this depth yet: saturating prior — each
            # extra queue slot halves the chance a submit finds it full
            drop = 0.5 ** k.prefetch_windows
        depth_term = max(1.0 - drop, 0.0)
        # a prefetched window must survive until its gather: an LRU bound
        # below the per-iteration working set evicts it first
        ws = max(self.signals.touched_windows, 1.0)
        lru_term = (1.0 if k.mmap_lru_windows <= 0
                    else min(1.0, k.mmap_lru_windows / ws))
        return self.overlap_cap * depth_term * lru_term

    def _stall(self, k: KnobState) -> float:
        """Predicted exposed storage stall (seconds) at knobs ``k``."""
        s, r = self.signals, self.ref
        exposed = min(max(s.t_load_stall, 0.0), max(s.t_load, 0.0))
        if exposed <= 0.0:
            return 0.0
        # reconstruct the *full* storage penalty from the exposed share:
        # at the reference knobs the prefetcher already hid
        # prefetch_hit_rate of the window touches
        full = exposed
        if r.prefetch_windows > 0:
            hidden = min(max(s.prefetch_hit_rate, 0.0), self.overlap_cap)
            full = exposed / max(1.0 - hidden, 1.0 - self.overlap_cap)
        return full * (1.0 - self._coverage(k))

    def _admission_scale(self, k: KnobState) -> float:
        """Admission bytes/iter at ``k`` relative to the reference: a
        longer period amortizes further, a larger frac swaps more rows."""
        r = self.ref
        return ((r.refresh_period / max(k.refresh_period, 1))
                * (k.refresh_frac / max(r.refresh_frac, 1e-9)))

    def _staleness_rows(self, k: KnobState) -> float:
        """Extra unique miss rows per iteration from cache staleness at
        cadence ``k.refresh_period`` relative to the reference (negative
        = a faster cadence recovers hits).  Calibrated from the measured
        per-iteration hit decay; 0 when no decay was observed."""
        s, r = self.signals, self.ref
        if s.hit_decay_per_iter <= 0.0 or s.loaded_rows_per_iter <= 0.0:
            return 0.0
        # average staleness ~ period/2 iterations of decay
        d_hit = s.hit_decay_per_iter * (k.refresh_period
                                        - r.refresh_period) / 2.0
        d_hit = min(max(d_hit, -(1.0 - s.hit_rate)), s.hit_rate)
        return s.loaded_rows_per_iter * d_hit / max(s.dup_factor, 1.0)

    # ------------------------------------------------------------ predict

    def predict(self, k: KnobState) -> float:
        """Predicted iteration time (max over stages, Eq. 6) at ``k``."""
        s, r = self.signals, self.ref

        def scale(ref_n: int, new_n: int) -> float:
            return ref_n / max(new_n, 1)

        t_sc = s.t_sc * scale(r.sample_threads, k.sample_threads)
        t_tc = s.t_tc * scale(r.train_threads, k.train_threads)
        stall_ref = min(max(s.t_load_stall, 0.0), max(s.t_load, 0.0))
        gather = ((s.t_load - stall_ref)
                  * scale(r.load_threads, k.load_threads))
        adm_bytes = (max(s.refresh_bytes_per_iter, 0.0)
                     * self._admission_scale(k))
        stale_bytes = self._staleness_rows(k) * s.row_bytes
        t_load_k = max(gather + self._stall(k)
                       + (adm_bytes + stale_bytes) / self._load_bw(), 0.0)
        t_tran_k = max(s.t_tran
                       + (adm_bytes + stale_bytes) / self._pcie_bw(), 0.0)
        return max(s.t_sa, t_sc, t_load_k, t_tran_k, t_tc, s.t_ta)


def calibrate_sampling(sampler_fn: Callable[[int], None],
                       batch_sizes: Sequence[int],
                       repeats: int = 3) -> Dict[int, float]:
    """T_samp is measured, not modeled (paper §V): run the sampling
    algorithm at each batch size during the design phase.  ``sampler_fn``
    returns once its work is done (a device sampler synchronizes)."""
    table: Dict[int, float] = {}
    for b in batch_sizes:
        sampler_fn(b)  # warmup
        t0 = time.perf_counter()
        for _ in range(repeats):
            sampler_fn(b)
        table[b] = (time.perf_counter() - t0) / repeats
    return table


def predict_epoch_time(num_nodes: int, total_batch: int,
                       pred: StagePrediction) -> float:
    """Iterations of one epoch over ``num_nodes`` targets times Eq. 6."""
    iters = math.ceil(num_nodes / total_batch)
    return iters * pred.t_execution
