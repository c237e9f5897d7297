"""Smoke run of the PyTorch/CUDA port on one NVIDIA card, and across up to
four when more are visible.

    python3 chip_smoke.py [--scale 1.0] [--iters 10] [--out DIR]
                          [--spill-dir DIR] [--cards N]

Builds the port's hand-written kernels from ``src/repro_torch/kernels/csrc``
with nvcc (sm_90a), holds each kernel against its plain PyTorch version on
the card at the slice's full-width shapes, times the kernel, the plain
version and the library call two ways (``ms``: the device time of one call
alone, its inputs cold, from torch.profiler's per-kernel durations with the
L2 flushed before each call; ``call_ms``: one host-inclusive call between
two CUDA events, as a Python caller pays it), and drives the hybrid
trainer (``repro_torch.core.HybridGNNTrainer``) on ``cuda:0`` with the
paper's ``sage-products`` configuration (``PAPER_CONFIGS``: layer widths
(100, 256, 47), fanouts (25, 10), batch 1024; the fused layer kernel, 20 %
hot cache, dedup, DRM, and the reference's default accelerator sampler).
Phases, each printing one JSON line:

  env          versions, the card, nvcc, kernel build time
  kernels      K1 combine (f32 and bf16: bit-equal and timed; also the
               cache-less dedup path and a peer gather of the shard phase's
               size, each bit-equal to the plain version and to K4 at
               depths 2-4 and timed beside torch.index_select as its
               library call), K4 multi-buffered combine
               (depths 2, 3, 4 on K1's inputs, f32 and bf16: bit-equal to K1
               and to the plain version), K7 legacy combine (the same rows
               through its (sel, row) tables: bit-equal), K2 fused layer
               (SAGE split W, GCN shared W) and K3 segment sum (f32, bf16)
               against their plain versions, K2/K3 gradients against plain
               autograd, K5/K6 refresh scatter (depths 1-4; f32, bf16;
               the slots and rows of a real first commit, plus aliased
               slots: bit-equal to the plain keep-last scatter and to K5),
               and each kernel's times, plain times, library times and bound;
               K8 flash attention at the serve phase's prefill shape
  train        ~10 iterations of the slice on the card, the CSR on the card
               and the first round(0.5 n) batches sampled there; asserts
               finite losses, an accelerator share on every iteration, CUDA
               inputs and parameters, K1/K2 launches on every accel
               iteration and at least one batch sampled on the card; each
               row reports t_sa, the device-sampling share and the trainers
               sampled on the card
  sampler      the full CSR on the card (its bytes, memory_allocated before
               and after); 20 batches of 1,024 targets at fanouts (25, 10)
               through the device sampler (to a synchronize) and the host
               sampler on the same targets, median ms of each; every card
               batch checked: shapes, each source a CSR neighbour of its
               destination (the destination itself at degree 0), the CSR's
               degrees; two samplers of one seed bit-equal
  compress     int8 and bf16 compression of the slice's real gradients on
               the card and on the host: values and scales bit-equal; three
               iterations with compression="int8": finite losses, t_sync
  ckpt         the slice with ckpt_every=2 and an async CheckpointManager
               (keep=2) callback into a temporary directory, the callback
               also cloning the state: restore_latest onto cuda:0 bit-equal
               to the clone, sha256 verified, two steps kept; save ms, bytes
  crosscheck   the slice with use_drm=False (sequential stages) for 3
               iterations on the card and on the host from the same weights:
               losses within 1e-3, feature traffic equal (this phase and
               the refresh, shard and depth phases sample on the host: the
               card's and the host's generators draw different numbers)
  segsum       gcn-products with agg_impl="pallas" (K3) for 3 iterations
  refresh      (a) the slice with cache_refresh=True, drift threshold 0, 6
               iterations: finite losses, cache version > 0, K5 launched,
               each stage/commit's wall time; (b) accel-only, refresh on vs
               off from the same weights, 4 iterations: layer-0 inputs and
               losses bit-equal; (c) async_refresh=True commits and matches
               (b)'s losses; (d) FeatureCache commits at
               kernel_pipeline_depth 2, 3 and 4 launch K6 and give the
               depth-1 device block bit for bit
  shard        n_accel=4 accelerator-only (all four on cuda:0), cache 20 %
               per device, kernel_pipeline_depth=2, 6 iterations, replicated
               then sharded (hash placement) from the same weights: layer-0
               inputs and losses bit-equal, K4 launched once per combine and
               once per peer gather and K1 never; the shipped-byte ratio,
               peer rows, modelled interconnect bytes and shard sizes; then
               sharded at the default depth 1: inputs and losses bit-equal
               to depth 2's, K1 once per combine and per peer gather, no K4
  depth        the slice at kernel_pipeline_depth 2 against depth 1 from the
               same weights, 3 iterations: losses and shares bit-equal, every
               accelerator combine through K4
  outofcore    the storage tier at the slice's width: the feature matrix
               (2,449,029 x 100 f32, 979,611,600 B) spilled by
               MmapFeatures.spill into 38 blobs of 65,536 rows under
               --spill-dir (default: a fresh directory under build/, removed
               at the end; its filesystem type and free bytes printed first,
               at least twice the matrix required), the spill's seconds and
               peak buffered rows (<= 65,536); the unique frontiers of 8
               host-sampled batches gathered through take bit-equal to the
               dense rows, one cold (after drop_page_cache) and one warm
               gather timed beside np.take from the dense matrix,
               madvise_calls > 0; accel-only training over
               the dense features and over the spill, 4 iterations each:
               losses bit-equal, feature_tier ram / disk; hybrid without DRM
               from cold pages, 10 iterations each, prefetch off, on
               (prefetch_windows=4, dedup history 2) and bounded (and
               mmap_lru_windows=16): each run's initial shares the perf
               model's for the disk tier at its prefetch overlap, all three
               trained from the overlap-1 shares, losses bit-equal, health
               ok, the bound evicting; then the slice's configuration (the
               device sampler, DRM) with prefetch_windows=4 for 6
               iterations.  Every run launches K1 and K2 on each
               accelerator iteration and reports storage_io(), t_load and
               t_load_stall per iteration; on tmpfs the line says that its
               "disk" is RAM.  The spill stays for the next two phases
  faults       the failure model at full width, host sampler, no DRM, over
               the spill unless marked: (a) the reference's transient
               storage schedule (storage.take at calls 0 and 7-8,
               storage.prefetch at 1) against a clean twin, 2 accelerators
               on cuda:0, prefetch_windows=4, 6 iterations: losses
               bit-equal, >= 3 retries, errors and raised faults; (b) the
               prefetch worker killed from its third item with a restart
               budget of 1, 8 iterations: finite losses, health degraded
               with a "synchronously" prefetcher event, one restart, the
               measured overlap 0; (c) a permanent refresh.stage fault with
               cache_refresh on, drift threshold 0 and a failure budget of
               2, against refresh off, 6 iterations: refresh disabled,
               version 0, no K5 launch, losses bit-equal; (d) over the
               dense features, hybrid, 2 accelerators, sequential stages,
               accel0 killed at iteration 3 of 8: finite losses, accel0 in
               health's failed trainers, the shares adding up to 1,024 over
               the survivors, K2 twice per iteration from iteration 3 and
               K1 once from iteration 4 (accel1 only; iteration 3's combine
               ran before accel0 died); (e) last, a 4 s pipeline.load delay
               at its third call under a 1 s watchdog: PipelineStallError
               naming "load" within 10 s, its diagnosis time, the stranded
               stage thread joined.  K1 once and K2 twice per accelerator
               batch in every training run
  autotune     benchmarks/bench_autotune.py's three knob sets on the slice
               over the spill (1 accelerator, accelerator only, host
               sampler, no DRM), 36 iterations each: hand (prefetch 4, LRU
               8, threads 2/2/2), bad-static (prefetch 0, LRU 1, threads
               4/1/1) and bad-auto (bad-static with auto_tune,
               autotune_interval 3 and cache_refresh): bad-auto's losses
               bit-equal to bad-static's, every knob state inside its
               bounds, K1/K2 on every iteration (K5 counted); reads the
               trials, accepted moves, rollbacks, final knobs, each move's
               predicted and measured ms, each run's steady iteration time
               (the mean of the last third, its worst dropped), bad-auto
               and bad-static against hand, and the host ms of every
               boundary where a window closed
  cli          python -m repro_torch.launch.train_gnn's main on the card:
               ogbn-products at scale 0.01, 12 iterations, 2 accelerators,
               pallas_fused, the mmap tier with prefetch, a 20 % cache with
               refresh, --auto-tune, --inject-failure 3 and a two-spec
               --fault-schedule: finite losses, accel0 among the survived
               failures, one "health:" line, K1/K2 launched
  serve        the LM serving path at llama3.2-1b full width and depth (bf16,
               attn_impl="flash", random weights from a seed): (a) prefill
               4 x 4096 tokens with make_prefill_step, prefill_into_cache,
               32 greedy decode steps with make_serve_step (prefill ms,
               decode ms per token, tok/s, peak device memory); (b) K8 16
               times per prefill; (c) the same prefill through the blocked
               plain path: last-position logits and caches within stated
               bf16 tolerances; (d) 1 x 512 tokens + 4 decode steps on the
               card against the host from the same weights; (e)
               repro_torch.launch.serve's main at its defaults on
               llama3.2-1b (the stepwise route, no K8)
  lm_train     LM training at llama3.2-1b full width and depth (bf16,
               attn_impl="flash", remat, random weights from a seed):
               (a) K8's gradient at the training shape [1, 4096, 8, 4, 64]:
               autograd through ops.flash_attention (K8 forward, the
               reference's recompute VJP) bit-equal to the plain forward
               and backward on the card, the forward within K8's
               tolerance, forward + backward timed beside SDPA's (timed
               only); (b) TokenPipeline(4 x 4096, depth 2) into
               make_train_step with 4 microbatches and AdamW under the
               cosine schedule, 8 steps: finite losses, ms per step (median
               of steps 2-7), tok/s, peak device memory, K8 launches per
               step equal to 16 layers x 4 microbatches x 2 (forward and
               remat recompute), then one more step traced (device ms by
               kernel kind, idle share); (c) one step through flash and
               one through blocked from the same weights on 1 x 4096
               tokens: losses, global gradient norms and updated
               parameters within stated bf16 bounds; (d) depth 2, 1 x 512
               tokens, card against host from the same weights: loss and
               every gradient leaf; (e) python -m repro_torch.launch.train
               on smollm-135m (full width, 4 x 512, flash) as a subprocess
               for 10 steps with a checkpoint every 5, then again for 15,
               restoring step 10: wall time, losses, checkpoint bytes (the
               directory under build/ removed after)
  lm_moe       MoE blocks, sliding-window attention and the stub frontends
               at published widths (bf16, random weights from a seed, the
               depth cut): (a) mixtral-8x22b at depth 4, 4 x 4096 prefill
               into a ring cache of min(4096 + 32, window 4096) slots, 32
               greedy decode steps (the first wraps the ring): prefill ms,
               decode ms per token, tok/s, peak memory, the share of
               assignments dropped at capacity factor 1.25; then prefill +
               decode again at capacity factor E / top_k (nothing drops)
               against one forward over prompt and decoded tokens, at the
               positions routed alike in every layer; (b) the blocked
               route's sliced window + q_block view at [1, 8192, 8, 6, 128]
               against one whole-sequence block with the window mask; (c)
               mixtral at depth 1, TokenPipeline 2 x 8192 in 2 microbatches,
               remat, SGD with momentum, 4 steps: finite losses, aux > 0,
               the drop share, ms per step, tok/s, peak memory; (d) its
               weights copied to the host, 1 x 512 tokens: the loss and
               every gradient leaf card against host, the tokens routed
               apart counted (bounds per such token); (e) llama4-scout at
               depth 2 through K8: K8 alone at [4, 4096, 8, 5, 128] against
               its plain version and timed beside SDPA, the serving chain
               as (a) with 2 K8 launches a prefill, flash vs blocked last
               logits, the check at capacity factor 16; (f) musicgen-medium
               and internvl2-1b at full width and depth, 1 x 4096 from
               TokenPipeline: one loss_fn through K8 and through blocked,
               3 AdamW steps with remat, K8 2 x layers a step
  lm_ssm       RWKV-6 and Mamba-2 blocks at published widths (bf16, random
               weights from a seed): (a) rwkv6-1.6b at full depth: a 4 x
               4096 whole-sequence prefill (the chunked WKV, 32 chunks a
               layer; ms, tok/s, peak memory), launch/serve.generate with a
               64-token prompt stepped through the serve step and 32
               greedy tokens (ms a token), the prompt and those tokens
               teacher-forced through the serve step against one forward:
               in bf16 within twice the bf16 forward's own distance from
               f32, and, the weights widened, in f32 over the first layers
               (random weights at full depth amplify rounding; the
               full-depth f32 reading is reported); the chunked WKV against the
               sequential one at [4, 4096, 32, 64] (1e-3), each timed, and
               the ragged route (4,000 tokens: the scan) timed; (b)
               zamba2-7b at full depth (81 Mamba layers, 13 sites of the
               shared attention, attn_impl="flash"): K8 alone at [4, 4096,
               32, 1, 112] against its plain version (f32 2e-5, bf16 1e-2)
               and timed beside SDPA, then (a)'s serving readings with 13
               K8 launches a prefill, and flash vs blocked last logits;
               (c) training, TokenPipeline x 4096, remat: rwkv6-1.6b at full
               depth, 1 x 4096, AdamW, 3 steps; zamba2-7b at depth 7 (one
               site of 6 Mamba layers and the shared block, one tail
               layer), 2 x 4096 in 2 microbatches, SGD with momentum, 3
               steps, K8 4 a step (the site's forward and its recompute,
               each microbatch); finite losses, ms a step, tok/s, peak
               memory; (d) card vs host at full width, 1 x 512: rwkv at
               depth 1, zamba as one site of one Mamba layer and the
               shared block; the loss and every gradient leaf
  mesh         the mesh route (~2-3 min): (a) python -m
               repro_torch.launch.dryrun on six cells of the 16 x 16
               production mesh under the fake process group (256 ranks, no
               card: the reference's three test cells, smollm-135m's auto
               cell, llama3.2-1b's train_4k and prefill_32k under auto;
               rwkv6's cell started before lm_ssm), every cell ok, its bytes
               a rank, fits_80gb, FLOPs, collective bytes by kind and the
               roofline terms at the H100's constants; (b) two ranks on
               cuda:0 over gloo (NCCL refuses two ranks on one card),
               llama3.2-1b at full width and depth 4 under dp on a (2, 1)
               mesh, K8 under local_map, 2 AdamW steps of 2 x 4096 tokens:
               losses within the lm_train bound of the one-process run, K8
               8 times a step on each rank, the parameters' layout kept, ms
               a step (gloo, host-staged: no speed meaning); tp2d is held on
               the CPU by the tests (gloo's functional all-gather and
               reduce-scatter on CUDA tensors never complete); (c)
               hierarchical_psum_mean of the two ranks' own f32 gradient
               trees on the (2, 1) mesh and on a (2, 1, 1) pod mesh (its
               flat path) equal to a flat all_reduce mean, the identity on
               a mesh of one; (d) python -m repro_torch.launch.train
               --model-parallel 2 in one process: no mesh, K8 launched
  multicard    the paths that exist only across cards, on min(visible, 4)
               cards (one card visible: one line, {"phase": "multicard",
               "skipped": "1 card visible"}; --cards N exits non-zero
               first when fewer than N are visible): (a) the slice at
               n_accel=4, one accelerator trainer a card (accelerator i on
               cuda:i), the CPU trainer on the host: with the DRM off, 8
               iterations, layer-0 inputs, losses and final parameters
               bit-equal to all four on cuda:0, each card launching K1
               once and K2 twice for each of its own batches; then the DRM
               on, 30 iterations, on one card and on four: the medians of
               the iteration time, MTEPS and every stage, the shares
               (finite losses, shares adding up to 1,024); (b) the shard
               phase's configuration one shard a card at
               kernel_pipeline_depth 1 and 2, replicated, sharded, and
               sharded all on cuda:0: inputs and losses bit-equal,
               feature_traffic() equal to one card's, each card launching
               K1 (K4) once for each of its combines and each peer gather
               it owns; then the cache refreshing at every boundary at
               tfp_depth 0, replicated against sharded at both depths:
               losses equal, each shard's K5 (K6) scatters on its own card;
               a peer gather's rows (6,524 x 100 f32) and 256 MiB copied
               card 1 -> card 0, GB/s beside the perf model's 450; (c)
               the LM training CLI under torchrun, one rank a card over
               NCCL, llama3.2-1b at full width and depth (bf16, flash,
               remat), 3 AdamW steps of a global 4 x 4096 batch, one
               microbatch a rank, on a (4, 1) and a (2, 2) mesh
               (--model-parallel 1 and 2): each rank's losses within the
               lm_train bound of the one-process CLI on cuda:0 (the batch
               in 4 microbatches), 32 K8 launches a step (16 layers,
               forward and recompute), the parameters' layout kept, ms a
               step and peak memory a rank; hierarchical_psum_mean of the
               ranks' own f32 gradient trees on a (4, 1) and a (2, 2, 1)
               pod mesh against a flat all_reduce mean: within
               PSUM_ULP_TOL ulp of the summands' scale an element, the
               elements that differ counted.  Each card's K1/K2/K4/K5/
               K6/K8 launches and its links (nvidia-smi topo -m) on a line
               of its own; ranks are spawned processes, each launch under
               a time limit, and a rank that fails fails the run

The phases before multicard place logical accelerator i on cuda:(i % the
visible cards), as the trainer does: on one card every accelerator shares
cuda:0; with more cards visible their accelerators spread as multicard's do.

The kernels phase also holds K8 (flash attention) against its plain version
at the prefill's shape in f32 (the FMA body) and bf16 (the tensor-core
body) and times the bf16 body beside ``scaled_dot_product_attention``
(timed only; the port never calls it), with its achieved TFLOP/s and the
fraction of its bound it reaches.

then the card's name and power limit as nvidia-smi prints them, one
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
Any failed check raises: the script exits non-zero and prints no result.
It needs a CUDA card and the repository's ``src/``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import glob
import json
import math
import os
import queue
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

K_SOURCES = {
    "cache_combine": ("src/repro_torch/kernels/csrc/cache_combine.cu",
                      "src/repro/kernels/gather_scatter_mm.py:291"),
    "cache_combine_pipelined": (
        "src/repro_torch/kernels/csrc/cache_combine.cu",
        "src/repro/kernels/gather_scatter_mm.py:386"),
    "cache_combine_legacy": ("src/repro_torch/kernels/csrc/cache_combine.cu",
                             "src/repro/kernels/gather_scatter_mm.py:173"),
    "fused_update": ("src/repro_torch/kernels/csrc/fused_update.cu",
                     "src/repro/kernels/gather_scatter_mm.py:125"),
    "segment_sum": ("src/repro_torch/kernels/csrc/segment_sum.cu",
                    "src/repro/kernels/gather_scatter_mm.py:73"),
    "cache_update": ("src/repro_torch/kernels/csrc/cache_update.cu",
                     "src/repro/kernels/gather_scatter_mm.py:229"),
    "cache_update_pipelined": ("src/repro_torch/kernels/csrc/cache_update.cu",
                               "src/repro/kernels/gather_scatter_mm.py:493"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:68"),
}
K6_DEPTHS = (2, 3, 4)        # K6's line reports depth 2
K4_DEPTHS = (2, 3, 4)        # K4's line reports depth 2
SHARD_ACCEL = 4
SPILL_ROWS = 65536           # the outofcore phase's partition (38 blobs)
LRU_WINDOWS = 16             # its bounded run: fewer windows than a batch
STAGES = ("t_sa", "t_sc", "t_load", "t_tran", "t_tc", "t_ta")
LM_ARCH = "llama3.2-1b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 4096, 32
HOST_BATCH, HOST_PROMPT, HOST_GEN = 1, 512, 4
BF16_TFLOPS = 989e12          # H100 SXM dense bf16 tensor cores (datasheet)
# K8 against its plain version: f32 sums of 64-key tiles in another order
# (2e-5); bf16, one rounding of an f32 value that may differ in its last
# bits (1e-2, about one bf16 ulp at |x| <= 2)
K8_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
# Whole bf16 models on two routes (flash vs blocked; card vs host).  The CPU
# rehearsal (llama3.2-1b widths, 16 layers, vocab cut to 8192, 1 x 512
# tokens, flash vs blocked) differed by at most 0.078 and on average 0.0127
# in the last logits (|x| up to 4.1) and 0.080 / 0.0099 in the caches; the
# bounds leave 3x and 2.4x for the larger batch and prompt.
BF16_MAX, BF16_MEAN = 0.25, 0.03


PHASE_LOG: list = []         # --out's phases.jsonl, when given


def emit(phase: str, **fields) -> None:
    line = json.dumps({"phase": phase, **fields}, default=float)
    print(line, flush=True)
    if PHASE_LOG:
        with open(PHASE_LOG[0], "a") as fh:
            fh.write(line + "\n")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def call_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """What one Python call of ``fn`` costs its caller, host included: the
    median over ``reps`` calls of the time between a CUDA event recorded
    before the call and one recorded after it (the stream idles while the
    host runs the wrapper).  Inputs stay warm in L2."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# The device-time yardstick: before each timed call a 256 MB buffer is
# rewritten (bitwise_not_, a kernel no timed function launches), which
# evicts the 50 MB L2, so every call meets its inputs cold.
FLUSH_ELEMS = (256 << 20) // 8
FLUSH_KERNEL = "bitwise_not"
SLEEP_CYCLES = 50_000_000      # ~25 ms at 2 GHz: the host enqueues first
TIMING = {"method": None}      # "profiler" or "events", fixed at first use
_flush_buf: list = []


def flush_l2() -> None:
    if not _flush_buf:
        _flush_buf.append(torch.zeros(FLUSH_ELEMS, dtype=torch.int64,
                                      device="cuda"))
    _flush_buf[0].bitwise_not_()


def _profiled_ms(fn, reps: int):
    """Per call, the summed device durations of every kernel, copy and
    memset ``fn`` launched (torch.profiler, CUPTI), split at the flush
    kernels; the median over ``reps`` calls, or None when the profiler saw
    no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush_l2()
            fn()
        torch.cuda.synchronize()
    dev = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)),
                 key=lambda e: e.time_range.start)
    calls: list = []
    for e in dev:
        if FLUSH_KERNEL in e.name:
            calls.append(0.0)
        elif calls:
            calls[-1] += e.time_range.end - e.time_range.start   # us
    if len(calls) != reps or not all(c > 0 for c in calls):
        return None
    return statistics.median(calls) / 1e3


def _event_ms(fn, reps: int) -> float:
    """The fallback: CUDA events around ``reps`` (flush, call) pairs queued
    behind a device sleep, so the host has enqueued them all before the
    device reaches them; the same loop with the flushes alone subtracted."""
    def run(call: bool) -> float:
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            flush_l2()
            if call:
                fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    return max(run(True) - run(False), 0.0) / reps


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """The device time of one call of ``fn`` alone, its inputs cold in L2:
    the host's time between launches is not in it.  torch.profiler's
    per-kernel device durations where the profiler sees the device, else
    CUDA events behind a device sleep (``TIMING["method"]`` says which)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if TIMING["method"] is None:
        probe = _profiled_ms(lambda: torch.empty(1 << 20,
                                                 device="cuda").fill_(1.0),
                             3)
        TIMING["method"] = "profiler" if probe else "events"
    if TIMING["method"] == "profiler":
        # a traced window now and then misses a record (seen once, on the
        # SDPA yardstick): trace again, and fail only when three windows in
        # a row miss one
        for _ in range(3):
            ms = _profiled_ms(fn, reps)
            if ms is not None:
                return ms
        check(False, "the profiler lost a timed call's kernels three times")
    return _event_ms(fn, reps)


def timed(fn, prefix: str = "") -> dict:
    """Both readings of ``fn``: ``{prefix}ms`` (device time alone, L2
    flushed) and ``{prefix}call_ms`` (one host-inclusive call)."""
    return {f"{prefix}ms": device_ms(fn), f"{prefix}call_ms": call_ms(fn)}


def event_timed(fn, prefix: str = "", reps: int = 20) -> dict:
    """``timed`` by CUDA events behind a device sleep (flushes
    subtracted), where the profiler's traced windows lose records: a call
    whose backward autograd launches from its own device thread (the first
    flush of the port's forward + backward in every window of two of four
    full runs, one of SDPA's in another), and SDPA at llama4-scout's shape
    late in a full run (three windows in a row)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return {f"{prefix}ms": _event_ms(fn, reps), f"{prefix}call_ms": call_ms(fn),
            f"{prefix}timing": "events"}


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def close(a, b, rtol, atol, what) -> float:
    err = max_err(a, b)
    ok = bool(torch.allclose(a.float(), b.float(), rtol=rtol, atol=atol))
    check(ok and a.shape == b.shape, f"{what}: max abs err {err}")
    return err


def bits(t: torch.Tensor) -> torch.Tensor:
    """The raw bits of a float tensor (so NaN payloads compare too)."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtypes, shapes and bits (floats compared as raw words)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return (torch.equal(bits(a), bits(b)) if a.is_floating_point()
            else torch.equal(a, b))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ---------------------------------------------------------------- phases


def phase_env() -> dict:
    from repro_torch.kernels import build
    import importlib.util
    triton_version = None
    if importlib.util.find_spec("triton") is not None:
        import triton
        triton_version = triton.__version__
    nvcc = build._nvcc()
    nvcc_line = next(
        (ln for ln in subprocess.run([nvcc, "--version"], capture_output=True,
                                     text=True).stdout.splitlines()
         if "release" in ln), "?")
    t0 = time.perf_counter()
    build.build_all()
    env = dict(torch=torch.__version__, cuda=torch.version.cuda,
               python=sys.version.split()[0],
               nvidia_smi=nvidia_smi(), nvcc=nvcc_line, triton=triton_version,
               device=torch.cuda.get_device_name(0),
               device_count=torch.cuda.device_count(),
               kernel_build_s=time.perf_counter() - t0,
               allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32)
    emit("env", **env)
    return env


def main_path_inputs(trainer, b: int, seed: int = 123):
    """A real batch of ``b`` targets classified against the trainer's cache
    (its own sampler and rng: the trainer's streams and stats are not
    touched)."""
    from repro_torch.graph import NumpySampler
    ds = trainer.dataset
    rng = np.random.default_rng(seed)
    tgt = rng.choice(ds.num_nodes, b, replace=False)
    mb = NumpySampler(ds.graph, trainer.gnn_cfg.fanouts,
                      seed=seed).sample(tgt, ds.labels[tgt])
    look = trainer.cache.lookup(mb.frontier(len(mb.fanouts)), record=False)
    rows = torch.from_numpy(ds.take_features(look.miss_ids))
    return mb, look, rows


def peer_request(trainer, dev: torch.device, seed: int = 123):
    """A peer gather of the shard phase at its real size: the plane of
    SHARD_ACCEL hash-placed shards at the trainer's per-device budget, a
    batch of ``total_batch`` targets split over SHARD_ACCEL trainers, and
    accel0's first request.  Returns the owner shard's device block and
    the requested slots (int32, on ``dev``)."""
    from repro_torch.graph import NumpySampler, build_sharded_cache
    ds = trainer.dataset
    plane = build_sharded_cache(ds, trainer.cfg.cache_fraction, SHARD_ACCEL,
                                placement="hash")
    per = trainer.cfg.total_batch // SHARD_ACCEL
    tgt = np.random.default_rng(seed).choice(ds.num_nodes,
                                             per * SHARD_ACCEL, replace=False)
    sampler = NumpySampler(ds.graph, trainer.gnn_cfg.fanouts, seed=seed)
    frontiers = {}
    for i in range(SHARD_ACCEL):
        t = tgt[i * per:(i + 1) * per]
        mb = sampler.sample(t, ds.labels[t])
        frontiers[f"accel{i}"] = mb.frontier(len(mb.fanouts))
    union = plane.lookup_union(frontiers, {name: i for i, name in
                                           enumerate(sorted(frontiers))},
                               record=False)
    peer, slots, _ = union.per_trainer["accel0"].peer_requests[0]
    return (plane.shards[peer].data_on(dev),
            torch.from_numpy(slots).to(dev))


def phase_kernels(trainer, b: int, platform: str, dev: torch.device) -> dict:
    from repro_torch.core.perfmodel import PLATFORMS
    from repro_torch.kernels import ops, ref
    # the card's datasheet peaks: fp32 outside the tensor cores, HBM rate
    spec = PLATFORMS[platform]
    peak_flops, peak_bw = spec.peak_tflops * 1e12, spec.mem_bw_gbps * 1e9
    gen = torch.Generator(device=dev).manual_seed(0)
    mb, look, rows = main_path_inputs(trainer, b)
    fan2, fan1 = mb.fanouts          # hop fanouts (25, 10)
    out = {}

    # ---- K1 cache combine: bit-equal, f32 and bf16 ----------------------
    cache32 = trainer.cache.data_on(dev)
    miss32 = rows.to(dev)
    slots = torch.from_numpy(look.slots).to(dev)
    mi = torch.from_numpy(look.miss_index).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        cache, miss = cache32.to(dtype), miss32.to(dtype)
        got = ops.assemble_features(cache, miss, slots, mi)
        want = ref.assemble_features(cache, miss, slots, mi)
        check(torch.equal(got, want), f"K1 {dtype} not bit-equal")
    x0 = ops.assemble_features(cache32, miss32, slots, mi)
    n, f = x0.shape
    uniq_src = int(np.unique(look.slots[look.slots >= 0]).size) + \
        int(np.unique(look.miss_index[look.slots < 0]).size)
    k1_bytes = n * f * 4 + n * 8 + uniq_src * f * 4
    k1_bound = k1_bytes / peak_bw * 1e3
    # the cache-less dedup path (every unique id shipped) and a peer gather
    # of the shard phase (every slot hits, an empty miss block): bit-equal
    # to the plain version and to K4, and timed beside one library call of
    # the same function
    uniq = torch.from_numpy(trainer.dataset.take_features(
        look.unique_ids)).to(dev)
    inv = torch.from_numpy(look.inverse).to(dev)
    block, peer_slots = peer_request(trainer, dev)
    cases = {   # name -> (cache, miss, slots, miss_index, source, index)
        "cache_less": (None, uniq, torch.full_like(inv, -1), inv, uniq, inv),
        "peer_gather": (block, block[:0], peer_slots,
                        torch.zeros_like(peer_slots), block, peer_slots)}
    yardsticks = {}
    for case, (c, m, sl, mx, src, index) in cases.items():
        for dtype in (torch.float32, torch.bfloat16):
            cc = c.to(dtype) if c is not None else None
            k1 = bits(ops.assemble_features(cc, m.to(dtype), sl, mx))
            check(torch.equal(k1, bits(ref.assemble_features(
                cc, m.to(dtype), sl, mx))),
                  f"K1 {case} {dtype} not bit-equal to the plain version")
            for depth in K4_DEPTHS:
                check(torch.equal(k1, bits(ops.assemble_features(
                    cc, m.to(dtype), sl, mx, depth))),
                      f"K4 depth {depth} {case} {dtype} not bit-equal to K1")
        rows = int(sl.shape[0])
        byts = rows * f * 4 + rows * 8 + \
            int(torch.unique(index).numel()) * f * 4
        yardsticks[case] = dict(
            shape=[rows, f], source_rows=int(src.shape[0]), bytes=byts,
            bound_ms=byts / peak_bw * 1e3,
            **timed(lambda: ops.assemble_features(c, m, sl, mx)),
            **timed(lambda: torch.index_select(src, 0, index), "library_"))
    cache16, miss16 = cache32.bfloat16(), miss32.bfloat16()
    out["cache_combine"] = dict(
        name="cache_combine", max_abs_err=0.0, shape=[n, f],
        **timed(lambda: ops.assemble_features(cache32, miss32, slots, mi)),
        **timed(lambda: ref.assemble_features(cache32, miss32, slots, mi),
                "plain_"),
        library_ms=None, library_call_ms=None, bound_ms=k1_bound,
        bound_by="bytes", bytes=k1_bytes, flops=0,
        **timed(lambda: ops.assemble_features(cache16, miss16, slots, mi),
                "bf16_"),
        bf16_bound_ms=(n * f * 2 + n * 8 + uniq_src * f * 2) / peak_bw * 1e3,
        **yardsticks)
    del cache16, miss16
    out.update(pipelined_and_legacy_combine(cache32, miss32, look, dev,
                                            k1_bytes, k1_bound))

    # ---- model tensors at the slice's widths ----------------------------
    d1 = b * (1 + fan2)                       # layer-1 destinations (26b)
    p = trainer.params
    f0, h = p["w1"].shape[0] // 2, p["w1"].shape[1]
    gb = mb.to(dev)

    def gcn_edge(hop: int, n_dst: int, fanout: int):
        sdeg = gb.hop_src_deg[hop].float()
        ddeg = gb.hop_dst_deg[hop].float()
        we = (1.0 / torch.sqrt((sdeg + 1) * (ddeg + 1))) * (ddeg / fanout)
        ss = 1.0 / (ddeg.reshape(n_dst, fanout)[:, 0] + 1.0)
        return we.contiguous(), ss.contiguous()

    wg1 = torch.randn(f0, h, generator=gen, device=dev) / math.sqrt(f0)
    wg2 = torch.randn(h, 47, generator=gen, device=dev) / math.sqrt(h)
    bias1, bias2 = p["b1"] + 0.1, p["b2"] + 0.1
    x1 = torch.relu(ref.fused_gnn_update(
        x0[:d1], x0[d1:], torch.full((d1 * fan1,), 1.0 / fan1, device=dev),
        torch.ones(d1, device=dev), p["w1"][:f0], p["w1"][f0:], bias1, fan1))
    layers = {   # name -> (x_self, x_nbr, w_edge, self_scale, ws, wa, b, fan)
        "sage1": (x0[:d1], x0[d1:],
                  torch.full((d1 * fan1,), 1.0 / fan1, device=dev),
                  torch.ones(d1, device=dev), p["w1"][:f0], p["w1"][f0:],
                  bias1, fan1),
        "sage2": (x1[:b], x1[b:], torch.full((b * fan2,), 1.0 / fan2,
                                             device=dev),
                  torch.ones(b, device=dev), p["w2"][:h], p["w2"][h:],
                  bias2, fan2),
        "gcn1": (x0[:d1], x0[d1:], *gcn_edge(1, d1, fan1), wg1, wg1, bias1,
                 fan1),
        "gcn2": (x1[:b], x1[b:], *gcn_edge(0, b, fan2), wg2, wg2, bias2,
                 fan2),
    }
    layers = {k: tuple(t.contiguous() if isinstance(t, torch.Tensor) else t
                       for t in v) for k, v in layers.items()}

    # ---- K2 fused layer --------------------------------------------------
    k2 = {"name": "fused_update", "layers": {}}
    err2 = 0.0
    for name, args in layers.items():
        got = ops.fused_gnn_update(*args)
        want = ref.fused_gnn_update(*args)
        err2 = max(err2, close(got, want, 1e-4, 1e-4, f"K2 {name}"))
    # gradients: every input differentiable, layer-2 shapes
    for name in ("sage2", "gcn2"):
        args = layers[name]
        g = torch.randn(args[0].shape[0], args[4].shape[1], generator=gen,
                        device=dev)
        ins = [a.detach().clone().requires_grad_() for a in args[:7]]
        grads_k = torch.autograd.grad(ops.fused_gnn_update(*ins, args[7]),
                                      ins, g)
        ins_r = [a.detach().clone().requires_grad_() for a in args[:7]]
        grads_r = torch.autograd.grad(ref.fused_gnn_update(*ins_r, args[7]),
                                      ins_r, g)
        for i, (a, r) in enumerate(zip(grads_k, grads_r)):
            err2 = max(err2, close(a, r, 1e-4, 1e-4, f"K2 grad {name}[{i}]"))
    sums = dict.fromkeys(("ms", "call_ms", "plain_ms", "plain_call_ms",
                          "bound_ms"), 0.0)
    b2_total = fl2_total = 0
    for name in ("sage1", "sage2"):   # the slice's two launches
        xs, xn, we, ss, ws, wa, bb, fan = layers[name]
        d_, f_ = xs.shape
        o_ = ws.shape[1]
        byts = nbytes(xs, xn, we, ss, ws, wa, bb) + d_ * o_ * 4
        flops = 4 * d_ * f_ * o_ + 2 * d_ * fan * f_ + d_ * f_
        lay = dict(shape=[d_, fan, f_, o_], bytes=byts, flops=flops,
                   bound_ms=max(byts / peak_bw, flops / peak_flops) * 1e3,
                   **timed(lambda: ops.fused_gnn_update(*layers[name])),
                   **timed(lambda: ref.fused_gnn_update(*layers[name]),
                           "plain_"))
        k2["layers"][name] = lay
        for key in sums:
            sums[key] += lay[key]
        b2_total, fl2_total = b2_total + byts, fl2_total + flops
    k2.update(max_abs_err=err2, library_ms=None, library_call_ms=None,
              bytes=b2_total, flops=fl2_total, **sums,
              bound_by=("bytes" if b2_total / peak_bw >= fl2_total
                        / peak_flops else "operations"))
    out["fused_update"] = k2

    # ---- K3 segment sum (gcn edge weights) -------------------------------
    k3 = {"name": "segment_sum", "layers": {}}
    err3 = 0.0
    seg = {"gcn1": (layers["gcn1"][1], layers["gcn1"][2], fan1),
           "gcn2": (layers["gcn2"][1], layers["gcn2"][2], fan2)}
    for name, (xn, we, fan) in seg.items():
        err3 = max(err3, close(ops.segment_weighted_sum_regular(xn, we, fan),
                               ref.segment_weighted_sum_regular(xn, we, fan),
                               1e-5, 1e-5, f"K3 {name}"))
        xb, wb = xn.bfloat16(), we.bfloat16()
        close(ops.segment_weighted_sum_regular(xb, wb, fan),
              ref.segment_weighted_sum_regular(xb, wb, fan), 1e-2, 1e-2,
              f"K3 bf16 {name}")
        ins = [xn.detach().clone().requires_grad_(),
               we.detach().clone().requires_grad_()]
        g = torch.randn(xn.shape[0] // fan, xn.shape[1], generator=gen,
                        device=dev)
        gk = torch.autograd.grad(ops.segment_weighted_sum_regular(*ins, fan),
                                 ins, g)
        ins_r = [t.detach().clone().requires_grad_() for t in ins]
        gr = torch.autograd.grad(
            ref.segment_weighted_sum_regular(*ins_r, fan), ins_r, g)
        for i, (a, r) in enumerate(zip(gk, gr)):
            err3 = max(err3, close(a, r, 1e-5, 1e-5, f"K3 grad {name}[{i}]"))
    sums = dict.fromkeys(("ms", "call_ms", "plain_ms", "plain_call_ms",
                          "library_ms", "library_call_ms", "bound_ms"), 0.0)
    b3_total = fl3_total = 0
    for name, (xn, we, fan) in seg.items():
        d_, f_ = xn.shape[0] // fan, xn.shape[1]
        byts = nbytes(xn, we) + d_ * f_ * 4
        flops = 2 * d_ * fan * f_
        # one library call computing the same function: a batched product
        # [D, 1, fanout] x [D, fanout, F]
        w3, x3 = we.view(d_, 1, fan), xn.view(d_, fan, f_)
        lay = dict(shape=[d_, fan, f_],
                   bound_ms=max(byts / peak_bw, flops / peak_flops) * 1e3,
                   **timed(lambda: ops.segment_weighted_sum_regular(xn, we,
                                                                    fan)),
                   **timed(lambda: ref.segment_weighted_sum_regular(xn, we,
                                                                    fan),
                           "plain_"),
                   **timed(lambda: torch.bmm(w3, x3), "library_"))
        k3["layers"][name] = lay
        for key in sums:
            sums[key] += lay[key]
        b3_total, fl3_total = b3_total + byts, fl3_total + flops
    k3.update(max_abs_err=err3, bound_by="bytes", bytes=b3_total,
              flops=fl3_total, **sums)
    out["segment_sum"] = k3
    out.update(refresh_scatter(trainer, b, peak_bw, dev))
    out["flash_attention"] = flash_kernel(dev, peak_bw)
    emit("kernels", b=b, platform=platform, **out)
    return out


def flash_kernel(dev, peak_bw: float) -> dict:
    """K8 at the serve phase's prefill shape (llama3.2-1b: B 4, S 4096, 8
    KV heads of 4 query heads, D 64) against its plain version in f32 and
    bf16, and its time, the plain version's and SDPA's in bf16."""
    from repro_torch.configs import get_arch
    cfg = get_arch(LM_ARCH)
    return k8_at(dev, peak_bw, (SERVE_BATCH, SERVE_PROMPT, cfg.n_kv,
                                cfg.n_heads // cfg.n_kv, cfg.hd),
                 cfg.q_block, (torch.float32, torch.bfloat16), timed)


def k8_at(dev, peak_bw: float, shape, q_block: int, dtypes, timer) -> dict:
    """K8 at ``shape`` (B, S, Hkv, G, D) on seeded inputs: held against its
    plain version in each of ``dtypes``, then timed in bf16 by ``timer``
    (``timed`` or ``event_timed``) beside the plain version and
    ``scaled_dot_product_attention`` (timed only; the port never calls
    it), with its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    b, s, hkv, g, d = shape
    gen = torch.Generator(device=dev).manual_seed(1)
    q32 = torch.randn(b, s, hkv, g, d, generator=gen, device=dev)
    k32 = torch.randn(b, s, hkv, d, generator=gen, device=dev)
    v32 = torch.randn(b, s, hkv, d, generator=gen, device=dev)
    err = {}
    for dtype in dtypes:
        q, k, v = (t.to(dtype) for t in (q32, k32, v32))
        got = ops.flash_attention(q, k, v, q_block)
        want = ref.flash_attention(q, k, v, q_block)
        torch.cuda.synchronize()
        err[str(dtype)] = close(got, want, K8_TOL[dtype], K8_TOL[dtype],
                                f"K8 {dtype} at {list(shape)}")
        del got, want
    q, k, v = (t.to(torch.bfloat16) for t in (q32, k32, v32))
    del q32, k32, v32
    # SDPA's layout: [B, H, S, D], query head h*G + g on KV head h
    qt = q.view(b, s, hkv * g, d).transpose(1, 2)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    flops = 2 * b * hkv * g * d * s * s      # causal: half of 4*B*Hq*D*S^2
    byts = nbytes(q, k, v) + q.numel() * q.element_size()
    t = timer(lambda: ops.flash_attention(q, k, v, q_block))
    ms = t["ms"]
    bound_ms = max(byts / peak_bw, flops / BF16_TFLOPS) * 1e3
    return dict(
        name="flash_attention", shape=list(shape), dtype="bfloat16",
        max_abs_err=err[str(torch.bfloat16)], max_abs_err_by_dtype=err,
        **t,
        **timer(lambda: ref.flash_attention(q, k, v, q_block), "plain_"),
        **timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), "library_"),
        bound_ms=bound_ms,
        bound_by=("bytes" if byts / peak_bw >= flops / BF16_TFLOPS
                  else "operations"), bytes=byts, flops=flops,
        tflops=flops / (ms * 1e-3) / 1e12, bound_fraction=bound_ms / ms)


def pipelined_and_legacy_combine(cache32, miss32, look, dev, k1_bytes,
                                 k1_bound) -> dict:
    """K4 at depths 2..4 and K7 on K1's main-path inputs: bit-equal to K1
    and to the plain versions (f32 and bf16), and their times.  Both compute
    K1's function (K7 through (sel, row) tables), so they share K1's bytes
    and bound."""
    from repro_torch.kernels import ops, ref
    slots = torch.from_numpy(look.slots).to(dev)
    mi = torch.from_numpy(look.miss_index).to(dev)
    hit = look.slots >= 0
    sel = torch.from_numpy((~hit).astype(np.int32)).to(dev)
    row = torch.from_numpy(np.where(hit, look.slots, look.miss_index)
                           .astype(np.int32)).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        cache, miss = cache32.to(dtype), miss32.to(dtype)
        k1 = bits(ops.assemble_features(cache, miss, slots, mi, 1))
        plain = bits(ref.assemble_features(cache, miss, slots, mi))
        for depth in K4_DEPTHS:
            k4 = bits(ops.assemble_features(cache, miss, slots, mi, depth))
            check(torch.equal(k4, k1) and torch.equal(k4, plain),
                  f"K4 depth {depth} {dtype} not bit-equal to K1 and to "
                  f"the plain version")
        k7 = bits(ops.cache_combine_legacy(cache, miss, sel, row))
        check(torch.equal(k7, k1), f"K7 {dtype} not bit-equal to K1")
        check(torch.equal(k7, bits(ref.cache_combine_legacy(cache, miss, sel,
                                                            row))),
              f"K7 {dtype} not bit-equal to its plain version")
    n, f = look.slots.shape[0], cache32.shape[1]
    by_depth = {d: timed(lambda: ops.assemble_features(
        cache32, miss32, slots, mi, d)) for d in K4_DEPTHS}
    common = dict(max_abs_err=0.0, shape=[n, f], library_ms=None,
                  library_call_ms=None, bound_ms=k1_bound, bound_by="bytes",
                  bytes=k1_bytes, flops=0)
    return {
        "cache_combine_pipelined": dict(
            name="cache_combine_pipelined", **by_depth[K4_DEPTHS[0]],
            ms_by_depth={d: t["ms"] for d, t in by_depth.items()},
            call_ms_by_depth={d: t["call_ms"] for d, t in by_depth.items()},
            **timed(lambda: ref.assemble_features(cache32, miss32, slots, mi),
                    "plain_"), **common),
        "cache_combine_legacy": dict(
            name="cache_combine_legacy",
            **timed(lambda: ops.cache_combine_legacy(cache32, miss32, sel,
                                                     row)),
            **timed(lambda: ref.cache_combine_legacy(cache32, miss32, sel,
                                                     row), "plain_"),
            **common)}


def first_commit(trainer, b: int):
    """The (slots, rows) of a real first commit at full width: a fresh
    cache of the trainer's size sees two real batches' frontiers and
    refreshes once on the host.  Returns the pre-commit block, the slots
    whose row changed and the admitted rows (transfer dtype)."""
    from repro_torch.graph import build_cache
    ds = trainer.dataset
    cache = build_cache(ds, trainer.cfg.cache_fraction)
    cache.track_hotness = True
    for seed in (7, 8):
        _, look, _ = main_path_inputs(trainer, b, seed=seed)
        cache.record_lookup(look)
    before_ids, before = cache.cached_ids, cache.host_rows
    moved = cache.refresh()
    slots = np.flatnonzero(cache.cached_ids != before_ids).astype(np.int32)
    check(moved > 0 and slots.size == moved, "the first commit moved no rows")
    rows = cache.host_rows[torch.from_numpy(slots).long()]
    return before, slots, rows


def refresh_scatter(trainer, b: int, peak_bw: float, dev) -> dict:
    """K5 and K6 against the plain keep-last scatter on a real first
    commit (f32 and bf16, with up to 1000 aliased slots appended), and their
    times on the commit's unique slots in f32."""
    from repro_torch.kernels import ops, ref
    block, slots, rows = first_commit(trainer, b)
    rng = np.random.default_rng(0)
    dup = rng.choice(slots.size, min(1000, slots.size), replace=False)
    slots_d = np.concatenate([slots, slots[dup]])
    extra = torch.from_numpy(rng.standard_normal((dup.size, rows.shape[1]))
                             .astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        cache = block.to(dev, dtype)
        rows_d = torch.cat([rows.to(dtype), extra.to(dtype)]).to(dev)
        want = ref.cache_update(cache, rows_d,
                                torch.from_numpy(slots_d).to(dev))
        for depth in (1, *K6_DEPTHS):
            got = ops.update_cache_rows(cache, rows_d, slots_d, depth)
            check(torch.equal(got, want),
                  f"K{5 if depth == 1 else 6} depth {depth} {dtype} not "
                  f"bit-equal to the plain scatter")
    m, f = slots.size, rows.shape[1]
    cache = block.to(dev)
    rows32 = rows.to(dev)
    slots_t = torch.from_numpy(slots).to(dev)
    slots_l = slots_t.long()
    mp = -(-m // ops.UPDATE_ROW_BLOCK) * ops.UPDATE_ROW_BLOCK
    rows_p = torch.zeros(mp, f, device=dev)
    rows_p[:m] = rows32
    out = cache.clone()
    byts = 2 * m * f * 4 + m * 4     # rows read, rows written, slots
    res = {depth: timed(lambda: ops.scatter_rows_(
        out, rows32 if depth == 1 else rows_p, slots_t, depth))
        for depth in (1, *K6_DEPTHS)}
    check(torch.equal(out, ref.cache_update(cache, rows32, slots_t)),
          "timed scatters left a wrong block")
    common = dict(max_abs_err=0.0, rows=m, f=f, bytes=byts, flops=0,
                  bound_ms=byts / peak_bw * 1e3, bound_by="bytes",
                  **timed(lambda: ref.cache_update(cache, rows32, slots_t),
                          "plain_"),
                  **timed(lambda: out.index_copy_(0, slots_l, rows32),
                          "library_"))
    return {"cache_update": dict(name="cache_update", **res[1], **common),
            "cache_update_pipelined": dict(
                name="cache_update_pipelined", **res[K6_DEPTHS[0]],
                ms_by_depth={d: res[d]["ms"] for d in K6_DEPTHS},
                call_ms_by_depth={d: res[d]["call_ms"] for d in K6_DEPTHS},
                **common)}


def phase_train(tr, iters: int) -> dict:
    from repro_torch.kernels import ops
    spy = []
    orig = tr._grad

    def traced(params, batch, x0):
        spy.append((x0.device.type, next(iter(params.values())).device.type))
        return orig(params, batch, x0)
    tr._grad = traced
    # the interpreter's garbage collections during the run (each holds the
    # GIL, so every pipeline thread waits for it)
    gcs: list = []

    def on_gc(when, info):
        if when == "start":
            gcs.append([info["generation"], time.perf_counter()])
        elif gcs:
            gcs[-1][1] = (time.perf_counter() - gcs[-1][1]) * 1e3
    gc.callbacks.append(on_gc)
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    try:
        hist = tr.train(iters)
    finally:
        gc.callbacks.remove(on_gc)
    wall = time.perf_counter() - t0
    launches = ops.kernel_launches()
    tr.close()
    accel_iters = sum(1 for m in hist if m.shares.get("accel0", 0) > 0)
    check(all(math.isfinite(m.loss) for m in hist), "non-finite loss")
    check(accel_iters == len(hist), "an iteration without accel share")
    check(all(p.is_cuda for p in tr.params.values()), "params off the card")
    check(any(s == ("cuda", "cuda") for s in spy),
          "accel trainer input/params not on the card")
    check(launches["cache_combine"] >= accel_iters, f"K1 launches {launches}")
    check(launches["fused_update"] >= 2 * accel_iters,
          f"K2 launches {launches}")
    check(any(m.device_sampled for m in hist),
          "no batch was sampled on the card")
    check(all((m.times.t_sa > 0) == bool(m.device_sampled) for m in hist),
          "t_sa does not follow the device-sampled batches")
    rows = [dict(it=m.iteration, loss=m.loss, shares=m.shares,
                 device_sampled=m.device_sampled,
                 sample_frac_accel=m.sample_frac_accel,
                 assignment=m.assignment, mteps=m.mteps,
                 iter_s=m.iter_time, t_sync=m.t_sync,
                 **{k: getattr(m.times, k) for k in STAGES})
            for m in hist]
    res = dict(iters=len(hist), wall_s=wall, launches=launches,
               gc={g: dict(count=sum(1 for c in gcs if c[0] == g),
                           max_ms=max((c[1] for c in gcs if c[0] == g),
                                      default=0.0),
                           sum_ms=sum(c[1] for c in gcs if c[0] == g))
                   for g in (0, 1, 2)},
               mean_mteps=tr.mean_mteps(), mean_iter_s=tr.mean_iter_time(),
               feature_traffic=tr.feature_traffic(), history=rows)
    emit("train", **res)
    return res


def edge_keys(indptr: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Every CSR edge (v, u) as the sorted key v * num_nodes + u."""
    n = indptr.shape[0] - 1
    dst = torch.repeat_interleave(torch.arange(n, device=indptr.device),
                                  indptr[1:] - indptr[:-1])
    return torch.sort(dst * n + indices.long()).values


def check_device_batch(mb, indptr, indices, keys, b: int) -> None:
    """A batch of the device sampler against the CSR, on the card: the
    fixed shapes, every source a neighbour of its destination (the
    destination itself at degree 0), the CSR's degrees, the dtypes."""
    n = indptr.shape[0] - 1
    deg = indptr[1:] - indptr[:-1]
    frontier = mb.targets
    check(frontier.shape == (b,) and mb.labels.dtype == torch.int64,
          "sampler: targets or labels")
    for h, f in enumerate(mb.fanouts):
        src, dst = mb.hop_src[h], frontier.repeat_interleave(f)
        check(src.shape == (frontier.shape[0] * f,) and src.is_cuda
              and src.dtype == torch.int64, f"sampler: hop {h} sources")
        edge = dst * n + src
        pos = torch.searchsorted(keys, edge).clamp(max=keys.shape[0] - 1)
        ok = torch.where(deg[dst] == 0, src == dst, keys[pos] == edge)
        check(bool(ok.all()), f"sampler: hop {h} has a source that is not "
              f"a neighbour of its destination")
        check(torch.equal(mb.hop_src_deg[h], deg[src].int())
              and torch.equal(mb.hop_dst_deg[h], deg[dst].int()),
              f"sampler: hop {h} degrees differ from the CSR's")
        frontier = torch.cat([frontier, src])


def phase_sampler(ds, gnn, dev: torch.device, batches: int = 20,
                  b: int = 1024) -> dict:
    """The device sampler at the slice's size: the full CSR on the card,
    ``batches`` batches of ``b`` targets timed beside the host sampler on
    the same targets (each device batch to a synchronize, its targets'
    upload included, as the trainer's t_sa), every batch checked."""
    from repro_torch.graph import NumpySampler, sample_minibatch_torch
    g = ds.graph
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(dev)
    indptr = torch.from_numpy(np.ascontiguousarray(g.indptr, np.int64)).to(
        dev)
    indices = torch.from_numpy(g.indices).to(dev)
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated(dev)
    keys = edge_keys(indptr, indices)
    gen = torch.Generator(device=dev).manual_seed(2)
    host = NumpySampler(g, gnn.fanouts, seed=1)
    rng = np.random.default_rng(11)
    dev_ms, host_ms = [], []
    for i in range(batches + 2):          # the first two warm up
        tgt = rng.integers(0, ds.num_nodes, b)
        labels = ds.labels[tgt]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mb = sample_minibatch_torch(gen, indptr, indices,
                                    torch.from_numpy(tgt).to(dev),
                                    torch.from_numpy(labels).to(dev),
                                    gnn.fanouts)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        host.sample(tgt, labels)
        t2 = time.perf_counter()
        if i >= 2:
            dev_ms.append((t1 - t0) * 1e3)
            host_ms.append((t2 - t1) * 1e3)
        check_device_batch(mb, indptr, indices, keys, b)
    tgt = torch.from_numpy(rng.integers(0, ds.num_nodes, b)).to(dev)
    twins = [sample_minibatch_torch(
        torch.Generator(device=dev).manual_seed(5), indptr, indices, tgt,
        tgt, gnn.fanouts) for _ in range(2)]
    check(all(torch.equal(x, y) for x, y in zip(
        twins[0].hop_src + twins[0].hop_src_deg + twins[0].hop_dst_deg,
        twins[1].hop_src + twins[1].hop_src_deg + twins[1].hop_dst_deg)),
        "sampler: one seed gave two different batches")
    res = dict(csr_bytes=g.nbytes(), memory_allocated_before=mem0,
               memory_allocated_after=mem1, batches=batches, batch=b,
               fanouts=list(gnn.fanouts), edges_per_batch=mb.edges_traversed(),
               device_ms_median=statistics.median(dev_ms),
               host_ms_median=statistics.median(host_ms),
               device_ms=dev_ms, host_ms=host_ms)
    emit("sampler", **res)
    return res


def phase_compress(ds, gnn, slice_cfg) -> dict:
    """Gradient compression: the slice's real gradients compressed on the
    card and on the host, values and scales bit-equal; then three
    iterations with compression="int8"."""
    from repro_torch.core import HybridGNNTrainer
    from repro_torch.optim import (CompressionSpec, compress_grads,
                                   decompress_grads)
    tr = HybridGNNTrainer(ds, gnn, dataclasses.replace(slice_cfg,
                                                       compression="int8"))
    grads_seen = []
    orig = tr._apply_update

    def spy(grads):
        grads_seen.append({k: v.clone() for k, v in grads.items()})
        return orig(grads)
    tr._apply_update = spy
    hist = tr.train(3)
    tr.close()
    check(all(math.isfinite(m.loss) for m in hist),
          "compress: non-finite loss")
    grads = grads_seen[-1]
    check(all(v.is_cuda for v in grads.values()), "compress: grads off card")
    host_grads = {k: v.cpu() for k, v in grads.items()}
    for method in ("int8", "bf16"):
        spec = CompressionSpec(method)
        on_card = compress_grads(grads, spec)
        on_host = compress_grads(host_grads, spec)
        for k in grads:
            # int8: (values, scale); bf16: one tensor
            parts = (zip(on_card[k], on_host[k]) if method == "int8"
                     else [(on_card[k], on_host[k])])
            for a, c in parts:
                check(same_bits(a.cpu(), c),
                      f"compress {method}: {k} differs card vs host")
        back = decompress_grads(on_card, spec, grads)
        back_host = decompress_grads(on_host, spec, host_grads)
        for k in grads:
            check(same_bits(back[k].cpu(), back_host[k]),
                  f"compress {method}: {k} decompressed differs")
    res = dict(losses=[m.loss for m in hist],
               t_sync=[m.t_sync for m in hist],
               grad_bytes=nbytes(*grads.values()),
               int8_bytes=sum(q.numel() + 4 for q, _ in compress_grads(
                   grads, CompressionSpec("int8")).values()))
    emit("compress", **res)
    return res


def phase_ckpt(ds, gnn, slice_cfg, dev: torch.device, iters: int = 6
               ) -> dict:
    """Checkpointing from the trainer's callback: every second iteration
    an async save (keep 2) and a clone of the state; the latest restores
    onto the card bit-equal to its clone."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import CheckpointManager, latest_step
    from repro_torch.core import HybridGNNTrainer
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        tr = HybridGNNTrainer(ds, gnn, dataclasses.replace(slice_cfg,
                                                           ckpt_every=2))
        mgr = CheckpointManager(tmp, keep=2, async_save=True)
        clones, save_ms = {}, []

        def clone(x):
            if isinstance(x, dict):
                return {k: clone(v) for k, v in x.items()}
            return x.clone() if isinstance(x, torch.Tensor) else x

        def cb(it, params, opt_state):
            state = {"params": params, "opt": opt_state}
            clones[it] = clone(state)
            t0 = time.perf_counter()
            mgr.save(it, state)
            save_ms.append((time.perf_counter() - t0) * 1e3)
        tr.set_checkpoint_callback(cb)
        hist = tr.train(iters)
        tr.close()
        t0 = time.perf_counter()
        mgr.finalize()
        finalize_ms = (time.perf_counter() - t0) * 1e3
        want = sorted(clones)
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp))
        check(want == [1, 3, 5] and steps == want[-2:],
              f"ckpt: callbacks at {want}, steps kept {steps}")
        check(latest_step(tmp) == want[-1], "ckpt: latest step")
        template = clone(clones[want[-1]])
        t0 = time.perf_counter()
        step, got = mgr.restore_latest(template, device=dev)
        restore_ms = (time.perf_counter() - t0) * 1e3
        check(step == want[-1], f"ckpt: restored step {step}")

        def leaves(x, prefix=""):
            if isinstance(x, dict):
                for k, v in x.items():
                    yield from leaves(v, f"{prefix}/{k}")
            else:
                yield prefix, x
        ref = dict(leaves(clones[step]))
        n = 0
        for key, v in leaves(got):
            w = ref[key]
            if isinstance(w, torch.Tensor):
                check(v.device == dev and same_bits(v, w),
                      f"ckpt: {key} differs from its clone")
            else:
                check(v == w, f"ckpt: {key} {v} != {w}")
            n += 1
        check(n == len(ref), "ckpt: leaves missing")
        with open(os.path.join(tmp, f"step_{step:08d}",
                               "manifest.json")) as fh:
            manifest = json.load(fh)
        res = dict(iters=len(hist), steps_saved=want, steps_kept=steps,
                   leaves=n, bytes=sum(i["bytes"] for i in
                                       manifest["leaves"].values()),
                   save_ms=save_ms, finalize_ms=finalize_ms,
                   restore_ms=restore_ms,
                   losses=[m.loss for m in hist])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("ckpt", **res)
    return res


def timed_refresh(cache, log: list) -> None:
    """Record the wall time of each stage() and commit() of ``cache``
    (a commit is timed to the end of its device work)."""
    stage, commit = cache.stage, cache.commit

    def timed_stage(*a, **k):
        t0 = time.perf_counter()
        n = stage(*a, **k)
        log.append(dict(call="stage", planned=n,
                        s=time.perf_counter() - t0))
        return n

    def timed_commit():
        t0 = time.perf_counter()
        n = commit()
        torch.cuda.synchronize()
        log.append(dict(call="commit", swapped=n, version=cache.version,
                        s=time.perf_counter() - t0))
        return n

    cache.stage, cache.commit = timed_stage, timed_commit


def phase_refresh(ds, sage, slice_cfg, dev: torch.device) -> dict:
    from repro_torch.core import HybridGNNTrainer
    from repro_torch.graph import build_cache
    from repro_torch.kernels import ops

    # (a) the slice with the dynamic cache refreshing at every boundary
    cfg_a = dataclasses.replace(slice_cfg, cache_refresh=True,
                                cache_drift_threshold=0.0)
    tr = HybridGNNTrainer(ds, sage, cfg_a)
    log: list = []
    timed_refresh(tr.cache, log)
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    hist = tr.train(6)
    wall_a = time.perf_counter() - t0
    launches_a = ops.kernel_launches()
    tr.close()
    check(all(math.isfinite(m.loss) for m in hist), "refresh: non-finite loss")
    check(hist[-1].cache_version > 0, "refresh: the cache version never moved")
    check(tr.cache.refresh_swapped_rows > 0, "refresh: no rows moved")
    check(launches_a["cache_update"] >= 1, f"K5 launches {launches_a}")
    res = dict(a=dict(launches=launches_a, commits=log, wall_s=wall_a,
                      versions=[m.cache_version for m in hist],
                      swapped_rows=tr.cache.refresh_swapped_rows,
                      losses=[m.loss for m in hist],
                      shares=[m.shares for m in hist],
                      iter_s=[m.iter_time for m in hist],
                      stages=[{k: getattr(m.times, k) for k in STAGES}
                              for m in hist],
                      feature_traffic=tr.feature_traffic()))

    # (b) accel-only, refresh on vs off from the same weights: the layer-0
    # input of every iteration and every loss bit-equal; (c) async refresh
    # commits and gives the same losses
    cfg_b = dataclasses.replace(slice_cfg, hybrid=False, use_drm=False,
                                cache_drift_threshold=0.0)
    runs = {}
    weights = None
    for name, kw in (("off", {}), ("on", dict(cache_refresh=True)),
                     ("async", dict(cache_refresh=True,
                                    async_refresh=True))):
        t = HybridGNNTrainer(ds, sage, dataclasses.replace(cfg_b, **kw))
        if weights is None:
            weights = {k: v.cpu().numpy() for k, v in t.params.items()}
        t.set_params(weights)
        inputs = []
        orig = t._grad

        def spy(params, batch, x0, orig=orig, inputs=inputs):
            inputs.append(x0.clone())
            return orig(params, batch, x0)
        t._grad = spy
        ops.reset_kernel_launches()
        t0 = time.perf_counter()
        h = t.train(4 if name != "async" else 6)
        wall = time.perf_counter() - t0
        t.close()
        runs[name] = dict(losses=[m.loss for m in h], inputs=inputs,
                          versions=[m.cache_version for m in h],
                          launches=ops.kernel_launches(), wall_s=wall)
    off, on, asy = runs["off"], runs["on"], runs["async"]
    check(len(on["inputs"]) == len(off["inputs"]) == 4,
          "refresh on/off: one accel input per iteration expected")
    check(all(torch.equal(x, y) for x, y in zip(on["inputs"], off["inputs"])),
          "refresh on/off: layer-0 inputs differ")
    check(on["losses"] == off["losses"], "refresh on/off: losses differ")
    check(on["versions"][-1] > 0 and off["versions"][-1] == 0,
          f"refresh on/off versions {on['versions']} {off['versions']}")
    check(asy["versions"][-1] > 0, f"async refresh never committed "
          f"{asy['versions']}")
    check(asy["losses"][:4] == off["losses"], "async refresh: losses differ")
    res["b"] = {k: dict(losses=v["losses"], versions=v["versions"],
                        launches=v["launches"], wall_s=v["wall_s"])
                for k, v in runs.items()}
    del runs

    # (d) FeatureCache commits at kernel_pipeline_depth 1 and each of
    # K6_DEPTHS on the card: K6 above 1, each device block bit-equal to
    # depth 1's
    caches = {}
    for depth in (1, *K6_DEPTHS):
        c = build_cache(ds, slice_cfg.cache_fraction)
        c.track_hotness = True
        c.kernel_pipeline_depth = depth
        rng = np.random.default_rng(5)
        for _ in range(3):
            c.lookup(rng.integers(0, ds.num_nodes, 200_000))
        c.data_on(dev)
        caches[depth] = c
    ops.reset_kernel_launches()
    moved = {d: c.refresh() for d, c in caches.items()}
    torch.cuda.synchronize()
    launches_d = ops.kernel_launches()
    check(len(set(moved.values())) == 1 and moved[1] > 0,
          f"depth commits moved {moved}")
    check(launches_d["cache_update_pipelined"] == len(K6_DEPTHS)
          and launches_d["cache_update"] == 1, f"K5/K6 launches {launches_d}")
    block1 = caches[1].data_on(dev)
    check(torch.equal(block1, caches[1].host_rows.to(dev)),
          "depth-1 device block differs from the host block")
    for d in K6_DEPTHS:
        check(torch.equal(caches[d].data_on(dev), block1),
              f"depth-{d} device block differs from depth 1")
    res["d"] = dict(moved=moved, launches=launches_d)
    emit("refresh", **res)
    return dict(cache_update=launches_a["cache_update"],
                cache_update_pipelined=launches_d["cache_update_pipelined"])


def spy_inputs(tr) -> dict:
    """Record every iteration's layer-0 inputs, per trainer, as the
    training thread receives them (iteration -> name -> tensor)."""
    inputs: dict = {}
    orig = tr._run_trainers

    def run(item):
        p = item.payload
        inputs[p["iteration"]] = {n: x.clone()
                                  for n, x in p["features"].items()}
        return orig(item)
    tr._run_trainers = run
    return inputs


def phase_shard(ds, sage, slice_cfg) -> dict:
    """The sharded plane at n_accel=4 against the replicated cache, both
    at kernel_pipeline_depth 2, from the same weights; then the sharded
    plane at the default depth 1, whose combines and peer gathers go
    through K1."""
    from repro_torch.core import HybridGNNTrainer
    from repro_torch.kernels import ops
    iters = 6
    cfg = dataclasses.replace(slice_cfg, n_accel=SHARD_ACCEL, hybrid=False,
                              use_drm=False, kernel_pipeline_depth=2,
                              shard_placement="hash")
    runs = {}
    weights = None
    for name, sharding, depth in (("replicated", "replicated", 2),
                                  ("sharded", "sharded", 2),
                                  ("sharded_depth1", "sharded", 1)):
        t0 = time.perf_counter()
        tr = HybridGNNTrainer(ds, sage, dataclasses.replace(
            cfg, cache_sharding=sharding, kernel_pipeline_depth=depth))
        build_s = time.perf_counter() - t0
        if weights is None:
            weights = {k: v.cpu().numpy() for k, v in tr.params.items()}
        tr.set_params(weights)
        inputs = spy_inputs(tr)
        peer_gathers = [0]
        if sharding == "sharded":
            orig = tr._assemble_sharded

            def assemble(block, dev, orig=orig):
                peer_gathers[0] += len(block.shard.peer_requests)
                return orig(block, dev)
            tr._assemble_sharded = assemble
        ops.reset_kernel_launches()
        t0 = time.perf_counter()
        hist = tr.train(iters)
        wall = time.perf_counter() - t0
        launches = ops.kernel_launches()
        tr.close()
        combines = sum(1 for m in hist for n in m.shares
                       if n != "cpu" and m.shares[n] > 0)
        cache = tr.cache
        runs[name] = dict(
            losses=[m.loss for m in hist], inputs=inputs, launches=launches,
            combines=combines, peer_gathers=peer_gathers[0], build_s=build_s,
            wall_s=wall, shares=[m.shares for m in hist],
            iter_s=[m.iter_time for m in hist],
            stages=[{k: getattr(m.times, k) for k in STAGES} for m in hist],
            traffic=tr.feature_traffic(),
            cache_nbytes=([s.nbytes for s in cache.shards]
                          if sharding == "sharded" else [cache.nbytes]),
            cache_rows=([s.capacity for s in cache.shards]
                        if sharding == "sharded" else [cache.capacity]))
    rep, sh, sh1 = (runs["replicated"], runs["sharded"],
                    runs["sharded_depth1"])
    check(all(math.isfinite(x) for x in sh["losses"]),
          "shard: non-finite loss")
    check(sh["losses"] == rep["losses"], "shard: losses differ from the "
          "replicated cache's")
    check(sorted(sh["inputs"]) == sorted(rep["inputs"]) == list(range(iters)),
          "shard: one input set per iteration expected")
    for it, xs in sh["inputs"].items():
        check(sorted(xs) == sorted(rep["inputs"][it]) == [
            f"accel{i}" for i in range(SHARD_ACCEL)],
            f"shard: iteration {it} trainers {sorted(xs)}")
        for name, x in xs.items():
            check(torch.equal(x, rep["inputs"][it][name]),
                  f"shard: layer-0 input of {name} at iteration {it} "
                  f"differs")
    check(sh["combines"] == rep["combines"] == SHARD_ACCEL * iters,
          f"shard: combines {sh['combines']} {rep['combines']}")
    for name, r in runs.items():
        want = r["combines"] + r["peer_gathers"]
        used, unused = (("cache_combine", "cache_combine_pipelined")
                        if name == "sharded_depth1" else
                        ("cache_combine_pipelined", "cache_combine"))
        check(r["launches"][used] == want and r["launches"][unused] == 0,
              f"shard ({name}): launches {r['launches']}, expected {want} "
              f"(combines + peer gathers) of {used} and none of {unused}")
    check(sh1["losses"] == sh["losses"] and sh1["peer_gathers"] ==
          sh["peer_gathers"] and sh1["combines"] == sh["combines"],
          "shard: depth 1 differs from depth 2 in losses or gathers")
    for it, xs in sh1["inputs"].items():
        for name, x in xs.items():
            check(torch.equal(x, sh["inputs"][it][name]),
                  f"shard: depth-1 layer-0 input of {name} at iteration "
                  f"{it} differs from depth 2's")
    check(sh["peer_gathers"] > 0 and sh["traffic"]["peer_rows"] > 0,
          "shard: no peer rows")
    ratio = rep["traffic"]["shipped_bytes"] / sh["traffic"]["shipped_bytes"]
    check(ratio > 1.0, f"shard: shipped-byte ratio {ratio}")
    res = {k: {f: v for f, v in r.items() if f != "inputs"}
           for k, r in runs.items()}
    emit("shard", shipped_ratio=ratio, peer_rows=sh["traffic"]["peer_rows"],
         ici_bytes=sh["traffic"]["ici_bytes"],
         union_saved_bytes=sh["traffic"]["union_saved_bytes"],
         shard_nbytes=sh["cache_nbytes"], **res)
    return sh["launches"]


def phase_depth(ds, sage, slice_cfg) -> dict:
    """The slice (hybrid, DRM) at kernel_pipeline_depth 2 against depth 1
    from the same weights: the same shares and losses bit for bit."""
    from repro_torch.core import HybridGNNTrainer
    from repro_torch.kernels import ops
    runs = {}
    weights = None
    for depth in (1, 2):
        t = HybridGNNTrainer(ds, sage, dataclasses.replace(
            slice_cfg, kernel_pipeline_depth=depth))
        if weights is None:
            weights = {k: v.cpu().numpy() for k, v in t.params.items()}
        t.set_params(weights)
        ops.reset_kernel_launches()
        hist = t.train(3)
        launches = ops.kernel_launches()
        t.close()
        runs[depth] = dict(losses=[m.loss for m in hist],
                           shares=[m.shares for m in hist],
                           launches=launches,
                           accel_iters=sum(1 for m in hist
                                           if m.shares.get("accel0", 0)))
    one, two = runs[1], runs[2]
    check(two["shares"] == one["shares"], "depth: shares differ")
    check(two["losses"] == one["losses"], "depth: losses differ at depth 2")
    check(two["accel_iters"] > 0 and
          two["launches"]["cache_combine_pipelined"] == two["accel_iters"]
          and two["launches"]["cache_combine"] == 0,
          f"depth: launches {two['launches']}")
    emit("depth", **{f"depth{d}": r for d, r in runs.items()})
    return two["launches"]


def mount_of(path: str) -> dict:
    """The filesystem ``path`` lives on (the longest mount point in
    /proc/mounts that holds it) and its free bytes."""
    real = os.path.realpath(path)
    best = dict(device="?", mount="", fstype="?")
    with open("/proc/mounts") as fh:
        for ln in fh:
            dev, mnt, fstype = ln.split()[:3]
            mnt = mnt.replace("\\040", " ")
            inside = real == mnt or real.startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) >= len(best["mount"]):
                best = dict(device=dev, mount=mnt, fstype=fstype)
    st = os.statvfs(real)
    return dict(best, free_bytes=st.f_bavail * st.f_frsize)


def disk_dataset(ds, spill_dir: str):
    """``ds`` with its features read from the spill through a fresh mmap
    view: no window open, no counter moved."""
    from repro_torch.graph import MmapFeatures
    return dataclasses.replace(ds, features=MmapFeatures(spill_dir))


def run_trainer(ds, gnn, cfg, iters: int, weights=None, pin=None) -> dict:
    """Build a trainer, give it ``weights`` (the built trainer's own when
    None) and, when ``pin`` returns shares for it, those initial shares;
    train ``iters`` iterations with the launch counts reset just before,
    and keep what the outofcore phase reports.  Every run must launch K1
    and K2 on each accelerator iteration."""
    from repro_torch.core import HybridGNNTrainer
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    tr = HybridGNNTrainer(ds, gnn, cfg)
    build_s = time.perf_counter() - t0
    if weights is None:
        weights = {k: v.cpu().numpy() for k, v in tr.params.items()}
    tr.set_params(weights)
    a = tr.runtime.assignment
    model = (a.cpu_batch, a.accel_batch)
    shares = pin(tr) if pin is not None else None
    if shares is not None:
        a.cpu_batch, a.accel_batch = shares
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    hist = tr.train(iters)
    wall = time.perf_counter() - t0
    launches = ops.kernel_launches()
    tr.close()
    accel = sum(1 for m in hist if m.shares.get("accel0", 0) > 0)
    check(all(math.isfinite(m.loss) for m in hist),
          "outofcore: non-finite loss")
    check(accel > 0 and launches["cache_combine"] >= accel and
          launches["fused_update"] >= 2 * accel,
          f"outofcore: K1/K2 launches {launches} for {accel} accelerator "
          "iterations")
    return dict(weights=weights, losses=[m.loss for m in hist],
                build_s=build_s, wall_s=wall, launches=launches,
                model_shares=model, trained_shares=shares or model,
                feature_tier=tr.feature_tier,
                prefetch_overlap=tr.prefetch_overlap,
                expected_hit_rate=tr.cache.expected_hit_rate,
                dedup_alpha=tr.measured_dedup_alpha,
                storage_io=tr.storage_io(), health=tr.health(),
                history=[dict(it=m.iteration, loss=m.loss, shares=m.shares,
                              t_load=m.times.t_load,
                              t_load_stall=m.times.t_load_stall,
                              t_tran=m.times.t_tran, iter_s=m.iter_time,
                              device_sampled=m.device_sampled)
                         for m in hist])


def phase_outofcore(ds, sage, slice_cfg, spill_dir: str) -> dict:
    """The out-of-core storage tier at the slice's full width: the feature
    matrix spilled to 65,536-row blobs and read back through mmap windows,
    gathered bit-equal to the dense rows, and trained over: dense against
    disk, prefetch off / on / bounded from cold pages, and the default
    configuration (device sampler, DRM) with the prefetcher.  The spill
    stays for the faults and autotune phases; ``main`` removes it."""
    from repro_torch.core.perfmodel import PLATFORMS, initial_task_mapping
    from repro_torch.graph import MmapFeatures, NumpySampler
    n, f = ds.features.shape
    need = n * f * ds.features.dtype.itemsize
    os.makedirs(spill_dir, exist_ok=False)
    fs = mount_of(spill_dir)
    on_tmpfs = fs["fstype"] == "tmpfs"
    emit("outofcore_fs", spill_dir=spill_dir, matrix_bytes=need, **fs)
    check(fs["free_bytes"] >= 2 * need,
          f"outofcore: {fs['free_bytes']} B free under {spill_dir} "
          f"({fs['fstype']}), {2 * need} B needed")
    res: dict = dict(fs=fs, numpy=np.__version__, note=(
        "the spill is on tmpfs: its 'disk' is RAM, so the cold and stall "
        "readings are page-mapping and copy time, not disk reads"
        if on_tmpfs else f"the spill is on {fs['fstype']}"))
    # 1. the spill: one 65,536-row partition buffered at a time
    t0 = time.perf_counter()
    sp = MmapFeatures.spill(ds.features, spill_dir,
                            partition_rows=SPILL_ROWS)
    res["spill_s"] = time.perf_counter() - t0
    sizes = [os.path.getsize(b) for b in
             glob.glob(os.path.join(spill_dir, "part-*.bin"))]
    res.update(spill_peak_buffered_rows=sp.spill_peak_buffered_rows,
               blobs=len(sizes), blob_max_bytes=max(sizes),
               bytes_on_disk=sum(sizes),
               spill_gb_per_s=sum(sizes) / res["spill_s"] / 1e9)
    sp.close()
    check(res["spill_peak_buffered_rows"] <= SPILL_ROWS,
          f"outofcore: spill buffered {res['spill_peak_buffered_rows']}")
    check(res["bytes_on_disk"] == need
          and res["blobs"] == -(-n // SPILL_ROWS)
          and res["blob_max_bytes"] <= SPILL_ROWS * f * 4,
          f"outofcore: spill layout {res['blobs']} blobs, "
          f"{res['bytes_on_disk']} B")
    # 2. gathers: the unique frontiers of 8 host-sampled batches,
    # bit-equal to the dense rows; then one cold gather (a fresh view
    # after drop_page_cache) and the same gather warm
    mm = MmapFeatures(spill_dir)
    sampler = NumpySampler(ds.graph, sage.fanouts, seed=7)
    rng = np.random.default_rng(8)
    fronts = []
    for _ in range(8):
        tgt = rng.integers(0, n, slice_cfg.total_batch)
        mb = sampler.sample(tgt, ds.labels[tgt])
        fronts.append(np.unique(mb.frontier(len(sage.fanouts))))
        check(np.array_equal(mm.take(fronts[-1]),
                             ds.features[fronts[-1]]),
              "outofcore: mmap rows differ from the dense rows")
    res["madvise_calls"] = mm.madvise_calls
    check(mm.madvise_calls > 0, "outofcore: no madvise hint landed "
          f"(numpy {np.__version__}: an np.memmap without _mmap?)")
    mm.close()
    cold = MmapFeatures(spill_dir)
    cold.drop_page_cache()
    gather = dict(fadvise_failures=cold.fadvise_failures)
    for kind in ("cold", "warm"):
        before = cold.cold_fault_page_bytes
        t0 = time.perf_counter()
        rows = cold.take(fronts[0])
        dt = time.perf_counter() - t0
        gather[kind] = dict(
            rows=int(fronts[0].size), ms=dt * 1e3,
            gb_per_s=rows.nbytes / dt / 1e9,
            cold_fault_page_bytes=cold.cold_fault_page_bytes - before)
    cold.close()
    # the same rows from the dense matrix in RAM: the gather without the
    # tier's windows and bookkeeping
    t0 = time.perf_counter()
    rows = np.take(ds.features, fronts[0], axis=0)
    dt = time.perf_counter() - t0
    gather["dense_ram"] = dict(rows=int(fronts[0].size), ms=dt * 1e3,
                               gb_per_s=rows.nbytes / dt / 1e9)
    res["gather"] = gather
    # 3. dense against disk, bit for bit (accelerator only, host
    # sampler): the reference's acceptance check at full width
    base = dataclasses.replace(slice_cfg, use_accel_sampler=False)
    acc = dataclasses.replace(base, hybrid=False, use_drm=False,
                              tfp_depth=2)
    runs = {"dense": run_trainer(ds, sage, acc, 4)}
    weights = runs["dense"]["weights"]
    runs["disk"] = run_trainer(disk_dataset(ds, spill_dir), sage, acc, 4,
                               weights)
    check(runs["disk"]["losses"] == runs["dense"]["losses"],
          "outofcore: disk losses differ from dense")
    check((runs["dense"]["feature_tier"], runs["disk"]["feature_tier"])
          == ("ram", "disk"), "outofcore: feature tiers")

    # 4. prefetch off / on / bounded from cold pages, hybrid, no DRM
    def model_shares(tr, overlap):
        m = initial_task_mapping(
            PLATFORMS[tr.cfg.host_platform],
            PLATFORMS[tr.cfg.accel_platform], tr.cfg.n_accel,
            tr.cfg.total_batch, sage.fanouts, sage.layer_dims,
            model=sage.model, cache_hit_rate=tr.cache.expected_hit_rate,
            dedup_factor=tr.measured_dedup_alpha, feature_tier="disk",
            prefetch_overlap=overlap)
        return (m["cpu"], m["accel_each"])
    model = {}

    def pin(tr):
        # the perf model prices prefetch off at overlap 0 and on at 1,
        # two mappings; all three runs train from the overlap-1 shares
        # so that they train the same rows
        model[tr.cfg.prefetch_windows] = (
            model_shares(tr, tr.prefetch_overlap), model_shares(tr, 1.0))
        return model_shares(tr, 1.0)
    hyb = dataclasses.replace(base, hybrid=True, use_drm=False,
                              cache_drift_threshold=1.0)
    for name, knobs in (
            ("off", {}),
            ("prefetch", dict(prefetch_windows=4,
                              prefetch_dedup_history=2)),
            ("bounded", dict(prefetch_windows=4,
                             prefetch_dedup_history=2,
                             mmap_lru_windows=LRU_WINDOWS))):
        data = disk_dataset(ds, spill_dir)
        data.features.drop_page_cache()
        r = run_trainer(data, sage, dataclasses.replace(hyb, **knobs),
                        10, weights, pin)
        data.features.close()
        own, _ = model[knobs.get("prefetch_windows", 0)]
        check(r["model_shares"] == own,
              f"outofcore ({name}): initial shares {r['model_shares']} "
              f"against the perf model's {own} for the disk tier")
        check(r["health"]["status"] == "ok",
              f"outofcore ({name}): health {r['health']}")
        runs[name] = r
    check(runs["off"]["losses"] == runs["prefetch"]["losses"]
          == runs["bounded"]["losses"],
          "outofcore: losses differ with prefetch off / on / bounded")
    check(runs["bounded"]["storage_io"]["evicted_window_bytes"] > 0,
          "outofcore: the window bound evicted nothing")
    # 5. the default configuration (device sampler, DRM) over disk
    data = disk_dataset(ds, spill_dir)
    r = run_trainer(data, sage, dataclasses.replace(
        slice_cfg, prefetch_windows=4), 6, weights)
    data.features.close()
    check(any(h["device_sampled"] for h in r["history"]),
          "outofcore (default): no batch was sampled on the card")
    check(r["storage_io"]["prefetch_submitted"] > 0,
          "outofcore (default): nothing submitted to the prefetcher")
    runs["default"] = r
    res["runs"] = {k: {f: v for f, v in r.items() if f != "weights"}
                   for k, r in runs.items()}
    emit("outofcore", **res)
    return res


# the reference's transient storage schedule (tests/test_faults.py)
TRANSIENT_SCHEDULE = {"seed": 0, "schedule": [
    {"op": "storage.take", "kind": "transient", "start": 0, "count": 1},
    {"op": "storage.take", "kind": "transient", "start": 7, "count": 2},
    {"op": "storage.prefetch", "kind": "transient", "start": 1,
     "count": 1}]}
WATCHDOG_DELAY = 4.0         # the wedge of faults (e): past the 1 s watchdog


def fault_run(ds, gnn, cfg, iters: int, weights=None, injector=None,
              failure=None) -> dict:
    """One trainer run of the faults phase: ``weights`` (the trainer's own
    when None), an optional ``FaultInjector`` and ``inject_failure``
    arguments; the launch counts are reset before training and read at the
    end of every iteration (the checkpoint callback, ``ckpt_every=1``).
    The caller closes ``tr``."""
    from repro_torch.core import HybridGNNTrainer
    from repro_torch.kernels import ops
    tr = HybridGNNTrainer(ds, gnn, dataclasses.replace(cfg, ckpt_every=1),
                          fault_injector=injector)
    if weights is None:
        weights = {k: v.cpu().numpy() for k, v in tr.params.items()}
    tr.set_params(weights)
    if failure is not None:
        tr.inject_failure(*failure)
    per_iter: list = []
    tr.set_checkpoint_callback(
        lambda it, p, o: per_iter.append(ops.kernel_launches()))
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    hist = tr.train(iters)
    wall = time.perf_counter() - t0
    launches = ops.kernel_launches()
    accel = sum(1 for m in hist for n in m.shares if n != "cpu")
    return dict(tr=tr, weights=weights, hist=hist, wall_s=wall,
                losses=[m.loss for m in hist], launches=launches,
                per_iter=[dict(c) for c in per_iter], accel_batches=accel)


def check_k1_k2(run: dict, what: str) -> None:
    """K1 once and K2 twice for every accelerator batch of the run."""
    k, n = run["launches"], run["accel_batches"]
    check(n > 0 and k["cache_combine"] == n and k["fused_update"] == 2 * n,
          f"{what}: launches {k} for {n} accelerator batches")


def join_pipeline_threads(timeout: float) -> int:
    """Wait for the stage and feeder threads a stalled pipeline left behind
    (a wedged stage cannot be interrupted; it finishes its item, then
    drains).  Returns how many were still running."""
    import threading
    left = [t for t in threading.enumerate()
            if t.name.endswith(("(_worker)", "(feed)"))]
    for t in left:
        t.join(timeout)
    return len(left)


def phase_faults(ds, sage, slice_cfg, spill_dir: str) -> dict:
    """The failure model at the slice's full width: (a) the reference's
    transient storage schedule against a clean twin, (b) the prefetch
    worker killed past its restart budget, (c) a refresh that always fails
    against refresh off, (d) a trainer killed mid-run over the dense
    features, (e) a wedged load stage against the watchdog, last."""
    from repro_torch.core import HybridGNNTrainer, PipelineStallError
    from repro_torch.graph import FaultInjector, FaultSpec
    base = dataclasses.replace(slice_cfg, use_accel_sampler=False,
                               use_drm=False, n_accel=2, hybrid=False,
                               tfp_depth=2)
    res: dict = {}

    def disk(cfg, iters, weights, injector=None, failure=None):
        data = disk_dataset(ds, spill_dir)
        r = fault_run(data, sage, cfg, iters, weights, injector, failure)
        r["tr"].close()
        data.features.close()
        return r

    # (a) transient storage faults: retried, invisible to the losses
    a_cfg = dataclasses.replace(base, prefetch_windows=4)
    clean = disk(a_cfg, 6, None)
    weights = clean["weights"]
    inj = FaultInjector.from_json(TRANSIENT_SCHEDULE)
    faulty = disk(a_cfg, 6, weights, inj)
    io = faulty["tr"].storage_io()
    check(faulty["losses"] == clean["losses"],
          "faults (a): losses differ from the clean twin")
    check(io["io_retries"] >= 3 and io["io_errors"] >= 3
          and inj.report()["faults_raised"] >= 3,
          f"faults (a): retries {io['io_retries']}, errors "
          f"{io['io_errors']}, injector {inj.report()}")
    for r in (clean, faulty):
        check_k1_k2(r, "faults (a)")
    res["transient"] = dict(
        losses=faulty["losses"], injector=inj.report(),
        io_retries=io["io_retries"], io_errors=io["io_errors"],
        io_retry_seconds=io["io_retry_seconds"],
        wall_s=faulty["wall_s"], clean_wall_s=clean["wall_s"],
        launches=faulty["launches"])

    # (b) the prefetch worker dies from its third item on, past a budget
    # of one restart: synchronous loads, the overlap re-priced to 0
    inj = FaultInjector([FaultSpec(op="prefetch.worker", kind="kill",
                                   start=2, count=1 << 30)])
    data = disk_dataset(ds, spill_dir)
    r = fault_run(data, sage, dataclasses.replace(
        a_cfg, prefetch_restart_budget=1), 8, weights, inj)
    tr = r["tr"]
    h = tr.health()
    overlap = tr._measured_prefetch_overlap()
    tr.close()
    data.features.close()
    ev = [e for e in h["events"] if e["component"] == "prefetcher"]
    check(len(r["losses"]) == 8
          and all(math.isfinite(x) for x in r["losses"]),
          f"faults (b): losses {r['losses']}")
    check(h["status"] == "degraded" and len(ev) == 1
          and "synchronously" in ev[0]["action"]
          and h["components"]["prefetcher"]["restarts"] == 1,
          f"faults (b): health {h}")
    check(overlap == 0.0, f"faults (b): measured overlap {overlap}")
    check_k1_k2(r, "faults (b)")
    res["prefetcher_death"] = dict(health=h, overlap=overlap,
                                   injector=inj.report(),
                                   wall_s=r["wall_s"],
                                   launches=r["launches"])

    # (c) every refresh stage fails: disabled after two, nothing committed,
    # the losses those of refresh off
    c_cfg = dataclasses.replace(base, n_accel=1)
    inj = FaultInjector([FaultSpec(op="refresh.stage", kind="permanent")])
    data = disk_dataset(ds, spill_dir)
    on = fault_run(data, sage, dataclasses.replace(
        c_cfg, cache_refresh=True, cache_drift_threshold=0.0,
        refresh_failure_budget=2), 6, weights, inj)
    tr = on["tr"]
    h, version = tr.health(), tr.cache.version
    stage_failures = tr.cache.stage_failures
    tr.close()
    data.features.close()
    off = disk(c_cfg, 6, weights)
    check(on["losses"] == off["losses"],
          "faults (c): losses differ from refresh off")
    check(not h["components"]["refresh"]["enabled"] and version == 0
          and stage_failures == 2 and on["launches"]["cache_update"] == 0,
          f"faults (c): health {h}, version {version}, stage failures "
          f"{stage_failures}, launches {on['launches']}")
    for r in (on, off):
        check_k1_k2(r, "faults (c)")
    res["refresh_failure"] = dict(health=h, cache_version=version,
                                  stage_failures=stage_failures,
                                  injector=inj.report(),
                                  launches=on["launches"])

    # (d) accel0 dies at iteration 3 (dense features, both accelerators on
    # cuda:0, sequential stages so each iteration's launches are its own)
    d_cfg = dataclasses.replace(base, hybrid=True, tfp_depth=0)
    r = fault_run(ds, sage, d_cfg, 8, weights, failure=("accel0", 3))
    tr = r["tr"]
    h = tr.health()
    a = tr.runtime.assignment
    tr.close()
    hist = r["hist"]
    cpu_b, accel_b = hist[-1].assignment
    k1 = [c["cache_combine"] for c in r["per_iter"]]
    k2 = [c["fused_update"] for c in r["per_iter"]]
    k1 = [y - x for x, y in zip([0] + k1, k1)]
    k2 = [y - x for x, y in zip([0] + k2, k2)]
    check(h["components"].get("trainers") == {"failed": ["accel0"]},
          f"faults (d): health {h}")
    check(accel_b > 0 and cpu_b + accel_b * a.n_accel == 1024
          and a.n_accel == 1,
          f"faults (d): last assignment {hist[-1].assignment}, n_accel "
          f"{a.n_accel}")
    check(all(math.isfinite(x) for x in r["losses"]),
          f"faults (d): losses {r['losses']}")
    check(hist[0].shares.get("accel0", 0) > 0
          and k1 == [2, 2, 2, 2, 1, 1, 1, 1]
          and k2 == [4, 4, 4, 2, 2, 2, 2, 2],
          f"faults (d): K1 per iteration {k1}, K2 {k2}, shares "
          f"{[m.shares for m in hist]}")
    res["trainer_failure"] = dict(
        losses=r["losses"], shares=[m.shares for m in hist],
        assignments=[m.assignment for m in hist], k1_per_iter=k1,
        k2_per_iter=k2, t_tc_ms=[m.times.t_tc * 1e3 for m in hist],
        t_ta_ms=[m.times.t_ta * 1e3 for m in hist], health=h,
        wall_s=r["wall_s"])

    # (e) the load stage wedged at its third call: a diagnosis within the
    # 1 s watchdog, not a hang; the stranded thread is waited out before
    # the next phase times anything
    inj = FaultInjector([FaultSpec(op="pipeline.load", kind="delay",
                                   start=2, count=1,
                                   delay=WATCHDOG_DELAY)])
    data = disk_dataset(ds, spill_dir)
    tr = HybridGNNTrainer(data, sage, dataclasses.replace(
        c_cfg, pipeline_watchdog_seconds=1.0), fault_injector=inj)
    tr.set_params(weights)
    err = None
    t0 = time.perf_counter()
    try:
        tr.train(8)
    except PipelineStallError as e:
        err = e
    diagnosis_s = time.perf_counter() - t0
    stranded = join_pipeline_threads(WATCHDOG_DELAY + 30.0)
    tr.close()
    data.features.close()
    check(err is not None and err.stage == "load"
          and err.watchdog_seconds == 1.0 and diagnosis_s < 10.0,
          f"faults (e): {err!r} after {diagnosis_s:.2f} s")
    res["watchdog"] = dict(stage=err.stage, diagnosis_s=diagnosis_s,
                           stalled_s=err.stalled_seconds,
                           queue_depths=err.queue_depths,
                           completed=err.completed,
                           iterations_done=len(tr.history),
                           stranded_threads_joined=stranded)
    emit("faults", **res)
    return res


AUTOTUNE_ITERS = 36
HAND_KNOBS = dict(prefetch_windows=4, mmap_lru_windows=8,
                  initial_threads=(2, 2, 2))
BAD_KNOBS = dict(prefetch_windows=0, mmap_lru_windows=1,
                 initial_threads=(4, 1, 1))


def steady_s(times: list) -> float:
    """The reference bench's steady iteration time: the mean of the last
    third, its worst iteration dropped."""
    tail = sorted(times[-max(len(times) // 3, 3):])
    return float(np.mean(tail[:-1] or tail))


def phase_autotune(ds, sage, slice_cfg, spill_dir: str) -> dict:
    """``benchmarks/bench_autotune.py``'s three knob sets on the slice over
    the spill (one accelerator, accelerator only, host sampler, no DRM):
    hand-tuned, misconfigured, and misconfigured with the autotuner (and
    the dynamic cache refresh) on.  Checks: bad-auto's losses bit-equal
    to bad-static's, every knob state inside its bounds, K1/K2 on every
    iteration.  Reads the tuner's moves and the host time of a deciding
    boundary."""
    from repro_torch.core import HybridGNNTrainer
    from repro_torch.kernels import ops
    base = dataclasses.replace(slice_cfg, use_accel_sampler=False,
                               use_drm=False, n_accel=1, hybrid=False,
                               tfp_depth=2)
    runs: dict = {}
    weights = None
    for label, knobs, auto in (("hand", HAND_KNOBS, False),
                               ("bad_static", BAD_KNOBS, False),
                               ("bad_auto", BAD_KNOBS, True)):
        extra = (dict(auto_tune=True, autotune_interval=3,
                      cache_refresh=True) if auto else {})
        data = disk_dataset(ds, spill_dir)
        tr = HybridGNNTrainer(data, sage,
                              dataclasses.replace(base, **knobs, **extra))
        if weights is None:
            weights = {k: v.cpu().numpy() for k, v in tr.params.items()}
        tr.set_params(weights)
        boundaries: list = []
        trail: list = []
        if auto:
            step = tr._maybe_autotune

            def timed(times, tr=tr, step=step):
                seen = tr.autotuner._windows_seen
                t0 = time.perf_counter()
                step(times)
                dt = time.perf_counter() - t0
                trail.append(tr._knobs)
                if tr.autotuner._windows_seen != seen:
                    boundaries.append(dict(iteration=len(tr.history),
                                           ms=dt * 1e3,
                                           log=list(tr.autotuner.log)))
            tr._maybe_autotune = timed
        ops.reset_kernel_launches()
        t0 = time.perf_counter()
        hist = tr.train(AUTOTUNE_ITERS)
        wall = time.perf_counter() - t0
        launches = ops.kernel_launches()
        rep = tr.autotune_report()
        io = tr.storage_io()
        bounds = tr.autotuner.bounds if auto else None
        tr.close()
        data.features.close()
        times = [m.iter_time for m in hist]
        check(launches["cache_combine"] == AUTOTUNE_ITERS
              and launches["fused_update"] == 2 * AUTOTUNE_ITERS,
              f"autotune ({label}): launches {launches}")
        check(all(math.isfinite(m.loss) for m in hist),
              f"autotune ({label}): non-finite loss")
        r = dict(steady_ms=steady_s(times) * 1e3, wall_s=wall,
                 iter_ms=[t * 1e3 for t in times],
                 t_load_ms=[m.times.t_load * 1e3 for m in hist],
                 t_load_stall_ms=[m.times.t_load_stall * 1e3 for m in hist],
                 losses=[m.loss for m in hist], launches=launches,
                 load_stall_s=io["load_stall_seconds"],
                 window_evictions=io["window_evictions"],
                 cache_version=hist[-1].cache_version, autotune=rep)
        if auto:
            check(all(bounds.contains(k) for k in trail),
                  f"autotune: a knob state left its bounds: {trail}")
            deciding = [b["ms"] for b in boundaries]
            r.update(boundaries=boundaries,
                     decide_ms_median=statistics.median(deciding),
                     decide_ms_max=max(deciding),
                     knob_trail=[dataclasses.asdict(k) for k in trail])
        runs[label] = r
    check(runs["bad_auto"]["losses"] == runs["bad_static"]["losses"],
          "autotune: bad-auto losses differ from bad-static")
    hand = runs["hand"]["steady_ms"]
    res = dict(iters=AUTOTUNE_ITERS, runs=runs,
               ratio_auto_vs_hand=runs["bad_auto"]["steady_ms"] / hand,
               ratio_static_vs_hand=runs["bad_static"]["steady_ms"] / hand)
    emit("autotune", **res)
    return res


def phase_cli(build_dir: Path) -> dict:
    """``python -m repro_torch.launch.train_gnn`` through its ``main`` on
    the card at a small scale, with the autotuner, a trainer failure and a
    two-spec fault schedule over the mmap tier."""
    import contextlib
    import io as _io
    from repro_torch.kernels import ops
    from repro_torch.launch import train_gnn
    work = build_dir / f"cli-{os.getpid()}"
    work.mkdir(parents=True)
    try:
        sched = work / "faults.json"
        sched.write_text(json.dumps({"seed": 0, "schedule": [
            {"op": "storage.take", "kind": "transient", "start": 0,
             "count": 1},
            {"op": "storage.prefetch", "kind": "transient", "start": 1,
             "count": 1}]}))
        argv = ["--dataset", "ogbn-products", "--scale", "0.01",
                "--iters", "12", "--batch", "1024", "--fanouts", "25,10",
                "--n-accel", "2", "--agg-impl", "pallas_fused",
                "--feature-backend", "mmap", "--spill-dir",
                str(work / "spill"), "--prefetch-windows", "2",
                "--cache-fraction", "0.2", "--cache-refresh", "--auto-tune",
                "--inject-failure", "3", "--fault-schedule", str(sched),
                "--pipeline-watchdog", "60"]
        buf = _io.StringIO()
        ops.reset_kernel_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = train_gnn.main(argv)
        wall = time.perf_counter() - t0
        launches = ops.kernel_launches()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = buf.getvalue().splitlines()
    health = [ln for ln in out if ln.startswith("health: ")]
    check(len(res["losses"]) == 12
          and all(math.isfinite(x) for x in res["losses"]),
          f"cli: losses {res['losses']}")
    check("accel0" in res["failed"]
          and any(ln.startswith("survived failures: ") and "accel0" in ln
                  for ln in out), f"cli: failures {res['failed']}")
    check(len(health) == 1, f"cli: health lines {health}")
    check(launches["cache_combine"] > 0 and launches["fused_update"] > 0,
          f"cli: launches {launches}")
    emit("cli", argv=argv, wall_s=wall, losses=res["losses"],
         assignments=res["assignments"], failed=res["failed"],
         health=health[0], faults=res["faults"],
         autotune={k: res["autotune"].get(k) for k in
                   ("trials", "accepted", "rollbacks", "knobs")},
         launches=launches)
    return res


def bf16_close(a: torch.Tensor, b: torch.Tensor, what: str) -> dict:
    """Two bf16 routes of one model: max and mean absolute difference
    within BF16_MAX / BF16_MEAN, values finite."""
    diff = (a.float() - b.float()).abs()
    res = dict(max_abs=float(diff.max()), mean_abs=float(diff.mean()),
               max_ref=float(b.float().abs().max()))
    check(a.shape == b.shape and bool(torch.isfinite(a).all()),
          f"{what}: shapes {tuple(a.shape)} {tuple(b.shape)} or non-finite")
    check(res["max_abs"] <= BF16_MAX and res["mean_abs"] <= BF16_MEAN,
          f"{what}: {res}")
    return res


def greedy(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    return logits[:, -1, :vocab].float().argmax(-1, keepdim=True).int()


def phase_serve(dev: torch.device) -> dict:
    """The LM serving path on the card: prefill with K8, the cache, greedy
    decode; the blocked route and the host as references; the serve CLI."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import (active_param_count, init_decode_cache,
                                    init_params, make_prefill_step,
                                    make_serve_step, param_count,
                                    prefill_into_cache)
    cfg = dataclasses.replace(get_arch(LM_ARCH), attn_impl="flash")
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(model)
    # the products' weights plus 2L + 1 norm vectors (1,498,482,688 for
    # llama3.2-1b, whose vocab needs no padding)
    want = active_param_count(cfg) + (2 * cfg.n_layers + 1) * cfg.d_model
    check(n_params == want, f"{cfg.name}: {n_params} params, not {want}")
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT), dtype=np.int32)).to(dev)
    step = make_serve_step(cfg)

    def run(tokens, gen: int):
        """prefill -> cache -> ``gen`` greedy steps; the prefill's K8
        launches counted from 0."""
        b, p = tokens.shape
        cache = init_decode_cache(cfg, b, p + gen, dev)
        ops.reset_kernel_launches()
        t0 = time.perf_counter()
        logits, caches = make_prefill_step(cfg)(model, {"tokens": tokens})
        prefill_into_cache(*caches["attn_kv"], cache["attn"])
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        k8 = ops.kernel_launches()["flash_attention"]
        toks, step_logits = [], []
        lg = logits
        t0 = time.perf_counter()
        for _ in range(gen):
            toks.append(greedy(lg, cfg.vocab))
            lg, cache = step(model, cache, {"tokens": toks[-1]})
            step_logits.append(lg)
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        return dict(logits=logits, kv=caches["attn_kv"], cache=cache["attn"],
                    tokens=torch.cat(toks, 1) if toks else None,
                    step_logits=step_logits, prefill_s=t_prefill,
                    decode_s=t_decode, k8=k8,
                    k8_after_decode=ops.kernel_launches()["flash_attention"])

    # (a) + (b): a warm-up, then the main path with the counts from 0
    run(prompts, 2)                       # warm-up (cuBLAS, K8's first launch)
    torch.cuda.reset_peak_memory_stats(dev)
    main_run = run(prompts, SERVE_GEN)
    peak = torch.cuda.max_memory_allocated(dev)
    check(main_run["k8"] == cfg.n_layers,
          f"K8 launched {main_run['k8']} times in a {cfg.n_layers}-layer "
          f"prefill")
    check(main_run["k8_after_decode"] == main_run["k8"],
          "decode launched K8 (it attends through the cache)")
    lg = main_run["logits"]
    check(lg.shape == (SERVE_BATCH, 1, cfg.vocab_padded)
          and bool(torch.isfinite(lg).all()), "prefill logits")
    toks = main_run["tokens"]
    check(toks.shape == (SERVE_BATCH, SERVE_GEN)
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab,
          "decoded tokens")
    check(main_run["cache"].pos.tolist() == [SERVE_PROMPT + SERVE_GEN]
          * cfg.n_layers, "cache positions after decode")
    check(all(bool(torch.isfinite(x).all()) for x in main_run["step_logits"]),
          "non-finite decode logits")
    prefill_ms = main_run["prefill_s"] * 1e3
    decode_ms = main_run["decode_s"] * 1e3 / SERVE_GEN
    res = dict(arch=cfg.name, params=n_params, init_s=init_s,
               batch=SERVE_BATCH, prompt=SERVE_PROMPT, gen=SERVE_GEN,
               prefill_ms=prefill_ms,
               prefill_tok_s=SERVE_BATCH * SERVE_PROMPT / main_run[
                   "prefill_s"],
               decode_ms_per_token=decode_ms,
               decode_tok_s=SERVE_BATCH * SERVE_GEN / main_run["decode_s"],
               peak_mem_bytes=peak, k8_launches=main_run["k8"],
               first_tokens=toks[0, :8].tolist())

    # (c) the blocked plain route on the same weights and prompts
    blocked_cfg = dataclasses.replace(cfg, attn_impl="blocked")
    ops.reset_kernel_launches()
    b_logits, b_caches = make_prefill_step(blocked_cfg)(
        model, {"tokens": prompts})
    check(ops.kernel_launches()["flash_attention"] == 0,
          "the blocked route launched K8")
    res["vs_blocked"] = dict(
        logits=bf16_close(lg, b_logits, "flash vs blocked logits"),
        k=bf16_close(main_run["kv"][0], b_caches["attn_kv"][0],
                     "flash vs blocked k"),
        v=bf16_close(main_run["kv"][1], b_caches["attn_kv"][1],
                     "flash vs blocked v"))
    del main_run, b_logits, b_caches

    # (d) card vs host from the same weights: 1 x 512 + 4 steps, the host
    # fed the card's greedy tokens
    small = prompts[:HOST_BATCH, :HOST_PROMPT].contiguous()
    card = run(small, HOST_GEN)
    check(card["k8"] == cfg.n_layers, f"host check: K8 {card['k8']}")
    cpu = torch.device("cpu")
    model.to(cpu)
    t0 = time.perf_counter()
    h_cache = init_decode_cache(cfg, HOST_BATCH, HOST_PROMPT + HOST_GEN, cpu)
    h_logits, h_kv = make_prefill_step(cfg)(model, {"tokens": small.cpu()})
    prefill_into_cache(*h_kv["attn_kv"], h_cache["attn"])
    host = dict(prefill=bf16_close(card["logits"].cpu(), h_logits,
                                   "card vs host prefill logits"), steps=[])
    for i in range(HOST_GEN):
        lg_h, h_cache = step(model, h_cache,
                             {"tokens": card["tokens"][:, i:i + 1].cpu()})
        host["steps"].append(bf16_close(card["step_logits"][i].cpu(), lg_h,
                                        f"card vs host decode step {i}"))
    host["host_s"] = time.perf_counter() - t0
    res["vs_host"] = host
    del model, card

    # (e) the serve CLI at its defaults on llama3.2-1b (stepwise prefill)
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    cli = serve.main(["--arch", LM_ARCH])
    check(cli["tokens"].shape == (4, 16), "serve CLI tokens")
    res["cli"] = dict(prefill_s=cli["prefill_s"], decode_s=cli["decode_s"],
                      wall_s=time.perf_counter() - t0,
                      launches=ops.kernel_launches())
    emit("serve", **res)
    return res


# The LM training phase (lm_train): llama3.2-1b at full width and depth.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MB, TRAIN_STEPS = 4, 4096, 4, 8
TRAIN_LR = 3e-4
TRAIN_HOST_LAYERS, TRAIN_HOST_SEQ = 2, 512
# (c) flash vs blocked, one AdamW step from the same weights and 1 x 4096
# tokens.  The CPU rehearsal (llama3.2-1b widths, 4 layers, vocab cut to
# 8,192, 1 x 512 zipf tokens) gave a loss difference of 4.3e-4, global
# gradient norms 1.4e-4 apart (relative), and 0.69 % of a leaf's bf16
# parameters changed at most; the loss and norm bounds leave 12x and 70x
# for 4x the depth and 8x the tokens (the reduced config, 128 wide, gave
# 3.5e-3 for the norms).  The changed share is a reading more than a
# bound: on the card at full size 4.3 % of a leaf changed (NVIDIA H100
# 80GB HBM3, 700 W), against the rehearsal's 0.69 %, so it is held to a
# quarter.  The bound that matters is per parameter: 2 lr (a gradient whose
# sign differs between the routes; a first AdamW step moves a weight by
# less than lr) plus two bf16 ulps of |p| + lr (the two roundings).
TRAIN_LOSS_TOL, TRAIN_GNORM_REL, TRAIN_CHANGED_FRAC = 5e-3, 1e-2, 0.25
# (d) card vs host at depth 2, 1 x 512 tokens, bf16.  The rehearsal's proxy
# (the host in bf16 against the same weights in f32) differed by 1.7e-4 in
# the loss and at most 1.45 % (relative L2, the embedding's, whose rows of
# frequent tokens sum hundreds of bf16 terms) in a gradient leaf; two bf16
# routes differ by about sqrt(2) of that: the bounds leave 8x and 3.4x.
HOST_LOSS_TOL, HOST_GRAD_REL = 2e-3, 0.05
CLI_ARCH, CLI_STEPS, CLI_RESUME_STEPS = "smollm-135m", 10, 15


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |t| (8 significant bits)."""
    a = t.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def lm_train_grad(dev: torch.device, peak_bw: float) -> dict:
    """(a) K8's gradient at the training shape: autograd through
    ``ops.flash_attention`` (K8 forward, the recompute VJP) against the
    plain forward and backward on the card, the same cotangent; forward +
    backward timed beside SDPA's (timed only; the port never calls it)."""
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops, ref
    cfg = get_arch(LM_ARCH)
    b, s, hkv, g, d = (1, TRAIN_SEQ, cfg.n_kv, cfg.n_heads // cfg.n_kv,
                       cfg.hd)
    gen = torch.Generator(device=dev).manual_seed(2)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)
    q, k, v = rand(b, s, hkv, g, d), rand(b, s, hkv, d), rand(b, s, hkv, d)
    cot = rand(b, s, hkv, g, d)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = ops.flash_attention(qg, kg, vg, cfg.q_block)
    got = torch.autograd.grad(out, (qg, kg, vg), cot)
    want = ref.flash_attention_vjp(q, k, v, cot, cfg.q_block)
    torch.cuda.synchronize()
    for name, a, w in zip("qkv", got, want):
        check(same_bits(a, w), f"K8 gradient d_{name} differs from the "
              f"plain backward's bits")
    fwd_err = close(out.detach(), ref.flash_attention(q, k, v, cfg.q_block),
                    K8_TOL[torch.bfloat16], K8_TOL[torch.bfloat16],
                    "K8 forward at the training shape")
    del out, got, want
    # SDPA's layout: [B, H, S, D], query head h*G + g on KV head h
    qt = q.view(b, s, hkv * g, d).transpose(1, 2).requires_grad_()
    kt, vt = (t.transpose(1, 2).requires_grad_() for t in (k, v))
    cot_t = cot.view(b, s, hkv * g, d).transpose(1, 2)

    def port():
        return torch.autograd.grad(ops.flash_attention(
            qg, kg, vg, cfg.q_block), (qg, kg, vg), cot)

    def library():
        return torch.autograd.grad(F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), (qt, kt, vt),
            cot_t)
    # the work: the forward's 2 products and the VJP's 5 (scores again,
    # d_v, d_p, d_q, d_k), each over the causal half of S x S; bytes: q, k,
    # v and the cotangent read, the output and d_q, d_k, d_v written
    flops = 7 * b * hkv * g * d * s * s
    byts = 2 * nbytes(q, k, v, cot) + nbytes(q)
    bound_ms = max(byts / peak_bw, flops / BF16_TFLOPS) * 1e3
    return dict(shape=[b, s, hkv, g, d], dtype="bfloat16",
                grads_bit_equal=True, forward_max_abs_err=fwd_err,
                **event_timed(port, "train_"),
                **event_timed(library, "train_library_"),
                train_bound_ms=bound_ms,
                train_bound_by=("bytes" if byts / peak_bw
                                >= flops / BF16_TFLOPS else "operations"))


def device_breakdown(step_fn) -> dict:
    """One profiled step: device ms summed by kernel kind (K8, GEMMs, the
    rest) and for the 15 costliest kernel names, and the share of the
    step's wall time the device was idle (the profiler's own overhead
    included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kinds = {"k8": 0.0, "gemm": 0.0, "other": 0.0}
    by_name: dict = {}
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        us = e.time_range.end - e.time_range.start
        spans.append((e.time_range.start, e.time_range.end))
        name = e.name.lower()
        kind = ("k8" if "flash_fwd" in name else
                "gemm" if any(t in name for t in ("gemm", "cutlass", "xmma",
                                                  "nvjet", "sm90_")) else
                "other")
        kinds[kind] += us / 1e3
        ms_n = by_name.setdefault(e.name[:90], [0.0, 0])
        ms_n[0] += us / 1e3
        ms_n[1] += 1
    busy, end = 0.0, -1.0
    for lo, hi in sorted(spans):            # the union of device intervals
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return dict(profiled_step_ms=wall * 1e3, device_ms_by_kind=kinds,
                top_kernels=[[n, ms, c] for n, (ms, c) in top],
                device_busy_ms=busy / 1e3,
                idle_share=max(0.0, 1.0 - busy / 1e3 / (wall * 1e3)))


def phase_lm_train(dev: torch.device, build_dir: Path,
                   peak_bw: float) -> dict:
    """The LM training path on the card (see the module docstring)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models import (init_params, make_train_step,
                                    value_and_grad)
    from repro_torch.models.convert import export_params, \
        load_reference_params
    from repro_torch.optim import adamw, cosine_warmup_schedule
    res: dict = {"grad": lm_train_grad(dev, peak_bw)}

    # (b) the slice: 8 steps of 4 x 4096 in 4 microbatches
    cfg = dataclasses.replace(get_arch(LM_ARCH), attn_impl="flash")
    check(cfg.remat, "llama3.2-1b trains with remat")
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = adamw(cosine_warmup_schedule(TRAIN_LR, TRAIN_STEPS // 10 + 1,
                                       TRAIN_STEPS))
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(cfg, opt, TRAIN_MB)
    pipe = TokenPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, depth=2,
                         device=dev)
    per_step = cfg.n_layers * TRAIN_MB * 2     # forward + remat recompute
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, times, k8 = [], [], []
    batches = pipe.batches(TRAIN_STEPS + 1)
    ops.reset_kernel_launches()
    t_prev = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        n0 = ops.kernel_launches()["flash_attention"]
        model, state, m = step(model, state, next(batches))
        losses.append(float(m["loss"]))          # waits for the step
        now = time.perf_counter()
        times.append((now - t_prev) * 1e3)
        t_prev = now
        k8.append(ops.kernel_launches()["flash_attention"] - n0)
    main_launches = ops.kernel_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(math.isfinite(x) for x in losses), f"lm_train losses {losses}")
    check(k8 == [per_step] * TRAIN_STEPS,
          f"K8 launches per step {k8}, derived {per_step} ({cfg.n_layers} "
          f"layers x {TRAIN_MB} microbatches x (forward + recompute))")
    check(main_launches["flash_attention"] == per_step * TRAIN_STEPS,
          f"K8 launches {main_launches}")
    med = statistics.median(times[2:])
    last = next(batches)                # one more step, traced
    breakdown = device_breakdown(lambda: step(model, state, last))
    del batches, last
    res["slice"] = dict(
        arch=cfg.name, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        microbatches=TRAIN_MB, steps=TRAIN_STEPS, losses=losses,
        ms_per_step=times, median_ms=med,
        tok_s=TRAIN_BATCH * TRAIN_SEQ / (med / 1e3), peak_mem_bytes=peak,
        k8_per_step=k8, k8_derived=per_step, launches=main_launches,
        breakdown=breakdown)
    emit("lm_train_slice", **res["slice"])
    del state, step, opt

    # (c) flash against blocked: one step each from the same weights
    batch = next(iter(TokenPipeline(cfg, 1, TRAIN_SEQ, seed=100, depth=0,
                                    device=dev).batches(1)))
    snap = {k: p.detach().clone() for k, p in model.named_parameters()}
    routes = {}
    after = None
    for route in ("flash", "blocked"):
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(snap[k])
        norms = []
        inner = adamw(TRAIN_LR)

        def spy(grads, st, params=None, inner=inner, norms=norms):
            norms.append(float(torch.sqrt(sum(
                g.float().square().sum() for g in grads.values()))))
            return inner.update(grads, st, params)
        spy_opt = inner._replace(update=spy)
        ops.reset_kernel_launches()
        model, _, m = make_train_step(
            dataclasses.replace(cfg, attn_impl=route), spy_opt, 1)(
            model, spy_opt.init(dict(model.named_parameters())), batch)
        routes[route] = dict(loss=float(m["loss"]), grad_norm=norms[0],
                             k8=ops.kernel_launches()["flash_attention"])
        if after is None:
            after = {k: p.detach().clone()
                     for k, p in model.named_parameters()}
    check(routes["flash"]["k8"] == 2 * cfg.n_layers
          and routes["blocked"]["k8"] == 0, f"(c) K8 launches {routes}")
    worst, changed = 0.0, 0.0
    for k, p in model.named_parameters():
        diff = (after[k].float() - p.detach().float()).abs()
        bound = 2 * TRAIN_LR + 2 * bf16_ulp(snap[k].float().abs()
                                            + TRAIN_LR)
        worst = max(worst, float((diff / bound).max()))
        changed = max(changed, float((diff > 0).float().mean()))
    dloss = abs(routes["flash"]["loss"] - routes["blocked"]["loss"])
    dnorm = abs(routes["flash"]["grad_norm"] - routes["blocked"][
        "grad_norm"]) / routes["blocked"]["grad_norm"]
    check(dloss <= TRAIN_LOSS_TOL, f"(c) losses differ by {dloss}")
    check(dnorm <= TRAIN_GNORM_REL, f"(c) gradient norms differ by {dnorm}")
    check(worst <= 1.0, f"(c) a parameter moved past its bound: {worst}")
    check(changed <= TRAIN_CHANGED_FRAC, f"(c) {changed} of a leaf changed")
    res["vs_blocked"] = dict(routes=routes, loss_diff=dloss,
                             grad_norm_rel_diff=dnorm,
                             param_diff_over_bound=worst,
                             max_changed_frac=changed)
    del model, snap, after, batch
    torch.cuda.empty_cache()

    # (d) card against host: depth 2, 1 x 512, the same converted weights
    small = dataclasses.replace(cfg, n_layers=TRAIN_HOST_LAYERS)
    host = init_params(small, torch.Generator().manual_seed(0), "cpu")
    card = init_params(small, torch.Generator(device=dev).manual_seed(0),
                       dev)
    load_reference_params(card, export_params(host))
    hb = next(iter(TokenPipeline(small, 1, TRAIN_HOST_SEQ, seed=3, depth=0,
                                 device="cpu").batches(1)))
    ops.reset_kernel_launches()
    c_loss, _, c_grads = value_and_grad(card, small, hb)
    check(ops.kernel_launches()["flash_attention"] == 2 * TRAIN_HOST_LAYERS,
          "(d) K8 launches")
    t0 = time.perf_counter()
    h_loss, _, h_grads = value_and_grad(host, small, hb)
    host_s = time.perf_counter() - t0
    rel = {k: float((c_grads[k].cpu().float() - g.float()).norm()
                    / g.float().norm().clamp(min=1e-30))
           for k, g in h_grads.items()}
    dl = abs(float(c_loss) - float(h_loss))
    check(dl <= HOST_LOSS_TOL, f"(d) card vs host loss {dl}")
    worst_leaf = max(rel, key=rel.get)
    check(rel[worst_leaf] <= HOST_GRAD_REL,
          f"(d) gradient {worst_leaf} differs by {rel[worst_leaf]}")
    res["vs_host"] = dict(loss_card=float(c_loss), loss_host=float(h_loss),
                          loss_diff=dl, worst_leaf=worst_leaf,
                          worst_rel_l2=rel[worst_leaf], leaves=len(rel),
                          host_s=host_s)
    del host, card, c_grads, h_grads

    # (e) the CLI, twice as subprocesses: 10 steps with checkpoints, then
    # 15 from the step-10 checkpoint
    ckpt = build_dir / f"lm-ckpt-{os.getpid()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = []
    try:
        for steps in (CLI_STEPS, CLI_RESUME_STEPS):
            argv = [sys.executable, "-m", "repro_torch.launch.train",
                    "--arch", CLI_ARCH, "--steps", str(steps), "--batch",
                    "4", "--seq", "512", "--ckpt-dir", str(ckpt),
                    "--ckpt-every", "5", "--attn-impl", "flash"]
            t0 = time.perf_counter()
            out = subprocess.run(argv, capture_output=True, text=True,
                                 env=env, cwd=str(ROOT), timeout=600)
            wall = time.perf_counter() - t0
            check(out.returncode == 0, f"train CLI failed: {out.stderr[-2000:]}")
            reading = json.loads(out.stdout.strip().splitlines()[-1])
            ckpt_bytes = sum(f.stat().st_size for f in ckpt.rglob("*")
                             if f.is_file())
            runs.append(dict(argv=argv[2:], wall_s=wall,
                             start_step=reading["start_step"],
                             losses=reading["losses"],
                             ms_per_step=reading["ms_per_step"],
                             median_ms=reading["median_ms"],
                             k8_launches=reading["k8_launches"],
                             ckpt_bytes=ckpt_bytes,
                             restored=[ln for ln in out.stdout.splitlines()
                                       if ln.startswith("restored")]))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    check(runs[0]["start_step"] == 0 and len(runs[0]["losses"]) == CLI_STEPS
          and runs[1]["start_step"] == CLI_STEPS
          and len(runs[1]["losses"]) == CLI_RESUME_STEPS - CLI_STEPS,
          f"CLI runs {[(r['start_step'], len(r['losses'])) for r in runs]}")
    check(all(math.isfinite(x) for r in runs for x in r["losses"]),
          "CLI losses")
    check(all(r["k8_launches"] > 0 for r in runs), "CLI runs without K8")
    res["cli"] = runs
    emit("lm_train", **{k: v for k, v in res.items() if k != "slice"})
    return res


# The MoE / sliding-window / stub-frontend phase (lm_moe): published widths,
# random weights from a seed, the depth cut as below.
MOE_ARCH, SCOUT_ARCH = "mixtral-8x22b", "llama4-scout-17b-a16e"
FRONTEND_ARCHS = ("musicgen-medium", "internvl2-1b")
MOE_SERVE_LAYERS, SCOUT_SERVE_LAYERS, MOE_TRAIN_LAYERS = 4, 2, 1
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_MB, MOE_TRAIN_STEPS = 2, 8192, 2, 4
MOE_LR, MOE_MOMENTUM = 1e-3, 0.9
MOE_HOST_SEQ = 512
WINDOW_SHAPE, WINDOW = (1, 8192, 8, 6, 128), 4096
FRONTEND_SEQ, FRONTEND_STEPS = 4096, 3
# The forward that prefill + decode is held against covers prompt and
# decoded tokens (4,096 + 32 = 4,128), which the 512-row q blocks (and K8)
# do not divide: it takes the blocked route in 32-row blocks.
CHECK_Q_BLOCK = 32
# (b) the window's sliced view against one whole-sequence block: the same
# products and masks, the masked keys adding exact zeros; only the f32
# sums' order differs before the one bf16 rounding of the output, so two
# bf16 ulps at |o| < 2 (the bf16 attention bound of tests/test_torch_lm.py).
WINDOW_TOL = 1.6e-2
# (d) card vs host at depth 1, 1 x 512 tokens, bf16.  A token routed apart
# (a router-logit near-tie rounding the other way on one side, or the drop
# that such a move shifts) changes its own output by O(1), its nll and its
# share of every gradient with it.  The CPU rehearsal's proxy (mixtral's
# layer at d 1,024, d_ff 2,048, 8 experts, top-2, bf16 against the same
# weights in f32, 1 x 512 zipf tokens, seeds 0-2): 12, 2 and 4 tokens
# routed apart; loss differences 8.3e-5, 2.2e-3, 1.6e-3, so about 2e-3
# whatever the count; the worst non-expert leaf (relative L2) 10.1 %,
# 5.7 %, 4.3 % (the router), experts no such token touched at most ~1 %.
# On the card (NVIDIA H100 80GB HBM3, 700 W) the loss differed by 1.2e-3
# (3 tokens apart) and 1.9e-3 (none). So the loss is held to
# MOE_HOST_LOSS_TOL (2.3x the proxy's worst) + MOE_FLIP_LOSS per token
# routed apart, the non-expert leaves to HOST_GRAD_REL + MOE_FLIP_GRAD per
# such token (1.7x, 1.2x and 2.1x the proxy's), an untouched expert's
# slices to HOST_GRAD_REL; a touched expert's slices are reported, not
# bounded.
MOE_HOST_LOSS_TOL = 5e-3
MOE_FLIP_LOSS, MOE_FLIP_GRAD = 4e-3, 0.01


@contextlib.contextmanager
def routing_log():
    """Every MoE layer call's routing, caught at ``moe._routing_indices``:
    a list of (kept experts, sorted, -1 where the assignment dropped:
    ``[B, S, K]``; kept assignments; all assignments)."""
    from repro_torch.models import moe
    real = moe._routing_indices
    log: list = []

    def spy(logits, top_k, capacity):
        out = real(logits, top_k, capacity)
        experts, keep = out[4], out[3].view_as(out[4])
        log.append((torch.where(keep, experts, -1).sort(-1).values,
                    int(keep.sum()), keep.numel()))
        return out
    moe._routing_indices = spy
    try:
        yield log
    finally:
        moe._routing_indices = real


def drop_share(log) -> float:
    return 1.0 - sum(k for _, k, _ in log) / max(sum(n for _, _, n in log), 1)


def routed_apart(a: list, b: list) -> torch.Tensor:
    """``[B, S]``: the positions whose kept expert set differs between two
    runs in any layer (lists of per-layer ``[B, S, K]`` routings)."""
    out = torch.zeros(a[0].shape[:2], dtype=torch.bool, device=a[0].device)
    for x, y in zip(a, b):
        out |= (x != y).any(-1)
    return out


def masked_bf16_close(a: torch.Tensor, b: torch.Tensor, ok: torch.Tensor,
                      what: str) -> dict:
    """``bf16_close`` over the positions ``ok`` (``[B, T]`` of ``[B, T,
    V]`` logits) whose routing agreed on both sides; all finite."""
    check(a.shape == b.shape and bool(torch.isfinite(a).all())
          and bool(torch.isfinite(b).all()), f"{what}: shapes or finite")
    diff = (a.float() - b.float()).abs()[ok]
    res = dict(max_abs=float(diff.max()) if diff.numel() else 0.0,
               mean_abs=float(diff.mean()) if diff.numel() else 0.0,
               compared=int(ok.sum()), positions=ok.numel())
    check(res["compared"] > 0 and res["max_abs"] <= BF16_MAX
          and res["mean_abs"] <= BF16_MEAN, f"{what}: {res}")
    return res


def moe_params_expected(cfg) -> int:
    """The parameter count of an MoE config from its widths."""
    d, hd = cfg.d_model, cfg.hd
    attn = d * hd * (cfg.n_heads + cfg.n_kv) * 2
    experts = 3 * cfg.moe_experts * d * cfg.d_ff + d * cfg.moe_experts
    return (cfg.n_layers * (attn + experts + 2 * d)
            + 2 * cfg.vocab_padded * d + d)


def serve_chain(model, cfg, tokens, gen: int, dev) -> dict:
    """prefill -> ``prefill_into_cache`` -> ``gen`` greedy decode steps,
    timed, with the prefill's K8 launches counted from 0 and every MoE
    layer's routing: per layer ``[B, P + gen, K]`` over the prompt and the
    decoded positions, and the prefill's drop share."""
    from repro_torch.kernels import ops
    from repro_torch.models import (init_decode_cache, make_prefill_step,
                                    make_serve_step, prefill_into_cache)
    b, p = tokens.shape
    cache = init_decode_cache(cfg, b, p + gen, dev)
    step = make_serve_step(cfg)
    ops.reset_kernel_launches()
    with routing_log() as log:
        t0 = time.perf_counter()
        logits, caches = make_prefill_step(cfg)(model, {"tokens": tokens})
        prefill_into_cache(*caches["attn_kv"], cache["attn"])
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        del caches
        k8 = ops.kernel_launches()["flash_attention"]
        toks, step_logits, lg = [], [], logits
        t0 = time.perf_counter()
        for _ in range(gen):
            toks.append(greedy(lg, cfg.vocab))
            lg, cache = step(model, cache, {"tokens": toks[-1]})
            step_logits.append(lg)
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
    n = cfg.n_layers
    routes = [torch.cat([log[i][0]] + [log[n + j * n + i][0]
                                      for j in range(gen)], 1)
              for i in range(n)] if log else []
    return dict(logits=logits, step_logits=step_logits,
                tokens=torch.cat(toks, 1) if toks else None,
                cache=cache["attn"],
                prefill_s=t_prefill, decode_s=t_decode, k8=k8,
                k8_after_decode=ops.kernel_launches()["flash_attention"],
                routes=routes, drop_share=drop_share(log[:n]))


def chain_vs_forward(model, cfg, prompts, gen: int, dev) -> dict:
    """Prefill + decode against one forward over the prompt and the decoded
    tokens, both at ``cfg``'s capacity factor (chosen so nothing drops):
    the last prompt position's and every decode step's logits, compared at
    the positions routed alike in every layer."""
    from repro_torch.models import forward
    run = serve_chain(model, cfg, prompts, gen, dev)
    check(run["drop_share"] == 0.0, f"the check's prefill dropped "
          f"{run['drop_share']}")
    seq = torch.cat([prompts, run["tokens"]], 1)
    fcfg = dataclasses.replace(cfg, attn_impl="blocked",
                               q_block=CHECK_Q_BLOCK)
    with torch.inference_mode(), routing_log() as log:
        logits, _, _ = forward(model, fcfg, {"tokens": seq})
    p = prompts.shape[1]
    logits = logits[:, p - 1:]
    chain = torch.cat([run["logits"]] + run["step_logits"], 1)
    apart = routed_apart(run["routes"], [x for x, _, _ in log])
    res = masked_bf16_close(chain[..., :cfg.vocab], logits[..., :cfg.vocab],
                            ~apart[:, p - 1:], "prefill + decode vs forward")
    res.update(capacity_factor=cfg.capacity_factor,
               forward_drop_share=drop_share(log),
               positions_routed_apart=int(apart.sum()),
               of_positions=apart.numel(),
               compared_positions_routed_apart=int(apart[:, p - 1:].sum()))
    return res


def moe_serve(model, cfg, dev, label: str) -> dict:
    """(a) / (e): 4 x 4,096 prompt tokens, a warm-up, then the timed chain
    at the config's capacity factor (1.25), then the check at E / top_k."""
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT), dtype=np.int32)).to(dev)
    serve_chain(model, cfg, prompts, 2, dev)             # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    run = serve_chain(model, cfg, prompts, SERVE_GEN, dev)
    peak = torch.cuda.max_memory_allocated(dev)
    k8_want = cfg.n_layers if cfg.attn_impl == "flash" else 0
    check(run["k8"] == k8_want, f"{label}: K8 {run['k8']} in a prefill, "
          f"{k8_want} derived")
    check(run["k8_after_decode"] == run["k8"], f"{label}: decode ran K8")
    toks = run["tokens"]
    check(toks.shape == (SERVE_BATCH, SERVE_GEN) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab, f"{label}: decoded tokens")
    check(all(bool(torch.isfinite(x).all())
              for x in [run["logits"]] + run["step_logits"]),
          f"{label}: non-finite logits")
    cache = run["cache"]
    total = SERVE_PROMPT + SERVE_GEN
    cap = min(total, cfg.window) if cfg.window else total
    check(cache.capacity == cap and cache.pos.tolist() == [total]
          * cfg.n_layers, f"{label}: cache capacity / positions")
    # the ring: the decoded positions overwrote the oldest slots
    want_slots = torch.arange(total - cap, total, dtype=torch.int32,
                              device=dev)
    check(bool((cache.slot_pos.sort(-1).values == want_slots).all()),
          f"{label}: ring slot positions")
    res = dict(layers=cfg.n_layers, batch=SERVE_BATCH, prompt=SERVE_PROMPT,
               gen=SERVE_GEN, cache_capacity=cap, ring_wrapped=cap < total,
               prefill_ms=run["prefill_s"] * 1e3,
               prefill_tok_s=SERVE_BATCH * SERVE_PROMPT / run["prefill_s"],
               decode_ms_per_token=run["decode_s"] * 1e3 / SERVE_GEN,
               decode_tok_s=SERVE_BATCH * SERVE_GEN / run["decode_s"],
               peak_mem_bytes=peak, k8_launches=run["k8"],
               capacity_factor=cfg.capacity_factor,
               drop_share=run["drop_share"],
               first_tokens=toks[0, :8].tolist())
    del run
    no_drop = dataclasses.replace(
        cfg, capacity_factor=cfg.moe_experts / cfg.moe_top_k)
    res["vs_forward"] = dict(
        chain_vs_forward(model, no_drop, prompts, SERVE_GEN, dev),
        note="capacity factor E / top_k serves only this check: at the "
             "default a 4,096-token prefill drops what a one-token decode "
             "step does not")
    torch.cuda.empty_cache()
    return res


def window_check(dev) -> dict:
    """(b) the blocked route's sliced ``window + q_block`` view at full
    width against one whole-sequence ``_block_attend`` with the window
    mask (scores [1, 8, 6, 8192, 8192] f32, 12.9 GB)."""
    from repro_torch.models import layers
    b, s, hkv, g, d = WINDOW_SHAPE
    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(b, s, hkv * g, d, generator=gen, device=dev).to(
        torch.bfloat16)
    k = torch.randn(b, s, hkv, d, generator=gen, device=dev).to(
        torch.bfloat16)
    v = torch.randn(b, s, hkv, d, generator=gen, device=dev).to(
        torch.bfloat16)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = layers.attention(q, k, v, window=WINDOW, q_block=512)
        torch.cuda.synchronize()
        sliced_s = time.perf_counter() - t0
        pos = torch.arange(s, device=dev)
        want = layers._block_attend(q.view(b, s, hkv, g, d), k, v, pos, pos,
                                    WINDOW).reshape(b, s, hkv * g, d)
    err = close(got, want, WINDOW_TOL, WINDOW_TOL, "(b) window view")
    return dict(shape=list(WINDOW_SHAPE), window=WINDOW, q_block=512,
                kv_view=WINDOW + 512, max_abs_err=err, tol=WINDOW_TOL,
                differing_share=float((got != want).float().mean()),
                sliced_ms=sliced_s * 1e3)


def moe_train(dev) -> tuple:
    """(c) mixtral at depth 1: TokenPipeline 2 x 8,192 zipf tokens in 2
    microbatches, remat, the blocked route (window 4,096), SGD with
    momentum, 4 steps; returns the readings and the model."""
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.models import init_params, make_train_step
    from repro_torch.optim import sgd
    cfg = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_TRAIN_LAYERS)
    check(cfg.remat and cfg.attn_impl == "blocked" and cfg.window > 0,
          "(c) mixtral trains with remat through the blocked window route")
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == moe_params_expected(cfg), f"(c) {n_params} params")
    opt = sgd(MOE_LR, momentum=MOE_MOMENTUM)
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(cfg, opt, MOE_TRAIN_MB)
    pipe = TokenPipeline(cfg, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, seed=0,
                         depth=2, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, auxs, times = [], [], []
    with routing_log() as log:
        t_prev = time.perf_counter()
        for batch in pipe.batches(MOE_TRAIN_STEPS):
            model, state, m = step(model, state, batch)
            losses.append(float(m["loss"]))      # waits for the step
            auxs.append(float(m["aux"]))
            now = time.perf_counter()
            times.append((now - t_prev) * 1e3)
            t_prev = now
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(math.isfinite(x) for x in losses + auxs),
          f"(c) losses {losses}, aux {auxs}")
    check(all(a > 0 for a in auxs), f"(c) aux {auxs}")
    drops = drop_share(log)
    check(0.0 <= drops < 1.0, f"(c) drop share {drops}")
    med = statistics.median(times[1:])
    del state, step, opt
    torch.cuda.empty_cache()
    return dict(layers=cfg.n_layers, params=n_params, batch=MOE_TRAIN_BATCH,
                seq=MOE_TRAIN_SEQ, microbatches=MOE_TRAIN_MB,
                steps=MOE_TRAIN_STEPS, optimizer=f"sgd(lr={MOE_LR}, "
                f"momentum={MOE_MOMENTUM})", losses=losses, aux=auxs,
                drop_share=drops, ms_per_step=times, median_ms=med,
                tok_s=MOE_TRAIN_BATCH * MOE_TRAIN_SEQ / (med / 1e3),
                peak_mem_bytes=peak), model, cfg


def moe_vs_host(model, cfg, dev) -> dict:
    """(d) the card's depth-1 mixtral against the host from the same
    weights (copied from the card), 1 x 512 tokens: the loss and every
    gradient leaf by name, the assignments routed apart counted."""
    import copy
    from repro_torch.data import TokenPipeline
    from repro_torch.models import value_and_grad
    from repro_torch.models.convert import export_named
    batch = next(iter(TokenPipeline(cfg, 1, MOE_HOST_SEQ, seed=3, depth=0,
                                    device="cpu").batches(1)))
    with routing_log() as clog:
        c_loss, c_m, c_grads = value_and_grad(model, cfg, batch)
    host = copy.deepcopy(model).to("cpu")
    t0 = time.perf_counter()
    with routing_log() as hlog:
        h_loss, h_m, h_grads = value_and_grad(host, cfg, batch)
    host_s = time.perf_counter() - t0
    n = cfg.n_layers                  # the forward's calls (then remat's)
    c_route = [x.cpu() for x, _, _ in clog[:n]]
    h_route = [x for x, _, _ in hlog[:n]]
    apart = routed_apart(c_route, h_route)[0]            # [S]
    assign_apart = int(sum((c != h).sum() for c, h in zip(c_route, h_route)))
    touched = set()
    for c, h in zip(c_route, h_route):
        for r in (c[0][apart], h[0][apart]):
            touched.update(int(e) for e in r.flatten() if e >= 0)
    dl = abs(float(c_loss) - float(h_loss))
    loss_tol = MOE_HOST_LOSS_TOL + MOE_FLIP_LOSS * int(apart.sum())
    check(dl <= loss_tol, f"(d) card vs host loss {dl} > {loss_tol}")
    card_tree = export_named(model, c_grads)
    host_tree = export_named(host, h_grads)

    def rel(a, b) -> float:
        return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
    leaves, experts = {}, {}
    for name in ("embed", "final_norm", "lm_head"):
        leaves[name] = rel(card_tree[name], host_tree[name])
    for name, a in card_tree["layers"].items():
        if name != "moe":
            leaves[f"layers/{name}"] = rel(a, host_tree["layers"][name])
    moe_c, moe_h = card_tree["layers"]["moe"], host_tree["layers"]["moe"]
    leaves["layers/moe/router"] = rel(moe_c["router"], moe_h["router"])
    for name in ("w1", "w3", "w2"):
        for e in range(cfg.moe_experts):
            experts[f"layers/moe/{name}[{e}]"] = (
                rel(moe_c[name][:, e], moe_h[name][:, e]), e in touched)
    worst = max(leaves, key=leaves.get)
    grad_tol = HOST_GRAD_REL + MOE_FLIP_GRAD * int(apart.sum())
    check(leaves[worst] <= grad_tol,
          f"(d) gradient {worst} differs by {leaves[worst]} > {grad_tol}")
    bounded = {k: v for k, (v, t) in experts.items() if not t}
    worst_e = max(bounded, key=bounded.get) if bounded else None
    check(worst_e is None or bounded[worst_e] <= HOST_GRAD_REL,
          f"(d) expert gradient {worst_e} differs by "
          f"{bounded.get(worst_e)}")
    del host, h_grads, c_grads
    return dict(seq=MOE_HOST_SEQ, loss_card=float(c_loss),
                loss_host=float(h_loss), loss_diff=dl, loss_tol=loss_tol,
                aux_card=float(c_m["aux"]), aux_host=float(h_m["aux"]),
                tokens_routed_apart=int(apart.sum()),
                assignments_routed_apart=assign_apart,
                assignments=MOE_HOST_SEQ * cfg.moe_top_k,
                experts_touched=sorted(touched),
                worst_leaf=worst, worst_rel_l2=leaves[worst],
                grad_tol=grad_tol,
                worst_untouched_expert=worst_e,
                worst_untouched_expert_rel_l2=bounded.get(worst_e),
                touched_expert_rel_l2={k: v for k, (v, t) in experts.items()
                                       if t},
                host_s=host_s)


def frontend_train(arch: str, dev) -> dict:
    """(f) a stub-frontend model at full width and depth: one ``loss_fn``
    through K8 and through the blocked route from the same weights, then
    ``FRONTEND_STEPS`` AdamW steps of ``TokenPipeline`` 1 x 4,096 through
    K8 with remat, 2 x layers launches a step."""
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models import init_params, loss_fn, make_train_step
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(get_arch(arch), attn_impl="flash")
    check(cfg.remat, f"{arch} trains with remat")
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(p.numel() for p in model.parameters())
    batches = list(TokenPipeline(cfg, 1, FRONTEND_SEQ, seed=0, depth=2,
                                 device=dev).batches(FRONTEND_STEPS))
    first = batches[0]
    routes = {}
    for impl in ("flash", "blocked"):
        ops.reset_kernel_launches()
        with torch.no_grad():
            loss, m = loss_fn(model, dataclasses.replace(cfg, attn_impl=impl),
                              first)
        routes[impl] = dict(loss=float(loss),
                            k8=ops.kernel_launches()["flash_attention"])
    check(routes["flash"]["k8"] == cfg.n_layers
          and routes["blocked"]["k8"] == 0, f"{arch} K8 {routes}")
    dloss = abs(routes["flash"]["loss"] - routes["blocked"]["loss"])
    check(dloss <= TRAIN_LOSS_TOL, f"{arch} flash vs blocked loss {dloss}")
    opt = adamw(TRAIN_LR)
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(cfg, opt, 1)
    per_step = 2 * cfg.n_layers              # forward + remat recompute
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, times, k8 = [], [], []
    ops.reset_kernel_launches()
    t_prev = time.perf_counter()
    for batch in batches:
        n0 = ops.kernel_launches()["flash_attention"]
        model, state, m = step(model, state, batch)
        losses.append(float(m["loss"]))
        now = time.perf_counter()
        times.append((now - t_prev) * 1e3)
        t_prev = now
        k8.append(ops.kernel_launches()["flash_attention"] - n0)
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(math.isfinite(x) for x in losses), f"{arch} losses {losses}")
    check(k8 == [per_step] * FRONTEND_STEPS, f"{arch} K8 per step {k8}, "
          f"{per_step} derived ({cfg.n_layers} layers x 2)")
    del model, state, step, opt
    torch.cuda.empty_cache()
    return dict(arch=arch, params=n_params, frontend=cfg.frontend,
                seq=FRONTEND_SEQ, vs_blocked=dict(routes, loss_diff=dloss),
                losses=losses, ms_per_step=times,
                tok_s=FRONTEND_SEQ / (statistics.median(times[1:]) / 1e3),
                peak_mem_bytes=peak, k8_per_step=k8, k8_derived=per_step,
                k8_launches=sum(k8))


def phase_lm_moe(dev: torch.device, peak_bw: float) -> dict:
    """MoE blocks with sliding-window attention and the stub frontends on
    the card (see the module docstring)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models import init_params, param_count
    t_phase = time.perf_counter()
    res: dict = {"part_s": {}}

    def lap(part: str) -> None:
        res["part_s"][part] = time.perf_counter() - t_phase - sum(
            res["part_s"].values())

    # (a) mixtral serving at depth 4
    cfg = dataclasses.replace(get_arch(MOE_ARCH), n_layers=MOE_SERVE_LAYERS)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    check(param_count(model) == moe_params_expected(cfg),
          f"(a) {param_count(model)} params")
    res["mixtral_serve"] = dict(arch=cfg.name, params=param_count(model),
                                **moe_serve(model, cfg, dev, "(a)"))
    del model
    torch.cuda.empty_cache()
    lap("a")

    # (b) the window at full width
    res["window"] = window_check(dev)
    torch.cuda.empty_cache()
    lap("b")

    # (c) mixtral training at depth 1, then (d) card vs host on its weights
    res["mixtral_train"], model, cfg = moe_train(dev)
    lap("c")
    res["mixtral_vs_host"] = moe_vs_host(model, cfg, dev)
    del model
    torch.cuda.empty_cache()
    lap("d")

    # (e) llama4-scout serving at depth 2 through K8, and K8 alone there
    cfg = dataclasses.replace(get_arch(SCOUT_ARCH),
                              n_layers=SCOUT_SERVE_LAYERS, attn_impl="flash")
    # timed by CUDA events: late in a full run the profiler's windows lost
    # SDPA's records three times in a row here (as lm_train (a)'s did)
    scout_k8 = k8_at(dev, peak_bw, (SERVE_BATCH, SERVE_PROMPT, cfg.n_kv,
                                    cfg.n_heads // cfg.n_kv, cfg.hd),
                     cfg.q_block, (torch.bfloat16,), event_timed)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    check(param_count(model) == moe_params_expected(cfg),
          f"(e) {param_count(model)} params")
    scout = dict(arch=cfg.name, params=param_count(model),
                 **moe_serve(model, cfg, dev, "(e)"))
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT), dtype=np.int32)).to(dev)
    runs = {}
    for impl in ("flash", "blocked"):
        runs[impl] = serve_chain(model, dataclasses.replace(
            cfg, attn_impl=impl), prompts, 0, dev)
    check(runs["flash"]["k8"] == cfg.n_layers and runs["blocked"]["k8"] == 0,
          "(e) K8 launches by route")
    apart = routed_apart(runs["flash"]["routes"], runs["blocked"]["routes"])
    scout["vs_blocked"] = dict(
        masked_bf16_close(runs["flash"]["logits"][..., :cfg.vocab],
                          runs["blocked"]["logits"][..., :cfg.vocab],
                          ~apart[:, -1:], "(e) flash vs blocked logits"),
        positions_routed_apart=int(apart.sum()), of_positions=apart.numel())
    scout["k8"] = {k: v for k, v in scout_k8.items() if k != "name"}
    res["scout_serve"] = scout
    del model, runs
    torch.cuda.empty_cache()
    lap("e")

    # (f) the stub frontends at full width and depth through K8
    res["frontends"] = [frontend_train(arch, dev) for arch in FRONTEND_ARCHS]
    lap("f")
    res["wall_s"] = time.perf_counter() - t_phase
    res["k8_launches"] = dict(
        scout_prefill=scout["k8_launches"],
        frontends=sum(f["k8_launches"] for f in res["frontends"]))
    emit("lm_moe", **res)
    return res


# The RWKV / Mamba phase (lm_ssm): rwkv6-1.6b and zamba2-7b at published
# widths, random weights from a seed; serving at full depth, training with
# zamba's depth cut.
SSM_RWKV, SSM_ZAMBA = "rwkv6-1.6b", "zamba2-7b"
SSM_STEP_PROMPT, SSM_GEN = 64, 32      # serve.generate: stepped prompt, greedy
SSM_WARMUP_PROMPT = 512
SSM_RAGGED = 4000                      # not a multiple of the 128-token chunk
SSM_TRAIN_SEQ, SSM_TRAIN_STEPS = 4096, 3
ZAMBA_TRAIN_LAYERS, ZAMBA_TRAIN_BATCH, ZAMBA_TRAIN_MB = 7, 2, 2
ZAMBA_LR, ZAMBA_MOMENTUM = 1e-3, 0.9
SSM_HOST_SEQ = 512
# Chunked against sequential WKV in f32 (TF32 off): the reference's own
# bound for the two routes (tests/test_models_consistency.py), rtol = atol.
WKV_TOL = 1e-3
# Bounds from a CPU rehearsal (scripts/ssm_rehearsal.py: the published
# depths with the width cut, rwkv6 at d 1,024, 16 heads of 64, d_ff 3,584,
# zamba2 at d 896, 8 heads of 112, d_ff 3,584, vocab 8,192; or the
# published width with the depth cut; random weights):
# * Random weights at full depth amplify rounding: each model in bf16 is
#   0.069-0.37 (mean) from the same weights in f32 (`chain`; the
#   reference's rwkv6 too, 0.46, `reference`), RWKV most at the first
#   positions.  So the bf16 serving chain (the prompt and the generated
#   tokens teacher-forced through the serve step) is held against the bf16
#   forward within SSM_NOISE_RATIO times the bf16 forward's own distance
#   from the f32 forward, max and mean, both measured in the run (the
#   rehearsal's ratios: zamba 1.02-1.08 / 1.04-1.05, rwkv 0.07-0.35 /
#   0.12-0.22).
# * In f32 the same amplification grows with depth (`depth`): rwkv6 at full
#   width, max 3.9e-5, 6.8e-5, 2.0e-4 and 3.2e-3 at 1, 2, 4 and 8 layers;
#   on the card at all 24 it read 0.88 (NVIDIA H100 80GB HBM3, 700 W).  So
#   the f32 check runs on the model's first layers (SSM_F32_DEPTH: rwkv's
#   first 4; zamba's first site, 6 Mamba layers and the shared block), and
#   the full depth's f32 reading is reported, not bounded.  The rehearsal
#   read max 2.0e-4 / 6.6e-4 and mean 7.1e-6 / 1.3e-5 for rwkv (seeds 0,
#   1) and 3.7e-5 / 3.4e-5 and 4.0e-6 for zamba's site (d 1,792, 16 heads
#   of 112): SSM_F32_CHAIN leaves 7.6x / 7.5x (rwkv) and 27x / 12x (zamba,
#   twice the width on the card).
# * zamba's bf16 prefill through K8 against the blocked route (which
#   rounds p to bf16 before p @ v), 2 x 1,024 tokens (`flash`): max
#   0.19-0.22, mean 0.038-0.041, each route 0.068-0.080 (mean) from f32:
#   ZAMBA_BF16_MAX / MEAN leave 2.7x and 2.4x.
# * Card against host in f32 at depth 1, 1 x 512 (`host`): f32 against f64
#   differed by at most 1.9e-6 in the loss and 1.1e-4 (relative L2,
#   Mamba's A_log; RWKV's u 2.5e-5) in a gradient leaf; two f32 routes
#   differ by about sqrt(2) of that, twice at 4x the width:
#   SSM_HOST_LOSS_TOL / GRAD_REL leave 18x and 3.2x.  (In bf16 RWKV's u
#   moved 20 % against f32: the check runs in f32.)
SSM_NOISE_RATIO = 2.0
SSM_F32_DEPTH = {"rwkv": 4, "zamba": 1}          # layers; zamba: sites
SSM_F32_CHAIN = {"rwkv": (5e-3, 1e-4), "zamba": (1e-3, 5e-5)}  # max, mean
ZAMBA_BF16_MAX, ZAMBA_BF16_MEAN = 0.6, 0.1
SSM_HOST_LOSS_TOL, SSM_HOST_GRAD_REL = 1e-4, 1e-3


def ssm_params_expected(cfg) -> int:
    """The parameter count of an RWKV or zamba config from its widths."""
    d, f = cfg.d_model, cfg.d_ff
    top = 2 * cfg.vocab_padded * d + d
    if cfg.kind == "rwkv":
        # 5 d x d products and c_r, c_k / c_v, the decay LoRA (2 x 64 d),
        # and 12 vectors of d (mix 5, mix_c 2, w0, u, ln_g, ln1, ln2)
        return top + cfg.n_layers * (6 * d * d + 2 * d * f + 140 * d)
    di, n = 2 * d, cfg.ssm_state
    h = di // cfg.ssm_head_dim
    conv = di + 2 * n
    mamba = (d * (2 * di + 2 * n + h) + 5 * conv + 3 * h + di + di * d
             + d)
    shared = d * cfg.hd * 2 * (cfg.n_heads + cfg.n_kv) + 2 * d + 3 * d * f
    sites, per, tail = cfg.zamba_structure()
    return top + (sites * per + tail) * mamba + shared


def teacher_forced(model, cfg, seq: torch.Tensor, dev) -> torch.Tensor:
    """``seq`` [B, T] through ``make_serve_step`` from an empty cache, one
    token a step: the logits of every step, ``[B, T, vocab_padded]``."""
    from repro_torch.models import init_decode_cache, make_serve_step
    step = make_serve_step(cfg)
    cache = init_decode_cache(cfg, seq.shape[0], seq.shape[1], dev)
    return torch.cat([step(model, cache, {"tokens": seq[:, t:t + 1]})[0]
                      for t in range(seq.shape[1])], 1)


def logit_diff(a: torch.Tensor, b: torch.Tensor, vocab: int) -> dict:
    d = (a[..., :vocab].float() - b[..., :vocab].float()).abs()
    return dict(max_abs=float(d.max()), mean_abs=float(d.mean()))


def first_layers(model, cfg, n: int):
    """A view of ``model`` (its own parameters, no copy) and its config
    with the first ``n`` layers only (zamba: the first ``n`` sites and the
    shared block, no tail)."""
    from repro_torch.models import LM
    sub = LM.__new__(LM)
    torch.nn.Module.__init__(sub)
    sub.embed, sub.final_norm = model.embed, model.final_norm
    sub.lm_head = model.lm_head
    sub.layers = torch.nn.ModuleList(list(model.layers)[:n])
    if cfg.kind == "zamba":
        sub.shared_attn = model.shared_attn
        n *= cfg.mamba_per_attn
    return sub, dataclasses.replace(cfg, n_layers=n)


def ssm_serve(model, cfg, dev, label: str) -> dict:
    """(a) / (b): a whole-sequence prefill of 4 x 4,096 tokens (after a
    4 x 512 warm-up), its K8 launches (one a zamba site with flash, none
    for RWKV) and caches; zamba's flash prefill against the blocked one;
    then ``launch/serve.generate``: a 64-token prompt stepped through the
    serve step and 32 greedy tokens; then the prompt and the generated
    tokens teacher-forced through the serve step against one ``forward``
    over them, in bf16 and, the model widened in place, in f32."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import forward, make_prefill_step
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT), dtype=np.int32)).to(dev)
    prefill = make_prefill_step(cfg)
    prefill(model, {"tokens": prompts[:, :SSM_WARMUP_PROMPT]})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    logits, caches = prefill(model, {"tokens": prompts})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    k8 = ops.kernel_launches()["flash_attention"]
    peak = torch.cuda.max_memory_allocated(dev)
    sites = cfg.zamba_structure()[0] if cfg.kind == "zamba" else 0
    k8_want = sites if cfg.attn_impl == "flash" else 0
    check(k8 == k8_want, f"{label}: K8 {k8} in a prefill, {k8_want} "
          f"derived")
    check(logits.shape == (SERVE_BATCH, 1, cfg.vocab_padded)
          and bool(torch.isfinite(logits).all()), f"{label}: prefill logits")
    if cfg.kind == "zamba":
        check(caches["attn_kv"][0].shape == (sites, SERVE_BATCH, SERVE_PROMPT,
                                             cfg.n_kv, cfg.hd),
              f"{label}: per-site K/V")
    else:
        check(caches is None, f"{label}: RWKV's prefill hands on no cache")
    del caches
    res = dict(layers=cfg.n_layers, batch=SERVE_BATCH, prompt=SERVE_PROMPT,
               prefill_ms=t_prefill * 1e3,
               prefill_tok_s=SERVE_BATCH * SERVE_PROMPT / t_prefill,
               prefill_peak_mem_bytes=peak, k8_launches=k8)
    if cfg.attn_impl == "flash":
        ops.reset_kernel_launches()
        blocked, _ = make_prefill_step(dataclasses.replace(
            cfg, attn_impl="blocked"))(model, {"tokens": prompts})
        check(ops.kernel_launches()["flash_attention"] == 0,
              f"{label}: the blocked prefill ran K8")
        vs = logit_diff(logits, blocked, cfg.vocab)
        check(vs["max_abs"] <= ZAMBA_BF16_MAX
              and vs["mean_abs"] <= ZAMBA_BF16_MEAN,
              f"{label}: flash vs blocked last logits {vs}")
        res["vs_blocked"] = dict(vs, max_tol=ZAMBA_BF16_MAX,
                                 mean_tol=ZAMBA_BF16_MEAN)
        del blocked
    del logits

    step_prompts = prompts[:, :SSM_STEP_PROMPT].cpu().numpy()
    n0 = ops.kernel_launches()["flash_attention"]
    torch.cuda.reset_peak_memory_stats(dev)
    run = serve.generate(model, cfg, step_prompts, SSM_GEN, 0.0,
                         torch.Generator(device=dev).manual_seed(0), dev)
    check(ops.kernel_launches()["flash_attention"] == n0,
          f"{label}: the serve step ran K8")
    toks = run["tokens"]
    check(toks.shape == (SERVE_BATCH, SSM_GEN) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab, f"{label}: generated tokens")
    res.update(step_prompt=SSM_STEP_PROMPT, gen=SSM_GEN,
               stepped_prompt_ms_per_token=run["prefill_s"] * 1e3
               / SSM_STEP_PROMPT,
               decode_ms_per_token=run["decode_s"] * 1e3 / SSM_GEN,
               decode_tok_s=SERVE_BATCH * SSM_GEN / run["decode_s"],
               decode_peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
               first_tokens=toks[0, :8].tolist())

    # the chain against the forward, in bf16 and then in f32
    seq = torch.cat([prompts[:, :SSM_STEP_PROMPT],
                     torch.from_numpy(toks).to(dev)], 1)
    chain16 = teacher_forced(model, cfg, seq, dev)
    with torch.inference_mode():
        whole16, _, _ = forward(model, cfg, {"tokens": seq})
    check(bool(torch.isfinite(chain16).all())
          and bool(torch.isfinite(whole16).all()), f"{label}: bf16 chain")
    greedy_agree = float((chain16[:, SSM_STEP_PROMPT - 1:-1, :cfg.vocab]
                          .argmax(-1) == seq[:, SSM_STEP_PROMPT:])
                         .float().mean())
    model.float()                      # every bf16 leaf widened exactly
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    chain32 = teacher_forced(model, cfg32, seq, dev)
    with torch.inference_mode():
        whole32, _, _ = forward(model, cfg32, {"tokens": seq})
    sub, sub_cfg = first_layers(model, cfg32, SSM_F32_DEPTH[cfg.kind])
    chain_sub = teacher_forced(sub, sub_cfg, seq, dev)
    with torch.inference_mode():
        whole_sub, _, _ = forward(sub, sub_cfg, {"tokens": seq})
    v = cfg.vocab
    bf16 = logit_diff(chain16, whole16, v)
    noise = logit_diff(whole16, whole32, v)
    f32_sub = logit_diff(chain_sub, whole_sub, v)
    check(bf16["max_abs"] <= SSM_NOISE_RATIO * noise["max_abs"]
          and bf16["mean_abs"] <= SSM_NOISE_RATIO * noise["mean_abs"],
          f"{label}: bf16 chain vs forward {bf16}, the bf16 forward "
          f"{noise} from f32")
    max_tol, mean_tol = SSM_F32_CHAIN[cfg.kind]
    check(f32_sub["max_abs"] <= max_tol and f32_sub["mean_abs"] <= mean_tol,
          f"{label}: f32 chain vs forward at {sub_cfg.n_layers} layers "
          f"{f32_sub}")
    res["vs_forward"] = dict(tokens=seq.shape[1], bf16=bf16,
                             bf16_forward_vs_f32=noise,
                             noise_ratio=SSM_NOISE_RATIO,
                             f32_full_depth=logit_diff(chain32, whole32, v),
                             f32_layers=sub_cfg.n_layers, f32=f32_sub,
                             f32_tol=[max_tol, mean_tol],
                             greedy_agree=greedy_agree)
    return res


def wkv_check(dev) -> dict:
    """(a) the chunked WKV against the sequential one at the prefill's
    shape [4, 4096, 32, 64] (decays as the model's init draws them:
    exp(-exp(w)), w around w0 = -4), each timed once after a warm-up; and
    the ragged route (4,000 tokens: the scan) timed."""
    from repro_torch.models import rwkv
    b, t, h, k = SERVE_BATCH, SERVE_PROMPT, 32, 64
    gen = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    r, kk, v = randn(b, t, h, k), randn(b, t, h, k), randn(b, t, h, k)
    w = torch.exp(-torch.exp(-4.0 + randn(b, t, h, k)))
    u = 0.1 * randn(h, k)
    s0 = torch.zeros(b, h, k, k, device=dev)

    def timed_once(fn, n: int):
        fn(n // 8)                                  # warm-up, 1/8 the length
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(n)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    with torch.inference_mode():
        (yc, sc), chunked_ms = timed_once(lambda n: rwkv._wkv_chunked(
            r[:, :n], kk[:, :n], v[:, :n], w[:, :n], u, s0), t)
        (ys, ss), scan_ms = timed_once(lambda n: rwkv._wkv_scan(
            r[:, :n], kk[:, :n], v[:, :n], w[:, :n], u, s0), t)
        _, ragged_ms = timed_once(lambda n: rwkv._wkv_chunked(
            r[:, :n], kk[:, :n], v[:, :n], w[:, :n], u, s0), SSM_RAGGED)
    err_y = close(yc, ys, WKV_TOL, WKV_TOL, "(a) chunked vs sequential y")
    err_s = close(sc, ss, WKV_TOL, WKV_TOL, "(a) chunked vs sequential s")
    return dict(shape=[b, t, h, k], tol=WKV_TOL, max_abs_err_y=err_y,
                max_abs_err_state=err_s, max_abs_y=float(ys.abs().max()),
                chunked_ms=chunked_ms, scan_ms=scan_ms,
                ragged_tokens=SSM_RAGGED, ragged_scan_ms=ragged_ms)


def ssm_train(cfg, dev, batch: int, microbatches: int, opt,
              label: str) -> dict:
    """(c) ``SSM_TRAIN_STEPS`` steps of ``TokenPipeline`` batch x 4,096
    through ``make_train_step`` with remat: finite losses, ms per step,
    tok/s, peak memory, and K8 a step against the count the remat
    structure implies (a zamba site's forward and its recompute, each
    microbatch)."""
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models import init_params, make_train_step
    check(cfg.remat, f"{label} trains with remat")
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == ssm_params_expected(cfg), f"{label}: {n_params} params")
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(cfg, opt, microbatches)
    pipe = TokenPipeline(cfg, batch, SSM_TRAIN_SEQ, seed=0, depth=2,
                         device=dev)
    sites = cfg.zamba_structure()[0] if cfg.kind == "zamba" else 0
    per_step = 2 * sites * microbatches if cfg.attn_impl == "flash" else 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, times, k8 = [], [], []
    t_prev = time.perf_counter()
    for b in pipe.batches(SSM_TRAIN_STEPS):
        n0 = ops.kernel_launches()["flash_attention"]
        model, state, m = step(model, state, b)
        losses.append(float(m["loss"]))              # waits for the step
        now = time.perf_counter()
        times.append((now - t_prev) * 1e3)
        t_prev = now
        k8.append(ops.kernel_launches()["flash_attention"] - n0)
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(math.isfinite(x) for x in losses), f"{label} losses {losses}")
    check(k8 == [per_step] * SSM_TRAIN_STEPS, f"{label}: K8 a step {k8}, "
          f"{per_step} derived")
    del model, state, step
    torch.cuda.empty_cache()
    med = statistics.median(times[1:])
    return dict(arch=cfg.name, layers=cfg.n_layers, params=n_params,
                batch=batch, seq=SSM_TRAIN_SEQ, microbatches=microbatches,
                steps=SSM_TRAIN_STEPS, losses=losses, ms_per_step=times,
                median_ms=med, tok_s=batch * SSM_TRAIN_SEQ / (med / 1e3),
                peak_mem_bytes=peak, k8_per_step=k8, k8_derived=per_step,
                k8_launches=sum(k8))


def ssm_vs_host(cfg, dev, label: str) -> dict:
    """(d) the card against the host in f32 from the same weights (drawn
    on the host, copied over), 1 x 512 tokens: the loss and every gradient
    leaf (relative L2) within SSM_HOST_LOSS_TOL / SSM_HOST_GRAD_REL."""
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models import init_params, value_and_grad
    from repro_torch.models.convert import (export_params,
                                            load_reference_params)
    host = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    load_reference_params(card, export_params(host))
    hb = next(iter(TokenPipeline(cfg, 1, SSM_HOST_SEQ, seed=3, depth=0,
                                 device="cpu").batches(1)))
    ops.reset_kernel_launches()
    c_loss, _, c_grads = value_and_grad(card, cfg, hb)
    k8 = ops.kernel_launches()["flash_attention"]
    t0 = time.perf_counter()
    h_loss, _, h_grads = value_and_grad(host, cfg, hb)
    host_s = time.perf_counter() - t0
    rel = {k: float((c_grads[k].cpu().float() - g.float()).norm()
                    / g.float().norm().clamp(min=1e-30))
           for k, g in h_grads.items()}
    dl = abs(float(c_loss) - float(h_loss))
    check(math.isfinite(float(c_loss)) and dl <= SSM_HOST_LOSS_TOL,
          f"{label} card vs host loss {dl}")
    worst = max(rel, key=rel.get)
    check(rel[worst] <= SSM_HOST_GRAD_REL,
          f"{label} gradient {worst} differs by {rel[worst]}")
    del host, card, c_grads, h_grads
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, layers=cfg.n_layers, seq=SSM_HOST_SEQ,
                dtype=cfg.dtype, loss_card=float(c_loss),
                loss_host=float(h_loss), loss_diff=dl,
                loss_tol=SSM_HOST_LOSS_TOL, worst_leaf=worst,
                worst_rel_l2=rel[worst], grad_tol=SSM_HOST_GRAD_REL,
                leaves=len(rel), k8_launches=k8, host_s=host_s)


def phase_lm_ssm(dev: torch.device, peak_bw: float) -> dict:
    """RWKV-6 and Mamba-2 blocks on the card (see the module docstring)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.optim import adamw, sgd
    t_phase = time.perf_counter()
    res: dict = {"part_s": {}}

    def lap(part: str) -> None:
        res["part_s"][part] = time.perf_counter() - t_phase - sum(
            res["part_s"].values())

    # (a) rwkv6-1.6b serving at full width and depth, and the WKV routes
    cfg = get_arch(SSM_RWKV)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == ssm_params_expected(cfg), f"(a) {n_params} params")
    res["rwkv_serve"] = dict(arch=cfg.name, params=n_params,
                             **ssm_serve(model, cfg, dev, "(a)"),
                             wkv=wkv_check(dev))
    del model
    torch.cuda.empty_cache()
    lap("a")

    # (b) zamba2-7b serving at full width and depth through K8 (D 112),
    # and K8 alone at its prefill shape
    cfg = dataclasses.replace(get_arch(SSM_ZAMBA), attn_impl="flash")
    # timed by CUDA events, as the other late K8 readings
    zamba_k8 = k8_at(dev, peak_bw, (SERVE_BATCH, SERVE_PROMPT, cfg.n_kv,
                                    cfg.n_heads // cfg.n_kv, cfg.hd),
                     cfg.q_block, (torch.float32, torch.bfloat16),
                     event_timed)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == ssm_params_expected(cfg), f"(b) {n_params} params")
    zamba = dict(arch=cfg.name, params=n_params,
                 weight_bytes=sum(nbytes(p) for p in model.parameters()),
                 **ssm_serve(model, cfg, dev, "(b)"))
    zamba["k8"] = {k: v for k, v in zamba_k8.items() if k != "name"}
    res["zamba_serve"] = zamba
    del model
    torch.cuda.empty_cache()
    lap("b")

    # (c) training: rwkv6-1.6b at full depth, zamba2-7b at depth 7
    res["rwkv_train"] = ssm_train(get_arch(SSM_RWKV), dev, 1, 1,
                                  adamw(TRAIN_LR), "(c) rwkv")
    res["zamba_train"] = ssm_train(
        dataclasses.replace(cfg, n_layers=ZAMBA_TRAIN_LAYERS), dev,
        ZAMBA_TRAIN_BATCH, ZAMBA_TRAIN_MB,
        sgd(ZAMBA_LR, momentum=ZAMBA_MOMENTUM), "(c) zamba")
    lap("c")

    # (d) card against host at full width in f32: rwkv at depth 1; zamba
    # as one site of one Mamba layer and the shared block
    res["rwkv_vs_host"] = ssm_vs_host(dataclasses.replace(
        get_arch(SSM_RWKV), n_layers=1, dtype="float32"), dev, "(d) rwkv")
    res["zamba_vs_host"] = ssm_vs_host(dataclasses.replace(
        cfg, n_layers=1, mamba_per_attn=1, dtype="float32"), dev,
        "(d) zamba")
    lap("d")
    res["wall_s"] = time.perf_counter() - t_phase
    res["k8_launches"] = dict(
        zamba_prefill=zamba["k8_launches"],
        zamba_train=res["zamba_train"]["k8_launches"])
    emit("lm_ssm", **res)
    return res


# The mesh phase: the port's mesh route on the card.
MESH_ARCH = "llama3.2-1b"
MESH_BATCH, MESH_SEQ, MESH_STEPS = 2, 4096, 2
# two ranks share the card: at full depth each rank's AdamW step peaks at
# ~32 GB (the old and new f32 moments, the updates, the new weights), and
# two of them did not fit in 80 GB; depth 4 keeps the width (K8's shapes)
# and ~20 GB a rank
MESH_LAYERS = 4
# (a) the dry-run's cells on the 16 x 16 production mesh (fake group, 256
# ranks): the reference's three test cells, the auto cell, and
# llama3.2-1b's train and prefill under the auto policy
MESH_DRYRUN_CELLS = (("smollm-135m", "train_4k", "tp2d"),
                     ("smollm-135m", "decode_32k", "serve2d"),
                     ("rwkv6-1.6b", "prefill_32k", "tp2d"),
                     ("smollm-135m", "train_4k", "auto"),
                     ("llama3.2-1b", "train_4k", "auto"),
                     ("llama3.2-1b", "prefill_32k", "auto"))
# rwkv6's prefill steps through 256 WKV chunks in 24 layers under the fake
# mode (~3 min of host time on the card's machine): it starts before the
# lm_ssm phase, on one core, and the mesh phase collects it
MESH_DRYRUN_EARLY = (("rwkv6-1.6b", "prefill_32k", "tp2d"),)
# NCCL refuses two ranks on one card, so the phase's two ranks share
# cuda:0 over gloo.  scripts/gloo_cuda_probe.py on the card (NVIDIA H100
# 80GB HBM3): gloo takes all_reduce, all_gather_into_tensor,
# reduce_scatter_tensor, all_to_all_single and broadcast on CUDA tensors in
# f32 and bf16 through torch.distributed, and DTensor's all-reduce
# (Partial -> Replicate); DTensor's redistributions through an all-gather
# or a reduce-scatter (the functional collectives) never completed.  The dp
# route needs only all-reduces, so it runs here, on a (2, 1) mesh; tp2d
# gathers and scatters activations, so it is held on the CPU under gloo by
# the tests (tests/test_torch_mesh.py), not on the card.
MESH_DP = (2, 1)
# (c) two ranks' f32 sums: a + b is the same sum in either order, so the
# hierarchical mean equals the flat one bit for bit
PSUM_TOL = 0.0


def mesh_rank(rank: int, store: str, q) -> None:
    """One of the phase's two ranks on cuda:0 (a spawned process): (b) 2
    AdamW steps of llama3.2-1b (2 x 4096 tokens, K8 under local_map) under
    dp on the ('data', 'model') mesh ``MESH_DP``, then (c) the hierarchical
    mean of the two ranks' own gradient trees.  Puts ``(rank, result)`` on
    ``q``; an exception puts its traceback."""
    import datetime
    import traceback
    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=2,
                                timeout=datetime.timedelta(seconds=120))
        res = _mesh_rank_run(rank)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException as e:
        res = {"error": "".join(traceback.format_exception(e))[-3000:]}
    q.put((rank, res))


def _mesh_rank_run(rank: int) -> dict:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.dist import (hierarchical_psum_mean, shard_batch,
                                  shard_params, use_mesh, use_policy)
    from repro_torch.kernels import ops
    from repro_torch.models import init_params, make_train_step, \
        value_and_grad
    from repro_torch.optim import adamw
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_arch(MESH_ARCH), attn_impl="flash",
                              n_layers=MESH_LAYERS)
    mesh = init_device_mesh("cuda", MESH_DP,
                            mesh_dim_names=("data", "model"))
    batches = list(TokenPipeline(cfg, MESH_BATCH, MESH_SEQ, seed=0, depth=0,
                                 device=dev).batches(MESH_STEPS))
    res: dict = {"rank": rank}
    with use_mesh(mesh), use_policy("dp"):
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
        placements = shard_params(model, mesh)
        opt = adamw(TRAIN_LR)
        state = opt.init(dict(model.named_parameters()))
        step = make_train_step(cfg, opt)
        losses, times, k8 = [], [], []
        for b in batches:
            ops.reset_kernel_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model, state, m = step(model, state, shard_batch(b, mesh))
            losses.append(float(m["loss"].full_tensor()))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            k8.append(ops.kernel_launches()["flash_attention"])
        res.update(losses=losses, ms_per_step=times, k8_per_step=k8,
                   layout_kept=all(tuple(p.placements) == placements[k]
                                   for k, p in model.named_parameters()),
                   local_param_bytes=sum(
                       p.to_local().numel() * p.element_size()
                       for p in model.parameters()),
                   peak_bytes=torch.cuda.max_memory_allocated(dev))
        # (c) each rank's own gradient tree: the loss of its batch row on
        # a plain copy of the (replicated) weights
        plain = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
        with torch.no_grad():
            for (_, p), (_, d) in zip(plain.named_parameters(),
                                      model.named_parameters()):
                p.copy_(d.to_local())
    del model, state
    torch.cuda.empty_cache()
    row = {k: v[rank:rank + 1] for k, v in batches[-1].items()}
    _, _, grads = value_and_grad(plain, cfg, row)
    del plain
    tree = {k: g.float() for k, g in grads.items()}
    del grads
    flat = {}
    for k, g in tree.items():
        t = g.clone()
        dist.all_reduce(t)
        flat[k] = t / 2
    pod = init_device_mesh("cuda", (2, 1, 1),
                           mesh_dim_names=("pod", "data", "model"))
    one = DeviceMesh("cuda", torch.tensor([[rank]]),
                     mesh_dim_names=("data", "model"), _init_backend=False)
    err = {}
    t0 = time.perf_counter()
    for name, m in (("data_model", mesh), ("pod", pod)):
        with use_mesh(m):
            got = hierarchical_psum_mean(tree)
        err[name] = max(float((got[k] - flat[k]).abs().max()) for k in tree)
        del got
    with use_mesh(one):
        identity = hierarchical_psum_mean(tree) is tree
    res["psum"] = dict(max_abs_err=err, identity_on_one=identity,
                       leaves=len(tree),
                       elements=sum(t.numel() for t in tree.values()),
                       s=time.perf_counter() - t0)
    return res


def start_dryrun(out_dir: Path, cells) -> list:
    """(a) the dry-run CLI on each cell, all subprocesses started at once
    (they need no card)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = []
    for arch, shape, policy in cells:
        out = out_dir / f"dryrun-{arch}-{shape}-{policy}.json"
        procs.append((out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--policy", policy,
             "--out", str(out), "--quiet"], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    return procs


def _finish_dryrun(procs: list) -> list:
    cells = []
    try:
        for out, p in procs:
            _, err = p.communicate(timeout=600)
            # the CLI writes its cells, failed ones with their error, then
            # exits non-zero if any failed
            check(out.exists(), f"(a) dry-run {out.name}: {err[-2000:]}")
            cells += json.loads(out.read_text())
            check(p.returncode == 0 or any(
                r["status"] == "error" for r in cells),
                f"(a) dry-run {out.name} exit {p.returncode}")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    rows = []
    for r in cells:
        check(r["status"] == "ok", f"(a) {r['arch']} {r['shape']}: "
              f"{r.get('error')}\n{r.get('traceback', '')}")
        roof = r["roofline"]
        rows.append(dict(
            arch=r["arch"], shape=r["shape"], mesh=r["mesh"],
            policy=r["policy"], attn_impl=r["attn_impl"],
            microbatches=r["microbatches"], status=r["status"],
            bytes_per_device=r["bytes_per_device"],
            argument_bytes=r["memory"]["argument_bytes"],
            peak_live_bytes=r["memory"]["peak_live_bytes"],
            fits_80gb=r["fits_80gb"], flops=r["cost"]["flops"],
            hbm_bytes=r["cost"]["bytes"], collectives=r["collectives"],
            t_compute_s=roof["t_compute_s"], t_memory_s=roof["t_memory_s"],
            t_collective_s=roof["t_collective_s"],
            bottleneck=roof["bottleneck"],
            roofline_fraction=roof["roofline_fraction"],
            t_run_s=r["t_run_s"]))
    return rows


def _two_ranks(work: Path) -> list:
    """(b) and (c): the two ranks on cuda:0; every process joined."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = str(work / "store")
    procs = [ctx.Process(target=mesh_rank, args=(r, store, q))
             for r in range(2)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in procs:
            try:
                rank, res = q.get(timeout=300)
            except queue.Empty:
                break
            out[rank] = res
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    errors = {r: out[r]["error"] for r in out if "error" in out[r]}
    check(len(out) == 2 and not errors, f"(b) ranks {sorted(out)} "
          f"answered; errors {errors}")
    return [out[0], out[1]]


def phase_mesh(dev: torch.device, work: Path, early: list) -> dict:
    """The mesh route on the card (see the module docstring); ``early``
    holds the dry-run cells started before the lm_ssm phase, ``work`` their
    directory (removed here)."""
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_cli
    from repro_torch.models import init_params, make_train_step
    from repro_torch.optim import adamw
    t_phase = time.perf_counter()
    res: dict = {"part_s": {}}

    def lap(part: str) -> None:
        res["part_s"][part] = time.perf_counter() - t_phase - sum(
            res["part_s"].values())

    try:
        dryrun = early + start_dryrun(work, [
            c for c in MESH_DRYRUN_CELLS if c not in MESH_DRYRUN_EARLY])
        # (b) the one-process run the two ranks are held against
        cfg = dataclasses.replace(get_arch(MESH_ARCH), attn_impl="flash",
                                  n_layers=MESH_LAYERS)
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
        opt = adamw(TRAIN_LR)
        state = opt.init(dict(model.named_parameters()))
        step = make_train_step(cfg, opt)
        one = []
        for b in TokenPipeline(cfg, MESH_BATCH, MESH_SEQ, seed=0, depth=0,
                               device=dev).batches(MESH_STEPS):
            model, state, m = step(model, state, b)
            one.append(float(m["loss"]))
        del model, state, step, m, b
        gc.collect()
        torch.cuda.empty_cache()
        res["one_process_losses"] = one
        res["main_allocated_bytes"] = torch.cuda.memory_allocated(dev)
        lap("one_process")
        ranks = _two_ranks(work)
        for r in ranks:
            d = max(abs(a - b) for a, b in zip(r["losses"], one))
            check(d <= TRAIN_LOSS_TOL, f"(b) rank {r['rank']} losses "
                  f"{r['losses']} vs one process {one}")
            check(r["layout_kept"], "(b) the parameters' layout changed")
            per_step = cfg.n_layers * 2        # forward + remat recompute
            check(r["k8_per_step"] == [per_step] * MESH_STEPS,
                  f"(b) K8 launches {r['k8_per_step']}")
            r["max_loss_diff"] = d
            c = r.pop("psum")
            check(all(v <= PSUM_TOL for v in c["max_abs_err"].values()),
                  f"(c) hierarchical vs flat mean {c['max_abs_err']}")
            check(c["identity_on_one"], "(c) not the identity on one rank")
            res.setdefault("psum", []).append(c)
        res["dp"] = dict(mesh=list(MESH_DP), ranks=ranks,
                         ms_note="gloo, host-staged: no speed meaning")
        lap("dp")
        # (d) one process: --model-parallel 2 without a mesh, through K8
        check("WORLD_SIZE" not in os.environ, "(d) a launcher's WORLD_SIZE")
        ops.reset_kernel_launches()
        cli = train_cli.main(["--arch", "smollm-135m", "--steps", "2",
                              "--batch", "2", "--seq", "512", "--attn-impl",
                              "flash", "--model-parallel", "2",
                              "--prefetch-depth", "0"])
        cli_k8 = ops.kernel_launches()["flash_attention"]
        check("mesh" not in cli and cli_k8 == cli["k8_launches"] > 0
              and all(math.isfinite(x) for x in cli["losses"]),
              f"(d) {cli}")
        res["one_process_cli"] = dict(losses=cli["losses"],
                                      k8_launches=cli_k8)
        lap("cli")
        res["dryrun"] = _finish_dryrun(dryrun)
        lap("dryrun_wait")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    res["wall_s"] = time.perf_counter() - t_phase
    res["k8_launches"] = dict(
        ranks=sum(sum(r["k8_per_step"]) for r in res["dp"]["ranks"]),
        one_process_cli=cli_k8)
    emit("mesh", **res)
    return res


# The multicard phase: the paths that exist only across cards.
MC_CARDS = 4                  # the phase runs on min(visible, MC_CARDS)
MC_EQUAL_ITERS = 8            # (a) bit-equality, DRM off
MC_DRM_ITERS = 30             # (a) readings, the paper's DRM on
MC_SHARD_ITERS = 6            # (b), as the shard phase
MC_REFRESH_ITERS = 4          # (b)'s refresh runs (tfp_depth 0)
# (c) the LM mesh route under torchrun: llama3.2-1b at full width and
# depth (bf16, flash, remat), a global batch of 4 x 4096 tokens, 3 AdamW
# steps through the training CLI, one microbatch a rank; the one-process
# run takes the same batch in 4 microbatches, as the lm_train phase
MC_LM_ARGS = ("--arch", LM_ARCH, "--steps", "3", "--batch", "4", "--seq",
              "4096", "--attn-impl", "flash")
MC_LM_LAYOUTS = (("dp", 1), ("tp2d", 2))      # --model-parallel
MC_RANK_TIMEOUT = 300         # seconds a launch of ranks may take
# (c) the hierarchical mean against a flat all-reduce mean of four ranks'
# f32 gradient trees: the two sum each element's four summands in other
# orders (NCCL's rings start each chunk at another rank), so they may
# differ by the rounding of a reordered sum, at most a few ulp of the
# summands' scale (recursive summation of n terms: (n - 1) u sum|x| each).
# PSUM_ULP_TOL bounds |hierarchical - flat| in ulp of mean|x| an element;
# the distance in ulp of the flat result is reported beside it (a sum
# that cancels has a result far below its summands).
PSUM_ULP_TOL = 4
MC_KERNELS = ("cache_combine", "fused_update", "cache_combine_pipelined",
              "cache_update", "cache_update_pipelined", "flash_attention")


def topology(cards: int) -> dict:
    """The links between the first ``cards`` cards: ``nvidia-smi topo
    -m``'s matrix and the entry for each pair (e.g. ``NV18``: 18 NVLinks),
    each card's NVLinks and their summed rate (``nvidia-smi nvlink
    --status``), and whether each card can reach each other's memory.  A
    query the machine refuses is recorded with its exit code, not
    raised."""
    def smi(*args):
        p = subprocess.run(["nvidia-smi", *args], capture_output=True,
                           text=True)
        return p.returncode, (p.stdout or p.stderr).strip().splitlines()

    rc, matrix = smi("topo", "-m")
    rows = [ln.split() for ln in matrix if ln.startswith("GPU")] \
        if rc == 0 else []
    links = {f"{i}-{j}": rows[i][1 + j] if len(rows) > i
             and len(rows[i]) > 1 + j else None
             for i in range(cards) for j in range(i + 1, cards)}
    nvlink = {}
    for c in range(cards):
        nvl_rc, status = smi("nvlink", "--status", "-i", str(c))
        rates = [float(ln.split(":")[1].split()[0]) for ln in status
                 if ln.strip().startswith("Link ") and "GB/s" in ln]
        nvlink[c] = dict(rc=nvl_rc, links=len(rates), gbps=sum(rates))
    peer = {f"{i}-{j}": torch.cuda.can_device_access_peer(i, j)
            for i in range(cards) for j in range(cards) if i != j}
    return dict(links=links, topo_rc=rc, matrix=matrix, nvlink=nvlink,
                peer_access=peer)


def mc_run(ds, gnn, cfg, iters: int, weights=None,
           one_card: bool = False) -> dict:
    """One training run of ``iters`` iterations: with its accelerators one
    a card (logical accelerator i on ``cuda:i % count``), or, with
    ``one_card``, all on ``cuda:0``.  Records the layer-0 inputs, losses,
    final parameters, feature traffic, stage times and the launches of
    each kernel on each card, with what each card should have launched:
    a combine for each accelerator batch on the reader's card, a peer
    gather (sharded plane) on the owner's card, and a refresh scatter on
    each card the cache block was placed on."""
    from repro_torch.core import HybridGNNTrainer
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    tr = HybridGNNTrainer(ds, gnn, cfg)
    if one_card:
        tr.accel_devices = [torch.device("cuda", 0)] * cfg.n_accel
    card = {f"accel{i}": tr._accel_device(f"accel{i}").index
            for i in range(cfg.n_accel)}
    build_s = time.perf_counter() - t0
    if weights is not None:
        tr.set_params(weights)
    init = {k: v.cpu().numpy() for k, v in tr.params.items()}
    inputs = spy_inputs(tr)
    peer_gathers: dict = {}          # owner card -> peer gathers
    if tr._sharded:
        orig = tr._assemble_sharded

        def assemble(block, dev):
            for peer, _, _ in block.shard.peer_requests:
                c = card[f"accel{peer}"]
                peer_gathers[c] = peer_gathers.get(c, 0) + 1
            return orig(block, dev)
        tr._assemble_sharded = assemble
    scatters: dict = {}              # card -> refresh scatters
    shard_cards: dict = {}           # shard -> cards it was scattered on
    blocks = (tr.cache.shards if tr._sharded
              else [tr.cache] if tr.cache is not None else [])
    for i, c in enumerate(blocks):
        def scatter(entry, rows, slots, dev, orig=c._scatter_block, i=i):
            scatters[dev.index] = scatters.get(dev.index, 0) + 1
            shard_cards.setdefault(i, set()).add(dev.index)
            return orig(entry, rows, slots, dev)
        c._scatter_block = scatter
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    hist = tr.train(iters)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.kernel_launches_by_device()
    tr.close()
    combines: dict = {}              # reader card -> combines
    for m in hist:
        for n, b in m.shares.items():
            if n != "cpu" and b > 0:
                combines[card[n]] = combines.get(card[n], 0) + 1
    res = dict(
        cards=card, build_s=build_s, wall_s=wall,
        losses=[m.loss for m in hist], shares=[m.shares for m in hist],
        iter_s=[m.iter_time for m in hist], mteps=[m.mteps for m in hist],
        stages=[{k: getattr(m.times, k) for k in STAGES} for m in hist],
        traffic=tr.feature_traffic(), combines=combines,
        peer_gathers=peer_gathers, scatters=scatters,
        shard_cards={i: sorted(s) for i, s in shard_cards.items()},
        launches={k: launches[k] for k in MC_KERNELS if launches[k]},
        cache_version=tr.cache.version if tr.cache is not None else 0,
        inputs=inputs, params=dict(tr.params), init=init)
    return res


def same_run(a: dict, b: dict, what: str) -> None:
    """``a`` and ``b`` trained alike: the same losses, and every layer-0
    input of every trainer bit for bit (wherever each lies)."""
    check(a["losses"] == b["losses"], f"{what}: losses {a['losses']} vs "
          f"{b['losses']}")
    check(sorted(a["inputs"]) == sorted(b["inputs"]),
          f"{what}: iterations differ")
    for it, xs in a["inputs"].items():
        ys = b["inputs"][it]
        check(sorted(xs) == sorted(ys), f"{what}: trainers of iteration "
              f"{it} differ")
        for n, x in xs.items():
            check(same_bits(x, ys[n].to(x.device)), f"{what}: layer-0 "
                  f"input of {n} at iteration {it} differs")


def check_card_launches(r: dict, depth: int, what: str) -> None:
    """Each card launched the combine kernel of ``depth`` (K1 at 1, K4
    above) once for each of its own batches and each peer gather it owned,
    K2 twice a batch (one a layer), and the refresh kernel (K5 at 1, K6
    above) once for each scatter of a block placed on it."""
    combine, other = (("cache_combine", "cache_combine_pipelined")
                      if depth == 1 else
                      ("cache_combine_pipelined", "cache_combine"))
    cards = set(r["combines"]) | set(r["peer_gathers"])
    want = {c: r["combines"].get(c, 0) + r["peer_gathers"].get(c, 0)
            for c in cards}
    got = r["launches"].get(combine, {})
    check(got == want, f"{what}: {combine} by card {got}, expected {want} "
          f"(combines {r['combines']} + peer gathers {r['peer_gathers']})")
    check(not r["launches"].get(other), f"{what}: {other} launched "
          f"{r['launches'].get(other)}")
    k2 = r["launches"].get("fused_update", {})
    check(k2 == {c: 2 * n for c, n in r["combines"].items()},
          f"{what}: K2 by card {k2}, combines {r['combines']}")
    update = "cache_update" if depth == 1 else "cache_update_pipelined"
    check(r["launches"].get(update, {}) == r["scatters"],
          f"{what}: {update} by card {r['launches'].get(update)}, "
          f"scatters {r['scatters']}")


def strip(r: dict) -> dict:
    """A run's readings for the phase line: the stage times, iteration
    times and MTEPS as medians, the tensors left out."""
    out = {k: v for k, v in r.items() if k not in (
        "inputs", "params", "init", "stages", "iter_s", "mteps")}
    out["median"] = {k: statistics.median(s[k] for s in r["stages"])
                     for k in STAGES}
    out["median"].update(iter_s=statistics.median(r["iter_s"]),
                         mteps=statistics.median(r["mteps"]))
    return out


def mc_gnn(ds, sage, slice_cfg, cards: int) -> dict:
    """(a) one accelerator trainer a card: the slice at n_accel=4 with the
    DRM off, one a card against all on cuda:0 (inputs, losses and final
    parameters bit-equal, each card's K1/K2 for its own batches); then
    with the DRM on for ``MC_DRM_ITERS`` iterations on one card and on
    four, readings only."""
    cfg = dataclasses.replace(slice_cfg, n_accel=MC_CARDS)
    eq_cfg = dataclasses.replace(cfg, use_drm=False)
    four = mc_run(ds, sage, eq_cfg, MC_EQUAL_ITERS)
    one = mc_run(ds, sage, eq_cfg, MC_EQUAL_ITERS, weights=four["init"],
                 one_card=True)
    check(sorted(set(four["cards"].values())) == list(range(cards)),
          f"(a) accelerators on cards {four['cards']}")
    check(set(one["cards"].values()) == {0}, f"(a) {one['cards']}")
    check(all(math.isfinite(x) for x in four["losses"]),
          f"(a) losses {four['losses']}")
    same_run(four, one, "(a) one a card vs all on cuda:0")
    for k, p in four["params"].items():
        check(same_bits(p, one["params"][k]), f"(a) final parameter {k} "
              f"differs")
    for r in (four, one):
        check(all(r["combines"].get(c, 0) == MC_EQUAL_ITERS * sum(
            1 for v in r["cards"].values() if v == c)
            for c in set(r["cards"].values())),
            f"(a) combines {r['combines']}: an accelerator without a share")
        check_card_launches(r, 1, "(a)")
    res = dict(equal=dict(four=strip(four), one=strip(one)))
    del four, one
    drm = {}
    for name, one_card in (("one", True), ("four", False)):
        r = mc_run(ds, sage, cfg, MC_DRM_ITERS, one_card=one_card)
        check(all(math.isfinite(x) for x in r["losses"]),
              f"(a) DRM {name}: losses {r['losses']}")
        check(all(sum(s.values()) == cfg.total_batch for s in r["shares"]),
              f"(a) DRM {name}: shares {r['shares']}")
        drm[name] = strip(r)
    res["drm"] = drm
    return res


def mc_shard(ds, sage, host_cfg, cards: int) -> dict:
    """(b) the sharded plane across cards: the shard phase's configuration
    at kernel_pipeline_depth 1 and 2, replicated and sharded one a card
    and sharded all on cuda:0: inputs and losses bit-equal, the sharded
    traffic equal to one card's, each peer gather on its owner's card;
    then the cache refreshing at every boundary at tfp_depth 0 (finding
    3), replicated against sharded."""
    cfg = dataclasses.replace(host_cfg, n_accel=MC_CARDS, hybrid=False,
                              use_drm=False, shard_placement="hash")
    res: dict = {}
    weights = None
    for depth in (1, 2):
        runs = {}
        for name, sharding, one_card in (("replicated", "replicated", False),
                                         ("sharded", "sharded", False),
                                         ("sharded_one_card", "sharded",
                                          True)):
            r = mc_run(ds, sage, dataclasses.replace(
                cfg, cache_sharding=sharding, kernel_pipeline_depth=depth),
                MC_SHARD_ITERS, weights=weights, one_card=one_card)
            weights = weights or r["init"]
            check_card_launches(r, depth, f"(b) depth {depth} {name}")
            runs[name] = r
        rep, sh, one = (runs["replicated"], runs["sharded"],
                        runs["sharded_one_card"])
        check(all(math.isfinite(x) for x in sh["losses"]),
              f"(b) losses {sh['losses']}")
        same_run(sh, rep, f"(b) depth {depth}: sharded vs replicated")
        same_run(sh, one, f"(b) depth {depth}: four cards vs one")
        check(sh["traffic"] == one["traffic"], f"(b) depth {depth}: "
              f"traffic {sh['traffic']} vs one card {one['traffic']}")
        check(sh["traffic"]["peer_rows"] > 0 and sum(
            sh["peer_gathers"].values()) > 0, "(b) no peer rows")
        check(len(sh["peer_gathers"]) == cards,
              f"(b) peer gathers by owner {sh['peer_gathers']}")
        res[f"depth{depth}"] = {name: strip(r) for name, r in runs.items()}
        del runs, rep, sh, one
    refresh = {}
    for depth in (1, 2):
        runs = {}
        for sharding in ("replicated", "sharded"):
            r = mc_run(ds, sage, dataclasses.replace(
                cfg, cache_sharding=sharding, kernel_pipeline_depth=depth,
                tfp_depth=0, cache_refresh=True,
                cache_drift_threshold=0.0), MC_REFRESH_ITERS,
                weights=weights)
            check_card_launches(r, depth, f"(b) refresh depth {depth} "
                                f"{sharding}")
            runs[sharding] = r
        sh = runs["sharded"]
        check(sh["losses"] == runs["replicated"]["losses"],
              f"(b) refresh depth {depth}: sharded {sh['losses']} vs "
              f"replicated {runs['replicated']['losses']}")
        check(sh["cache_version"] > 0 and sum(sh["scatters"].values()) > 0,
              f"(b) refresh depth {depth}: no commit")
        for i, cs in sh["shard_cards"].items():
            check(cs == [sh["cards"][f"accel{i}"]], f"(b) shard {i} "
                  f"scattered on cards {cs}")
        refresh[f"depth{depth}"] = {n: strip(r) for n, r in runs.items()}
        del runs, sh
    res["refresh"] = refresh
    res["link"] = peer_link(cards)
    return res


def peer_link(cards: int) -> dict:
    """The peer hop's rate: a peer gather's rows (the kernels phase's
    6,524 x 100 f32) and a 256 MiB block copied from card 1 to card 0,
    timed by CUDA events on the reader's stream (20 copies each, after
    warm-up), beside the perf model's NVLink rate."""
    from repro_torch.core.perfmodel import PLATFORMS
    src_dev, dst_dev = torch.device("cuda", 1), torch.device("cuda", 0)
    out = dict(peer_access=torch.cuda.can_device_access_peer(0, 1),
               model_gbps=PLATFORMS["h100-sxm"].ici_gbps)
    for name, rows in (("peer_gather", 6524), ("block_256mib",
                                                (256 << 20) // 400)):
        gen = torch.Generator(device=src_dev).manual_seed(rows)
        src = torch.randn(rows, 100, device=src_dev, generator=gen)
        dst = torch.empty(rows, 100, device=dst_dev)
        for _ in range(3):
            dst.copy_(src)
        torch.cuda.synchronize(src_dev)
        torch.cuda.synchronize(dst_dev)
        with torch.cuda.device(dst_dev):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                dst.copy_(src)
            end.record()
            end.synchronize()
        ms = start.elapsed_time(end) / 20
        check(torch.equal(dst.cpu(), src.cpu()), f"peer hop {name}")
        out[name] = dict(bytes=src.numel() * 4, ms=ms,
                         gbps=src.numel() * 4 / ms / 1e6)
        del src, dst
    return out


def mc_psum_rank(rank: int, n: int, store: str, q) -> None:
    """One rank of (c)'s mean check on cuda:<rank> over NCCL (a spawned
    process): its own f32 gradient tree of llama3.2-1b (row ``rank`` of
    a 4 x 4096 batch), the flat all-reduce mean, and
    ``hierarchical_psum_mean`` on a (n, 1) mesh and on a (2, n/2, 1) pod
    mesh.  Puts ``(rank, result)`` on ``q``."""
    import datetime
    import traceback
    import torch.distributed as dist
    try:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                rank=rank, world_size=n, device_id=dev,
                                timeout=datetime.timedelta(seconds=120))
        res = _mc_psum_run(rank, n, dev)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException as e:
        res = {"error": "".join(traceback.format_exception(e))[-3000:]}
    q.put((rank, res))


def _ulp(t: torch.Tensor) -> torch.Tensor:
    a = t.abs()
    return torch.nextafter(a, torch.full_like(a, math.inf)) - a


def _mc_psum_run(rank: int, n: int, dev: torch.device) -> dict:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenPipeline
    from repro_torch.dist import hierarchical_psum_mean, use_mesh
    from repro_torch.models import init_params, value_and_grad
    cfg = dataclasses.replace(get_arch(LM_ARCH), attn_impl="flash")
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    batch = next(iter(TokenPipeline(cfg, n, 4096, seed=0, depth=0,
                                    device=dev).batches(1)))
    row = {k: v[rank:rank + 1] for k, v in batch.items()}
    _, _, grads = value_and_grad(model, cfg, row)
    del model
    tree = {k: g.float() for k, g in grads.items()}
    del grads
    torch.cuda.empty_cache()
    flat, scale = {}, {}
    for k, g in tree.items():
        t = g.clone()
        dist.all_reduce(t)
        flat[k] = t / n
        t = g.abs()
        dist.all_reduce(t)
        scale[k] = _ulp(t / n)       # ulp of mean|x| an element
    meshes = [("data_model", (n, 1), ("data", "model"))]
    if n % 2 == 0 and n >= 4:
        meshes.append(("pod", (2, n // 2, 1), ("pod", "data", "model")))
    out = {}
    for name, shape, axes in meshes:
        mesh = init_device_mesh("cuda", shape, mesh_dim_names=axes)
        t0 = time.perf_counter()
        with use_mesh(mesh):
            got = hierarchical_psum_mean(tree)
        torch.cuda.synchronize(dev)
        s = time.perf_counter() - t0
        ulp_mag = ulp_res = 0.0
        differ = 0
        for k in tree:
            d = (got[k] - flat[k]).abs()
            differ += int((d > 0).sum())
            ulp_mag = max(ulp_mag, float((d / scale[k]).max()))
            ulp_res = max(ulp_res, float((d / _ulp(flat[k])).max()))
        del got
        out[name] = dict(mesh=list(shape), s=s, elements_differ=differ,
                         bit_equal=differ == 0, max_ulp_of_scale=ulp_mag,
                         max_ulp_of_result=ulp_res)
    return dict(rank=rank, leaves=len(tree),
                elements=sum(t.numel() for t in tree.values()), meshes=out)


def spawn_ranks(target, n: int, work: Path) -> list:
    """``target(rank, n, store, q)`` in ``n`` spawned processes joined
    through a FileStore under ``work``, each answer awaited for at most
    ``MC_RANK_TIMEOUT`` seconds; every process joined or killed."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    store = str(work / f"store-{target.__name__}")
    procs = [ctx.Process(target=target, args=(r, n, store, q))
             for r in range(n)]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + MC_RANK_TIMEOUT
    try:
        for _ in procs:
            try:
                rank, res = q.get(timeout=max(deadline - time.monotonic(),
                                              1))
            except queue.Empty:
                break
            out[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    errors = {r: out[r]["error"] for r in out if "error" in out[r]}
    check(len(out) == n and not errors, f"{target.__name__}: ranks "
          f"{sorted(out)} of {n} answered; errors {errors}")
    return [out[r] for r in range(n)]


def torchrun(n: int, argv, timeout: float) -> list:
    """``python -m torch.distributed.run --standalone --nproc-per-node n``
    on the training CLI (its ranks on cuda:0..n-1 over NCCL); every rank
    prints its JSON line last.  The launcher's process group is killed
    past ``timeout``."""
    import signal
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", "-m", "repro_torch.launch.train",
           *argv]
    p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, err = p.communicate()
        check(False, f"(c) {' '.join(argv)}: past {timeout} s\n{err[-3000:]}")
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()
    check(p.returncode == 0, f"(c) torchrun {' '.join(argv)}: exit "
          f"{p.returncode}\n{err[-4000:]}")
    # each rank's JSON object, wherever the shared stdout put it
    ranks = {}
    dec = json.JSONDecoder()
    i = out.find('{"arch"')
    while i >= 0:
        r, end = dec.raw_decode(out, i)
        if "rank" in r:
            ranks[r["rank"]] = r
        i = out.find('{"arch"', end)
    check(sorted(ranks) == list(range(n)), f"(c) ranks {sorted(ranks)} "
          f"printed\n{out[-2000:]}")
    return [ranks[r] for r in range(n)]


def mc_lm(cards: int, work: Path) -> dict:
    """(c) the LM mesh route over NCCL, one rank a card (see the module
    docstring)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as train_cli
    gc.collect()
    torch.cuda.empty_cache()
    check("WORLD_SIZE" not in os.environ, "(c) a launcher's WORLD_SIZE")
    one = train_cli.main([*MC_LM_ARGS, "--microbatches", "4"])
    gc.collect()
    torch.cuda.empty_cache()
    check(all(math.isfinite(x) for x in one["losses"]),
          f"(c) one process: {one['losses']}")
    res: dict = {"one_process": one}
    # one microbatch a rank: each layer's K8 forward and its remat
    # recompute
    per_step = get_arch(LM_ARCH).n_layers * 2
    for name, mp_size in MC_LM_LAYOUTS:
        if cards % mp_size or 4 % (cards // mp_size):
            res[name] = {"skipped": f"{cards} cards: the 4-row batch does "
                                    f"not split over 'data'"}
            continue
        t0 = time.perf_counter()
        ranks = torchrun(cards, [*MC_LM_ARGS, "--model-parallel",
                                 str(mp_size)], MC_RANK_TIMEOUT)
        wall = time.perf_counter() - t0
        for r in ranks:
            d = max(abs(a - b) for a, b in zip(r["losses"], one["losses"]))
            check(d <= TRAIN_LOSS_TOL, f"(c) {name} rank {r['rank']} "
                  f"losses {r['losses']} vs one process {one['losses']}")
            check(r["mesh"] == {"data": cards // mp_size, "model": mp_size},
                  f"(c) {name} mesh {r['mesh']}")
            check(r["layout_kept"], f"(c) {name}: a parameter's layout "
                  f"changed")
            check(r["k8_per_step"] == [per_step] * len(one["losses"]),
                  f"(c) {name} rank {r['rank']} K8 {r['k8_per_step']}, "
                  f"expected {per_step} a step")
            r["max_loss_diff"] = d
        res[name] = dict(model_parallel=mp_size, wall_s=wall, ranks=ranks)
    ranks = spawn_ranks(mc_psum_rank, cards, work)
    for r in ranks:
        for name, m in r["meshes"].items():
            check(m["max_ulp_of_scale"] <= PSUM_ULP_TOL,
                  f"(c) rank {r['rank']} hierarchical vs flat mean on "
                  f"{name}: {m}")
    res["psum"] = ranks
    return res


def phase_multicard(ds, sage, slice_cfg, host_cfg, cards: int,
                    work: Path) -> dict:
    """The paths that exist only across cards (see the module docstring),
    on ``cards`` cards; ``work`` (removed here) holds the ranks' stores."""
    t_phase = time.perf_counter()
    res: dict = {"cards": cards, "part_s": {}}

    def lap(part: str) -> None:
        res["part_s"][part] = time.perf_counter() - t_phase - sum(
            res["part_s"].values())

    res["topology"] = topology(cards)
    res["names"] = [f"{torch.cuda.get_device_name(i)}" for i in range(cards)]
    work.mkdir(parents=True, exist_ok=True)
    try:
        # each part's readings on a line of its own as it ends
        res["gnn"] = mc_gnn(ds, sage, slice_cfg, cards)
        lap("gnn")
        emit("multicard_gnn", **res["gnn"])
        res["shard"] = mc_shard(ds, sage, host_cfg, cards)
        lap("shard")
        emit("multicard_shard", **res["shard"])
        res["lm"] = mc_lm(cards, work)
        lap("lm")
        emit("multicard_lm", **res["lm"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # each card's launches over (a)-(c): the GNN runs' counts by card, and
    # each rank's K8 on its own card
    per_card = {c: {k: 0 for k in MC_KERNELS} for c in range(cards)}
    runs = [r for part in (res["gnn"]["equal"], res["gnn"]["drm"])
            for r in part.values()]
    for key in ("depth1", "depth2"):
        runs += list(res["shard"][key].values())
        runs += list(res["shard"]["refresh"][key].values())
    for r in runs:
        for k, by_card in r["launches"].items():
            for c, v in by_card.items():
                per_card[c][k] += v
    for name, _ in MC_LM_LAYOUTS:
        for r in res["lm"].get(name, {}).get("ranks", []):
            per_card[r["rank"]]["flash_attention"] += r["k8_launches"]
    res["per_card_launches"] = per_card
    res["wall_s"] = time.perf_counter() - t_phase
    for c, counts in per_card.items():
        emit("multicard_card", card=c, name=res["names"][c],
             links={k: v for k, v in res["topology"]["links"].items()
                    if str(c) in k.split("-")},
             nvlink=res["topology"]["nvlink"][c], launches=counts)
    emit("multicard", **{k: v for k, v in res.items()
                         if k not in ("gnn", "shard", "lm")})
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="ogbn-products scale (1.0 = 2,449,029 nodes)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None,
                    help="directory for the build log (ptxas -v output) and "
                    "every phase's JSON line (phases.jsonl)")
    ap.add_argument("--cards", type=int, default=None,
                    help="exit non-zero unless at least this many cards "
                    "are visible (the multicard phase runs on up to "
                    f"{MC_CARDS} whenever two or more are)")
    ap.add_argument("--spill-dir", default=None,
                    help="a directory to create for the outofcore phase's "
                    "feature spill (980 MB at scale 1.0; removed at the "
                    "phase's end); default: a fresh one under build/")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if args.cards is not None and torch.cuda.device_count() < args.cards:
        print(f"chip_smoke: {args.cards} cards asked for, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    # full-precision f32 everywhere a library product runs (stated, not
    # assumed): the plain versions and the backwards use cuBLAS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import PAPER_BATCH, PAPER_CONFIGS
    from repro_torch.core import HybridConfig, HybridGNNTrainer
    from repro_torch.core.perfmodel import platform_for_device_name
    from repro_torch.graph import make_dataset
    from repro_torch.kernels import build, ops

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        PHASE_LOG.append(os.path.join(args.out, "phases.jsonl"))
    env = phase_env()
    if args.out:
        with open(os.path.join(args.out, "chip_smoke_build.log"), "w") as fh:
            json.dump(build.build_report(), fh, indent=1, default=str)
    platform = platform_for_device_name(env["device"])

    t0 = time.perf_counter()
    ds = make_dataset("ogbn-products", scale=args.scale, seed=0)
    emit("dataset", scale=args.scale, nodes=ds.num_nodes,
         edges=ds.num_edges, seconds=time.perf_counter() - t0)
    sage = dataclasses.replace(PAPER_CONFIGS["sage-products"][1],
                               agg_impl="pallas_fused")
    gcn = dataclasses.replace(PAPER_CONFIGS["gcn-products"][1],
                              agg_impl="pallas")
    slice_cfg = HybridConfig(
        total_batch=PAPER_BATCH, n_accel=1, hybrid=True, use_drm=True,
        tfp_depth=2, dedup=True, cache_fraction=0.2,
        cache_sharding="replicated", feature_dtype="float32",
        kernel_pipeline_depth=1, accel_platform=platform, seed=0)
    # phases that hold two runs equal sample on the host
    host_cfg = dataclasses.replace(slice_cfg, use_accel_sampler=False)
    tr = HybridGNNTrainer(ds, sage, slice_cfg)
    b = tr.runtime.quantized_shares()[1] or 1024
    kern = phase_kernels(tr, b, platform, torch.device("cuda", 0))
    train = phase_train(tr, args.iters)
    del tr
    phase_sampler(ds, sage, torch.device("cuda", 0))
    phase_compress(ds, sage, slice_cfg)
    phase_ckpt(ds, sage, slice_cfg, torch.device("cuda", 0))

    # cross-check: card vs host from the same weights.  Sequential stages
    # (tfp_depth=0) make the hit-rate feedback see the same window at every
    # boundary in both runs, so both take the same shares.
    cc_cfg = dataclasses.replace(host_cfg, use_drm=False, tfp_depth=0)
    runs = {}
    weights = None
    for dev in ("cuda", "cpu"):
        t = HybridGNNTrainer(ds, sage, cc_cfg, device=dev)
        if weights is None:
            weights = {k: v.cpu().numpy() for k, v in t.params.items()}
        t.set_params(weights)
        hist = t.train(3)
        t.close()
        runs[dev] = dict(losses=[m.loss for m in hist],
                         shares=[m.shares for m in hist],
                         traffic=t.feature_traffic())
    dl = max(abs(a - c) for a, c in zip(runs["cuda"]["losses"],
                                        runs["cpu"]["losses"]))
    check(runs["cuda"]["shares"] == runs["cpu"]["shares"], "shares differ")
    check(dl <= 1e-3, f"card vs host losses differ by {dl}")
    check(runs["cuda"]["traffic"] == runs["cpu"]["traffic"],
          "feature traffic differs")
    emit("crosscheck", max_loss_diff=dl, **runs)

    # the segment-sum path: gcn-products through K3
    t = HybridGNNTrainer(ds, gcn, slice_cfg)
    ops.reset_kernel_launches()
    hist = t.train(3)
    seg_launches = ops.kernel_launches()
    t.close()
    check(all(math.isfinite(m.loss) for m in hist), "gcn: non-finite loss")
    check(seg_launches["segment_sum"] >= 2 * sum(
        1 for m in hist if m.shares.get("accel0", 0) > 0) > 0,
        f"K3 launches {seg_launches}")
    emit("segsum", launches=seg_launches, losses=[m.loss for m in hist],
         shares=[m.shares for m in hist])
    refresh_launches = phase_refresh(ds, sage, host_cfg,
                                     torch.device("cuda", 0))
    shard_launches = phase_shard(ds, sage, host_cfg)
    phase_depth(ds, sage, host_cfg)
    spill_dir = args.spill_dir or str(
        ROOT / "build" / f"outofcore-spill-{os.getpid()}")
    try:
        phase_outofcore(ds, sage, slice_cfg, spill_dir)
        phase_faults(ds, sage, slice_cfg, spill_dir)
        phase_autotune(ds, sage, slice_cfg, spill_dir)
    finally:
        shutil.rmtree(spill_dir, ignore_errors=True)
    phase_cli(ROOT / "build")
    serve_res = phase_serve(torch.device("cuda", 0))
    from repro_torch.core.perfmodel import PLATFORMS
    train_res = phase_lm_train(torch.device("cuda", 0), ROOT / "build",
                               PLATFORMS[platform].mem_bw_gbps * 1e9)
    moe_res = phase_lm_moe(torch.device("cuda", 0),
                           PLATFORMS[platform].mem_bw_gbps * 1e9)
    mesh_work = ROOT / "build" / f"mesh-{os.getpid()}"
    early = start_dryrun(mesh_work, MESH_DRYRUN_EARLY)
    ssm_res = phase_lm_ssm(torch.device("cuda", 0),
                           PLATFORMS[platform].mem_bw_gbps * 1e9)
    mesh_res = phase_mesh(torch.device("cuda", 0), mesh_work, early)
    cards = min(torch.cuda.device_count(), MC_CARDS)
    if cards >= 2:
        phase_multicard(ds, sage, slice_cfg, host_cfg, cards,
                        ROOT / "build" / f"multicard-{os.getpid()}")
    else:
        emit("multicard", skipped="1 card visible")

    launches = dict(train["launches"])
    launches["segment_sum"] = seg_launches["segment_sum"]
    launches.update(refresh_launches)
    # K4's path is the sharded plane; K7 lies on no path (a parity
    # baseline), so the train run's count of it stands
    launches["cache_combine_pipelined"] = \
        shard_launches["cache_combine_pipelined"]
    # K8's paths: the serve phase's prefill, the lm_train slice, in lm_moe
    # llama4-scout's prefill and the two frontends' training steps, and in
    # lm_ssm zamba2-7b's prefill and training steps (D 112), and in mesh
    # the two ranks' steps (each rank's own count, under local_map) and
    # the one-process CLI
    k8_paths = dict(serve=serve_res["k8_launches"],
                    lm_train=train_res["slice"]["launches"]["flash_attention"],
                    lm_moe_scout_prefill=moe_res["k8_launches"][
                        "scout_prefill"],
                    lm_moe_frontends=moe_res["k8_launches"]["frontends"],
                    lm_ssm_zamba_prefill=ssm_res["k8_launches"][
                        "zamba_prefill"],
                    lm_ssm_zamba_train=ssm_res["k8_launches"][
                        "zamba_train"],
                    mesh_ranks=mesh_res["k8_launches"]["ranks"],
                    mesh_one_process=mesh_res["k8_launches"][
                        "one_process_cli"])
    launches["flash_attention"] = sum(k8_paths.values())
    k8_keys = ("shape", "max_abs_err", "ms", "call_ms", "plain_ms",
               "library_ms", "bound_ms", "bound_by", "tflops",
               "bound_fraction", "timing")
    scout_k8 = moe_res["scout_serve"]["k8"]
    zamba_k8 = ssm_res["zamba_serve"]["k8"]
    kern["flash_attention"].update(launches_by_path=k8_paths, **{
        key: train_res["grad"][key] for key in train_res["grad"]
        if key.startswith("train_")}, **{
        f"scout_{key}": scout_k8[key] for key in k8_keys}, **{
        f"zamba_{key}": zamba_k8[key] for key in k8_keys + (
            "max_abs_err_by_dtype",)})
    kernels = []
    for name in ops.KERNELS:
        k = kern[name]
        src, replaces = K_SOURCES[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=k["max_abs_err"],
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"],
            call_ms=k["call_ms"], library_call_ms=k["library_call_ms"],
            plain_call_ms=k["plain_call_ms"], timing=TIMING["method"],
            **{key: k[key] for key in ("tflops", "bound_fraction",
                                       "bf16_ms", "bf16_bound_ms",
                                       "cache_less", "peer_gather")
               if key in k},
            **{key: k[key] for key in k if key.startswith(
                ("train_", "scout_", "zamba_"))
               or key == "launches_by_path"}))
    print(env["nvidia_smi"], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
