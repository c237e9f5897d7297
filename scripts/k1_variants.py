"""Time design variants of K1 (the cache combine at depth 1) on one card.

    python3 scripts/k1_variants.py [--scale 1.0] [--rounds 2]
                                   [--parent DIR] [--out DIR]

Each variant is a copy of ``src/repro_torch/kernels/csrc`` with one named
change to ``cache_combine.cu`` or ``ldst.cuh`` (a text patch whose anchor
must occur exactly once), built with nvcc (all at once, the port's flags)
into ``build/k1_variants/``.  ``--parent DIR`` adds the ``csrc`` of another
checkout (say ``git archive`` of the parent commit) unchanged, as
``parent``.  Every variant runs on the main path's combine of
``chip_smoke.py`` (a real sage-products batch of ogbn-products at
``--scale`` classified against the 20 % hot cache, f32), must be bit-equal
to the plain version, and is timed with chip_smoke's yardsticks: ``ms``,
the device time of one call alone with the L2 flushed before it, and
``call_ms``, one host-inclusive call.  The variants run in turns, in order
and then reversed, ``--rounds`` times, so a drift of the card shows as a
spread.  ``residue`` asks whether the shipped loads' evict_last lines
outlive chip_smoke's L2 flush: one ``no_hints`` call timed (CUDA events)
right after a flush that followed a shipped call, and after a flush that
followed a ``no_hints`` call.  For reference, one library call computes
the same gather: ``torch.index_select`` over the cache and miss block
concatenated (the concatenation made once, outside the timing); and a
contiguous copy of a tensor of the output's size shows the rate the card
streams at.

Prints the card's name and power limit, one JSON line per variant and
round, the registers per variant (``-Xptxas -v``), and last one summary
line; with ``--out`` every line also goes to ``DIR/k1_variants.jsonl``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts src/ on the path)
import numpy as np  # noqa: E402
import torch  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT_DIR = ROOT / "build" / "k1_variants"
COMBINE, LDST = "cache_combine.cu", "ldst.cuh"

# ldst.cuh without hints: read-only-path loads and plain stores
PLAIN_LDST = """#pragma once
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ uint64_t l2_evict_last_policy() { return 0; }
template <class V>
__device__ __forceinline__ V load_reused(const V* p, uint64_t) {
  return __ldg(p);
}
template <class V>
__device__ __forceinline__ void store_streaming(V* p, V v) { *p = v; }
"""

PERSISTENT_GRID = """  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, combine_rows_kernel<V>, kGroupWarps * 32, 0);
  if (err != cudaSuccess) return err;
  int64_t blocks = 0;
  err = persistent_grid(ceil_div(groups, kGroupWarps), per_sm, &blocks);
  if (err != cudaSuccess) return err;
"""

SLIDING = """    V buf[kCopyDepth];
#pragma unroll
    for (int j = 0; j < kCopyDepth; ++j) fetch(buf[j], j * 32 + lane);
    for (int e0 = 0; e0 < total; e0 += 32 * kCopyDepth) {
#pragma unroll
      for (int j = 0; j < kCopyDepth; ++j) {
        const int e = e0 + j * 32 + lane;
        if (e < total) store_streaming(dst + e, buf[j]);
        fetch(buf[j], e + 32 * kCopyDepth);
      }
    }
"""
# kCopyDepth loads, then kCopyDepth stores, then the next loads
LOCKSTEP = """    for (int e0 = 0; e0 < total; e0 += 32 * kCopyDepth) {
      V buf[kCopyDepth];
#pragma unroll
      for (int j = 0; j < kCopyDepth; ++j) fetch(buf[j], e0 + j * 32 + lane);
#pragma unroll
      for (int j = 0; j < kCopyDepth; ++j) {
        const int e = e0 + j * 32 + lane;
        if (e < total) store_streaming(dst + e, buf[j]);
      }
    }
"""
K1_BOUNDS = "__launch_bounds__(kGroupWarps * 32)\ncombine_rows_kernel"


def min_blocks(k: int) -> tuple:
    return (K1_BOUNDS, K1_BOUNDS.replace("* 32)", f"* 32, {k})"))


def copy_depth(k: int) -> tuple:
    return ("kCopyDepth = 8;", f"kCopyDepth = {k};")


# name -> ({file: [(anchor, replacement), ...]}, entry point, extra args)
VARIANTS = {
    "shipped": ({}, "cache_combine_f32", ()),
    "no_hints": ({LDST: None}, "cache_combine_f32", ()),
    "store_hint_only": ({LDST: [("L2::evict_last", "L2::evict_normal")]},
                        "cache_combine_f32", ()),
    # the 16-byte store (the main path's unit) without its hint
    "load_hint_only": ({LDST: [("st.global.cs.v4", "st.global.v4")]},
                       "cache_combine_f32", ()),
    "lockstep": ({COMBINE: [(SLIDING, LOCKSTEP)]}, "cache_combine_f32", ()),
    "lockstep_no_hints": ({COMBINE: [(SLIDING, LOCKSTEP)], LDST: None},
                          "cache_combine_f32", ()),
    "persistent": ({COMBINE: [(
        "  const int64_t blocks = ceil_div(groups, kGroupWarps);  "
        "// a group a warp\n", PERSISTENT_GRID)]}, "cache_combine_f32", ()),
    "min_blocks_4": ({COMBINE: [min_blocks(4)]}, "cache_combine_f32", ()),
    "copy_depth_4": ({COMBINE: [copy_depth(4)]}, "cache_combine_f32", ()),
    "copy_depth_4_min_blocks_6": ({COMBINE: [copy_depth(4), min_blocks(6)]},
                                  "cache_combine_f32", ()),
    "copy_depth_12": ({COMBINE: [copy_depth(12)]}, "cache_combine_f32", ()),
    "group_warps_4": ({COMBINE: [("kGroupWarps = 8;", "kGroupWarps = 4;")]},
                      "cache_combine_f32", ()),
    # K4's bulk route with one stage: the storer frees the stage once its
    # own store has read it (at depth >= 2 it frees the stage before)
    "k4_bulk_1stage": ({COMBINE: [
        ("if (depth < 2 || depth > 4)", "if (depth < 1 || depth > 4)"),
        ("      bulk_wait_read<1>();\n"
         "      if (k > 0) mbar_arrive(&empty[(k - 1) % depth]);\n",
         "      bulk_wait_read<0>();\n"
         "      mbar_arrive(&empty[s]);\n")]},
        "cache_combine_pipelined_f32", (1,)),
}
_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 2


def emit(fh, **line) -> None:
    text = json.dumps(line, default=float)
    print(text, flush=True)
    if fh is not None:
        fh.write(text + "\n")


def make_variant(name: str, src_dir: Path, patches: dict) -> Path:
    """``src_dir`` copied to OUT_DIR/name with ``patches`` applied (None
    for a file: PLAIN_LDST in its place)."""
    dst = OUT_DIR / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src_dir, dst)
    for fname, edits in patches.items():
        path = dst / fname
        if edits is None:
            path.write_text(PLAIN_LDST)
            continue
        text = path.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: anchor {old!r} occurs "
                                   f"{text.count(old)} times in {fname}")
            text = text.replace(old, new)
        path.write_text(text)
    return dst


def build(dirs: dict) -> dict:
    """One nvcc per variant, all started together; returns name ->
    (library path, -Xptxas -v log)."""
    from repro_torch.kernels import build as kbuild
    nvcc = kbuild._nvcc()
    procs = {}
    for name, d in dirs.items():
        lib = d / "libcache_combine.so"
        cmd = [nvcc, *kbuild.NVCC_FLAGS, "-I", str(d), "-o", str(lib),
               str(d / COMBINE)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    out, failed = {}, []
    for name, (proc, lib) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{text}")
        out[name] = (lib, text)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def k1_registers(log: str) -> list:
    """The ptxas lines of K1's kernel (and K4's bulk kernel): function,
    registers, spill stores and loads."""
    res, fn, spill = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spill = m.group(1), None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn and ("combine_rows_kernel" in fn
                         or "combine_rows_bulk" in fn):
            res.append(dict(function=fn, registers=int(m.group(1)),
                            spill=spill))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--parent", default=None,
                    help="root of another checkout whose csrc is timed "
                    "unchanged as 'parent'")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch.core import HybridConfig, HybridGNNTrainer
    from repro_torch.core.perfmodel import platform_for_device_name
    from repro_torch.graph import GNNConfig, make_dataset
    from repro_torch.kernels import ref

    fh = None
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        fh = open(Path(args.out) / "k1_variants.jsonl", "w")
    print(chip_smoke.nvidia_smi(), flush=True)
    dirs = {name: make_variant(name, CSRC, patches)
            for name, (patches, _, _) in VARIANTS.items()}
    entries = {name: (sym, extra) for name, (_, sym, extra)
               in VARIANTS.items()}
    if args.parent:
        dirs["parent"] = make_variant(
            "parent", Path(args.parent) / "src/repro_torch/kernels/csrc", {})
        entries["parent"] = ("cache_combine_f32", ())
    built = build(dirs)
    fns = {}
    for name, (lib, log) in built.items():
        sym, extra = entries[name]
        fn = getattr(ctypes.CDLL(str(lib)), sym)
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGS + [ctypes.c_int] * len(extra) + [ctypes.c_void_p]
        fns[name] = (fn, extra)
        emit(fh, variant=name, ptxas=k1_registers(log))

    dev = torch.device("cuda", 0)
    ds = make_dataset("ogbn-products", scale=args.scale, seed=0)
    sage = GNNConfig(model="sage", layer_dims=(100, 256, 47),
                     fanouts=(25, 10), num_classes=47,
                     agg_impl="pallas_fused")
    cfg = HybridConfig(
        total_batch=1024, n_accel=1, hybrid=True, use_drm=True, tfp_depth=2,
        dedup=True, cache_fraction=0.2, feature_dtype="float32",
        use_accel_sampler=False, kernel_pipeline_depth=1,
        accel_platform=platform_for_device_name(
            torch.cuda.get_device_name(0)), seed=0)
    tr = HybridGNNTrainer(ds, sage, cfg)
    b = tr.runtime.quantized_shares()[1] or 1024
    _, look, rows = chip_smoke.main_path_inputs(tr, b)
    cache = tr.cache.data_on(dev)
    tr.close()
    miss = rows.to(dev)
    slots = torch.from_numpy(look.slots).to(dev)
    mi = torch.from_numpy(look.miss_index).to(dev)
    n, f = slots.shape[0], cache.shape[1]
    want = chip_smoke.bits(ref.assemble_features(cache, miss, slots, mi))
    out = torch.empty(n, f, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call(name: str) -> None:
        fn, extra = fns[name]
        rc = fn(cache.data_ptr(), miss.data_ptr(), slots.data_ptr(),
                mi.data_ptr(), out.data_ptr(), n, f, *extra, stream)
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA error {rc}")

    for name in fns:
        out.zero_()
        call(name)
        torch.cuda.synchronize()
        chip_smoke.check(torch.equal(chip_smoke.bits(out), want),
                         f"{name} not bit-equal to the plain combine")
    # the same gather as one library call: index_select over [cache; miss]
    both = torch.cat([cache, miss])
    index = torch.where(slots >= 0, slots, mi + cache.shape[0])
    chip_smoke.check(torch.equal(chip_smoke.bits(torch.index_select(
        both, 0, index)), want), "index_select reference differs")
    library = chip_smoke.timed(lambda: torch.index_select(both, 0, index))
    # the card's streaming rate on this many output bytes: a contiguous
    # copy reads and writes n * f * 4 bytes each
    src = torch.empty_like(out).copy_(out)
    copy = chip_smoke.timed(lambda: out.copy_(src))
    copy["tb_per_s"] = 2 * out.numel() * 4 / (copy["ms"] * 1e-3) / 1e12
    del src
    readings = {name: [] for name in fns}
    order = list(fns)
    for rnd in range(args.rounds):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            t = chip_smoke.timed(lambda: call(name))
            readings[name].append(t)
            emit(fh, variant=name, round=rnd, shape=[n, f], **t)

    def after(first: str, reps: int = 20) -> float:
        """Median event time of one no_hints call right after a flush
        that followed a ``first`` call."""
        times = []
        for _ in range(reps):
            call(first)
            chip_smoke.flush_l2()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call("no_hints")
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    residue = {"after_no_hints": after("no_hints"),
               "after_shipped": after("shipped")}
    summary = {name: dict(ms=statistics.mean(r["ms"] for r in rs),
                          ms_all=[r["ms"] for r in rs],
                          call_ms=statistics.mean(r["call_ms"] for r in rs))
               for name, rs in readings.items()}
    emit(fh, summary=summary, residue_ms=residue, shape=[n, f],
         index_select_concatenated=library, contiguous_copy=copy,
         timing=chip_smoke.TIMING["method"],
         nvidia_smi=chip_smoke.nvidia_smi(),
         distinct_source_rows=int(np.unique(look.slots[look.slots >= 0])
                                  .size + np.unique(
                                      look.miss_index[look.slots < 0]).size))
    if fh is not None:
        fh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
