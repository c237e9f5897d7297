"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--scale 1.0] [--iters 10] [--out DIR]

Builds the port's hand-written kernels from ``src/repro_torch/kernels/csrc``
with nvcc (sm_90a), holds each kernel against its plain PyTorch version on
the card at the slice's full-width shapes, times both with CUDA events, and
drives the hybrid trainer (``repro_torch.core.HybridGNNTrainer``) on
``cuda:0`` with the paper's ``sage-products`` configuration (layer widths
(100, 256, 47), fanouts (25, 10), batch 1024, fused layer kernel, 20 % hot
cache, dedup, DRM).  Phases, each printing one JSON line:

  env          versions, the card, nvcc, kernel build time
  kernels      K1 combine (f32, bf16: bit-equal), K2 fused layer (SAGE split
               W, GCN shared W) and K3 segment sum (f32, bf16) against their
               plain versions, K2/K3 gradients against plain autograd, and
               each kernel's time, plain time, library time and bound
  train        ~10 iterations of the slice on the card; asserts finite
               losses, an accelerator share on every iteration, CUDA inputs
               and parameters, and K1/K2 launches on every accel iteration
  crosscheck   the slice with use_drm=False (sequential stages) for 3
               iterations on the card and on the host from the same weights:
               losses within 1e-3, feature traffic equal
  segsum       gcn-products with agg_impl="pallas" (K3) for 3 iterations

then the card's name and power limit as nvidia-smi prints them, one
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
Any failed check raises: the script exits non-zero and prints no result.
It needs a CUDA card and the repository's ``src/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
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
    "fused_update": ("src/repro_torch/kernels/csrc/fused_update.cu",
                     "src/repro/kernels/gather_scatter_mm.py:125"),
    "segment_sum": ("src/repro_torch/kernels/csrc/segment_sum.cu",
                    "src/repro/kernels/gather_scatter_mm.py:73"),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=float), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
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


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def close(a, b, rtol, atol, what) -> float:
    err = max_err(a, b)
    ok = bool(torch.allclose(a.float(), b.float(), rtol=rtol, atol=atol))
    check(ok and a.shape == b.shape, f"{what}: max abs err {err}")
    return err


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
    # the cache-less dedup path (every unique id shipped)
    uniq = torch.from_numpy(trainer.dataset.take_features(look.unique_ids))
    inv = torch.from_numpy(look.inverse).to(dev)
    got = ops.assemble_features(None, uniq.to(dev), torch.full_like(inv, -1),
                                inv)
    check(torch.equal(got, ref.expand_rows(uniq.to(dev), inv)),
          "K1 cache-less not bit-equal")
    x0 = ops.assemble_features(cache32, miss32, slots, mi)
    n, f = x0.shape
    uniq_src = int(np.unique(look.slots[look.slots >= 0]).size) + \
        int(np.unique(look.miss_index[look.slots < 0]).size)
    k1_bytes = n * f * 4 + n * 8 + uniq_src * f * 4
    out["cache_combine"] = dict(
        name="cache_combine", max_abs_err=0.0, shape=[n, f],
        ms=time_ms(lambda: ops.assemble_features(cache32, miss32, slots,
                                                 mi)),
        plain_ms=time_ms(lambda: ref.assemble_features(cache32, miss32,
                                                       slots, mi)),
        library_ms=None, bound_ms=k1_bytes / peak_bw * 1e3,
        bound_by="bytes", bytes=k1_bytes, flops=0)

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
    ms = plain = bound = 0.0
    b2_total = fl2_total = 0
    for name in ("sage1", "sage2"):   # the slice's two launches
        xs, xn, we, ss, ws, wa, bb, fan = layers[name]
        d_, f_ = xs.shape
        o_ = ws.shape[1]
        byts = nbytes(xs, xn, we, ss, ws, wa, bb) + d_ * o_ * 4
        flops = 4 * d_ * f_ * o_ + 2 * d_ * fan * f_ + d_ * f_
        lms = time_ms(lambda: ops.fused_gnn_update(*layers[name]))
        pms = time_ms(lambda: ref.fused_gnn_update(*layers[name]))
        lb = max(byts / peak_bw, flops / peak_flops) * 1e3
        k2["layers"][name] = dict(shape=[d_, fan, f_, o_], ms=lms,
                                  plain_ms=pms, bound_ms=lb, bytes=byts,
                                  flops=flops)
        ms, plain, bound = ms + lms, plain + pms, bound + lb
        b2_total, fl2_total = b2_total + byts, fl2_total + flops
    k2.update(max_abs_err=err2, ms=ms, plain_ms=plain, library_ms=None,
              bound_ms=bound, bytes=b2_total, flops=fl2_total,
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
    ms = plain = lib = bound = 0.0
    b3_total = fl3_total = 0
    for name, (xn, we, fan) in seg.items():
        d_, f_ = xn.shape[0] // fan, xn.shape[1]
        byts = nbytes(xn, we) + d_ * f_ * 4
        flops = 2 * d_ * fan * f_
        lms = time_ms(lambda: ops.segment_weighted_sum_regular(xn, we, fan))
        pms = time_ms(lambda: ref.segment_weighted_sum_regular(xn, we, fan))
        # one library call computing the same function: a batched product
        # [D, 1, fanout] x [D, fanout, F]
        w3, x3 = we.view(d_, 1, fan), xn.view(d_, fan, f_)
        bms = time_ms(lambda: torch.bmm(w3, x3))
        lb = max(byts / peak_bw, flops / peak_flops) * 1e3
        k3["layers"][name] = dict(shape=[d_, fan, f_], ms=lms, plain_ms=pms,
                                  library_ms=bms, bound_ms=lb)
        ms, plain, lib, bound = ms + lms, plain + pms, lib + bms, bound + lb
        b3_total, fl3_total = b3_total + byts, fl3_total + flops
    k3.update(max_abs_err=err3, ms=ms, plain_ms=plain, library_ms=lib,
              bound_ms=bound, bound_by="bytes", bytes=b3_total,
              flops=fl3_total)
    out["segment_sum"] = k3
    emit("kernels", b=b, platform=platform, **out)
    return out


def phase_train(tr, iters: int) -> dict:
    from repro_torch.kernels import ops
    spy = []
    orig = tr._grad

    def traced(params, batch, x0):
        spy.append((x0.device.type, next(iter(params.values())).device.type))
        return orig(params, batch, x0)
    tr._grad = traced
    ops.reset_kernel_launches()
    t0 = time.perf_counter()
    hist = tr.train(iters)
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
    rows = [dict(it=m.iteration, loss=m.loss, shares=m.shares,
                 assignment=m.assignment, mteps=m.mteps,
                 iter_s=m.iter_time, t_sync=m.t_sync,
                 **{k: getattr(m.times, k) for k in
                    ("t_sc", "t_load", "t_tran", "t_tc", "t_ta")})
            for m in hist]
    res = dict(iters=len(hist), wall_s=wall, launches=launches,
               mean_mteps=tr.mean_mteps(), mean_iter_s=tr.mean_iter_time(),
               feature_traffic=tr.feature_traffic(), history=rows)
    emit("train", **res)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="ogbn-products scale (1.0 = 2,449,029 nodes)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", default=None,
                    help="directory for the build log (ptxas -v output)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    # full-precision f32 everywhere a library product runs (stated, not
    # assumed): the plain versions and the backwards use cuBLAS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core import HybridConfig, HybridGNNTrainer
    from repro_torch.core.perfmodel import platform_for_device_name
    from repro_torch.graph import GNNConfig, make_dataset
    from repro_torch.kernels import build, ops

    env = phase_env()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke_build.log"), "w") as fh:
            json.dump(build.build_report(), fh, indent=1, default=str)
    platform = platform_for_device_name(env["device"])

    t0 = time.perf_counter()
    ds = make_dataset("ogbn-products", scale=args.scale, seed=0)
    emit("dataset", scale=args.scale, nodes=ds.num_nodes,
         edges=ds.num_edges, seconds=time.perf_counter() - t0)
    sage = GNNConfig(model="sage", layer_dims=(100, 256, 47),
                     fanouts=(25, 10), num_classes=47,
                     agg_impl="pallas_fused")
    slice_cfg = HybridConfig(
        total_batch=1024, n_accel=1, hybrid=True, use_drm=True, tfp_depth=2,
        dedup=True, cache_fraction=0.2, cache_sharding="replicated",
        feature_dtype="float32", use_accel_sampler=False,
        kernel_pipeline_depth=1, accel_platform=platform, seed=0)
    tr = HybridGNNTrainer(ds, sage, slice_cfg)
    b = tr.runtime.quantized_shares()[1] or 1024
    kern = phase_kernels(tr, b, platform, torch.device("cuda", 0))
    train = phase_train(tr, args.iters)

    # cross-check: card vs host from the same weights.  Sequential stages
    # (tfp_depth=0) make the hit-rate feedback see the same window at every
    # boundary in both runs, so both take the same shares.
    cc_cfg = dataclasses.replace(slice_cfg, use_drm=False, tfp_depth=0)
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
    gcn = GNNConfig(model="gcn", layer_dims=(100, 256, 47), fanouts=(25, 10),
                    num_classes=47, agg_impl="pallas")
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

    launches = dict(train["launches"])
    launches["segment_sum"] = seg_launches["segment_sum"]
    kernels = []
    for name in ops.KERNELS:
        k = kern[name]
        src, replaces = K_SOURCES[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=k["max_abs_err"],
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k["library_ms"]))
    print(env["nvidia_smi"], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
