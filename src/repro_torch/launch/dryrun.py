"""Dry-run of every (arch x shape x mesh) cell under a fake process group
(port of ``repro/launch/dryrun.py``):

    python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh single|multi|both] [--policy tp2d|dp|serve2d|auto]
        [--out FILE] [--quiet]

The reference lowers and compiles each cell on 512 forced host devices.
Here the fake backend (``init_process_group("fake")``) stands in for the
256 or 512 ranks of the production meshes and a ``FakeTensorMode`` for
their memory: one step of the cell runs on rank 0's shards, every
collective is issued and counted but moves nothing, and no card, no
``torchrun`` and no kernel build is needed.  K8 runs as its custom op's
shape function inside ``local_map``.  The fake tensors carry the ``cpu``
device type (a CPU-only build of torch cannot run autograd on fake
``cuda`` tensors); the roofline is at the H100's constants
(``launch/analysis.py``).

Per cell: ``status`` (``ok``, ``skipped`` or ``error`` with the
traceback: a failing cell is a fault of the port), the bytes per rank
(its arguments' local shards plus the run's peak of live tensors) and
``fits_80gb``, the FLOPs and bytes of ``launch/costmodel.py``, the
collective operand bytes by kind, and the roofline terms.  A train cell
walks the microbatch ladder until it fits, as the reference's does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from typing import Optional

import torch.distributed as dist
from torch.distributed.tensor.debug import CommDebugMode

from ..configs import ARCHS, SHAPES, cell_applicable, get_arch
from ..models import active_param_count
from .analysis import (FIT_BYTES, HW, CollectiveBytes, Roofline,
                       model_flops_total)
from .cellspecs import build_cell, microbatch_ladder
from .costmodel import CostMode, LiveBytes, local_nbytes
from .mesh import make_production_mesh

__all__ = ["resolve_policy", "run_cell", "init_fake_world", "main"]


def resolve_policy(cfg, shape, n_chips: int) -> tuple:
    """(policy, attn_impl), the reference's design-time choice: decode of
    dense / MoE archs -> 'serve2d'; archs of <= 2 B active parameters
    whose global batch divides the ranks -> 'dp' (+ K8 for full-attention
    dense / MoE); MoE with a multiple of 16 experts -> 'ep'; else
    'tp2d'."""
    if shape.step == "decode" and cfg.kind in ("dense", "moe"):
        return "serve2d", cfg.attn_impl
    if (active_param_count(cfg) <= 2e9
            and shape.global_batch % n_chips == 0):
        attn = ("flash" if cfg.window == 0 and cfg.kind in ("dense", "moe")
                else cfg.attn_impl)
        return "dp", attn
    if cfg.kind == "moe" and cfg.moe_experts % 16 == 0:
        return "ep", cfg.attn_impl
    return "tp2d", cfg.attn_impl


def init_fake_world(world_size: int) -> None:
    """(Re)initialise the default process group as the fake backend of
    ``world_size`` ranks, this process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def run_cell(arch: str, shape_name: str, mesh, *, verbose: bool = True,
             microbatches: Optional[int] = None,
             policy: str = "tp2d") -> dict:
    """One step of a cell under the fake group; train cells walk the
    microbatch ladder until they fit the card's 80 GB."""
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    n = mesh.size()
    if policy == "auto":
        policy, attn = resolve_policy(cfg, shape, n)
        if attn != cfg.attn_impl:
            cfg = dataclasses.replace(cfg, attn_impl=attn)
    ok, reason = cell_applicable(cfg, shape)
    if not ok:
        if verbose:
            print(f"[skip] {arch} x {shape_name}: {reason}")
        return {"arch": arch, "shape": shape_name, "mesh": list(mesh.shape),
                "chips": n, "status": "skipped", "reason": reason}
    ladder = [microbatches] if microbatches else microbatch_ladder(shape,
                                                                   mesh)
    attempts = []
    result: dict = {}
    for n_mb in ladder:
        result = _run_cell(arch, cfg, shape, mesh, n_mb, policy,
                           verbose=verbose)
        attempts.append({"microbatches": n_mb, "status": result["status"],
                         "bytes_per_device": result.get("bytes_per_device")})
        if result["status"] != "ok" or result["fits_80gb"]:
            break
    result["microbatch_ladder"] = attempts
    return result


def _run_cell(arch, cfg, shape, mesh, n_mb, policy, *, verbose) -> dict:
    n_chips = mesh.size()
    result = {"arch": arch, "shape": shape.name, "mesh": list(mesh.shape),
              "chips": n_chips, "microbatches": n_mb, "policy": policy,
              "attn_impl": cfg.attn_impl, "status": "skipped", "reason": ""}
    t0 = time.time()
    try:
        cell = build_cell(cfg, shape, mesh, microbatches=n_mb,
                          policy=policy)
        args = cell.arg_tensors()
        arg_bytes = sum(local_nbytes(t) for t in args.values())
        cost, live, coll = CostMode(), LiveBytes(), CollectiveBytes()
        t_build = time.time() - t0
        with CommDebugMode() as comm:
            out = cell.run(cost, live, coll)
        t_run = time.time() - t0 - t_build
        cost.add_io(args.values())
        cost.add_io(cell.out_tensors(out))
        c = cost.cost
        colls = coll.totals()
        roof = Roofline(flops=c.flops, hbm_bytes=c.bytes,
                        coll_bytes=float(colls["total"]),
                        model_flops=model_flops_total(cfg, shape) / n_chips)
        total = arg_bytes + live.peak
        result.update({
            "status": "ok",
            "t_build_s": round(t_build, 2), "t_run_s": round(t_run, 2),
            "memory": {"argument_bytes": int(arg_bytes),
                       "peak_live_bytes": int(live.peak)},
            "bytes_per_device": int(total),
            "fits_80gb": bool(total < FIT_BYTES),
            "cost": dataclasses.asdict(c),
            "collectives": {k: int(v) for k, v in colls.items()},
            "collective_counts": dict(coll.count),
            "comm_counts": {str(k): v
                            for k, v in comm.get_comm_counts().items()},
            "roofline": roof.as_dict(),
            "hw": HW,
        })
        if verbose:
            print(f"[ok]   {arch} x {shape.name} x {tuple(mesh.shape)} "
                  f"{policy} mb={n_mb} build={t_build:.1f}s "
                  f"run={t_run:.1f}s")
            print(f"       {total / 2**30:.2f} GiB/device "
                  f"(args {arg_bytes / 2**30:.2f}, peak live "
                  f"{live.peak / 2**30:.2f}; fits 80GB: "
                  f"{total < FIT_BYTES})")
            print(f"       flops={roof.flops:.3e} bytes={roof.hbm_bytes:.3e}"
                  f" coll_bytes={roof.coll_bytes:.3e}")
            print(f"       roofline: compute={roof.t_compute * 1e3:.2f}ms "
                  f"memory={roof.t_memory * 1e3:.2f}ms "
                  f"collective={roof.t_collective * 1e3:.2f}ms "
                  f"bottleneck={roof.bottleneck} "
                  f"useful={roof.useful_ratio:.2f} "
                  f"roofline_frac={roof.roofline_fraction:.3f}")
    except Exception as e:  # a failing cell is a fault of the port
        result.update({"status": "error",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]})
        if verbose:
            print(f"[FAIL] {arch} x {shape.name}: {type(e).__name__}: {e}")
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all' (see repro_torch.configs.ARCHS)")
    ap.add_argument("--shape", default="all",
                    help="shape id or 'all' (train_4k/prefill_32k/...)")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--policy", default="tp2d",
                    choices=["tp2d", "dp", "serve2d", "auto"])
    ap.add_argument("--out", default=None, help="write results JSON here")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    results = []
    try:
        for multi_pod in meshes:
            init_fake_world(512 if multi_pod else 256)
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            for arch in archs:
                for shape in shapes:
                    results.append(run_cell(arch, shape, mesh,
                                            verbose=not args.quiet,
                                            policy=args.policy))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndry-run summary: {n_ok} ok, {n_skip} skipped, {n_err} failed "
          f"of {len(results)} cells")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"results -> {args.out}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
