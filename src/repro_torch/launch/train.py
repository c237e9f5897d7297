"""LM training CLI (port of ``repro/launch/train.py``):
``python -m repro_torch.launch.train --arch smollm-135m --reduced --steps 50
[--device cpu]``.

The paper's system pieces end to end on the LM substrate: the two-stage
prefetching input pipeline (``data.TokenPipeline``), AdamW under the cosine
warm-up schedule, microbatched gradient accumulation, and checkpoint /
restart through ``checkpoint.CheckpointManager(keep=2)`` (parameters,
optimizer state and its step).  Runs on ``cuda:0`` unless ``--device`` says
otherwise; weights are random from ``--seed`` (a ``torch.Generator``).

As in the reference, a mesh exists only when there is more than one rank:
under ``torchrun`` with ``WORLD_SIZE > 1`` each process joins the group
(NCCL on CUDA, each rank on ``cuda:<LOCAL_RANK>``; gloo with ``--device
cpu``), builds a ('data', 'model') mesh with ``--model-parallel`` ranks on
'model', lays the parameters out by the rule table and runs the step under
it (the default 'tp2d' policy).  One process runs without a mesh whatever
``--model-parallel`` says.  Rank 0 prints the progress and writes the
checkpoints (full tensors, so a run restores onto any mesh); under a mesh
every rank prints its own readings as its last line.

A resumed run reads the batches of the steps it resumes at (step ``i``
from ``seed + i``), so its losses continue an uninterrupted run's bit for
bit; the reference's CLI replays its stream from step 0 instead.
``main`` returns the readings (losses, ms per step, tok/s, K8 launches a
step, peak device memory; under a mesh also the rank and whether every
parameter kept its layout) and prints them last as one JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.dist import shard_batch, shard_params, use_mesh
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import init_params, make_train_step, param_count
from repro_torch.optim import adamw, cosine_warmup_schedule


def _full(tree):
    """A state tree with every DTensor gathered to its full value."""
    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    return tree.full_tensor() if isinstance(tree, DTensor) else tree


def _value(t: torch.Tensor) -> float:
    return float(_full(t))


def _load(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Copy a restored full tensor into ``dst`` (its shard if a DTensor)."""
    if isinstance(dst, DTensor):
        src = distribute_tensor(src.to(dst.device), dst.device_mesh,
                                dst.placements, src_data_rank=None)
    dst.copy_(src)


def _setup(device: torch.device, model_parallel: int):
    """(device, mesh, rank, joined): a mesh only under a multi-process
    launch; ``joined`` when this call joined the process group (a caller
    may have joined it already)."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return device, None, 0, False
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    joined = not dist.is_initialized()
    if joined:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return (device, make_local_mesh(model=model_parallel,
                                    device_type=device.type),
            dist.get_rank(), joined)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="TFP window; 0 disables the two-stage prefetch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--attn-impl", choices=("blocked", "flash"),
                    default=None,
                    help="attention route (default: the config's); flash "
                    "launches K8 on the card")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:0)")
    args = ap.parse_args(argv)

    device, mesh, rank, joined = _setup(resolve_device(args.device),
                                        args.model_parallel)
    try:
        return _train(args, device, mesh, rank)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(args, device: torch.device, mesh, rank: int) -> Dict[str, object]:
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = get_arch(args.arch, reduced=args.reduced)
    if args.attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    shape = None if mesh is None else dict(zip(mesh.mesh_dim_names,
                                               mesh.shape))
    say(f"arch={cfg.name} device={device} attn_impl={cfg.attn_impl} "
        f"mesh={shape}")

    with use_mesh(mesh):
        params = init_params(cfg, torch.Generator(device=device).manual_seed(
            args.seed), device)
        layout = (shard_params(params, mesh) if mesh is not None
                  else None)
        named = dict(params.named_parameters())
        opt = adamw(cosine_warmup_schedule(args.lr, args.steps // 10 + 1,
                                           args.steps))
        opt_state = opt.init(named)
        say(f"params: {param_count(params)/1e6:.1f}M")
        step_fn = make_train_step(cfg, opt, microbatches=args.microbatches)

        start_step = 0
        mgr = None
        if args.ckpt_dir:
            mgr = CheckpointManager(args.ckpt_dir, keep=2)
            restored = mgr.restore_latest(_full({"params": named,
                                                 "opt": opt_state}))
            if restored is not None:
                start_step, tree = restored
                with torch.no_grad():
                    for k, p in named.items():
                        _load(p, tree["params"][k])
                    for g in ("m", "v"):
                        for k, t in opt_state[g].items():
                            _load(t, tree["opt"][g][k])
                opt_state["step"] = tree["opt"]["step"]
                say(f"restored checkpoint at step {start_step}")

        pipe = TokenPipeline(cfg, args.batch, args.seq, seed=args.seed,
                             depth=args.prefetch_depth, device=device)
        losses: List[float] = []
        times: List[float] = []
        k8_per_step: List[int] = []
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        loss = float("nan")
        t_prev = time.perf_counter()
        for step, batch in enumerate(pipe.batches(args.steps - start_step,
                                                  start=start_step),
                                     start=start_step):
            if mesh is not None:
                batch = shard_batch(batch, mesh)
            k8_0 = ops.kernel_launches()["flash_attention"]
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = _value(metrics["loss"])       # waits for the step
            k8_per_step.append(ops.kernel_launches()["flash_attention"]
                               - k8_0)
            now = time.perf_counter()
            dt = now - t_prev
            t_prev = now
            losses.append(loss)
            times.append(dt)
            if step % 5 == 0 or step == args.steps - 1:
                say(f"step {step:5d}  loss {loss:.4f}  {dt*1e3:7.1f} ms/step  "
                    f"{args.batch * args.seq / dt:9.0f} tok/s")
            if mgr and (step + 1) % args.ckpt_every == 0:
                _save(mgr, step + 1, named, opt_state, rank)
        if mgr:
            _save(mgr, args.steps, named, opt_state, rank)
            mgr.finalize()
    med = float(np.median(times[2:])) if len(times) > 3 else float("nan")
    say(f"done: median {med*1e3:.1f} ms/step, final loss {loss:.4f}")
    res: Dict[str, object] = dict(
        arch=cfg.name, device=str(device), start_step=start_step,
        steps=args.steps, losses=losses, ms_per_step=[t * 1e3 for t in times],
        median_ms=med * 1e3, tok_s=args.batch * args.seq / med,
        k8_launches=sum(k8_per_step), k8_per_step=k8_per_step,
        peak_bytes=(torch.cuda.max_memory_allocated(device)
                    if device.type == "cuda" else None))
    if mesh is not None:
        res["mesh"] = shape
        res["rank"] = rank
        res["layout_kept"] = all(tuple(p.placements) == layout[k]
                                 for k, p in params.named_parameters())
        # each rank's own readings (its K8 launches, its peak memory), the
        # line and its newline in one write: under a launcher the ranks
        # share one unbuffered stdout, and print's two writes interleave
        print(json.dumps(res) + "\n", end="", flush=True)
    else:
        say(json.dumps(res))
    return res


def _save(mgr, step: int, named, opt_state, rank: int) -> None:
    """Every rank gathers the full state; rank 0 writes it."""
    tree = _full({"params": named, "opt": opt_state})
    if rank == 0:
        mgr.save(step, tree)


if __name__ == "__main__":
    main()
