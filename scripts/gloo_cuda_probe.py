"""Which collectives the gloo backend takes on CUDA tensors, two ranks on
one card (the setting of ``chip_smoke.py``'s mesh phase, since NCCL
refuses two ranks on one device).

    python3 scripts/gloo_cuda_probe.py

Runs each case on its own pair of processes on ``cuda:0`` (joined through
a FileStore, all pairs at once): each collective in f32 and bf16, its
result checked, and one DTensor redistribution of each kind the tp2d route
issues on a (1, 2) mesh.  Prints one JSON line ``{"case": "ok" | "error
text"}``; a case that hangs reads "no answer".
"""
from __future__ import annotations

import datetime
import json
import os
import queue
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _cases(rank: int, dev):
    """{name: fn} of the collectives tried, each checking its result."""
    cases = {}
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).split(".")[-1]

        def all_reduce(dt=dt):
            t = torch.full((8,), float(rank + 1), dtype=dt, device=dev)
            dist.all_reduce(t)
            assert torch.all(t == 3)

        def all_gather(dt=dt):
            t = torch.full((4,), float(rank), dtype=dt, device=dev)
            o = torch.empty(8, dtype=dt, device=dev)
            dist.all_gather_into_tensor(o, t)
            assert torch.all(o[:4] == 0) and torch.all(o[4:] == 1)

        def reduce_scatter(dt=dt):
            t = torch.arange(8, dtype=dt, device=dev)
            o = torch.empty(4, dtype=dt, device=dev)
            dist.reduce_scatter_tensor(o, t)
            assert torch.equal(o, 2 * torch.arange(4 * rank, 4 * rank + 4,
                                                   dtype=dt, device=dev))

        def all_to_all(dt=dt):
            t = torch.full((4,), float(rank), dtype=dt, device=dev)
            o = torch.empty(4, dtype=dt, device=dev)
            dist.all_to_all_single(o, t)
            assert torch.all(o[:2] == 0) and torch.all(o[2:] == 1)

        def broadcast(dt=dt):
            t = torch.full((4,), float(rank), dtype=dt, device=dev)
            dist.broadcast(t, 0)
            assert torch.all(t == 0)

        for name, fn in (("all_reduce", all_reduce),
                         ("all_gather_into_tensor", all_gather),
                         ("reduce_scatter_tensor", reduce_scatter),
                         ("all_to_all_single", all_to_all),
                         ("broadcast", broadcast)):
            cases[f"{name} {tag}"] = fn

    def redistribute(src, dst):
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor
        mesh = init_device_mesh("cuda", (1, 2),
                                mesh_dim_names=("data", "model"))
        full = torch.arange(32, dtype=torch.float32, device=dev
                            ).reshape(4, 8)
        if isinstance(src[1], Partial):
            d = DTensor.from_local(full / 2, mesh, src, run_check=False)
        else:       # each rank keeps its shard, as the port lays out
            d = distribute_tensor(full, mesh, src, src_data_rank=None)
        assert torch.equal(d.redistribute(mesh, dst).full_tensor(), full)

    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)
    for name, src, dst in (
            ("dtensor shard->replicate", (Replicate(), Shard(0)),
             (Replicate(), Replicate())),
            ("dtensor partial->shard", (Replicate(), Partial()),
             (Replicate(), Shard(0))),
            ("dtensor partial->replicate", (Replicate(), Partial()),
             (Replicate(), Replicate())),
            ("dtensor shard0->shard1", (Replicate(), Shard(0)),
             (Replicate(), Shard(1)))):
        cases[name] = lambda src=src, dst=dst: redistribute(src, dst)
    return cases


def _work(rank: int, path: str, name: str, q) -> None:
    """One case on a fresh pair of ranks; the group's 20 s timeout turns a
    collective that never completes into an error."""
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=20))
    try:
        _cases(rank, torch.device("cuda", 0))[name]()
        torch.cuda.synchronize()
        res = "ok"
    except Exception as e:  # the probe records every refusal
        res = f"{type(e).__name__}: {str(e)[:160]}"
    q.put((rank, name, res))
    q.close()
    q.join_thread()     # the answer is sent before the exit below
    os._exit(0)         # no teardown: a refused collective may hang it


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: needs a CUDA card", file=sys.stderr)
        return 2
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    names = list(_cases(0, torch.device("cpu")))
    out = {n: "no answer in 120 s" for n in names}
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_work,
                             args=(r, os.path.join(d, f"s{i}"), n, q))
                 for i, n in enumerate(names) for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.time() + 120
        got = {}
        while len(got) < len(procs) and time.time() < deadline:
            try:
                rank, name, res = q.get(timeout=max(0.1,
                                                    deadline - time.time()))
            except queue.Empty:
                break
            got[(rank, name)] = res
        for p in procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
    for n in names:
        res = {got.get((r, n)) for r in range(2)}
        out[n] = "ok" if res == {"ok"} else "; ".join(
            sorted(str(x) for x in res if x != "ok"))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
