"""Driver of LM training cells across the cards of one host: the port's
``make_train_step`` under its device mesh, one rank process a card.

The cell's traffic names the mesh (``mesh``: data x model ranks) and the
policy.  ``run`` starts one rank process a card (this module run as a
script), joined over NCCL (gloo on the host) at a free ``localhost`` port,
and waits for them: each collective fails its rank after
``COLLECTIVE_S`` seconds, the run as a whole is stopped after
``RUN_S`` seconds past the window, and when one rank fails or the time is
up every rank is killed and ``run`` raises.  A rank, as
``launch/train.py`` runs one:

1. set-up: the mesh (``launch.mesh.make_local_mesh``), the model
   (``repro_torch.models.init_params``) laid out by the rule table
   (``dist.shard_params``) and loaded with the benchmark's weights for the
   seed, its AdamW state and train step, and a ``TokenPipeline`` whose
   whole batch every rank makes and ``dist.shard_batch`` cuts to the
   rank's rows; the compared steps (each batch checked bit for bit
   against the benchmark's own), the first gradient's norms from the
   optimizer's state after step 1 and the parameters' change after the
   last compared step, summed over the ranks;
2. the window: as many steps as fill ``seconds`` at the slowest rank's
   steady step, a device event at each boundary, the host's wait for each
   batch timed, one synchronize at the end;
3. with ``traced``, a few more steps under the profiler on every rank;
   rank 0 reads the per-layer metrics, the MoE counters summed over the
   ranks;
4. the program freed, the plain f32 reference (``reference/moe.py``) runs
   the compared step on the rank's rows with one layer's weights at a
   time, each gradient summed over the ranks in f32, and the judge
   compares.

Rank 0's record carries the run; ``memory_peak_gb`` is the fullest
card's.  Each rank lists the forbidden modules (``harness/imports.py``)
it has loaded once its reference has run, and ``run`` raises where any
rank lists one: the harness checks only its own process.  ``correct``'s ``grad_gap`` leaves the router leaves out of its
worst leaf (their gap follows which tokens route apart, not the
arithmetic); ``grad_gap_median`` keeps them.
"""
from __future__ import annotations

import ctypes
import datetime
import gc
import json
import math
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench.harness import (imports, judge, moe_weights,  # noqa: E402
                               program, spec, token_batches)
from perfbench.harness.mesh_record import (  # noqa: E402
    MOE_COUNTERS, MeshRun, forward_counts)
from perfbench.harness.moe_dims import from_arch  # noqa: E402

FAULTS = ("state_unchanged", "half_batch")
MODES = ("program", "control")
MAX_STEPS = 100_000
COLLECTIVE_S = 900      # a collective waiting longer fails its rank
RUN_S = 1800            # the run's limit beyond twice the window
ROUTER = ".moe.router"
PORT_AUX = 0.01         # the port's aux coefficient (models/lm.py loss_fn)


def require_program() -> None:
    """Refuse, before any rank starts, a program that cannot make this
    driver's traffic (a ``TokenPipeline`` without ``zipf_exponent``)."""
    from repro_torch.data import TokenPipeline
    if "zipf_exponent" not in TokenPipeline.__dataclass_fields__:
        raise RuntimeError("the program's TokenPipeline has no "
                           "zipf_exponent: it cannot make this cell's "
                           "token ids")


def model_config(cell: Dict[str, Any]):
    from repro_torch.models.lm import ModelConfig
    a = cell["config"]["arch"]
    d = from_arch(a)
    if d.aux_coef != PORT_AUX:
        raise ValueError(f"aux_loss_coef {d.aux_coef}: the port's loss "
                         f"adds {PORT_AUX} x the aux")
    return ModelConfig(         # from_arch has checked kind and frontend
        name=cell["config"]["name"], kind="moe", n_layers=d.layers,
        d_model=d.d, n_heads=d.heads, n_kv=d.kv_heads, d_ff=d.ff,
        vocab=d.vocab, head_dim=d.head_dim, moe_experts=d.experts,
        moe_top_k=d.top_k, capacity_factor=d.capacity_factor, window=0,
        mlp="swiglu", rope_theta=d.rope_theta, norm_eps=d.eps,
        dtype=a["dtype"], frontend="none", remat=a["remat"],
        q_block=a["q_block"], attn_impl=a["attn_impl"])


def numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``judge.numbers`` with the router leaves out of ``grad_gap``'s
    worst leaf."""
    nums = judge.numbers(prog, ref)
    leaves = sorted(k for k in ref["grad"] if not k.endswith(ROUTER))
    nums["grad_gap"], nums["_grad_leaf"] = judge.leaf_gap(
        prog["grad"], ref["grad"], leaves)
    return nums


# ------------------------------------------------------------ the parent


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(path: Path, n: int = 4000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except OSError:
        return ""


def _wait(procs: List[subprocess.Popen], logs: List[Path],
          deadline: float) -> None:
    """Until every rank exits 0; kills them all when one fails or the
    deadline passes, and raises."""
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RuntimeError(
                    f"rank {bad[0]} exited {codes[bad[0]]}:\n"
                    f"{_tail(logs[bad[0]])}")
            if all(c == 0 for c in codes):
                return
            if time.time() > deadline:
                raise RuntimeError(
                    f"ranks {[r for r, c in enumerate(codes) if c is None]}"
                    f" still running at the run's limit:\n{_tail(logs[0])}")
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()


def run(cell: Dict[str, Any], seed: int, seconds: float, traced: bool, *,
        started: float, fault: Optional[str] = None,
        device: Optional[str] = None, mode: str = "program"
        ) -> Dict[str, Any]:
    """One run on the host's cards (or, with ``device="cpu"``, in gloo
    processes on the host): the record the harness reports from.
    ``mode="control"`` puts the reference in fp8 in the program's
    place."""
    require_program()
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault {fault!r}; have {FAULTS}")
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}; have {MODES}")
    tr = cell["traffic"]
    world = tr["mesh"][0] * tr["mesh"][1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    with tempfile.TemporaryDirectory(prefix="pb-mesh-") as tmp:
        out = Path(tmp)
        job = {"cell": cell, "seed": int(seed), "seconds": float(seconds),
               "traced": bool(traced), "started": started, "fault": fault,
               "device": device, "mode": mode, "world": world,
               "port": _free_port(), "out": str(out)}
        (out / "job.json").write_text(json.dumps(job))
        logs = [out / f"rank{r}.log" for r in range(world)]
        procs = []
        for r in range(world):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()),
                     str(out / "job.json"), str(r), str(os.getpid())],
                    cwd=str(ROOT), env=env,
                    stdout=log, stderr=subprocess.STDOUT))
        _wait(procs, logs, time.time() + RUN_S + 2 * float(seconds))
        recs = [json.loads((out / f"rank{r}.json").read_text())
                for r in range(world)]
    loaded = {r: rc["forbidden"] for r, rc in enumerate(recs)
              if rc["forbidden"]}
    if loaded:
        raise RuntimeError(f"ranks loaded JAX modules: {loaded}")
    rec = recs[0]
    rec["peak_bytes"] = max(r["peak_bytes"] for r in recs)
    rec["phases"]["peak_bytes_by_rank"] = [r["peak_bytes"] for r in recs]
    rec["phases"]["reserved_bytes_by_rank"] = [r.get("reserved_bytes", 0)
                                               for r in recs]
    rec["cards"] = world
    return rec


def as_run(cell: Dict[str, Any], rec: Dict[str, Any]) -> MeshRun:
    """The record as the end-to-end readers see it."""
    tr = cell["traffic"]
    return MeshRun(dims=from_arch(cell["config"]["arch"]), traffic=tr,
                   steps=rec["steps"], window_s=rec["window_s"],
                   tokens_per_step=tr["batch"] * tr["seq"],
                   step_ms=rec["step_ms"], input_wait_s=rec["input_wait_s"],
                   peak_bytes=rec["peak_bytes"], setup_s=rec["setup_s"],
                   ranks=rec["cards"])


# ------------------------------------------------------------- one rank


def _value(t) -> float:
    from torch.distributed.tensor import DTensor
    return float(t.full_tensor() if isinstance(t, DTensor) else t)


def _norms(tensors: Dict[str, Any], scale: float = 1.0) -> Dict[str, float]:
    """Each tensor's f32 norm (a DTensor's over all its shards)."""
    import torch
    from torch.distributed.tensor import DTensor
    vals = []
    for t in tensors.values():
        n = torch.linalg.vector_norm(t.float())
        vals.append(n.full_tensor() if isinstance(n, DTensor) else n)
    return dict(zip(tensors, (torch.stack(vals) * scale).tolist()))


def _agree_max(x: float, dev) -> float:
    import torch
    import torch.distributed as dist
    t = torch.tensor([float(x)], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _faulty(step_fn, fault: Optional[str], cfg):
    """The timed path broken underneath by ``state_unchanged``: the step
    computes the gradient and keeps the old state."""
    if fault != "state_unchanged":
        return step_fn
    from repro_torch.models import value_and_grad

    def unchanged(params, state, batch):
        loss, metrics, _ = value_and_grad(params, cfg, batch)
        return params, state, dict(metrics, loss=loss)
    return unchanged


def _half(raw: Dict[str, Any]) -> Dict[str, Any]:
    """The ``half_batch`` fault: the batch's later half of rows masked out
    of the loss (label -1), so the step trains on the first half."""
    labels = raw["labels"].clone()
    labels[labels.shape[0] // 2:] = -1
    return dict(raw, labels=labels)


def _program(cell, seed, seconds, traced, dev, mesh, started, fault, rank,
             world) -> Dict[str, Any]:
    import torch
    from torch.distributed.tensor import distribute_tensor
    from perfbench.drivers.lm_train import (_alloc_retries, _Clock,
                                            _optimizer, _sync)
    from perfbench.harness.trace import breakdown, busy, profile, span
    from repro_torch.data import TokenPipeline
    from repro_torch.dist import (shard_batch, shard_params, use_mesh,
                                  use_policy)
    from repro_torch.models import init_params, make_train_step
    tr, dims = cell["traffic"], from_arch(cell["config"]["arch"])
    train = cell["config"]["train"]
    phases = {"imported": time.time() - started}
    cfg = model_config(cell)
    with use_mesh(mesh), use_policy(tr["policy"]):
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(
            seed), dev)
        shard_params(params, mesh)
        named = dict(params.named_parameters())
        names = [n for n, _, _ in moe_weights.leaf_specs(dims)]
        if set(named) != set(names):
            raise RuntimeError(
                f"leaves differ: {sorted(set(named) ^ set(names))}")
        with torch.no_grad():
            for name, full in moe_weights.leaves(dims, names, seed, dev):
                p = named[name]
                p.copy_(distribute_tensor(full, mesh, p.placements,
                                          src_data_rank=None))
                del full
        _sync(dev)
        phases["model"] = time.time() - started
        opt = _optimizer(train)
        state = opt.init(named)
        step_fn = _faulty(make_train_step(cfg, opt, tr["microbatches"]),
                          fault, cfg)
        pipe = TokenPipeline(cfg, tr["batch"], tr["seq"], seed=seed,
                             device=dev, zipf_exponent=tr["zipf_exponent"])
        feed = iter(pipe.batches(MAX_STEPS))

        def shard(raw):
            return shard_batch(_half(raw) if fault == "half_batch" else raw,
                               mesh)

        losses, mismatch = [], 0
        for i in range(tr["compare_steps"]):
            raw = next(feed)
            want = token_batches.host_batch(
                dims.vocab, tr["zipf_exponent"], tr["batch"], tr["seq"],
                seed, i)
            mismatch += sum(not np.array_equal(raw[k].cpu().numpy(),
                                               want[k]) for k in want)
            params, state, m = step_fn(params, state, shard(raw))
            losses.append(_value(m["loss"]))
            if i == 0:
                # AdamW's first moment after one step is (1 - b1) g
                grad = _norms(state["m"], 1.0 / (1.0 - train["b1"]))
            phases[f"step{i + 1}"] = time.time() - started
        change: Dict[str, float] = {}
        for name, full in moe_weights.leaves(dims, names, seed, dev):
            p = named[name]
            start = distribute_tensor(full, mesh, p.placements,
                                      src_data_rank=None)
            change.update(_norms({name: p.float() - start.float()}))
            del full, start
        # one step settles the allocator after the readings' buffers, and
        # a second, steady one sizes the window (at the slowest rank)
        params, state, _ = step_fn(params, state, shard(next(feed)))
        _sync(dev)
        t0 = time.perf_counter()
        params, state, _ = step_fn(params, state, shard(next(feed)))
        _sync(dev)
        step_s = _agree_max(time.perf_counter() - t0, dev)
        phases["warm"] = time.time() - started
        n = min(MAX_STEPS, max(2, math.ceil(seconds / max(step_s, 1e-6))))
        setup_s = time.time() - started

        clock, waits, window_losses = _Clock(dev), [], []
        retries = _alloc_retries(dev)
        t0 = time.perf_counter()
        clock.mark()
        for _ in range(n):
            tw = time.perf_counter()
            raw = next(feed)
            waits.append(time.perf_counter() - tw)
            params, state, m = step_fn(params, state, shard(raw))
            clock.mark()
            window_losses.append(m["loss"])
        _sync(dev)
        window_s = _agree_max(time.perf_counter() - t0, dev)
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        phases["reserved_bytes"] = (torch.cuda.max_memory_reserved(dev)
                                    if dev.type == "cuda" else 0)
        phases["window_alloc_retries"] = _alloc_retries(dev) - retries
        nonfinite = sum(not math.isfinite(_value(x)) for x in window_losses)
        step_ms = clock.step_ms()

        trace = None
        if traced:
            def body() -> int:
                nonlocal params, state
                for _ in range(tr["traced_steps"]):
                    with span("input_wait"):
                        raw = next(feed)
                    with span("step"):
                        params, state, _ = step_fn(params, state, shard(raw))
                with span("window_end"):
                    _sync(dev)
                return tr["traced_steps"]
            _sync(dev)
            trace = profile(body)
    run = MeshRun(dims=dims, traffic=tr, steps=n, window_s=window_s,
                  tokens_per_step=tr["batch"] * tr["seq"], step_ms=step_ms,
                  input_wait_s=waits, peak_bytes=peak, setup_s=setup_s,
                  trace=trace, ranks=world)
    out = {"losses": losses, "grad": grad, "change": change,
           "batch_mismatch": mismatch, "nonfinite": nonfinite,
           "phases": phases, "run": run}
    if trace is not None:
        run.moe_counters = _counts_over_ranks(run, dev)
        if rank == 0:
            phases["spans"] = _span_table(run)
            out["per_layer"] = spec.read_metrics(cell["per_layer"], run)
            out["busy_s"] = busy(trace)
            out["traced_window_s"] = trace.window_s
            out["breakdown"] = breakdown(trace)
    del params, state, step_fn, feed, pipe, window_losses, named
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _span_table(run: MeshRun) -> Dict[str, List[float]]:
    """Rank 0's traced steps by program span: ``[count, device ms, host
    ms]`` a step (means), for the record's phases."""
    got = program.steps(run)
    if not got:
        return {}
    table: Dict[str, List[float]] = {}
    for step in got:
        for e in [step.top] + step.spans:
            row = table.setdefault(e["name"], [0.0, 0.0, 0.0])
            row[0] += 1 / len(got)
            row[1] += e["device_ms"] / len(got)
            row[2] += e["host_ms"] / len(got)
    return table


def _counts_over_ranks(run: MeshRun, dev) -> Optional[Dict[str, int]]:
    """The traced steps' forward MoE counters summed over the ranks (None
    where some rank's program counts none)."""
    import torch
    import torch.distributed as dist
    mine = forward_counts(run)
    t = torch.tensor([1 if mine else 0] + [mine[k] if mine else 0
                                           for k in MOE_COUNTERS],
                     dtype=torch.int64, device=dev)
    dist.all_reduce(t)
    vals = t.tolist()
    if vals[0] != dist.get_world_size():
        return None
    return dict(zip(MOE_COUNTERS, vals[1:]))


def reference(cell, seed, dev, rank, precision: str = "f32"
              ) -> Dict[str, Any]:
    """The plain reference's compared step on this rank's rows, one
    layer's weights at a time: the loss, and each leaf's first gradient
    norm and change norm, summed over the ranks.  ``precision="fp8"`` is
    the control (the weights in the configuration's bf16)."""
    import torch
    import torch.distributed as dist
    from perfbench.reference import lm as ref_lm
    from perfbench.reference import moe as ref
    tr, dims = cell["traffic"], from_arch(cell["config"]["arch"])
    train = cell["config"]["train"]
    if tr["compare_steps"] != 1:
        raise ValueError("the blocked reference compares one step")
    # the rows of this rank's place on 'data' (the mesh is (data, model)
    # in rank order); the model ranks of one place share them, so each
    # counts 1 / model of their loss
    data, model = tr["mesh"]
    rows, at = tr["batch"] // data, rank // model
    host = token_batches.host_batch(dims.vocab, tr["zipf_exponent"],
                                    tr["batch"], tr["seq"], seed, 0)
    mine = {k: torch.from_numpy(v[at * rows:(at + 1) * rows]).to(dev)
            for k, v in host.items()}
    dtype = torch.float32 if precision == "f32" else torch.bfloat16

    def make(name: str) -> torch.Tensor:
        return moe_weights.leaf(dims, name, seed, dev).to(dtype)

    grad: Dict[str, torch.Tensor] = {}
    change: Dict[str, torch.Tensor] = {}

    def on_grads(gs: Dict[str, torch.Tensor]) -> None:
        for k, g in gs.items():
            dist.all_reduce(g)
            grad[k] = torch.linalg.vector_norm(g)
            change[k] = torch.linalg.vector_norm(
                ref.first_change(make(k), g, train))
            gs[k] = None
            del g

    with ref_lm.exact_f32():
        outer = {k: make(k) for k in ref.OUTER}
        value = ref.blocked_value_and_grad(
            dims, mine, lambda i: {n: make(n) for n in ref.layer_names(
                dims, i)}, outer, on_grads, precision,
            scale=rows / (tr["batch"] * model))
    del outer
    total = torch.tensor([value], dtype=torch.float64, device=dev)
    dist.all_reduce(total)
    names = list(grad)
    out = {"losses": [float(total.item())],
           "grad": dict(zip(names, torch.stack(
               [grad[k] for k in names]).tolist())),
           "change": dict(zip(names, torch.stack(
               [change[k] for k in names]).tolist()))}
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _rank_record(job: Dict[str, Any], rank: int) -> Dict[str, Any]:
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    cell, world = job["cell"], job["world"]
    tr = cell["traffic"]
    cpu = job["device"] == "cpu"
    if cpu:
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo" if cpu else "nccl",
        init_method=f"tcp://127.0.0.1:{job['port']}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=COLLECTIVE_S))
    try:
        mesh = make_local_mesh(data=tr["mesh"][0], model=tr["mesh"][1],
                               device_type=dev.type)
        if job["mode"] == "control":
            prog = reference(cell, job["seed"], dev, rank, "fp8")
            prog.update(batch_mismatch=0, nonfinite=0, phases={})
            run = None
        else:
            prog = _program(cell, job["seed"], job["seconds"],
                            job["traced"], dev, mesh, job["started"],
                            job["fault"], rank, world)
            run = prog.pop("run")
        refd = reference(cell, job["seed"], dev, rank)
        rec: Dict[str, Any] = {"rank": rank,
                               "forbidden": imports.forbidden()}
        if run is None:
            rec.update(setup_s=0.0, window_s=0.0, steps=0, step_ms=[],
                       input_wait_s=[], peak_bytes=0)
        else:
            rec.update(setup_s=run.setup_s, window_s=run.window_s,
                       steps=run.steps, step_ms=run.step_ms,
                       input_wait_s=run.input_wait_s,
                       peak_bytes=run.peak_bytes,
                       reserved_bytes=prog["phases"]["reserved_bytes"])
        if rank == 0:
            per_layer = {k: prog.pop(k) for k in
                         ("per_layer", "busy_s", "traced_window_s",
                          "breakdown") if k in prog}
            rec.update(per_layer)
            rec.update(nonfinite=prog["nonfinite"],
                       numbers=numbers(prog, refd),
                       phases=prog.pop("phases"),
                       readings={"program": prog, "reference": refd},
                       device_kind=(torch.cuda.get_device_name(dev)
                                    if dev.type == "cuda" else "cpu"))
        return rec
    finally:
        dist.destroy_process_group()


def _die_with_parent(parent: int) -> None:
    """Have the kernel kill this rank when the process that started it
    ends (Linux ``prctl(PR_SET_PDEATHSIG, SIGKILL)``), so a killed run
    leaves no rank on a card; then make sure it has not ended already."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(1)


def _rank_main(argv: List[str]) -> int:
    _die_with_parent(int(argv[2]))
    job = json.loads(Path(argv[0]).read_text())
    rank = int(argv[1])
    rec = _rank_record(job, rank)
    path = Path(job["out"]) / f"rank{rank}.json"
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(rec))
    os.replace(tmp, path)
    return 0


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1:]))
