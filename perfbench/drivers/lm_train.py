"""Driver of LM training cells: the port's ``make_train_step`` fed by its
``TokenPipeline``, on one card.

One run:

1. set-up: the configuration's model (``repro_torch.models.init_params``)
   loaded with the benchmark's weights for the seed, its optimizer state
   and train step, the pipeline; then the compared steps through the
   window's own step and feed (each batch checked bit for bit against the
   benchmark's own), the first gradient read from the optimizer's state
   after step 1 and the parameters' change after the last compared step;
2. the window: as many further steps as fill ``seconds`` at the last
   compared step's time, a device event at each boundary, the host's wait
   for each batch timed, one synchronize at the end;
3. with ``traced``, a few more steps under the profiler;
4. the program freed, the plain f32 reference runs the compared steps on
   the same weights and batches, and the judge compares.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from perfbench.harness import batches, judge, spec, weights
from perfbench.harness.dims import from_arch
from perfbench.harness.record import Run
from perfbench.harness.trace import breakdown, busy, profile, span
from perfbench.reference import lm as ref

FAULTS = ("state_unchanged", "half_batch")
MAX_STEPS = 100_000
REF_TOKENS = 16_384       # tokens in one block of the reference's rows


def _model_config(cell: Dict[str, Any]):
    from repro_torch.models.lm import ModelConfig
    a = cell["config"]["arch"]
    d = from_arch(a)
    return ModelConfig(         # from_arch has checked kind and frontend
        name=cell["config"]["name"], kind=a["kind"], n_layers=d.layers,
        d_model=d.d, n_heads=d.heads, n_kv=d.kv_heads, d_ff=d.ff,
        vocab=d.vocab, head_dim=d.head_dim, window=0, mlp="gelu",
        rope_theta=d.rope_theta, norm_eps=d.eps, dtype=a["dtype"],
        frontend=a["frontend"], remat=a["remat"], q_block=a["q_block"],
        attn_impl=a["attn_impl"])


def _optimizer(train: Dict[str, Any]):
    from repro_torch.optim import adamw, cosine_warmup_schedule
    if train["optimizer"] != "adamw":
        raise ValueError(f"optimizer {train['optimizer']!r}")
    sched = cosine_warmup_schedule(train["lr"], train["warmup_steps"],
                                   train["total_steps"], train["min_ratio"])
    return adamw(sched, b1=train["b1"], b2=train["b2"], eps=train["eps"],
                 weight_decay=train["weight_decay"])


def _norms(leaves: Dict[str, torch.Tensor], scale: float = 1.0
           ) -> Dict[str, float]:
    vals = [torch.linalg.vector_norm(t, dtype=torch.float32)
            for t in leaves.values()]
    return dict(zip(leaves, (torch.stack(vals) * scale).tolist()))


def _change_norms(current: Dict[str, torch.Tensor],
                  start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    vals = [torch.linalg.vector_norm(p.float() - start[k].float())
            for k, p in current.items()]
    return dict(zip(current, torch.stack(vals).tolist()))


def _first_grad_norms(state: Dict[str, Any],
                      train: Dict[str, Any]) -> Dict[str, float]:
    """The first gradient as the optimizer got it, from its state after
    one step: AdamW's first moment is then (1 - b1) g."""
    return _norms(state["m"], 1.0 / (1.0 - train["b1"]))


class _Clock:
    """Window step times: device events on a card, the host clock on the
    CPU (where the host waits for every operation anyway)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List[Any] = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def step_ms(self) -> List[float]:
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _alloc_retries(device: torch.device) -> int:
    """Times the caching allocator freed its cache and synchronized to
    retry an allocation."""
    if device.type != "cuda":
        return 0
    return torch.cuda.memory_stats(device).get("num_alloc_retries", 0)


def _rows(batch: Dict[str, Any], lo: int, hi: int) -> Dict[str, Any]:
    return {k: v[lo:hi] for k, v in batch.items()}


def _faulty(step_fn, fault: Optional[str], cfg, batch_rows: int):
    """The timed path broken underneath, for the harness's own tests and
    the faults' readings."""
    if fault is None:
        return step_fn
    if fault == "state_unchanged":
        from repro_torch.models import value_and_grad

        def unchanged(params, state, batch):
            loss, metrics, _ = value_and_grad(params, cfg, batch)
            return params, state, dict(metrics, loss=loss)
        return unchanged
    if fault == "half_batch":
        return lambda params, state, batch: step_fn(
            params, state, _rows(batch, 0, batch_rows // 2))
    raise ValueError(f"fault {fault!r}; have {FAULTS}")


def _program(cell: Dict[str, Any], seed: int, seconds: float, traced: bool,
             device: torch.device, started: float,
             fault: Optional[str]) -> Dict[str, Any]:
    """Set-up, window and traced stretch; the program's readings for the
    judge and the run's measurements."""
    from repro_torch.data import TokenPipeline
    from repro_torch.models import init_params, make_train_step
    tr, dims = cell["traffic"], from_arch(cell["config"]["arch"])
    train = cell["config"]["train"]
    phases = {"imported": time.time() - started}
    cfg = _model_config(cell)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        seed), device)
    start = weights.make(dims, seed, device)
    named = dict(params.named_parameters())
    if set(named) != set(start):
        raise RuntimeError(f"leaves differ: {sorted(set(named) ^ set(start))}")
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(start[k])
    del start, named
    _sync(device)
    phases["model"] = time.time() - started
    opt = _optimizer(train)
    state = opt.init(dict(params.named_parameters()))
    step_fn = _faulty(make_train_step(cfg, opt, tr["microbatches"]),
                      fault, cfg, tr["batch"])
    pipe = TokenPipeline(cfg, tr["batch"], tr["seq"], seed=seed,
                         device=device)
    feed = iter(pipe.batches(MAX_STEPS))

    losses, mismatch = [], 0
    for i in range(tr["compare_steps"]):
        batch = next(feed)
        want = batches.host_batch(dims, tr["batch"], tr["seq"], seed, i)
        mismatch += sum(not np.array_equal(batch[k].cpu().numpy(), want[k])
                        for k in want)
        params, state, m = step_fn(params, state, batch)
        losses.append(float(m["loss"]))
        if i == 0:
            grad = _first_grad_norms(state, train)
        phases[f"step{i + 1}"] = time.time() - started
    start = weights.make(dims, seed, device)
    change = _change_norms(dict(params.named_parameters()), start)
    # one step settles the allocator after the readings' buffers, and
    # a second, steady one sizes the window
    del start
    params, state, _ = step_fn(params, state, next(feed))
    _sync(device)
    t0 = time.perf_counter()
    params, state, _ = step_fn(params, state, next(feed))
    _sync(device)
    step_s = time.perf_counter() - t0
    phases["warm"] = time.time() - started
    n = min(MAX_STEPS, max(2, math.ceil(seconds / max(step_s, 1e-6))))
    _sync(device)
    setup_s = time.time() - started

    clock, waits, window_losses = _Clock(device), [], []
    retries = _alloc_retries(device)
    t0 = time.perf_counter()
    clock.mark()
    for _ in range(n):
        tw = time.perf_counter()
        batch = next(feed)
        waits.append(time.perf_counter() - tw)
        params, state, m = step_fn(params, state, batch)
        clock.mark()
        window_losses.append(m["loss"])
    _sync(device)
    window_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    phases["window_alloc_retries"] = _alloc_retries(device) - retries
    nonfinite = sum(not math.isfinite(float(x)) for x in window_losses)
    step_ms = clock.step_ms()

    trace = None
    if traced:
        def body() -> int:
            nonlocal params, state
            for _ in range(tr["traced_steps"]):
                with span("input_wait"):
                    batch = next(feed)
                with span("step"):
                    params, state, _ = step_fn(params, state, batch)
            with span("window_end"):
                _sync(device)
            return tr["traced_steps"]
        _sync(device)
        trace = profile(body)
    del params, state, step_fn, feed, pipe, window_losses
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    run = Run(dims=dims, traffic=tr, steps=n, window_s=window_s,
              tokens_per_step=tr["batch"] * tr["seq"],
              step_ms=step_ms, input_wait_s=waits, peak_bytes=peak,
              setup_s=setup_s, trace=trace)
    return {"run": run, "losses": losses, "grad": grad, "change": change,
            "batch_mismatch": mismatch, "nonfinite": nonfinite,
            "phases": phases}


def _chunk_rows(rows: int, seq: int) -> int:
    """The reference's block of rows: the most that divide ``rows`` and
    hold at most ``REF_TOKENS`` tokens (at least one row)."""
    best = 1
    for n in range(1, rows + 1):
        if rows % n == 0 and n * seq <= REF_TOKENS:
            best = n
    return best


def reference(cell: Dict[str, Any], seed: int, device: torch.device,
              precision: str = "f32", keep: Optional[int] = None
              ) -> Dict[str, Any]:
    """The plain reference's compared steps: its losses, first gradient
    norms and change norms.  ``precision="fp8"`` is the control, which
    also keeps the weights in the configuration's bf16.  ``keep`` trains
    on the batch's first ``keep`` rows only: the reference put in the
    program's place with half the batch."""
    tr, dims = cell["traffic"], from_arch(cell["config"]["arch"])
    rows = tr["batch"] if keep is None else keep
    per_chunk = _chunk_rows(rows, tr["seq"])
    with ref.exact_f32():
        w = weights.make(dims, seed, device)
        if precision == "f32":
            w = {k: v.float() for k, v in w.items()}
        else:
            w = {k: v.clone() for k, v in w.items()}
        opt = ref.Optimizer(cell["config"]["train"], w)
        losses, grad = [], None
        for i in range(tr["compare_steps"]):
            host = batches.host_batch(dims, tr["batch"], tr["seq"], seed, i)
            mine = {k: torch.from_numpy(v[:rows]).to(device)
                    for k, v in host.items()}
            chunks = [_rows(mine, j, j + per_chunk)
                      for j in range(0, rows, per_chunk)]
            value, g = ref.value_and_grad(w, dims, chunks, precision)
            losses.append(value)
            if i == 0:
                grad = _norms(g)
            opt.update(w, g)
            del g
        start = weights.make(dims, seed, device)
        change = _change_norms(w, start)
    del w, opt, start
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "grad": grad, "change": change}


def run(cell: Dict[str, Any], seed: int, seconds: float, traced: bool, *,
        started: float, fault: Optional[str] = None,
        device: Optional[str] = None) -> Dict[str, Any]:
    """One run on card 0 (or, with ``device="cpu"``, on the host): the
    record the harness reports from."""
    if device == "cpu":
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    prog = _program(cell, seed, seconds, traced, dev, started, fault)
    refd = reference(cell, seed, dev)
    run: Run = prog.pop("run")
    rec = {"setup_s": run.setup_s, "window_s": run.window_s,
           "steps": run.steps, "step_ms": run.step_ms,
           "input_wait_s": run.input_wait_s, "peak_bytes": run.peak_bytes,
           "nonfinite": prog["nonfinite"], "cards": 1,
           "numbers": judge.numbers(prog, refd),
           "phases": prog.pop("phases"),
           "readings": {"program": prog, "reference": refd},
           "device_kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu")}
    if run.trace is not None:
        rec["per_layer"] = spec.read_metrics(cell["per_layer"], run)
        rec["busy_s"] = busy(run.trace)
        rec["traced_window_s"] = run.trace.window_s
        rec["breakdown"] = breakdown(run.trace)
    return rec


def as_run(cell: Dict[str, Any], rec: Dict[str, Any]) -> Run:
    """The record as the end-to-end readers see it."""
    tr = cell["traffic"]
    return Run(dims=from_arch(cell["config"]["arch"]), traffic=tr,
               steps=rec["steps"], window_s=rec["window_s"],
               tokens_per_step=tr["batch"] * tr["seq"],
               step_ms=rec["step_ms"], input_wait_s=rec["input_wait_s"],
               peak_bytes=rec["peak_bytes"], setup_s=rec["setup_s"])
