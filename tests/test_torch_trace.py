"""The port's span recorder (``repro_torch.trace``) on a tiny LM step.

Off (no profiler recording), a step records nothing, enters no profiler
range, makes no CUDA event and allocates nothing in the recorder.  Under
``torch.profiler.profile`` it records every span at the step's layer
boundaries, each under a profiler range of the same name, and changes no
number of the step.

A span's host interval holds its profiler range.  ``record_function``
spends time of its own outside the timestamps it records: per span name
a median of 13-87 us over its range, and single spans up to 400 us, on
a CPU host running six such tests at once.  So the test puts every range
inside its span under one clock offset, which pairs them exactly, and
bounds each name's median excess by 250 us.

The CUDA cases (device intervals, autograd's thread) skip without a card;
on the card run ``python -m pytest tests/test_torch_trace.py -q``.
"""
import dataclasses
import json
import statistics
import threading
import tracemalloc

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import optim as po
from repro_torch import trace
from repro_torch.configs import ARCHS
from repro_torch.core.pipeline import PipelineItem, PrefetchPipeline, Stage
from repro_torch.data import TokenPipeline
from repro_torch.models import init_params, make_train_step

ARCH = "smollm-135m"           # reduced: 4 dense layers, q_block 32
BATCH, SEQ = 2, 64
STEP_SPANS = ("lm.train_step", "lm.forward", "lm.loss", "lm.backward",
              "lm.layer", "attn.vjp", "optim.step", "pipeline.wait")


@pytest.fixture(autouse=True)
def _fresh_recorder():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    trace.reset()
    yield
    trace.reset()
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device intervals are CUDA events")
    return torch.device("cuda", 0)


def _setup(remat=True, impl="flash", microbatches=1, device="cpu"):
    cfg = dataclasses.replace(ARCHS[ARCH][1], remat=remat, attn_impl=impl)
    model = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                        device)
    opt = po.adamw(1e-3)
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(cfg, opt, microbatches)
    feed = iter(TokenPipeline(cfg, BATCH, SEQ, seed=1, depth=0,
                              device=device).batches(1000))
    return cfg, model, state, step, feed


def _run(step, model, state, feed, n):
    losses = []
    for _ in range(n):
        model, state, m = step(model, state, next(feed))
        losses.append(m["loss"])
    return model, state, losses


def _profiled(fn, activities=(ProfilerActivity.CPU,)):
    with profile(activities=list(activities)) as prof:
        out = fn()
    return out, prof


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    raw = json.loads(path.read_text())
    return [e for e in raw["traceEvents"]
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def _inside(e, outer):
    return outer["start_ns"] <= e["start_ns"] and e["end_ns"] <= outer[
        "end_ns"]


# ------------------------------------------------------------------- off


def test_off_step_records_nothing_and_makes_no_event(monkeypatch):
    _, model, state, step, feed = _setup()
    made = []
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: made.append("event"))
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: made.append("range"))
    _run(step, model, state, feed, 2)
    assert trace.spans() == [] and trace.summary() == {}
    assert made == [] and trace.dropped() == 0


def test_off_span_is_one_shared_no_op_that_allocates_nothing():
    assert trace.span("lm.forward") is trace.span("lm.forward")
    assert trace.step("cpu") is trace.span(trace.TRAIN_STEP)
    for _ in range(3):                 # the no-op of each name exists
        with trace.span("x"), trace.step("cpu"):
            trace.count("c")
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with trace.span("x"), trace.step("cpu"):
                trace.count("c")
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == trace.__file__ and d.size_diff > 0]
    assert grown == []
    assert trace.spans() == []


# -------------------------------------------------------------------- on


@pytest.mark.parametrize("remat,impl,microbatches", [
    (True, "flash", 1), (False, "flash", 1), (True, "blocked", 1),
    (True, "flash", 2)])
def test_profiled_step_records_each_span(remat, impl, microbatches):
    cfg, model, state, step, feed = _setup(remat, impl, microbatches)
    _profiled(lambda: _run(step, model, state, feed, 1))
    got = trace.spans()
    names = [e["name"] for e in got]
    n, mb = cfg.n_layers, microbatches
    want = {"lm.train_step": 1, "lm.forward": mb, "lm.loss": mb,
            "lm.backward": mb, "lm.layer": n * mb * (2 if remat else 1),
            "attn.vjp": n * mb if impl == "flash" else 0, "optim.step": 1,
            "pipeline.wait": 1}
    assert {k: names.count(k) for k in STEP_SPANS} == want
    assert set(names) <= set(STEP_SPANS)
    top = next(e for e in got if e["name"] == "lm.train_step")
    assert top["counters"] == {"alloc_retries": 0}
    backs = [e for e in got if e["name"] == "lm.backward"]
    layers = [e for e in got if e["name"] == "lm.layer"]
    recomputed = [e for e in layers if any(_inside(e, b) for b in backs)]
    assert len(recomputed) == (n * mb if remat else 0)
    for e in got:
        if e["name"] == "pipeline.wait":
            assert e["step"] == top["step"] and e["end_ns"] <= top["start_ns"]
            continue
        assert e["step"] == top["step"]
        if e is not top:
            assert _inside(e, top)
    for e in recomputed + [e for e in got if e["name"] == "attn.vjp"]:
        assert any(_inside(e, b) for b in backs)
    for e in got:
        assert e["device_ms"] == e["host_ms"] > 0     # no CUDA device


def test_parents_and_step_ordinals():
    _, model, state, step, feed = _setup(remat=False, impl="blocked")
    _profiled(lambda: _run(step, model, state, feed, 2))
    got = trace.spans()
    by_id = {e["id"]: e for e in got}
    tops = [e for e in got if e["name"] == "lm.train_step"]
    assert [t["step"] for t in tops] == [tops[0]["step"], tops[0]["step"] + 1]
    assert all(t["parent"] is None for t in tops)
    for e in got:
        parent = by_id.get(e["parent"])
        if e["name"] in ("lm.forward", "lm.backward", "optim.step"):
            assert parent["name"] == "lm.train_step"
        if e["name"] == "lm.layer":
            assert parent["name"] == "lm.forward"
        if parent is not None:
            assert _inside(e, parent) and parent["step"] == e["step"]


def test_every_span_has_its_profiler_range(tmp_path):
    """Every span has a ``user_annotation`` of its name, in the same
    number; one clock offset puts each range inside its span; each name's
    median duration exceeds its ranges' by at most 250 us."""
    _, model, state, step, feed = _setup()
    _run(step, model, state, feed, 1)        # first-call costs out of it
    _, prof = _profiled(lambda: _run(step, model, state, feed, 3))
    got = trace.spans()
    ranges = _annotations(prof, tmp_path)
    assert len(got) == len(ranges)
    lo, hi, excess = [], [], {}
    for name in STEP_SPANS:
        mine = [e for e in got if e["name"] == name]
        theirs = sorted((r for r in ranges if r["name"] == name),
                        key=lambda r: r["ts"])
        assert len(mine) == len(theirs) > 0, name
        for e, r in zip(mine, theirs):
            lo.append((r["ts"] + r["dur"]) - e["end_ns"] * 1e-3)
            hi.append(r["ts"] - e["start_ns"] * 1e-3)
            excess.setdefault(name, []).append(e["host_ms"] * 1e3 - r["dur"])
    assert max(lo) <= min(hi)
    for name, xs in excess.items():
        assert min(xs) >= -1.0, name
        assert statistics.median(xs) <= 250.0, (name, xs)


@pytest.mark.parametrize("remat,impl", [(True, "flash"), (False, "blocked")])
def test_profiler_changes_no_number(remat, impl):
    out = {}
    for on in (False, True):
        _, model, state, step, feed = _setup(remat, impl)
        if on:
            (model, state, losses), _ = _profiled(
                lambda: _run(step, model, state, feed, 3))
        else:
            model, state, losses = _run(step, model, state, feed, 3)
        out[on] = (dict(model.named_parameters()), losses)
    assert len(trace.spans()) > 0
    for k, p in out[False][0].items():
        assert torch.equal(p, out[True][0][k]), k
    assert all(torch.equal(a, b) for a, b in zip(out[False][1], out[True][1]))


# --------------------------------------------------------- the recorder


def test_decorator_decides_at_each_call():
    @trace.span("work")
    def work(x):
        trace.count("items", x)
        return x + 1

    assert work(1) == 2 and trace.spans() == []
    (value, _), _ = _profiled(lambda: (work(2), work(3)))
    got = trace.spans()
    assert value == 3 and [e["name"] for e in got] == ["work", "work"]
    assert [e["counters"] for e in got] == [{"items": 2}, {"items": 3}]
    assert trace.summary()["work"]["items"] == 5
    assert trace.summary()["work"]["count"] == 2


def test_count_goes_to_the_innermost_span():
    def body():
        trace.count("outside")                 # no open span: dropped
        with trace.span("outer"):
            trace.count("n")
            with trace.span("inner"):
                trace.count("n", 4)
            trace.count("n")
    _profiled(body)
    got = {e["name"]: e for e in trace.spans()}
    assert got["outer"]["counters"] == {"n": 2}
    assert got["inner"]["counters"] == {"n": 4}
    assert got["inner"]["parent"] == got["outer"]["id"]


def test_a_span_left_by_an_exception_is_kept_and_closed():
    def body():
        with pytest.raises(ValueError):
            with trace.span("outer"):
                with trace.span("failing"):
                    raise ValueError("stop")
        with trace.span("after"):
            pass
    _profiled(body)
    got = {e["name"]: e for e in trace.spans()}
    assert set(got) == {"outer", "failing", "after"}
    assert got["after"]["parent"] is None


def test_buffer_keeps_the_newest_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 4)
    monkeypatch.setattr(trace, "_REC", trace._Recorder())

    def body():
        for i in range(6):
            with trace.span(f"s{i}"):
                pass
    _profiled(body)
    assert [e["name"] for e in trace.spans()] == ["s2", "s3", "s4", "s5"]
    assert trace.dropped() == 2
    trace.reset()
    assert trace.spans() == [] and trace.dropped() == 0


def test_threads_started_before_the_profile_record_nothing():
    """The pipeline's stage threads start before the profile and are not
    in its trace; only the consumer's wait is recorded, on its thread,
    once an item, never open while the consumer works."""
    seen = []

    def stage_span(item):
        with trace.span("stage"):
            seen.append(threading.get_ident())
        return item
    run = PrefetchPipeline([Stage("load", stage_span)], depth=2).run(
        PipelineItem(seq=i, payload=i) for i in range(4))
    next(run)                                  # the stage thread runs

    def body():
        for item in run:
            with trace.span("consume"):
                pass
    _profiled(body)
    got = trace.spans()
    names = [e["name"] for e in got]
    assert "stage" not in names and seen
    assert names.count("pipeline.wait") == 4  # three items and the end
    waits = [e for e in got if e["name"] == "pipeline.wait"]
    assert {e["thread"] for e in got} == {threading.get_ident()}
    for c in (e for e in got if e["name"] == "consume"):
        assert not any(_inside(c, w) for w in waits)


@pytest.mark.parametrize("depth", [0, 2])
def test_pipeline_wait_once_an_item(depth):
    cfg = ARCHS[ARCH][1]
    pipe = TokenPipeline(cfg, BATCH, SEQ, seed=1, depth=depth, device="cpu")
    batches, _ = _profiled(lambda: list(pipe.batches(3)))
    waits = [e for e in trace.spans() if e["name"] == "pipeline.wait"]
    assert len(batches) == 3 and len(waits) == 4   # three and the end
    assert all(e["parent"] is None for e in waits)


# ------------------------------------------------------------------ card


def test_card_step_times_each_span_on_the_stream(cuda):
    cfg, model, state, step, feed = _setup(device=cuda)
    _run(step, model, state, feed, 1)
    torch.cuda.synchronize(cuda)
    acts = (ProfilerActivity.CPU, ProfilerActivity.CUDA)
    _profiled(lambda: _run(step, model, state, feed, 2), acts)
    torch.cuda.synchronize(cuda)
    got = trace.spans()
    main = threading.get_ident()
    tops = [e for e in got if e["name"] == "lm.train_step"]
    assert len(tops) == 2
    for top in tops:
        mine = [e for e in got if e["step"] == top["step"]]
        assert all(e["device_ms"] > 0 for e in mine
                   if e["name"] != "pipeline.wait")
        parts = sum(e["device_ms"] for e in mine if e["name"] in (
            "lm.forward", "lm.loss", "lm.backward", "optim.step"))
        assert 0.8 * top["device_ms"] <= parts <= top["device_ms"] * 1.001
        vjps = [e for e in mine if e["name"] == "attn.vjp"]
        assert len(vjps) == cfg.n_layers
        # the backward of CUDA tensors runs in autograd's device thread
        assert all(e["thread"] != main for e in vjps)
        assert top["counters"]["alloc_retries"] >= 0
