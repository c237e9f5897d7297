"""The readers of the program's own spans (``harness/program.py`` and the
nine metrics on it) over a traced run of the tiny cell on the CPU."""
import statistics
import time

import pytest

from perfbench import run as bench
from perfbench.harness import program
from perfbench.tests.tiny import tiny_cell

SEED = 2**31 + 5151
SPAN_METRICS = ("forward_ms", "loss_ms", "backward_ms", "recompute_ms",
                "attn_vjp_ms", "optimizer_ms", "optimizer_idle_pct",
                "feed_wait_ms", "alloc_retries")
PARTS = ("lm.forward", "lm.loss", "lm.backward", "optim.step")


@pytest.fixture
def seen(monkeypatch):
    """Every list of steps the readers were handed, in order."""
    out = []
    real = program.steps

    def spy(run):
        got = real(run)
        out.append(got)
        return got
    monkeypatch.setattr(program, "steps", spy)
    return out


def _traced(layers=2, seed=SEED):
    cell = tiny_cell()
    cell["config"]["arch"]["num_hidden_layers"] = layers
    return bench.measure(cell, seed, 0.0, True, time.time(), device="cpu")


def test_traced_run_reports_every_span_metric(seen):
    res = _traced()
    assert res["correct"] is True
    got = res["metrics"]
    for name in SPAN_METRICS:
        assert got[name]["value"] is not None, name
        assert got[name]["value"] >= 0, name
    assert got["alloc_retries"]["value"] == 0          # no CUDA
    assert 0 <= got["optimizer_idle_pct"]["value"] <= 100
    steps = seen[-1]
    assert len(steps) == tiny_cell()["traffic"]["traced_steps"]
    for key, span in (("forward_ms", "lm.forward"),
                      ("optimizer_ms", "optim.step")):
        assert got[key]["value"] == pytest.approx(
            statistics.median(s.device_ms(span) for s in steps))


def test_parts_add_up_to_the_step(seen):
    _traced()
    for s in seen[-1]:
        parts = sum(s.device_ms(n) for n in PARTS)
        top = s.top["device_ms"]
        # the host work between the spans weighs more on a tiny CPU step
        assert 0.8 * top <= parts <= top
        backward = s.device_ms("lm.backward")
        assert s.device_ms("attn.vjp") + sum(
            e["device_ms"] for e in s.named("lm.layer")
            if any(b["start_ns"] <= e["start_ns"] <= e["end_ns"]
                   <= b["end_ns"] for b in s.named("lm.backward"))
        ) <= backward


def test_two_runs_in_one_process_read_their_own_steps(seen):
    _traced(layers=2)
    first = seen[-1]
    _traced(layers=3, seed=SEED + 1)
    second = seen[-1]
    assert not {s.top["step"] for s in first} & {
        s.top["step"] for s in second}
    for steps, layers in ((first, 2), (second, 3)):
        for s in steps:
            assert len(s.named("lm.layer")) == 2 * layers   # remat
            assert len(s.named("attn.vjp")) == layers
            assert len(s.named("pipeline.wait")) == 1
            assert len(s.named("optim.step")) == 1


@pytest.mark.parametrize("lows,highs,want", [
    ([0.0, 2e-5, 1e-5], [1e-4, 9e-5, 3e-4], 5.5e-5),   # the tightest pair
    ([0.0, 5e-4], [1e-4, 6e-4], None),                   # contradict
    ([0.0, 1e-5], [2.5e-4, 3e-4], None),                 # unsure by 0.125 ms
])
def test_clock_offset_from_the_tightest_anchors(monkeypatch, lows, highs,
                                                 want):
    monkeypatch.setattr(program, "anchors", lambda run: (lows, highs))
    got = program.clock_offset(None)
    assert got == (None if want is None else pytest.approx(want))
