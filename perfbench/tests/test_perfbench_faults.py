"""The harness's run with its look for cards skipped, at a tiny size on
the CPU: sound, it comes out correct; with the timed path broken
underneath, ``correct`` comes out false, once for each fault the cell
can have.  (A training cell produces no token or answer of its own to
alter: its product is the step's state, which the first fault covers;
a cell on one card has no exchange between cards to leave out.)"""
import time

import pytest

from perfbench import run as bench
from perfbench.tests.tiny import tiny_cell

SEED = 2**31 + 4242


def _measure(fault=None):
    return bench.measure(tiny_cell(), SEED, 0.0, False, time.time(),
                         device="cpu", fault=fault)


def test_sound_run_is_correct():
    res = _measure()
    assert res["correct"] is True
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"train_tokens_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_broken_step_is_not_correct(fault):
    res = _measure(fault)
    assert res["correct"] is False
    failed = [k for k, c in res["checks"].items()
              if c["limit"] is not None and c["value"] > c["limit"]]
    assert failed


def test_refuses_without_a_card(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = bench.main(["--workload", "musicgen-medium.clips-30s", "--seed",
                     "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
