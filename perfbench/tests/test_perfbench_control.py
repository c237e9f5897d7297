"""The control: the plain reference put in the program's place and
computed in fp8, the precision below the configuration's bf16.  On the
CPU at a tiny size its first gradient lies farther from the f32
reference than the bf16 program's does; on the card, at the cell's own
size, the judge with the cell's limits finds it not correct."""
import pytest

from perfbench import control
from perfbench.harness import judge, spec
from perfbench.tests.tiny import tiny_cell

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]

SEEDS = (2**31 + 11, 2**31 + 12)


@pytest.mark.parametrize("seed", SEEDS)
def test_control_reads_farther_than_the_program(seed):
    cell = tiny_cell("bfloat16")
    prog = control.readings(cell, seed, "program", device="cpu")
    ctl = control.readings(cell, seed, "control", device="cpu")
    assert ctl["grad_gap"] > 3 * prog["grad_gap"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(card, name):
    cell = spec.cell(name)
    for seed in (101, 102, 103):
        nums = control.readings(cell, seed, "control")
        ok, _ = judge.verdict(nums, cell["limits"])
        assert not ok, (seed, nums)
