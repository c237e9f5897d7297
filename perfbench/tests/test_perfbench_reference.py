"""The plain reference against a tiny run of the port on the CPU, and the
benchmark's inputs against the port's: the same weights' names and
shapes, batches bit for bit."""
import time

import numpy as np
import pytest
import torch

from perfbench.drivers import lm_train
from perfbench.harness import batches, weights
from perfbench.harness.dims import from_arch
from perfbench.reference import lm as ref
from perfbench.tests.tiny import tiny_cell

SEED = 2**31 + 977


def test_reference_follows_the_port_in_f32():
    cell = tiny_cell()
    nums = lm_train.run(cell, SEED, 0.0, False, started=time.time(),
                        device="cpu")["numbers"]
    assert nums["batch_mismatch"] == 0 and nums["nonfinite"] == 0
    assert nums["loss_gap"] < 1e-5
    assert nums["grad_gap"] < 1e-4
    assert nums["change_gap"] < 1e-3


def test_weights_fit_the_port():
    from repro_torch.models import init_params
    cell = tiny_cell()
    dims = from_arch(cell["config"]["arch"])
    model = init_params(lm_train._model_config(cell),
                        torch.Generator().manual_seed(0), "cpu")
    mine = weights.make(dims, SEED, torch.device("cpu"), torch.float32)
    theirs = dict(model.named_parameters())
    assert list(mine) == list(theirs)
    assert all(mine[k].shape == theirs[k].shape for k in mine)
    again = weights.make(dims, SEED, torch.device("cpu"), torch.float32)
    assert all(torch.equal(mine[k], again[k]) for k in mine)


@pytest.mark.parametrize("step", [0, 3])
def test_batches_are_the_pipelines(step):
    from repro_torch.data import TokenPipeline
    cell = tiny_cell()
    tr = cell["traffic"]
    pipe = TokenPipeline(lm_train._model_config(cell), tr["batch"],
                         tr["seq"], seed=SEED, depth=0, device="cpu")
    got = next(iter(pipe.batches(1, start=step)))
    want = batches.host_batch(from_arch(cell["config"]["arch"]),
                              tr["batch"], tr["seq"], SEED, step)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), want[k])


@pytest.mark.parametrize("key,value", [
    ("kind", "moe"), ("activation_function", "silu"), ("frontend", "none"),
    ("sliding_window", 16)])
def test_architectures_the_reference_cannot_follow_are_refused(key, value):
    arch = dict(tiny_cell()["config"]["arch"], **{key: value})
    with pytest.raises(ValueError, match=key):
        from_arch(arch)


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(4096, dtype=torch.float32)
    bf = (x.to(torch.bfloat16).float() - x).abs().max()
    f8 = (ref._round_fp8(x, torch.float8_e4m3fn, 448.0) - x).abs().max()
    assert f8 > 4 * bf


def test_exact_f32_restores_the_flags():
    before = torch.backends.cuda.matmul.allow_tf32
    with ref.exact_f32():
        assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 == before
