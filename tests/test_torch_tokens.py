"""The port's ``TokenPipeline`` against the reference's on the CPU.

The load stage draws each step's batch from ``default_rng(seed + step)``
with numpy in both packages, so the batches are bit-equal for every
frontend (text's zipf tokens, the audio stub's frame embeddings, the vision
stub's prefix); the transfer stage hands them over as tensors on the
pipeline's device, at every prefetch depth.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.data import TokenPipeline as RefPipeline
from repro_torch.configs import ARCHS
from repro_torch.data import TokenPipeline

STEPS = 5
FRONTENDS = {"none": "llama3.2-1b", "audio_stub": "musicgen-medium",
             "vision_stub": "internvl2-1b"}


def _cfgs(frontend):
    arch = FRONTENDS[frontend]
    ref, port = REF_ARCHS[arch][1], ARCHS[arch][1]
    assert ref.frontend == port.frontend == frontend
    if frontend == "vision_stub":       # a prefix shorter than the sequence
        ref = dataclasses.replace(ref, vision_tokens=8)
        port = dataclasses.replace(port, vision_tokens=8)
    return ref, port


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("frontend", sorted(FRONTENDS))
def test_batches_bit_equal_to_reference(frontend, depth):
    rcfg, pcfg = _cfgs(frontend)
    ref = RefPipeline(rcfg, batch=3, seq=24, seed=7, depth=depth)
    port = TokenPipeline(pcfg, batch=3, seq=24, seed=7, depth=depth,
                         device="cpu")
    got = list(port.batches(STEPS))
    want = list(ref.batches(STEPS))
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key, t in g.items():
            a = np.asarray(jax.device_get(w[key]))
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            assert t.numpy().dtype == a.dtype and t.shape == a.shape, key
            assert np.array_equal(t.numpy(), a), key


@pytest.mark.parametrize("frontend", sorted(FRONTENDS))
def test_host_batch_bit_equal_to_reference(frontend):
    rcfg, pcfg = _cfgs(frontend)
    ref = RefPipeline(rcfg, batch=2, seq=16, seed=3, depth=0)
    port = TokenPipeline(pcfg, batch=2, seq=16, seed=3, depth=0,
                         device="cpu")
    for step in range(STEPS):
        w, g = ref._make_host_batch(step), port._make_host_batch(step)
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key].dtype == w[key].dtype
            assert np.array_equal(g[key], w[key]), (step, key)


def test_batches_start_at_a_step():
    """``start`` resumes the stream: step i's batch whatever came before."""
    _, pcfg = _cfgs("none")
    pipe = TokenPipeline(pcfg, batch=2, seq=16, seed=1, depth=2,
                         device="cpu")
    whole = list(pipe.batches(6))
    tail = list(pipe.batches(3, start=3))
    for g, w in zip(tail, whole[3:]):
        assert torch.equal(g["tokens"], w["tokens"])


def test_token_pipeline_default_device_requires_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TokenPipeline(ARCHS["llama3.2-1b"][1], batch=1, seq=8)
