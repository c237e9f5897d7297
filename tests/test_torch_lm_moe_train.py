"""Training steps of the MoE, sliding-window and stub-frontend models
against the JAX reference on the CPU: the reduced configs of
mixtral-8x22b, llama4-scout, musicgen-medium and internvl2-1b in f32,
SGD with momentum and AdamW under the cosine schedule, one-shot and
microbatched.  The fixtures and tolerances are those of
``tests/test_torch_lm_moe.py`` (kept in a file of its own so the two
halves run on two test workers):

* SGD parameters within 1e-6 after 1 and 3 steps; AdamW by
  ``assert_adam_params_close`` (each weight moves ~lr per step whatever
  its gradient's size); each step's loss and aux within 1e-5;
* microbatched equal to single-shot within the reference's own bounds
  (rtol 1e-5, atol 1e-6, ``tests/test_models_consistency.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as rm
import repro.optim as ro
from repro.configs import ARCHS as REF_ARCHS
from repro_torch import optim as po
from repro_torch.configs import ARCHS
from repro_torch.data import TokenPipeline
from repro_torch.models import init_params, make_train_step
from repro_torch.models.convert import export_params, load_reference_params

ARCHES = ("mixtral-8x22b", "llama4-scout-17b-a16e", "musicgen-medium",
          "internvl2-1b")
SEQ = {"mixtral-8x22b": 128, "llama4-scout-17b-a16e": 64,
       "musicgen-medium": 64, "internvl2-1b": 64}


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two torch threads a test: the suite runs six workers on eight cores,
    and torch's default of one thread a core oversubscribes them several
    times over (its waiting threads spin)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def _leaves(tree):
    return {jax.tree_util.keystr(p): f32(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_trees_close(port_tree, ref_tree, atol):
    got, want = _leaves(port_tree), _leaves(ref_tree)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        assert np.abs(got[name] - w).max() <= atol, name


def assert_adam_params_close(port_tree, ref_tree, lr, steps):
    got, want = _leaves(port_tree), _leaves(ref_tree)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        d = np.abs(got[name] - w)
        assert d.max() <= 2 * lr * steps, (name, d.max())
        assert (d > 1e-3 * lr).mean() <= 1e-3, (name, (d > 1e-3 * lr).mean())
        assert d.mean() <= 1e-4 * lr, (name, d.mean())


def _models(arch, impl="blocked", seed=0, **kw):
    jcfg = dataclasses.replace(REF_ARCHS[arch][1], attn_impl=impl, **kw)
    tcfg = dataclasses.replace(ARCHS[arch][1], attn_impl=impl, **kw)
    jparams = rm.init_params(jax.random.PRNGKey(seed), jcfg)
    model = init_params(tcfg, torch.Generator().manual_seed(seed), "cpu")
    load_reference_params(model, jax.tree.map(f32, jparams))
    return jcfg, tcfg, jparams, model


def _batch(cfg, b, s, seed=0):
    """The training batch ``TokenPipeline`` makes for the config's
    frontend (``embeds`` / ``vision_embeds`` + text tokens / tokens)."""
    return TokenPipeline(cfg, b, s, seed=seed, depth=0,
                         device="cpu")._make_host_batch(0)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


OPT_PAIRS = {
    "sgd": (lambda: ro.sgd(0.1, momentum=0.9),
            lambda: po.sgd(0.1, momentum=0.9), 0.1),
    "adamw": (lambda: ro.adamw(ro.cosine_warmup_schedule(1e-3, 2, 10)),
              lambda: po.adamw(po.cosine_warmup_schedule(1e-3, 2, 10)), 1e-3),
}


def _ref_steps(jcfg, make_opt, batches, microbatches):
    opt = make_opt()
    step = rm.make_train_step(jcfg, opt, microbatches=microbatches)
    params = rm.init_params(jax.random.PRNGKey(0), jcfg)
    state = opt.init(params)
    out = []
    for b in batches:
        params, state, m = step(params, state, _jbatch(b))
        out.append((params, {k: float(v) for k, v in m.items()}))
    return out


def _port_steps(tcfg, model, make_opt, batches, microbatches):
    opt = make_opt()
    step = make_train_step(tcfg, opt, microbatches=microbatches)
    state = opt.init(dict(model.named_parameters()))
    out = []
    for b in batches:
        model, state, m = step(model, state, b)
        out.append((export_params(model),
                    {k: float(v) for k, v in m.items()}))
    return out


def _assert_params(opt, port_tree, ref_tree, lr, steps):
    if opt == "sgd":
        assert_trees_close(port_tree, ref_tree, atol=1e-6)
    else:
        assert_adam_params_close(port_tree, ref_tree, lr, steps)


@pytest.mark.parametrize("opt", sorted(OPT_PAIRS))
@pytest.mark.parametrize("arch", ARCHES)
def test_train_steps_match_reference(arch, opt):
    """Parameters after 1 and 3 steps and each step's loss and aux (SGD
    with momentum 0.9, AdamW under the cosine schedule)."""
    make_ref, make_port, lr = OPT_PAIRS[opt]
    jcfg, tcfg, _, model = _models(arch)
    batches = [_batch(jcfg, 2, SEQ[arch], seed=s) for s in range(3)]
    ref = _ref_steps(jcfg, make_ref, batches, 1)
    port = _port_steps(tcfg, model, make_port, batches, 1)
    for i in (0, 2):
        _assert_params(opt, port[i][0], ref[i][0], lr, i + 1)
    for key in ("loss", "aux"):
        np.testing.assert_allclose([m[key] for _, m in port],
                                   [m[key] for _, m in ref], rtol=1e-5,
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize("arch", ARCHES)
def test_microbatched_step_matches_reference(arch):
    """microbatches=2 on both sides (4 rows), AdamW + cosine; and inside
    the port, SGD over 2 microbatches equals the single-shot step: the aux
    is a mean of per-row terms, so the microbatches' mean is the batch's
    (the reference's invariant, rtol 1e-5 / atol 1e-6)."""
    make_ref, make_port, lr = OPT_PAIRS["adamw"]
    jcfg, tcfg, _, model = _models(arch)
    batches = [_batch(jcfg, 4, SEQ[arch], seed=5)]
    (rparams, rm_), = _ref_steps(jcfg, make_ref, batches, 2)
    (pparams, pm), = _port_steps(tcfg, model, make_port, batches, 2)
    assert_adam_params_close(pparams, rparams, lr, 1)
    for key in ("loss", "aux"):
        np.testing.assert_allclose(pm[key], rm_[key], rtol=1e-5, atol=1e-5)

    _, _, _, m1 = _models(arch, seed=1)
    _, _, _, m2 = _models(arch, seed=1)
    opt = po.sgd(1e-2)
    state = opt.init(dict(m1.named_parameters()))
    p1, _, s1 = make_train_step(tcfg, opt, 1)(m1, state, batches[0])
    p2, _, s2 = make_train_step(tcfg, opt, 2)(m2, state, batches[0])
    for key in ("loss", "aux", "nll"):
        np.testing.assert_allclose(float(s1[key]), float(s2[key]),
                                   rtol=1e-5, err_msg=key)
    for (k, a), (_, b) in zip(p1.named_parameters(), p2.named_parameters()):
        np.testing.assert_allclose(f32(a), f32(b), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
