"""The port's LM training path against the JAX reference on the CPU.

The same numpy inputs, and the reference's weights carried across with
``convert.load_reference_params``, go through both packages; gradients are
compared leaf by leaf under the reference's names (``convert.export_named``
lays the port's ``{name: tensor}`` dicts out as the reference's tree).  The
reference's flash attention runs its Pallas kernel in interpret mode with
its jnp recompute VJP, as ``tests/test_kernels.py`` runs it; the port's runs
the plain forward and the same VJP in torch ops.  Tolerances:

* K8's gradient: the reference's own flash-vs-blocked gradient tolerance
  (2e-4, ``tests/test_kernels.py:276``) through ``attention``; directly,
  f32 rtol = atol = 1e-5 (the port sums d_k and d_v over q blocks, the
  reference in one product), and bf16 one bf16 ulp (rtol 2^-7: each
  cotangent is one rounding of an f32 value that may differ in its last
  bits).
* Blocked attention's gradient: f32 1e-5; bf16 two ulps (1.6e-2), as the
  forward's.
* Whole reduced models in f32: loss within 1e-5; every gradient leaf within
  2e-5 of that leaf's largest magnitude (measured: at most 3e-6 of it).
* Train steps in f32: SGD parameters within 1e-6 (lr 0.1 times the
  gradients' 1e-5).  AdamW moves each weight by about lr per step whatever
  the gradient's size, so a gradient near eps (1e-8) whose last bits differ
  moves differently: each parameter within 2 lr per step (a flipped sign,
  the bound of ``tests/test_torch_trainer.py``), at most 1e-3 of a leaf's
  entries more than 1e-3 lr apart, and the mean difference within 1e-4 lr
  (measured: 0.24 lr, 7.7e-5 and 1e-5 lr).
* Port-internal invariants: remat on and off bit-equal; microbatched equal
  to single-shot within the reference's own bounds (rtol 1e-5, atol 1e-6,
  ``tests/test_models_consistency.py:134``).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as rm
import repro.optim as ro
from repro.configs import ARCHS as REF_ARCHS
from repro.kernels import ops as rops
from repro.models import layers as jl
from repro_torch import optim as po
from repro_torch.configs import ARCHS
from repro_torch.data import TokenPipeline
from repro_torch.kernels import ops
from repro_torch.launch import train as train_cli
from repro_torch.models import (init_params, loss_fn, make_train_step,
                                value_and_grad)
from repro_torch.models import layers as tl
from repro_torch.models.convert import (export_named, export_params,
                                        load_reference_params)

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
F32 = dict(rtol=1e-5, atol=1e-5)
BF16_ULP = dict(rtol=2 ** -7, atol=1e-5)
ATTN_BF16 = dict(rtol=1.6e-2, atol=1.6e-2)
LEAF_REL = 2e-5


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


def assert_trees_close(port_tree, ref_tree, rel=LEAF_REL, atol=None):
    """Every leaf by the reference's name: max |diff| within ``rel`` of the
    leaf's largest magnitude (or within ``atol``)."""
    got, want = _leaves(port_tree), _leaves(ref_tree)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        bound = atol if atol is not None else rel * max(np.abs(w).max(),
                                                        1e-30)
        assert np.abs(g - w).max() <= bound, (name, np.abs(g - w).max(),
                                              bound)


def assert_adam_params_close(port_tree, ref_tree, lr, steps):
    """AdamW parameters after ``steps`` steps (see the module docstring)."""
    got, want = _leaves(port_tree), _leaves(ref_tree)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        d = np.abs(got[name] - w)
        assert d.max() <= 2 * lr * steps, (name, d.max())
        assert (d > 1e-3 * lr).mean() <= 1e-3, (name, (d > 1e-3 * lr).mean())
        assert d.mean() <= 1e-4 * lr, (name, d.mean())


# ------------------------------------------------------- K8's gradient


def _qkv(rng, b, s, hkv, g, d):
    q = rng.standard_normal((b, s, hkv, g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    return q, k, v


def test_flash_grad_matches_reference_test_shape():
    """The reference's own gradient test (``test_flash_attention_grads``:
    B 2, S 32, 2 heads, D 16, q_block 16, loss sum(out^2)) through
    ``attention(impl="flash")`` in both packages."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
               for _ in range(3))
    want = jax.grad(lambda a: (jl.attention(*a, q_block=16, impl="flash")
                               ** 2).sum())(tuple(map(jnp.asarray,
                                                      (q, k, v))))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tl.attention(tq, tk, tv, q_block=16, impl="flash")
    got = torch.autograd.grad((out ** 2).sum(), (tq, tk, tv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(f32(g), f32(w), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("pos0", [0, 5])
@pytest.mark.parametrize("g", [2, 4])
def test_flash_grad_matches_reference(g, pos0, dtype):
    """GQA gradients of ``ops.flash_attention`` against ``jax.grad``
    through the reference's ``flash_attention`` (Pallas forward in
    interpret mode, jnp recompute VJP), the same upstream cotangent."""
    rng = np.random.default_rng(10 * g + pos0)
    b, s, hkv, d, qb = 2, 64, 2, 16, 32
    q, k, v = _qkv(rng, b, s, hkv, g, d)
    w = rng.standard_normal(q.shape).astype(np.float32)
    jd = JDT[dtype]
    jw = jnp.asarray(w, jd)
    want = jax.grad(lambda a: jnp.vdot(
        rops.flash_attention(*a, qb, pos0).astype(jnp.float32),
        jw.astype(jnp.float32)))(tuple(jnp.asarray(a, jd) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).to(dtype).requires_grad_()
                  for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, qb, pos0)
    got = torch.autograd.grad(out, (tq, tk, tv),
                              torch.from_numpy(w).to(dtype))
    tol = F32 if dtype == torch.float32 else BF16_ULP
    for name, gt, wt in zip("qkv", got, want):
        assert gt.dtype == dtype and gt.shape == wt.shape, name
        np.testing.assert_allclose(f32(gt), f32(wt), err_msg=name, **tol)


def test_flash_vjp_tiling_matches_one_block():
    """The plain VJP tiled over q blocks against one block over the whole
    sequence (the reference's layout): d_q bit-equal per row, d_k and d_v
    within f32 summation order."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 128, 2, 3, 16))
    gq = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    tiled = ref.flash_attention_vjp(q, k, v, gq, 32, 3)
    whole = ref.flash_attention_vjp(q, k, v, gq, 128, 3)
    for a, b_ in zip(tiled, whole):
        torch.testing.assert_close(a, b_, **F32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("window", [0, 8])
def test_blocked_attention_grad_matches_reference(window, dtype):
    """The blocked route (q blocks rematerialized in both packages) under
    ``jax.grad`` and torch autograd, sliding window on and off."""
    rng = np.random.default_rng(window)
    b, s, hq, hkv, d = 2, 64, 4, 2, 16
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    w = rng.standard_normal(q.shape).astype(np.float32)
    jd = JDT[dtype]
    want = jax.grad(lambda a: jnp.vdot(
        jl.attention(*a, window=window, q_block=16).astype(jnp.float32),
        jnp.asarray(w)))(tuple(jnp.asarray(x, jd) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_()
                  for x in (q, k, v))
    out = tl.attention(tq, tk, tv, window=window, q_block=16)
    got = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(),
                              (tq, tk, tv))
    tol = F32 if dtype == torch.float32 else ATTN_BF16
    for name, gt, wt in zip("qkv", got, want):
        assert gt.dtype == dtype, name
        np.testing.assert_allclose(f32(gt), f32(wt), err_msg=name, **tol)


# --------------------------------------------------------------- models


def _models(arch, impl, seed=0, **kw):
    """The reduced config in both packages, the reference's weights, and
    the port's model holding the same bits."""
    jcfg = dataclasses.replace(REF_ARCHS[arch][1], attn_impl=impl, **kw)
    tcfg = dataclasses.replace(ARCHS[arch][1], attn_impl=impl, **kw)
    jparams = rm.init_params(jax.random.PRNGKey(seed), jcfg)
    model = init_params(tcfg, torch.Generator().manual_seed(seed), "cpu")
    load_reference_params(model, jax.tree.map(f32, jparams))
    return jcfg, tcfg, jparams, model


def _batch(cfg, b, s, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)
                                                ).astype(np.int32)
    return {"tokens": toks, "labels": toks}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


ARCH_IMPL = [(a, i) for a in ("llama3.2-1b", "smollm-135m")
             for i in ("blocked", "flash")]


@pytest.mark.parametrize("arch,impl", ARCH_IMPL)
def test_loss_and_grads_match_reference(arch, impl):
    """``loss_fn``'s loss and metrics and every gradient leaf, by the
    reference's name, on the reduced configs (f32)."""
    jcfg, tcfg, jp, model = _models(arch, impl)
    batch = _batch(jcfg, 2, 64)
    batch["labels"] = batch["labels"].copy()
    batch["labels"][0, 40:] = -1              # masked-out positions
    (jloss, jm), jg = jax.value_and_grad(rm.loss_fn, has_aux=True)(
        jp, jcfg, _jbatch(batch))
    loss, metrics, grads = value_and_grad(model, tcfg, batch)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0, atol=1e-5)
    assert float(metrics["tokens"]) == float(jm["tokens"]) == 2 * 63 - 24
    assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
    np.testing.assert_allclose(float(metrics["nll"]), float(jm["nll"]),
                               atol=1e-5)
    assert sorted(grads) == sorted(k for k, _ in model.named_parameters())
    assert all(not p.requires_grad for p in model.parameters())
    assert_trees_close(export_named(model, grads), jg)
    # loss_fn alone gives the same loss (no gradient recorded)
    l2, _ = loss_fn(model, tcfg, batch)
    assert float(l2) == float(loss) and not l2.requires_grad


OPT_PAIRS = {
    "sgd": (lambda: ro.sgd(0.1), lambda: po.sgd(0.1), 0.1),
    "adamw_cosine": (
        lambda: ro.adamw(ro.cosine_warmup_schedule(1e-3, 2, 10)),
        lambda: po.adamw(po.cosine_warmup_schedule(1e-3, 2, 10)), 1e-3),
}


def _assert_step_params(opt, port_tree, ref_tree, lr, steps):
    if opt == "sgd":
        assert_trees_close(port_tree, ref_tree, atol=1e-6)
    else:
        assert_adam_params_close(port_tree, ref_tree, lr, steps)


def _ref_steps(jcfg, make_opt, batches, microbatches):
    opt = make_opt()
    step = rm.make_train_step(jcfg, opt, microbatches=microbatches)
    params, state = rm.init_params(jax.random.PRNGKey(0), jcfg), None
    state = opt.init(params)
    out = []
    for b in batches:
        params, state, m = step(params, state, _jbatch(b))
        out.append((params, float(m["loss"])))
    return out


def _port_steps(tcfg, model, make_opt, batches, microbatches):
    opt = make_opt()
    step = make_train_step(tcfg, opt, microbatches=microbatches)
    state = opt.init({k: p for k, p in model.named_parameters()})
    out = []
    for b in batches:
        model, state, m = step(model, state, b)
        out.append((export_params(model), float(m["loss"])))
    assert state["step"] == len(batches)
    return out


@pytest.mark.parametrize("opt", sorted(OPT_PAIRS))
def test_train_steps_match_reference(opt):
    """Parameters after 1 and 3 steps and each step's loss (llama
    reduced, flash, f32)."""
    make_ref, make_port, lr = OPT_PAIRS[opt]
    jcfg, tcfg, _, model = _models("llama3.2-1b", "flash")
    batches = [_batch(jcfg, 2, 64, seed=s) for s in range(3)]
    ref = _ref_steps(jcfg, make_ref, batches, 1)
    port = _port_steps(tcfg, model, make_port, batches, 1)
    for i in (0, 2):
        _assert_step_params(opt, port[i][0], ref[i][0], lr, i + 1)
    np.testing.assert_allclose([x[1] for x in port], [x[1] for x in ref],
                               rtol=0, atol=1e-5)


def test_microbatched_step_matches_reference():
    """microbatches=4 on both sides: the batch of 8 cut into 4, gradients
    summed in f32 and averaged, AdamW under the cosine schedule."""
    make_ref, make_port, lr = OPT_PAIRS["adamw_cosine"]
    jcfg, tcfg, _, model = _models("smollm-135m", "blocked")
    batches = [_batch(jcfg, 8, 32, seed=5)]
    (rparams, rloss), = _ref_steps(jcfg, make_ref, batches, 4)
    (pparams, ploss), = _port_steps(tcfg, model, make_port, batches, 4)
    assert_adam_params_close(pparams, rparams, lr, 1)
    np.testing.assert_allclose(ploss, rloss, rtol=0, atol=1e-5)


@pytest.mark.parametrize("impl", ["blocked", "flash"])
def test_microbatched_step_equals_single_in_port(impl):
    """The reference's invariant on the port: with SGD (linear), 4
    microbatches give the single-shot step's loss and parameters."""
    _, tcfg, _, model = _models("llama3.2-1b", impl, seed=1)
    model2 = init_params(tcfg, torch.Generator().manual_seed(1), "cpu")
    load_reference_params(model2, export_params(model))
    batch = _batch(tcfg, 8, 16, seed=2)
    opt = po.sgd(1e-2)
    named = {k: p for k, p in model.named_parameters()}
    p1, _, m1 = make_train_step(tcfg, opt, 1)(model, opt.init(named), batch)
    p4, _, m4 = make_train_step(tcfg, opt, 4)(model2, opt.init(named),
                                              batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    for (k, a), (_, b) in zip(p1.named_parameters(), p4.named_parameters()):
        np.testing.assert_allclose(f32(a), f32(b), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_microbatches_must_divide_the_batch():
    _, tcfg, _, model = _models("llama3.2-1b", "blocked")
    opt = po.sgd(1e-2)
    state = opt.init(dict(model.named_parameters()))
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(tcfg, opt, 3)(model, state, _batch(tcfg, 4, 16))


REMAT_CASES = [("smollm-135m", "blocked"), ("smollm-135m", "flash"),
               ("mixtral-8x22b", "blocked"), ("llama4-scout-17b-a16e", "flash"),
               ("musicgen-medium", "flash"), ("internvl2-1b", "flash")]


@pytest.mark.parametrize("arch,impl", REMAT_CASES,
                         ids=["blocked", "flash"] + [
                             f"{a}-{i}" for a, i in REMAT_CASES[2:]])
def test_remat_on_and_off_bit_equal(arch, impl):
    """Rematerializing each layer recomputes the same ops: the loss, the
    MoE aux (it leaves the checkpointed layer beside its output, so the
    router's gradient sees it) and every gradient bit for bit.  The
    mixtral sequence (128) runs its window's sliced view."""
    _, tcfg, _, model = _models(arch, impl)
    if tcfg.frontend == "none":
        batch = _batch(tcfg, 2, 128 if tcfg.window else 64, seed=4)
    else:
        batch = TokenPipeline(tcfg, 2, 64, seed=4, depth=0,
                              device="cpu")._make_host_batch(0)
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        out[remat] = value_and_grad(model, cfg, batch)
    assert torch.equal(out[False][0], out[True][0])
    assert torch.equal(out[False][1]["aux"], out[True][1]["aux"])
    assert (float(out[True][1]["aux"]) > 0) == (tcfg.kind == "moe")
    for k, g in out[False][2].items():
        assert torch.equal(g, out[True][2][k]), k


def test_grad_cast_delivers_bf16_cotangent_into_the_layers(monkeypatch):
    """At bf16 the cotangent entering the layer stack (the last layer's
    output, where ``_GradCast`` sits) is bf16, and every parameter's
    gradient keeps its dtype."""
    from repro_torch.models import lm as tlm
    cfg = dataclasses.replace(ARCHS["llama3.2-1b"][1], dtype="bfloat16",
                              remat=True, attn_impl="flash")
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    seen = []
    apply = tlm._GradCast.apply

    def spy(x, dtype):
        x.register_hook(lambda g: seen.append(g.dtype))
        return apply(x, dtype)
    monkeypatch.setattr(tlm._GradCast, "apply", spy)
    _, _, grads = value_and_grad(model, cfg, _batch(cfg, 2, 32))
    assert seen == [torch.bfloat16]
    assert all(g.dtype == torch.bfloat16 for g in grads.values())


# ------------------------------------------------------------------ CLI


CLI = ["--arch", "llama3.2-1b", "--reduced", "--batch", "2", "--seq", "32",
       "--device", "cpu"]


def test_train_cli_equals_hand_driven_loop(capsys):
    res = train_cli.main(CLI + ["--steps", "4", "--microbatches", "2",
                                "--attn-impl", "flash"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["losses"] == res["losses"] and len(res["losses"]) == 4
    cfg = dataclasses.replace(ARCHS["llama3.2-1b"][1], attn_impl="flash")
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = po.adamw(po.cosine_warmup_schedule(3e-4, 4 // 10 + 1, 4))
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(cfg, opt, microbatches=2)
    losses = []
    for batch in TokenPipeline(cfg, 2, 32, seed=0, depth=0,
                               device="cpu").batches(4):
        model, state, m = step(model, state, batch)
        losses.append(float(m["loss"]))
    assert losses == res["losses"]


def test_train_cli_resume_bit_equal_to_uninterrupted(tmp_path, monkeypatch):
    """A run that dies after its step-10 checkpoint and is started again
    restores step 10 (params, AdamW moments, the int step) and continues
    with the losses of a run that never stopped."""
    args = CLI + ["--steps", "15", "--ckpt-every", "5"]
    whole = train_cli.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    real = train_cli.make_train_step

    def dies_at_12(cfg, opt, microbatches=1):
        inner = real(cfg, opt, microbatches)
        calls = []

        def step(params, state, batch):
            if len(calls) == 12:
                raise RuntimeError("killed")
            calls.append(1)
            return inner(params, state, batch)
        return step

    resumed_dir = str(tmp_path / "b")
    monkeypatch.setattr(train_cli, "make_train_step", dies_at_12)
    with pytest.raises(RuntimeError, match="killed"):
        train_cli.main(args + ["--ckpt-dir", resumed_dir,
                               "--prefetch-depth", "0"])
    monkeypatch.setattr(train_cli, "make_train_step", real)
    resumed = train_cli.main(args + ["--ckpt-dir", resumed_dir])
    assert resumed["start_step"] == 10
    assert resumed["losses"] == whole["losses"][10:]


def test_train_cli_default_device_requires_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "llama3.2-1b", "--reduced", "--steps", "1"])


def test_train_cli_refuses_model_parallel(capsys):
    """(The name is kept from when the port refused the flag.)  One process
    has no mesh, as in the reference (``repro/launch/train.py:46-47``):
    ``--model-parallel 2`` runs, with the losses of a run without it."""
    with_flag = train_cli.main(CLI + ["--steps", "3", "--model-parallel",
                                      "2"])
    without = train_cli.main(CLI + ["--steps", "3"])
    assert "mesh" not in with_flag
    assert with_flag["losses"] == without["losses"]
