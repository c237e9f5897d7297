"""MoE blocks with sliding-window attention and the stub frontends through
the port's LM train and serve paths, against the JAX reference on the CPU
(the train steps: ``tests/test_torch_lm_moe_train.py``).

The reduced configs of mixtral-8x22b (MoE top-2 of 4, window 64),
llama4-scout (MoE top-1 of 4), musicgen-medium (``audio_stub`` frame
embeddings, GELU) and internvl2-1b (``vision_stub``, 8 prefix embeddings)
in f32, the reference's weights carried across with
``convert.load_reference_params``, the same numpy batches on both sides.
The sequences (64-128 tokens, q blocks of 32) run the window's sliced
``window + q_block`` view, and the MoE layers drop tokens at the default
capacity factor 1.25 (both packages drop the same ones: the routing is
bit-equal, ``tests/test_torch_moe.py``).  Tolerances, those of
``tests/test_torch_lm.py`` and ``tests/test_torch_lm_train.py``:

* logits and caches rtol = atol = 1e-4 (f32, four layers and a 512-wide
  head); the aux loss rtol 1e-5 (a sum of four f32 means);
* the loss within 1e-5; every gradient leaf within 2e-5 of that leaf's
  largest magnitude;
* port-internal identities (remat on and off, decode against the forward
  at a capacity that drops nothing) bit-equal or within the reference's
  own 2e-4 (``tests/test_models_consistency.py``).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as rm
from repro.configs import ARCHS as REF_ARCHS
from repro.models import layers as jl
from repro.models import moe as rmoe
from repro_torch import optim as po
from repro_torch.configs import ARCHS
from repro_torch.data import TokenPipeline
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import (forward, init_decode_cache, init_params,
                                make_prefill_step, make_serve_step,
                                make_train_step, prefill_into_cache,
                                value_and_grad)
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import (export_named, export_params,
                                        load_reference_params)

MODEL_F32 = dict(rtol=1e-4, atol=1e-4)
LEAF_REL = 2e-5
ARCHES = ("mixtral-8x22b", "llama4-scout-17b-a16e", "musicgen-medium",
          "internvl2-1b")
MOE = ("mixtral-8x22b", "llama4-scout-17b-a16e")
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


def assert_trees_close(port_tree, ref_tree):
    """Every leaf by the reference's name, within ``LEAF_REL`` of the
    leaf's largest magnitude."""
    got, want = _leaves(port_tree), _leaves(ref_tree)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        bound = LEAF_REL * max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= bound, (name, np.abs(g - w).max(),
                                              bound)


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


ARCH_IMPL = [(a, i) for a in ARCHES for i in ("blocked", "flash")]


@pytest.mark.parametrize("arch,impl", ARCH_IMPL)
def test_forward_matches_reference(arch, impl):
    """Logits, the summed aux loss and the per-layer caches (a window
    config takes the blocked route under either impl, in both)."""
    jcfg, tcfg, jp, model = _models(arch, impl)
    batch = _batch(jcfg, 2, SEQ[arch])
    jlog, jaux, jc = rm.forward(jp, jcfg, _jbatch(batch), return_cache=True)
    tlog, taux, tc = forward(model, tcfg, batch, return_cache=True)
    assert tlog.shape == jlog.shape == (2, SEQ[arch], tcfg.vocab_padded)
    np.testing.assert_allclose(f32(tlog), f32(jlog), **MODEL_F32)
    assert taux.dtype == torch.float32 and taux.dim() == 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert (float(taux) > 0) == (arch in MOE)
    for i in range(2):
        np.testing.assert_allclose(f32(tc["attn_kv"][i]),
                                   f32(jc["attn_kv"][i]), **MODEL_F32)


@pytest.mark.parametrize("arch,impl", ARCH_IMPL)
def test_loss_and_grads_match_reference(arch, impl):
    """``loss_fn``'s loss, nll, aux and tokens, and every gradient leaf by
    the reference's name (the MoE leaves nested under ``moe``)."""
    jcfg, tcfg, jp, model = _models(arch, impl)
    batch = _batch(jcfg, 2, SEQ[arch])
    (jloss, jm), jg = jax.value_and_grad(rm.loss_fn, has_aux=True)(
        jp, jcfg, _jbatch(batch))
    loss, metrics, grads = value_and_grad(model, tcfg, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(metrics["aux"]), float(jm["aux"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["nll"]), float(jm["nll"]),
                               atol=1e-5)
    assert float(metrics["tokens"]) == float(jm["tokens"])
    assert sorted(grads) == sorted(k for k, _ in model.named_parameters())
    if arch in MOE:
        assert "layers.0.moe.router" in grads
        assert float(grads["layers.0.moe.router"].abs().sum()) > 0
    assert_trees_close(export_named(model, grads), jg)


@pytest.mark.parametrize("arch", MOE)
def test_aux_loss_reaches_the_router(arch):
    """The forward's aux loss has a nonzero gradient in every layer's
    router, and equals the aux ``value_and_grad`` reports."""
    _, tcfg, _, model = _models(arch)
    batch = _batch(tcfg, 2, SEQ[arch])
    _, m, _ = value_and_grad(model, tcfg, batch)
    routers = [p for k, p in model.named_parameters()
               if k.endswith("moe.router")]
    assert len(routers) == tcfg.n_layers
    for r in routers:
        r.requires_grad_(True)
    try:
        with torch.enable_grad():
            _, aux, _ = forward(model, tcfg, batch)
            g_aux = torch.autograd.grad(aux, routers)
    finally:
        for r in routers:
            r.requires_grad_(False)
    assert all(float(g.abs().max()) > 0 for g in g_aux)
    np.testing.assert_allclose(float(aux.detach()), float(m["aux"]),
                               rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHES)
def test_prefill_cache_decode_chain_matches_reference(arch):
    """prefill -> prefill_into_cache -> teacher-forced decode steps, the
    same chain on both sides: the prefill's last logits, every step's
    logits and the final cache.  The reduced mixtral's cache holds
    min(64 + 32, window 64) = 64 slots, so its decode wraps the ring."""
    jcfg, tcfg, jp, model = _models(arch, seed=1)
    b, s, n = 2, 64, 32
    batch = _batch(jcfg, b, s, seed=1)
    total = s + n
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (b, n)).astype(
        np.int32)
    jlog, jcaches = rm.make_prefill_step(jcfg)(jp, _jbatch(batch))
    tlog, tcaches = make_prefill_step(tcfg)(model, batch)
    np.testing.assert_allclose(f32(tlog), f32(jlog), **MODEL_F32)
    jcache = rm.init_decode_cache(jcfg, b, total)
    jcache["attn"] = jax.vmap(jl.prefill_into_cache)(
        *jcaches["attn_kv"], jcache["attn"])
    tcache = init_decode_cache(tcfg, b, total, "cpu")
    cap = min(total, tcfg.window) if tcfg.window else total
    assert tcache["attn"].capacity == jcache["attn"].capacity == cap
    prefill_into_cache(*tcaches["attn_kv"], tcache["attn"])
    jstep, tstep = jax.jit(rm.make_serve_step(jcfg)), make_serve_step(tcfg)
    for t in range(n):
        tok = toks[:, t:t + 1]
        jlog, jcache = jstep(jp, jcache, {"tokens": jnp.asarray(tok)})
        tlog, tcache = tstep(model, tcache, {"tokens": tok})
        np.testing.assert_allclose(f32(tlog), f32(jlog), err_msg=str(t),
                                   **MODEL_F32)
    ja, ta = jcache["attn"], tcache["attn"]
    assert np.array_equal(ta.slot_pos.numpy(), np.asarray(ja.slot_pos))
    assert np.array_equal(ta.pos.numpy(), np.asarray(ja.pos))
    if arch == "mixtral-8x22b":            # wrapped: slot 0 took position 64
        assert int(ta.slot_pos[0, 0]) == 64
    np.testing.assert_allclose(f32(ta.k), f32(ja.k), **MODEL_F32)
    np.testing.assert_allclose(f32(ta.v), f32(ja.v), **MODEL_F32)


@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_forward_at_ample_capacity(arch):
    """One-token decode equals the teacher-forced forward inside the port
    when no token drops: capacity factor E / top_k gives every expert room
    for the whole sequence.  96 tokens through the reduced mixtral's
    64-slot ring."""
    base = ARCHS[arch][1]
    cfg = dataclasses.replace(
        base, capacity_factor=base.moe_experts / base.moe_top_k)
    model = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    s = 96
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, s)).astype(
        np.int32)
    logits_f, _, _ = forward(model, cfg, {"tokens": toks})
    step = make_serve_step(cfg)
    cache = init_decode_cache(cfg, 2, s, "cpu")
    outs = []
    for t in range(s):
        lg, cache = step(model, cache, {"tokens": toks[:, t:t + 1]})
        outs.append(lg)
    torch.testing.assert_close(logits_f[..., :cfg.vocab],
                               torch.cat(outs, 1)[..., :cfg.vocab],
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_convert_round_trip_nested_moe_leaves(arch, dtype):
    """The reference's tree with ``layers/moe/{router, w1, w3, w2}``
    stacked ``[L, ...]`` goes into the port and back bit for bit."""
    jcfg, tcfg, jp, model = _models(arch, dtype=dtype, seed=3)
    tree = export_params(model)
    want = jax.tree.map(f32, jp)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    assert tree["layers"]["moe"]["w1"].shape == (
        tcfg.n_layers, tcfg.moe_experts, tcfg.d_model, tcfg.d_ff)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        assert a.dtype == np.float32 and np.array_equal(a.view(np.int32),
                                                        b.view(np.int32))
    fresh = init_params(tcfg, torch.Generator().manual_seed(9), "cpu")
    load_reference_params(fresh, tree)
    for (n, a), (_, b) in zip(fresh.named_parameters(),
                              model.named_parameters()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("arch", MOE)
def test_routing_indices_inside_the_model_match_reference(arch,
                                                          monkeypatch):
    """Each layer's routing index arrays in the port's forward, caught at
    ``_routing_indices``, equal the reference's for the same layer input
    (bf16 weights: the router logits tie often)."""
    jcfg, tcfg, jp, model = _models(arch, dtype="bfloat16", seed=2)
    batch = _batch(jcfg, 2, SEQ[arch], seed=2)
    seen = []
    real = tmoe._routing_indices

    def spy(logits, top_k, capacity):
        out = real(logits, top_k, capacity)
        seen.append((logits.clone(), top_k, capacity, out))
        return out
    monkeypatch.setattr(tmoe, "_routing_indices", spy)
    forward(model, tcfg, batch)
    assert len(seen) == tcfg.n_layers
    for logits, top_k, cap, got in seen:
        jlg = jnp.asarray(f32(logits), jnp.bfloat16)
        want = jax.vmap(lambda lg: rmoe._routing_indices(lg, top_k, cap))(
            jlg)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------------ CLIs


@pytest.mark.parametrize("arch", ARCHES)
def test_train_cli_on_reduced_arch(arch, capsys):
    """The training CLI on the host: the losses of a hand-driven loop of
    the same pipeline, optimizer and step."""
    res = train_cli.main(["--arch", arch, "--reduced", "--steps", "3",
                          "--batch", "2", "--seq", "64", "--microbatches",
                          "2", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["losses"] == res["losses"] and len(res["losses"]) == 3
    cfg = ARCHS[arch][1]
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = po.adamw(po.cosine_warmup_schedule(3e-4, 3 // 10 + 1, 3))
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(cfg, opt, microbatches=2)
    losses = []
    for batch in TokenPipeline(cfg, 2, 64, seed=0, depth=0,
                               device="cpu").batches(3):
        model, state, m = step(model, state, batch)
        losses.append(float(m["loss"]))
    assert losses == res["losses"]


@pytest.mark.parametrize("arch", ARCHES)
def test_serve_cli_on_reduced_arch(arch):
    """The serve CLI on the host at temperature 0 gives the reference's
    greedy tokens from the same weights (its serve loop under jit); the
    reduced mixtral's 60 + 12 tokens wrap its 64-slot ring."""
    jcfg, tcfg, jp, model = _models(arch, seed=4)
    prompts = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 60)
                                                ).astype(np.int32)
    gen = 12
    jstep = jax.jit(rm.make_serve_step(jcfg))
    cache = rm.init_decode_cache(jcfg, 2, 60 + gen)
    for t in range(60):
        logits, cache = jstep(jp, cache,
                              {"tokens": jnp.asarray(prompts[:, t:t + 1])})
    want = []
    for _ in range(gen):
        tok = logits[:, -1, :jcfg.vocab].astype(jnp.float32).argmax(-1)
        tok = tok[:, None].astype(jnp.int32)
        want.append(np.asarray(tok))
        logits, cache = jstep(jp, cache, {"tokens": tok})
    got = serve_cli.generate(model, tcfg, prompts, gen, 0.0,
                             torch.Generator(), torch.device("cpu"))
    assert np.array_equal(got["tokens"], np.concatenate(want, axis=1))
    res = serve_cli.main(["--arch", arch, "--reduced", "--batch", "2",
                          "--prompt-len", "8", "--gen", "4", "--device",
                          "cpu"])
    assert res["tokens"].shape == (2, 4)
