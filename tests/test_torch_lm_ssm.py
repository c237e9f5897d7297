"""RWKV-6 and Mamba-2 blocks through the port's LM train and serve paths,
against the JAX reference on the CPU.

The reduced configs of rwkv6-1.6b (4 layers, 4 heads of 32) and
zamba2-7b (7 Mamba layers: 2 sites of 3 with the shared attention block
after each, then 1 tail layer; state 16, heads of 32) in f32, the
reference's weights carried across with ``convert.load_reference_params``,
the same numpy batches on both sides.  256 tokens run two 128-token
chunks of the WKV / SSD.  Tolerances:

* the converter bit for bit, both ways, f32 and bf16 trees (the f32
  leaves of a bf16 model included);
* logits, caches and decode states rtol = atol = 1e-4 (f32, four to
  seven layers and a 512-wide head, as ``tests/test_torch_lm.py``);
* the loss within 1e-5; every gradient leaf within 5e-4 of that leaf's
  largest magnitude: the recurrences' leaves (RWKV's ``u``, Mamba's
  ``A_log``) sum ``exp`` of cumulative log-decays over 256 positions
  whose terms cancel, and differ by up to 1.7e-4 on the CPU;
* after microbatched SGD steps, each leaf's movement (parameters after
  minus before) within 5e-4 of the reference's largest movement in that
  leaf, plus two ulps of the parameters: the movement is lr times the
  momentum-summed gradients, so it carries their relative error;
* port-internal identities (remat on and off bit-equal; decode against
  the forward within the reference's own 2e-4,
  ``tests/test_models_consistency.py``).
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
from repro.models import layers as jl
from repro_torch import optim as po
from repro_torch.configs import ARCHS
from repro_torch.data import TokenPipeline
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import (forward, init_decode_cache, init_params,
                                make_prefill_step, make_serve_step,
                                make_train_step, prefill_into_cache,
                                value_and_grad)
from repro_torch.models.convert import (export_named, export_params,
                                        load_reference_params)

MODEL_F32 = dict(rtol=1e-4, atol=1e-4)
LEAF_REL = 5e-4
ARCHES = ("rwkv6-1.6b", "zamba2-7b")
ARCH_IMPL = [("rwkv6-1.6b", "blocked"), ("zamba2-7b", "blocked"),
             ("zamba2-7b", "flash")]
SEQ = 256


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Two torch threads a test: the suite runs six workers on eight cores,
    and torch's default of one thread a core oversubscribes them."""
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


def assert_trees_close(port_tree, ref_tree, rel=None, atol=None):
    """Every leaf by the reference's name: within ``rel`` of the leaf's
    largest magnitude, or within ``atol``."""
    got, want = _leaves(port_tree), _leaves(ref_tree)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        bound = atol if atol is not None else rel * max(np.abs(w).max(),
                                                        1e-30)
        assert np.abs(g - w).max() <= bound, (name, np.abs(g - w).max(),
                                              bound)


def _models(arch, impl="blocked", seed=0, **kw):
    jcfg = dataclasses.replace(REF_ARCHS[arch][1], attn_impl=impl, **kw)
    tcfg = dataclasses.replace(ARCHS[arch][1], attn_impl=impl, **kw)
    jparams = rm.init_params(jax.random.PRNGKey(seed), jcfg)
    model = init_params(tcfg, torch.Generator().manual_seed(seed), "cpu")
    load_reference_params(model, jax.tree.map(f32, jparams))
    return jcfg, tcfg, jparams, model


def _batch(cfg, b, s, seed=0):
    return TokenPipeline(cfg, b, s, seed=seed, depth=0,
                         device="cpu")._make_host_batch(0)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# -------------------------------------------------------------- converter


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHES)
def test_convert_round_trip(arch, dtype):
    """The reference's tree (zamba: ``layers`` ``[sites, per, ...]``,
    ``tail``, the flat ``shared_attn``) into the port and back, bit for
    bit; a bf16 model keeps RWKV's ``w0`` / ``u`` and Mamba's ``A_log`` /
    ``D`` / ``dt_bias`` in f32, on both sides."""
    jcfg, tcfg, jp, model = _models(arch, dtype=dtype, seed=3)
    tree = export_params(model)
    want = jax.tree.map(f32, jp)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        assert a.dtype == np.float32 and np.array_equal(a.view(np.int32),
                                                        b.view(np.int32))
    f32_leaves = {"rwkv": ("w0", "u"),
                  "zamba": ("A_log", "D", "dt_bias")}[tcfg.kind]
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        want_dt = torch.float32 if leaf in f32_leaves else tcfg.torch_dtype
        assert p.dtype == want_dt, name
        ref_leaf = jp["layers"][leaf] if leaf in jp["layers"] else None
        if ref_leaf is not None:
            assert str(ref_leaf.dtype) == str(want_dt).split(".")[-1], name
    if tcfg.kind == "zamba":
        sites, per, tail = tcfg.zamba_structure()
        assert tree["layers"]["in_proj"].shape[:2] == (sites, per)
        assert tree["tail"]["in_proj"].shape[0] == tail
        assert tree["shared_attn"]["wq"].ndim == 2
    fresh = init_params(tcfg, torch.Generator().manual_seed(9), "cpu")
    load_reference_params(fresh, tree)
    for (n, a), (_, b) in zip(fresh.named_parameters(),
                              model.named_parameters()):
        assert torch.equal(a, b), n


# ---------------------------------------------------------------- forward


@pytest.mark.parametrize("arch,impl", ARCH_IMPL)
def test_forward_matches_reference(arch, impl):
    """Logits over two 128-token chunks, aux 0, and the caches: zamba's
    post-RoPE K/V stacked over its sites, RWKV's None."""
    jcfg, tcfg, jp, model = _models(arch, impl)
    batch = _batch(jcfg, 2, SEQ)
    jlog, jaux, jc = rm.forward(jp, jcfg, _jbatch(batch), return_cache=True)
    tlog, taux, tc = forward(model, tcfg, batch, return_cache=True)
    assert tlog.shape == jlog.shape == (2, SEQ, tcfg.vocab_padded)
    np.testing.assert_allclose(f32(tlog), f32(jlog), **MODEL_F32)
    assert float(taux) == float(jaux) == 0.0
    if tcfg.kind == "rwkv":
        assert tc is None and jc is None
        return
    sites = tcfg.zamba_structure()[0]
    for i in range(2):
        assert tc["attn_kv"][i].shape == (sites, 2, SEQ, tcfg.n_kv, tcfg.hd)
        np.testing.assert_allclose(f32(tc["attn_kv"][i]),
                                   f32(jc["attn_kv"][i]), **MODEL_F32)


@pytest.mark.parametrize("arch", ARCHES)
def test_prefill_step_matches_reference(arch):
    """The prefill's last logits and its caches (zamba's per-site K/V into
    the decode cache's ``attn``; RWKV hands on nothing, as the
    reference)."""
    jcfg, tcfg, jp, model = _models(arch, seed=1)
    batch = _batch(jcfg, 2, 64, seed=1)
    jlog, jcaches = rm.make_prefill_step(jcfg)(jp, _jbatch(batch))
    tlog, tcaches = make_prefill_step(tcfg)(model, batch)
    assert tlog.shape == (2, 1, tcfg.vocab_padded)
    np.testing.assert_allclose(f32(tlog), f32(jlog), **MODEL_F32)
    if tcfg.kind == "rwkv":
        assert tcaches is None and jcaches is None
        return
    jcache = rm.init_decode_cache(jcfg, 2, 80)
    jcache["attn"] = jax.vmap(jl.prefill_into_cache)(
        *jcaches["attn_kv"], jcache["attn"])
    tcache = init_decode_cache(tcfg, 2, 80, "cpu")
    prefill_into_cache(*tcaches["attn_kv"], tcache["attn"])
    ja, ta = jcache["attn"], tcache["attn"]
    assert np.array_equal(ta.slot_pos.numpy(), np.asarray(ja.slot_pos))
    assert np.array_equal(ta.pos.numpy(), np.asarray(ja.pos))
    np.testing.assert_allclose(f32(ta.k), f32(ja.k), **MODEL_F32)
    np.testing.assert_allclose(f32(ta.v), f32(ja.v), **MODEL_F32)


# ----------------------------------------------------------------- decode


def _state_pairs(tcfg, tcache, jcache):
    """(name, port tensor, reference array) of every cache field."""
    if tcfg.kind == "rwkv":
        return [(f"rwkv.{n}", getattr(tcache["rwkv"], n),
                 getattr(jcache["rwkv"], n)) for n in ("tm_x", "cm_x", "s")]
    out = [(f"{g}.{n}", getattr(tcache[g], n), getattr(jcache[g], n))
           for g in ("mamba", "mamba_tail") for n in ("conv", "h")]
    out += [(f"attn.{n}", getattr(tcache["attn"], n),
             getattr(jcache["attn"], n))
            for n in ("k", "v", "slot_pos", "pos")]
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHES)
def test_init_decode_cache_matches_reference(arch, dtype):
    """Fields, shapes and dtypes of the stacked cache: the RWKV state, or
    the Mamba state ``[sites, per, ...]`` / ``[tail, ...]`` (f32 SSM
    states) plus one ``min(seq_len, window)``-slot KV cache a site."""
    jcfg = dataclasses.replace(REF_ARCHS[arch][1], dtype=dtype)
    tcfg = dataclasses.replace(ARCHS[arch][1], dtype=dtype)
    jcache = rm.init_decode_cache(jcfg, 3, 40)
    tcache = init_decode_cache(tcfg, 3, 40, "cpu")
    assert sorted(tcache) == sorted(jcache)
    for name, t, j in _state_pairs(tcfg, tcache, jcache):
        assert tuple(t.shape) == j.shape, name
        assert str(t.dtype).split(".")[-1] == str(j.dtype), name
        assert np.array_equal(f32(t), f32(j)), name


@pytest.mark.parametrize("arch", ARCHES)
def test_decode_chain_matches_reference(arch):
    """24 steps from an empty cache through the reference's jitted
    ``serve_step`` and the port's: every step's logits and, at the end,
    every cache field (integer positions bit-equal)."""
    jcfg, tcfg, jp, model = _models(arch, seed=2)
    b, n = 2, 24
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (b, n)).astype(
        np.int32)
    jcache = rm.init_decode_cache(jcfg, b, n)
    tcache = init_decode_cache(tcfg, b, n, "cpu")
    jstep, tstep = jax.jit(rm.make_serve_step(jcfg)), make_serve_step(tcfg)
    for t in range(n):
        tok = toks[:, t:t + 1]
        jlog, jcache = jstep(jp, jcache, {"tokens": jnp.asarray(tok)})
        tlog, back = tstep(model, tcache, {"tokens": tok})
        assert back is tcache
        np.testing.assert_allclose(f32(tlog), f32(jlog), err_msg=str(t),
                                   **MODEL_F32)
    for name, t, j in _state_pairs(tcfg, tcache, jcache):
        if t.dtype in (torch.int32, torch.int64):
            assert np.array_equal(t.numpy(), np.asarray(j)), name
        else:
            np.testing.assert_allclose(f32(t), f32(j), err_msg=name,
                                       **MODEL_F32)


@pytest.mark.parametrize("arch", ARCHES)
def test_decode_matches_forward_in_port(arch):
    """The reference's property (``test_decode_matches_forward``) on the
    port: one-token decode equals the teacher-forced forward (zamba's 64
    tokens: the forward's SSD runs one 64-token chunk)."""
    cfg = ARCHS[arch][1]
    model = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    s = 32 if cfg.kind == "rwkv" else 64
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


# --------------------------------------------------------------- training


@pytest.mark.parametrize("arch,impl", ARCH_IMPL)
def test_loss_and_grads_match_reference(arch, impl):
    """``loss_fn``'s loss, nll and tokens, and every gradient leaf by the
    reference's name (zamba's ``layers``, ``tail`` and ``shared_attn``)."""
    jcfg, tcfg, jp, model = _models(arch, impl)
    batch = _batch(jcfg, 2, SEQ)
    (jloss, jm), jg = jax.value_and_grad(rm.loss_fn, has_aux=True)(
        jp, jcfg, _jbatch(batch))
    loss, metrics, grads = value_and_grad(model, tcfg, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(metrics["nll"]), float(jm["nll"]),
                               atol=1e-5)
    assert float(metrics["tokens"]) == float(jm["tokens"])
    assert sorted(grads) == sorted(k for k, _ in model.named_parameters())
    assert_trees_close(export_named(model, grads), jg, rel=LEAF_REL)


@pytest.mark.parametrize("arch", ARCHES)
def test_remat_on_off_bit_equal(arch):
    """Remat (a checkpoint per RWKV layer, per zamba site; the WKV / SSD
    chunks always) changes no bit of the loss or the gradients."""
    cfg = ARCHS[arch][1]
    batch = _batch(cfg, 2, SEQ, seed=4)
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        model = init_params(c, torch.Generator().manual_seed(4), "cpu")
        out[remat] = value_and_grad(model, c, batch)
    assert torch.equal(out[False][0], out[True][0])
    for k, g in out[False][2].items():
        assert torch.equal(g, out[True][2][k]), k


@pytest.mark.parametrize("arch", ARCHES)
def test_train_step_microbatched_remat_matches_reference(arch):
    """Two SGD-with-momentum steps of 4 x 128 tokens in 2 microbatches
    with remat on both sides: each step's loss and the parameters after
    them."""
    jcfg, tcfg, jp, model = _models(arch, seed=0, remat=True)
    batches = [_batch(jcfg, 4, 128, seed=s) for s in (5, 6)]
    jopt, topt = ro.sgd(0.1, momentum=0.9), po.sgd(0.1, momentum=0.9)
    jstep = rm.make_train_step(jcfg, jopt, microbatches=2)
    tstep = make_train_step(tcfg, topt, microbatches=2)
    jstate = jopt.init(jp)
    tstate = topt.init(dict(model.named_parameters()))
    before = _leaves(jp)
    for b in batches:
        jp, jstate, jm = jstep(jp, jstate, _jbatch(b))
        model, tstate, tm = tstep(model, tstate, b)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=0, atol=1e-5)
    got, want = _leaves(export_params(model)), _leaves(jp)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        moved = np.abs(w - before[name]).max()
        bound = LEAF_REL * moved + 2 * np.spacing(np.abs(w)).max()
        assert moved > 0 and np.abs(got[name] - w).max() <= bound, (
            name, np.abs(got[name] - w).max(), bound)


# ------------------------------------------------------------------- CLIs


@pytest.mark.parametrize("arch", ARCHES)
def test_serve_cli_greedy_tokens_match_reference(arch):
    """The serve CLI's ``generate`` at temperature 0 gives the reference's
    greedy tokens from the same weights (its serve loop under jit), then
    ``main`` runs on the host."""
    jcfg, tcfg, jp, model = _models(arch, seed=4)
    prompts = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 20)
                                                ).astype(np.int32)
    gen = 10
    jstep = jax.jit(rm.make_serve_step(jcfg))
    cache = rm.init_decode_cache(jcfg, 2, 20 + gen)
    for t in range(20):
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


@pytest.mark.parametrize("arch", ARCHES)
def test_train_cli_on_reduced_arch(arch, capsys):
    """The training CLI on the host: the losses of a hand-driven loop of
    the same pipeline, optimizer and step."""
    res = train_cli.main(["--arch", arch, "--reduced", "--steps", "3",
                          "--batch", "2", "--seq", "128", "--microbatches",
                          "2", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["losses"] == res["losses"] and len(res["losses"]) == 3
    assert all(np.isfinite(res["losses"]))
    cfg = ARCHS[arch][1]
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = po.adamw(po.cosine_warmup_schedule(3e-4, 3 // 10 + 1, 3))
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(cfg, opt, microbatches=2)
    losses = []
    for batch in TokenPipeline(cfg, 2, 128, seed=0, depth=0,
                               device="cpu").batches(3):
        model, state, m = step(model, state, batch)
        losses.append(float(m["loss"]))
    assert losses == res["losses"]
