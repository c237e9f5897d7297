"""The port's LM serving path against the JAX reference on the CPU.

The same numpy inputs (and the reference's weights, carried across with
``convert.load_reference_params``) go through both packages.  Tolerances:

* f32: rtol = atol = 1e-5 for the layer functions and the flash kernel's
  plain version (sums in another order than XLA's); 1e-4 for whole models
  (four layers and a 512-wide head, logits up to ~5).
* bf16: the element-wise functions (``rms_norm``, ``rope``) round the same
  f32 value once, so they agree to one bf16 ulp (rtol 2^-7 ≈ 7.8e-3);
  attention to two ulps (1.6e-2).  A whole bf16 model rounds at other
  places in the two frameworks (XLA rounds ``silu``'s sigmoid before the
  product, torch does not), and each layer re-rounds the residual stream.
  On the reduced llama (mean |logit| 0.80) the two bf16 models differ by
  0.0097 on average and 0.0625 at most, the same size as each one's
  distance from the f32 model with the same weights (0.0094 and 0.0093
  mean, 0.069 max).  So logits and caches are held to 0.125 absolute at
  most and 0.02 on average.

The reference's flash attention runs its Pallas kernel in interpret mode,
as ``tests/test_kernels.py`` runs it; the port's runs its plain version.
Flash and blocked differ by route in bf16 (flash rounds once, blocked
rounds ``p`` before ``p @ v``), so each route is held against the same
route of the reference.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as rm
from repro.configs import ARCHS as REF_ARCHS
from repro.kernels.flash_attention import flash_attention_call
from repro.models import layers as jl
from repro_torch.configs import ARCHS, get_arch
from repro_torch.kernels import ops
from repro_torch.launch.serve import generate
from repro_torch.models import (forward, init_decode_cache, init_params,
                                make_prefill_step, make_serve_step,
                                prefill_into_cache)
from repro_torch.models import layers as tl
from repro_torch.models import lm as tlm
from repro_torch.models.convert import export_params, load_reference_params

F32 = dict(rtol=1e-5, atol=1e-5)
MODEL_F32 = dict(rtol=1e-4, atol=1e-4)
ELEM_BF16 = dict(rtol=2 ** -7, atol=1e-5)
ATTN_BF16 = dict(rtol=1.6e-2, atol=1.6e-2)
MODEL_BF16_MAX, MODEL_BF16_MEAN = 0.125, 0.02
CPU = torch.device("cpu")
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a).astype(np.float32)


def pair(x: np.ndarray, dtype: torch.dtype):
    """The same f32 numpy array in both packages, rounded to ``dtype``
    (both round to nearest even)."""
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(dtype)


def assert_model_close(got, want, dtype, what=""):
    g, w = f32(got), f32(want)
    assert g.shape == w.shape, what
    if dtype == torch.float32:
        np.testing.assert_allclose(g, w, err_msg=what, **MODEL_F32)
    else:
        diff = np.abs(g - w)
        assert diff.max() <= MODEL_BF16_MAX, (what, diff.max())
        assert diff.mean() <= MODEL_BF16_MEAN, (what, diff.mean())


def assert_close(got, want, tol, what=""):
    np.testing.assert_allclose(f32(got), f32(want), err_msg=what, **tol)


# ------------------------------------------------------------------ configs


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_config_fields_equal(arch):
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    for port, refc in zip(ARCHS[arch], REF_ARCHS[arch]):
        assert dataclasses.asdict(port) == dataclasses.asdict(refc)
        assert (port.hd, port.vocab_padded, port.sub_quadratic,
                port.zamba_structure()) == (
            refc.hd, refc.vocab_padded, refc.sub_quadratic,
            refc.zamba_structure())
        assert tlm.active_param_count(port) == rm.active_param_count(refc)
        assert tlm.model_flops_per_token(port) == \
            rm.model_flops_per_token(refc)
    assert get_arch(arch, reduced=True) is ARCHS[arch][1]


def test_get_arch_unknown():
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("gpt-5")


# ------------------------------------------------------------------ layers


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_rms_norm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 48)).astype(np.float32) * 3
    gamma = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    (jx, tx), (jg, tg) = pair(x, dtype), pair(gamma, dtype)
    got = tl.rms_norm(tx, tg, 1e-5)
    assert got.dtype == dtype
    assert_close(got, jl.rms_norm(jx, jg, 1e-5),
                 F32 if dtype == torch.float32 else ELEM_BF16)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_rope_matches_reference(dtype, theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 32)).astype(np.float32)
    pos = (5 + np.arange(9)).astype(np.int32)
    jx, tx = pair(x, dtype)
    got = tl.rope(tx, torch.from_numpy(pos)[None], theta)
    want = jl.rope(jx, jnp.asarray(pos)[None], theta)
    assert got.dtype == dtype
    assert_close(got, want, F32 if dtype == torch.float32 else ELEM_BF16)


def _qkv(rng, b, s, hq, hkv, d):
    return (rng.standard_normal((b, s, hq, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("pos0,window", [(0, 0), (3, 0), (0, 24)])
def test_blocked_attention_matches_reference(dtype, pos0, window):
    """The blocked route, full and sliding-window (a window + q_block KV
    slice under each q block)."""
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 2, 64, 8, 2, 16)
    (jq, tq), (jk, tk), (jv, tv) = (pair(a, dtype) for a in (q, k, v))
    got = tl.attention(tq, tk, tv, q_block=16, pos0=pos0, window=window,
                       impl="blocked")
    want = jl.attention(jq, jk, jv, q_block=16, pos0=pos0, window=window,
                        impl="blocked")
    assert got.dtype == dtype
    assert_close(got, want, F32 if dtype == torch.float32 else ATTN_BF16)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_decode_attention_matches_reference(dtype):
    """A cache of capacity 12 holding 9 tokens takes a 10th."""
    rng = np.random.default_rng(3)
    b, cap, hq, hkv, d, seen = 2, 12, 4, 2, 16, 9
    kc = rng.standard_normal((b, cap, hkv, d)).astype(np.float32)
    vc = rng.standard_normal((b, cap, hkv, d)).astype(np.float32)
    kc[:, seen:] = vc[:, seen:] = 0
    q, kn, vn = _qkv(rng, b, 1, hq, hkv, d)
    slot = np.where(np.arange(cap) < seen, np.arange(cap), -1).astype(
        np.int32)
    jcache = jl.KVCache(k=jnp.asarray(kc, JDT[dtype]),
                        v=jnp.asarray(vc, JDT[dtype]),
                        slot_pos=jnp.asarray(slot),
                        pos=jnp.asarray(seen, jnp.int32))
    tcache = tl.KVCache(k=torch.from_numpy(kc).to(dtype),
                        v=torch.from_numpy(vc).to(dtype),
                        slot_pos=torch.from_numpy(slot),
                        pos=torch.tensor(seen, dtype=torch.int32))
    (jq, tq), (jk, tk), (jv, tv) = (pair(a, dtype) for a in (q, kn, vn))
    want, jnew = jl.decode_attention(jq, jk, jv, jcache)
    got, tnew = tl.decode_attention(tq, tk, tv, tcache)
    assert tnew is tcache and int(tnew.pos) == int(jnew.pos) == seen + 1
    assert np.array_equal(tnew.slot_pos.numpy(), np.asarray(jnew.slot_pos))
    assert np.array_equal(f32(tnew.k), f32(jnew.k))
    assert np.array_equal(f32(tnew.v), f32(jnew.v))
    assert_close(got, want, F32 if dtype == torch.float32 else ATTN_BF16)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("mlp", ["swiglu", "gelu"])
def test_mlp_matches_reference(mlp, dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w1, w3 = (rng.standard_normal((32, 64)).astype(np.float32) / 6
              for _ in range(2))
    w2 = rng.standard_normal((64, 32)).astype(np.float32) / 8
    (jx, tx), (j1, t1), (j3, t3), (j2, t2) = (pair(a, dtype)
                                              for a in (x, w1, w3, w2))
    if mlp == "swiglu":
        got, want = tl.swiglu(tx, t1, t3, t2), jl.swiglu(jx, j1, j3, j2)
    else:
        got, want = tl.gelu_mlp(tx, t1, t2), jl.gelu_mlp(jx, j1, j2)
    # bf16: XLA rounds silu's sigmoid (and gelu's tanh) before the product
    assert_close(got, want, F32 if dtype == torch.float32 else ATTN_BF16)


# ------------------------------------------------------------------ K8


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("pos0", [0, 5])
@pytest.mark.parametrize("shape", [(2, 32, 2, 2, 16), (1, 64, 1, 4, 32),
                                   (1, 100, 2, 2, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_plain_matches_pallas(shape, pos0, dtype):
    """The port's plain flash attention (what K8 computes, and what the
    wrapper runs for a CPU tensor) against the reference's Pallas kernel in
    interpret mode, including a ragged length (S = 100, one 100-row
    block)."""
    b, s, hkv, g, d = shape
    rng = np.random.default_rng(s + pos0)
    q = rng.standard_normal((b, s, hkv, g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (pair(a, dtype) for a in (q, k, v))
    want = flash_attention_call(jq, jk, jv, pos0=pos0, interpret=True)
    before = ops.kernel_launches()["flash_attention"]
    got = ops.flash_attention(tq, tk, tv, 512, pos0)
    assert ops.kernel_launches()["flash_attention"] == before  # no kernel
    assert got.dtype == dtype and got.shape == tq.shape
    assert_close(got, want, F32 if dtype == torch.float32 else ATTN_BF16)


@pytest.mark.parametrize("s,q_block", [(600, 512), (96, 64), (1030, 512)])
def test_flash_wrapper_refuses_lengths_the_reference_refuses(s, q_block):
    q = torch.zeros(1, s, 1, 1, 16)
    k = torch.zeros(1, s, 1, 16)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, k, k, q_block)


def test_flash_wrapper_takes_multiples_of_512():
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((1, 1024, 1, 2, 16)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 1024, 1, 16)).astype(
        np.float32))
    out = ops.flash_attention(q, k, k)
    # row 0 attends to key 0 only
    torch.testing.assert_close(out[0, 0, 0], k[0, 0, 0].expand(2, 16),
                               rtol=0, atol=0)


# ------------------------------------------------------------------ models


def _models(arch="llama3.2-1b", dtype="float32", impl="blocked", seed=0,
            **kw):
    """The reduced config in both packages, the reference's weights, and
    the port's model holding the same bits."""
    jcfg = dataclasses.replace(REF_ARCHS[arch][1], dtype=dtype,
                               attn_impl=impl, **kw)
    tcfg = dataclasses.replace(ARCHS[arch][1], dtype=dtype, attn_impl=impl,
                               **kw)
    jparams = rm.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(f32, jparams)
    model = init_params(tcfg, torch.Generator().manual_seed(seed), "cpu")
    load_reference_params(model, tree)
    return jcfg, tcfg, jparams, model


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)
                                                ).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["blocked", "flash"])
def test_forward_matches_reference(impl, dtype):
    jcfg, tcfg, jp, model = _models(dtype=dtype, impl=impl)
    toks = _tokens(jcfg, 2, 64)
    jl_, jaux, jc = rm.forward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                               return_cache=True)
    tl_, taux, tc = forward(model, tcfg, {"tokens": toks},
                            return_cache=True)
    tdt = tcfg.torch_dtype
    assert tl_.dtype == tdt and float(taux) == float(jaux) == 0.0
    assert_model_close(tl_, jl_, tdt, "logits")
    for i, name in enumerate("kv"):
        assert tc["attn_kv"][i].shape == jc["attn_kv"][i].shape
        assert_model_close(tc["attn_kv"][i], jc["attn_kv"][i], tdt, name)


@pytest.mark.parametrize("impl", ["blocked", "flash"])
def test_prefill_cache_decode_chain_matches_reference(impl):
    """prefill -> prefill_into_cache -> 8 teacher-forced decode steps, the
    same chain on both sides (f32): last-position logits, every step's
    logits and the final cache."""
    jcfg, tcfg, jp, model = _models(impl=impl, seed=1)
    b, s, n = 2, 32, 8
    toks = _tokens(jcfg, b, s + n, seed=1)
    jlog, jcaches = rm.make_prefill_step(jcfg)(
        jp, {"tokens": jnp.asarray(toks[:, :s])})
    tlog, tcaches = make_prefill_step(tcfg)(model, {"tokens": toks[:, :s]})
    assert tlog.shape == (b, 1, tcfg.vocab_padded)
    assert_close(tlog, jlog, MODEL_F32, "prefill logits")

    jcache = rm.init_decode_cache(jcfg, b, s + n)
    jcache["attn"] = jax.vmap(jl.prefill_into_cache)(
        *jcaches["attn_kv"], jcache["attn"])
    tcache = init_decode_cache(tcfg, b, s + n, "cpu")
    prefill_into_cache(*tcaches["attn_kv"], tcache["attn"])
    assert tcache["attn"].pos.tolist() == [s] * tcfg.n_layers
    jstep, tstep = jax.jit(rm.make_serve_step(jcfg)), make_serve_step(tcfg)
    for t in range(n):
        tok = toks[:, s + t:s + t + 1]
        jlog, jcache = jstep(jp, jcache, {"tokens": jnp.asarray(tok)})
        tlog, tcache = tstep(model, tcache, {"tokens": tok})
        assert_close(tlog, jlog, MODEL_F32, f"decode step {t}")
    ja, ta = jcache["attn"], tcache["attn"]
    assert np.array_equal(ta.slot_pos.numpy(), np.asarray(ja.slot_pos))
    assert np.array_equal(ta.pos.numpy(), np.asarray(ja.pos))
    assert_close(ta.k, ja.k, MODEL_F32, "cache k")
    assert_close(ta.v, ja.v, MODEL_F32, "cache v")


@pytest.mark.parametrize("impl", ["blocked", "flash"])
def test_decode_matches_forward(impl):
    """One-token decode == teacher-forced forward inside the port (the
    reference's tests/test_models_consistency.py check, dense kind)."""
    cfg = tlm.ModelConfig(name="t", kind="dense", n_layers=3, d_model=64,
                          n_heads=4, n_kv=2, d_ff=128, vocab=97,
                          remat=False, q_block=8, dtype="float32",
                          attn_impl=impl)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    s = 16
    toks = _tokens(cfg, 2, s)
    logits_f, _, _ = forward(model, cfg, {"tokens": toks})
    step = make_serve_step(cfg)
    cache = init_decode_cache(cfg, 2, s, "cpu")
    outs = []
    for t in range(s):
        lg, cache = step(model, cache, {"tokens": toks[:, t:t + 1]})
        outs.append(lg)
    logits_d = torch.cat(outs, dim=1)
    torch.testing.assert_close(logits_f[..., :cfg.vocab],
                               logits_d[..., :cfg.vocab], rtol=2e-4,
                               atol=2e-4)
    assert bool((logits_d[..., cfg.vocab:] == -1e30).all())


def test_greedy_serve_matches_reference():
    """The port's serve loop (stepwise prefill, greedy decode) gives the
    reference's tokens: a JAX loop of its serve steps at temperature 0."""
    jcfg, tcfg, jp, model = _models(seed=2)
    prompts = _tokens(jcfg, 3, 12, seed=2)
    gen = 10
    jstep = jax.jit(rm.make_serve_step(jcfg))
    cache = rm.init_decode_cache(jcfg, 3, 12 + gen)
    for t in range(12):
        logits, cache = jstep(jp, cache,
                              {"tokens": jnp.asarray(prompts[:, t:t + 1])})
    want = []
    for _ in range(gen):
        tok = logits[:, -1, :jcfg.vocab].astype(jnp.float32).argmax(-1)
        tok = tok[:, None].astype(jnp.int32)
        want.append(np.asarray(tok))
        logits, cache = jstep(jp, cache, {"tokens": tok})
    got = generate(model, tcfg, prompts, gen, 0.0, torch.Generator(), CPU)
    assert np.array_equal(got["tokens"], np.concatenate(want, axis=1))


# ------------------------------------------------------------------ weights


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip_bit_identical(dtype):
    jcfg, tcfg, jp, model = _models(dtype=dtype, seed=3)
    tree = export_params(model)
    want = jax.tree.map(f32, jp)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        assert a.dtype == np.float32 and np.array_equal(a.view(np.int32),
                                                        b.view(np.int32))
    fresh = init_params(tcfg, torch.Generator().manual_seed(9), "cpu")
    load_reference_params(fresh, tree)
    for (n, a), (_, b) in zip(fresh.named_parameters(),
                              model.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(
            a.view(torch.int16 if a.dtype == torch.bfloat16 else
                   torch.int32),
            b.view(torch.int16 if b.dtype == torch.bfloat16 else
                   torch.int32)), n


def test_convert_takes_bf16_bits_and_refuses_inexact_values():
    jcfg, tcfg, jp, model = _models(dtype="bfloat16", seed=4)
    bits = jax.tree.map(lambda a: np.asarray(a).view(np.uint16), jp)
    fresh = init_params(tcfg, torch.Generator().manual_seed(9), "cpu")
    load_reference_params(fresh, bits)
    assert all(torch.equal(a, b) for a, b in zip(fresh.parameters(),
                                                 model.parameters()))
    tree = export_params(model)
    tree["lm_head"] = tree["lm_head"] + np.float32(1e-6)
    with pytest.raises(ValueError, match="not exactly representable"):
        load_reference_params(fresh, tree)
