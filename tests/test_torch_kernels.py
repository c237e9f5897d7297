"""The port's kernel wrappers against the JAX reference.

On the CPU a wrapper runs its kernel's plain PyTorch version (``ref``); the
inputs are made with numpy from a seed and fed to both packages.  The JAX
side runs the Pallas kernels as the repo's own tests do here (interpret
mode, ``use_pallas=True``) or their jnp oracles.

Tolerances: the combine moves data, so it is bit-equal.  The segment sum
and the fused layer sum in another order than XLA: forward rtol=1e-5,
atol=1e-5; gradients (the analytic backwards inside
``torch.autograd.Function``) rtol=1e-4, atol=1e-5.

The kernels themselves are held against their plain versions on the card
in ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32)
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


def _combine_case(seed, case, n=300, k=40, m=23, f=100, specials=True):
    rng = np.random.default_rng(seed)
    cache = rng.standard_normal((k, f)).astype(np.float32)
    if specials:
        cache[0, :3] = [0.0, -0.0, 1e-40]      # signed zero, denormal
    miss = rng.standard_normal((m, f)).astype(np.float32)
    slots = rng.integers(-1, k, n).astype(np.int32)
    if case == "no_cache":
        cache, slots = None, np.full(n, -1, np.int32)
    if case == "all_hit":
        slots = rng.integers(0, k, n).astype(np.int32)
        miss = miss[:0]
    if case == "duplicates":                    # many positions, few rows
        slots = np.where(rng.random(n) < 0.5, rng.integers(0, 3, n),
                         -1).astype(np.int32)
    mi = np.where(slots < 0, rng.integers(0, max(miss.shape[0], 1), n),
                  0).astype(np.int32)
    return cache, miss, slots, mi


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["mixed", "no_cache", "all_hit",
                                  "duplicates"])
def test_combine_bit_equal_to_reference(case, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16

    def both(specials):
        cache, miss, slots, mi = _combine_case(11, case, specials=specials)
        jc = None if cache is None else jnp.asarray(cache, jdt)
        tc = None if cache is None else torch.from_numpy(cache).to(tdt)
        got = ops.assemble_features(tc, torch.from_numpy(miss).to(tdt),
                                    slots, mi)
        return got, (jc, jnp.asarray(miss, jdt), slots, mi)

    got, jargs = both(specials=True)
    oracle = jops.assemble_features(*jargs, use_pallas=False)
    assert np.array_equal(_bits(got), _bits(oracle))
    if case != "all_hit":   # the tiled Pallas schedule needs a miss row
        # the Pallas kernel's one-hot product turns -0.0 into +0.0 and
        # flushes denormals, so it is compared on normal values only
        got, jargs = both(specials=False)
        pallas = jops.assemble_features(*jargs, use_pallas=True)
        assert np.array_equal(_bits(got), _bits(pallas))


def test_expand_rows_is_cacheless_combine():
    _, miss, _, _ = _combine_case(3, "mixed")
    inv = np.random.default_rng(4).integers(0, miss.shape[0], 77)
    tm = torch.from_numpy(miss)
    got = ref.expand_rows(tm, torch.from_numpy(inv))
    assert np.array_equal(_bits(got),
                          _bits(jref.expand_rows(jnp.asarray(miss),
                                                 jnp.asarray(inv))))
    assert torch.equal(got, ops.assemble_features(
        None, tm, np.full(77, -1, np.int32), inv.astype(np.int32)))


def _layer_inputs(seed, d, fanout, f, o):
    rng = np.random.default_rng(seed)
    return dict(
        x_self=rng.standard_normal((d, f)).astype(np.float32),
        x_nbr=rng.standard_normal((d * fanout, f)).astype(np.float32),
        w_edge=rng.random(d * fanout).astype(np.float32),
        self_scale=rng.random(d).astype(np.float32),
        w_self=(rng.standard_normal((f, o)) / np.sqrt(f)).astype(np.float32),
        w_agg=(rng.standard_normal((f, o)) / np.sqrt(f)).astype(np.float32),
        bias=rng.standard_normal(o).astype(np.float32),
        g=rng.standard_normal((d, o)).astype(np.float32))


SHAPES = [(37, 5, 100, 32), (8, 10, 16, 7), (130, 3, 33, 47)]


@pytest.mark.parametrize("d,fanout,f,o", SHAPES)
def test_segment_sum_forward_and_grad(d, fanout, f, o):
    x = _layer_inputs(d, d, fanout, f, o)
    g = np.random.default_rng(1).standard_normal((d, f)).astype(np.float32)
    xn = torch.from_numpy(x["x_nbr"]).requires_grad_()
    we = torch.from_numpy(x["w_edge"]).requires_grad_()
    out = ops.segment_weighted_sum_regular(xn, we, fanout)
    jout = jops.segment_weighted_sum_regular(jnp.asarray(x["x_nbr"]),
                                             jnp.asarray(x["w_edge"]),
                                             fanout)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FWD)
    gx, gw = torch.autograd.grad(out, (xn, we), torch.from_numpy(g))

    def jloss(a, b):
        return jnp.sum(jops.segment_weighted_sum_regular(a, b, fanout) * g)

    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x["x_nbr"]),
                                               jnp.asarray(x["w_edge"]))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **GRAD)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), **GRAD)


@pytest.mark.parametrize("d,fanout,f,o", SHAPES)
@pytest.mark.parametrize("has_bias", [True, False])
def test_fused_layer_forward_and_grad(d, fanout, f, o, has_bias):
    x = _layer_inputs(d + o, d, fanout, f, o)
    names = ["x_self", "x_nbr", "w_edge", "self_scale", "w_self", "w_agg",
             "bias"]
    if not has_bias:
        names = names[:-1]
    targs = [torch.from_numpy(x[n]).requires_grad_() for n in names]
    out = ops.fused_gnn_update(*targs, *([] if has_bias else [None]),
                               fanout)
    jargs = [jnp.asarray(x[n]) for n in names]

    def jfwd(*a):
        a = list(a) + ([] if has_bias else [None])
        return jops.fused_gnn_update(*a, fanout)

    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jfwd(*jargs)), **FWD)
    grads = torch.autograd.grad(out, targs, torch.from_numpy(x["g"]))
    jgrads = jax.grad(lambda *a: jnp.sum(jfwd(*a) * x["g"]),
                      argnums=tuple(range(len(names))))(*jargs)
    for n, a, b in zip(names, grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=n,
                                   **GRAD)


def test_plain_fused_layer_equals_reference_oracle():
    x = _layer_inputs(5, 20, 4, 24, 9)
    names = ["x_self", "x_nbr", "w_edge", "self_scale", "w_self", "w_agg",
             "bias"]
    got = ref.fused_gnn_update(*[torch.from_numpy(x[n]) for n in names], 4)
    want = jref.fused_gnn_update(*[jnp.asarray(x[n]) for n in names], 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def test_launch_counters_untouched_on_cpu():
    ops.reset_kernel_launches()
    x = _layer_inputs(2, 8, 3, 16, 5)
    ops.segment_weighted_sum_regular(torch.from_numpy(x["x_nbr"]),
                                     torch.from_numpy(x["w_edge"]), 3)
    assert ops.kernel_launches() == {k: 0 for k in ops.KERNELS}
