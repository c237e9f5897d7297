"""The Mamba-2 (SSD) block (``repro_torch.models.ssm``) against the JAX
reference (``repro.models.ssm``) on the CPU, function by function.

The same seeded numpy inputs and the reference's own parameters (carried
across as numpy) go through both packages in f32.  Tolerances:

* data movement (``_split_proj``, the cache's layout) bit for bit;
* ``_softplus`` and ``_causal_conv``: rtol = atol = 1e-6 (a few f32 ops);
* the block over a sequence, one step, a chain of steps: rtol = atol =
  1e-4 (f32 products 64-512 wide, a state carried over 8-32 chunks);
* gradients (``jax.grad`` through the reference's checkpointed chunks,
  autograd through the port's): each within 2e-4 of its largest
  magnitude;
* the step chain against the chunked forward inside the port: the
  reference's own 2e-4 (``tests/test_models_consistency.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as S
from repro_torch.models import ssm as T

D, N, HD = 32, 16, 16
REC = dict(rtol=1e-4, atol=1e-4)
ELEM = dict(rtol=1e-6, atol=1e-6)
GRAD_REL = 2e-4


@pytest.fixture(autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def _params(seed=0):
    jp = S.init_mamba_params(jax.random.PRNGKey(seed), D, N, head_dim=HD)
    rng = np.random.default_rng(seed)
    # nonzero conv bias and dt bias, a norm that is not all ones
    jp["conv_b"] = jnp.asarray((rng.standard_normal(jp["conv_b"].shape)
                                * 0.1).astype(np.float32))
    jp["dt_bias"] = jnp.asarray(rng.uniform(-2, 1, jp["dt_bias"].shape)
                                .astype(np.float32))
    jp["norm"] = jnp.asarray((1 + 0.1 * rng.standard_normal(D * 2))
                             .astype(np.float32))
    return jp, {k: torch.from_numpy(f32(v)) for k, v in jp.items()}


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mamba_params_leaves(dtype):
    """The reference's leaves, shapes and dtypes (A_log, D and dt_bias f32
    in a bf16 block); A_log, D, dt_bias, conv_b and norm exactly the
    reference's."""
    want = S.init_mamba_params(jax.random.PRNGKey(0), D, N, head_dim=HD,
                               dtype=jnp.dtype(dtype))
    got = T.init_mamba_params(torch.Generator().manual_seed(0), D, N,
                              head_dim=HD, dtype=getattr(torch, dtype))
    assert list(got) == list(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k
    for k in ("A_log", "D", "dt_bias", "conv_b", "norm"):
        np.testing.assert_allclose(f32(got[k]), f32(want[k]), rtol=1e-6,
                                   atol=0, err_msg=k)


def test_softplus_is_logaddexp():
    """``jax.nn.softplus`` across the range where ``F.softplus``'s
    threshold (20) would return x itself."""
    x = np.concatenate([np.linspace(-60, 60, 2401, dtype=np.float32),
                        np.array([-1e30, 1e30, 0.0, -0.0], np.float32)])
    want = jax.nn.softplus(jnp.asarray(x))
    got = T._softplus(torch.from_numpy(x))
    np.testing.assert_allclose(f32(got), f32(want), **ELEM)


def test_causal_conv_matches_reference():
    x = _x(1, 2, 9, 20)
    w, b = _x(2, 20, 4), _x(3, 20)
    want = S._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = T._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b))
    np.testing.assert_allclose(f32(got), f32(want), **ELEM)


def test_causal_conv_bf16_sums_in_bf16():
    """In bf16 the four shifted products are rounded and summed one by one
    in the activation dtype, as the reference writes them (a convolution
    library call accumulates in f32 and rounds once)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 12, 8)).astype(
        np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((8, 4)).astype(
        np.float32)).bfloat16()
    b = torch.zeros(8, dtype=torch.bfloat16)
    got = T._causal_conv(x, w, b)
    want = x * w[:, 3]
    for i in range(1, 4):
        sh = torch.cat([torch.zeros_like(x[:, :i]), x[:, :-i]], 1)
        want = want + sh * w[:, 3 - i]
    assert got.dtype == torch.bfloat16 and torch.equal(got, want + b)


def test_split_proj_bit_equal():
    d_inner, heads = 2 * D, 2 * D // HD
    z = _x(5, 2, 3, 2 * d_inner + 2 * N + heads)
    want = S._split_proj(jnp.asarray(z), d_inner, N, heads)
    got = T._split_proj(torch.from_numpy(z), d_inner, N, heads)
    for g, w in zip(got, want):
        assert np.array_equal(f32(g), f32(w))


@pytest.mark.parametrize("s,chunk", [(32, 4), (256, 128), (64, 64),
                                     (12, 4)])
def test_mamba_forward_matches_reference(s, chunk):
    """Chunks of 4 (8 of them), of 128 (2), one chunk, and the reference's
    property length 12 in chunks of 4."""
    jp, tp = _params(1)
    x = _x(6, 2, s, D)
    want = S.mamba_forward(jp, jnp.asarray(x), d_state=N, head_dim=HD,
                           chunk=chunk)
    got = T.mamba_forward(tp, torch.from_numpy(x), d_state=N, head_dim=HD,
                          chunk=chunk)
    np.testing.assert_allclose(f32(got), f32(want), **REC)


def test_mamba_forward_refuses_ragged_length():
    _, tp = _params(1)
    with pytest.raises(AssertionError):
        T.mamba_forward(tp, torch.zeros(1, 12, D), d_state=N, head_dim=HD,
                        chunk=8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mamba_cache(dtype):
    want = S.init_mamba_cache(3, D, N, HD, dtype=jnp.dtype(dtype))
    got = T.init_mamba_cache(3, D, N, HD, dtype=getattr(torch, dtype))
    for name in ("conv", "h"):
        g, w = getattr(got, name), getattr(want, name)
        assert tuple(g.shape) == w.shape and not bool(g.any())
        assert str(g.dtype).split(".")[-1] == str(w.dtype), name
    stacked = T.init_mamba_cache(3, D, N, HD, prefix=(2, 5))
    assert stacked.h.shape == (2, 5, 3, 4, HD, N)
    assert stacked.layer(1, 3).conv.data_ptr() == \
        stacked.conv[1, 3].data_ptr()


def test_mamba_step_chain_matches_reference():
    """Sixteen steps from a zero cache on both sides: every output and the
    final cache (the conv window holds the last three projected inputs)."""
    jp, tp = _params(2)
    x = _x(7, 2, 16, D)
    jc = S.init_mamba_cache(2, D, N, HD, dtype=jnp.float32)
    tc = T.init_mamba_cache(2, D, N, HD, dtype=torch.float32)
    for i in range(x.shape[1]):
        jy, jc = S.mamba_step(jp, jc, jnp.asarray(x[:, i:i + 1]), d_state=N,
                              head_dim=HD)
        ty, back = T.mamba_step(tp, tc, torch.from_numpy(x[:, i:i + 1]),
                                d_state=N, head_dim=HD)
        assert back is tc and ty.shape == (2, 1, D)
        np.testing.assert_allclose(f32(ty), f32(jy), err_msg=str(i), **REC)
    np.testing.assert_allclose(f32(tc.h), f32(jc.h), **REC)
    np.testing.assert_allclose(f32(tc.conv), f32(jc.conv), **REC)


@pytest.mark.parametrize("chunk,t", [(4, 12), (4, 32), (128, 256)])
def test_mamba_chunked_equals_step_in_port(chunk, t):
    """The reference's property (``test_mamba_chunked_equals_step``) on
    the port, at chunks of 4 and of 128."""
    _, tp = _params(3)
    x = torch.from_numpy(_x(8, 2, t, D))
    y_chunk = T.mamba_forward(tp, x, d_state=N, head_dim=HD, chunk=chunk)
    cache = T.init_mamba_cache(2, D, N, HD, dtype=torch.float32)
    ys = [T.mamba_step(tp, cache, x[:, i:i + 1], d_state=N,
                       head_dim=HD)[0] for i in range(t)]
    torch.testing.assert_close(y_chunk, torch.cat(ys, 1), rtol=2e-4,
                               atol=2e-4)


def _assert_grads_close(got, want):
    for name, w in want.items():
        g, w = f32(got[name]), f32(w)
        bound = GRAD_REL * max(np.abs(w).max(), 1e-30)
        assert np.isfinite(g).all(), name
        assert np.abs(g - w).max() <= bound, (name, np.abs(g - w).max(),
                                              bound)


@pytest.mark.parametrize("s,chunk", [(32, 4), (256, 128)])
def test_mamba_forward_grads_match_jax_grad(s, chunk):
    """Every parameter's and the input's gradient of a projection of the
    output (finite: the SSD masks before ``exp``)."""
    jp, tp = _params(4)
    x = _x(9, 1, s, D)
    cot = _x(10, 1, s, D)

    def jloss(p, xx):
        return (S.mamba_forward(p, xx, d_state=N, head_dim=HD, chunk=chunk)
                * cot).sum()
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    (T.mamba_forward(leaves, xt, d_state=N, head_dim=HD, chunk=chunk)
     * torch.from_numpy(cot)).sum().backward()
    _assert_grads_close({k: v.grad for k, v in leaves.items()}, jg)
    _assert_grads_close({"x": xt.grad}, {"x": jgx})
