"""The RWKV-6 block (``repro_torch.models.rwkv``) against the JAX reference
(``repro.models.rwkv``) on the CPU, function by function.

The same seeded numpy inputs and the reference's own parameters (carried
across as numpy) go through both packages in f32.  Tolerances:

* data movement (``_token_shift``, the cache's layout) bit for bit;
* one projection or normalisation (``_wkv_inputs``, ``_group_norm``,
  channel-mix): rtol = atol = 1e-5 (f32 products of 128-wide rows summed
  in another order);
* the WKV recurrences, the time-mix and the block (a state carried over
  64 steps or 4 chunks, ``exp(±L)`` of cumulative log-decays): rtol =
  atol = 1e-4;
* gradients (``jax.grad`` through the reference's checkpointed chunks,
  autograd through the port's): each within 2e-4 of its largest
  magnitude;
* chunked against sequential inside the port: the reference's own 1e-3
  (``tests/test_models_consistency.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv as R
from repro_torch.models import rwkv as T

D, FF, HD = 64, 160, 16
H = D // HD
ONE = dict(rtol=1e-5, atol=1e-5)
REC = dict(rtol=1e-4, atol=1e-4)
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


def _params(seed=0, dtype=jnp.float32):
    jp = R.init_rwkv_params(jax.random.PRNGKey(seed), D, FF, head_dim=HD,
                            dtype=dtype)
    # a spread of decays, so the chunks' exp(±L) see more than w0 = -4
    # (above -1 a 128-token chunk overflows: test_wkv_chunked_overflow_...)
    jp["w0"] = jnp.asarray(np.random.default_rng(seed).uniform(
        -6.0, -1.0, D).astype(np.float32))
    return jp, {k: torch.from_numpy(f32(v)) for k, v in jp.items()}


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _wkv_args(seed, b, t, wmin=0.02, wmax=0.98):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, t, H, HD)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(wmin, wmax, (b, t, H, HD)).astype(np.float32)
    u = (rng.standard_normal((H, HD)) * 0.1).astype(np.float32)
    s0 = rng.standard_normal((b, H, HD, HD)).astype(np.float32)
    return r, k, v, w, u, s0


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_rwkv_params_leaves(dtype):
    """The reference's leaves, shapes and dtypes (w0 and u f32 in a bf16
    block); w0 = -4, the lerp weights in [0, 1), ln_g ones."""
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = R.init_rwkv_params(jax.random.PRNGKey(0), D, FF, head_dim=HD,
                              dtype=jd)
    got = T.init_rwkv_params(torch.Generator().manual_seed(0), D, FF,
                             head_dim=HD, dtype=td)
    assert list(got) == list(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k
    assert bool((got["w0"] == -4.0).all())
    assert bool((got["ln_g"] == 1).all())
    for k in ("mix", "mix_c"):
        assert 0.0 <= float(got[k].min()) and float(got[k].max()) < 1.0


def test_token_shift_bit_equal():
    x, xp = _x(0, 2, 9, D), _x(1, 2, D)
    want = R._token_shift(jnp.asarray(x), jnp.asarray(xp))
    got = T._token_shift(torch.from_numpy(x), torch.from_numpy(xp))
    assert np.array_equal(f32(got), f32(want))


def test_wkv_inputs_match_reference():
    jp, tp = _params()
    x, xp = _x(2, 2, 12, D), _x(3, 2, 12, D)
    want = R._wkv_inputs(jp, jnp.asarray(x), jnp.asarray(xp), HD)
    got = T._wkv_inputs(tp, torch.from_numpy(x), torch.from_numpy(xp), HD)
    for name, g, w in zip("rkvgw", got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(f32(g), f32(w), err_msg=name, **ONE)


@pytest.mark.parametrize("t", [1, 7, 64])
def test_wkv_scan_matches_reference(t):
    args = _wkv_args(4, 2, t)
    (jr, jk, jv, jw, ju, js), (tr, tk, tv, tw, tu, ts) = _both(*args)
    y1, s1 = R._wkv_scan(jr, jk, jv, jw, ju, js)
    y2, s2 = T._wkv_scan(tr, tk, tv, tw, tu, ts)
    assert y2.dtype == s2.dtype == torch.float32
    np.testing.assert_allclose(f32(y2), f32(y1), **REC)
    np.testing.assert_allclose(f32(s2), f32(s1), **REC)


@pytest.mark.parametrize("t,chunk", [(64, 16), (64, 128), (50, 16),
                                     (24, 8)])
def test_wkv_chunked_matches_reference(t, chunk):
    """4 chunks of 16, one whole chunk (T < chunk), the ragged fallback to
    the scan (50 % 16 != 0) and 3 chunks of 8."""
    args = _wkv_args(5, 2, t, wmin=0.3)
    (jr, jk, jv, jw, ju, js), (tr, tk, tv, tw, tu, ts) = _both(*args)
    y1, s1 = R._wkv_chunked(jr, jk, jv, jw, ju, js, chunk)
    y2, s2 = T._wkv_chunked(tr, tk, tv, tw, tu, ts, chunk)
    np.testing.assert_allclose(f32(y2), f32(y1), **REC)
    np.testing.assert_allclose(f32(s2), f32(s1), **REC)


@pytest.mark.parametrize("seed,b,t,wmax", [(0, 1, 8, 0.5), (1, 2, 16, 0.98),
                                           (2, 3, 32, 0.05),
                                           (3, 4, 32, 0.9),
                                           (4, 2, 24, 0.7)])
def test_wkv_chunked_equals_sequential_in_port(seed, b, t, wmax):
    """The reference's property (``test_wkv_chunked_equals_sequential``)
    on the port: chunks of 8 against the scan, from a zero state."""
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.standard_normal((b, t, 2, 8)).astype(
        np.float32)) for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.02, wmax, (b, t, 2, 8)).astype(
        np.float32))
    u = torch.from_numpy((rng.standard_normal((2, 8)) * 0.1).astype(
        np.float32))
    s0 = torch.zeros(b, 2, 8, 8)
    y1, s1 = T._wkv_scan(r, k, v, w, u, s0)
    y2, s2 = T._wkv_chunked(r, k, v, w, u, s0, chunk=8)
    torch.testing.assert_close(y2, y1, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(s2, s1, rtol=1e-3, atol=1e-3)


def test_wkv_chunked_overflow_as_reference():
    """The reference's unguarded ``exp(-L)``: a decay of 0.4 a step over a
    128-token chunk takes L to 128 log 0.4 = -117, past f32's exp range,
    and both packages give the same non-finite outputs (the scan stays
    finite).  Reproduced, not repaired."""
    args = list(_wkv_args(26, 1, 128))
    args[3] = np.full_like(args[3], 0.4)
    (jr, jk, jv, jw, ju, js), (tr, tk, tv, tw, tu, ts) = _both(*args)
    y1, s1 = R._wkv_chunked(jr, jk, jv, jw, ju, js, 128)
    y2, s2 = T._wkv_chunked(tr, tk, tv, tw, tu, ts, 128)
    assert not np.isfinite(f32(y1)).all()
    assert np.array_equal(np.isfinite(f32(y2)), np.isfinite(f32(y1)))
    assert np.array_equal(np.isfinite(f32(s2)), np.isfinite(f32(s1)))
    assert bool(torch.isfinite(T._wkv_scan(tr, tk, tv, tw, tu, ts)[0]).all())


def test_group_norm_matches_reference():
    """Population variance (ddof 0), per head; a head with a large offset
    and a constant head included."""
    y = _x(6, 2, 5, H, HD)
    y[:, :, 0] += 40.0
    y[:, :, 1] = 0.5
    g = _x(7, D)
    want = R._group_norm(jnp.asarray(y), jnp.asarray(g), HD)
    got = T._group_norm(torch.from_numpy(y), torch.from_numpy(g), HD)
    np.testing.assert_allclose(f32(got), f32(want), **ONE)


@pytest.mark.parametrize("t", [1, 32, 40])
def test_time_mix_matches_reference(t):
    """One token (the scan), 2 chunks of 16, and 40 tokens (ragged: the
    scan), from a nonzero previous token and state."""
    jp, tp = _params(1)
    x, xp = _x(8, 2, t, D), _x(9, 2, D)
    s0 = _x(10, 2, H, HD, HD, scale=0.1)
    want = R.rwkv_time_mix(jp, jnp.asarray(x), jnp.asarray(xp),
                           jnp.asarray(s0), HD, chunk=16)
    got = T.rwkv_time_mix(tp, torch.from_numpy(x), torch.from_numpy(xp),
                          torch.from_numpy(s0), HD, chunk=16)
    for name, g, w in zip(("out", "last_x", "s_T"), got, want):
        np.testing.assert_allclose(f32(g), f32(w), err_msg=name, **REC)


def test_channel_mix_matches_reference():
    jp, tp = _params(2)
    x, xp = _x(11, 2, 6, D), _x(12, 2, D)
    want = R.rwkv_channel_mix(jp, jnp.asarray(x), jnp.asarray(xp))
    got = T.rwkv_channel_mix(tp, torch.from_numpy(x), torch.from_numpy(xp))
    np.testing.assert_allclose(f32(got[0]), f32(want[0]), **ONE)
    assert np.array_equal(f32(got[1]), f32(want[1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_rwkv_cache(dtype):
    want = R.init_rwkv_cache(3, D, HD, jnp.dtype(dtype))
    got = T.init_rwkv_cache(3, D, HD, getattr(torch, dtype))
    for name in ("tm_x", "cm_x", "s"):
        g, w = getattr(got, name), getattr(want, name)
        assert tuple(g.shape) == w.shape and not bool(g.any())
        assert str(g.dtype).split(".")[-1] == str(w.dtype), name
    stacked = T.init_rwkv_cache(3, D, HD, prefix=(5,))
    assert stacked.s.shape == (5, 3, H, HD, HD)
    assert stacked.layer(2).tm_x.data_ptr() == stacked.tm_x[2].data_ptr()


def _ln(seed):
    return (1.0 + 0.1 * _x(seed, D)).astype(np.float32)


def test_rwkv_forward_matches_reference():
    jp, tp = _params(3)
    x = _x(13, 2, 64, D)
    ln1, ln2 = _ln(14), _ln(15)
    want = R.rwkv_forward(jp, jnp.asarray(x), jnp.asarray(ln1),
                          jnp.asarray(ln2), HD)
    got = T.rwkv_forward(tp, torch.from_numpy(x), torch.from_numpy(ln1),
                         torch.from_numpy(ln2), HD)
    np.testing.assert_allclose(f32(got), f32(want), **REC)


def test_rwkv_step_chain_matches_reference_and_forward():
    """Twelve one-token steps from a zero cache on both sides: every
    output and the final cache against the reference's chain, and the
    outputs against the port's own whole-sequence forward."""
    jp, tp = _params(4)
    x = _x(16, 2, 12, D)
    ln1, ln2 = _ln(17), _ln(18)
    jcache = R.init_rwkv_cache(2, D, HD, jnp.float32)
    tcache = T.init_rwkv_cache(2, D, HD, torch.float32)
    outs = []
    for i in range(x.shape[1]):
        jy, jcache = R.rwkv_step(jp, jcache, jnp.asarray(x[:, i:i + 1]),
                                 jnp.asarray(ln1), jnp.asarray(ln2), HD)
        ty, back = T.rwkv_step(tp, tcache, torch.from_numpy(x[:, i:i + 1]),
                               torch.from_numpy(ln1), torch.from_numpy(ln2),
                               HD)
        assert back is tcache
        np.testing.assert_allclose(f32(ty), f32(jy), err_msg=str(i), **REC)
        outs.append(ty)
    for name in ("tm_x", "cm_x", "s"):
        np.testing.assert_allclose(f32(getattr(tcache, name)),
                                   f32(getattr(jcache, name)), err_msg=name,
                                   **REC)
    whole = T.rwkv_forward(tp, torch.from_numpy(x), torch.from_numpy(ln1),
                           torch.from_numpy(ln2), HD)
    torch.testing.assert_close(torch.cat(outs, 1), whole, rtol=2e-4,
                               atol=2e-4)


def _assert_grads_close(got, want):
    for name, w in want.items():
        g, w = f32(got[name]), f32(w)
        bound = GRAD_REL * max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= bound, (name, np.abs(g - w).max(),
                                              bound)


def test_wkv_chunked_grads_match_jax_grad():
    """d(sum(y * cy) + sum(s_T * cs)) by r, k, v, w, u and s0, through the
    reference's checkpointed chunks and the port's."""
    args = _wkv_args(19, 2, 32, wmin=0.3)
    cy = _x(20, 2, 32, H, HD)
    cs = _x(21, 2, H, HD, HD)

    def jloss(*a):
        y, s = R._wkv_chunked(*a, chunk=8)
        return (y * cy).sum() + (s * cs).sum()
    want = jax.grad(jloss, argnums=tuple(range(6)))(
        *[jnp.asarray(a) for a in args])
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, s = T._wkv_chunked(*ts, chunk=8)
    ((y * torch.from_numpy(cy)).sum()
     + (s * torch.from_numpy(cs)).sum()).backward()
    _assert_grads_close({n: t.grad for n, t in zip("rkvwus", ts)},
                        dict(zip("rkvwus", want)))


def test_rwkv_forward_grads_match_jax_grad():
    """Every parameter's and the input's gradient of a projection of the
    block's output over 256 tokens: two chunks of the default 128."""
    jp, tp = _params(5)
    x = _x(22, 1, 256, D, scale=0.5)
    ln1, ln2 = _ln(23), _ln(24)
    cot = _x(25, 1, 256, D)

    def jloss(p, xx):
        return (R.rwkv_forward(p, xx, jnp.asarray(ln1), jnp.asarray(ln2),
                               HD) * cot).sum()
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    (T.rwkv_forward(leaves, xt, torch.from_numpy(ln1),
                    torch.from_numpy(ln2), HD)
     * torch.from_numpy(cot)).sum().backward()
    _assert_grads_close({k: v.grad for k, v in leaves.items()}, jg)
    _assert_grads_close({"x": xt.grad}, {"x": jgx})
