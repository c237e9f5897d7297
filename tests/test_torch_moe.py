"""The port's routed MoE layer (``repro_torch/models/moe.py``) against the
JAX reference (``repro/models/moe.py``) on the CPU.

The same numpy inputs go through both packages.  The routing is integer
math and compares bit for bit: ``_capacity``, the top-k experts (ties
broken toward the lower index, as ``jax.lax.top_k``), and every index
array of ``_routing_indices`` (the reference's vmapped over rows).  Float
results, f32: the gate weights within 1e-6 (a softmax over K values);
``moe_ffn``'s output, aux loss and gradients within rtol = atol = 1e-5
(products summed in another order than XLA's).  The reference's own
properties (``tests/test_moe.py``) are held on the port with the
reference's bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import moe as rmoe
from repro_torch.models import moe as tmoe

F32 = dict(rtol=1e-5, atol=1e-5)
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


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


def _logits(kind: str, shape, seed: int) -> np.ndarray:
    """Router logits: plain normals, or normals snapped to a grid of 0.25
    so that most rows hold exact ties among their top experts."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.round(x * 4) / 4 if kind == "tied" else x


def _pair(x: np.ndarray, dtype: torch.dtype):
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("factor", [0.25, 1.0, 1.25, 2.0, 4.0, 8.0, 16.0])
def test_capacity_equal(factor):
    for tokens in (1, 3, 7, 64, 100, 512, 4096, 4128, 8192):
        for e in (2, 4, 8, 16):
            for k in (1, 2):
                assert tmoe._capacity(tokens, e, k, factor) == \
                    rmoe._capacity(tokens, e, k, factor), (tokens, e, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("kind", ["random", "tied"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_router_assignment_matches_reference(top_k, kind, dtype):
    x = _logits(kind, (96, 8), seed=top_k)
    jx, tx = _pair(x, dtype)
    jw, je = rmoe.router_assignment(jx, top_k)
    tw, te = tmoe.router_assignment(tx, top_k)
    assert np.array_equal(te.numpy(), np.asarray(je))
    assert tw.dtype == torch.float32
    np.testing.assert_allclose(f32(tw), f32(jw), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(f32(tw).sum(-1), np.ones(96), rtol=1e-6)


def test_planted_ties_pick_the_lower_expert():
    """Rows whose top values are equal: both packages list the lower
    expert first (``torch.topk`` promises no order); +0.0 ranks above
    -0.0, as in XLA's totalOrder."""
    x = np.full((4, 8), -1.0, np.float32)
    x[0, [2, 5]] = 1.0                     # a tie for first
    x[1, [1, 6, 7]] = 2.0                  # three-way tie
    x[2, :] = 0.5                          # every expert tied
    x[3, [1, 3, 4]] = [-0.0, 0.0, -0.0]    # signed zeros
    for dtype in (torch.float32, torch.bfloat16):
        jx, tx = _pair(x, dtype)
        _, je = rmoe.router_assignment(jx, 2)
        _, te = tmoe.router_assignment(tx, 2)
        assert te.tolist() == np.asarray(je).tolist() == [[2, 5], [1, 6],
                                                          [0, 1], [3, 1]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("kind", ["random", "tied"])
@pytest.mark.parametrize("factor", [0.25, 1.25, 8.0])
@pytest.mark.parametrize("top_k", [1, 2])
def test_routing_indices_bit_equal(top_k, factor, kind, dtype):
    """Every index array, batched over 3 rows of 64 tokens, equal element
    for element to the reference's vmapped over the rows."""
    b, t, e = 3, 64, 8
    x = _logits(kind, (b, t, e), seed=int(factor * 8) + top_k)
    jx, tx = _pair(x, dtype)
    cap = rmoe._capacity(t, e, top_k, factor)
    want = jax.vmap(lambda lg: rmoe._routing_indices(lg, top_k, cap))(jx)
    got = tmoe._routing_indices(tx, top_k, cap)
    names = ("token_for_slot", "slot_valid", "slot_for_assign", "keep",
             "experts")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        assert np.array_equal(g.numpy(), w), name
    if factor == 0.25:                     # the tight capacity drops
        assert not bool(got[3].all())
    if factor == 8.0:
        assert bool(got[3].all())
    # one row alone gives that row's arrays
    row = tmoe._routing_indices(tx[1], top_k, cap)
    for g, r in zip(got, row):
        assert torch.equal(g[1], r)


def _moe_pair(d, f, e, seed, dtype=torch.float32):
    jp = rmoe.init_moe_params(jax.random.PRNGKey(seed), d, f, e,
                              JDT[dtype])
    tp = {k: torch.from_numpy(f32(v)).to(dtype) for k, v in jp.items()}
    return jp, tp


@pytest.mark.parametrize("factor", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_and_grads_match_reference(top_k, factor):
    """Output, aux and the gradients of x and all four parameter groups
    (f32, reduced widths) against ``jax.grad`` of the reference, the loss
    ``sum(out * w) + 0.01 aux`` with a fixed cotangent ``w``."""
    b, s, d, f, e = 2, 48, 32, 64, 4
    jp, tp = _moe_pair(d, f, e, seed=top_k)
    rng = np.random.default_rng(7 + top_k)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = rng.standard_normal((b, s, d)).astype(np.float32)

    def jloss(p, xx):
        out, aux = rmoe.moe_ffn(xx, p, top_k=top_k, capacity_factor=factor)
        return jnp.sum(out * w) + 0.01 * aux, (out, aux)
    (jl, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))

    tx = torch.from_numpy(x).requires_grad_()
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    out, aux = tmoe.moe_ffn(tx, leaves, top_k=top_k, capacity_factor=factor)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    loss = (out * torch.from_numpy(w)).sum() + 0.01 * aux
    grads = torch.autograd.grad(loss, [tx, *leaves.values()])
    np.testing.assert_allclose(f32(out), f32(jout), **F32)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(f32(grads[0]), f32(jgx), **F32)
    for name, g in zip(leaves, grads[1:]):
        np.testing.assert_allclose(f32(g), f32(jgp[name]), err_msg=name,
                                   **F32)


def test_moe_ffn_bf16_matches_reference():
    """bf16 activations and weights: the output within two bf16 ulps
    (1.6e-2; the expert products and the combine round in both packages,
    and these inputs route alike) and the f32 aux within 1e-5."""
    b, s, d, f, e = 2, 32, 32, 64, 8
    jp, tp = _moe_pair(d, f, e, seed=5, dtype=torch.bfloat16)
    x = np.random.default_rng(5).standard_normal((b, s, d)).astype(
        np.float32)
    jx, tx = _pair(x, torch.bfloat16)
    jout, jaux = rmoe.moe_ffn(jx, jp, top_k=2, capacity_factor=1.25)
    out, aux = tmoe.moe_ffn(tx, tp, top_k=2, capacity_factor=1.25)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(out), f32(jout), rtol=1.6e-2, atol=1.6e-2)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


# ----------------------------------------- the reference's own properties


def _dense_reference(x, params, top_k):
    """Per-token evaluation of the selected experts (no capacity)."""
    b, s, d = x.shape
    logits = x @ params["router"]
    w, experts = tmoe.router_assignment(logits.reshape(b * s, -1), top_k)
    xf = x.reshape(b * s, d)
    out = torch.zeros_like(xf)
    for i in range(b * s):
        for j in range(top_k):
            ex = int(experts[i, j])
            h = F.silu(xf[i] @ params["w1"][ex]) * (xf[i] @ params["w3"][ex])
            out[i] += w[i, j] * (h @ params["w2"][ex])
    return out.reshape(b, s, d)


def test_moe_matches_dense_reference_when_capacity_ample():
    _, tp = _moe_pair(16, 32, 4, seed=0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 6, 16)).astype(np.float32))
    got, _ = tmoe.moe_ffn(x, tp, top_k=2, capacity_factor=8.0)
    np.testing.assert_allclose(f32(got), f32(_dense_reference(x, tp, 2)),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_capacity_drop_zeroes_rows(seed, top_k):
    """A tight capacity drops assignments: a token whose every assignment
    dropped outputs exactly 0, so there are no more nonzero rows than at
    ample capacity; the reference drops the same tokens."""
    jp, tp = _moe_pair(8, 16, 2, seed=seed)
    x = np.random.default_rng(seed).standard_normal((1, 16, 8)).astype(
        np.float32)
    full, _ = tmoe.moe_ffn(torch.from_numpy(x), tp, top_k=top_k,
                           capacity_factor=16.0)
    tight, _ = tmoe.moe_ffn(torch.from_numpy(x), tp, top_k=top_k,
                            capacity_factor=0.25)
    rtight, _ = rmoe.moe_ffn(jnp.asarray(x), jp, top_k=top_k,
                             capacity_factor=0.25)
    nz_full = int((full[0].abs().sum(-1) > 1e-6).sum())
    nz_tight = int((tight[0].abs().sum(-1) > 1e-6).sum())
    assert nz_tight <= nz_full
    zero = (tight[0] == 0).all(-1).numpy()
    assert zero.any()
    assert np.array_equal(zero, (np.asarray(rtight)[0] == 0).all(-1))


def test_moe_grads_flow_to_all_param_groups():
    _, tp = _moe_pair(8, 16, 4, seed=4)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 8, 8)).astype(np.float32))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    y, aux = tmoe.moe_ffn(x, leaves, top_k=2, capacity_factor=4.0)
    grads = torch.autograd.grad((y ** 2).mean() + 0.01 * aux,
                                list(leaves.values()))
    for name, g in zip(leaves, grads):
        assert float(g.abs().sum()) > 0, f"no grad into {name}"


def test_init_moe_params_shapes_and_scales():
    gen = torch.Generator().manual_seed(0)
    p = tmoe.init_moe_params(gen, 64, 256, 4, torch.bfloat16, "cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (64, 4), "w1": (4, 64, 256), "w3": (4, 64, 256),
        "w2": (4, 256, 64)}
    assert all(v.dtype == torch.bfloat16 for v in p.values())
    np.testing.assert_allclose(float(p["w1"].float().std()), 64 ** -0.5,
                               rtol=0.05)
    np.testing.assert_allclose(float(p["w2"].float().std()), 256 ** -0.5,
                               rtol=0.05)
