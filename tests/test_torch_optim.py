"""The port's optimizers, clipping and schedule against the JAX reference.

The same numpy parameters and gradients (seeded) go through
``repro.optim`` and ``repro_torch.optim`` for five steps, on f32 and bf16
trees.  The port writes out the reference's promotion rules (an f32
learning rate, SGD's momentum rounded to the buffer's dtype as JAX rounds a
weak scalar, f32 moments and bias corrections), so:

* SGD (momentum 0 and 0.9): updates, buffers and parameters bit-equal;
* Adam / AdamW: the moments, updates and parameters bit-equal.  torch's
  vectorized f32 ``sqrt`` on the CPU is not correctly rounded (173,415 of
  10^6 random inputs an ulp off on an AVX512 host, fewer on an AVX2 one),
  while XLA's is (and so is the card's), so the port takes the host's in
  f64 and rounds once;
* the cosine schedule: XLA's f32 ``cos`` is not correctly rounded either,
  and neither torch's nor numpy's reproduces it, so the schedule agrees
  to one ulp of ``cos`` carried through ``0.45 (1 + cos)`` (a few ulps of
  the result where ``1 + cos`` is small) plus one ulp of the result; AdamW
  under the two packages' own schedules then stays within 8 ulps (rtol
  1e-6) of the update, and the warm-up part of the schedule is exact;
* the global norm sums each leaf in another order than XLA's reduction:
  rtol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as ro
import repro.optim.optimizers as roo
import repro_torch.optim as po

SHAPES = {"w": (7, 5), "b": (13,), "e": (3, 4, 2)}
STEPS = 5
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DTYPES = [torch.float32, torch.bfloat16]


def _bits(a) -> np.ndarray:
    """Raw words of a float array of either package (bf16 as uint16)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t.view(torch.int32)).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _trees(seed, dtype):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 1))
              .astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    # a zero gradient leaf exercises Adam's eps and SGD's untouched rows
    grads[1]["b"][:] = 0.0
    return params, grads


def _run(ref_opt, port_opt, dtype, seed=0):
    """Both optimizers over STEPS steps from the same tree; the params of
    both packages after every step."""
    params, grads = _trees(seed, dtype)
    jd = JDT[dtype]
    rp = {k: jnp.asarray(v, jd) for k, v in params.items()}
    tp = {k: torch.from_numpy(v).to(dtype) for k, v in params.items()}
    rs, ts = ref_opt.init(rp), port_opt.init(tp)
    out = []
    for g in grads:
        rg = {k: jnp.asarray(v, jd) for k, v in g.items()}
        tg = {k: torch.from_numpy(v).to(dtype) for k, v in g.items()}
        ru, rs = ref_opt.update(rg, rs, rp)
        tu, ts = port_opt.update(tg, ts, tp)
        rp, tp = roo.apply_updates(rp, ru), po.apply_updates(tp, tu)
        assert int(ts["step"]) == int(rs["step"])
        out.append((rp, tp, ru, tu, rs, ts))
    return out


OPTS = {
    "sgd": (lambda: ro.sgd(0.1), lambda: po.sgd(0.1)),
    "sgd_momentum": (lambda: ro.sgd(0.05, momentum=0.9),
                     lambda: po.sgd(0.05, momentum=0.9)),
    "adam": (lambda: ro.adam(1e-2), lambda: po.adam(1e-2)),
    "adamw_float_lr": (lambda: ro.adamw(1e-2, weight_decay=0.1),
                       lambda: po.adamw(1e-2, weight_decay=0.1)),
}


def _bit_equal(got: torch.Tensor, want) -> None:
    assert np.array_equal(_bits(got), _bits(np.asarray(want)))


def _within_one_ulp(got: torch.Tensor, want) -> None:
    """Equal dtypes, and raw words at most one apart (same sign)."""
    a = _bits(got).astype(np.int64)
    b = _bits(np.asarray(want)).astype(np.int64)
    assert np.abs(a - b).max() <= 1, np.abs(a - b).max()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", sorted(OPTS))
def test_optimizer_matches_reference(name, dtype):
    make_ref, make_port = OPTS[name]
    for rp, tp, ru, tu, rs, ts in _run(make_ref(), make_port(), dtype):
        for k in SHAPES:
            assert tp[k].dtype == dtype and tu[k].dtype == torch.float32
            if name.startswith("sgd"):
                assert np.array_equal(_bits(rp[k]), _bits(tp[k])), k
                assert np.array_equal(_bits(ru[k]), _bits(tu[k])), k
            else:
                _bit_equal(tu[k], ru[k])
                _bit_equal(tp[k], rp[k])
        if name == "sgd_momentum":
            for k in SHAPES:
                # mu keeps the gradients' dtype, as the reference's does
                assert ts["mu"][k].dtype == dtype
                assert np.array_equal(_bits(rs["mu"][k]),
                                      _bits(ts["mu"][k])), k
        if name.startswith("adam"):
            for k in SHAPES:
                assert ts["m"][k].dtype == ts["v"][k].dtype == torch.float32
                assert np.array_equal(_bits(rs["m"][k]), _bits(ts["m"][k]))
                assert np.array_equal(_bits(rs["v"][k]), _bits(ts["v"][k]))


@pytest.mark.parametrize("peak,warmup,total", [(3e-4, 2, 15),
                                               (1e-3, 11, 100),
                                               (0.1, 5, 1000),
                                               (3e-4, 1, 8)])
def test_cosine_schedule_matches_reference(peak, warmup, total):
    ref = ro.cosine_warmup_schedule(peak, warmup, total)
    port = po.cosine_warmup_schedule(peak, warmup, total)
    steps = list(range(total + 3))
    want = np.array([np.float32(ref(jnp.asarray(s, jnp.int32)))
                     for s in steps])
    got = np.array([port(s).item() for s in steps], np.float32)
    assert all(port(s).dtype == torch.float32 for s in steps[:2])
    # one ulp of cos (<= 2^-23 below 1) through peak * 0.45 * (1 + cos),
    # plus the result's own rounding
    bound = peak * 0.45 * 2.0 ** -23 + np.spacing(np.abs(want))
    assert np.all(np.abs(got - want) <= bound), np.abs(got - want).max()
    # the warm-up (no cosine) is exact
    for s in range(min(warmup, total) + 1):
        assert got[s] == want[s], s


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_adamw_cosine_close_to_reference(dtype):
    """Under each package's own schedule: the learning rates differ by a
    few f32 ulps, so every update is within rtol 1e-6
    of the reference's, and the parameters within one ulp of their
    dtype."""
    run = _run(ro.adamw(ro.cosine_warmup_schedule(1e-2, 2, STEPS)),
               po.adamw(po.cosine_warmup_schedule(1e-2, 2, STEPS)), dtype)
    for rp, tp, ru, tu, _, _ in run:
        for k in SHAPES:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ru[k]),
                                       rtol=1e-6, atol=0)
            _within_one_ulp(tp[k], rp[k])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_adamw_scheduled_on_one_lr_table(dtype):
    """Fed the same f32 learning rates (the reference's own schedule's
    values), AdamW's moments, updates and parameters are bit-equal, as
    with a constant rate."""
    sched = ro.cosine_warmup_schedule(3e-3, 2, STEPS)
    table = {s: np.float32(sched(jnp.asarray(s, jnp.int32)))
             for s in range(STEPS + 1)}
    run = _run(ro.adamw(lambda s: jnp.asarray(table[int(s)], jnp.float32)),
               po.adamw(lambda s: torch.tensor(table[s])), dtype)
    for rp, tp, ru, tu, rs, ts in run:
        for k in SHAPES:
            assert np.array_equal(_bits(rs["m"][k]), _bits(ts["m"][k]))
            assert np.array_equal(_bits(rs["v"][k]), _bits(ts["v"][k]))
            _bit_equal(tu[k], ru[k])
            _bit_equal(tp[k], rp[k])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("max_norm", [1e-3, 1.0, 1e6])
def test_clip_by_global_norm_matches_reference(dtype, max_norm):
    params, grads = _trees(3, dtype)
    g = grads[0]
    jc, jn = ro.clip_by_global_norm(
        {k: jnp.asarray(v, JDT[dtype]) for k, v in g.items()}, max_norm)
    tc, tn = po.clip_by_global_norm(
        {k: torch.from_numpy(v).to(dtype) for k, v in g.items()}, max_norm)
    assert tn.dtype == torch.float32 and tn.dim() == 0
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in SHAPES:
        assert tc[k].dtype == dtype
        np.testing.assert_allclose(
            tc[k].float().numpy(), np.asarray(jc[k]).astype(np.float32),
            rtol=1e-6 if dtype == torch.float32 else 2 ** -8, atol=0)
    if max_norm == 1e6:           # below the threshold: unchanged bits
        for k in SHAPES:
            assert np.array_equal(_bits(tc[k]),
                                  _bits(torch.from_numpy(g[k]).to(dtype)))


def test_sgd_without_momentum_keeps_no_buffer():
    opt = po.sgd(0.1)
    st = opt.init({"w": torch.zeros(3)})
    assert st == {"step": 0, "mu": None}
    upd, st = opt.update({"w": torch.ones(3, dtype=torch.bfloat16)}, st)
    assert st["step"] == 1 and upd["w"].dtype == torch.float32
    assert torch.equal(upd["w"], torch.full((3,), -0.1))
