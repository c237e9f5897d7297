"""GCN / GraphSAGE of the PyTorch port against the JAX reference: the same
sampled batch, layer-0 features and weights (the reference's ``init_params``
carried across as numpy) give the same logits, loss and parameter gradients
for every aggregation implementation (rtol=1e-4, atol=1e-5: the sums run in
another order than XLA's), and one AdamW step on identical gradients gives
the same parameters (atol=1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graph as rg
import repro_torch.graph as tg
from repro.optim import adamw as jadamw
from repro.optim.optimizers import apply_updates as japply
from repro_torch.optim import adamw, apply_updates

IMPLS = ["dense", "segsum", "pallas", "pallas_fused"]
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def batch():
    ds = rg.make_dataset("ogbn-products", scale=0.002, seed=0)
    mb = rg.NumpySampler(ds.graph, fanouts=(5, 3), seed=1).sample(
        np.arange(32), ds.labels[:32])
    x0 = ds.take_features(np.asarray(mb.frontier(2)))
    pds = tg.make_dataset("ogbn-products", scale=0.002, seed=0)
    pmb = tg.NumpySampler(pds.graph, fanouts=(5, 3), seed=1).sample(
        np.arange(32), pds.labels[:32])
    return mb, jnp.asarray(x0), pmb.to(torch.device("cpu")), \
        torch.from_numpy(x0)


@pytest.mark.parametrize("model", ["sage", "gcn"])
@pytest.mark.parametrize("impl", IMPLS)
def test_forward_loss_grads_match_reference(batch, model, impl):
    mb, jx0, pmb, tx0 = batch
    jcfg = rg.GNNConfig(model=model, layer_dims=(100, 32, 47),
                        fanouts=(5, 3), agg_impl=impl)
    tcfg = tg.GNNConfig(model=model, layer_dims=(100, 32, 47),
                        fanouts=(5, 3), agg_impl=impl)
    jp = rg.init_params(jax.random.PRNGKey(0), jcfg)
    (jloss, jacc), jgrads = jax.value_and_grad(rg.loss_fn, has_aux=True)(
        jp, jcfg, mb, jx0)
    jlogits = rg.forward(jp, jcfg, mb, jx0)

    tp = {k: v.requires_grad_() for k, v in
          tg.params_from_numpy(jp).items()}
    logits = tg.forward(tp, tcfg, pmb, tx0)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **TOL)
    loss, acc = tg.loss_fn(tp, tcfg, pmb, tx0)
    assert abs(float(loss.detach()) - float(jloss)) < 1e-5
    assert float(acc) == float(jacc)
    grads = torch.autograd.grad(loss, list(tp.values()))
    for (k, g) in zip(tp, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[k]),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("impl", ["kernel", "kernel_fused"])
def test_port_impl_names_alias_reference_names(batch, impl):
    _, _, pmb, tx0 = batch
    alias = {"kernel": "pallas", "kernel_fused": "pallas_fused"}[impl]
    a = tg.GNNConfig(layer_dims=(100, 16, 47), fanouts=(5, 3), agg_impl=impl)
    b = tg.GNNConfig(layer_dims=(100, 16, 47), fanouts=(5, 3),
                     agg_impl=alias)
    p = tg.init_params(a, torch.Generator().manual_seed(3))
    assert torch.equal(tg.forward(p, a, pmb, tx0), tg.forward(p, b, pmb, tx0))


def test_init_params_shapes_and_scale():
    cfg = tg.GNNConfig(model="sage", layer_dims=(100, 256, 47))
    p = tg.init_params(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w1": (200, 256), "b1": (256,), "w2": (512, 47), "b2": (47,)}
    assert abs(float(p["w1"].std()) - 200 ** -0.5) < 0.01
    assert tg.param_count(p) == 200 * 256 + 256 + 512 * 47 + 47


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_steps_match_reference(steps):
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((20, 7)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(steps)]
    jopt, topt = jadamw(1e-3), adamw(1e-3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp)
        jp = japply(jp, ju)
        tu, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             ts, tp)
        tp = apply_updates(tp, tu)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(ts["m"][k].numpy(), np.asarray(js["m"][k]),
                                   rtol=1e-6, atol=1e-7)
    assert ts["step"] == int(js["step"]) == steps
