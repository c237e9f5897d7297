"""End-to-end parity of the port's ``HybridGNNTrainer`` (on the host) with
the JAX reference: the same dataset, configuration and initial weights give
the same shares on every iteration, exactly the same feature-traffic
accounting, losses within 1e-4 and final parameters within 2*lr*iters
(each Adam step moves a parameter by at most lr)."""
import math

import numpy as np
import pytest

import repro.core as rc
import repro.graph as rg
import repro_torch.core as tc
import repro_torch.graph as tg

ITERS = 4
CFG = dict(total_batch=256, use_drm=False, tfp_depth=2, cache_fraction=0.2,
           use_accel_sampler=False, accel_platform="rtx-a5000", seed=0)


@pytest.fixture(scope="module")
def datasets():
    return (rg.make_dataset("ogbn-products", scale=0.002, seed=0),
            tg.make_dataset("ogbn-products", scale=0.002, seed=0))


def _pair(datasets, model, agg_impl, **overrides):
    rds, pds = datasets
    gkw = dict(model=model, layer_dims=(100, 32, 47), fanouts=(5, 3),
               num_classes=47, agg_impl=agg_impl)
    cfg = dict(CFG, **overrides)
    ref = rc.HybridGNNTrainer(rds, rg.GNNConfig(**gkw),
                              rc.HybridConfig(**cfg))
    port = tc.HybridGNNTrainer(pds, tg.GNNConfig(**gkw),
                               tc.HybridConfig(**cfg), device="cpu")
    port.set_params({k: np.asarray(v) for k, v in ref.params.items()})
    return ref, port


def _check_parity(ref, port):
    rh, ph = ref.train(ITERS), port.train(ITERS)
    ref.close()
    port.close()
    assert [m.assignment for m in rh] == [m.assignment for m in ph]
    assert [m.edges for m in rh] == [m.edges for m in ph]
    rt, pt = ref.feature_traffic(), port.feature_traffic()
    assert {k: rt[k] for k in pt} == pt
    assert all(rt[k] == 0 for k in set(rt) - set(pt))   # sharded/recent
    np.testing.assert_allclose([m.loss for m in ph], [m.loss for m in rh],
                               rtol=0, atol=1e-4)
    bound = 2 * port.cfg.lr * ITERS
    for k, v in ref.params.items():
        np.testing.assert_allclose(port.params[k].numpy(), np.asarray(v),
                                   rtol=0, atol=bound, err_msg=k)
    assert port.measured_dedup_alpha == ref.measured_dedup_alpha
    return ph


@pytest.mark.parametrize("n_accel", [0, 1, 2])
@pytest.mark.parametrize("agg_impl", ["pallas_fused", "pallas"])
def test_trainer_parity_with_reference(datasets, n_accel, agg_impl):
    ref, port = _pair(datasets, "sage", agg_impl, n_accel=n_accel)
    hist = _check_parity(ref, port)
    want = {"cpu"} if n_accel == 0 else \
        {"cpu"} | {f"accel{i}" for i in range(n_accel)}
    assert set(hist[0].shares) == want


@pytest.mark.parametrize("overrides", [
    dict(feature_dtype="bfloat16"), dict(dedup=False), dict(tfp_depth=0),
    dict(cache_fraction=0.0), dict(hybrid=False, n_accel=2)],
    ids=["bf16", "no_dedup", "sequential", "no_cache", "accel_only"])
def test_trainer_parity_variants(datasets, overrides):
    ref, port = _pair(datasets, "gcn", "pallas_fused",
                      **dict(dict(n_accel=1), **overrides))
    _check_parity(ref, port)


def test_drm_run_finishes_with_finite_losses(datasets):
    _, pds = datasets
    g = tg.GNNConfig(model="sage", layer_dims=(100, 32, 47), fanouts=(5, 3),
                     num_classes=47, agg_impl="pallas_fused")
    tr = tc.HybridGNNTrainer(pds, g, tc.HybridConfig(**dict(CFG,
                                                            use_drm=True)),
                             device="cpu")
    hist = tr.train(6)
    tr.close()
    assert len(hist) == 6
    assert all(math.isfinite(m.loss) for m in hist)
    assert all(sum(m.shares.values()) == 256 for m in hist)
    assert len(tr.runtime.drm.log) == 6
    assert tr.mean_mteps() > 0
