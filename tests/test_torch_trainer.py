"""End-to-end parity of the port's ``HybridGNNTrainer`` (on the host) with
the JAX reference: the same dataset, configuration and initial weights give
the same shares on every iteration, exactly the same feature-traffic
accounting, losses within 1e-4 and final parameters within 2*lr*iters
(each Adam step moves a parameter by at most lr)."""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as rcfg
import repro.core as rc
import repro.core.perfmodel as rpm
import repro.graph as rg
import repro.optim as ro
import repro_torch.configs as pcfg
import repro_torch.core as tc
import repro_torch.core.perfmodel as ppm
import repro_torch.graph as tg
import repro_torch.optim as po

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


# ---------------------------------------- defaults, compression, configs


def test_config_defaults_match_reference():
    """``HybridConfig()`` describes the reference's run: every default is
    the reference's but two, ``cache_assemble`` (the port has none: the
    tensor's device picks the kernel) and ``accel_platform`` (the port's
    accelerator is the H100)."""
    ref = dataclasses.asdict(rc.HybridConfig())
    port = dataclasses.asdict(tc.HybridConfig())
    assert set(ref) - set(port) == {"cache_assemble"}
    assert set(port) <= set(ref)
    diff = {k for k in port if port[k] != ref[k]}
    assert diff == {"accel_platform"}
    assert (ref["accel_platform"], port["accel_platform"]) == \
        ("tpu-v5e", "h100-sxm")
    assert port["use_accel_sampler"] is True


def _grads(seed: int = 0):
    """Seeded gradients with the cases that decide rounding: an all-zero
    tensor (the 1e-12 floor), a tensor below the floor, exact .5 ties after
    the scale (absmax 127 gives scale 1), large magnitudes, and f32 words
    halfway between two bf16 values."""
    rng = np.random.default_rng(seed)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5],
                    np.float32)
    halfway = ((rng.integers(0, 1 << 15, 64, dtype=np.uint32) << 16)
               | 0x8000).astype(np.uint32).view(np.float32)
    halfway = np.where(np.isfinite(halfway), halfway, 1.0).astype(np.float32)
    return {
        "zero": np.zeros((4, 8), np.float32),
        "tiny": np.full(16, 1e-20, np.float32),
        "ties": ties,
        "large": (rng.standard_normal((32, 16)) * 1e30).astype(np.float32),
        "normal": rng.standard_normal((64, 32)).astype(np.float32),
        "halfway": halfway,
    }


def _u(x) -> bytes:
    """Raw bytes of a reference (jnp / ml_dtypes) or port (torch) array."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


@pytest.mark.parametrize("method", ["int8", "bf16", "none"])
def test_compression_bit_equal_to_reference(method):
    g = _grads()
    rspec, pspec = ro.CompressionSpec(method), po.CompressionSpec(method)
    assert pspec.ratio == rspec.ratio
    rg_ = {k: jnp.asarray(v) for k, v in g.items()}
    pg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    rc_, pc = ro.compress_grads(rg_, rspec), po.compress_grads(pg, pspec)
    for k in g:
        if method == "int8":
            (rq, rs), (pq, ps) = rc_[k], pc[k]
            assert pq.dtype == torch.int8 and ps.dtype == torch.float32
            assert _u(rq) == _u(pq), k
            assert _u(rs) == _u(ps), k
        else:
            assert _u(rc_[k]) == _u(pc[k]), k
    rd = ro.decompress_grads(rc_, rspec, rg_)
    pd = po.decompress_grads(pc, pspec, pg)
    for k in g:
        assert pd[k].dtype == torch.float32
        assert _u(rd[k]) == _u(pd[k]), k
    if method == "int8":
        assert pc["zero"][1].item() == np.float32(1e-12) / np.float32(127)
        assert pc["ties"][0].tolist() == [127, 0, 2, 2, 0, -2, -2, 4, 126]


@pytest.mark.parametrize("method", ["int8", "bf16"])
def test_trainer_parity_with_compression(datasets, method):
    ref, port = _pair(datasets, "sage", "pallas_fused", n_accel=1,
                      compression=method)
    _check_parity(ref, port)


@pytest.mark.parametrize("ratio", [1.0, 0.5, 0.25])
def test_sync_time_and_prediction_with_compression_match_reference(ratio):
    host, accel = "epyc-7763", "rtx-a5000"
    kw = dict(fanouts=(25, 10), layer_dims=(100, 256, 47), model="sage")
    rw = [rpm.WorkloadSpec(b, **kw) for b in (320, 704)]
    pw = [ppm.WorkloadSpec(b, **kw) for b in (320, 704)]
    assert ppm.t_sync(pw[1], ppm.PLATFORMS[accel], ratio) == \
        rpm.t_sync(rw[1], rpm.PLATFORMS[accel], ratio)
    rp = rpm.predict(rpm.PLATFORMS[host], rpm.PLATFORMS[accel], 1, *rw,
                     t_samp=0.01, compression_ratio=ratio)
    pp = ppm.predict(ppm.PLATFORMS[host], ppm.PLATFORMS[accel], 1, *pw,
                     t_samp=0.01, compression_ratio=ratio)
    assert pp.as_dict() == rp.as_dict()


@pytest.mark.parametrize("name", ["gcn-products", "sage-products",
                                  "gcn-papers100m", "sage-papers100m",
                                  "gcn-mag240m", "sage-mag240m"])
def test_paper_configs_and_epoch_time_match_reference(name):
    assert set(pcfg.PAPER_CONFIGS) == set(rcfg.PAPER_CONFIGS)
    assert (pcfg.PAPER_BATCH, pcfg.PAPER_FANOUTS) == \
        (rcfg.PAPER_BATCH, rcfg.PAPER_FANOUTS)
    rds, rcf = rcfg.PAPER_CONFIGS[name]
    pds, pcf = pcfg.PAPER_CONFIGS[name]
    assert pds == rds
    assert dataclasses.asdict(pcf) == dataclasses.asdict(rcf)
    assert pcf.agg_impl == "dense"
    nodes = tg.DATASET_STATS[pds][0]
    preds = []
    for pm, batch in ((rpm, rcfg.PAPER_BATCH), (ppm, pcfg.PAPER_BATCH)):
        w = [pm.WorkloadSpec(b, pcf.fanouts, pcf.layer_dims, model=pcf.model)
             for b in (batch // 4, batch - batch // 4)]
        pred = pm.predict(pm.PLATFORMS["epyc-7763"],
                          pm.PLATFORMS["rtx-a5000"], 1, *w, t_samp=0.02)
        preds.append(pm.predict_epoch_time(nodes, batch, pred))
    assert preds[1] == preds[0] > 0


def test_calibrate_sampling_tables_the_sizes_given(datasets):
    _, pds = datasets
    sampler = tg.NumpySampler(pds.graph, (5, 3), seed=0)
    rng = np.random.default_rng(0)
    calls = []

    def run(b):
        tgt = rng.integers(0, pds.num_nodes, b)
        calls.append(b)
        sampler.sample(tgt, pds.labels[tgt])
    table = ppm.calibrate_sampling(run, [32, 128, 512], repeats=2)
    assert list(table) == [32, 128, 512]
    assert all(t > 0 for t in table.values())
    assert calls == [32] * 3 + [128] * 3 + [512] * 3
