"""The accelerator sampler of the port (``sample_minibatch_torch``, the
trainer's device route) against the JAX reference's ``sample_minibatch_jax``
and its trainer: the draws differ (torch's generator against threefry), so
parity is semantic: the same shapes, every source a CSR neighbour of its
destination (or the destination itself at degree 0), the CSR's degrees, the
same uniformity; and the same routing, 1 GiB gate and DRM trajectory."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2

import repro.core as rc
import repro.graph as rg
import repro_torch.core as tc
import repro_torch.graph as tg
from repro.core.pipeline import PipelineItem as RefItem
from repro_torch.core.pipeline import PipelineItem

FANOUTS = [(25, 10), (3, 2)]


def _graph_with_isolated_nodes(n=200, seed=0):
    """A random CSR whose every fifth node and the last node have no
    out-edges (so a zero-degree row starts at num_edges)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, 12, n)
    deg[::5] = 0
    deg[-1] = 0
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    return indptr, indices


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check_semantics(mb, indptr, indices, fanouts):
    """Every hop's sources are neighbours of their destinations (or the
    destination itself at degree 0); degrees are the CSR's."""
    deg = np.diff(indptr)
    frontier = _np(mb.targets).astype(np.int64)
    assert len(mb.hop_src) == len(fanouts)
    for h, f in enumerate(fanouts):
        src = _np(mb.hop_src[h]).astype(np.int64)
        assert src.shape == (frontier.shape[0] * f,)
        dst = np.repeat(frontier, f)
        for s, d in zip(src, dst):
            if deg[d] == 0:
                assert s == d
            else:
                assert s in indices[indptr[d]:indptr[d + 1]]
        assert np.array_equal(_np(mb.hop_src_deg[h]), deg[src])
        assert np.array_equal(_np(mb.hop_dst_deg[h]), deg[dst])
        frontier = np.concatenate([frontier, src])
    return frontier


def _port_sample(indptr, indices, targets, labels, fanouts, seed=2):
    gen = torch.Generator().manual_seed(seed)
    return tg.sample_minibatch_torch(
        gen, torch.from_numpy(indptr), torch.from_numpy(indices),
        torch.from_numpy(targets), torch.from_numpy(labels), fanouts)


def _ref_sample(indptr, indices, targets, labels, fanouts, seed=2):
    return rg.sample_minibatch_jax(
        jax.random.PRNGKey(seed), jnp.asarray(indptr), jnp.asarray(indices),
        jnp.asarray(targets), jnp.asarray(labels), tuple(fanouts))


@pytest.mark.parametrize("fanouts", FANOUTS, ids=str)
def test_device_sampler_semantics_match_reference(fanouts):
    indptr, indices = _graph_with_isolated_nodes()
    rng = np.random.default_rng(1)
    targets = np.concatenate([[0, 5, 199], rng.integers(0, 200, 29)])
    labels = rng.integers(0, 47, targets.shape[0])
    port = _port_sample(indptr, indices, targets, labels, fanouts)
    ref = _ref_sample(indptr, indices, targets, labels, fanouts)
    for h in range(len(fanouts)):
        for field in ("hop_src", "hop_src_deg", "hop_dst_deg"):
            assert getattr(port, field)[h].shape == \
                getattr(ref, field)[h].shape
    depth = len(fanouts)
    assert port.frontier(depth).shape == ref.frontier(depth).shape
    assert port.num_frontier(depth) == ref.num_frontier(depth)
    assert port.edges_traversed() == ref.edges_traversed()
    _check_semantics(port, indptr, indices, fanouts)
    _check_semantics(ref, indptr, indices, fanouts)
    # the port's dtypes are those MiniBatch.to() gives
    assert port.targets.dtype == port.labels.dtype == torch.int64
    assert all(s.dtype == torch.int64 for s in port.hop_src)
    assert all(d.dtype == torch.int32
               for d in port.hop_src_deg + port.hop_dst_deg)
    assert np.array_equal(port.labels.numpy(), labels)
    # the zero-degree targets, the last node among them, take self-loops
    for i, v in enumerate((0, 5, 199)):
        assert np.all(port.hop_src[0].numpy()[i * fanouts[0]:
                                              (i + 1) * fanouts[0]] == v)


def test_device_sampler_is_uniform_like_reference():
    """20,000 draws over one node of degree 7: both samplers pass the
    chi-square test of uniformity at the 0.1 % level."""
    d = 7
    indptr = np.array([0, d] + [d] * d, np.int64)
    indices = np.arange(1, d + 1, dtype=np.int32)
    targets = np.zeros(2000, np.int64)
    labels = np.zeros(2000, np.int64)
    crit = chi2.ppf(0.999, d - 1)
    for mb in (_port_sample(indptr, indices, targets, labels, (10,)),
               _ref_sample(indptr, indices, targets, labels, (10,))):
        counts = np.bincount(_np(mb.hop_src[0]).astype(np.int64),
                             minlength=d + 1)[1:]
        assert counts.sum() == 20_000
        expect = 20_000 / d
        stat = float(((counts - expect) ** 2 / expect).sum())
        assert stat < crit, (stat, crit, counts)


def test_device_sampler_same_seed_bit_equal():
    indptr, indices = _graph_with_isolated_nodes(seed=3)
    targets = np.arange(0, 200, 3)
    labels = np.zeros_like(targets)
    a = _port_sample(indptr, indices, targets, labels, (5, 4), seed=9)
    b = _port_sample(indptr, indices, targets, labels, (5, 4), seed=9)
    c = _port_sample(indptr, indices, targets, labels, (5, 4), seed=10)
    for x, y in zip(a.hop_src + a.hop_src_deg + a.hop_dst_deg,
                    b.hop_src + b.hop_src_deg + b.hop_dst_deg):
        assert torch.equal(x, y)
    assert not torch.equal(a.hop_src[1], c.hop_src[1])


def test_device_batch_to_host_and_loader_match_numpy_batch():
    """A device-sampled batch moves with MiniBatch.to() at its dtypes, and
    the loader classifies and gathers it exactly as the same ids in a host
    batch."""
    ds = tg.make_dataset("ogbn-products", scale=0.002, seed=0)
    g = ds.graph
    tgt = np.arange(0, 600, 7)
    mb = _port_sample(g.indptr, g.indices, tgt, ds.labels[tgt], (4, 3))
    moved = mb.to(torch.device("cpu"))
    for x, y in zip((mb.targets, mb.labels, *mb.hop_src, *mb.hop_src_deg,
                     *mb.hop_dst_deg),
                    (moved.targets, moved.labels, *moved.hop_src,
                     *moved.hop_src_deg, *moved.hop_dst_deg)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    host = tg.MiniBatch(
        targets=mb.targets.numpy(), labels=mb.labels.numpy().astype(np.int32),
        hop_src=tuple(s.numpy() for s in mb.hop_src),
        hop_src_deg=tuple(d.numpy() for d in mb.hop_src_deg),
        hop_dst_deg=tuple(d.numpy() for d in mb.hop_dst_deg),
        fanouts=mb.fanouts)
    cache = tg.build_cache(ds, 0.2)
    blocks = [tg.FeatureLoader(ds, cache=cache).load_compact(b)
              for b in (mb, host)]
    assert torch.equal(blocks[0].rows, blocks[1].rows)
    assert np.array_equal(blocks[0].lookup.slots, blocks[1].lookup.slots)
    assert np.array_equal(blocks[0].lookup.miss_index,
                          blocks[1].lookup.miss_index)
    dense = [tg.FeatureLoader(ds).load(b, to_device=False)
             for b in (mb, host)]
    assert torch.equal(dense[0], dense[1])


# ------------------------------------------------ the trainer's routing


@pytest.fixture(scope="module")
def routing_pair():
    rds = rg.make_dataset("ogbn-products", scale=0.002, seed=0)
    pds = tg.make_dataset("ogbn-products", scale=0.002, seed=0)
    gkw = dict(model="sage", layer_dims=(100, 16, 47), fanouts=(3, 2),
               num_classes=47)
    cfg = dict(total_batch=256, n_accel=4, use_drm=False,
               accel_platform="rtx-a5000", seed=0)
    ref = rc.HybridGNNTrainer(rds, rg.GNNConfig(**gkw),
                              rc.HybridConfig(**cfg))
    port = tc.HybridGNNTrainer(pds, tg.GNNConfig(**gkw),
                               tc.HybridConfig(**cfg), device="cpu")
    yield ref, port
    ref.close()
    port.close()


def _ref_device_sampled(ref, names, frac):
    """Names whose batch the reference's sample stage drew on the device
    (its device sampler is wrapped to record the targets it was given)."""
    seen = []
    orig = ref._jax_sample

    def spy(key, indptr, indices, tgt, labels):
        seen.append(np.asarray(tgt))
        return orig(key, indptr, indices, tgt, labels)
    ref._jax_sample = spy
    try:
        ref.runtime.assignment.sample_frac_accel = frac
        targets = {n: np.arange(i * 16, i * 16 + 16) for i, n in
                   enumerate(names)}
        ref._stage_sample(RefItem(0, {"targets": targets, "minibatch": {},
                                      "t": {}}))
    finally:
        ref._jax_sample = orig
    return [n for n in names
            if any(np.array_equal(targets[n], s) for s in seen)]


@pytest.mark.parametrize("n_names", [2, 3, 4, 5])
@pytest.mark.parametrize("frac", [0.0, 0.25, 0.5, 0.75, 1.0])
def test_routing_matches_reference(routing_pair, frac, n_names):
    ref, port = routing_pair
    names = ["cpu"] + [f"accel{i}" for i in range(n_names - 1)]
    want = _ref_device_sampled(ref, names, frac)
    assert want == names[:int(round(frac * n_names))]
    port.runtime.assignment.sample_frac_accel = frac
    targets = {n: np.arange(i * 16, i * 16 + 16) for i, n in
               enumerate(names)}
    item = port._stage_sample(PipelineItem(0, {"targets": targets,
                                               "minibatch": {}, "t": {}}))
    p = item.payload
    assert list(p["device_sampled"]) == want
    for n in names:
        on_dev = isinstance(p["minibatch"][n].targets, torch.Tensor)
        assert on_dev == (n in want)
    assert (p["t"]["t_sa"] > 0) == bool(want)
    assert (p["t"]["t_sc"] > 0) == (len(want) < n_names)


@pytest.mark.parametrize("nbytes", [(1 << 30) - 1, 1 << 30, 1 << 31],
                         ids=["under", "at", "over"])
def test_one_gib_gate_matches_reference(monkeypatch, nbytes):
    """A CSR of 1 GiB or more stays on the host in both packages: no
    device topology, a device-sampling share of 0, every batch on the
    host."""
    rds = rg.make_dataset("ogbn-products", scale=0.001, seed=0)
    pds = tg.make_dataset("ogbn-products", scale=0.001, seed=0)
    monkeypatch.setattr(rds.graph, "nbytes", lambda: nbytes)
    monkeypatch.setattr(pds.graph, "nbytes", lambda: nbytes)
    gkw = dict(layer_dims=(100, 16, 47), fanouts=(3, 2))
    cfg = dict(total_batch=128, accel_platform="rtx-a5000")
    ref = rc.HybridGNNTrainer(rds, rg.GNNConfig(**gkw),
                              rc.HybridConfig(**cfg))
    port = tc.HybridGNNTrainer(pds, tg.GNNConfig(**gkw),
                               tc.HybridConfig(**cfg), device="cpu")
    fits = nbytes < (1 << 30)
    assert (ref._dev_topology is not None) == fits
    assert (port._dev_topology is not None) == fits
    assert port.runtime.assignment.sample_frac_accel == \
        ref.runtime.assignment.sample_frac_accel == (0.5 if fits else 0.0)
    hist = port.train(2)
    port.close()
    ref.close()
    assert all(bool(m.device_sampled) == fits for m in hist)
    assert all((m.times.t_sa > 0) == fits for m in hist)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drm_sample_share_trajectory_matches_reference(seed):
    """Both Runtimes, fed the same StageTimes with t_sa and t_sc set, take
    the same device-sampling shares and the same assignments."""
    rng = np.random.default_rng(seed)
    kw = dict(cpu_batch=320, accel_batch=704, n_accel=1,
              sample_frac_accel=0.5,
              threads={"sample": 2, "load": 2, "train": 2})
    ref = rc.Runtime(rc.Assignment(**kw), damping=0.25)
    port = tc.Runtime(tc.Assignment(**kw), damping=0.25)
    moved = 0
    for i in range(40):
        t = dict(zip(("t_sa", "t_sc", "t_load", "t_tran", "t_tc", "t_ta"),
                     rng.uniform(0.001, 0.05, 6).tolist()))
        if i % 3 == 0:     # make the sampler pair the bottleneck
            t["t_sc"] = 0.2
        elif i % 3 == 1:
            t["t_sa"] = 0.2
        a = ref.end_iteration(rc.StageTimes(**t))
        b = port.end_iteration(tc.StageTimes(**t))
        assert b.sample_frac_accel == a.sample_frac_accel
        assert (b.cpu_batch, b.accel_batch, b.threads) == \
            (a.cpu_batch, a.accel_batch, a.threads)
        assert port.quantized_shares() == ref.quantized_shares()
        moved += a.sample_frac_accel != 0.5
    assert moved > 0


def test_trainer_samples_on_device_with_finite_losses():
    ds = tg.make_dataset("ogbn-products", scale=0.002, seed=0)
    g = tg.GNNConfig(model="sage", layer_dims=(100, 16, 47), fanouts=(5, 3),
                     agg_impl="pallas_fused")
    tr = tc.HybridGNNTrainer(ds, g, tc.HybridConfig(
        total_batch=256, cache_fraction=0.2, accel_platform="rtx-a5000"),
        device="cpu")
    assert tr.cfg.use_accel_sampler
    hist = tr.train(4)
    tr.close()
    assert all(math.isfinite(m.loss) for m in hist)
    assert all(m.device_sampled == ("cpu",) for m in hist)
    assert all(m.times.t_sa > 0 for m in hist)
    assert all(m.times.t_sc > 0 for m in hist)
