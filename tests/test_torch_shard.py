"""The sharded hot-feature plane of the PyTorch port against the JAX
reference, on the CPU.

The same numpy inputs go through both packages.  Bit-equal: the SplitMix64
hash and both owner tables, every shard's cached ids, slot table and rows,
every field of a union lookup (and the shards' hotness and stats once it is
recorded), a sharded refresh, ``load_union``'s per-trainer rows and every
``LoadStats`` field but ``seconds``, the peer exchange's row blocks, the
sharded combine against the reference's jnp path, and ``gather_rows`` and
the legacy combine (K7's plain version) against the reference's Pallas
kernels in interpret mode (normal values only: the reference's one-hot
Pallas combine flips -0.0, ROADMAP section 3).  Trainer runs at n_accel 2
and 4, sharded with hash and degree placement: equal shares and
``feature_traffic()``, losses within 1e-4 (float sums in another order), and
the replicated/sharded shipped-byte ratio at 4 accelerators equal to the
reference's.  Inside the port: sharded and replicated losses, every
``kernel_pipeline_depth`` and a refresh forced mid-run are bit-identical."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.graph as rg
import repro.kernels.ops as rops
from repro.dist.collectives import exchange_peer_rows as r_exchange
from repro.dist.collectives import ring_order as r_ring_order
from repro.graph.featcache import _mix64 as r_mix64
from repro.kernels.gather_scatter_mm import cache_combine_kernel_call
import repro_torch.core as tc
import repro_torch.graph as tg
from repro_torch.dist import exchange_peer_rows, ring_order
from repro_torch.graph.featcache import _mix64
from repro_torch.kernels import ops

N, F = 400, 12
POLICIES = ("hash", "degree")


def _bits(x) -> np.ndarray:
    """Raw bits of a reference (numpy / ml_dtypes / jax) or port (torch)
    block: bf16 compared as 16-bit integers."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32)
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


def _hotness(seed=0):
    # few distinct values: ties exercise the stable ordering
    return np.random.default_rng(seed).integers(0, 40, N).astype(np.float64)


def _planes(n_shards=3, capacity=35, placement="hash", dtype="float32",
            seed=0):
    hot = _hotness(seed)
    a = rg.ShardedFeatureCache(rg.HashedFeatures(N, F, seed=seed), hot,
                               capacity, n_shards, placement=placement,
                               transfer_dtype=dtype)
    b = tg.ShardedFeatureCache(tg.HashedFeatures(N, F, seed=seed), hot,
                               capacity, n_shards, placement=placement,
                               transfer_dtype=dtype)
    return a, b


def _assert_planes_equal(a, b):
    assert np.array_equal(a.placement.owner, b.placement.owner)
    assert a.capacity == b.capacity and a.nbytes == b.nbytes
    assert a.expected_hit_rate == b.expected_hit_rate
    assert a.version == b.version
    assert np.array_equal(a.slot_of, b.slot_of)
    for sa, sb in zip(a.shards, b.shards):
        assert np.array_equal(sa.cached_ids, sb.cached_ids)
        assert np.array_equal(sa.slot_of, sb.slot_of)
        assert sa.version == sb.version
        assert np.array_equal(_bits(sa._host_rows), _bits(sb.host_rows))
        assert np.array_equal(sa.slot_hotness().view(np.uint32),
                              sb.slot_hotness().view(np.uint32))
        everyone = np.arange(N)
        assert np.array_equal(sa.uncached_hotness(everyone).view(np.uint32),
                              sb.uncached_hotness(everyone).view(np.uint32))
        assert dataclasses.asdict(sa.stats) == dataclasses.asdict(sb.stats)
        assert dataclasses.asdict(sa.epoch_stats) == \
            dataclasses.asdict(sb.epoch_stats)
        assert sa.retained_versions() == sb.retained_versions()


# --------------------------------------------------- placement and shards


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_owner_tables_bit_equal(policy, n_shards):
    ids = np.arange(N, dtype=np.uint64)
    assert np.array_equal(_mix64(ids), r_mix64(ids))
    a = rg.ShardPlacement(N, n_shards, policy, _hotness())
    b = tg.ShardPlacement(N, n_shards, policy, _hotness())
    assert b.owner.dtype == np.int32
    assert np.array_equal(a.owner, b.owner)
    assert len(np.unique(b.owner)) == n_shards
    probe = np.random.default_rng(1).integers(0, N, 50)
    assert np.array_equal(a.owner_of(probe), b.owner_of(probe))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("placement", POLICIES)
def test_shards_bit_equal(placement, dtype):
    """Every shard's cached ids, slot table and rows, the merged table and
    the plane's design-time hit rate; the shards are disjoint and owned."""
    a, b = _planes(placement=placement, dtype=dtype)
    _assert_planes_equal(a, b)
    all_ids = np.concatenate([s.cached_ids for s in b.shards])
    assert len(np.unique(all_ids)) == len(all_ids)
    for d, s in enumerate(b.shards):
        assert np.all(b.placement.owner[s.cached_ids] == d)


def _frontiers(n_trainers, seed, size=150):
    rng = np.random.default_rng(seed)
    fr = {f"accel{i}": rng.integers(0, N, size) for i in range(n_trainers)}
    return fr, {f"accel{i}": i for i in range(n_trainers)}


def _assert_union_equal(ua, ub):
    assert sorted(ua.per_trainer) == sorted(ub.per_trainer)
    for name, sa in ua.per_trainer.items():
        sb = ub.per_trainer[name]
        for f in ("ids", "slots", "miss_index", "miss_ids", "unique_ids",
                  "inverse"):
            x, y = getattr(sa.look, f), getattr(sb.look, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), (name, f)
        assert sa.look.version == sb.look.version
        assert sa.shard == sb.shard and sa.pinned == sb.pinned
        assert (sa.peer_rows, sa.peer_positions, sa.local_positions) == \
            (sb.peer_rows, sb.peer_positions, sb.local_positions)
        assert len(sa.peer_requests) == len(sb.peer_requests)
        for (pa, xa, va), (pb, xb, vb) in zip(sa.peer_requests,
                                              sb.peer_requests):
            assert (pa, va) == (pb, vb)
            assert xa.dtype == xb.dtype and np.array_equal(xa, xb)
    assert len(ua.record_payload) == len(ub.record_payload)
    for pa, pb in zip(ua.record_payload, ub.record_payload):
        assert pa[0] == pb[0] and pa[5] == pb[5]
        for x, y in zip(pa[1:5], pb[1:5]):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("pin", [False, True], ids=["unpinned", "pinned"])
@pytest.mark.parametrize("placement", POLICIES)
def test_lookup_union_bit_equal(placement, pin):
    """Slots, miss_index, miss_ids, peer requests with versions, pins and
    the position counts; after ``record_union`` the shards' hotness and
    stats; the pins release to nothing in flight."""
    a, b = _planes(placement=placement)
    a.track_hotness = b.track_hotness = True
    for seed in range(3):
        fr, ords = _frontiers(3, seed)
        ua = a.lookup_union(fr, ords, pin=pin, record=False)
        ub = b.lookup_union(fr, ords, pin=pin, record=False)
        _assert_union_equal(ua, ub)
        a.record_union(ua)
        b.record_union(ub)
        assert ub.record_payload == []
        _assert_planes_equal(a, b)
        for sl in ub.per_trainer.values():
            b.release_union(sl)
        for sl in ua.per_trainer.values():
            a.release_union(sl)
    assert all(s.inflight() == 0 for s in b.shards)
    assert b.measured_hit_rate() == a.measured_hit_rate()


@pytest.mark.parametrize("split", [False, True], ids=["refresh", "stage"])
def test_sharded_refresh_bit_equal(split):
    """Per-shard stage and commit on both planes: tables, versions, rows
    and counters bit-equal after each refresh; the shards stay disjoint."""
    a, b = _planes(n_shards=2, capacity=30)
    a.track_hotness = b.track_hotness = True
    for r in range(4):
        fr, ords = _frontiers(2, 10 + r, size=200)
        a.lookup_union(fr, ords)
        b.lookup_union(fr, ords)
        if split:
            assert a.stage() == b.stage()
            assert a.staged_ready == b.staged_ready
            assert a.commit() == b.commit()
        else:
            assert a.refresh(max_swap=8) == b.refresh(max_swap=8)
        _assert_planes_equal(a, b)
    assert b.version > 0 and b.refresh_swapped_rows == a.refresh_swapped_rows
    all_ids = np.concatenate([s.cached_ids for s in b.shards])
    assert len(np.unique(all_ids)) == len(all_ids)
    for d, s in enumerate(b.shards):
        assert np.all(b.placement.owner[s.cached_ids] == d)


# --------------------------------------------------------- the union load


class _FakeBatch:
    """Minimal MiniBatch stand-in: only the last-hop frontier is read."""

    fanouts = (1,)

    def __init__(self, ids):
        self._ids = np.asarray(ids, dtype=np.int64)

    def frontier(self, depth):
        return self._ids


@pytest.fixture(scope="module")
def datasets():
    return (rg.make_dataset("ogbn-products", scale=0.002, seed=0),
            tg.make_dataset("ogbn-products", scale=0.002, seed=0))


@pytest.mark.parametrize("n_trainers", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_union_bit_equal(datasets, dtype, n_trainers):
    """Per-trainer rows and tables bit-equal, every LoadStats field but the
    timings equal, and the byte identity of the union accounting."""
    loaders = []
    for g, ds in zip((rg, tg), datasets):
        plane = g.ShardedFeatureCache(ds.feature_source, ds.feature_hotness(),
                                      40, n_trainers, transfer_dtype=dtype)
        loaders.append((plane, g.FeatureLoader(ds, cache=plane,
                                               transfer_dtype=dtype)))
    (ra, rl), (pa, pl) = loaders
    rng = np.random.default_rng(4)
    ords = {f"accel{i}": i for i in range(n_trainers)}
    for _ in range(3):
        shared = rng.integers(0, 2000, 200)
        batches = {n: _FakeBatch(np.concatenate(
            [shared, rng.integers(0, 2000, 150)])) for n in ords}
        ba = rl.load_union(batches, ords, pin=True)
        bb = pl.load_union(batches, ords, pin=True)
        assert sorted(ba) == sorted(bb)
        for name, x in bb.items():
            assert isinstance(x, tg.ShardMissBlock)
            assert np.array_equal(_bits(ba[name].rows), _bits(x.rows))
            for f in ("slots", "miss_index", "miss_ids"):
                assert np.array_equal(getattr(ba[name].lookup, f),
                                      getattr(x.lookup, f))
            assert x.shard.pinned == ba[name].shard.pinned
            pa.release_union(x.shard)
    s = pl.snapshot()
    for f in dataclasses.fields(s):
        if f.name != "seconds":
            assert getattr(rl.stats, f.name) == getattr(s, f.name), f.name
    assert s.union_saved_bytes > 0 and s.peer_rows > 0
    assert s.ici_bytes == s.peer_rows * pa.row_bytes + s.union_saved_bytes
    assert s.total_rows * pa.row_bytes == (
        s.saved_bytes + s.peer_saved_bytes + s.dedup_saved_bytes
        + s.union_saved_bytes + (s.bytes - s.padding_bytes))
    with pytest.raises(RuntimeError, match="ShardedFeatureCache"):
        tg.FeatureLoader(datasets[1]).load_union(batches, ords)


# ------------------------------------- peer exchange and sharded combine


def test_ring_order_and_exchange_bit_equal():
    for n in range(1, 6):
        for me in range(n):
            assert ring_order(n, me) == r_ring_order(n, me)
    rng = np.random.default_rng(6)
    blocks = {d: rng.standard_normal((32, F)).astype(np.float32)
              for d in (1, 2, 3)}
    blocks[2][5, :2] = [-0.0, np.nan]
    reqs = [(1, np.array([3, 0, 7], np.int32), 0),
            (2, np.array([5, 5], np.int32), 4),
            (3, np.array([31], np.int32), 1)]
    seen = []

    def port_block(p, v):
        seen.append((p, v))
        return torch.from_numpy(blocks[p])

    want = r_exchange(reqs, lambda p, v: jnp.asarray(blocks[p]),
                      jax.devices()[0])
    got = exchange_peer_rows(reqs, port_block, "cpu", pipeline_depth=2)
    assert seen == [(1, 0), (2, 4), (3, 1)]
    assert len(got) == len(want) == 3
    for x, y in zip(want, got):
        assert np.array_equal(_bits(x), _bits(y))


@pytest.mark.parametrize("path", ["jnp", "pallas", "pallas_pipelined"])
@pytest.mark.parametrize("placement", POLICIES)
def test_assemble_sharded_matches_reference(placement, path):
    """Local block + ring-ordered peer rows + fresh host rows: the port's
    combine equals the reference's jnp path, and its Pallas kernels at
    depths 1 and 2 (interpret mode), bit for bit, and rebuilds the
    positional source rows."""
    a, b = _planes(placement=placement)
    fr, ords = _frontiers(3, 7, size=120)
    ua = a.lookup_union(fr, ords, pin=True, record=False)
    ub = b.lookup_union(fr, ords, pin=True, record=False)
    dev = jax.devices()[0]
    src = tg.HashedFeatures(N, F, seed=0)
    use_pallas = path != "jnp"
    depth = 2 if path == "pallas_pipelined" else 1
    for name, sa in ua.per_trainer.items():
        sb = ub.per_trainer[name]
        fresh = src.take(sb.look.miss_ids).astype(np.float32)
        r_local = a.shards[sa.shard].data_on(dev, version=sa.look.version)
        r_peers = r_exchange(
            sa.peer_requests,
            lambda p, v: a.shards[p].data_on(dev, version=v), dev,
            use_pallas=use_pallas, pipeline_depth=depth)
        want = rops.assemble_features_sharded(
            r_local, r_peers + [jnp.asarray(fresh)], sa.look.slots,
            sa.look.miss_index, use_pallas=use_pallas, pipeline_depth=depth)
        p_local = b.shards[sb.shard].data_on("cpu", version=sb.look.version)
        p_peers = exchange_peer_rows(
            sb.peer_requests,
            lambda p, v: b.shards[p].data_on("cpu", version=v), "cpu",
            pipeline_depth=depth)
        got = ops.assemble_features_sharded(
            p_local, p_peers + [torch.from_numpy(fresh)], sb.look.slots,
            sb.look.miss_index, pipeline_depth=depth)
        assert np.array_equal(_bits(want), _bits(got)), name
        assert np.array_equal(got.numpy(),
                              src.take(fr[name]).astype(np.float32))
        a.release_union(sa)
        b.release_union(sb)


@pytest.mark.parametrize("depth", [1, 2])
def test_gather_rows_matches_reference_pallas(depth):
    rng = np.random.default_rng(5)
    block = rng.standard_normal((64, F)).astype(np.float32)
    slots = rng.integers(0, 64, 17).astype(np.int32)
    want = rops.gather_rows(jnp.asarray(block), slots, use_pallas=True,
                            pipeline_depth=depth)
    got = ops.gather_rows(torch.from_numpy(block), slots, depth)
    assert np.array_equal(_bits(want), _bits(got))
    assert ops.gather_rows(torch.from_numpy(block), slots[:0],
                           depth).shape == (0, F)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_legacy_combine_matches_reference_interpret(dtype):
    """K7's plain version against the reference's one-row-per-step Pallas
    kernel (interpret mode), bit for bit."""
    rng = np.random.default_rng(11)
    k, m, n = 20, 9, 60
    cache = rng.standard_normal((k, F)).astype(np.float32)
    miss = rng.standard_normal((m, F)).astype(np.float32)
    sel = rng.integers(0, 2, n).astype(np.int32)
    row = np.where(sel == 0, rng.integers(0, k, n),
                   rng.integers(0, m, n)).astype(np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = cache_combine_kernel_call(jnp.asarray(cache, jdt),
                                     jnp.asarray(miss, jdt),
                                     jnp.asarray(sel), jnp.asarray(row),
                                     interpret=True)
    got = ops.cache_combine_legacy(torch.from_numpy(cache).to(tdt),
                                   torch.from_numpy(miss).to(tdt), sel, row)
    assert np.array_equal(_bits(want), _bits(got))


# ------------------------------------------------ trainer against reference


ITERS = 4
GKW = dict(model="sage", layer_dims=(100, 32, 47), fanouts=(4, 3),
           num_classes=47)
CFG = dict(total_batch=128, hybrid=False, use_drm=False, tfp_depth=2,
           cache_fraction=0.05, use_accel_sampler=False,
           accel_platform="rtx-a5000", seed=0)


def _pair(datasets, **overrides):
    cfg = dict(CFG, **overrides)
    r = rc.HybridGNNTrainer(datasets[0], rg.GNNConfig(**GKW),
                            rc.HybridConfig(**cfg))
    p = tc.HybridGNNTrainer(datasets[1], tg.GNNConfig(**GKW),
                            tc.HybridConfig(**cfg), device="cpu")
    p.set_params({k: np.asarray(v) for k, v in r.params.items()})
    rh, ph = r.train(ITERS), p.train(ITERS)
    r.close()
    p.close()
    assert [m.assignment for m in rh] == [m.assignment for m in ph]
    assert [m.cache_version for m in rh] == [m.cache_version for m in ph]
    rt, pt = r.feature_traffic(), p.feature_traffic()
    assert rt == pt
    np.testing.assert_allclose([m.loss for m in ph], [m.loss for m in rh],
                               rtol=0, atol=1e-4)
    return r, p, ph


@pytest.mark.parametrize("overrides", [
    dict(n_accel=2, shard_placement="hash"),
    dict(n_accel=2, shard_placement="degree"),
    dict(n_accel=4, shard_placement="hash", total_batch=256),
    dict(n_accel=4, shard_placement="degree", total_batch=256),
    dict(n_accel=2, hybrid=True, total_batch=256),
    dict(n_accel=2, cache_refresh=True, cache_drift_threshold=0.0,
         tfp_depth=0)],
    ids=["n2_hash", "n2_degree", "n4_hash", "n4_degree", "n2_hybrid",
         "n2_refresh"])
def test_sharded_trainer_parity(datasets, overrides):
    """Shares, cache versions and feature traffic equal to the reference's,
    losses within 1e-4 (the hybrid case re-prices through the sharded
    Eq. 7/8 terms).  The refresh case runs its stages in sequence: each
    boundary then sees one batch's loads and commits, in both packages
    (versions 2, 4, 6, 8)."""
    _, p, ph = _pair(datasets, cache_sharding="sharded", **overrides)
    assert isinstance(p.cache, tg.ShardedFeatureCache)
    ft = p.feature_traffic()
    assert ft["peer_rows"] > 0 and ft["ici_bytes"] > 0
    if overrides.get("cache_refresh"):
        assert [m.cache_version for m in ph] == [2, 4, 6, 8]


def test_sharded_trainer_refresh_parity_pipelined(datasets):
    """Refresh at tfp_depth=2: what a boundary refreshes depends on how far
    the load stage has run ahead of training, in either package, so only
    what timing cannot move is compared: the losses (within 1e-4), the
    assignments, and a committed refresh."""
    cfg = dict(CFG, n_accel=2, cache_sharding="sharded", cache_refresh=True,
               cache_drift_threshold=0.0)
    assert cfg["tfp_depth"] == 2
    r = rc.HybridGNNTrainer(datasets[0], rg.GNNConfig(**GKW),
                            rc.HybridConfig(**cfg))
    p = tc.HybridGNNTrainer(datasets[1], tg.GNNConfig(**GKW),
                            tc.HybridConfig(**cfg), device="cpu")
    p.set_params({k: np.asarray(v) for k, v in r.params.items()})
    rh, ph = r.train(ITERS), p.train(ITERS)
    r.close()
    p.close()
    assert [m.assignment for m in rh] == [m.assignment for m in ph]
    np.testing.assert_allclose([m.loss for m in ph], [m.loss for m in rh],
                               rtol=0, atol=1e-4)
    assert r.cache.version > 0 and p.cache.version > 0


def test_shipped_byte_ratio_at_4_accel_equals_reference(datasets):
    """Replicated over sharded shipped bytes at n_accel=4 and an equal
    per-device budget: the port's ratio is the reference's, to the byte,
    and sharding ships fewer bytes."""
    kw = dict(n_accel=4, total_batch=256, tfp_depth=1)
    r_rep, p_rep, _ = _pair(datasets, **kw)
    r_sh, p_sh, _ = _pair(datasets, cache_sharding="sharded", **kw)

    def shipped(t):
        return t.feature_traffic()["shipped_bytes"]

    assert (shipped(p_rep), shipped(p_sh)) == (shipped(r_rep), shipped(r_sh))
    assert shipped(p_rep) / shipped(p_sh) == shipped(r_rep) / shipped(r_sh)
    assert shipped(p_rep) > shipped(p_sh)


# ------------------------------------------- bit identities inside the port


def _port_losses(ds, iters=5, force_refresh_at=None, **kw):
    """Losses of a port run from the seed's weights (the same in every
    run)."""
    cfg = dict(CFG, n_accel=2, **kw)
    tr = tc.HybridGNNTrainer(ds, tg.GNNConfig(**GKW), tc.HybridConfig(**cfg),
                             device="cpu")
    if force_refresh_at is not None:
        orig = tr._stage_transfer
        fired = []

        def transfer(item):
            # with prefetched batches between load and transfer
            if not fired and item.payload["iteration"] == force_refresh_at:
                fired.append(True)
                tr.cache.track_hotness = True
                cold = np.flatnonzero(tr.cache.slot_of < 0)[:64]
                for _ in range(6):
                    tr.cache.lookup_union({"accel0": np.repeat(cold, 4)},
                                          {"accel0": 0})
                assert tr.cache.refresh() > 0
                tr.loader.reset_window()
            return orig(item)

        tr._stage_transfer = transfer
    hist = tr.train(iters)
    tr.close()
    return [m.loss for m in hist], tr


@pytest.mark.parametrize("placement", POLICIES)
def test_port_sharded_replicated_bit_identical(datasets, placement):
    ds = datasets[1]
    rep, _ = _port_losses(ds)
    sh, trs = _port_losses(ds, cache_sharding="sharded",
                           shard_placement=placement)
    assert isinstance(trs.cache, tg.ShardedFeatureCache)
    assert rep == sh, "sharding must only move bytes, never values"


@pytest.mark.parametrize("depth", [2, 3, 4])
@pytest.mark.parametrize("sharding", ["replicated", "sharded"])
def test_port_pipeline_depths_bit_identical(datasets, sharding, depth):
    ds = datasets[1]
    base, _ = _port_losses(ds, cache_sharding=sharding)
    got, tr = _port_losses(ds, cache_sharding=sharding,
                           kernel_pipeline_depth=depth)
    assert tr.cache.kernel_pipeline_depth == depth
    assert got == base


def test_port_sharded_refresh_forced_mid_run_bit_identical(datasets):
    ds = datasets[1]
    off, _ = _port_losses(ds, iters=6, cache_sharding="sharded")
    on, tr = _port_losses(ds, iters=6, cache_sharding="sharded",
                          force_refresh_at=2)
    assert on == off
    assert tr.cache.version > 0


def test_sharded_falls_back_below_two_accelerators(datasets):
    ds = datasets[1]
    tr = tc.HybridGNNTrainer(
        ds, tg.GNNConfig(**GKW),
        tc.HybridConfig(**dict(CFG, n_accel=1, cache_sharding="sharded")),
        device="cpu")
    assert isinstance(tr.cache, tg.FeatureCache)
    tr.close()
