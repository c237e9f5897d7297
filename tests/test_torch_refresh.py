"""The dynamic hot-feature cache of the PyTorch port against the JAX
reference, on the CPU: the same numpy inputs give bit-equal refresh plans,
slot tables, hotness counters, undo logs and version blocks; the refresh
scatter's plain version is bit-equal to the reference's jnp and Pallas
(interpret mode) paths; the reference's refresh-protocol tests hold for both
packages; the trainer with refresh, async refresh and the recent-rows LRU
takes the same shares, cache versions and feature traffic as the reference
with losses within 1e-4; and inside the port refresh on, off, forced
mid-flight and async give bit-identical losses."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro.graph as rg
import repro.kernels.ops as rops
import repro_torch.core as tc
import repro_torch.graph as tg
from repro_torch.kernels import ops, ref

N, F = 300, 16


def _bits(x) -> np.ndarray:
    """Raw bits of a reference (numpy / ml_dtypes / jax) or port (torch)
    block: bf16 compared as 16-bit integers."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32)
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


# ---------------------------------------------- (i) FeatureCache parity


def _cache_pair(dtype, capacity=40, seed=0):
    hot = np.arange(N, 0, -1, dtype=np.float64)      # node 0 hottest
    a = rg.FeatureCache(rg.HashedFeatures(N, F, seed=seed), hot, capacity,
                        transfer_dtype=dtype)
    b = tg.FeatureCache(tg.HashedFeatures(N, F, seed=seed), hot, capacity,
                        transfer_dtype=dtype)
    for c in (a, b):
        c.track_hotness = True
        c.keep_versions = 4
    return a, b


def _assert_cache_equal(a, b):
    assert np.array_equal(a.slot_of, b.slot_of)
    assert np.array_equal(a.cached_ids, b.cached_ids)
    assert a.version == b.version
    assert np.array_equal(a.slot_hotness().view(np.uint32),
                          b.slot_hotness().view(np.uint32))
    everyone = np.arange(N)
    assert np.array_equal(a.uncached_hotness(everyone).view(np.uint32),
                          b.uncached_hotness(everyone).view(np.uint32))
    assert a.retained_versions() == b.retained_versions()
    assert a.retained_bytes() == b.retained_bytes()
    for v in a.retained_versions():
        assert np.array_equal(_bits(a.data_on(None, version=v)),
                              _bits(b.data_on("cpu", version=v))), v
    assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("split", [False, True], ids=["refresh", "stage"])
def test_feature_cache_refresh_bit_equal(dtype, split):
    """One lookup stream (some pinned, released a round later) through
    both packages: after every refresh (one-shot, or stage then commit)
    the tables, version, counters, retention and every retained version
    block agree bit for bit."""
    a, b = _cache_pair(dtype)
    rng = np.random.default_rng(7)
    pinned = []
    for r in range(6):
        for i in range(3):
            ids = rng.integers(0, N, 90 + 10 * r)
            a.lookup(ids, pin=(i == 0))
            b.lookup(ids, pin=(i == 0))
            if i == 0:
                pinned.append(a.version)
        if r % 2:
            v = pinned.pop(0)
            a.release_version(v)
            b.release_version(v)
        if split:
            assert a.stage() == b.stage()
            assert a.staged_swaps == b.staged_swaps
            assert a.commit() == b.commit()
        else:
            assert a.refresh(max_swap=12) == b.refresh(max_swap=12)
        _assert_cache_equal(a, b)
    assert a.version >= 3


# ------------------------------------------ (ii) the scatter's plain version


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["jnp", "pallas", "pallas_pipelined"])
def test_update_cache_rows_matches_reference(dtype, path):
    """Aliased slots, M = 21 (not a multiple of 8): the port's plain
    scatter equals the reference's jnp path and its Pallas kernels (K5 at
    depth 1, K6 at depth 2, interpret mode), bit for bit."""
    rng = np.random.default_rng(3)
    k, m = 50, 21
    cache32 = rng.standard_normal((k, F)).astype(np.float32)
    rows32 = rng.standard_normal((m, F)).astype(np.float32)
    slots = rng.integers(0, k, m).astype(np.int32)
    slots[2] = slots[17]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = rops.update_cache_rows(
        jnp.asarray(cache32, jdt), np.asarray(rows32, jdt), slots,
        use_pallas=(path != "jnp"),
        pipeline_depth=2 if path == "pallas_pipelined" else 1)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    cache = torch.from_numpy(cache32).to(tdt)
    rows = torch.from_numpy(rows32).to(tdt)
    got = ops.update_cache_rows(cache, rows, slots,
                                2 if path == "pallas_pipelined" else 1)
    assert np.array_equal(_bits(want), _bits(got))
    assert np.array_equal(_bits(ref.cache_update(
        cache, rows, torch.from_numpy(slots))), _bits(got))


# ------------------------- (iii) the reference's refresh-protocol tests


class _Pkg:
    """One package behind the protocol tests' few calls."""

    def __init__(self, name):
        self.name = name
        self.g = rg if name == "reference" else tg
        self.dev = (jax.devices()[0] if name == "reference"
                    else torch.device("cpu"))

    def cache(self, capacity=40, seed=0, hotness=None, **kw):
        src = self.g.HashedFeatures(N, F, seed=seed)
        if hotness is None:
            hotness = np.arange(N, 0, -1, dtype=np.float64)
        c = self.g.FeatureCache(src, hotness, capacity, **kw)
        c.track_hotness = True
        return src, c

    def host(self, cache):
        return np.asarray(cache._host_rows if self.name == "reference"
                          else cache.host_rows.numpy())

    def block(self, cache, version=None):
        return np.asarray(cache.data_on(self.dev, version=version))

    def assemble(self, data, miss, look):
        if self.name == "reference":
            return np.asarray(rops.assemble_features(
                data, jnp.asarray(miss), look.slots, look.miss_index))
        return ops.assemble_features(data, torch.from_numpy(miss),
                                     look.slots, look.miss_index).numpy()


PKGS = ["reference", "port"]


def _heat(cache, lo, hi, rounds=4, reps=4, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        cache.lookup(np.repeat(rng.integers(lo, hi, 60), reps))


def _consistent_inverse(cache):
    assert np.unique(cache.cached_ids).shape == (cache.capacity,)
    assert np.array_equal(cache.slot_of[cache.cached_ids],
                          np.arange(cache.capacity, dtype=np.int32))
    assert np.count_nonzero(cache.slot_of >= 0) == cache.capacity


def _heat_and_refresh(cache, lo, hi, max_swap=40):
    for _ in range(5):
        cache.lookup(np.repeat(np.arange(lo, hi), 4))
    assert cache.refresh(max_swap=max_swap) > 0


@pytest.mark.parametrize("pkg", PKGS)
def test_stage_commit_matches_one_shot_refresh(pkg):
    p = _Pkg(pkg)
    _, a = p.cache(capacity=30, seed=2)
    _, b = p.cache(capacity=30, seed=2)
    _heat(a, 100, N)
    _heat(b, 100, N)
    planned = a.stage()
    assert a.staged_ready and a.staged_swaps == planned > 0
    assert a.commit() == planned
    assert b.refresh() == planned
    assert np.array_equal(a.cached_ids, b.cached_ids)
    assert np.array_equal(a.slot_of, b.slot_of)
    assert np.array_equal(p.host(a), p.host(b))
    assert np.array_equal(a.slot_hotness(), b.slot_hotness())
    assert a.version == b.version == 1
    _consistent_inverse(a)


@pytest.mark.parametrize("pkg", PKGS)
def test_stale_staged_plan_discarded_after_concurrent_refresh(pkg):
    p = _Pkg(pkg)
    src, cache = p.cache(capacity=30)
    _heat(cache, 100, 200)
    assert cache.stage() > 0
    plan = cache._staged                 # hold the staged plan aside
    _heat(cache, 200, N, seed=1)
    assert cache.refresh() > 0           # bumps version past the plan
    cache._staged = plan                 # resurrect the now-stale plan
    ver, ids = cache.version, cache.cached_ids.copy()
    assert cache.commit() == 0           # stale: discarded
    assert cache.version == ver
    assert np.array_equal(cache.cached_ids, ids)
    _consistent_inverse(cache)
    assert np.array_equal(p.host(cache), src.take(cache.cached_ids))


@pytest.mark.parametrize("pkg", PKGS)
def test_hysteresis_respects_commit_time_revalidation(pkg):
    p = _Pkg(pkg)
    hotness = np.zeros(N)
    hotness[:10] = 1.0
    _, cache = p.cache(capacity=10, hotness=hotness)
    cache.lookup(np.repeat(np.arange(10, dtype=np.int64), 2))   # slots at 2
    cache.lookup(np.repeat(np.int64(250), 8))        # candidate at 8 (4x)
    assert cache.stage() == 1
    victim_slot = int(np.argmin(cache.slot_hotness()))
    victim_id = int(cache.cached_ids[victim_slot])
    cache.lookup(np.repeat(np.int64(victim_id), 50))  # victim reheats
    assert cache.commit() == 0                       # pair no longer valid
    assert cache.slot_of[250] < 0


@pytest.mark.parametrize("pkg", PKGS)
def test_versioned_assemble_is_refresh_invariant(pkg):
    p = _Pkg(pkg)
    src, cache = p.cache(capacity=40)
    rng = np.random.default_rng(3)
    frontier = rng.integers(0, N, size=128).astype(np.int64)
    look = cache.lookup(frontier)
    miss = src.take(look.miss_ids) if look.num_miss else \
        np.zeros((1, F), np.float32)
    truth = src.take(frontier)

    def assembled():
        return p.assemble(cache.data_on(p.dev, version=look.version), miss,
                          look)

    assert np.array_equal(assembled(), truth)
    for _ in range(5):
        cache.lookup(np.repeat(np.arange(250, 280), 4))
    assert cache.refresh(max_swap=40) > 0
    assert cache.version == 1
    assert np.array_equal(assembled(), truth)
    assert not np.array_equal(p.block(cache, 0), p.block(cache))


@pytest.mark.parametrize("pkg", PKGS)
def test_new_device_can_place_retained_old_version(pkg):
    p = _Pkg(pkg)
    src, cache = p.cache(capacity=30)
    look = cache.lookup(np.arange(50, 120))      # classified at v0; the
    ids_v0 = cache.cached_ids.copy()             # device holds nothing yet
    for _ in range(5):
        cache.lookup(np.repeat(np.arange(200, 230), 4))
    assert cache.refresh(max_swap=10) > 0
    block = p.block(cache, look.version)
    assert np.array_equal(block, src.take(ids_v0))
    assert not np.array_equal(block, p.block(cache))


@pytest.mark.parametrize("pkg", PKGS)
def test_stale_version_requests_raise(pkg):
    p = _Pkg(pkg)
    _, cache = p.cache(capacity=20)
    cache.keep_versions = 1
    p.block(cache)
    for _ in range(4):
        cache.lookup(np.repeat(np.arange(100, 140), 3))
    assert cache.refresh(max_swap=5) > 0
    with pytest.raises(RuntimeError, match="retired"):
        cache.data_on(p.dev, version=0)


@pytest.mark.parametrize("pkg", PKGS)
def test_pinned_lookup_retires_eagerly_on_release(pkg):
    p = _Pkg(pkg)
    _, cache = p.cache(capacity=40)
    cache.keep_versions = 10          # generous window: eager must win
    look = cache.lookup(np.arange(50, 120), pin=True)
    _heat_and_refresh(cache, 250, 280)
    _heat_and_refresh(cache, 200, 230)
    assert cache.version == 2
    assert cache.retained_versions() == [0, 1, 2]
    assert p.block(cache, look.version).shape == (40, F)
    cache.release_lookup(look)
    assert cache.retained_versions() == [2]
    with pytest.raises(RuntimeError, match="retired"):
        cache.data_on(p.dev, version=0)


@pytest.mark.parametrize("pkg", PKGS)
def test_leaked_pin_self_heals_at_the_keep_versions_bound(pkg):
    p = _Pkg(pkg)
    _, cache = p.cache(capacity=40)
    cache.keep_versions = 2
    leaked = cache.lookup(np.arange(50, 120), pin=True)   # never released
    _heat_and_refresh(cache, 250, 280, max_swap=10)
    assert cache.retained_versions() == [0, 1]
    _heat_and_refresh(cache, 200, 230, max_swap=10)
    assert cache.retained_versions() == [2]
    look = cache.lookup(np.arange(0, 50), pin=True)
    _heat_and_refresh(cache, 150, 180, max_swap=10)
    assert cache.retained_versions() == [2, 3]   # pinned v2 held
    cache.release_lookup(look)
    assert cache.retained_versions() == [3]
    del leaked


@pytest.mark.parametrize("pkg", PKGS)
def test_undo_log_reconstructs_multi_version_chain(pkg):
    p = _Pkg(pkg)
    src, cache = p.cache(capacity=40)
    cache.keep_versions = 8
    tables = {0: cache.cached_ids.copy()}
    for r in range(3):
        for _ in range(4):
            cache.lookup(np.repeat(np.arange(120 + 30 * r, 160 + 30 * r), 5))
        assert cache.refresh(max_swap=8) > 0
        tables[cache.version] = cache.cached_ids.copy()
    for ver, ids in tables.items():
        assert np.array_equal(p.block(cache, ver), src.take(ids)), ver


# --------------------------------------------- (iv) trainer parity

ITERS = 6
CFG = dict(total_batch=256, use_drm=False, tfp_depth=2, cache_fraction=0.2,
           use_accel_sampler=False, accel_platform="rtx-a5000", seed=0,
           cache_refresh=True, cache_drift_threshold=0.0)


@pytest.fixture(scope="module")
def datasets():
    return (rg.make_dataset("ogbn-products", scale=0.002, seed=0),
            tg.make_dataset("ogbn-products", scale=0.002, seed=0))


def _gkw():
    return dict(model="sage", layer_dims=(100, 32, 47), fanouts=(5, 3),
                num_classes=47, agg_impl="pallas_fused")


def _pair(datasets, **overrides):
    rds, pds = datasets
    cfg = dict(CFG, **overrides)
    r = rc.HybridGNNTrainer(rds, rg.GNNConfig(**_gkw()),
                            rc.HybridConfig(**cfg))
    p = tc.HybridGNNTrainer(pds, tg.GNNConfig(**_gkw()),
                            tc.HybridConfig(**cfg), device="cpu")
    p.set_params({k: np.asarray(v) for k, v in r.params.items()})
    return r, p


def _check_parity(r, p):
    rh, ph = r.train(ITERS), p.train(ITERS)
    r.close()
    p.close()
    assert [m.assignment for m in rh] == [m.assignment for m in ph]
    assert [m.cache_version for m in rh] == [m.cache_version for m in ph]
    rt, pt = r.feature_traffic(), p.feature_traffic()
    assert {k: rt[k] for k in pt} == pt
    assert all(rt[k] == 0 for k in set(rt) - set(pt))    # sharded plane
    np.testing.assert_allclose([m.loss for m in ph], [m.loss for m in rh],
                               rtol=0, atol=1e-4)
    assert r.cache.version == p.cache.version
    assert r.cache.retained_versions() == p.cache.retained_versions()
    return ph, pt


@pytest.mark.parametrize("overrides", [
    dict(hybrid=False, n_accel=1), dict(hybrid=True, n_accel=1),
    dict(hybrid=False, n_accel=1, async_refresh=True),
    dict(hybrid=True, n_accel=1, feature_dtype="bfloat16")],
    ids=["accel_only", "hybrid", "async", "hybrid_bf16"])
def test_refresh_trainer_parity_with_reference(datasets, overrides):
    r, p = _pair(datasets, **overrides)
    hist, _ = _check_parity(r, p)
    assert hist[-1].cache_version > 0
    assert p.health()["components"]["refresh"]["enabled"]


# ------------------------------------ (v) bit-identity inside the port


def _port_run(ds, iters=6, **overrides):
    cfg = dict(total_batch=128, n_accel=2, hybrid=False, use_drm=False,
               tfp_depth=2, seed=0, cache_fraction=0.2)
    cfg.update(overrides)
    g = tg.GNNConfig(model="sage", layer_dims=ds.layer_dims, fanouts=(4, 3),
                     num_classes=ds.num_classes)
    tr = tc.HybridGNNTrainer(ds, g, tc.HybridConfig(**cfg), device="cpu")
    return tr


def test_port_refresh_on_off_async_bit_identical(datasets):
    _, ds = datasets
    losses = {}
    trainers = {}
    for name, kw in (("off", {}),
                     ("sync", dict(cache_refresh=True,
                                   cache_drift_threshold=0.0)),
                     ("async", dict(cache_refresh=True,
                                    cache_drift_threshold=0.0,
                                    async_refresh=True))):
        tr = _port_run(ds, **kw)
        losses[name] = [m.loss for m in tr.train(8)]
        tr.close()
        trainers[name] = tr
    assert losses["sync"] == losses["off"]
    assert losses["async"] == losses["off"]
    assert trainers["off"].cache.version == 0
    assert trainers["async"].cache.version > 0
    assert trainers["sync"].cache.version >= trainers["async"].cache.version
    # the pins drained: only the current version is retained
    assert trainers["sync"].cache.retained_versions() == \
        [trainers["sync"].cache.version]


@pytest.mark.parametrize("n_accel", [2, 0])
def test_port_forced_midflight_refresh_bit_identical(datasets, n_accel):
    """A refresh forced inside the transfer stage of iteration 2, with
    prefetched batches between load and transfer, changes no loss bit."""
    _, ds = datasets

    def run(force):
        tr = _port_run(ds, n_accel=n_accel, hybrid=(n_accel == 0))
        if force:
            orig = tr._stage_transfer
            fired = []

            def transfer(item):
                if not fired and item.payload["iteration"] == 2:
                    fired.append(True)
                    tr.cache.track_hotness = True
                    cold = np.flatnonzero(tr.cache.slot_of < 0)[:64]
                    for _ in range(6):
                        tr.cache.lookup(np.repeat(cold, 4))
                    assert tr.cache.refresh() > 0
                    tr.loader.reset_window()
                return orig(item)

            tr._stage_transfer = transfer
        hist = tr.train(6)
        tr.close()
        return [m.loss for m in hist], tr.cache.version

    (l0, v0), (l1, v1) = run(False), run(True)
    assert l0 == l1
    assert v0 == 0 and v1 == 1


def test_port_async_stage_error_surfaces(datasets):
    """A background stage() that raises surfaces at the next boundary in
    fail-fast mode, through the refresh-failure protocol."""
    _, ds = datasets
    tr = _port_run(ds, tfp_depth=0, cache_refresh=True,
                   cache_drift_threshold=0.0, async_refresh=True,
                   degrade_on_failure=False)
    tr.train(2)
    if tr._refresh_thread is not None:
        tr._refresh_thread.join(10.0)
        tr._maybe_refresh_cache()
    cold = np.flatnonzero(tr.cache.slot_of < 0)[:64]
    for _ in range(6):
        tr.cache.lookup(np.repeat(cold, 4))

    def bad_take(rows):
        raise RuntimeError("source gone")

    tr.cache.source = type("Broken", (), {
        "take": staticmethod(bad_take), "shape": tr.cache.source.shape})()
    rb = tr.cache.row_bytes
    tr.loader._account("stats", tg.LoadStats(
        rows=20, bytes=20 * rb, total_rows=100, unique_rows=80,
        hit_rows=70, saved_bytes=70 * rb))
    tr._model_hit_rate = 0.99
    assert not tr._maybe_refresh_cache()
    tr._refresh_thread.join(10.0)
    with pytest.raises(RuntimeError, match="async cache-refresh"):
        tr._maybe_refresh_cache()
    assert tr.cache.stage_failures == 1 and not tr.cache.staged_ready
    tr.close()


def test_port_refresh_failure_budget_degrades(datasets):
    """In degraded mode a failing refresh keeps the current version
    serving and, past the budget, disables refresh in ``health()``."""
    _, ds = datasets
    tr = _port_run(ds, tfp_depth=0, cache_refresh=True,
                   cache_drift_threshold=0.0, refresh_failure_budget=2)

    def bad_take(rows):
        raise OSError("source gone")

    tr.train(1)
    tr.cache.source = type("Broken", (), {
        "take": staticmethod(bad_take), "shape": tr.cache.source.shape})()
    hist = tr.train(4)
    tr.close()
    h = tr.health()
    assert h["status"] == "degraded" and h["degraded"] == ["refresh"]
    assert not h["components"]["refresh"]["enabled"]
    assert tr.cache.stage_failures == 2
    assert all(np.isfinite(m.loss) for m in hist)


# --------------------------------------------- (vi) the recent-rows LRU


class _FakeBatch:
    """Minimal MiniBatch stand-in: only the last-hop frontier is read."""

    fanouts = (1,)

    def __init__(self, ids):
        self._ids = np.asarray(ids, dtype=np.int64)

    def frontier(self, depth):
        return self._ids


def _loaders(datasets, recent_batches):
    out = []
    for g, ds in zip((rg, tg), datasets):
        cache = g.build_cache(ds, 0.05)
        cache.track_hotness = True
        out.append((cache, g.FeatureLoader(ds, cache=cache,
                                           recent_batches=recent_batches)))
    return out


def _blocks_equal(a, b):
    assert np.array_equal(_bits(a.rows), _bits(b.rows))
    for f in ("slots", "miss_index", "miss_ids"):
        assert np.array_equal(getattr(a.lookup, f), getattr(b.lookup, f)), f
    assert len(a.recent) == len(b.recent)
    for (ea, ia), (eb, ib) in zip(a.recent, b.recent):
        assert np.array_equal(ia, ib)
        assert np.array_equal(ea.ids, eb.ids) and ea.version == eb.version


def _stats_equal(ra, pa):
    for f in dataclasses.fields(pa.snapshot()):
        if f.name != "seconds":
            assert getattr(ra.stats, f.name) == \
                getattr(pa.snapshot(), f.name), f.name


def test_recent_lru_blocks_and_stats_equal(datasets):
    """Same frontiers through both loaders: equal blocks, recent sources
    and counters; a resident frontier ships nothing."""
    (rcache, rl), (pcache, pl) = _loaders(datasets, recent_batches=2)
    rng = np.random.default_rng(8)
    n = datasets[0].num_nodes
    ids = rng.integers(0, n, 300)
    shipped = []
    for batch in (ids, ids, rng.integers(0, n, 300), ids):
        a = rl.load_compact(_FakeBatch(batch), recent_key="accel0")
        b = pl.load_compact(_FakeBatch(batch), recent_key="accel0")
        _blocks_equal(a, b)
        shipped.append(b.rows.shape[0])
    _stats_equal(rl, pl)
    assert shipped[0] > 0 and shipped[1] == 0   # the repeat was resident
    s = pl.snapshot()
    assert s.recent_rows > 0
    assert s.recent_saved_bytes == s.recent_rows * pcache.row_bytes
    assert s.total_rows * pcache.row_bytes == (
        s.saved_bytes + s.dedup_saved_bytes + s.recent_saved_bytes
        + (s.bytes - s.padding_bytes))
    pl.drop_recent("accel0")
    fresh = pl.load_compact(_FakeBatch(ids), recent_key="accel0")
    assert fresh.recent == [] and fresh.rows.shape[0] > 0


def test_recent_lru_is_per_consumer_and_bounded(datasets):
    (_, rl), (_, pl) = _loaders(datasets, recent_batches=1)
    rng = np.random.default_rng(9)
    n = datasets[0].num_nodes
    ids_a, ids_b = rng.integers(0, n, 200), rng.integers(0, n, 200)
    for key, batch in (("accel0", ids_a), ("accel1", ids_a),
                       ("accel0", ids_b), ("accel0", ids_a)):
        a = rl.load_compact(_FakeBatch(batch), recent_key=key)
        b = pl.load_compact(_FakeBatch(batch), recent_key=key)
        _blocks_equal(a, b)
        if key == "accel1":
            # another consumer never matches accel0's residency
            assert b.recent == [] and b.rows.shape[0] > 0
    # depth-1 history: batch b evicted the first, so only ids also in
    # batch b can be served from the device
    overlap = np.intersect1d(np.unique(ids_a), np.unique(ids_b))
    assert sum(idx.shape[0] for _, idx in b.recent) <= overlap.shape[0]
    _stats_equal(rl, pl)


def test_recent_lru_invalidated_on_version_move(datasets):
    (rcache, rl), (pcache, pl) = _loaders(datasets, recent_batches=4)
    rng = np.random.default_rng(10)
    n = datasets[0].num_nodes
    ids = rng.integers(0, n, 300)
    for cache, loader in ((rcache, rl), (pcache, pl)):
        loader.load_compact(_FakeBatch(ids), recent_key="accel0")
    heat = [rng.integers(0, n, 400) for _ in range(4)]
    for cache in (rcache, pcache):
        for h in heat:
            cache.lookup(h)
    assert rcache.refresh(max_swap=16) == pcache.refresh(max_swap=16) > 0
    a = rl.load_compact(_FakeBatch(ids), recent_key="accel0")
    b = pl.load_compact(_FakeBatch(ids), recent_key="accel0")
    _blocks_equal(a, b)
    assert b.recent == [] and b.rows.shape[0] > 0
    assert b.lookup.version == 1


@pytest.mark.parametrize("refresh", [False, True], ids=["static", "refresh"])
def test_recent_rows_trainer_parity(datasets, refresh):
    """recent_rows_batches=2 at hybrid=False: same shares, versions and
    traffic (recent rows included) as the reference, losses within 1e-4,
    and bit-identical to the port without the LRU."""
    kw = dict(hybrid=False, n_accel=1, cache_refresh=refresh)
    r, p = _pair(datasets, recent_rows_batches=2, **kw)
    w0 = {k: v.numpy().copy() for k, v in p.params.items()}
    hist, traffic = _check_parity(r, p)
    assert traffic["recent_rows"] > 0
    plain = tc.HybridGNNTrainer(datasets[1], tg.GNNConfig(**_gkw()),
                                tc.HybridConfig(**dict(CFG, **kw)),
                                device="cpu")
    plain.set_params(w0)
    base = plain.train(ITERS)
    plain.close()
    assert [m.loss for m in base] == [m.loss for m in hist]
    assert plain.feature_traffic()["shipped_bytes"] > \
        traffic["shipped_bytes"]
