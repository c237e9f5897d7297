"""Graph data layer of the PyTorch port against the JAX reference: the same
seeds give bit-identical datasets, batches, cache tables, loader blocks and
byte accounting."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.graph as rg
import repro_torch.graph as tg
from repro_torch.graph.featcache import wire_row_bytes as port_row_bytes

DATASETS = [("ogbn-products", 0.002, 0), ("ogbn-papers100M", 2e-5, 3)]


@pytest.fixture(scope="module")
def pair():
    return (rg.make_dataset("ogbn-products", scale=0.002, seed=0),
            tg.make_dataset("ogbn-products", scale=0.002, seed=0))


def _bits(x) -> np.ndarray:
    """Raw bits of a reference (numpy / ml_dtypes) or port (torch) block."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32)
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("name,scale,seed", DATASETS)
def test_make_dataset_bit_equal(name, scale, seed):
    r = rg.make_dataset(name, scale=scale, seed=seed)
    p = tg.make_dataset(name, scale=scale, seed=seed)
    assert np.array_equal(r.graph.indptr, p.graph.indptr)
    assert r.graph.indices.dtype == p.graph.indices.dtype
    assert np.array_equal(r.graph.indices, p.graph.indices)
    assert np.array_equal(r.labels, p.labels)
    assert np.array_equal(_bits(r.features), _bits(p.features))
    assert (r.num_classes, r.feat_dim, r.layer_dims) == \
        (p.num_classes, p.feat_dim, p.layer_dims)
    assert np.array_equal(r.feature_hotness(), p.feature_hotness())


def test_hashed_features_bit_equal():
    r = rg.HashedFeatures(5000, 100, seed=7)
    p = tg.HashedFeatures(5000, 100, seed=7)
    ids = np.random.default_rng(0).integers(0, 5000, 777)
    assert np.array_equal(_bits(r.take(ids)), _bits(p.take(ids)))
    assert np.array_equal(_bits(r.take(np.arange(5000))),
                          _bits(p.materialize(chunk_rows=999)))


@pytest.mark.parametrize("fanouts,seed", [((5, 3), 1), ((25, 10), 4),
                                          ((4, 3, 2), 9)])
def test_sampler_batches_bit_equal(pair, fanouts, seed):
    rds, pds = pair
    rs = rg.NumpySampler(rds.graph, fanouts, seed=seed)
    ps = tg.NumpySampler(pds.graph, fanouts, seed=seed)
    for t in (np.arange(64), np.arange(100, 300)):
        a = rs.sample(t, rds.labels[t])
        b = ps.sample(t, pds.labels[t])
        assert np.array_equal(np.asarray(a.targets), b.targets)
        assert np.array_equal(np.asarray(a.labels), b.labels)
        for name in ("hop_src", "hop_src_deg", "hop_dst_deg"):
            for x, y in zip(getattr(a, name), getattr(b, name)):
                assert np.array_equal(np.asarray(x), y), name
        L = len(fanouts)
        assert np.array_equal(np.asarray(a.frontier(L)), b.frontier(L))
        assert a.edges_traversed() == b.edges_traversed()
        assert tg.frontier_sizes(64, fanouts) == rg.frontier_sizes(64,
                                                                   fanouts)


def test_minibatch_to_device_keeps_values(pair):
    _, pds = pair
    mb = tg.NumpySampler(pds.graph, (5, 3), seed=1).sample(
        np.arange(32), pds.labels[:32])
    d = mb.to(torch.device("cpu"))
    assert d.labels.dtype == torch.int64
    assert all(t.dtype == torch.int32 for t in d.hop_src_deg)
    assert torch.equal(d.frontier(2), torch.from_numpy(mb.frontier(2)))
    assert d.batch_size == mb.batch_size and d.fanouts == mb.fanouts


@pytest.fixture(scope="module")
def frontier(pair):
    rds, _ = pair
    mb = rg.NumpySampler(rds.graph, (5, 3), seed=2).sample(
        np.arange(128), rds.labels[:128])
    return np.asarray(mb.frontier(2)).astype(np.int64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_feature_cache_bit_equal(pair, dtype):
    rds, pds = pair
    rc = rg.build_cache(rds, 0.2, transfer_dtype=dtype)
    pc = tg.build_cache(pds, 0.2, transfer_dtype=dtype)
    assert np.array_equal(rc.cached_ids, pc.cached_ids)
    assert np.array_equal(rc.slot_of, pc.slot_of)
    assert rc.expected_hit_rate == pc.expected_hit_rate
    assert rc.row_bytes == pc.row_bytes == port_row_bytes(100, dtype)
    assert np.array_equal(_bits(rc._host_rows), _bits(pc.host_rows))
    assert np.array_equal(
        _bits(np.asarray(rc.data_on(None))),
        _bits(pc.data_on(torch.device("cpu"))))


@pytest.mark.parametrize("dedup", [True, False])
def test_cache_lookup_tables_bit_equal(pair, frontier, dedup):
    rds, pds = pair
    rc, pc = rg.build_cache(rds, 0.2), tg.build_cache(pds, 0.2)
    a = rc.lookup(frontier, dedup=dedup)
    b = pc.lookup(frontier, dedup=dedup)
    for f in ("ids", "slots", "miss_index", "miss_ids", "unique_ids",
              "inverse"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (a.num_hit, a.num_miss, a.dup_miss_rows, a.version) == \
        (b.num_hit, b.num_miss, b.dup_miss_rows, b.version)
    assert dataclasses.asdict(rc.stats) == dataclasses.asdict(pc.stats)
    assert rc.measured_hit_rate() == pc.measured_hit_rate()


def test_compact_lookup_bit_equal(frontier):
    slot_of = np.full(int(frontier.max()) + 1, -1, np.int32)
    slot_of[::3] = np.arange(slot_of[::3].shape[0], dtype=np.int32)
    for so in (None, slot_of):
        a = rg.compact_lookup(frontier, so)
        b = tg.compact_lookup(frontier, so)
        for f in ("slots", "miss_index", "miss_ids", "unique_ids",
                  "inverse"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_pinned_lookups_release(pair, frontier):
    _, pds = pair
    pc = tg.build_cache(pds, 0.2)
    looks = [pc.lookup(frontier, pin=True) for _ in range(3)]
    assert pc.inflight() == 3
    for look in looks:
        pc.release_lookup(look)
    assert pc.inflight() == 0
    pc.release_lookup(looks[0])        # unpinned: a no-op
    assert pc.inflight() == 0


@pytest.mark.parametrize("dtype,cache_fraction,dedup", [
    ("float32", 0.2, True), ("bfloat16", 0.2, True), ("float32", 0.0, True),
    ("float32", 0.2, False), ("bfloat16", 0.0, True)])
def test_loader_blocks_and_stats_equal(pair, dtype, cache_fraction, dedup):
    rds, pds = pair
    rc = rg.build_cache(rds, cache_fraction, transfer_dtype=dtype)
    pc = tg.build_cache(pds, cache_fraction, transfer_dtype=dtype)
    rl = rg.FeatureLoader(rds, transfer_dtype=dtype, cache=rc, dedup=dedup)
    pl = tg.FeatureLoader(pds, transfer_dtype=dtype, cache=pc, dedup=dedup)
    rs = rg.NumpySampler(rds.graph, (5, 3), seed=3)
    ps = tg.NumpySampler(pds.graph, (5, 3), seed=3)
    for t in (np.arange(50), np.arange(60, 190)):
        a = rl.load_compact(rs.sample(t, rds.labels[t]))
        b = pl.load_compact(ps.sample(t, pds.labels[t]))
        assert np.array_equal(_bits(a.rows), _bits(b.rows))
        for f in ("slots", "miss_index", "miss_ids"):
            assert np.array_equal(getattr(a.lookup, f),
                                  getattr(b.lookup, f)), f
        # positional (CPU-trainer) load, accounted as host reads
        mr, mp = rs.sample(t, rds.labels[t]), ps.sample(t, pds.labels[t])
        assert np.array_equal(_bits(rl.load(mr, to_device=False)),
                              _bits(pl.load(mp, to_device=False)))
    rl.note_transfer_padding(7, 7 * rl._row_bytes)
    pl.note_transfer_padding(7, 7 * pl._row_bytes)
    for rstats, pstats in ((rl.stats, pl.snapshot()),
                           (rl.window, pl.snapshot("window")),
                           (rl.host_stats, pl.snapshot("host_stats"))):
        for f in dataclasses.fields(pstats):
            if f.name != "seconds":
                assert getattr(rstats, f.name) == getattr(pstats, f.name), \
                    f.name
    rl.close()
    pl.close()


def test_bf16_transfer_rows_bit_equal_through_uint16(pair):
    rds, pds = pair
    ids = np.random.default_rng(5).integers(0, rds.num_nodes, 300)
    rows32 = rds.take_features(ids)
    # include values that exercise round-to-nearest-even ties and signs
    rows32[0, :4] = np.array([1.00390625, -1.01171875, 0.0, -0.0],
                             np.float32)
    ref_bits = np.asarray(rows32.astype(rg.featload._BF16)).view(np.uint16)
    port = tg.featcache.to_transfer_dtype(rows32, "bfloat16")
    assert np.array_equal(ref_bits, _bits(port))
