"""The port's hand-written kernels and its trainer on a CUDA card.

Every case needs the card: the kernels have no interpret mode, so on a host
without one the ``cuda`` fixture skips them (they count as no pass there).
On the card, run this file alone:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

The cases that take the ``n_cards`` fixture need that many cards (they
skip with fewer): a peer row crossing from its owner's card to the
reader's, the sharded plane one shard a card, one accelerator trainer a
card against all on cuda:0, and the LM mesh route over NCCL (one spawned
rank a card, joined through a FileStore in ``tmp_path``, each launch
under a time limit).  Run them on four cards with

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q -k across_cards
It imports neither JAX nor the reference package, which the card's
machine does not have.  Each kernel is held against its plain version on
the same inputs: the combines (K1, K4 at every depth, K7) and the refresh
scatter (K5, K6) bit-equal, the segment sum rtol=atol=1e-5 in
f32 (1e-2 in bf16: one rounding of the sum), the fused layer and every
gradient rtol=atol=1e-4 (fp32 sums in another order than cuBLAS), flash
attention (K8) rtol=atol=2e-5 in f32 (the online softmax sums 64-key
tiles in another order than the plain version's one softmax) and 1e-2 in
bf16 (the tensor-core body rounds p to bf16 for P V, and the output is
rounded once from an f32 value that may differ in its last bits).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core import HybridConfig, HybridGNNTrainer
from repro_torch.dist import peer_gather_rows
from repro_torch.graph import GNNConfig, make_dataset
from repro_torch.kernels import ops, ref
from repro_torch.models import forward, init_params


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture
def n_cards(cuda):
    """``n_cards(k)``: cuda:0 .. cuda:k-1, or a skip with fewer cards."""
    def need(k: int):
        if torch.cuda.device_count() < k:
            pytest.skip(f"needs {k} CUDA cards: the path crosses cards")
        return [torch.device("cuda", i) for i in range(k)]
    return need


def _randn(gen, *shape, device):
    return torch.randn(*shape, generator=gen).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [100, 7])
def test_combine_bit_equal(cuda, dtype, f):
    rng = np.random.default_rng(f)
    k, m, n = 700, 300, 5000
    cache = torch.from_numpy(rng.standard_normal((k, f)).astype(
        np.float32)).to(cuda, dtype)
    miss = torch.from_numpy(rng.standard_normal((m, f)).astype(
        np.float32)).to(cuda, dtype)
    slots = torch.from_numpy(rng.integers(-1, k, n).astype(np.int32))
    mi = torch.from_numpy(np.where(slots.numpy() < 0,
                                   rng.integers(0, m, n), 0).astype(np.int32))
    slots, mi = slots.to(cuda), mi.to(cuda)
    before = ops.kernel_launches()["cache_combine"]
    got = ops.assemble_features(cache, miss, slots, mi)
    assert ops.kernel_launches()["cache_combine"] == before + 1
    assert torch.equal(got, ref.assemble_features(cache, miss, slots, mi))
    got = ops.assemble_features(None, miss, torch.full_like(mi, -1), mi)
    assert torch.equal(got, ref.expand_rows(miss, mi))


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else \
        t.view(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [100, 7, 32])
@pytest.mark.parametrize("depth", [2, 3, 4])
def test_pipelined_combine_bit_equal_to_k1(cuda, dtype, f, depth):
    """K4 against K1 and the plain version, bit for bit, with -0.0, a
    denormal and a NaN payload in the sources and a ragged last block;
    also with no cache and with an empty miss block.  Rows of a multiple
    of 16 bytes (f32 at 100 and 32, bf16 at 32) take the bulk-copy route,
    the others the cp.async route."""
    rng = np.random.default_rng(depth * 7 + f)
    k, m, n = 700, 300, 5003
    cache = torch.from_numpy(rng.standard_normal((k, f)).astype(
        np.float32)).to(dtype)
    miss = torch.from_numpy(rng.standard_normal((m, f)).astype(
        np.float32)).to(dtype)
    special = torch.tensor([-0.0, 1e-40, float("nan")])[:f].to(dtype)
    cache[:5, :special.numel()] = special
    miss[:5, :special.numel()] = special
    cache, miss = cache.to(cuda), miss.to(cuda)
    slots = rng.integers(-1, k, n).astype(np.int32)
    slots[:20] = np.arange(20) % 5 - 1
    mi = np.where(slots < 0, rng.integers(0, m, n), 0).astype(np.int32)
    mi[:20] = np.arange(20) % 5
    all_miss = rng.integers(0, m, n).astype(np.int32)
    for c, mm, sl, mx in ((cache, miss, slots, mi),
                          (None, miss, np.full(n, -1, np.int32), all_miss),
                          (cache, miss[:0], np.abs(slots),
                           np.zeros(n, np.int32))):
        k1 = ops.assemble_features(c, mm, sl, mx, 1)
        n0 = ops.kernel_launches()["cache_combine_pipelined"]
        k4 = ops.assemble_features(c, mm, sl, mx, depth)
        torch.cuda.synchronize()
        assert ops.kernel_launches()["cache_combine_pipelined"] == n0 + 1
        want = ref.assemble_features(c, mm, torch.from_numpy(sl).to(cuda),
                                     torch.from_numpy(mx).to(cuda))
        assert torch.equal(_bits(k4), _bits(k1))
        assert torch.equal(_bits(k4), _bits(want))


def _k1_case(cuda, dtype, f, case, n, k=90, m=37, seed=0):
    """K1's inputs on the card: a cache and a miss block whose first rows
    hold -0.0, a denormal and NaNs with payloads of their own, and index
    tables for ``case``: "mixed", "no_cache" (every slot -1), "all_hit"
    (a peer gather: every slot hits, the miss block is empty) and
    "misaligned" (mixed, both blocks views one element off a 16-byte
    boundary, so K1 copies in a narrower unit)."""
    rng = np.random.default_rng(seed * 1000 + n * 10 + f)
    ibits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    off = 1 if case == "misaligned" else 0
    special = torch.tensor([0x8000, 0x0001, 0x7FC5, 0xFFA1] if dtype ==
                           torch.bfloat16 else
                           [-2 ** 31, 0x00000001, 0x7FC01234, -0x5FEDCC],
                           dtype=torch.int32).to(ibits)

    def block(rows):
        x = torch.from_numpy(rng.standard_normal(rows * f + off).astype(
            np.float32)).to(dtype)
        flat = x[off:].view(ibits)
        flat[:special.numel()] = special[:flat.numel()]
        return x.to(cuda)[off:].view(rows, f)

    cache, miss = block(k), block(m)
    slots = rng.integers(-1, k, n).astype(np.int32)
    slots[:4] = [0, -1, 0, -1]
    if case == "no_cache":
        cache, slots = None, np.full(n, -1, np.int32)
    mi = np.where(slots < 0, rng.integers(0, m, n), 0).astype(np.int32)
    mi[:4] = 0
    if case == "all_hit":
        slots, mi, miss = np.abs(slots), np.zeros(n, np.int32), miss[:0]
    return (cache, miss, torch.from_numpy(slots).to(cuda),
            torch.from_numpy(mi).to(cuda))


def _k1_against_plain_and_k4(cache, miss, slots, mi, gather):
    """One K1 call (through ``gather_rows`` when ``gather``), counted once,
    bit-equal to the plain combine and to K4 at depths 2-4."""
    before = ops.kernel_launches()
    got = (ops.gather_rows(cache, slots) if gather else
           ops.assemble_features(cache, miss, slots, mi))
    torch.cuda.synchronize()
    after = ops.kernel_launches()
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == "cache_combine") for k in after}
    want = _bits(ref.assemble_features(cache, miss, slots, mi))
    assert torch.equal(_bits(got), want)
    for depth in (2, 3, 4):
        k4 = (ops.gather_rows(cache, slots, depth) if gather else
              ops.assemble_features(cache, miss, slots, mi, depth))
        assert torch.equal(_bits(k4), want), depth


@pytest.mark.parametrize("case", ["mixed", "no_cache", "all_hit",
                                  "misaligned"])
@pytest.mark.parametrize("dtype,f", [(torch.float32, 1),
                                     (torch.float32, 47),
                                     (torch.float32, 100),
                                     (torch.float32, 256),
                                     (torch.bfloat16, 7),
                                     (torch.bfloat16, 47)])
@pytest.mark.parametrize("n", [75, 17, 5003])
def test_k1_groups_bit_equal_on_card(cuda, n, dtype, f, case):
    """K1's 32-row warp groups (a ragged last group, a lone short group, and
    157 groups) at copy units of 16, 4 and 2 bytes, bit-equal to the plain
    combine and to K4 at depths 2-4, one K1 launch a call."""
    cache, miss, slots, mi = _k1_case(cuda, dtype, f, case, n)
    if case == "misaligned":
        assert cache.data_ptr() % 16 and miss.data_ptr() % 16
    _k1_against_plain_and_k4(cache, miss, slots, mi, case == "all_hit")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_main_path_size_on_card(cuda, dtype):
    """K1 at the main path's size: 201,344 rows of width 100 from a
    489,806-row cache and a 64,000-row miss block, a third of the slots
    missing, bit-equal to the plain combine and to K4 at depths 2-4."""
    rng = np.random.default_rng(17)
    k, m, n, f = 489_806, 64_000, 201_344, 100
    gen = torch.Generator(device=cuda).manual_seed(17)
    cache = torch.randn(k, f, generator=gen, device=cuda).to(dtype)
    miss = torch.randn(m, f, generator=gen, device=cuda).to(dtype)
    slots = rng.integers(0, k, n).astype(np.int32)
    slots[rng.random(n) < 1 / 3] = -1
    mi = np.where(slots < 0, rng.integers(0, m, n), 0).astype(np.int32)
    _k1_against_plain_and_k4(cache, miss, torch.from_numpy(slots).to(cuda),
                             torch.from_numpy(mi).to(cuda), False)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_gather_rows_on_card(cuda, depth):
    rng = np.random.default_rng(depth)
    block = torch.from_numpy(rng.standard_normal((5000, 100)).astype(
        np.float32)).to(cuda)
    slots = rng.integers(0, 5000, 3001).astype(np.int32)
    kernel = "cache_combine" if depth == 1 else "cache_combine_pipelined"
    n0 = ops.kernel_launches()[kernel]
    got = ops.gather_rows(block, slots, depth)
    assert ops.kernel_launches()[kernel] == n0 + 1
    assert torch.equal(got, block[torch.from_numpy(slots).long().to(cuda)])


@pytest.mark.parametrize("depth", [1, 2])
def test_peer_gather_across_cards(n_cards, depth):
    """A peer gather issued under the reader's transfer stream on card 0
    reads a block owned by card 1: the kernel runs on card 1 and only the
    gathered rows hop to card 0."""
    reader, owner = n_cards(2)
    rng = np.random.default_rng(depth)
    block = torch.from_numpy(rng.standard_normal((5000, 100)).astype(
        np.float32)).to(owner)
    slots = rng.integers(0, 5000, 3001).astype(np.int32)
    kernel = "cache_combine" if depth == 1 else "cache_combine_pipelined"
    ops.reset_kernel_launches()
    stream = torch.cuda.Stream(reader)
    with torch.cuda.stream(stream):
        got = peer_gather_rows(block, slots, reader, depth)
    stream.synchronize()
    assert ops.kernel_launches()[kernel] == 1
    assert ops.kernel_launches_by_device()[kernel] == {1: 1}
    assert got.device == reader
    assert torch.equal(got.cpu(),
                       block[torch.from_numpy(slots).long().to(owner)].cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [100, 7])
def test_legacy_combine_bit_equal(cuda, dtype, f):
    rng = np.random.default_rng(f + 1)
    k, m, n = 700, 300, 5000
    cache = torch.from_numpy(rng.standard_normal((k, f)).astype(
        np.float32)).to(cuda, dtype)
    miss = torch.from_numpy(rng.standard_normal((m, f)).astype(
        np.float32)).to(cuda, dtype)
    sel = rng.integers(0, 2, n).astype(np.int32)
    row = np.where(sel == 0, rng.integers(0, k, n),
                   rng.integers(0, m, n)).astype(np.int32)
    n0 = ops.kernel_launches()["cache_combine_legacy"]
    got = ops.cache_combine_legacy(cache, miss, sel, row)
    assert ops.kernel_launches()["cache_combine_legacy"] == n0 + 1
    want = ref.cache_combine_legacy(cache, miss,
                                    torch.from_numpy(sel).to(cuda),
                                    torch.from_numpy(row).to(cuda))
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [100, 7])
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_cache_update_bit_equal(cuda, dtype, f, depth):
    """K5 (depth 1) and K6 (depth 2..4) with aliased slots, M not a multiple
    of 8: bit-equal to the plain keep-last scatter, the input block
    untouched."""
    rng = np.random.default_rng(depth * 10 + f)
    k, m = 20_000, 6_001
    cache = torch.from_numpy(rng.standard_normal((k, f)).astype(
        np.float32)).to(cuda, dtype)
    rows = torch.from_numpy(rng.standard_normal((m, f)).astype(
        np.float32)).to(cuda, dtype)
    slots = rng.integers(0, k, m).astype(np.int32)     # with duplicates
    before = cache.clone()
    kernel = "cache_update" if depth == 1 else "cache_update_pipelined"
    n0 = ops.kernel_launches()[kernel]
    got = ops.update_cache_rows(cache, rows, slots, depth)
    torch.cuda.synchronize()
    assert ops.kernel_launches()[kernel] == n0 + 1
    want = ref.cache_update(cache, rows, torch.from_numpy(slots).to(cuda))
    assert torch.equal(got, want)
    assert torch.equal(cache, before)
    assert ops.update_cache_rows(cache, rows[:0], slots[:0], depth) is cache


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,fanout,f", [(3000, 10, 100), (300, 25, 256),
                                        (77, 3, 7)])
def test_segment_sum_matches_plain(cuda, dtype, d, fanout, f):
    gen = torch.Generator().manual_seed(d)
    xn = _randn(gen, d * fanout, f, device=cuda).to(dtype)
    we = torch.rand(d * fanout, generator=gen).to(cuda, dtype)
    got = ops.segment_weighted_sum_regular(xn, we, fanout)
    want = ref.segment_weighted_sum_regular(xn, we, fanout)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else \
        dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    if dtype == torch.float32:
        ins = [xn.clone().requires_grad_(), we.clone().requires_grad_()]
        g = _randn(gen, d, f, device=cuda)
        a = torch.autograd.grad(ops.segment_weighted_sum_regular(*ins,
                                                                 fanout),
                                ins, g)
        ins = [t.detach().clone().requires_grad_() for t in ins]
        b = torch.autograd.grad(ref.segment_weighted_sum_regular(*ins,
                                                                 fanout),
                                ins, g)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d,fanout,f,o", [(9000, 10, 100, 256),
                                          (300, 25, 256, 47),
                                          (50, 3, 33, 300),
                                          (18304, 10, 100, 256),
                                          (704, 25, 256, 47)])
def test_fused_layer_and_grads_match_plain(cuda, d, fanout, f, o):
    gen = torch.Generator().manual_seed(o)
    args = [_randn(gen, d, f, device=cuda),
            _randn(gen, d * fanout, f, device=cuda),
            torch.rand(d * fanout, generator=gen).to(cuda),
            torch.rand(d, generator=gen).to(cuda),
            _randn(gen, f, o, device=cuda) / f ** 0.5,
            _randn(gen, f, o, device=cuda) / f ** 0.5,
            _randn(gen, o, device=cuda)]
    torch.testing.assert_close(ops.fused_gnn_update(*args, fanout),
                               ref.fused_gnn_update(*args, fanout),
                               rtol=1e-4, atol=1e-4)
    g = _randn(gen, d, o, device=cuda)
    ins = [a.clone().requires_grad_() for a in args]
    ka = torch.autograd.grad(ops.fused_gnn_update(*ins, fanout), ins, g)
    ins = [a.clone().requires_grad_() for a in args]
    kb = torch.autograd.grad(ref.fused_gnn_update(*ins, fanout), ins, g)
    for x, y in zip(ka, kb):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4)


def test_fused_layer_unaligned_views_on_card(cuda):
    """x_self and x_nbr one float off a 16-byte boundary take K2's
    plain-load route; their aligned copies take the ring route; both agree
    with the plain version within 1e-4."""
    d, fanout, f, o = 2000, 10, 100, 256
    gen = torch.Generator().manual_seed(11)
    xs = _randn(gen, d * f + 1, device=cuda)[1:].view(d, f)
    xn = _randn(gen, d * fanout * f + 1, device=cuda)[1:].view(d * fanout,
                                                                f)
    rest = [torch.rand(d * fanout, generator=gen).to(cuda),
            torch.rand(d, generator=gen).to(cuda),
            _randn(gen, f, o, device=cuda) / f ** 0.5,
            _randn(gen, f, o, device=cuda) / f ** 0.5,
            _randn(gen, o, device=cuda)]
    assert xs.data_ptr() % 16 and xn.data_ptr() % 16
    want = ref.fused_gnn_update(xs, xn, *rest, fanout)
    for a, b in ((xs, xn), (xs.clone(), xn.clone())):
        torch.testing.assert_close(ops.fused_gnn_update(a, b, *rest, fanout),
                                   want, rtol=1e-4, atol=1e-4)


def test_refresh_on_card_bit_identical_and_launches_k5(cuda):
    """Accel-only training with the dynamic cache refreshing on every
    boundary gives the same losses, bit for bit, as refresh off, and the
    commits went through K5."""
    ds = make_dataset("ogbn-products", scale=0.01, seed=0)
    g = GNNConfig(model="sage", layer_dims=(100, 64, 47), fanouts=(10, 5))
    runs = {}
    for refresh in (False, True):
        cfg = HybridConfig(total_batch=512, hybrid=False, use_drm=False,
                           tfp_depth=2, cache_fraction=0.2,
                           cache_refresh=refresh, cache_drift_threshold=0.0,
                           recent_rows_batches=2,
                           accel_platform="rtx-a5000")
        tr = HybridGNNTrainer(ds, g, cfg)
        if refresh:
            tr.set_params(runs[False][2])
        params0 = {k: v.cpu().numpy() for k, v in tr.params.items()}
        ops.reset_kernel_launches()
        hist = tr.train(5)
        tr.close()
        runs[refresh] = ([m.loss for m in hist], ops.kernel_launches(),
                         params0, tr.cache.version)
    assert runs[True][0] == runs[False][0]
    assert runs[True][3] > 0 and runs[False][3] == 0
    assert runs[True][1]["cache_update"] >= 1
    assert runs[False][1]["cache_update"] == 0


def test_sharded_plane_on_card_bit_identical_and_launches_k4(cuda):
    """Accel-only training at n_accel=4 (all on one card) with the sharded
    plane and kernel_pipeline_depth=2 gives the replicated run's losses bit
    for bit, and every combine and peer gather went through K4."""
    ds = make_dataset("ogbn-products", scale=0.01, seed=0)
    g = GNNConfig(model="sage", layer_dims=(100, 64, 47), fanouts=(10, 5))
    runs = {}
    for sharding in ("replicated", "sharded"):
        cfg = HybridConfig(total_batch=512, n_accel=4, hybrid=False,
                           use_drm=False, tfp_depth=2, cache_fraction=0.1,
                           cache_sharding=sharding, kernel_pipeline_depth=2,
                           accel_platform="rtx-a5000")
        tr = HybridGNNTrainer(ds, g, cfg)
        if sharding == "sharded":
            tr.set_params(runs["replicated"][2])
        params0 = {k: v.cpu().numpy() for k, v in tr.params.items()}
        ops.reset_kernel_launches()
        hist = tr.train(4)
        tr.close()
        runs[sharding] = ([m.loss for m in hist], ops.kernel_launches(),
                          params0, tr.feature_traffic())
    assert runs["sharded"][0] == runs["replicated"][0]
    for sharding in runs:
        launches = runs[sharding][1]
        assert launches["cache_combine"] == 0
        assert launches["cache_combine_pipelined"] >= 4 * 4
    assert runs["sharded"][3]["peer_rows"] > 0
    assert runs["sharded"][1]["cache_combine_pipelined"] > \
        runs["replicated"][1]["cache_combine_pipelined"]


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_plane_across_cards_bit_identical(n_cards, n):
    """At n_accel=n on n cards, with the cache refreshing on every
    boundary, the sharded plane (peer rows gathered on the owner's card,
    shards refreshed through K6 on their own cards) gives the replicated
    run's losses bit for bit, and every card launched K4."""
    n_cards(n)
    ds = make_dataset("ogbn-products", scale=0.01, seed=0)
    g = GNNConfig(model="sage", layer_dims=(100, 64, 47), fanouts=(10, 5))
    runs = {}
    for sharding in ("replicated", "sharded"):
        cfg = HybridConfig(total_batch=512, n_accel=n, hybrid=False,
                           use_drm=False, tfp_depth=2, cache_fraction=0.1,
                           cache_sharding=sharding, kernel_pipeline_depth=2,
                           cache_refresh=True, cache_drift_threshold=0.0,
                           accel_platform="rtx-a5000")
        tr = HybridGNNTrainer(ds, g, cfg)
        assert [tr._accel_device(f"accel{i}").index for i in range(n)] == \
            list(range(n))
        if sharding == "sharded":
            tr.set_params(runs["replicated"][2])
        params0 = {k: v.cpu().numpy() for k, v in tr.params.items()}
        ops.reset_kernel_launches()
        hist = tr.train(4)
        tr.close()
        runs[sharding] = ([m.loss for m in hist],
                          ops.kernel_launches_by_device(), params0,
                          tr.feature_traffic())
    assert all(math.isfinite(x) for x in runs["sharded"][0])
    assert runs["sharded"][0] == runs["replicated"][0]
    assert runs["sharded"][3]["peer_rows"] > 0
    for sharding in runs:
        by_card = runs[sharding][1]
        assert sorted(by_card["cache_combine_pipelined"]) == list(range(n))
        assert sum(by_card["cache_combine_pipelined"].values()) >= n * 4
        assert sum(by_card["cache_update_pipelined"].values()) >= 1


@pytest.mark.parametrize("agg_impl", ["kernel_fused", "kernel"])
def test_trainer_on_card_matches_host(cuda, agg_impl):
    ds = make_dataset("ogbn-products", scale=0.01, seed=0)
    g = GNNConfig(model="gcn", layer_dims=(100, 64, 47), fanouts=(10, 5),
                  agg_impl=agg_impl)
    # the card's and the host's generators draw different numbers: both
    # runs sample on the host
    cfg = HybridConfig(total_batch=512, use_drm=False, tfp_depth=0,
                       cache_fraction=0.2, use_accel_sampler=False,
                       accel_platform="rtx-a5000")
    runs = {}
    for dev in ("cuda", "cpu"):
        tr = HybridGNNTrainer(ds, g, cfg, device=dev)
        if dev == "cpu":
            tr.set_params(runs["cuda"][2])
        params0 = {k: v.cpu().numpy() for k, v in tr.params.items()}
        ops.reset_kernel_launches()
        hist = tr.train(3)
        tr.close()
        accel_iters = sum(1 for m in hist if m.shares.get("accel0", 0))
        runs[dev] = ([m.loss for m in hist], ops.kernel_launches(), params0,
                     tr.feature_traffic(), accel_iters)
    assert all(math.isfinite(x) for x in runs["cuda"][0])
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], atol=1e-3)
    assert runs["cuda"][3] == runs["cpu"][3]
    launches, accel_iters = runs["cuda"][1], runs["cuda"][4]
    assert accel_iters > 0
    assert launches["cache_combine"] == accel_iters
    key = "fused_update" if agg_impl == "kernel_fused" else "segment_sum"
    assert launches[key] == 2 * accel_iters
    assert runs["cpu"][1] == {k: 0 for k in ops.KERNELS}


def _flash_case(cuda, dtype, b, s, hkv, g, d, pos0):
    """K8 once on seeded inputs, against its plain version."""
    gen = torch.Generator().manual_seed(s * d + g)
    q = _randn(gen, b, s, hkv, g, d, device=cuda).to(dtype)
    k = _randn(gen, b, s, hkv, d, device=cuda).to(dtype)
    v = _randn(gen, b, s, hkv, d, device=cuda).to(dtype)
    n0 = ops.kernel_launches()["flash_attention"]
    got = ops.flash_attention(q, k, v, 512, pos0)
    torch.cuda.synchronize()
    assert ops.kernel_launches()["flash_attention"] == n0 + 1
    want = ref.flash_attention(q, k, v, 512, pos0)
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32 else \
        dict(rtol=1e-2, atol=1e-2)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [100, 512, 2048])
@pytest.mark.parametrize("g", [1, 3, 4, 8])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("pos0", [0, 7])
def test_flash_attention_matches_plain(cuda, dtype, s, g, d, pos0):
    """K8 against its plain version at every head dim it is built for,
    with and without grouping (G = 3: CTAs start mid-position), a ragged
    length (100 = one 64-key tile and a 36-key tail), one 512 block and
    four; pos0 = 7 shifts q and k alike."""
    _flash_case(cuda, dtype, 2, s, 2, g, d, pos0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_at_prefill_length(cuda, dtype):
    """The serving prefill's length and head shape (S 4096, 8 KV heads of
    G 4, D 64) at B 1: every tile kind, from the first CTA's one masked
    tile to the last one's 63 unmasked tiles before its diagonal."""
    _flash_case(cuda, dtype, 1, 4096, 8, 4, 64, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [5, 7])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_at_scout_and_internvl_groups(cuda, dtype, g, d):
    """The group sizes the MoE and vision models bring: G = 5 query heads
    per KV head (llama4-scout, D 128) and G = 7 (internvl2-1b, D 64), each
    at both head dims, at the prefill length S 4096."""
    _flash_case(cuda, dtype, 1, 4096, 2, g, d, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [100, 4096])
@pytest.mark.parametrize("hkv,g", [(2, 1), (2, 4)])
def test_flash_attention_at_zamba_head_dim(cuda, dtype, s, hkv, g):
    """D 112, zamba2-7b's 3584 / 32: 7 k16 steps in the bf16 body and 7
    output columns a thread in the f32 body; G 1 (zamba's shared
    attention) and a GQA group of 4, a ragged length and the prefill's."""
    _flash_case(cuda, dtype, 1, s, hkv, g, 112, 0)


@pytest.mark.parametrize("offset", [1, 4])
@pytest.mark.parametrize("operand", ["q", "k", "o"])
def test_flash_attention_refuses_misaligned_bf16(cuda, offset, operand):
    """A bf16 base pointer off a 16-byte boundary (a view offset by one
    element, 2 bytes, or by four, 8 bytes) raises instead of launching:
    the bf16 body copies 16 bytes a thread."""
    shapes = dict(q=(1, 64, 1, 2, 16), k=(1, 64, 1, 16), o=(1, 64, 1, 2, 16))

    def view(name):
        n = math.prod(shapes[name])
        off = offset if name == operand else 0
        return torch.randn(n + off, device=cuda).to(
            torch.bfloat16)[off:].view(shapes[name])
    q, k, o = view("q"), view("k"), view("o")
    n0 = ops.kernel_launches()["flash_attention"]
    with pytest.raises(RuntimeError, match="launch failed"):
        ops._launch("flash_attention", "flash_attention_bf16", q,
                    q.data_ptr(), k.data_ptr(), k.data_ptr(), o.data_ptr(),
                    1, 64, 1, 2, 16, 0)
    if operand != "o":             # the wrapper's own output is aligned
        with pytest.raises(RuntimeError, match="launch failed"):
            ops.flash_attention(q, k, k)
    assert ops.kernel_launches()["flash_attention"] == n0


def test_flash_attention_refuses_gradient_and_bad_inputs(cuda):
    """A CUDA input that needs a gradient goes through K8 (one launch) and
    gets the reference's recompute VJP: bit-equal to the plain backward on
    the same inputs, which reads q, k, v and the cotangent only.  Bad
    shapes and dtypes still raise."""
    q = torch.randn(1, 64, 1, 2, 16, device=cuda, requires_grad=True)
    k = torch.randn(1, 64, 1, 16, device=cuda, requires_grad=True)
    v = torch.randn(1, 64, 1, 16, device=cuda, requires_grad=True)
    g = torch.randn(1, 64, 1, 2, 16, device=cuda)
    n0 = ops.kernel_launches()["flash_attention"]
    out = ops.flash_attention(q, k, v)
    assert ops.kernel_launches()["flash_attention"] == n0 + 1
    got = torch.autograd.grad(out, (q, k, v), g)
    want = ref.flash_attention_vjp(q.detach(), k.detach(), v.detach(), g)
    for a, b in zip(got, want):
        assert _bits(a).equal(_bits(b))
    with torch.no_grad():                      # nothing recorded
        assert not ops.flash_attention(q, k, v).requires_grad
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(torch.zeros(1, 8, 1, 1, 24, device=cuda),
                            *[torch.zeros(1, 8, 1, 24, device=cuda)] * 2)
    with pytest.raises(TypeError, match="dtypes"):
        ops.flash_attention(q.detach().half(), k.detach().half(),
                            v.detach().half())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,pos0", [((2, 512, 2, 3, 64), 0),
                                        ((1, 1024, 2, 4, 32), 5),
                                        ((1, 4096, 8, 4, 64), 0)])
def test_flash_attention_grad_bit_equal_to_plain_route(cuda, shape, pos0,
                                                       dtype):
    """K8's gradient on the card at the training shape (llama3.2-1b's 8 KV
    heads of 4, D 64, 4,096 tokens) and two others: autograd through K8
    against the plain forward and backward on the same inputs and
    cotangent, bit for bit; the forward within K8's tolerance."""
    gen = torch.Generator().manual_seed(sum(shape) + pos0)
    b, s, hkv, g, d = shape
    q = _randn(gen, *shape, device=cuda).to(dtype).requires_grad_()
    k = _randn(gen, b, s, hkv, d, device=cuda).to(dtype).requires_grad_()
    v = _randn(gen, b, s, hkv, d, device=cuda).to(dtype).requires_grad_()
    cot = _randn(gen, *shape, device=cuda).to(dtype)
    out = ops.flash_attention(q, k, v, 512, pos0)
    got = torch.autograd.grad(out, (q, k, v), cot)
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    want = ref.flash_attention_vjp(qd, kd, vd, cot, 512, pos0)
    for a, w in zip(got, want):
        assert a.dtype == dtype and _bits(a).equal(_bits(w))
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.detach().float(), ref.flash_attention(
        qd, kd, vd, 512, pos0).float(), rtol=tol, atol=tol)


def _lm_train_pair(cfg, batch, make_opt, microbatches, steps, device):
    """``steps`` train steps of one model from the same weights on
    ``device`` and on the host: losses and final params of both."""
    from repro_torch.models import make_train_step
    from repro_torch.models.convert import export_params, \
        load_reference_params
    host = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = init_params(cfg, torch.Generator().manual_seed(0), device)
    load_reference_params(card, export_params(host))
    out = {}
    for model in (card, host):
        opt = make_opt()
        state = opt.init(dict(model.named_parameters()))
        step = make_train_step(cfg, opt, microbatches)
        losses = []
        for _ in range(steps):
            model, state, m = step(model, state, batch)
            losses.append(float(m["loss"]))
        out[model.embed.device.type] = (losses, export_params(model))
    return out["cuda"], out["cpu"]


@pytest.mark.parametrize("impl", ["blocked", "flash"])
def test_reduced_lm_train_step_on_card_matches_host(cuda, impl):
    """Three AdamW steps of the reduced llama (f32, remat on) on the card
    and on the host from the same weights and tokens: losses within 1e-4;
    parameters within 2 lr per step (AdamW moves a weight by about lr
    whatever its gradient's size, so a near-eps gradient whose last bits
    differ moves differently) and on average within 1e-3 lr.  The flash
    route launches K8 twice per layer per step (forward and recompute)."""
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(get_arch("llama3.2-1b", reduced=True),
                              attn_impl=impl, remat=True)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 64)
                                             ).astype(np.int32)
    ops.reset_kernel_launches()
    (cl, cp), (hl, hp) = _lm_train_pair(cfg, {"tokens": toks,
                                              "labels": toks},
                                        lambda: adamw(1e-3), 1, 3, cuda)
    assert ops.kernel_launches()["flash_attention"] == (
        3 * 2 * cfg.n_layers if impl == "flash" else 0)
    np.testing.assert_allclose(cl, hl, rtol=0, atol=1e-4)
    for name in ("embed", "lm_head", "final_norm"):
        d = np.abs(cp[name] - hp[name])
        assert d.max() <= 2 * 1e-3 * 3 and d.mean() <= 1e-6, name
    for name, a in cp["layers"].items():
        d = np.abs(a - hp["layers"][name])
        assert d.max() <= 2 * 1e-3 * 3 and d.mean() <= 1e-6, name


def test_microbatched_step_equals_single_on_card(cuda):
    """The reference's invariant (microbatched = single-shot under SGD,
    rtol 1e-5, atol 1e-6) on the card in f32, through K8."""
    from repro_torch.models import make_train_step
    from repro_torch.optim import sgd
    cfg = dataclasses.replace(get_arch("llama3.2-1b", reduced=True),
                              attn_impl="flash")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (8, 32)
                                             ).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    res = []
    for n in (1, 4):
        model = init_params(cfg, torch.Generator(device=cuda).manual_seed(1),
                            cuda)
        opt = sgd(1e-2)
        model, _, m = make_train_step(cfg, opt, n)(
            model, opt.init(dict(model.named_parameters())), batch)
        res.append((float(m["loss"]), [p.detach().cpu()
                                       for p in model.parameters()]))
    np.testing.assert_allclose(res[0][0], res[1][0], rtol=1e-5)
    for a, b in zip(res[0][1], res[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_lm_flash_matches_blocked_on_card(cuda, dtype):
    """The reduced llama's forward on the card through K8 and through the
    blocked plain path, from the same weights: logits within 1e-4 in f32,
    within 0.125 (0.02 on average) in bf16, where blocked rounds p to bf16
    before p @ v and flash does not."""
    base = dataclasses.replace(get_arch("llama3.2-1b", reduced=True),
                               dtype=dtype)
    model = init_params(base, torch.Generator(device=cuda).manual_seed(0),
                        cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, base.vocab, (2, 128)).astype(np.int32)).to(cuda)
    out = {}
    for impl in ("flash", "blocked"):
        ops.reset_kernel_launches()
        cfg = dataclasses.replace(base, attn_impl=impl)
        logits, _, caches = forward(model, cfg, {"tokens": toks},
                                    return_cache=True)
        out[impl] = (logits.float(), ops.kernel_launches()[
            "flash_attention"])
    assert out["flash"][1] == base.n_layers and out["blocked"][1] == 0
    diff = (out["flash"][0] - out["blocked"][0]).abs()
    if dtype == "float32":
        assert float(diff.max()) <= 1e-4
    else:
        assert float(diff.max()) <= 0.125 and float(diff.mean()) <= 0.02


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b"])
def test_reduced_ssm_lm_on_card_matches_host(cuda, arch):
    """The reduced RWKV and zamba models (f32; zamba through K8, once a
    site) on the card against the host from the same weights: a 256-token
    forward (two 128-token WKV / SSD chunks) and 8 decode steps, logits
    within 1e-4 (cuBLAS's f32 sums in another order, TF32 off)."""
    import copy
    from repro_torch.models import init_decode_cache, make_serve_step
    cfg = dataclasses.replace(get_arch(arch, reduced=True),
                              attn_impl="flash")
    host = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = copy.deepcopy(host).to(cuda)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 256)).astype(
        np.int32)
    out = {}
    for name, model, dev in (("card", card, cuda), ("host", host, "cpu")):
        ops.reset_kernel_launches()
        with torch.no_grad():
            logits, _, _ = forward(model, cfg, {"tokens": toks})
        k8 = ops.kernel_launches()["flash_attention"]
        step = make_serve_step(cfg)
        cache = init_decode_cache(cfg, 2, 8, dev)
        steps = [step(model, cache, {"tokens": toks[:, t:t + 1]})[0].cpu()
                 for t in range(8)]
        out[name] = (logits.cpu(), torch.cat(steps, 1), k8)
    sites = cfg.zamba_structure()[0] if cfg.kind == "zamba" else 0
    assert out["card"][2] == sites and out["host"][2] == 0
    for i in (0, 1):
        assert bool(torch.isfinite(out["card"][i]).all())
        torch.testing.assert_close(out["card"][i], out["host"][i],
                                   rtol=1e-4, atol=1e-4)


def _moe_case(device, dtype, seed=0):
    """``moe_ffn`` (d 256, f 512, 8 experts, top-2, 2 x 256 tokens) from
    seeded host weights and inputs on ``device``: output, aux, the
    gradients of x and the four leaves under a fixed cotangent, and the
    chosen experts (caught at ``_routing_indices``)."""
    from repro_torch.models import moe
    gen = torch.Generator().manual_seed(seed)
    params = moe.init_moe_params(gen, 256, 512, 8, dtype, "cpu")
    x = torch.randn(2, 256, 256, generator=gen).to(dtype)
    w = torch.randn(2, 256, 256, generator=gen).to(dtype)
    leaves = {k: v.to(device).requires_grad_() for k, v in params.items()}
    xd = x.to(device).requires_grad_()
    seen = []
    real = moe._routing_indices

    def spy(logits, top_k, capacity):
        out = real(logits, top_k, capacity)
        seen.append((logits.detach().float().cpu(), out[4].cpu()))
        return out
    moe._routing_indices = spy
    try:
        out, aux = moe.moe_ffn(xd, leaves, top_k=2, capacity_factor=1.25)
        grads = torch.autograd.grad((out * w.to(device)).float().sum()
                                    + 0.01 * aux, [xd, *leaves.values()])
    finally:
        moe._routing_indices = real
    return (out.detach().cpu(), float(aux.detach()),
            [g.cpu() for g in grads], *seen[0])


def test_moe_ffn_on_card_matches_host(cuda):
    """One ``moe_ffn`` forward and backward on the card against the same
    function on the host, the same weights and inputs.

    bf16: the router logits of the two sides may round apart, and a token
    whose top-2 set differs (a routing flip) changes by O(1); the flips
    are counted (printed) and held under 2 % of the assignments, and
    every unflipped token's output agrees within 3e-2 (two bf16 ulps at
    |y| <= 2, the expert products rounding in another order).  f32: the
    host's logits keep every top-2 margin above 1e-4 (5e-4 at least on
    these inputs), a hundred times an f32 sum's rounding over 256 terms,
    so nothing flips; output, aux and every gradient within
    1e-4 of each leaf's largest magnitude (cuBLAS's f32 sums in another
    order, TF32 off)."""
    out_c, aux_c, _, _, exp_c = _moe_case(cuda, torch.bfloat16)
    out_h, aux_h, _, _, exp_h = _moe_case("cpu", torch.bfloat16)
    flipped = (exp_c.sort(-1).values != exp_h.sort(-1).values).any(-1)
    print(f"bf16 routing flips: {int(flipped.sum())} of "
          f"{flipped.numel()} tokens")
    assert int(flipped.sum()) <= 0.02 * flipped.numel()
    ok = ~flipped
    torch.testing.assert_close(out_c.float()[ok], out_h.float()[ok],
                               rtol=3e-2, atol=3e-2)
    assert abs(aux_c - aux_h) <= 1e-2 * abs(aux_h)

    out_c, aux_c, g_c, _, exp_c = _moe_case(cuda, torch.float32)
    out_h, aux_h, g_h, logits_h, exp_h = _moe_case("cpu", torch.float32)
    top = logits_h.sort(-1, descending=True).values
    assert float((top[..., 1] - top[..., 2]).min()) > 1e-4
    assert torch.equal(exp_c, exp_h)
    torch.testing.assert_close(out_c, out_h, rtol=1e-4, atol=1e-4)
    assert abs(aux_c - aux_h) <= 1e-5 * abs(aux_h)
    for name, a, b in zip(["x", "router", "w1", "w3", "w2"], g_c, g_h):
        bound = 1e-4 * float(b.abs().max())
        assert float((a - b).abs().max()) <= bound, name


def _check_device_batch(mb, indptr, indices):
    """On the card: every source a CSR neighbour of its destination, or the
    destination itself at degree 0; the CSR's degrees; the dtypes of
    ``MiniBatch.to``."""
    deg = indptr[1:] - indptr[:-1]
    keys = torch.sort(torch.repeat_interleave(
        torch.arange(deg.shape[0], device=deg.device), deg)
        * deg.shape[0] + indices.long()).values
    frontier = mb.targets
    for h, f in enumerate(mb.fanouts):
        src, dst = mb.hop_src[h], frontier.repeat_interleave(f)
        assert src.dtype == torch.int64 and src.is_cuda
        edge = dst * deg.shape[0] + src
        pos = torch.searchsorted(keys, edge).clamp(max=keys.shape[0] - 1)
        ok = torch.where(deg[dst] == 0, src == dst, keys[pos] == edge)
        assert bool(ok.all())
        assert torch.equal(mb.hop_src_deg[h], deg[src].int())
        assert torch.equal(mb.hop_dst_deg[h], deg[dst].int())
        frontier = torch.cat([frontier, src])


@pytest.mark.parametrize("fanouts", [(25, 10), (3, 2)], ids=str)
def test_device_sampler_on_card(cuda, fanouts):
    """The accelerator sampler on the card: neighbours, degrees and dtypes
    as on the host, the same seed bit-equal."""
    from repro_torch.graph import sample_minibatch_torch
    ds = make_dataset("ogbn-products", scale=0.01, seed=0)
    indptr = torch.from_numpy(ds.graph.indptr).to(cuda)
    indices = torch.from_numpy(ds.graph.indices).to(cuda)
    tgt = torch.from_numpy(np.random.default_rng(0).integers(
        0, ds.num_nodes, 1024)).to(cuda)
    labels = torch.zeros(1024, dtype=torch.int32, device=cuda)
    batches = [sample_minibatch_torch(
        torch.Generator(device=cuda).manual_seed(7), indptr, indices, tgt,
        labels, fanouts) for _ in range(2)]
    _check_device_batch(batches[0], indptr, indices)
    for x, y in zip(batches[0].hop_src + batches[0].hop_src_deg,
                    batches[1].hop_src + batches[1].hop_src_deg):
        assert torch.equal(x, y)
    assert batches[0].labels.dtype == torch.int64


def test_trainer_samples_on_card(cuda):
    """The default configuration samples the first round(0.5 n) of n
    batches on the card (the CPU trainer's, first of two) and trains with
    finite losses."""
    ds = make_dataset("ogbn-products", scale=0.01, seed=0)
    g = GNNConfig(model="sage", layer_dims=(100, 64, 47), fanouts=(10, 5),
                  agg_impl="kernel_fused")
    tr = HybridGNNTrainer(ds, g, HybridConfig(
        total_batch=512, use_drm=False, cache_fraction=0.2,
        accel_platform="rtx-a5000"))
    assert tr._dev_topology[0].is_cuda
    hist = tr.train(3)
    tr.close()
    assert all(math.isfinite(m.loss) for m in hist)
    for m in hist:
        names = list(m.shares)
        assert list(m.device_sampled) == names[:round(0.5 * len(names))]
        assert (m.times.t_sa > 0) == bool(m.device_sampled)
    assert any(m.device_sampled for m in hist)


def test_trainer_over_mmap_on_card_bit_equal_to_dense(cuda, tmp_path):
    """Accel-only training on the card over the mmap spill gives the dense
    run's losses bit for bit (the backend only moves where the rows are
    read from), prices the disk tier, and launches K1 and K2."""
    g = GNNConfig(model="sage", layer_dims=(100, 64, 47), fanouts=(10, 5),
                  agg_impl="kernel_fused")
    runs = {}
    for backend in ("dense", "mmap"):
        kw = ({} if backend == "dense" else
              dict(spill_dir=str(tmp_path / "spill"), partition_rows=4096))
        ds = make_dataset("ogbn-products", scale=0.01, seed=0,
                          feature_backend=backend, **kw)
        tr = HybridGNNTrainer(ds, g, HybridConfig(
            total_batch=512, hybrid=False, use_drm=False, tfp_depth=2,
            cache_fraction=0.2, use_accel_sampler=False,
            accel_platform="rtx-a5000"))
        if runs:
            tr.set_params(runs["dense"][2])
        params0 = {k: v.cpu().numpy() for k, v in tr.params.items()}
        ops.reset_kernel_launches()
        hist = tr.train(4)
        tr.close()
        runs[backend] = ([m.loss for m in hist], ops.kernel_launches(),
                         params0, tr.feature_tier)
    assert runs["mmap"][0] == runs["dense"][0]
    assert (runs["dense"][3], runs["mmap"][3]) == ("ram", "disk")
    for backend in runs:
        assert runs[backend][1]["cache_combine"] >= 4
        assert runs[backend][1]["fused_update"] >= 2 * 4


def test_trainer_prefetch_on_card_bit_equal_to_off(cuda, tmp_path):
    """Hybrid training on the card over the mmap spill with the window
    prefetcher (and then a window LRU bound) gives the prefetch-off run's
    losses bit for bit from the same shares, and the prefetcher ran."""
    g = GNNConfig(model="sage", layer_dims=(100, 64, 47), fanouts=(10, 5),
                  agg_impl="kernel_fused")
    runs = {}
    shares = None
    for name, knobs in (("on", dict(prefetch_windows=4)),
                        ("bounded", dict(prefetch_windows=4,
                                         mmap_lru_windows=4)),
                        ("off", {})):
        ds = make_dataset("ogbn-products", scale=0.01, seed=0,
                          feature_backend="mmap", partition_rows=4096,
                          spill_dir=str(tmp_path / name))
        tr = HybridGNNTrainer(ds, g, HybridConfig(
            total_batch=512, use_drm=False, tfp_depth=2, cache_fraction=0.2,
            use_accel_sampler=False, cache_drift_threshold=1.0,
            accel_platform="rtx-a5000", **knobs))
        a = tr.runtime.assignment
        if shares is None:
            shares = (a.cpu_batch, a.accel_batch)
            w0 = {k: v.cpu().numpy() for k, v in tr.params.items()}
        else:
            tr.set_params(w0)
            a.cpu_batch, a.accel_batch = shares   # off prices overlap 0
        hist = tr.train(4)
        tr.close()
        runs[name] = ([m.loss for m in hist], tr.storage_io(), tr.health())
    assert runs["on"][0] == runs["bounded"][0] == runs["off"][0]
    assert runs["on"][1]["prefetch_submitted"] > 0
    assert runs["bounded"][1]["open_windows"] <= \
        4 + runs["bounded"][1]["pin_blocked_evictions"]
    assert all(r[2]["status"] == "ok" for r in runs.values())


def _card_failure_run(inject, device=None):
    ds = make_dataset("ogbn-products", scale=0.01, seed=0)
    g = GNNConfig(model="sage", layer_dims=(100, 64, 47), fanouts=(10, 5),
                  agg_impl="kernel_fused")
    tr = HybridGNNTrainer(ds, g, HybridConfig(
        total_batch=512, n_accel=2, hybrid=True, use_drm=False, tfp_depth=0,
        cache_fraction=0.2, use_accel_sampler=False, ckpt_every=1,
        accel_platform="rtx-a5000"), device=device)
    if inject:
        tr.inject_failure("accel0", 2)
    # the checkpoint callback runs at the end of every iteration: it reads
    # the launch counts there
    per_iter = []
    tr.set_checkpoint_callback(
        lambda it, p, o: per_iter.append(dict(ops.kernel_launches())))
    ops.reset_kernel_launches()
    hist = tr.train(6)
    tr.close()
    return tr, hist, per_iter


def test_trainer_failure_on_card_survives_and_drops_kernels(cuda):
    """accel0 dies at iteration 2 on the card: every loss stays finite,
    the shares add up over the survivors, and from iteration 2 on only
    accel1 runs K2 (from iteration 3 on, K1 too: iteration 2's combine ran
    before the trainer died)."""
    tr, hist, per_iter = _card_failure_run(True)
    assert all(math.isfinite(m.loss) for m in hist)
    assert tr.health()["components"]["trainers"] == {"failed": ["accel0"]}
    cpu_b, accel_b = hist[-1].assignment
    assert cpu_b + accel_b * tr.runtime.assignment.n_accel == 512
    assert accel_b > 0
    k1 = np.diff([0] + [c["cache_combine"] for c in per_iter])
    k2 = np.diff([0] + [c["fused_update"] for c in per_iter])
    assert list(k1) == [2, 2, 2, 1, 1, 1]
    assert list(k2) == [4, 4, 2, 2, 2, 2]


def test_autotune_on_card_bit_equal_to_off(cuda, tmp_path):
    """The knob autotuner on the card, from a misconfigured start over the
    mmap spill: the same losses bit for bit as the static run."""
    g = GNNConfig(model="sage", layer_dims=(100, 64, 47), fanouts=(10, 5),
                  agg_impl="kernel_fused")
    runs = {}
    for auto in (True, False):
        ds = make_dataset("ogbn-products", scale=0.01, seed=0,
                          feature_backend="mmap", partition_rows=4096,
                          spill_dir=str(tmp_path / f"spill-{auto}"))
        tr = HybridGNNTrainer(ds, g, HybridConfig(
            total_batch=512, n_accel=1, hybrid=False, use_drm=False,
            tfp_depth=2, cache_fraction=0.2, use_accel_sampler=False,
            mmap_lru_windows=1, initial_threads=(4, 1, 1), auto_tune=auto,
            autotune_interval=2, autotune_warmup_windows=0,
            accel_platform="rtx-a5000"))
        if runs:
            tr.set_params(runs[True][2])
        w0 = {k: v.cpu().numpy() for k, v in tr.params.items()}
        ops.reset_kernel_launches()
        hist = tr.train(10)
        tr.close()
        runs[auto] = ([m.loss for m in hist], tr.autotune_report(), w0,
                      ops.kernel_launches())
    assert runs[True][0] == runs[False][0]
    assert runs[True][1]["enabled"] and not runs[False][1]["enabled"]
    for auto in runs:
        assert runs[auto][3]["cache_combine"] >= 10
        assert runs[auto][3]["fused_update"] >= 20


# ------------------------------------------------------ across cards (n_cards)


def _spy_inputs(tr):
    """Every iteration's layer-0 inputs per trainer, as the training thread
    receives them."""
    inputs = {}
    orig = tr._run_trainers

    def run(item):
        p = item.payload
        inputs[p["iteration"]] = {n: x.clone()
                                  for n, x in p["features"].items()}
        return orig(item)
    tr._run_trainers = run
    return inputs


def test_trainers_across_cards_bit_equal_to_one_card(n_cards):
    """The hybrid trainer at n_accel=4 (the CPU trainer on the host, the
    device sampler on cuda:0), the DRM off: one accelerator trainer a card
    gives the layer-0 inputs, losses and final parameters of all four on
    cuda:0 bit for bit, and each card launches K1 once and K2 twice for
    each of its own batches."""
    n_cards(4)
    ds = make_dataset("ogbn-products", scale=0.01, seed=0)
    g = GNNConfig(model="sage", layer_dims=(100, 64, 47), fanouts=(10, 5),
                  agg_impl="kernel_fused")
    cfg = HybridConfig(total_batch=1024, n_accel=4, use_drm=False,
                       tfp_depth=2, cache_fraction=0.2)
    runs = {}
    for placement in ("four", "one"):
        tr = HybridGNNTrainer(ds, g, cfg)
        if placement == "one":
            tr.accel_devices = [torch.device("cuda", 0)] * 4
            tr.set_params(runs["four"][3])
        cards = [tr._accel_device(f"accel{i}").index for i in range(4)]
        assert cards == ([0, 1, 2, 3] if placement == "four" else [0] * 4)
        params0 = {k: v.cpu().numpy() for k, v in tr.params.items()}
        inputs = _spy_inputs(tr)
        ops.reset_kernel_launches()
        hist = tr.train(4)
        tr.close()
        assert all(m.shares[f"accel{i}"] > 0 for m in hist
                   for i in range(4))
        runs[placement] = ([m.loss for m in hist], inputs,
                           {k: v.cpu() for k, v in tr.params.items()},
                           params0, ops.kernel_launches_by_device())
    (l4, x4, p4, _, k4), (l1, x1, p1, _, k1) = runs["four"], runs["one"]
    assert all(math.isfinite(x) for x in l4) and l4 == l1
    assert sorted(x4) == sorted(x1) == list(range(4))
    for it, xs in x4.items():
        assert sorted(xs) == sorted(x1[it])
        for name, x in xs.items():
            assert torch.equal(x.cpu(), x1[it][name].cpu()), (it, name)
    for name, p in p4.items():
        assert torch.equal(p, p1[name]), name
    assert k4["cache_combine"] == {c: 4 for c in range(4)}
    assert k4["fused_update"] == {c: 8 for c in range(4)}
    assert k1["cache_combine"] == {0: 16}
    assert k1["fused_update"] == {0: 32}


# The mesh route over NCCL: llama3.2-1b at full width cut to depth 2 (bf16,
# flash, remat), 3 AdamW steps of 4 x 1024 tokens, one rank a card.
NCCL_DEPTH, NCCL_BATCH, NCCL_SEQ, NCCL_STEPS, NCCL_LR = 2, 4, 1024, 3, 3e-4
NCCL_LOSS_TOL = 5e-3          # chip_smoke.py's TRAIN_LOSS_TOL (bf16 steps)
NCCL_ULP_TOL = 4              # chip_smoke.py's PSUM_ULP_TOL
NCCL_TIMEOUT = 300

_NCCL_RANK = r"""
import dataclasses, datetime, json, math, sys
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_arch
from repro_torch.data import TokenPipeline
from repro_torch.dist import (hierarchical_psum_mean, shard_batch,
                              shard_params, use_mesh)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import init_params, make_train_step, value_and_grad
from repro_torch.optim import adamw
rank, world, store, spec = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                            json.loads(sys.argv[4]))
dev = torch.device("cuda", rank)
torch.cuda.set_device(dev)
dist.init_process_group("nccl", init_method="file://" + store, rank=rank,
                        world_size=world, device_id=dev,
                        timeout=datetime.timedelta(seconds=120))
cfg = dataclasses.replace(get_arch("llama3.2-1b"), attn_impl="flash",
                          n_layers=spec["depth"])
batches = list(TokenPipeline(cfg, spec["batch"], spec["seq"], seed=0,
                             depth=0, device=dev).batches(spec["steps"]))
out = {}
if spec["mode"] == "train":
    mesh = make_local_mesh(model=spec["model"])
    with use_mesh(mesh):
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
        layout = shard_params(model, mesh)
        opt = adamw(spec["lr"])
        state = opt.init(dict(model.named_parameters()))
        step = make_train_step(cfg, opt)
        losses, k8 = [], []
        for b in batches:
            n0 = ops.kernel_launches()["flash_attention"]
            model, state, m = step(model, state, shard_batch(b, mesh))
            losses.append(float(m["loss"].full_tensor()))
            k8.append(ops.kernel_launches()["flash_attention"] - n0)
        out = dict(losses=losses, k8_per_step=k8,
                   mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
                   layout_kept=all(tuple(p.placements) == layout[k]
                                   for k, p in model.named_parameters()),
                   k8_cards=ops.kernel_launches_by_device()[
                       "flash_attention"])
else:
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    row = {k: v[rank:rank + 1] for k, v in batches[0].items()}
    grads = value_and_grad(model, cfg, row)[2]
    tree = {k: g.float() for k, g in grads.items()}
    flat, scale = {}, {}
    for k, g in tree.items():
        t = g.clone()
        dist.all_reduce(t)
        flat[k] = t / world
        a = g.abs()
        dist.all_reduce(a)
        a = a / world
        scale[k] = torch.nextafter(a, torch.full_like(a, math.inf)) - a
    for name, shape, axes in (("data_model", (world, 1), ("data", "model")),
                              ("pod", (2, world // 2, 1),
                               ("pod", "data", "model"))):
        with use_mesh(init_device_mesh("cuda", shape, mesh_dim_names=axes)):
            got = hierarchical_psum_mean(tree)
        out[name] = max(float(((got[k] - flat[k]).abs() / scale[k]).max())
                        for k in tree)
dist.barrier()
dist.destroy_process_group()
print("RESULT:" + json.dumps(out))
"""


def _nccl_ranks(world, tmp_path, spec):
    """``_NCCL_RANK`` in ``world`` processes, rank r on cuda:r, joined over
    NCCL through a FileStore in ``tmp_path``; each prints one ``RESULT:``
    line.  Every process is joined, or killed past ``NCCL_TIMEOUT``."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", _NCCL_RANK, str(r),
                               str(world), store, json.dumps(spec)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=NCCL_TIMEOUT)
            assert p.returncode == 0, err[-3000:]
            line = [ln for ln in out.splitlines()
                    if ln.startswith("RESULT:")][-1]
            outs.append(json.loads(line[len("RESULT:"):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


@pytest.mark.parametrize("model", [1, 2], ids=["dp-4x1", "tp2d-2x2"])
def test_lm_mesh_across_cards_over_nccl_matches_one_process(n_cards,
                                                          tmp_path, model):
    """Four ranks, one a card, over NCCL on a (4 / model, model) mesh under
    the training CLI's rule table: each rank's losses within the bf16 step
    bound of one process on cuda:0 (the batch in 4 microbatches), K8 twice
    a layer a step on its own card, the parameters' layout kept."""
    from repro_torch.data import TokenPipeline
    from repro_torch.models import make_train_step
    from repro_torch.optim import adamw
    cuda = n_cards(4)[0]
    spec = dict(mode="train", depth=NCCL_DEPTH, batch=NCCL_BATCH,
                seq=NCCL_SEQ, steps=NCCL_STEPS, lr=NCCL_LR, model=model)
    outs = _nccl_ranks(4, tmp_path, spec)
    cfg = dataclasses.replace(get_arch("llama3.2-1b"), attn_impl="flash",
                              n_layers=NCCL_DEPTH)
    m1 = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    opt = adamw(NCCL_LR)
    state = opt.init(dict(m1.named_parameters()))
    step = make_train_step(cfg, opt, NCCL_BATCH)
    one = []
    for b in TokenPipeline(cfg, NCCL_BATCH, NCCL_SEQ, seed=0, depth=0,
                           device=cuda).batches(NCCL_STEPS):
        m1, state, m = step(m1, state, b)
        one.append(float(m["loss"]))
    for rank, out in enumerate(outs):
        assert out["mesh"] == {"data": 4 // model, "model": model}
        assert out["layout_kept"]
        assert out["k8_per_step"] == [2 * NCCL_DEPTH] * NCCL_STEPS
        assert out["k8_cards"] == {str(rank): 2 * NCCL_DEPTH * NCCL_STEPS}
        np.testing.assert_allclose(out["losses"], one, rtol=0,
                                   atol=NCCL_LOSS_TOL)


def test_hierarchical_mean_across_cards_over_nccl(n_cards, tmp_path):
    """``hierarchical_psum_mean`` of four ranks' own f32 gradient trees on
    a (4, 1) and a (2, 2, 1) pod mesh against a flat NCCL all-reduce mean:
    within ``NCCL_ULP_TOL`` ulp of the summands' mean magnitude an element
    (the two sum four terms in other orders)."""
    n_cards(4)
    spec = dict(mode="psum", depth=NCCL_DEPTH, batch=4, seq=NCCL_SEQ,
                steps=1)
    for out in _nccl_ranks(4, tmp_path, spec):
        assert out["data_model"] <= NCCL_ULP_TOL, out
        assert out["pod"] <= NCCL_ULP_TOL, out

