"""The FLOP and byte counts of ``step_mfu`` and ``attn_fwd_roofline``
against hand counts at small shapes, and the trace readers on traces
made by hand."""
import dataclasses

import pytest

from perfbench.harness import peaks, spec
from perfbench.harness.dims import Dims
from perfbench.harness.record import Run
from perfbench.harness.trace import Event, Trace, breakdown, busy, gaps

MFU = spec.reader("step_mfu")
ROOF = spec.reader("attn_fwd_roofline")
DENSE = Dims(layers=2, d=8, heads=2, kv_heads=2, head_dim=4, ff=16,
             vocab=128)
GQA = Dims(layers=1, d=8, heads=4, kv_heads=2, head_dim=2, ff=6, vocab=200)


def _pairs_by_loop(seq):
    return sum(i + 1 for i in range(seq))


@pytest.mark.parametrize("seq", [1, 2, 5, 9, 1536])
def test_causal_pairs(seq):
    assert MFU.causal_pairs(seq) == _pairs_by_loop(seq)
    assert ROOF.causal_pairs(seq) == _pairs_by_loop(seq)


def test_product_weights_by_hand():
    # per layer wq wk wv wo 4 x 8 x 8, w1 w2 2 x 8 x 16; head 8 x 128
    assert MFU.product_weights(DENSE) == 2 * (4 * 64 + 2 * 128) + 8 * 128
    # wq wo 8 x 8, wk wv 8 x 4 each; w1 w2 2 x 8 x 6; the head's vocabulary
    # padded to 256
    assert MFU.product_weights(GQA) == (64 + 32 + 32 + 64) + 2 * 48 \
        + 8 * 256


def test_step_flops_by_hand():
    tr = {"batch": 3, "seq": 5}
    # attention: 4 x D x H x B x pairs x L, pairs(5) = 15
    attn = 4 * 4 * 2 * 3 * 15 * 2
    assert MFU.attention_flops(DENSE, 3, 5) == attn
    assert MFU.step_flops(DENSE, tr) == 6 * 2048 * 15 + 3 * attn
    # query heads count, not kv heads: 4 x D 2 x H 4 x B 3 x 15 pairs
    assert MFU.attention_flops(GQA, 3, 5) == 4 * 2 * 4 * 3 * 15


def _run(dims, traffic, **kw):
    base = dict(dims=dims, traffic=traffic, steps=4, window_s=2.0,
                tokens_per_step=traffic["batch"] * traffic["seq"],
                step_ms=[500.0] * 12, input_wait_s=[0.001, 0.003],
                peak_bytes=2_000_000_000, setup_s=9.5)
    base.update(kw)
    return Run(**base)


def test_mfu_reader():
    tr = {"batch": 3, "seq": 5, "microbatches": 1}
    run = _run(DENSE, tr)
    want = 100 * MFU.step_flops(DENSE, tr) / (peaks.BF16_FLOPS * 0.5)
    assert MFU.read(run) == pytest.approx(want)


def test_end_to_end_readers():
    tr = {"batch": 3, "seq": 5, "microbatches": 1}
    run = _run(DENSE, tr)
    assert spec.reader("train_tokens_per_s").read(run) == 4 * 15 / 2.0
    assert spec.reader("memory_peak_gb").read(run) == 2.0
    assert spec.reader("setup_s").read(run) == 9.5
    assert spec.reader("input_wait_ms").read(run) == pytest.approx(2.0)
    assert spec.reader("step_ms_p90").read(run) == 500.0
    assert spec.reader("memory_peak_gb").read(_run(DENSE, tr,
                                                   peak_bytes=0)) is None


def test_attention_forward_bytes_and_flops():
    # q and o [B, S, H, D], k and v [B, S, Hkv, D], bf16
    assert ROOF.fwd_bytes(2, 3, 4, 2, 5) == 2 * 2 * 3 * 5 * (4 + 4 + 2 + 2)
    assert ROOF.fwd_flops(2, 3, 4, 5) == 4 * 5 * 4 * 2 * 6


def _trace(events, spans, steps=2):
    return Trace(device=[Event(n, a, b, c) for n, a, b, c in events],
                 spans=[Event(n, a, b, "user_annotation")
                        for n, a, b in spans],
                 start=min(s[1] for s in spans),
                 end=max(s[2] for s in spans), steps=steps)


def test_busy_gaps_and_breakdown():
    tr = _trace([("k1", 1.0, 2.0, "kernel"), ("k2", 1.5, 3.0, "kernel"),
                 ("Memcpy", 5.0, 6.0, "gpu_memcpy")],
                [("input_wait", 0.0, 1.0), ("step", 1.0, 7.0),
                 ("window_end", 7.0, 8.0)])
    assert busy(tr) == pytest.approx(3.0)
    assert gaps(tr) == [(0.0, 1.0), (3.0, 5.0), (6.0, 8.0)]
    bd = breakdown(tr)
    assert bd["device_ops"][0] == ["k2", 1.5]
    assert bd["idle_gaps"] == [["step", 2.0], ["step", 2.0],
                               ["input_wait", 1.0]]
    idle = spec.reader("device_idle_pct").read(_run(DENSE, {
        "batch": 1, "seq": 1, "microbatches": 1}, trace=tr))
    assert idle == pytest.approx(100 * 5 / 8)


def test_roofline_reader():
    dims = Dims(layers=1, d=8, heads=2, kv_heads=2, head_dim=4, ff=16,
                vocab=128)
    tr = {"batch": 4, "seq": 8, "microbatches": 2}
    bound = ROOF.bound_s(dims, 2, 8)
    t = _trace([("void flash_fwd_wgmma_kernel<64>", 0.0, 4 * bound, "kernel"),
                ("void flash_fwd_wgmma_kernel<64>", 5.0, 5.0 + 4 * bound,
                 "kernel"), ("other", 1.0, 2.0, "kernel")],
               [("step", 0.0, 6.0)])
    run = _run(dims, tr, trace=t)
    assert ROOF.read(run) == pytest.approx(25.0)
    none = dataclasses.replace(run, trace=_trace(
        [("other", 0.0, 1.0, "kernel")], [("step", 0.0, 2.0)]))
    assert ROOF.read(none) is None
