"""Attention forward's share of its roofline, in %: the least time the
card could take for the launches the trace shows, over their device time.

A launch's bound is max(causal FLOPs / 989 TFLOP/s, bytes / 3.35 TB/s),
counted from the shapes whatever kernel runs the forward: QK^T and PV
over the causal pairs (2 x 2 x D FLOPs a pair and query head), and q, k,
v read and o written once.  Every launch in a cell has one shape: one
microbatch's rows.
"""
from perfbench.harness import peaks
from perfbench.harness.trace import busy

KERNELS = ("flash_fwd_wgmma_kernel", "flash_fwd_kernel")
ELEM_BYTES = 2     # bf16


def causal_pairs(seq: int) -> int:
    return seq * (seq + 1) // 2


def fwd_flops(batch: int, seq: int, heads: int, head_dim: int) -> int:
    return 4 * head_dim * heads * batch * causal_pairs(seq)


def fwd_bytes(batch: int, seq: int, heads: int, kv_heads: int,
              head_dim: int, elem: int = ELEM_BYTES) -> int:
    return elem * batch * seq * head_dim * (2 * heads + 2 * kv_heads)


def bound_s(dims, batch: int, seq: int) -> float:
    return max(fwd_flops(batch, seq, dims.heads, dims.head_dim)
               / peaks.BF16_FLOPS,
               fwd_bytes(batch, seq, dims.heads, dims.kv_heads,
                         dims.head_dim) / peaks.HBM_BYTES_S)


def read(run):
    if run.trace is None:
        return None
    launches = [e for e in run.trace.kernels()
                if any(k in e.name for k in KERNELS)]
    if not launches:
        return None
    tr = run.traffic
    rows = tr["batch"] // tr["microbatches"]
    spent = busy(run.trace, launches)
    return 100.0 * len(launches) * bound_s(run.dims, rows, tr["seq"]) / spent
