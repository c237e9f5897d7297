"""Model FLOPs of a routed model's step over the peak of the run's cards
(989 TFLOP/s each) x the window's mean step time, in %.

FLOPs a step, each x3 for the forward and the backward (recomputation
not counted): 2 x the weights of the products every token passes
through (attention's projections, the router, the head) x the tokens;
attention's score and value products over the causal query-key pairs
(2 x 2 x D a pair and query head); and the experts' SwiGLU products,
2 x 3 x d x ff a kept assignment, counted from the assignments the
router kept (``moe.assignments`` less ``moe.dropped``, summed over the
ranks, a traced step's mean): a dropped assignment and an empty slot of
the capacity buffer are no model work.
"""
from perfbench.harness import peaks


def dense_weights(dims) -> int:
    """Weights of the products every token passes through."""
    d, hd = dims.d, dims.head_dim
    attn = d * hd * (2 * dims.heads + 2 * dims.kv_heads)
    return dims.layers * (attn + d * dims.experts) + d * dims.vocab_padded


def causal_pairs(seq: int) -> int:
    return seq * (seq + 1) // 2


def attention_flops(dims, batch: int, seq: int) -> int:
    return 4 * dims.head_dim * dims.heads * batch * causal_pairs(seq) * \
        dims.layers


def expert_flops(dims, kept: float) -> float:
    """Forward FLOPs of ``kept`` assignments (all layers' together)."""
    return 2.0 * 3 * dims.d * dims.ff * kept


def step_flops(dims, traffic, kept: float) -> float:
    b, s = traffic["batch"], traffic["seq"]
    return 3 * (2 * dense_weights(dims) * b * s
                + attention_flops(dims, b, s) + expert_flops(dims, kept))


def read(run):
    c = getattr(run, "moe_counters", None)
    if not c or run.trace is None or run.trace.steps < 1 or run.steps < 1:
        return None
    kept = (c["moe.assignments"] - c["moe.dropped"]) / run.trace.steps
    mean_step_s = run.window_s / run.steps
    return 100.0 * step_flops(run.dims, run.traffic, kept) / (
        peaks.BF16_FLOPS * getattr(run, "ranks", 1) * mean_step_s)
