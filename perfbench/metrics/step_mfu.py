"""Model FLOPs of a step over 989 TFLOP/s x the window's mean step time,
in %.

FLOPs a step: 6 x the weights of the products a token passes through
(attention's projections, the MLP, the head; not the embedding lookup,
not the norms) x the tokens, plus attention's score and value products
over the causal query-key pairs, x3 for the forward and the backward.
Recomputation (remat, the attention VJP's forward) is not counted.
"""
from perfbench.harness import peaks


def product_weights(dims) -> int:
    d, hd = dims.d, dims.head_dim
    attn = d * hd * (2 * dims.heads + 2 * dims.kv_heads)
    ffn = 2 * d * dims.ff
    return dims.layers * (attn + ffn) + d * dims.vocab_padded


def causal_pairs(seq: int) -> int:
    """Query-key pairs a sequence attends."""
    return seq * (seq + 1) // 2


def attention_flops(dims, batch: int, seq: int) -> int:
    """Forward: QK^T and PV, 2 x 2 x D FLOPs a pair and query head."""
    return 4 * dims.head_dim * dims.heads * batch * \
        causal_pairs(seq) * dims.layers


def step_flops(dims, traffic) -> int:
    b, s = traffic["batch"], traffic["seq"]
    return 6 * product_weights(dims) * b * s + \
        3 * attention_flops(dims, b, s)


def read(run):
    mean_step_s = run.window_s / run.steps
    return 100.0 * step_flops(run.dims, run.traffic) / (
        peaks.BF16_FLOPS * mean_step_s)
