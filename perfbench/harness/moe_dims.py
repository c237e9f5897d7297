"""A routed (MoE) configuration's ``arch`` as the sizes the yardstick
counts with: token ids through an embedding, RMSNorm, rotary embeddings,
full causal grouped-query attention, a top-k routed SwiGLU FFN with the
port's per-row capacity and Switch-style aux loss, an untied head.

``from_arch`` refuses any other architecture (a sliding window, another
activation or frontend), so a configuration the MoE reference
(``reference/moe.py``) cannot follow never runs.  The dense decoder's
sizes stay in ``dims.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

SUPPORTED = {"kind": "moe", "hidden_act": "silu", "frontend": "tokens",
             "tie_word_embeddings": False}


@dataclasses.dataclass(frozen=True)
class MoEDims:
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int                     # one expert's hidden width
    experts: int
    top_k: int
    vocab: int
    capacity_factor: float
    aux_coef: float
    rope_theta: float = 1e4
    eps: float = 1e-5

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab // 128) * 128


def from_arch(arch: Dict[str, Any]) -> MoEDims:
    for key, want in SUPPORTED.items():
        if arch.get(key) != want:
            raise ValueError(f"{key} {arch.get(key)!r}: the MoE yardstick "
                             f"follows {want!r} only")
    if arch.get("sliding_window"):
        raise ValueError("sliding_window: the MoE yardstick follows full "
                         "causal attention only")
    return MoEDims(
        layers=arch["num_hidden_layers"], d=arch["hidden_size"],
        heads=arch["num_attention_heads"],
        kv_heads=arch["num_key_value_heads"], head_dim=arch["head_dim"],
        ff=arch["intermediate_size"], experts=arch["num_local_experts"],
        top_k=arch["num_experts_per_tok"], vocab=arch["vocab_size"],
        capacity_factor=arch["capacity_factor"],
        aux_coef=arch["aux_loss_coef"], rope_theta=arch["rope_theta"],
        eps=arch["rms_norm_eps"])


def capacity(dims: MoEDims, tokens: int) -> int:
    """Slots an expert has in one batch row of ``tokens``: ``factor x
    ceil(tokens x top_k / experts)`` rounded down, then up to a multiple
    of 8 where it exceeds 8 (the port's rule, written out)."""
    per = max(1, -(-tokens * dims.top_k // dims.experts))
    cap = int(per * dims.capacity_factor)
    return -(-cap // 8) * 8 if cap > 8 else cap
