"""A configuration file's ``arch`` as the sizes the yardstick counts with.

The yardstick covers what the benchmark's cells run: a dense decoder with
a tanh-GELU MLP and full causal attention over the port's audio stub
(precomputed frame embeddings).  ``from_arch`` refuses any other
architecture, so a configuration the reference cannot follow never runs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

SUPPORTED = {"kind": "dense", "activation_function": "gelu_pytorch_tanh",
             "frontend": "audio_stub"}


@dataclasses.dataclass(frozen=True)
class Dims:
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    vocab: int
    rope_theta: float = 1e4
    eps: float = 1e-5

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab // 128) * 128


def from_arch(arch: Dict[str, Any]) -> Dims:
    for key, want in SUPPORTED.items():
        if arch.get(key) != want:
            raise ValueError(f"{key} {arch.get(key)!r}: the yardstick "
                             f"follows {want!r} only")
    if arch.get("sliding_window"):
        raise ValueError("sliding_window: the yardstick follows full "
                         "causal attention only")
    return Dims(
        layers=arch["num_hidden_layers"], d=arch["hidden_size"],
        heads=arch["num_attention_heads"],
        kv_heads=arch["num_key_value_heads"], head_dim=arch["head_dim"],
        ff=arch["ffn_dim"], vocab=arch["vocab_size"],
        rope_theta=arch["rope_theta"], eps=arch["rms_norm_eps"])
