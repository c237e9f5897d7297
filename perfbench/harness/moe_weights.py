"""A routed configuration's initial weights, made from the seed leaf by
leaf: leaf ``i`` (in ``leaf_specs`` order) is drawn by a
``torch.Generator`` seeded with ``leaf_seed(seed, i)`` on the device, in
f32, then scaled and rounded to the served dtype.  So any leaf can be made
again alone, on any rank, which the blocked reference needs: it holds one
layer's f32 weights at a time.  Leaves carry the port's parameter names;
the router and each expert's products are N(0, fan_in^-1), the embedding
N(0, 0.02^2), the norms ones."""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import torch

from .moe_dims import MoEDims

CHUNK = 1 << 27      # elements a randn call (512 MB of f32 at once)
_MIX = 0x9E3779B97F4A7C15
_MASK = (1 << 63) - 1

Spec = Tuple[str, Tuple[int, ...], Optional[float]]


def leaf_seed(seed: int, index: int) -> int:
    """A generator seed for leaf ``index`` of run ``seed`` (any integer
    seed; the result fits the generator's 63 bits)."""
    return (int(seed) * _MIX + (index + 1) * 0xBF58476D1CE4E5B9) & _MASK


def layer_specs(dims: MoEDims, i: int) -> List[Spec]:
    d, hd, f, e = dims.d, dims.head_dim, dims.ff, dims.experts
    p = f"layers.{i}."
    return [(p + "ln1", (d,), None),
            (p + "wq", (d, dims.heads * hd), d ** -0.5),
            (p + "wk", (d, dims.kv_heads * hd), d ** -0.5),
            (p + "wv", (d, dims.kv_heads * hd), d ** -0.5),
            (p + "wo", (dims.heads * hd, d), (dims.heads * hd) ** -0.5),
            (p + "ln2", (d,), None),
            (p + "moe.router", (d, e), d ** -0.5),
            (p + "moe.w1", (e, d, f), d ** -0.5),
            (p + "moe.w3", (e, d, f), d ** -0.5),
            (p + "moe.w2", (e, f, d), f ** -0.5)]


def leaf_specs(dims: MoEDims) -> List[Spec]:
    """``(name, shape, std)`` of every leaf; std None for a norm's ones."""
    d, vp = dims.d, dims.vocab_padded
    specs: List[Spec] = [("embed", (vp, d), 0.02), ("final_norm", (d,), None),
                         ("lm_head", (d, vp), d ** -0.5)]
    for i in range(dims.layers):
        specs += layer_specs(dims, i)
    return specs


def _index(dims: MoEDims) -> Dict[str, int]:
    return {name: i for i, (name, _, _) in enumerate(leaf_specs(dims))}


def leaf(dims: MoEDims, name: str, seed: int, device: torch.device,
         dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Leaf ``name``'s start value in ``dtype`` (the reference widens the
    bf16 values: ``leaf(...).float()``)."""
    specs = leaf_specs(dims)
    i = _index(dims)[name]
    _, shape, std = specs[i]
    if std is None:
        return torch.ones(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, i))
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for off in range(0, flat.numel(), CHUNK):
        n = min(CHUNK, flat.numel() - off)
        flat[off:off + n] = torch.randn(n, generator=gen, device=device,
                                        dtype=torch.float32).mul_(std)
    return out


def leaves(dims: MoEDims, names, seed: int, device: torch.device,
           dtype: torch.dtype = torch.bfloat16
           ) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(name, leaf)`` for each of ``names``, one made at a time."""
    for name in names:
        yield name, leaf(dims, name, seed, device, dtype)


def make(dims: MoEDims, seed: int, device: torch.device,
         dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Every leaf at once (small sizes: the tests)."""
    return dict(leaves(dims, [n for n, _, _ in leaf_specs(dims)], seed,
                       device, dtype))
