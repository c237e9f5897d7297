"""A cell's initial weights, made from the seed: one flat buffer in the
served dtype, filled by a few large ``randn`` calls of a ``torch.Generator``
on the device, then cut into leaves and scaled.  Both the port and the
plain reference start from these values (the reference in f32, exactly
the bf16 values).  Leaves carry the port's parameter names."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .dims import Dims

CHUNK = 1 << 27      # elements per randn call (512 MB of f32 at once)


def leaf_specs(dims: Dims) -> List[Tuple[str, Tuple[int, ...],
                                         Optional[float]]]:
    """``(name, shape, std)``; std None for a norm's ones."""
    d, hd, f = dims.d, dims.head_dim, dims.ff
    vp = dims.vocab_padded
    specs = [("embed", (vp, d), 0.02), ("final_norm", (d,), None),
             ("lm_head", (d, vp), d ** -0.5)]
    for i in range(dims.layers):
        p = f"layers.{i}."
        specs += [(p + "ln1", (d,), None),
                  (p + "wq", (d, dims.heads * hd), d ** -0.5),
                  (p + "wk", (d, dims.kv_heads * hd), d ** -0.5),
                  (p + "wv", (d, dims.kv_heads * hd), d ** -0.5),
                  (p + "wo", (dims.heads * hd, d),
                   (dims.heads * hd) ** -0.5),
                  (p + "ln2", (d,), None),
                  (p + "w1", (d, f), d ** -0.5),
                  (p + "w2", (f, d), f ** -0.5)]
    return specs


def _numel(shape: Tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make(dims: Dims, seed: int, device: torch.device,
         dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """``{name: tensor}``; the random leaves are views of one buffer."""
    specs = leaf_specs(dims)
    total = sum(_numel(s) for _, s, std in specs if std is not None)
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    for off in range(0, total, CHUNK):
        n = min(CHUNK, total - off)
        flat[off:off + n] = torch.randn(n, generator=gen, device=device,
                                        dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for name, shape, std in specs:
        if std is None:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
            continue
        n = _numel(shape)
        out[name] = flat[off:off + n].view(shape).mul_(std)
        off += n
    return out
