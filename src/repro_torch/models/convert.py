"""Carrying LM weights between the reference's layout and the port's.

The reference keeps parameters as a nested dict with every layer weight
stacked on a leading ``[L, ...]`` axis (``embed``, ``final_norm``,
``lm_head``, ``layers: {ln1, wq, ...}``, an MoE layer's routed FFN nested
as ``layers: {moe: {router, w1, w3, w2}}``).  ``load_reference_params`` copies
such a tree of numpy arrays into an ``LM`` bit for bit; ``export_params``
gives it back, so a round trip is the identity.  ``export_named`` lays any
``{parameter name: tensor}`` dict (gradients, optimizer moments) out in
the same tree, so the port's training state compares leaf by leaf with the
reference's.

bf16 leaves may arrive as float32 (every bf16 value is exact in f32) or as
uint16 bit patterns, since numpy has no bf16 without ``ml_dtypes`` (which
the card's machine lacks).  A float32 leaf that is not exactly a bf16 value
is refused rather than rounded.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["load_reference_params", "export_params", "export_named"]

_TOP = ("embed", "final_norm", "lm_head")


def _names(model: nn.Module) -> Iterator[Tuple[str, ...]]:
    """Tree path of every parameter: top-level leaves by name, layer leaves
    as ``("layers", *name)`` (one stacked leaf over all layers; a
    submodule's leaf nests, as ``("layers", "moe", "router")``)."""
    for name in _TOP:
        yield (name,)
    for name, _ in model.layers[0].named_parameters():
        yield ("layers", *name.split("."))


def _to_tensor(arr: np.ndarray, dtype: torch.dtype, shape: Tuple[int, ...],
               path: str) -> torch.Tensor:
    arr = np.asarray(arr)
    if tuple(arr.shape) != shape:
        raise ValueError(f"{path}: shape {arr.shape}, expected {shape}")
    if dtype == torch.bfloat16 and arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    if arr.dtype != np.float32:
        raise TypeError(f"{path}: dtype {arr.dtype}; float32 (or uint16 "
                        f"bf16 bits) expected")
    t = torch.from_numpy(arr.copy())
    if dtype == torch.float32:
        return t
    out = t.to(dtype)
    if not torch.equal(out.float(), t):
        raise ValueError(f"{path}: float32 values are not exactly "
                         f"representable in {dtype}")
    return out


def load_reference_params(model: nn.Module,
                          tree: Dict[str, object]) -> nn.Module:
    """Copy the reference's parameter tree (numpy leaves, layers stacked
    ``[L, ...]``) into ``model`` in place, bit for bit; returns it."""
    with torch.no_grad():
        for path in _names(model):
            node: object = tree
            for key in path:
                node = node[key]  # type: ignore[index]
            name = ".".join(path[1:])
            if path[0] == "layers":
                like = model.layers[0].get_parameter(name)
                shape = (len(model.layers), *like.shape)
            else:
                like = getattr(model, path[0])
                shape = tuple(like.shape)
            t = _to_tensor(node, like.dtype, shape,  # type: ignore[arg-type]
                           "/".join(path))
            if path[0] == "layers":
                for i, layer in enumerate(model.layers):
                    layer.get_parameter(name).copy_(t[i])
            else:
                like.copy_(t)
    return model


def export_named(model: nn.Module,
                 tensors: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """The reference's tree of a dict keyed by ``model``'s parameter names
    (``embed``, ``layers.<i>.<leaf>``, ``layers.<i>.moe.<leaf>``, ...) as
    numpy float32 copies (bf16 widened exactly; a later in-place update
    does not reach them), layer leaves stacked ``[L, ...]``."""
    def host(name: str) -> np.ndarray:
        return tensors[name].detach().to("cpu", torch.float32,
                                         copy=True).numpy()

    tree: Dict[str, object] = {"layers": {}}
    for path in _names(model):
        if path[0] != "layers":
            tree[path[0]] = host(path[0])
            continue
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})  # type: ignore[assignment]
        name = ".".join(path[1:])
        node[path[-1]] = np.stack([host(f"layers.{i}.{name}")
                                   for i in range(len(model.layers))])
    return tree


def export_params(model: nn.Module) -> Dict[str, object]:
    """The reference's tree of ``model``'s weights as numpy float32 (bf16
    leaves widened exactly), layers stacked ``[L, ...]``."""
    return export_named(model, dict(model.named_parameters()))
