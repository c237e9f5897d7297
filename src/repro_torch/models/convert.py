"""Carrying LM weights between the reference's layout and the port's.

The reference keeps parameters as a nested dict with every layer weight
stacked on a leading ``[L, ...]`` axis (``embed``, ``final_norm``,
``lm_head``, ``layers: {ln1, wq, ...}``, an MoE layer's routed FFN nested
as ``layers: {moe: {router, w1, w3, w2}}``).  Zamba's tree stacks its
Mamba layers ``[sites, per, ...]`` under ``layers`` and the layers after
the last site ``[tail, ...]`` under ``tail``, beside the flat
``shared_attn`` dict.  ``load_reference_params`` copies such a tree of
numpy arrays into an ``LM`` bit for bit; ``export_params`` gives it back,
so a round trip is the identity.  ``export_named`` lays any ``{parameter
name: tensor}`` dict (gradients, optimizer moments) out in the same tree,
so the port's training state compares leaf by leaf with the reference's.

bf16 leaves may arrive as float32 (every bf16 value is exact in f32) or as
uint16 bit patterns, since numpy has no bf16 without ``ml_dtypes`` (which
the card's machine lacks).  A float32 leaf that is not exactly a bf16 value
is refused rather than rounded.  A leaf the port keeps in f32 inside a bf16
model (RWKV's ``w0`` and ``u``, Mamba's ``A_log``, ``D`` and ``dt_bias``)
takes the float32 array as it is.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["load_reference_params", "export_params", "export_named"]

_TOP = ("embed", "final_norm", "lm_head")

# (tree path, stack shape, the port's parameter names in row-major order
# over the stack; one name and shape () for an unstacked leaf)
_Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], List[str]]


def _stacks(model: nn.Module) -> Iterator[Tuple[str, Tuple[int, ...],
                                                List[str]]]:
    """(tree key, stack shape, module prefixes) of each stacked group."""
    layers = model.layers
    if isinstance(layers[0], nn.ModuleList):          # zamba's sites
        yield "layers", (len(layers), len(layers[0])), [
            f"layers.{s}.{j}" for s in range(len(layers))
            for j in range(len(layers[0]))]
    else:
        yield "layers", (len(layers),), [f"layers.{i}"
                                         for i in range(len(layers))]
    if hasattr(model, "tail"):
        yield "tail", (len(model.tail),), [f"tail.{i}"
                                           for i in range(len(model.tail))]


def _leaves(model: nn.Module) -> Iterator[_Leaf]:
    """Every leaf of the reference's tree: the top-level ones, each
    stacked group's (a submodule's leaf nests, as ``("layers", "moe",
    "router")``) and the flat ``shared_attn`` dict's."""
    for name in _TOP:
        yield (name,), (), [name]
    for key, stack, prefixes in _stacks(model):
        first = model.get_submodule(prefixes[0])
        for name, _ in first.named_parameters():
            yield (key, *name.split(".")), stack, [f"{p}.{name}"
                                                   for p in prefixes]
    if hasattr(model, "shared_attn"):
        for name, _ in model.shared_attn.named_parameters():
            yield ("shared_attn", name), (), [f"shared_attn.{name}"]


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
    ``[L, ...]``, zamba's ``[sites, per, ...]``) into ``model`` in place,
    bit for bit; returns it."""
    named = dict(model.named_parameters())
    with torch.no_grad():
        for path, stack, names in _leaves(model):
            node: object = tree
            for key in path:
                node = node[key]  # type: ignore[index]
            like = named[names[0]]
            t = _to_tensor(node, like.dtype,  # type: ignore[arg-type]
                           (*stack, *like.shape), "/".join(path))
            for name, part in zip(names, t.reshape(-1, *like.shape)):
                named[name].copy_(part)
    return model


def export_named(model: nn.Module,
                 tensors: Dict[str, torch.Tensor]) -> Dict[str, object]:
    """The reference's tree of a dict keyed by ``model``'s parameter names
    (``embed``, ``layers.<i>.<leaf>``, ``layers.<i>.moe.<leaf>``,
    ``layers.<site>.<j>.<leaf>``, ``tail.<i>.<leaf>``,
    ``shared_attn.<leaf>``, ...) as numpy float32 copies (bf16 widened
    exactly; a later in-place update does not reach them), stacked groups
    stacked as the reference's."""
    def host(name: str) -> np.ndarray:
        return tensors[name].detach().to("cpu", torch.float32,
                                         copy=True).numpy()

    tree: Dict[str, object] = {}
    for path, stack, names in _leaves(model):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})  # type: ignore[assignment]
        if stack:
            arr = np.stack([host(n) for n in names])
            node[path[-1]] = arr.reshape(*stack, *arr.shape[1:])
        else:
            node[path[-1]] = host(names[0])
    return tree


def export_params(model: nn.Module) -> Dict[str, object]:
    """The reference's tree of ``model``'s weights as numpy float32 (bf16
    leaves widened exactly), stacked as the reference's."""
    return export_named(model, dict(model.named_parameters()))
