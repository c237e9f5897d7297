"""Parameter-sharding rule table, FSDP x TP (port of
``repro/dist/sharding.py``).

``param_pspec(name, leaf, stack)`` maps one parameter (or optimizer-state)
leaf to a spec against the ambient mesh, with the reference's rules:

  * norm scales / biases / 0-1D leaves: replicated,
  * >= 2-D weights: last dim over ``model`` (tensor parallelism), the
    second-to-last over the data-parallel axes (FSDP), each only when the
    axes' product divides the dim,
  * under the 'dp' policy, with no mesh or a mesh of one rank: replicated.

The reference stacks each layer's leaves on leading axes (``[L, ...]``,
zamba's ``[sites, per, ...]``) and applies the rules to the stacked leaf;
the port keeps one tensor a layer.  So the rules run on the reference's
stacked shape (``stack`` + the leaf's shape) and the spec drops the
leading stack entries.  The reference leaves a stack dim unsharded except
where a 1-D leaf's stacked form is 2-D and the dp axes divide the layer
count (rwkv6-1.6b's ``w0`` on a 4 x 2 mesh): that entry has no per-layer
counterpart, and the port's leaf stays replicated over those axes.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

from . import Spec, axis_sizes, current_mesh, current_policy

__all__ = ["param_pspec", "stack_sizes"]

_REPLICATED_NAMES = ("ln", "norm", "scale", "bias", "step", "count")
_STACKED = ("layers", "tail")


def param_pspec(name: str, leaf: Any, stack: Tuple[int, ...] = ()) -> Spec:
    """The spec of leaf ``name`` (``named_parameters()``'s name; the rule
    reads its last component) of shape ``leaf.shape``, stacked in the
    reference under ``stack``."""
    shape = tuple(stack) + tuple(leaf.shape)
    nd, lead = len(shape), len(stack)
    mesh = current_mesh()
    sizes = axis_sizes(mesh)
    total = 1
    for n in sizes.values():
        total *= n
    leaf_name = name.rsplit(".", 1)[-1]
    if (mesh is None or total == 1 or nd < 2 or current_policy() == "dp"
            or any(leaf_name.startswith(r) or r in leaf_name
                   for r in _REPLICATED_NAMES)):
        return (None,) * leaf.dim()
    dims: list = [None] * nd
    msize = sizes.get("model", 1)
    dp_axes = tuple(n for n in ("pod", "data") if n in sizes)
    dp_size = 1
    for n in dp_axes:
        dp_size *= sizes[n]
    if msize > 1 and shape[-1] % msize == 0:
        dims[-1] = "model"
    if dp_size > 1 and shape[-2] % dp_size == 0:
        dims[-2] = dp_axes[0] if len(dp_axes) == 1 else dp_axes
    return tuple(dims[lead:])


def stack_sizes(named: Mapping[str, Any]) -> Dict[str, Tuple[int, ...]]:
    """``{name: the reference's stack dims}`` for per-layer leaves
    (``layers.<i>.<leaf>``, zamba's ``layers.<site>.<j>.<leaf>``,
    ``tail.<i>.<leaf>``); other names stack nothing and are left out."""
    parsed = {}
    for name in named:
        parts = name.split(".")
        if parts[0] not in _STACKED:
            continue
        idx = []
        for p in parts[1:]:
            if not p.isdigit():
                break
            idx.append(int(p))
        rest = ".".join(parts[1 + len(idx):])
        parsed[name] = ((parts[0], len(idx), rest), tuple(idx))
    extent: Dict[Tuple, list] = {}
    for key, idx in parsed.values():
        ext = extent.setdefault(key, [0] * len(idx))
        for i, v in enumerate(idx):
            ext[i] = max(ext[i], v + 1)
    return {name: tuple(extent[key]) for name, (key, _) in parsed.items()}
