"""Analytic cost model: per-rank FLOPs and bytes of one step, counted by a
``TorchDispatchMode`` (port of ``repro/launch/costmodel.py``, which walks
the jaxpr).

The port runs eagerly, so the mode sees every op as executed: remat's
recomputed forwards and each microbatch count as often as they run.
Conventions, as the reference's:

  * a product (``mm``, ``bmm``, ``addmm``, ``baddbmm``) costs 2·M·N·K
    FLOPs and moves its operands and output;
  * K8's op (``repro_torch::flash_attention``) is charged as the reference
    charges its ``pallas_call``: 2·2·B·Hkv·G·S²·D·0.5 FLOPs (two causal
    products) and q + k + v + o bytes (``repro/launch/costmodel.py:101-111``);
  * every other op costs one FLOP per output element and no bytes (its
    chains are assumed fused);
  * the step's tensor arguments and outputs move once (``add_io``).

A DTensor op is seen once, at its global shapes: its per-rank share is the
global cost over the product of the mesh dims its output is ``Shard`` or
``Partial`` on (a product's rows, columns or contraction split there; a
``Replicate`` dim computes it whole on each rank).  An op on plain tensors
inside ``dist.shard_map_compat`` is already per rank; its global cost is
that times ``dist.local_shards()``.  ``global_product_flops`` is the
reference's quantity (the unpartitioned program's products), for parity.
Collectives are not counted here (``analysis.CollectiveBytes``).
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from collections import Counter
from typing import Dict, Iterable, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Shard
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..dist import local_shards

__all__ = ["CostEstimate", "CostMode", "LiveBytes", "local_nbytes",
           "is_collective"]

_PRODUCTS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1}   # operand offset
_FLASH = "repro_torch::flash_attention"
# ops that move or alias data without computing (no FLOP), and the waits
_FREE = ("wait_tensor", "empty", "empty_like", "empty_strided", "detach",
         "_to_copy", "lift_fresh", "alias", "device")


def is_collective(func) -> bool:
    """A collective of the functional API, c10d or DTensor (not a wait)."""
    return func.namespace in ("_c10d_functional", "c10d_functional",
                              "c10d", "_dtensor") \
        and "wait" not in func._opname


@dataclasses.dataclass
class CostEstimate:
    flops: float = 0.0                 # per rank
    bytes: float = 0.0                 # per rank
    product_flops: float = 0.0         # per rank, products and K8
    global_product_flops: float = 0.0  # the unpartitioned program's


def local_nbytes(t: torch.Tensor) -> int:
    """Bytes of the rank's own shard (the tensor itself if plain)."""
    if isinstance(t, DTensor):
        # the shard itself: to_local() would add an autograd view per call
        t = t._local_tensor
    return t.numel() * t.element_size()


def _numel(shape: Sequence[int]) -> int:
    return math.prod(int(s) for s in shape)


def _split(out: torch.Tensor) -> Dict[str, int]:
    """For a DTensor output: the mesh-size product over which each output
    dim is sharded (``"d<i>"``) and over which it is partial (``"k"``)."""
    parts: Dict[str, int] = Counter()
    if not isinstance(out, DTensor):
        return parts
    for size, p in zip(out.device_mesh.shape, out.placements):
        key = (f"d{p.dim}" if isinstance(p, Shard)
               else "k" if isinstance(p, Partial) else None)
        if key is not None:
            parts[key] = parts.get(key, 1) * size
    return parts


def _product(name: str, args, out: torch.Tensor):
    """(global FLOPs, per-rank FLOPs, per-rank bytes) of one product."""
    a, b = args[_PRODUCTS[name]], args[_PRODUCTS[name] + 1]
    itemsize = a.element_size()
    *batch, m, k = a.shape
    n = b.shape[-1]
    bt = _numel(batch)
    flops = 2.0 * bt * m * n * k
    sp = _split(out)
    nb = len(batch)
    gb = sp.get("d0", 1) if nb else 1
    gm, gn, gk = sp.get(f"d{nb}", 1), sp.get(f"d{nb + 1}", 1), sp.get("k", 1)
    local = flops / (gb * gm * gn * gk)
    moved = itemsize * (bt * (m * k / gm + k * n / gn) / gk + bt * m * n
                        / (gm * gn)) / gb
    return flops, local, moved


class CostMode(TorchDispatchMode):
    """Counts each op's cost per rank into ``self.cost`` (and FLOPs by op
    name into ``self.by_op``) while it is active."""

    def __init__(self):
        super().__init__()
        self.cost = CostEstimate()
        self.by_op: Dict[str, float] = Counter()

    def add_io(self, tensors: Iterable[torch.Tensor]) -> None:
        """The step's arguments or outputs, moved once."""
        self.cost.bytes += sum(local_nbytes(t) for t in tensors
                               if isinstance(t, torch.Tensor))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._opname
        if is_collective(func) or name in _FREE:
            return out
        c = self.cost
        if name in _PRODUCTS:
            flops, local, moved = _product(name, args, out)
            if not isinstance(out, DTensor):     # inside a shard_map region
                flops = local * local_shards()
            c.flops += local
            c.product_flops += local
            c.global_product_flops += flops
            c.bytes += moved
            self.by_op[name] += local
        elif func._schema.name == _FLASH:
            q, k, v = args[:3]
            b, s, hkv, g, d = q.shape
            local = 2 * 2 * b * hkv * g * s * s * d * 0.5
            c.flops += local
            c.product_flops += local
            c.global_product_flops += local * local_shards()
            c.bytes += sum(local_nbytes(t) for t in (q, k, v, out))
            self.by_op["flash_attention"] += local
        else:
            n = sum(local_nbytes(t) // max(t.element_size(), 1)
                    for t in pytree.tree_leaves(out)
                    if isinstance(t, torch.Tensor))
            c.flops += n
            self.by_op[name] += n
        return out


class LiveBytes(TorchDispatchMode):
    """The peak, over a run, of the per-rank bytes of tensors the run
    allocated that are still alive (views and in-place results are not new
    allocations)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func._opname == "wait_tensor" or any(
                r.alias_info is not None for r in func._schema.returns):
            return out
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                n = local_nbytes(t)
                self.live += n
                weakref.finalize(t, self._free, n)
        self.peak = max(self.peak, self.live)
        return out

