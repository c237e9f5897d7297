"""Sort-based top-k routed MoE (port of ``repro/models/moe.py``).

Static-shape dispatch routed **per batch row**: each row's token
assignments are sorted by expert, each expert takes up to ``capacity``
tokens per row (the surplus is dropped, GShard-style), the expert FFNs run
as batched products over the capacity buffer, and outputs are combined
back with the router weights.

The reference vmaps its index math over the batch rows; here the same
integer math runs with a leading ``[B]`` axis, and every index array
equals the reference's element for element:

* top-k through a stable descending sort of a totalOrder key: XLA ranks
  -0.0 below +0.0, ``jax.lax.top_k`` puts the lower expert first on equal
  logits, ``torch.topk`` promises no order, and bf16 router logits over
  8-16 experts tie often;
* ``jnp.argsort(stable=True)`` as ``torch.argsort(stable=True)``; the
  inverse permutation by a scatter (a permutation has one inverse);
* the histogram and ``starts`` in integer ops.

Dispatch and combine are gathers on the token axis by advanced indexing,
never through an index expanded over the model width (at mixtral's width
and 4 x 4,096 tokens that index alone would be 2 GB).  The capacity buffer
is laid out ``[E, B, C, D]`` so the expert products are ``torch.bmm`` over
the experts with no copy; the reference's is ``[B, E, C, D]``, the same
numbers.  The reference's mesh branches are here: its ``constrain`` sites,
and the ``ep`` policy, which shards the capacity buffer over experts on
the model axis when E divides it.
"""
from __future__ import annotations

import functools
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..dist import (_fit_spec, axis_sizes, constrain, current_mesh,
                    current_policy, pspec, shard_map_compat)

__all__ = ["moe_ffn", "init_moe_params", "router_assignment"]


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int,
                    n_experts: int, dtype=torch.float32,
                    device=None) -> Dict[str, torch.Tensor]:
    """Router ``[D, E]`` and expert weights ``w1``/``w3`` ``[E, D, F]``,
    ``w2`` ``[E, F, D]``: N(0, fan_in^-1) draws in f32 on the generator's
    device, cast to ``dtype`` and placed on ``device``."""
    s_in, s_ff = d_model ** -0.5, d_ff ** -0.5

    def draw(shape, std):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * std
        return w.to(device=device or generator.device, dtype=dtype)

    return {"router": draw((d_model, n_experts), s_in),
            "w1": draw((n_experts, d_model, d_ff), s_in),
            "w3": draw((n_experts, d_model, d_ff), s_in),
            "w2": draw((n_experts, d_ff, d_model), s_ff)}


_BITS = {torch.float32: (torch.int32, 0x7FFFFFFF),
         torch.bfloat16: (torch.int16, 0x7FFF)}


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """An int32 key ordered as IEEE 754 totalOrder of ``x``, the order
    XLA's sort and ``top_k`` compare floats by (-0.0 below +0.0)."""
    int_dtype, mask = _BITS[x.dtype]
    bits = x.view(int_dtype).to(torch.int32)
    # negative floats: flip the magnitude bits so a larger one sorts lower
    return bits ^ ((bits >> 31) & mask)


def _top_k(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values in
    totalOrder, ties broken toward the lower index."""
    _, idx = torch.sort(_total_order_key(logits), dim=-1, descending=True,
                        stable=True)
    idx = idx[..., :k]
    return torch.gather(logits, -1, idx), idx


def router_assignment(logits: torch.Tensor, top_k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., E]`` router logits -> (weights ``[..., K]`` f32, experts
    ``[..., K]``): softmax over the selected experts (Mixtral)."""
    gate_logits, experts = _top_k(logits, top_k)
    return torch.softmax(gate_logits.float(), dim=-1), experts


def _capacity(tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    cap = int(max(1, -(-tokens * top_k // n_experts)) * factor)
    return -(-cap // 8) * 8 if cap > 8 else cap


def _routing_indices(logits: torch.Tensor, top_k: int, capacity: int):
    """The index math for rows of ``[..., T, E]`` logits (no data moves).

    Slot ``(e, c)`` holds sorted assignment ``starts[e] + c``, so dispatch
    is ``x[token_for_slot]`` and combine ``y[slot_for_assign]``.  Returns
    ``token_for_slot`` ``[..., E*C]``, ``slot_valid`` ``[..., E*C]``,
    ``slot_for_assign`` ``[..., T*K]``, ``keep`` ``[..., T*K]`` and
    ``experts`` ``[..., T, K]`` (int64 and bool)."""
    *lead, t, e = logits.shape
    dev = logits.device
    _, experts = _top_k(logits, top_k)                        # [..., T, K]
    flat_expert = experts.reshape(*lead, t * top_k)
    order = torch.argsort(flat_expert, dim=-1, stable=True)   # [..., T*K]
    ranks = torch.arange(t * top_k, device=dev).expand_as(order)
    inv_order = torch.empty_like(order).scatter_(-1, order, ranks)
    hist = torch.zeros((*lead, e), dtype=torch.int64, device=dev)
    hist.scatter_add_(-1, flat_expert, torch.ones_like(flat_expert))
    starts = torch.cumsum(hist, dim=-1) - hist                # exclusive
    # dispatch side: slot (e, c) <- sorted position starts[e] + c
    ec = torch.arange(e * capacity, device=dev)
    e_of_slot = (ec // capacity).expand(*lead, -1)
    c_of_slot = ec % capacity
    sorted_idx = torch.clamp(torch.gather(starts, -1, e_of_slot) + c_of_slot,
                             max=t * top_k - 1)
    token_for_slot = torch.gather(order, -1, sorted_idx) // top_k
    slot_valid = c_of_slot < torch.gather(hist, -1, e_of_slot)
    # combine side: assignment (t, k) -> its slot (or overflow)
    pos = inv_order - torch.gather(starts, -1, flat_expert)
    keep = pos < capacity
    slot_for_assign = torch.where(keep, flat_expert * capacity + pos,
                                  torch.zeros_like(pos))
    return token_for_slot, slot_valid, slot_for_assign, keep, experts


def _dispatch(x: torch.Tensor, logits: torch.Tensor, top_k: int,
              capacity: int):
    """Per batch row: route, gather the tokens into the ``[E, B, C, D]``
    capacity buffer (empty slots zero), and the combine's inputs:
    ``slot_for_assign`` ``[B, S*K]`` and the kept gate weights ``wk``
    ``[B, S, K]`` in ``x``'s dtype."""
    b, s, d = x.shape
    e = logits.shape[-1]
    with torch.no_grad():
        token_for_slot, slot_valid, slot_for_assign, keep, experts = \
            _routing_indices(logits, top_k, capacity)
    gate_logits = torch.gather(logits, -1, experts)             # [B, S, K]
    weights = torch.softmax(gate_logits.float(), dim=-1)
    # a gather on the token axis into the [E, B, C, D] buffer
    rows = torch.arange(b, device=x.device)
    tok = token_for_slot.reshape(b, e, capacity).permute(1, 0, 2)
    xe = x[rows[None, :, None], tok]                            # [E, B, C, D]
    valid = slot_valid.reshape(b, e, capacity).permute(1, 0, 2)
    xe = xe.masked_fill(~valid[..., None], 0)
    wk = (weights * keep.reshape(b, s, top_k)).to(x.dtype)
    return xe, slot_for_assign, wk


def _combine(ye: torch.Tensor, slot_for_assign: torch.Tensor,
             wk: torch.Tensor) -> torch.Tensor:
    """Per batch row: each assignment's slot output of ``ye`` ``[E, B, C,
    D]``, weighted over K -> ``[B, S, D]``."""
    _, b, capacity, d = ye.shape
    s, top_k = wk.shape[1], wk.shape[2]
    rows = torch.arange(b, device=ye.device)
    ya = ye[slot_for_assign // capacity, rows[:, None],
            slot_for_assign % capacity]                         # [B, S*K, D]
    return torch.bmm(wk.reshape(b * s, 1, top_k),
                     ya.reshape(b * s, top_k, d)).reshape(b, s, d)


def moe_ffn(x: torch.Tensor, params: Mapping[str, torch.Tensor], *,
            top_k: int, capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: ``[B, S, D]`` -> (out ``[B, S, D]``, aux loss, a 0-d f32 tensor).

    Router logits and the expert products run in ``x``'s dtype; the
    load-balancing aux and the gate softmax in f32.  Under a mesh the
    routing, dispatch and combine run per rank on its batch rows
    (``shard_map_compat``: the index math has no sharding rules and is
    rank-local, as in the reference), and the expert products are DTensor
    products under the reference's constraints.
    """
    b, s, d = x.shape
    e = params["router"].shape[1]
    capacity = _capacity(s, e, top_k, capacity_factor)
    x = constrain(x, ("pod", "data"), None, None)
    # [B, S, E]; every expert's logit beside its row (the routing reads
    # them per row); the identity with no mesh
    logits = constrain(x @ params["router"].to(x.dtype), ("pod", "data"),
                       None, None)
    # load-balancing aux loss per group (= batch row), as in Switch:
    # E * sum_e f_e(row) p_e(row), averaged over rows; it decomposes over
    # microbatches
    probs = torch.softmax(logits.float(), dim=-1)
    top1 = torch.argmax(logits, dim=-1)                  # the first maximum
    fe = (top1[..., None] == torch.arange(e, device=x.device)
          ).float().mean(1)                                     # [B, E]
    aux = (e * torch.sum(fe * probs.mean(1), dim=-1)).mean()

    mesh = current_mesh()
    dispatch = functools.partial(_dispatch, top_k=top_k, capacity=capacity)
    combine = _combine
    ep = False
    if mesh is not None and mesh.size() > 1 and isinstance(x, DTensor):
        msize = axis_sizes(mesh).get("model", 1)
        # expert parallelism ('ep', E % |model| == 0): the capacity buffer
        # is sharded over experts on the model axis
        ep = current_policy() == "ep" and msize > 1 and e % msize == 0
        xs = _fit_spec(mesh, x.shape, pspec(("pod", "data"), None, None))
        b_ax = xs[0]
        dispatch = shard_map_compat(
            dispatch, mesh, in_specs=(xs, xs),
            out_specs=[(None, b_ax, None, None), (b_ax, None),
                       (b_ax, None, None)])
        combine = shard_map_compat(
            _combine, mesh,
            in_specs=((None, b_ax, None, None), (b_ax, None),
                      (b_ax, None, None)), out_specs=xs)
    e_ax = "model" if ep else None
    f_ax = None if ep else "model"

    xe, slot_for_assign, wk = dispatch(x, logits)
    xe = constrain(xe, e_ax, ("pod", "data"), None, None)       # [E, B, C, D]
    xe = xe.reshape(e, b * capacity, d)
    w1, w3, w2 = (params[n].to(x.dtype) for n in ("w1", "w3", "w2"))
    h = F.silu(torch.bmm(xe, w1)) * torch.bmm(xe, w3)           # [E, BC, F]
    h = constrain(h, e_ax, ("pod", "data"), f_ax)
    ye = constrain(torch.bmm(h, w2), e_ax, ("pod", "data"), None)
    out = combine(ye.reshape(e, b, capacity, d), slot_for_assign, wk)
    return constrain(out, ("pod", "data"), None, None), aux
