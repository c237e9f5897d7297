"""Transformer building blocks (port of ``repro/models/layers.py``).

Attention over a full sequence runs one of two routes, as in the reference:

* ``impl="blocked"`` — a loop over q blocks, each attending to the whole
  sequence (memory bounded by ``q_block × S`` scores per block); the
  scores and the softmax in f32, the probabilities cast to ``v``'s dtype
  before the second product;
* ``impl="flash"`` (``window == 0`` and ``S > 1``) — the online-softmax
  kernel K8 (``kernels.ops.flash_attention``), f32 inside and one rounding
  of the output.

Both routes train.  Under autograd each q block of the blocked loop is
rematerialized (``torch.utils.checkpoint``, as the reference's
``jax.checkpoint`` on its scan body), so a backward holds one block's f32
scores at a time, not ``n_blocks`` of them; K8's gradient is the
reference's recompute VJP (``kernels.ref.flash_attention_vjp``).

Decode runs against a KV cache with an explicit per-slot position array.
Unlike the reference's pure functions, ``decode_attention`` and
``prefill_into_cache`` write the cache in place (a full-width cache is
hundreds of MB; copying it per token buys nothing when serving) and return
it.  GQA never materialises repeated KV heads (grouped einsum).

Under a device mesh (``dist.use_mesh``) the tensors are DTensors and the
reference's sharding constraints (``dist.constrain``) apply at its sites;
attention runs on each rank's local shard through
``dist.shard_map_compat`` (``local_map``: the batch over (pod, data), the
kv heads over ``model`` when it divides them), K8 because a custom op is
as opaque to DTensor as ``pallas_call`` is to XLA's partitioner, the
blocked loop because its batched products over (batch, head) would
flatten two sharded dims.  A DTensor cache is written by a select over its
slots (``torch.where``) instead of ``index_copy_``, which has no sharding
rule; still in place.  With no mesh every constraint is the identity.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.dist import (_fit_spec, axis_sizes, constrain,
                              current_mesh, pspec, shard_map_compat, spec_of)
from repro_torch.kernels import ops as kops

__all__ = ["rms_norm", "rope", "attention", "decode_attention", "KVCache",
           "prefill_into_cache", "swiglu", "gelu_mlp", "init_linear",
           "init_rms"]

_NEG = -1e30


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """f32 statistics, cast to the input dtype, then times gamma."""
    x32 = x.float()
    scale = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * gamma


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding, split-half convention.  x: [..., S, H, D];
    positions broadcast against [..., S].  Computed in f32, rounded once."""
    d = x.shape[-1]
    half = d // 2
    # log(theta) in f32, as the reference's jnp.log of a weak float; built
    # on x's device (no host-to-device copy per layer and token)
    log_theta = float(np.log(np.float32(theta)))
    freqs = torch.exp(-log_theta * torch.arange(half, dtype=torch.float32,
                                                device=x.device) / half)
    ang = positions.to(device=x.device, dtype=torch.float32)[..., None] \
        * freqs                                             # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                      # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ------------------------------------------------------------------ attention


def _scale(dh: int) -> float:
    # 1 / sqrt(dh) in f32, as the reference's jnp.sqrt of a weak int
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


def _block_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, kv_pos: torch.Tensor,
                  window: int) -> torch.Tensor:
    """Grouped-query attention over one q block and its KV view.

    q: [B, Sq, Hkv, G, D]; k/v: [B, Skv, Hkv, D];
    q_pos: [Sq]; kv_pos: [Skv] (slot positions, -1 = empty slot).
    """
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())
    scores = scores * _scale(q.shape[-1])
    mask = kv_pos[None, :] <= q_pos[:, None]            # causal
    mask &= kv_pos[None, :] >= 0                        # slot written
    if window > 0:
        mask &= (q_pos[:, None] - kv_pos[None, :]) < window
    # in place on the scaled product's output, which autograd does not
    # save (the product saves only its scalar); softmax saves its result
    p = torch.softmax(scores.masked_fill_(~mask, _NEG), dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype), v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: int = 0, q_block: int = 512, pos0: int = 0,
              impl: str = "blocked") -> torch.Tensor:
    """Causal (optionally sliding-window) attention over a full sequence.

    q: [B, S, Hq, D]; k/v: [B, S, Hkv, D] -> [B, S, Hq, D].
    ``impl="flash"`` with ``window == 0`` and ``S > 1`` launches K8 on a
    card (its plain version on the host); otherwise the blocked loop, each
    block recomputed in the backward when autograd records.
    """
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    mesh = current_mesh()
    if mesh is not None and mesh.size() > 1 and isinstance(q, DTensor):
        # per (batch row, kv head): each rank attends on its shard, the
        # batch over (pod, data) and the kv heads over model when it divides
        # them (the reference's K8 specs; its blocked route is partitioned
        # by XLA)
        h_ax = ("model" if hkv % axis_sizes(mesh).get("model", 1) == 0
                else None)
        qs = _fit_spec(mesh, q.shape, pspec(("pod", "data"), None, h_ax,
                                            None))
        ks = _fit_spec(mesh, k.shape, pspec(("pod", "data"), None, h_ax,
                                            None))
        return shard_map_compat(
            lambda q_, k_, v_: _attention(q_, k_, v_, window, q_block, pos0,
                                          impl),
            mesh, in_specs=(qs, ks, ks), out_specs=qs)(q, k, v)
    return _attention(q, k, v, window, q_block, pos0, impl)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: int, q_block: int, pos0: int,
               impl: str) -> torch.Tensor:
    """``attention`` on plain tensors (one rank's shard under a mesh)."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, dh)
    if impl == "flash" and window == 0 and s > 1:
        out = kops.flash_attention(qg, k, v, min(q_block, s), pos0)
        return out.reshape(b, s, hq, dh)
    qb = min(q_block, s)
    if s % qb:
        raise ValueError(f"sequence {s} is not a multiple of q_block {qb}")
    kv_len = window + qb if 0 < window and window + qb < s else s
    outs = []
    for start in range(0, s, qb):
        qi = qg[:, start:start + qb]
        q_pos = pos0 + start + torch.arange(qb, device=q.device)
        if kv_len == s:
            ki, vi = k, v
            kv_pos = pos0 + torch.arange(s, device=q.device)
        else:
            lo = min(max(start + qb - kv_len, 0), s - kv_len)
            ki, vi = k[:, lo:lo + kv_len], v[:, lo:lo + kv_len]
            kv_pos = pos0 + lo + torch.arange(kv_len, device=q.device)
        if torch.is_grad_enabled():
            outs.append(checkpoint(_block_attend, qi, ki, vi, q_pos, kv_pos,
                                   window, use_reentrant=False,
                                   preserve_rng_state=False))
        else:
            outs.append(_block_attend(qi, ki, vi, q_pos, kv_pos, window))
    return torch.cat(outs, dim=1).reshape(b, s, hq, dh)


# ------------------------------------------------------------------ KV cache


@dataclasses.dataclass
class KVCache:
    """Linear or ring-buffer KV cache with explicit slot positions, for one
    layer or stacked over layers (a leading ``prefix`` on every field)."""
    k: torch.Tensor          # [*prefix, B, C, Hkv, D]
    v: torch.Tensor          # [*prefix, B, C, Hkv, D]
    slot_pos: torch.Tensor   # [*prefix, C] int32, -1 = empty
    pos: torch.Tensor        # [*prefix] int32: number of tokens seen

    @classmethod
    def init(cls, batch: int, capacity: int, n_kv: int, head_dim: int,
             dtype=torch.bfloat16, prefix: Tuple[int, ...] = (),
             device=None) -> "KVCache":
        shape = (*prefix, batch, capacity, n_kv, head_dim)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   slot_pos=torch.full((*prefix, capacity), -1,
                                       dtype=torch.int32, device=device),
                   pos=torch.zeros(prefix, dtype=torch.int32, device=device))

    @property
    def capacity(self) -> int:
        return self.k.shape[-3]

    def layer(self, i: int) -> "KVCache":
        """Layer ``i`` of a stacked cache, as views: writing it writes the
        stack."""
        return KVCache(k=self.k[i], v=self.v[i], slot_pos=self.slot_pos[i],
                       pos=self.pos[i])


def decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, cache: KVCache, *,
                     window: int = 0) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode: write (k_new, v_new) into the cache slot
    ``pos % capacity`` (a ring-buffer write when the cache is smaller than
    the stream), attend over it, advance ``pos``.  In place.

    q: [B, 1, Hq, D]; k_new/v_new: [B, 1, Hkv, D].
    """
    b, _, hq, dh = q.shape
    hkv = k_new.shape[2]
    # the slot is computed on the device: no host sync per layer and token
    write = (cache.pos % cache.capacity).reshape(1).long()
    if isinstance(cache.k, DTensor):
        at = torch.arange(cache.capacity, device=cache.k.device) == write
        cache.k.copy_(torch.where(at[:, None, None],
                                  k_new.to(cache.k.dtype), cache.k))
        cache.v.copy_(torch.where(at[:, None, None],
                                  v_new.to(cache.v.dtype), cache.v))
        cache.slot_pos.copy_(torch.where(at, cache.pos, cache.slot_pos))
    else:
        cache.k.index_copy_(1, write, k_new.to(cache.k.dtype))
        cache.v.index_copy_(1, write, v_new.to(cache.v.dtype))
        cache.slot_pos.index_copy_(0, write, cache.pos.reshape(1))
    qg = q.reshape(b, 1, hkv, hq // hkv, dh)
    q_pos = cache.pos.reshape(1)
    attend = functools.partial(_block_attend, window=window)
    if isinstance(cache.k, DTensor) and spec_of(cache.k)[1] is None:
        # the cache's length unsplit: each rank attends on its rows and
        # heads as the cache lays them out (a product over two sharded
        # batch dims has no DTensor rule); a split length stays DTensor's
        kspec = spec_of(cache.k)
        qspec = (kspec[0], None, kspec[2], None, None)
        attend = shard_map_compat(attend, cache.k.device_mesh,
                                  in_specs=(qspec, kspec, kspec, (None,),
                                            (None,)), out_specs=qspec)
    out = attend(qg, cache.k, cache.v, q_pos, cache.slot_pos)
    cache.pos += 1
    return out.reshape(b, 1, hq, dh), cache


def prefill_into_cache(k: torch.Tensor, v: torch.Tensor,
                       cache: KVCache) -> KVCache:
    """Write a full prefill's K/V into a fresh cache (capacity >= S), in
    place.  k/v: [*prefix, B, S, Hkv, D] for a cache of the same prefix
    (one layer, or every layer of a stacked cache at once)."""
    s = k.shape[-3]
    if s > cache.capacity:
        raise ValueError(f"prefill of {s} tokens exceeds the cache's "
                         f"capacity {cache.capacity}")
    cache.k[..., :s, :, :] = k.to(cache.k.dtype)
    cache.v[..., :s, :, :] = v.to(cache.v.dtype)
    cache.slot_pos[..., :s] = torch.arange(s, dtype=torch.int32,
                                           device=cache.slot_pos.device)
    cache.pos.fill_(s)
    return cache


# ----------------------------------------------------------------------- MLP


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w1) * (x @ w3)
    return constrain(h, ("pod", "data"), None, "model") @ w2


def gelu_mlp(x: torch.Tensor, w1: torch.Tensor,
             w2: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ w1, approximate="tanh")
    return constrain(h, ("pod", "data"), None, "model") @ w2


# ---------------------------------------------------------------------- init


def init_linear(generator: torch.Generator, fan_in: int, fan_out: int,
                dtype=torch.float32, std: Optional[float] = None,
                device=None) -> torch.Tensor:
    """N(0, std²) weights ``[fan_in, fan_out]`` (std defaults to
    fan_in^-1/2), drawn in f32 on the generator's device, then cast."""
    std = std if std is not None else fan_in ** -0.5
    w = torch.randn((fan_in, fan_out), generator=generator,
                    dtype=torch.float32, device=generator.device) * std
    return w.to(device=device or generator.device, dtype=dtype)


def init_rms(dim: int, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.ones((dim,), dtype=dtype, device=device)
