"""Plain PyTorch versions of the port's kernels.

Port of ``repro/kernels/ref.py``.  These are the functions the Hopper
kernels in ``csrc/`` compute, written as ordinary torch ops: the wrappers in
``ops.py`` run them for tensors on the CPU, and the card's tests and
``chip_smoke.py`` hold each kernel against them on the same inputs.

* ``assemble_features`` — the cache combine (Feature Duplicator):
  ``out[i] = cache[slots[i]]`` if ``slots[i] >= 0`` else
  ``miss[miss_index[i]]``; a pure data movement, so kernel and plain
  version agree bit for bit.  K1 and its multi-buffered twin K4 both
  compute it, and so does the peer gather (``ops.gather_rows``).
* ``cache_combine_legacy`` — the legacy combine (K7): ``out[i] =
  cache[row[i]]`` if ``sel[i] == 0`` else ``miss[row[i]]``; bitwise.
* ``cache_update`` — the refresh scatter: ``out = cache;
  out[slots[i]] = rows[i]``, updates applied in index order so an aliased
  slot keeps its last writer; bitwise, like the combine.
* ``segment_weighted_sum_regular`` — the regular-layout aggregation: each
  destination owns ``fanout`` contiguous edge slots, weighted-summed in f32.
* ``fused_gnn_update`` — aggregation fused with the update:
  ``(self_scale ⊙ x_self) @ w_self + agg @ w_agg + bias`` in f32.
* ``flash_attention`` — causal grouped-query attention (K8): scores, mask,
  softmax and product in f32, one rounding to the input dtype.
* ``flash_attention_vjp`` — K8's gradient, the reference's recompute VJP
  (``repro/kernels/ops.py:414-445``): probabilities recomputed in f32 from
  q and k, then d_v, d_p, the row term, d_s, d_q and d_k in f32, each
  result rounded once.  The gradient of f32 inputs and of host tensors on
  both devices; bf16 on a card has a kernel of its own
  (``csrc/flash_attention_bwd.cu``), held against this one.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["assemble_features", "expand_rows", "cache_combine_legacy",
           "cache_update",
           "segment_weighted_sum_regular", "fused_gnn_update",
           "flash_attention", "flash_attention_vjp"]


def assemble_features(cache: Optional[torch.Tensor], miss: torch.Tensor,
                      slots: torch.Tensor,
                      miss_index: torch.Tensor) -> torch.Tensor:
    """Cache-combine: ``out[i] = cache[slots[i]]`` when ``slots[i] >= 0``
    else ``miss[miss_index[i]]``.  Many positions may share one source row.

    cache: [K, F] or None (every position is a miss); miss: [M, F] (may be
    empty when every position hits); slots/miss_index: int [N] -> [N, F].
    """
    f = miss.shape[1] if cache is None else cache.shape[1]
    dtype = miss.dtype if cache is None else cache.dtype
    if cache is None:
        cache = torch.zeros((1, f), dtype=dtype, device=miss.device)
    if miss.shape[0] == 0:
        miss = torch.zeros((1, f), dtype=dtype, device=cache.device)
    slots = slots.long()
    hit = slots >= 0
    from_cache = cache[slots.clamp_min(0)]
    from_miss = miss[miss_index.long()]
    return torch.where(hit[:, None], from_cache, from_miss)


def expand_rows(rows: torch.Tensor, inverse: torch.Tensor) -> torch.Tensor:
    """Dedup expansion: ``out[i] = rows[inverse[i]]`` (the cache-less
    combine)."""
    return rows[inverse.long()]


def cache_combine_legacy(cache: torch.Tensor, miss: torch.Tensor,
                         sel: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """Legacy combine: ``out[i] = cache[row[i]]`` when ``sel[i] == 0`` else
    ``miss[row[i]]``.  As in the reference's kernel both sources are read
    (row 0 of the source not taken) and one is selected.

    cache: [K, F], miss: [M, F] (K, M >= 1); sel/row: int [N] -> [N, F].
    """
    take_cache = sel == 0
    row = row.long()
    zero = torch.zeros_like(row)
    from_cache = cache[torch.where(take_cache, row, zero)]
    from_miss = miss[torch.where(take_cache, zero, row)]
    return torch.where(take_cache[:, None], from_cache, from_miss)


def cache_update(cache: torch.Tensor, rows: torch.Tensor,
                 slots: torch.Tensor) -> torch.Tensor:
    """Cache scatter-update: ``out = cache; out[slots[i]] = rows[i]`` with
    the updates applied in index order, so a slot named several times keeps
    its LAST writer (a plain ``out[slots] = rows`` leaves that order
    unspecified).  Functional: ``cache`` is not written.

    cache: [K, F]; rows: [M, F]; slots: int [M] -> [K, F].
    """
    out = cache.clone()
    m = int(slots.shape[0])
    if m == 0:
        return out
    slots = slots.to(cache.device).long()
    order = torch.arange(m, device=cache.device)
    last = torch.full((cache.shape[0],), -1, dtype=torch.long,
                      device=cache.device).scatter_reduce(
                          0, slots, order, "amax")
    winner = last[slots] == order
    out[slots[winner]] = rows[winner].to(cache.device, cache.dtype)
    return out


def segment_weighted_sum_regular(x_nbr: torch.Tensor, w_edge: torch.Tensor,
                                 fanout: int) -> torch.Tensor:
    """x_nbr: [D*fanout, F]; w_edge: [D*fanout] -> [D, F] (f32 accumulation,
    cast back to x_nbr's dtype)."""
    d = x_nbr.shape[0] // fanout
    xn = x_nbr.reshape(d, fanout, -1).float()
    we = w_edge.reshape(d, fanout, 1).float()
    return (xn * we).sum(dim=1).to(x_nbr.dtype)


def fused_gnn_update(x_self: torch.Tensor, x_nbr: torch.Tensor,
                     w_edge: torch.Tensor, self_scale: torch.Tensor,
                     w_self: torch.Tensor, w_agg: torch.Tensor,
                     bias: Optional[torch.Tensor],
                     fanout: int) -> torch.Tensor:
    """out = (self_scale ⊙ x_self) @ w_self + segsum(w ⊙ x_nbr) @ w_agg + b.

    x_self: [D, F]; x_nbr: [D*fanout, F]; w_edge: [D*fanout];
    self_scale: [D]; w_self/w_agg: [F, O]; bias: [O] -> [D, O].
    """
    agg = segment_weighted_sum_regular(x_nbr, w_edge, fanout).float()
    xs = x_self.float() * self_scale.float()[:, None]
    out = xs @ w_self.float() + agg @ w_agg.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x_self.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_block: int = 512, pos0: int = 0) -> torch.Tensor:
    """Causal grouped-query attention, the function K8 computes.

    q: [B, S, Hkv, G, D]; k/v: [B, S, Hkv, D] -> [B, S, Hkv, G, D] in q's
    dtype.  Scores ``q . k / sqrt(D)``, the causal mask (``kv_pos <= q_pos``,
    both offset by ``pos0``; -1e30 elsewhere), the softmax and the product
    with v all in f32, rounded once at the end.  One q block at a time, so
    the f32 scores ``[B, Hkv, G, q_block, S]`` stay bounded; a block
    attends only to the keys up to its last row (the rest are masked, and
    their exp is exactly 0).
    """
    b, s, hkv, g, d = q.shape
    qb = min(q_block, s)
    scale = 1.0 / (d ** 0.5)
    k32, v32 = k.float(), v.float()
    pos = pos0 + torch.arange(s, device=q.device)
    out = torch.empty_like(q)
    for start in range(0, s, qb):
        stop = min(start + qb, s)
        scores = torch.einsum("bqhgd,bkhd->bhgqk", q[:, start:stop].float(),
                              k32[:, :stop]) * scale
        mask = pos[None, :stop] <= pos[start:stop, None]
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
        p = torch.softmax(scores, dim=-1)
        out[:, start:stop] = torch.einsum("bhgqk,bkhd->bqhgd", p,
                                          v32[:, :stop]).to(q.dtype)
    return out


def flash_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        g: torch.Tensor, q_block: int = 512, pos0: int = 0):
    """The cotangents ``(d_q, d_k, d_v)`` of ``flash_attention`` at
    ``(q, k, v)`` for the output cotangent ``g`` (q's shape).

    The reference's ``_flash_vjp_bwd`` over the whole sequence, tiled over
    q blocks of ``q_block`` rows so that the f32 probabilities, ``d_p`` and
    ``d_s`` stay ``[B, Hkv, G, q_block, <= S]``: a block recomputes its rows'
    probabilities over the keys up to its last row (the rest are exactly 0)
    and adds its share of d_k and d_v into f32 sums.  d_q is per row, as in
    the reference; d_k and d_v sum the blocks' shares in block order, so
    they differ from the reference's one product in the order of an f32
    sum.  The softmax scale multiplies d_q per block and the d_k sum once,
    as the reference scales its products.  Reads only q, k, v and g: the
    forward's output is not needed.
    """
    b, s, hkv, gq, d = q.shape
    qb = min(q_block, s)
    scale = 1.0 / (d ** 0.5)
    k32, v32 = k.float(), v.float()
    pos = pos0 + torch.arange(s, device=q.device)
    d_q = torch.empty_like(q)
    d_k = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    d_v = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for start in range(0, s, qb):
        stop = min(start + qb, s)
        qi, gi = q[:, start:stop].float(), g[:, start:stop].float()
        ki, vi = k32[:, :stop], v32[:, :stop]
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qi, ki) * scale
        future = pos[None, :stop] > pos[start:stop, None]    # masked out
        p = torch.softmax(scores.masked_fill_(future, -1e30), dim=-1)
        del scores
        d_v[:, :stop] += torch.einsum("bhgqk,bqhgd->bkhd", p, gi)
        d_p = torch.einsum("bqhgd,bkhd->bhgqk", gi, vi)
        row = torch.sum(d_p * p, dim=-1, keepdim=True)
        d_s = p * (d_p - row)
        del p, d_p
        d_q[:, start:stop] = (torch.einsum("bhgqk,bkhd->bqhgd", d_s, ki)
                              * scale).to(q.dtype)
        d_k[:, :stop] += torch.einsum("bhgqk,bqhgd->bkhd", d_s, qi)
    return d_q, (d_k * scale).to(k.dtype), d_v.to(v.dtype)
