"""RWKV-6 "Finch" block (port of ``repro/models/rwkv.py``): attention-free
token mixing with a data-dependent per-channel decay.

Time-mix (WKV6), per head of size K = V:
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t · (S_{t-1} + diag(u) k_t^T v_t)
with w_t in (0, 1) from a low-rank projection of the token stream, and the
token-shift interpolation on every projection input.  Channel-mix is the
squared-ReLU gated FFN.

A whole sequence runs the chunked WKV (``_wkv_chunked``, the reference's
GLA-style block decomposition: a loop over ``T / chunk`` chunks, each
chunk's body recomputed in the backward when autograd records, as the
reference's ``jax.checkpoint``); a ragged length (``T % chunk != 0``) and
one-token decode run the sequential ``_wkv_scan``.  These are torch ops:
the reference's blocks are jnp, not Pallas kernels.

Numerics kept from the reference: the lerps, the gate and the projections
in the activation dtype; the decay path, ``u`` and the WKV state in f32;
``_group_norm``'s population variance; ``_wkv_chunked``'s ``exp(-L)``
unguarded.  Unlike the reference's pure ``rwkv_step``, the port's writes
the cache in place (as ``layers.decode_attention`` does) and returns it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..dist import (_fit_spec, axis_sizes, constrain, current_mesh, pspec,
                    shard_map_compat)
from .layers import rms_norm

__all__ = ["init_rwkv_params", "rwkv_forward", "rwkv_step", "RWKVCache",
           "init_rwkv_cache", "rwkv_time_mix", "rwkv_channel_mix"]

Params = Mapping[str, torch.Tensor]

_LORA = 64  # low-rank width of the decay projection


def init_rwkv_params(generator: torch.Generator, d_model: int, d_ff: int,
                     head_dim: int = 64, dtype=torch.float32,
                     device=None) -> Dict[str, torch.Tensor]:
    """The reference's leaves and distributions, drawn in f32 on the
    generator's device: ``w0`` and ``u`` stay f32, the rest is cast to
    ``dtype``; all placed on ``device``."""
    gdev = generator.device
    n_heads = d_model // head_dim

    def put(t: torch.Tensor, dt=dtype) -> torch.Tensor:
        return t.to(device=device or gdev, dtype=dt)

    def lin(din: int, dout: int, scale=None) -> torch.Tensor:
        w = torch.randn((din, dout), generator=generator, device=gdev)
        return put(w * (scale if scale is not None else din ** -0.5))

    def uniform(*shape) -> torch.Tensor:
        return put(torch.rand(shape, generator=generator, device=gdev))

    return {
        # time-mix
        "mix": uniform(5, d_model),          # lerp weights r, k, v, w, g
        "w_r": lin(d_model, d_model),
        "w_k": lin(d_model, d_model),
        "w_v": lin(d_model, d_model),
        "w_g": lin(d_model, d_model),
        "w0": put(torch.full((d_model,), -4.0), torch.float32),
        "w_lora_a": lin(d_model, _LORA, 0.01),
        "w_lora_b": lin(_LORA, d_model, 0.01),
        "u": put(torch.randn((n_heads, head_dim), generator=generator,
                             device=gdev) * 0.1, torch.float32),
        "ln_g": put(torch.ones((d_model,))),
        "w_o": lin(d_model, d_model),
        # channel-mix
        "mix_c": uniform(2, d_model),
        "c_k": lin(d_model, d_ff),
        "c_v": lin(d_ff, d_model),
        "c_r": lin(d_model, d_model),
    }


def _hidden_rows(h: torch.Tensor) -> torch.Tensor:
    """A [B, T, F] input of a product with its rows over (pod, data) only
    and F over model, as the reference constrains an MLP's hidden: under a
    mesh DTensor may have split the rows over model too (a strided shard
    no product rule takes).  The identity without a mesh."""
    return constrain(h, ("pod", "data"), None, "model")


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """[B, S, D] -> the previous-token tensor; x_prev is the t = -1 row."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _wkv_inputs(params: Params, x: torch.Tensor, xp: torch.Tensor,
                head_dim: int):
    """The projections shared by both WKV routes.  x, xp: [B, T, D]."""
    b, t, d = x.shape
    h = d // head_dim
    mix = params["mix"].to(x.dtype)

    def lerp(i: int) -> torch.Tensor:
        return x + (xp - x) * mix[i]

    def proj(i: int, name: str) -> torch.Tensor:
        return lerp(i) @ params[name].to(x.dtype)

    r = proj(0, "w_r").reshape(b, t, h, head_dim)
    k = proj(1, "w_k").reshape(b, t, h, head_dim)
    v = proj(2, "w_v").reshape(b, t, h, head_dim)
    g = F.silu(proj(4, "w_g"))
    # the data-dependent decay (low rank), in f32
    # both low-rank products' outputs laid out as rows x features, so the
    # sum with w0 (features over model) adds no partial sums
    w = params["w0"] + _hidden_rows(_hidden_rows(torch.tanh(
        lerp(3).float() @ params["w_lora_a"].float()))
        @ params["w_lora_b"].float())
    w = torch.exp(-torch.exp(w)).reshape(b, t, h, head_dim)  # in (0, 1)
    return r, k, v, g, w


def _wkv_scan(r, k, v, w, u, s0):
    """Sequential WKV (the decode route and the ragged fallback).

    r, k, v, w: [B, T, H, K]; u: [H, K]; s0: [B, H, K, V] f32
    -> y [B, T, H, V] f32, s_T.
    """
    r, k, v, w = (t.float() for t in (r, k, v, w))
    s = s0
    ys = []
    for i in range(r.shape[1]):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]          # [B,H,K,V]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, i],
                               s + u[None, :, :, None] * kv))
        s = w[:, i, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def _wkv_chunk(s, rt, kt, vt, wt, u):
    """One chunk of ``_wkv_chunked`` (log-space cumulative decay
    L_t = sum_{i<=t} log w_i):
      y_t = (r_t * e^{L_{t-1}}) · S_0
          + sum_{i<t} (r_t * e^{L_{t-1}-L_i}) · k_i v_i
          + (r_t · (u * k_t)) v_t
      S' = e^{L_Q} * S_0 + sum_i (k_i * e^{L_Q-L_i}) v_i^T
    rt, kt, vt, wt: [B, Q, H, K] f32."""
    q = rt.shape[1]
    logw = torch.log(torch.clamp(wt, min=1e-38))
    L = torch.cumsum(logw, dim=1)
    q_dec = rt * torch.exp(L - logw)                  # r_t * e^{L_{t-1}}
    k_dec = kt * torch.exp(-L)                        # k_i * e^{-L_i}
    # intra-chunk scores (strictly lower triangular) + the bonus diagonal
    scores = torch.einsum("bqhk,bihk->bhqi", q_dec, k_dec)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                device=rt.device), diagonal=-1)
    scores = torch.where(tri, scores, 0.0)
    diag = (rt * u * kt).sum(-1)                      # [B, Q, H]
    y = (torch.einsum("bhqi,bihv->bqhv", scores, vt)
         + diag[..., None] * vt
         + torch.einsum("bqhk,bhkv->bqhv", q_dec, s))
    # the chunk-final state
    k_tail = kt * torch.exp(L[:, -1:] - L)
    s = (torch.exp(L[:, -1])[..., None] * s
         + torch.einsum("bihk,bihv->bhkv", k_tail, vt))
    return s, y


def _wkv_chunked(r, k, v, w, u, s0, chunk: int = 128):
    """Chunked WKV, the sequence route: equal to ``_wkv_scan`` up to f32
    rounding, over ``T / chunk`` chunks instead of T steps; under autograd
    each chunk is recomputed in the backward, so it stores ``T / chunk``
    states.  A length that is not a multiple of ``min(chunk, T)`` falls
    back to the scan, as in the reference."""
    b, t, h, dk = r.shape
    q = min(chunk, t)
    if t % q:
        return _wkv_scan(r, k, v, w, u, s0)      # ragged fallback
    nc = t // q
    rc, kc, vc, wc = (x.reshape(b, nc, q, h, dk).float()
                      for x in (r, k, v, w))
    remat = torch.is_grad_enabled()
    s = s0
    ys = []
    for c in range(nc):
        args = (s, rc[:, c], kc[:, c], vc[:, c], wc[:, c], u)
        if remat:
            s, y = checkpoint(_wkv_chunk, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            s, y = _wkv_chunk(*args)
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(b, t, h, dk), s


def _group_norm(y: torch.Tensor, gamma: torch.Tensor,
                head_dim: int) -> torch.Tensor:
    """Per-head LayerNorm on [B, T, H, V] (population variance, as
    ``jnp.var``), flattened back to [B, T, D] and scaled by f32 gamma."""
    mu = y.mean(-1, keepdim=True)
    var = torch.square(y - mu).mean(-1, keepdim=True)
    yn = (y - mu) * torch.rsqrt(var + 1e-5)
    b, t, h, v = y.shape
    return yn.reshape(b, t, h * v) * gamma.float()


def rwkv_time_mix(params: Params, x: torch.Tensor, x_prev: torch.Tensor,
                  s0: torch.Tensor, head_dim: int = 64, chunk: int = 128
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B, S, D]; returns (out, last x, s_T)."""
    xp = _token_shift(x, x_prev)
    r, k, v, g, w = _wkv_inputs(params, x, xp, head_dim)
    wkv = (functools.partial(_wkv_chunked, chunk=chunk) if x.shape[1] > 1
           else _wkv_scan)
    mesh = current_mesh()
    if mesh is not None and mesh.size() > 1 and isinstance(r, DTensor):
        # per (batch row, head): each rank runs the recurrence on its own
        # rows and heads
        h = r.shape[2]
        h_ax = "model" if h % axis_sizes(mesh).get("model", 1) == 0 \
            else None
        rs = _fit_spec(mesh, r.shape, pspec(("pod", "data"), None, h_ax,
                                            None))
        ss = (rs[0], rs[2], None, None)
        wkv = shard_map_compat(wkv, mesh,
                               in_specs=(rs, rs, rs, rs, (rs[2], None), ss),
                               out_specs=[rs, ss])
    y, s_t = wkv(r, k, v, w, params["u"], s0)
    y = _group_norm(y, params["ln_g"], head_dim).to(x.dtype)
    out = _hidden_rows(y * g) @ params["w_o"].to(x.dtype)
    return out, x[:, -1], s_t


def rwkv_channel_mix(params: Params, x: torch.Tensor, x_prev: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    xp = _token_shift(x, x_prev)
    mix = params["mix_c"].to(x.dtype)
    xk = x + (xp - x) * mix[0]
    xr = x + (xp - x) * mix[1]
    kk = _hidden_rows(torch.square(F.relu(xk @ params["c_k"].to(x.dtype))))
    out = torch.sigmoid(xr @ params["c_r"].to(x.dtype)) \
        * (kk @ params["c_v"].to(x.dtype))
    return out, x[:, -1]


@dataclasses.dataclass
class RWKVCache:
    """The decode state of one layer, or stacked over layers (a leading
    ``prefix`` on every field)."""
    tm_x: torch.Tensor   # [*prefix, B, D] the last token time-mix saw
    cm_x: torch.Tensor   # [*prefix, B, D] the last token channel-mix saw
    s: torch.Tensor      # [*prefix, B, H, K, V] the WKV state (f32)

    def layer(self, i: int) -> "RWKVCache":
        """Layer ``i`` of a stacked cache, as views."""
        return RWKVCache(tm_x=self.tm_x[i], cm_x=self.cm_x[i], s=self.s[i])


def init_rwkv_cache(batch: int, d_model: int, head_dim: int = 64,
                    dtype=torch.bfloat16, device=None,
                    prefix: Tuple[int, ...] = ()) -> RWKVCache:
    h = d_model // head_dim
    return RWKVCache(
        tm_x=torch.zeros((*prefix, batch, d_model), dtype=dtype,
                         device=device),
        cm_x=torch.zeros((*prefix, batch, d_model), dtype=dtype,
                         device=device),
        s=torch.zeros((*prefix, batch, h, head_dim, head_dim),
                      dtype=torch.float32, device=device))


def rwkv_forward(params: Params, x: torch.Tensor, ln1: torch.Tensor,
                 ln2: torch.Tensor, head_dim: int = 64) -> torch.Tensor:
    """The full RWKV block over a sequence (time-mix and channel-mix,
    pre-RMSNorm residuals), from a zero state."""
    b, _, d = x.shape
    h = d // head_dim
    s0 = torch.zeros((b, h, head_dim, head_dim), dtype=torch.float32,
                     device=x.device)
    zero = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    tm, _, _ = rwkv_time_mix(params, rms_norm(x, ln1), zero, s0, head_dim)
    x = x + tm
    cm, _ = rwkv_channel_mix(params, rms_norm(x, ln2), zero)
    return x + cm


def rwkv_step(params: Params, cache: RWKVCache, x: torch.Tensor,
              ln1: torch.Tensor, ln2: torch.Tensor, head_dim: int = 64
              ) -> Tuple[torch.Tensor, RWKVCache]:
    """One-token step.  x: [B, 1, D].  Writes ``cache`` in place."""
    xn = rms_norm(x, ln1)
    tm, tm_x, s_t = rwkv_time_mix(params, xn, cache.tm_x.to(x.dtype),
                                  cache.s, head_dim)
    x = x + tm
    xn = rms_norm(x, ln2)
    cm, cm_x = rwkv_channel_mix(params, xn, cache.cm_x.to(x.dtype))
    cache.tm_x.copy_(tm_x)
    cache.cm_x.copy_(cm_x)
    cache.s.copy_(s_t)
    return x + cm, cache
