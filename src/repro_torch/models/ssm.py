"""Mamba-2 (SSD) block, the state-space half of Zamba2 (port of
``repro/models/ssm.py``).

Scalar-per-head decay ``a_t = exp(-exp(A_log) · dt_t)``; state update
``h_t = a_t h_{t-1} + (dt_t B_t) x_t``; output ``y_t = C_t · h_t + D x_t``.

A sequence runs the chunked SSD decomposition (chunk length Q): an
intra-chunk attention-like term plus the inter-chunk state carried by a
loop over chunks, each chunk's body recomputed in the backward when
autograd records (the reference's ``jax.checkpoint``).  ``mamba_step`` is
the O(1) recurrent form for decode.  These are torch ops: the reference's
block is jnp, not a Pallas kernel.

Numerics kept from the reference: ``softplus`` as ``logaddexp(x, 0)``
(``F.softplus`` switches to ``x`` above 20); the sequence route's causal
conv as four shifted products summed in the activation dtype in the
reference's order, and the step's as a ``.sum(-1)`` over the window; the
SSD's ``l_q - l_t`` masked to ``-inf`` before ``exp`` (after it, the
backward meets ``inf * 0``).  Unlike the reference's pure ``mamba_step``,
the port's writes the cache in place and returns it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..dist import _fit_spec, axis_sizes, current_mesh, pspec, shard_map_compat
from .layers import rms_norm

__all__ = ["init_mamba_params", "mamba_forward", "mamba_step", "MambaCache",
           "init_mamba_cache"]

Params = Mapping[str, torch.Tensor]

_CONV_K = 4  # depthwise causal conv width


def init_mamba_params(generator: torch.Generator, d_model: int,
                      d_state: int, head_dim: int = 64, expand: int = 2,
                      dtype=torch.float32,
                      device=None) -> Dict[str, torch.Tensor]:
    """The reference's leaves and distributions, drawn in f32 on the
    generator's device: ``A_log``, ``D`` and ``dt_bias`` stay f32, the rest
    is cast to ``dtype``; all placed on ``device``."""
    gdev = generator.device
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * d_state
    proj_out = 2 * d_inner + 2 * d_state + n_heads   # z, x, B, C, dt

    def put(t: torch.Tensor, dt=dtype) -> torch.Tensor:
        return t.to(device=device or gdev, dtype=dt)

    def normal(shape, std: float) -> torch.Tensor:
        return put(torch.randn(shape, generator=generator, device=gdev)
                   * std)

    return {
        "in_proj": normal((d_model, proj_out), d_model ** -0.5),
        "conv_w": normal((conv_dim, _CONV_K), 0.2),
        "conv_b": put(torch.zeros((conv_dim,))),
        "A_log": put(torch.log(torch.linspace(1.0, 16.0, n_heads)),
                     torch.float32),
        "D": put(torch.ones((n_heads,)), torch.float32),
        "dt_bias": put(torch.zeros((n_heads,)), torch.float32),
        "norm": put(torch.ones((d_inner,))),
        "out_proj": normal((d_inner, d_model), d_inner ** -0.5),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(-|x|))."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width 4, by shifted adds.  x: [B, S, C]."""
    s = x.shape[1]
    out = x * w[:, -1]
    for i in range(1, _CONV_K):
        shifted = F.pad(x, (0, 0, i, 0))[:, :s]
        out = out + shifted * w[:, -1 - i]
    return out + b


def _split_proj(zxbcdt: torch.Tensor, d_inner: int, d_state: int,
                n_heads: int):
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + d_inner + 2 * d_state]
    dt = zxbcdt[..., -n_heads:]
    return z, xbc, dt


def _ssd_chunk(h_in, xck, bck, cck, dtk, alk):
    """One chunk of the SSD: xck [B, Q, H, P], bck / cck [B, Q, N], dtk /
    alk [B, Q, H] (f32); h_in [B, H, P, N] f32 -> (h_out, y [B, Q, H, P])."""
    q = xck.shape[1]
    l = torch.cumsum(alk, dim=1)                           # cumulative log a
    # intra-chunk: scores[q, t] = C_q·B_t · exp(l_q - l_t) · dt_t, t <= q
    c32, b32, xs_f = cck.float(), bck.float(), xck.float()
    cb = torch.einsum("bqn,btn->bqt", c32, b32)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=xck.device))[None, :, :, None]
    # mask BEFORE exp: the upper triangle would overflow (l decreasing)
    ldiff = torch.where(causal, l[:, :, None] - l[:, None, :], -torch.inf)
    decay = torch.exp(ldiff)                               # [B, Q, Q, H]
    scores = cb[..., None] * decay * dtk[:, None, :, :]
    y_intra = torch.einsum("bqth,bthp->bqhp", scores, xs_f)
    # inter-chunk: y += C_t · exp(l_t) h_in
    y_inter = torch.einsum("bqn,bhpn->bqhp", c32, h_in) \
        * torch.exp(l)[..., None]
    # the next chunk's incoming state
    tail = torch.exp(l[:, -1:, :] - l)                     # [B, Q, H]
    s_chunk = torch.einsum("btn,bthp->bhpn", b32,
                           (tail * dtk)[..., None] * xs_f)
    h_out = torch.exp(l[:, -1])[:, :, None, None] * h_in + s_chunk
    return h_out, y_intra + y_inter


def _ssd(xs: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
         dt: torch.Tensor, a_log: torch.Tensor, chunk: int) -> torch.Tensor:
    """The chunked SSD from a zero state: xs [B, S, H, P], bm / cm [B, S,
    N], dt / a_log [B, S, H] (f32) -> y [B, S, H, P] f32.  Under autograd
    each chunk is recomputed in the backward."""
    b, s, n_heads, head_dim = xs.shape
    d_state = bm.shape[-1]
    q = min(chunk, s)
    assert s % q == 0, (s, q)
    nc = s // q

    def rs(t: torch.Tensor) -> torch.Tensor:   # [B, S, ...] -> [B, nc, Q, ...]
        return t.reshape(b, nc, q, *t.shape[2:])

    xs_c, b_c, c_c, dt_c, al_c = (rs(t) for t in (xs, bm, cm, dt, a_log))
    remat = torch.is_grad_enabled()
    h = torch.zeros((b, n_heads, head_dim, d_state), dtype=torch.float32,
                    device=xs.device)
    ys = []
    for c in range(nc):
        args = (h, xs_c[:, c], b_c[:, c], c_c[:, c], dt_c[:, c], al_c[:, c])
        if remat:
            h, y = checkpoint(_ssd_chunk, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            h, y = _ssd_chunk(*args)
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(b, s, n_heads, head_dim)


def mamba_forward(params: Params, x: torch.Tensor, *, d_state: int,
                  head_dim: int = 64, chunk: int = 128) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D] (the training / prefill route, chunked
    SSD from a zero state)."""
    b, s, _ = x.shape
    d_inner = params["out_proj"].shape[0]
    n_heads = d_inner // head_dim

    zxbcdt = x @ params["in_proj"].to(x.dtype)
    z, xbc, dt = _split_proj(zxbcdt, d_inner, d_state, n_heads)
    xbc = F.silu(_causal_conv(xbc, params["conv_w"].to(x.dtype),
                              params["conv_b"].to(x.dtype)))
    xs = xbc[..., :d_inner].reshape(b, s, n_heads, head_dim)
    bm = xbc[..., d_inner:d_inner + d_state]                 # [B, S, N]
    cm = xbc[..., d_inner + d_state:]                        # [B, S, N]

    dt = _softplus(dt.float() + params["dt_bias"])           # [B, S, H]
    a_log = -torch.exp(params["A_log"]) * dt                 # log a_t <= 0

    ssd = functools.partial(_ssd, chunk=chunk)
    mesh = current_mesh()
    if mesh is not None and mesh.size() > 1 and isinstance(xs, DTensor):
        # per (batch row, head): each rank scans its own rows and heads;
        # B and C are shared by the heads
        h_ax = "model" if n_heads % axis_sizes(mesh).get("model", 1) == 0 \
            else None
        xsp = _fit_spec(mesh, xs.shape, pspec(("pod", "data"), None, h_ax,
                                              None))
        bsp = (xsp[0], None, None)
        hsp = (xsp[0], None, xsp[2])
        ssd = shard_map_compat(ssd, mesh,
                               in_specs=(xsp, bsp, bsp, hsp, hsp),
                               out_specs=xsp)
    y = ssd(xs, bm, cm, dt, a_log)
    y = y + params["D"][:, None] * xs.float()
    y = y.reshape(b, s, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"])
    return y @ params["out_proj"].to(x.dtype)


@dataclasses.dataclass
class MambaCache:
    """The decode state of one layer, or stacked (a leading ``prefix`` on
    every field)."""
    conv: torch.Tensor   # [*prefix, B, conv_dim, K-1] the last inputs
    h: torch.Tensor      # [*prefix, B, H, P, N] the SSM state (f32)

    def layer(self, *idx: int) -> "MambaCache":
        """The layer at ``idx`` of a stacked cache, as views."""
        return MambaCache(conv=self.conv[idx], h=self.h[idx])


def init_mamba_cache(batch: int, d_model: int, d_state: int,
                     head_dim: int = 64, expand: int = 2,
                     dtype=torch.bfloat16, device=None,
                     prefix: Tuple[int, ...] = ()) -> MambaCache:
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * d_state
    return MambaCache(
        conv=torch.zeros((*prefix, batch, conv_dim, _CONV_K - 1),
                         dtype=dtype, device=device),
        h=torch.zeros((*prefix, batch, n_heads, head_dim, d_state),
                      dtype=torch.float32, device=device))


def mamba_step(params: Params, cache: MambaCache, x: torch.Tensor, *,
               d_state: int, head_dim: int = 64
               ) -> Tuple[torch.Tensor, MambaCache]:
    """One-token recurrent step.  x: [B, 1, D].  Writes ``cache`` in
    place."""
    b = x.shape[0]
    d_inner = params["out_proj"].shape[0]
    n_heads = d_inner // head_dim

    zxbcdt = x[:, 0] @ params["in_proj"].to(x.dtype)
    z, xbc, dt = _split_proj(zxbcdt, d_inner, d_state, n_heads)
    # the conv over (the cached K-1 inputs, the current one)
    window = torch.cat([cache.conv.to(x.dtype), xbc[:, :, None]],
                       dim=-1)                                # [B, C, K]
    conv_out = (window * params["conv_w"].to(x.dtype)).sum(-1)
    xbc = F.silu(conv_out + params["conv_b"].to(x.dtype))
    xs = xbc[..., :d_inner].reshape(b, n_heads, head_dim)
    bm = xbc[..., d_inner:d_inner + d_state].float()
    cm = xbc[..., d_inner + d_state:].float()

    dt = _softplus(dt.float() + params["dt_bias"])            # [B, H]
    a = torch.exp(-torch.exp(params["A_log"]) * dt)
    xs_f = xs.float()
    h = (a[:, :, None, None] * cache.h
         + (dt[:, :, None] * xs_f)[..., None] * bm[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", h, cm)
    y = y + params["D"][:, None] * xs_f
    y = y.reshape(b, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"])
    out = (y @ params["out_proj"].to(x.dtype))[:, None]
    cache.conv.copy_(window[:, :, 1:])
    cache.h.copy_(h)
    return out, cache
