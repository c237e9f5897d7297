"""Plain PyTorch reference of the benchmark's LM training step.

Written from the model's equations, not from the port, and importing
nothing of it: the audio stub's frame embeddings, RMSNorm (f32
statistics), rotary embeddings (split-half), causal attention over grouped
kv heads, a tanh-GELU MLP, the final norm and head, next-token
cross-entropy, gradients, and AdamW.

``precision="f32"`` is the reference: every tensor f32 and TF32 off, so
that a product is an f32 product.  ``precision="fp8"`` is the control: the
weights and activations in bf16, as the configuration states, and every
product's operands rounded to fp8 (e4m3 forward, e5m2 for the incoming
gradient, one scale a tensor), as an fp8 training recipe computes them.

Memory: each layer is recomputed in the backward and attention runs in q
blocks of ``Q_BLOCK`` rows, each recomputed too, so a long sequence never
holds its whole f32 score matrix.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.harness.dims import Dims

Q_BLOCK = 512
_NEG = -1e30
_E4M3_MAX, _E5M2_MAX = 448.0, 57344.0


@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    """TF32 off for the block (products and convolutions), restored
    after."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
        torch.set_float32_matmul_precision(prec)


# ---------------------------------------------------------------- fp8 control


def _round_fp8(x: torch.Tensor, fmt: torch.dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    q = (x.float() * scale).clamp(-top, top).to(fmt)
    return (q.float() / scale).to(x.dtype)


class _Fp8In(torch.autograd.Function):
    """Forward operand rounded to e4m3; its gradient passes through."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Grad(torch.autograd.Function):
    """Identity forward; the incoming gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, _E5M2_MAX)


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return _Fp8Grad.apply(_Fp8In.apply(a) @ _Fp8In.apply(b))
    return a @ b


# -------------------------------------------------------------------- layers


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return y.to(x.dtype) * g


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x ``[B, S, H, D]``; position i rotates pair (j, j + D/2) by
    ``i * theta^(-j / (D/2))``."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    log_theta = float(np.log(np.float32(theta)))
    inv = torch.exp(-log_theta * torch.arange(half, dtype=torch.float32,
                                              device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _attend_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q0: int) -> torch.Tensor:
    """q ``[B, H, Sq, D]`` at positions q0.., k/v ``[B, H, Sk, D]`` at
    0..; scores and softmax in f32, probabilities in v's dtype."""
    scores = q.float() @ k.float().transpose(-1, -2)
    scores = scores * (1.0 / math.sqrt(q.shape[-1]))
    qi = q0 + torch.arange(q.shape[2], device=q.device)[:, None]
    ki = torch.arange(k.shape[2], device=q.device)[None, :]
    p = torch.softmax(scores.masked_fill(ki > qi, _NEG), dim=-1)
    return p.to(v.dtype) @ v


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """Causal attention; q ``[B, S, H, D]``, k/v ``[B, S, Hkv, D]``, query
    head h reading kv head ``h // (H / Hkv)``."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    q = q.transpose(1, 2)
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    outs = []
    for q0 in range(0, s, Q_BLOCK):
        q1 = min(q0 + Q_BLOCK, s)
        args = (q[:, :, q0:q1], k[:, :, :q1], v[:, :, :q1], q0)
        if torch.is_grad_enabled():
            outs.append(checkpoint(_attend_block, *args, use_reentrant=False))
        else:
            outs.append(_attend_block(*args))
    return torch.cat(outs, dim=2).transpose(1, 2)


def layer(x: torch.Tensor, w: Dict[str, torch.Tensor], i: int, dims: Dims,
          precision: str) -> torch.Tensor:
    p = f"layers.{i}."
    b, s, _ = x.shape
    hd = dims.head_dim
    h = rms_norm(x, w[p + "ln1"], dims.eps)
    q = _mm(h, w[p + "wq"], precision).reshape(b, s, dims.heads, hd)
    k = _mm(h, w[p + "wk"], precision).reshape(b, s, dims.kv_heads, hd)
    v = _mm(h, w[p + "wv"], precision).reshape(b, s, dims.kv_heads, hd)
    q, k = rope(q, dims.rope_theta), rope(k, dims.rope_theta)
    o = attention(q, k, v).reshape(b, s, dims.heads * hd)
    x = x + _mm(o, w[p + "wo"], precision)
    h = rms_norm(x, w[p + "ln2"], dims.eps)
    y = F.gelu(_mm(h, w[p + "w1"], precision), approximate="tanh")
    return x + _mm(y, w[p + "w2"], precision)


def loss(w: Dict[str, torch.Tensor], dims: Dims,
         batch: Dict[str, torch.Tensor], precision: str) -> torch.Tensor:
    """Mean next-token cross-entropy (f32)."""
    x = batch["embeds"].to(w["lm_head"].dtype)
    for i in range(dims.layers):
        x = checkpoint(layer, x, w, i, dims, precision, use_reentrant=False)
    x = rms_norm(x, w["final_norm"], dims.eps)
    logits = _mm(x, w["lm_head"], precision).float()[:, :-1]
    logits = logits[..., :dims.vocab]
    labels = batch["labels"].long()[:, 1:]
    return (torch.logsumexp(logits, -1)
            - torch.gather(logits, -1, labels[..., None])[..., 0]).mean()


def value_and_grad(w: Dict[str, torch.Tensor], dims: Dims,
                   chunks: List[Dict[str, torch.Tensor]], precision: str
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The mean loss over equal row chunks and its f32 gradient, one chunk
    alive at a time."""
    names = list(w)
    leaves = [w[n].detach().requires_grad_(True) for n in names]
    live = dict(zip(names, leaves))
    total, grads = 0.0, None
    for chunk in chunks:
        with torch.enable_grad():
            value = loss(live, dims, chunk, precision) / len(chunks)
            gs = torch.autograd.grad(value, leaves, allow_unused=True,
                                     materialize_grads=True)
        total += float(value.detach())
        gs = [g.float() for g in gs]
        grads = gs if grads is None else [a + g for a, g in zip(grads, gs)]
    return total, dict(zip(names, grads))


# ----------------------------------------------------------------- optimizer


def schedule(train: Dict, step: int) -> float:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine decay
    to ``min_ratio x lr`` at ``total_steps``."""
    warm = max(1.0, float(train["warmup_steps"]))
    span = max(1.0, float(train["total_steps"] - train["warmup_steps"]))
    prog = min(max((step - train["warmup_steps"]) / span, 0.0), 1.0)
    ratio = train["min_ratio"]
    cos = ratio + (1 - ratio) * 0.5 * (1 + math.cos(math.pi * prog))
    return train["lr"] * min(step / warm, cos)


class Optimizer:
    """AdamW (f32 moments, bias-corrected): updates each weight in f32 and
    stores it back in its own dtype."""

    def __init__(self, train: Dict, w: Dict[str, torch.Tensor]):
        if train["optimizer"] != "adamw":
            raise ValueError(train["optimizer"])
        self.train, self.step = train, 0
        self.m = {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in w.items()}
        self.v = {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in w.items()}

    def update(self, w: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor]) -> None:
        t = self.train
        self.step += 1
        lr = schedule(t, self.step)
        with torch.no_grad():
            b1, b2 = t["b1"], t["b2"]
            c1, c2 = 1 - b1 ** self.step, 1 - b2 ** self.step
            for k, g in grads.items():
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                u = -lr * (self.m[k] / c1) / (
                    torch.sqrt(self.v[k] / c2) + t["eps"])
                if t["weight_decay"]:
                    u = u - lr * t["weight_decay"] * w[k].float()
                w[k].copy_((w[k].float() + u).to(w[k].dtype))
