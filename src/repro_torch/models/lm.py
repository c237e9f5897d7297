"""The LM substrate (port of ``repro/models/lm.py``): one ``ModelConfig``
covers the ten architectures, and the serving path of the dense kind runs.

Ported: the config (fields, defaults, derived sizes), the parameter
counts, and for ``kind="dense"`` with full attention (``window=0``) and no
frontend stub: ``init_params``, ``forward`` (training / prefill logits
with the per-layer K/V), ``make_prefill_step``, ``init_decode_cache`` and
``make_serve_step`` (one-token decode against the stacked cache).  Every
other kind, window or frontend raises ``NotImplementedError`` naming its
ROADMAP item; training (``loss_fn``, ``make_train_step``) is the next LM
slice.

Parameters live in an ``nn.Module`` whose names are the reference's
(``embed``, ``final_norm``, ``lm_head``, and per layer ``ln1``, ``wq``,
``wk``, ``wv``, ``wo``, ``ln2``, ``w1``, ``w3``, ``w2``), with weights
``[in, out]`` so products stay ``x @ W``.  The reference stacks layers on
a leading axis and scans; here ``layers`` is a ``ModuleList`` and a loop
(``convert.py`` maps between the two).  Everything runs under
``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
from torch import nn

from .layers import (KVCache, attention, decode_attention, gelu_mlp,
                     init_linear, init_rms, rms_norm, rope, swiglu)

__all__ = ["ModelConfig", "LM", "init_params", "forward",
           "make_prefill_step", "make_serve_step", "init_decode_cache",
           "param_count", "active_param_count", "model_flops_per_token"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    kind: str                   # 'dense' | 'moe' | 'rwkv' | 'zamba'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0
    moe_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    window: int = 0             # sliding-window size (0 = full attention)
    ssm_state: int = 64
    ssm_head_dim: int = 64
    mamba_per_attn: int = 6     # zamba: mamba layers per shared-attn site
    mlp: str = "swiglu"         # 'swiglu' | 'gelu'
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    frontend: str = "none"      # 'none' | 'audio_stub' | 'vision_stub'
    vision_tokens: int = 256    # prefix length for the vision stub
    remat: bool = True
    q_block: int = 512
    attn_impl: str = "blocked"   # 'blocked' | 'flash' (K8)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab // 128) * 128

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k? (SSM/hybrid/linear-attn or SWA)."""
        return self.kind in ("rwkv", "zamba") or self.window > 0

    def zamba_structure(self) -> Tuple[int, int, int]:
        """(n_sites, mamba_per_site, n_tail) with all layers Mamba except
        the shared attention applied after every ``mamba_per_attn``."""
        per = self.mamba_per_attn
        sites = self.n_layers // per
        tail = self.n_layers - sites * per
        return sites, per, tail


def param_count(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def model_flops_per_token(cfg: ModelConfig) -> float:
    """6·N_active per token (the §Roofline MODEL_FLOPS convention)."""
    return 6.0 * active_param_count(cfg)


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE counts top_k experts only)."""
    d, hd = cfg.d_model, cfg.hd
    attn = d * hd * (cfg.n_heads * 2 + cfg.n_kv * 2)
    ffn = 3 * d * cfg.d_ff if cfg.mlp == "swiglu" else 2 * d * cfg.d_ff
    if cfg.kind == "moe":
        per_layer = attn + cfg.moe_top_k * ffn + d * cfg.moe_experts
    elif cfg.kind == "dense":
        per_layer = attn + ffn
    elif cfg.kind == "rwkv":
        # time-mix: w_r/w_k/w_v/w_g/w_o (5·d²) + decay LoRA; channel-mix:
        # c_k [d,ff] + c_v [ff,d] + c_r [d,d]
        per_layer = 6 * d * d + 2 * d * cfg.d_ff + 2 * d * 64
    elif cfg.kind == "zamba":
        d_inner = 2 * d
        mamba = d * (2 * d_inner + 2 * cfg.ssm_state +
                     d_inner // cfg.ssm_head_dim) + d_inner * d
        sites, per, tail = cfg.zamba_structure()
        total = (sites * per + tail) * mamba
        shared = attn + 3 * d * cfg.d_ff
        return total + shared + 2 * cfg.vocab * d
    else:
        raise ValueError(cfg.kind)
    return cfg.n_layers * per_layer + 2 * cfg.vocab * d


def _check_ported(cfg: ModelConfig) -> None:
    """Refuse what this slice does not run, naming its ROADMAP item."""
    if cfg.kind == "moe":
        raise NotImplementedError(f"{cfg.name}: MoE blocks are not ported "
                                  f"yet (ROADMAP: LM stack, MoE)")
    if cfg.kind in ("rwkv", "zamba"):
        raise NotImplementedError(f"{cfg.name}: {cfg.kind} blocks are not "
                                  f"ported yet (ROADMAP: LM stack, RWKV "
                                  f"and Mamba)")
    if cfg.kind != "dense":
        raise ValueError(cfg.kind)
    if cfg.window:
        raise NotImplementedError(f"{cfg.name}: sliding-window attention is "
                                  f"not ported yet (ROADMAP: LM stack, SWA)")
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} frontend "
                                  f"is not ported yet (ROADMAP: LM stack, "
                                  f"stub frontends)")
    if cfg.attn_impl not in ("blocked", "flash"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")


# ====================================================================== init


class DenseBlock(nn.Module):
    """One dense layer's weights, under the reference's names."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        d, hd, f, dt = cfg.d_model, cfg.hd, cfg.d_ff, cfg.torch_dtype

        def lin(fan_in, fan_out):
            return nn.Parameter(init_linear(gen, fan_in, fan_out, dt,
                                            device=device),
                                requires_grad=False)

        def ones(dim):
            return nn.Parameter(init_rms(dim, dt, device), requires_grad=False)

        self.ln1 = ones(d)
        self.wq = lin(d, cfg.n_heads * hd)
        self.wk = lin(d, cfg.n_kv * hd)
        self.wv = lin(d, cfg.n_kv * hd)
        self.wo = lin(cfg.n_heads * hd, d)
        self.ln2 = ones(d)
        self.w1 = lin(d, f)
        if cfg.mlp == "swiglu":
            self.w3 = lin(d, f)
        self.w2 = lin(f, d)


class LM(nn.Module):
    """A dense decoder: embedding, ``layers``, final norm and head."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        dt = cfg.torch_dtype
        self.embed = nn.Parameter(
            init_linear(gen, cfg.vocab_padded, cfg.d_model, dt, std=0.02,
                        device=device), requires_grad=False)
        self.final_norm = nn.Parameter(init_rms(cfg.d_model, dt, device),
                                       requires_grad=False)
        self.lm_head = nn.Parameter(
            init_linear(gen, cfg.d_model, cfg.vocab_padded, dt,
                        device=device), requires_grad=False)
        self.layers = nn.ModuleList(DenseBlock(cfg, gen, device)
                                    for _ in range(cfg.n_layers))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> LM:
    """Random weights drawn from ``generator`` (on its device, f32, then
    cast to the config's dtype) and placed on ``device`` (default: the
    generator's).  The draws differ from the reference's ``jax.random``
    ones; ``convert.load_reference_params`` carries its weights across."""
    _check_ported(cfg)
    return LM(cfg, generator, device or generator.device)


# ================================================================= block fwd


def _attn_apply(cfg: ModelConfig, lp: DenseBlock, x: torch.Tensor,
                pos0: int):
    b, s, _ = x.shape
    h = rms_norm(x, lp.ln1, cfg.norm_eps)
    q = (h @ lp.wq).reshape(b, s, cfg.n_heads, cfg.hd)
    k = (h @ lp.wk).reshape(b, s, cfg.n_kv, cfg.hd)
    v = (h @ lp.wv).reshape(b, s, cfg.n_kv, cfg.hd)
    positions = pos0 + torch.arange(s, device=x.device)
    q = rope(q, positions[None], cfg.rope_theta)
    k = rope(k, positions[None], cfg.rope_theta)
    o = attention(q, k, v, window=cfg.window, q_block=cfg.q_block,
                  pos0=pos0, impl=cfg.attn_impl)
    x = x + o.reshape(b, s, cfg.n_heads * cfg.hd) @ lp.wo
    return x, (k, v)


def _ffn_apply(cfg: ModelConfig, lp: DenseBlock, x: torch.Tensor):
    h = rms_norm(x, lp.ln2, cfg.norm_eps)
    if cfg.mlp == "swiglu":
        return x + swiglu(h, lp.w1, lp.w3, lp.w2)
    return x + gelu_mlp(h, lp.w1, lp.w2)


# ==================================================================== forward


def _hidden(params: LM, cfg: ModelConfig, batch: Dict[str, Any],
            return_cache: bool):
    """Embedding and every layer: the last hidden state, and the stacked
    post-RoPE ``(k, v)`` ``[L, B, S, Hkv, D]`` when asked."""
    _check_ported(cfg)
    tokens = torch.as_tensor(batch["tokens"], device=params.embed.device)
    x = params.embed[tokens.long()]
    ks, vs = [], []
    for lp in params.layers:
        x, (k, v) = _attn_apply(cfg, lp, x, 0)
        x = _ffn_apply(cfg, lp, x)
        if return_cache:
            ks.append(k)
            vs.append(v)
    caches = {"attn_kv": (torch.stack(ks), torch.stack(vs))} \
        if return_cache else None
    return x, caches


@torch.inference_mode()
def forward(params: LM, cfg: ModelConfig, batch: Dict[str, Any],
            return_cache: bool = False):
    """Training / prefill forward.  Returns (logits, aux, caches|None):
    logits ``[B, S, vocab_padded]``, aux 0 (no MoE), caches
    ``{"attn_kv": (k, v)}`` stacked over layers."""
    x, caches = _hidden(params, cfg, batch, return_cache)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = x @ params.lm_head
    return logits, torch.zeros((), dtype=torch.float32), caches


def _mask_padded(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.vocab_padded == cfg.vocab:
        return logits
    logits = logits.clone()
    logits[..., cfg.vocab:] = -1e30
    return logits


def make_prefill_step(cfg: ModelConfig):
    """Returns prefill_step(params, batch) -> (last-position logits
    ``[B, 1, vocab_padded]``, caches)."""

    @torch.inference_mode()
    def prefill_step(params: LM, batch: Dict[str, Any]):
        x, caches = _hidden(params, cfg, batch, return_cache=True)
        # Only the last position's logits are returned, so the final norm
        # (per position) and the head run on that row alone: at full width
        # the whole [B, S, vocab] logits would be 4.2 GB for one row each.
        x = rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
        return _mask_padded(x @ params.lm_head, cfg), caches

    return prefill_step


# ===================================================================== decode


def init_decode_cache(cfg: ModelConfig, batch: int, seq_len: int,
                      device=None) -> Dict[str, KVCache]:
    """The stacked per-layer KV cache for one-token decode (capacity
    ``seq_len``; ``pos`` is ``[L]``)."""
    _check_ported(cfg)
    return {"attn": KVCache.init(batch, seq_len, cfg.n_kv, cfg.hd,
                                 cfg.torch_dtype, prefix=(cfg.n_layers,),
                                 device=device)}


def _attn_step(cfg: ModelConfig, lp: DenseBlock, cache: KVCache,
               x: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    h = rms_norm(x, lp.ln1, cfg.norm_eps)
    q = (h @ lp.wq).reshape(b, s, cfg.n_heads, cfg.hd)
    k = (h @ lp.wk).reshape(b, s, cfg.n_kv, cfg.hd)
    v = (h @ lp.wv).reshape(b, s, cfg.n_kv, cfg.hd)
    pos = cache.pos.reshape(1, 1)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    o, _ = decode_attention(q, k, v, cache, window=cfg.window)
    return x + o.reshape(b, s, cfg.n_heads * cfg.hd) @ lp.wo


def make_serve_step(cfg: ModelConfig):
    """Returns serve_step(params, cache, batch{tokens [B, 1]}) ->
    (logits ``[B, 1, vocab_padded]``, cache).  The cache is advanced in
    place and returned."""
    _check_ported(cfg)

    @torch.inference_mode()
    def serve_step(params: LM, cache: Dict[str, KVCache],
                   batch: Dict[str, Any]):
        tokens = torch.as_tensor(batch["tokens"], device=params.embed.device)
        x = params.embed[tokens.long()]
        attn = cache["attn"]
        for i, lp in enumerate(params.layers):
            x = _attn_step(cfg, lp, attn.layer(i), x)
            x = _ffn_apply(cfg, lp, x)
        x = rms_norm(x, params.final_norm, cfg.norm_eps)
        return _mask_padded(x @ params.lm_head, cfg), cache

    return serve_step
