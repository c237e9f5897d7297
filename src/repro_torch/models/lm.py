"""The LM substrate (port of ``repro/models/lm.py``): one ``ModelConfig``
covers the ten architectures, and all four kinds train and serve.

Ported: the config (fields, defaults, derived sizes), the parameter
counts, and for every kind — ``dense``, ``moe`` (``models/moe.py``),
``rwkv`` (``models/rwkv.py``) and ``zamba`` (Mamba-2 layers,
``models/ssm.py``, with one shared attention block after every
``mamba_per_attn`` of them) — with full or sliding-window attention
(``window > 0``: the blocked route, a ring-buffer decode cache) and the
stub frontends (``audio_stub`` frame embeddings, ``vision_stub``
embeddings prepended to the tokens): ``init_params``, ``forward`` (the
training forward: logits, the layers' summed MoE aux loss, the per-layer
or per-site K/V when asked), ``loss_fn``, ``value_and_grad``,
``make_train_step`` (microbatched gradient accumulation),
``make_prefill_step``, ``init_decode_cache`` and ``make_serve_step``
(one-token decode against the stacked cache: KV for attention, the shift
rows and WKV state for RWKV, the conv window and SSM state for Mamba).

Parameters live in an ``nn.Module`` whose names are the reference's
(``embed``, ``final_norm``, ``lm_head``, and per layer ``ln1``, ``wq``,
``wk``, ``wv``, ``wo``, ``ln2`` and either ``w1``, ``w3``, ``w2`` or the
submodule ``moe`` with ``router``, ``w1``, ``w3``, ``w2``; an RWKV layer's
``mix``, ``w_r``, ..., ``ln1``, ``ln2``; a Mamba layer's ``in_proj``, ...,
``ln``), with weights ``[in, out]`` so products stay ``x @ W``.  The
reference stacks layers on a leading axis and scans; here ``layers`` is a
``ModuleList`` and a loop (``convert.py`` maps between the two).  Zamba's
``layers`` is a ``ModuleList`` of sites, each a ``ModuleList`` of its
Mamba layers (the reference's ``[sites, per, ...]``), beside ``tail``
(the layers after the last site) and ``shared_attn`` (the attention and
FFN leaves every site applies).  The parameters do not require
gradients; ``value_and_grad`` turns that on for the one backward it
takes, so serving and plain forwards record nothing.  Training works on a
``{name: tensor}`` dict with ``named_parameters()``'s names (``embed``,
``final_norm``, ``lm_head``, ``layers.<i>.<leaf>``,
``layers.<i>.moe.<leaf>``, ``layers.<site>.<j>.<leaf>``,
``tail.<i>.<leaf>``, ``shared_attn.<leaf>``); the prefill and decode
steps run under ``torch.inference_mode()`` (``torch.no_grad()`` under a
mesh).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Iterator, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import checkpoint

from ..dist import (carry_context, constrain, constrain_act,
                    constrain_act_serve, constrain_proj, constrain_proj_serve,
                    current_mesh)
from ..optim.optimizers import apply_updates
from .layers import (KVCache, attention, decode_attention, gelu_mlp,
                     init_linear, init_rms, rms_norm, rope, swiglu)
from .moe import init_moe_params, moe_ffn
from .rwkv import init_rwkv_cache, init_rwkv_params, rwkv_forward, rwkv_step
from .ssm import init_mamba_cache, init_mamba_params, mamba_forward, mamba_step

__all__ = ["ModelConfig", "LM", "init_params", "forward", "loss_fn",
           "value_and_grad", "make_train_step", "make_prefill_step",
           "make_serve_step", "init_decode_cache", "param_count",
           "active_param_count", "model_flops_per_token"]

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


def _check_config(cfg: ModelConfig) -> None:
    """Refuse an unknown kind or attention route."""
    if cfg.kind not in ("dense", "moe", "rwkv", "zamba"):
        raise ValueError(cfg.kind)
    if cfg.attn_impl not in ("blocked", "flash"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")


# ====================================================================== init


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _linears(cfg: ModelConfig, gen: torch.Generator, device):
    """``lin(fan_in, fan_out)``: the next ``init_linear`` draw, frozen."""
    return lambda fan_in, fan_out: _frozen(init_linear(
        gen, fan_in, fan_out, cfg.torch_dtype, device=device))


class _Block(nn.Module):
    """One layer's attention weights and its FFN norm, under the
    reference's names."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        d, hd, dt = cfg.d_model, cfg.hd, cfg.torch_dtype
        lin = _linears(cfg, gen, device)
        self.ln1 = _frozen(init_rms(d, dt, device))
        self.wq = lin(d, cfg.n_heads * hd)
        self.wk = lin(d, cfg.n_kv * hd)
        self.wv = lin(d, cfg.n_kv * hd)
        self.wo = lin(cfg.n_heads * hd, d)
        self.ln2 = _frozen(init_rms(d, dt, device))


class DenseBlock(_Block):
    """A dense layer: attention and a SwiGLU or GELU MLP."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__(cfg, gen, device)
        d, f = cfg.d_model, cfg.d_ff
        lin = _linears(cfg, gen, device)
        self.w1 = lin(d, f)
        if cfg.mlp == "swiglu":
            self.w3 = lin(d, f)
        self.w2 = lin(f, d)


class MoEParams(nn.Module):
    """The routed FFN's weights (``moe.init_moe_params``): ``router``
    ``[D, E]``, ``w1``/``w3`` ``[E, D, F]``, ``w2`` ``[E, F, D]``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        for name, t in init_moe_params(gen, cfg.d_model, cfg.d_ff,
                                       cfg.moe_experts, cfg.torch_dtype,
                                       device).items():
            setattr(self, name, _frozen(t))


class MoEBlock(_Block):
    """An MoE layer: attention and the routed FFN under ``moe``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__(cfg, gen, device)
        self.moe = MoEParams(cfg, gen, device)


class _Leaves(nn.Module):
    """A block whose leaves come from an ``init_*_params`` dict, plus its
    norms."""

    def __init__(self, leaves: Dict[str, torch.Tensor], norms, dim: int,
                 dtype, device):
        super().__init__()
        for name, t in leaves.items():
            setattr(self, name, _frozen(t))
        for name in norms:
            setattr(self, name, _frozen(init_rms(dim, dtype, device)))


class RWKVBlock(_Leaves):
    """An RWKV-6 layer: time-mix and channel-mix leaves, ``ln1``, ``ln2``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__(init_rwkv_params(gen, cfg.d_model, cfg.d_ff,
                                          head_dim=cfg.hd,
                                          dtype=cfg.torch_dtype,
                                          device=device),
                         ("ln1", "ln2"), cfg.d_model, cfg.torch_dtype, device)


class MambaBlock(_Leaves):
    """A Mamba-2 layer: the SSD leaves and its pre-norm ``ln``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__(init_mamba_params(gen, cfg.d_model, cfg.ssm_state,
                                           head_dim=cfg.ssm_head_dim,
                                           dtype=cfg.torch_dtype,
                                           device=device),
                         ("ln",), cfg.d_model, cfg.torch_dtype, device)


class LM(nn.Module):
    """A decoder: embedding, ``layers`` (dense, MoE or RWKV blocks; for
    zamba, sites of Mamba blocks, then ``tail`` and ``shared_attn``), final
    norm and head."""

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
        if cfg.kind == "zamba":
            sites, per, tail = cfg.zamba_structure()
            self.layers = nn.ModuleList(
                nn.ModuleList(MambaBlock(cfg, gen, device)
                              for _ in range(per)) for _ in range(sites))
            if tail:
                self.tail = nn.ModuleList(MambaBlock(cfg, gen, device)
                                          for _ in range(tail))
            self.shared_attn = DenseBlock(cfg, gen, device)
            return
        block = {"dense": DenseBlock, "moe": MoEBlock,
                 "rwkv": RWKVBlock}[cfg.kind]
        self.layers = nn.ModuleList(block(cfg, gen, device)
                                    for _ in range(cfg.n_layers))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> LM:
    """Random weights drawn from ``generator`` (on its device, f32, then
    cast to the config's dtype) and placed on ``device`` (default: the
    generator's).  The draws differ from the reference's ``jax.random``
    ones; ``convert.load_reference_params`` carries its weights across."""
    _check_config(cfg)
    return LM(cfg, generator, device or generator.device)


# ================================================================= block fwd


def _attn_apply(cfg: ModelConfig, lp: _Block, x: torch.Tensor,
                pos0: int):
    b, s, _ = x.shape
    h = rms_norm(x, lp.ln1, cfg.norm_eps)
    q = constrain_proj(h @ lp.wq, cfg.n_heads).reshape(b, s, cfg.n_heads,
                                                       cfg.hd)
    k = constrain_proj(h @ lp.wk, cfg.n_kv).reshape(b, s, cfg.n_kv, cfg.hd)
    v = constrain_proj(h @ lp.wv, cfg.n_kv).reshape(b, s, cfg.n_kv, cfg.hd)
    positions = pos0 + torch.arange(s, device=x.device)
    q = rope(q, positions[None], cfg.rope_theta)
    k = rope(k, positions[None], cfg.rope_theta)
    o = attention(q, k, v, window=cfg.window, q_block=cfg.q_block,
                  pos0=pos0, impl=cfg.attn_impl)
    o = constrain(o.reshape(b, s, cfg.n_heads * cfg.hd), ("pod", "data"),
                  None, "model")
    # the residual stream summed over the ranks that split o's features
    # before the FFN's products (DTensor would carry it on as a partial
    # sum, which the products' backward cannot take)
    return _rows(x + o @ lp.wo), (k, v)


def _ffn_apply(cfg: ModelConfig, lp: _Block, x: torch.Tensor):
    """The FFN sub-block: ``(x + ffn(ln2(x)), aux)``, aux the MoE
    load-balancing loss (a 0-d f32 tensor) or None for a dense layer."""
    h = rms_norm(x, lp.ln2, cfg.norm_eps)
    if cfg.kind == "moe":
        y, aux = moe_ffn(h, dict(lp.moe.named_parameters()),
                         top_k=cfg.moe_top_k,
                         capacity_factor=cfg.capacity_factor)
        return x + y, aux
    if cfg.mlp == "swiglu":
        return x + swiglu(h, lp.w1, lp.w3, lp.w2), None
    return x + gelu_mlp(h, lp.w1, lp.w2), None


# ==================================================================== forward


def _leaves(lp: nn.Module) -> Dict[str, torch.Tensor]:
    return dict(lp.named_parameters())


def _rows(x: torch.Tensor) -> torch.Tensor:
    """The sequence gathered back before a block's products: tp2d shards
    block-boundary activations over it (``constrain_act``), and DTensor has
    no product rule for the rows a flatten of such a tensor gives (a
    strided shard).  XLA moves the same bytes under the reference's
    constraints; with no mesh the identity."""
    return constrain(x, ("pod", "data"), None, None)


def _layer(cfg: ModelConfig, lp: nn.Module, x: torch.Tensor):
    """One layer forward (the reference's ``_block_fwd``): ``(x, aux,
    kv)``, aux and kv None where the layer has none; the block boundary's
    activation constraint last."""
    x = _rows(x)
    if cfg.kind == "rwkv":
        x = rwkv_forward(_leaves(lp), x, lp.ln1, lp.ln2, cfg.hd)
        return constrain_act(x), None, None
    if cfg.kind == "zamba":                       # one Mamba layer
        y = mamba_forward(_leaves(lp), rms_norm(x, lp.ln, cfg.norm_eps),
                          d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim)
        return constrain_act(x + y), None, None
    x, kv = _attn_apply(cfg, lp, x, 0)
    x, aux = _ffn_apply(cfg, lp, x)
    return constrain_act(x), aux, kv


def _site(cfg: ModelConfig, site: nn.ModuleList, shared: DenseBlock,
          x: torch.Tensor):
    """A zamba super-block: its Mamba layers, then the shared attention
    and FFN; ``(x, None, kv)``."""
    for lp in site:
        x = _layer(cfg, lp, x)[0]
    x, kv = _attn_apply(cfg, shared, _rows(x), 0)
    x, _ = _ffn_apply(cfg, shared, x)
    return constrain_act(x), None, kv


def _embed_inputs(params: LM, cfg: ModelConfig,
                  batch: Dict[str, Any]) -> torch.Tensor:
    """The layer stack's input (``repro/models/lm.py:306-316``): the audio
    stub's frame ``embeds`` cast to the config's dtype, or the tokens'
    embedding rows; the vision stub's ``vision_embeds`` prepended."""
    dev, dt = params.embed.device, cfg.torch_dtype
    if "embeds" in batch:
        x = torch.as_tensor(batch["embeds"], device=dev).to(dt)
    else:
        # F.embedding, not indexing: its backward sums a repeated token's
        # rows in a fixed order, where the indexing's CPU backward adds
        # them with parallel atomics (remat on and off stay bit-equal)
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        x = F.embedding(tokens.long(), params.embed)
    if cfg.frontend == "vision_stub" and "vision_embeds" in batch:
        vis = torch.as_tensor(batch["vision_embeds"], device=dev).to(dt)
        x = torch.cat([vis, x], dim=1)
    return constrain_act(x)


def _hidden(params: LM, cfg: ModelConfig, batch: Dict[str, Any],
            return_cache: bool):
    """The inputs through every layer: the last hidden state, the layers'
    aux losses summed in f32 (0 without MoE), and when asked the stacked
    post-RoPE ``(k, v)`` ``[L, B, S, Hkv, D]`` of the attention layers (of
    zamba's sites; RWKV has none, and its caches are None, as the
    reference's).  With ``cfg.remat`` and autograd recording, each layer
    (each zamba site; its tail layers not, as in the reference) is
    rematerialized in the backward (the reference's ``jax.checkpoint`` on
    its scan body): only the unit inputs stay alive between the passes,
    and the aux comes out of the checkpointed function so the router's
    gradient sees it."""
    _check_config(cfg)
    x = _embed_inputs(params, cfg, batch)
    remat = cfg.remat and not return_cache and torch.is_grad_enabled()
    if cfg.kind == "zamba":
        units = [lambda h, site=site: _site(cfg, site, params.shared_attn, h)
                 for site in params.layers]
    else:
        units = [lambda h, lp=lp: _layer(cfg, lp, h) for lp in params.layers]
    ks, vs, auxs = [], [], []
    for unit in units:
        if remat:
            # the recompute runs in the backward: on a card in autograd's
            # thread, which must see the mesh too
            body = carry_context(lambda h, unit=unit: unit(h)[:2])
            x, aux = checkpoint(body, x, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux, kv = unit(x)
            if return_cache and kv is not None:
                ks.append(kv[0])
                vs.append(kv[1])
        if aux is not None:
            auxs.append(aux)
    for lp in getattr(params, "tail", ()):
        x = _layer(cfg, lp, x)[0]
    aux_sum = torch.stack(auxs).sum() if auxs else torch.zeros(
        (), dtype=torch.float32, device=x.device)
    caches = {"attn_kv": (torch.stack(ks), torch.stack(vs))} \
        if return_cache and ks else None
    return x, aux_sum, caches


class _GradCast(torch.autograd.Function):
    """Identity whose cotangent is cast to ``dtype``: the reference's
    ``_grad_cast`` (``repro/models/lm.py:283-303``), which keeps the
    backward stream through the layers in the forward's dtype."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


def forward(params: LM, cfg: ModelConfig, batch: Dict[str, Any],
            return_cache: bool = False):
    """Training / prefill forward.  Returns (logits, aux, caches|None):
    logits ``[B, S, vocab_padded]`` (S counts a vision prefix), aux the
    layers' MoE aux losses summed (0-d f32; 0 without MoE), caches
    ``{"attn_kv": (k, v)}`` stacked over attention layers (zamba's sites),
    None for RWKV.  Differentiable: it records for autograd where the
    caller does."""
    x, aux, caches = _hidden(params, cfg, batch, return_cache)
    x = _GradCast.apply(_rows(x), cfg.torch_dtype)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = constrain(x @ params.lm_head, ("pod", "data"), None, "model")
    return logits, aux, caches


def _mask_padded(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The padded vocab's logits set to -1e30 (a select: DTensor has no
    rule for filling a slice)."""
    if cfg.vocab_padded == cfg.vocab:
        return logits
    pad = torch.arange(logits.shape[-1], device=logits.device) >= cfg.vocab
    return logits.masked_fill(pad, -1e30)


def loss_fn(params: LM, cfg: ModelConfig, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy in f32 over the positions whose label is
    ``>= 0`` (``repro/models/lm.py:375-394``): ``(loss, {"nll", "aux",
    "tokens"})``, with ``loss = nll + 0.01 * aux``.  A vision prefix's
    positions carry no labels: their logits are dropped first."""
    logits, aux, _ = forward(params, cfg, batch)
    if cfg.frontend == "vision_stub" and "vision_embeds" in batch:
        logits = logits[:, torch.as_tensor(batch["vision_embeds"]).shape[1]:]
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    logits = _mask_padded(logits, cfg).float()
    shift_logits = logits[:, :-1]
    shift_labels = labels[:, 1:]
    logz = torch.logsumexp(shift_logits, dim=-1)
    # a negative label indexes from the end, as take_along_axis does; its
    # position is masked out of the sum
    idx = torch.where(shift_labels < 0, shift_labels + logits.shape[-1],
                      shift_labels)
    if isinstance(shift_logits, DTensor):
        # the vocab dim may be sharded: a select and a sum over it (the
        # gather on a sharded dim has no rule that keeps the batch's)
        hit = torch.arange(logits.shape[-1], device=logits.device) \
            == idx[..., None]
        gold = torch.where(hit, shift_logits, 0.0).sum(-1)
    else:
        gold = torch.gather(shift_logits, -1, idx[..., None])[..., 0]
    mask = (shift_labels >= 0).float()
    nll = ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    loss = nll + 0.01 * aux
    return loss, {"nll": nll, "aux": aux, "tokens": mask.sum()}


@contextlib.contextmanager
def _recording(leaves) -> Iterator[None]:
    """Parameters require gradients inside the block only."""
    for p in leaves:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            yield
    finally:
        for p in leaves:
            p.requires_grad_(False)


def value_and_grad(params: LM, cfg: ModelConfig, batch: Dict[str, Any]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                              Dict[str, torch.Tensor]]:
    """``loss_fn`` and its gradient: ``(loss, metrics, grads)``, grads a
    ``{name: tensor}`` dict in each parameter's dtype, under
    ``named_parameters()``'s names."""
    named = dict(params.named_parameters())
    with _recording(named.values()):
        loss, metrics = loss_fn(params, cfg, batch)
        # an unused leaf (the embedding under the audio stub's frame
        # embeddings) gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True, materialize_grads=True)
    # under a mesh a gradient comes out partial over the ranks that split
    # the batch: reduce it here, once, to its parameter's layout
    grads = [g.redistribute(p.device_mesh, p.placements)
             if isinstance(g, DTensor) and g.placements != p.placements
             else g for g, p in zip(grads, named.values())]
    return (loss.detach(), {k: m.detach() for k, m in metrics.items()},
            dict(zip(named, grads)))


def _split(batch: Dict[str, Any], n: int) -> list:
    """The batch cut on its leading axis into ``n`` equal microbatches.  A
    DTensor batch is gathered first and each microbatch laid out as the
    batch was (the reference's reshape to [n, B/n] moves the same rows)."""
    parts: list = [{} for _ in range(n)]
    for key, a in batch.items():
        t = torch.as_tensor(a)
        if t.shape[0] % n:
            raise ValueError(f"batch of {t.shape[0]} rows does not split "
                             f"into {n} microbatches")
        layout = None
        if isinstance(t, DTensor):
            layout = t.placements
            t = t.redistribute(t.device_mesh,
                               [Replicate()] * len(layout))
        for i, piece in enumerate(t.split(t.shape[0] // n)):
            parts[i][key] = (piece if layout is None else piece.redistribute(
                piece.device_mesh, layout))
    return parts


def make_train_step(cfg: ModelConfig, optimizer,
                    microbatches: int = 1) -> Callable:
    """The train step (``repro/models/lm.py:397-440``):
    ``step(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``params`` is the ``LM``; its tensors are updated in place under
    ``torch.no_grad()`` and the same module is returned.  The optimizer
    works on ``{name: tensor}`` dicts under ``named_parameters()``'s names.
    ``metrics`` holds ``loss``, ``nll``, ``aux`` and ``tokens`` as 0-d f32
    tensors on the parameters' device.  ``microbatches > 1`` accumulates:
    the batch is cut on its leading axis, each part's gradients are added
    into f32 sums in order and divided by ``n``, and the metrics are the
    means over the parts; only one part's activations are alive at a time.
    ``apply_updates`` rounds ``p + u`` to each parameter's dtype.
    """
    _check_config(cfg)
    n = int(microbatches)

    def apply(params: LM, opt_state, grads, metrics):
        named = dict(params.named_parameters())
        updates, opt_state = optimizer.update(grads, opt_state, named)
        del grads
        new = apply_updates(named, updates)
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(new[k])
        return params, opt_state, metrics

    def single(params: LM, opt_state, batch):
        loss, metrics, grads = value_and_grad(params, cfg, batch)
        return apply(params, opt_state, grads, dict(metrics, loss=loss))

    if n <= 1:
        return single

    def accumulated(params: LM, opt_state, batch):
        acc = {k: torch.zeros_like(p, dtype=torch.float32)
               for k, p in params.named_parameters()}
        ms = []
        for one in _split(batch, n):
            loss, metrics, grads = value_and_grad(params, cfg, one)
            for k, g in grads.items():
                acc[k] += g.float()
            del grads
            ms.append(dict(metrics, loss=loss))
        for a in acc.values():
            a.div_(n)
        metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        return apply(params, opt_state, acc, metrics)

    return accumulated


class _no_autograd(contextlib.ContextDecorator):
    """``torch.inference_mode()``, or ``torch.no_grad()`` under a mesh
    (DTensor's views of tensors made outside inference mode refuse it)."""

    def __enter__(self):
        self._ctx = (torch.inference_mode() if current_mesh() is None
                     else torch.no_grad())
        return self._ctx.__enter__()

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)


def make_prefill_step(cfg: ModelConfig):
    """Returns prefill_step(params, batch) -> (last-position logits
    ``[B, 1, vocab_padded]``, caches): ``{"attn_kv": (k, v)}`` stacked over
    the attention layers (zamba's sites), None for RWKV.  As in the
    reference, no RWKV or Mamba state is handed on: a decode after it
    starts those from zero, so a stepped prompt is the serving route."""

    @_no_autograd()
    def prefill_step(params: LM, batch: Dict[str, Any]):
        x, _, caches = _hidden(params, cfg, batch, return_cache=True)
        # Only the last position's logits are returned, so the final norm
        # (per position) and the head run on that row alone: at full width
        # the whole [B, S, vocab] logits would be 4.2 GB for one row each.
        x = rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
        return _mask_padded(x @ params.lm_head, cfg), caches

    return prefill_step


# ===================================================================== decode


def init_decode_cache(cfg: ModelConfig, batch: int, seq_len: int,
                      device=None) -> Dict[str, Any]:
    """The stacked per-layer cache for one-token decode.  Attention: a KV
    cache (``pos`` is ``[L]``) of capacity ``seq_len``, or ``min(seq_len,
    window)`` with a sliding window, where decode writes it as a ring
    buffer.  RWKV: ``{"rwkv"}``, the shift rows and the f32 WKV state
    ``[L, ...]``.  Zamba: ``{"mamba"}`` ``[sites, per, ...]``, ``{"attn"}``
    one KV cache a site, and ``{"mamba_tail"}`` ``[tail, ...]`` when the
    config has a tail; the SSM states in f32."""
    _check_config(cfg)
    dt = cfg.torch_dtype
    cap = min(seq_len, cfg.window) if cfg.window else seq_len
    if cfg.kind == "rwkv":
        return {"rwkv": init_rwkv_cache(batch, cfg.d_model, cfg.hd, dt,
                                        device, prefix=(cfg.n_layers,))}
    if cfg.kind != "zamba":
        return {"attn": KVCache.init(batch, cap, cfg.n_kv, cfg.hd, dt,
                                     prefix=(cfg.n_layers,), device=device)}
    sites, per, tail = cfg.zamba_structure()

    def mamba(prefix):
        return init_mamba_cache(batch, cfg.d_model, cfg.ssm_state,
                                cfg.ssm_head_dim, dtype=dt, device=device,
                                prefix=prefix)
    out = {"mamba": mamba((sites, per)),
           "attn": KVCache.init(batch, cap, cfg.n_kv, cfg.hd, dt,
                                prefix=(sites,), device=device)}
    if tail:
        out["mamba_tail"] = mamba((tail,))
    return out


def _attn_step(cfg: ModelConfig, lp: _Block, cache: KVCache,
               x: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    h = rms_norm(x, lp.ln1, cfg.norm_eps)
    # q's heads split as [Hkv, G] in decode_attention: sharded by the kv
    # heads' rule
    q = constrain_proj_serve(h @ lp.wq, cfg.n_kv).reshape(
        b, s, cfg.n_heads, cfg.hd)
    k = constrain_proj_serve(h @ lp.wk, cfg.n_kv).reshape(b, s, cfg.n_kv,
                                                          cfg.hd)
    v = constrain_proj_serve(h @ lp.wv, cfg.n_kv).reshape(b, s, cfg.n_kv,
                                                          cfg.hd)
    pos = cache.pos.reshape(1, 1)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    o, _ = decode_attention(q, k, v, cache, window=cfg.window)
    return x + o.reshape(b, s, cfg.n_heads * cfg.hd) @ lp.wo


def make_serve_step(cfg: ModelConfig):
    """Returns serve_step(params, cache, batch{tokens [B, 1]}) ->
    (logits ``[B, 1, vocab_padded]``, cache).  The cache is advanced in
    place and returned."""
    _check_config(cfg)

    def mamba(lp, c, x: torch.Tensor) -> torch.Tensor:
        y, _ = mamba_step(_leaves(lp), c, rms_norm(x, lp.ln, cfg.norm_eps),
                          d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim)
        return x + y

    @_no_autograd()
    def serve_step(params: LM, cache: Dict[str, Any],
                   batch: Dict[str, Any]):
        tokens = torch.as_tensor(batch["tokens"], device=params.embed.device)
        x = constrain_act_serve(params.embed[tokens.long()])
        if cfg.kind == "rwkv":
            for i, lp in enumerate(params.layers):
                x, _ = rwkv_step(_leaves(lp), cache["rwkv"].layer(i), x,
                                 lp.ln1, lp.ln2, cfg.hd)
        elif cfg.kind == "zamba":
            shared = params.shared_attn
            for s, site in enumerate(params.layers):
                for j, lp in enumerate(site):
                    x = mamba(lp, cache["mamba"].layer(s, j), x)
                x = _attn_step(cfg, shared, cache["attn"].layer(s), x)
                x, _ = _ffn_apply(cfg, shared, x)
            for i, lp in enumerate(getattr(params, "tail", ())):
                x = mamba(lp, cache["mamba_tail"].layer(i), x)
        else:
            for i, lp in enumerate(params.layers):
                x = _attn_step(cfg, lp, cache["attn"].layer(i), x)
                x = constrain_act_serve(_ffn_apply(cfg, lp, x)[0])
        x = rms_norm(x, params.final_norm, cfg.norm_eps)
        return _mask_padded(x @ params.lm_head, cfg), cache

    return serve_step
