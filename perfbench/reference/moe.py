"""Plain PyTorch reference of a routed (MoE) decoder's training step.

Written from the model's equations and the port's documented routing
rules, not from the port's code, and importing nothing of it: token ids
through an embedding, per layer RMSNorm, rotary embeddings, causal
grouped-query attention (``reference.lm``'s, by import), RMSNorm and a
top-k routed SwiGLU FFN, then the final norm, an untied head and
next-token cross-entropy plus the layers' aux loss.

The routed FFN, per batch row of S tokens over E experts:

* router logits ``h @ router`` in the activations' dtype;
* top-k: the k largest logits, a tie going to the lower expert index
  (``argmax`` k times, each pick masked out; the port ranks -0.0 below
  +0.0, which an exact zero logit from random weights never meets);
* gate weights: a softmax in f32 over the k selected logits;
* capacity ``C`` a row (``harness.moe_dims.capacity``); the row's
  assignments in order token by token, choice by choice, and an expert
  keeps its first ``C`` (a running count a expert: a cumulative sum of
  one-hot rows); a dropped assignment adds nothing;
* each expert's kept tokens through ``(silu(x w1) * (x w3)) w2``, added
  into the token's output weighted by its kept gate weight;
* aux: ``E * sum_e f_e p_e``, f_e the share of the row's tokens whose
  largest logit (the first, on a tie) is e, p_e the mean softmax
  probability of e; the mean over rows; the loss adds ``aux_coef`` x the
  sum over layers.

``precision="f32"``: every tensor f32 and TF32 off (``lm.exact_f32``).
``precision="fp8"`` is the control: weights and activations in the
configuration's bf16 and each product's operands rounded to fp8 as in
``reference.lm``.

``blocked_value_and_grad`` runs the step for one rank's rows with one
layer's weights alive at a time: the forward keeps each layer's input,
the backward makes each layer's weights again, recomputes the layer and
hands its weight gradients to a callback (which sums them over ranks and
reads them) before the next layer's are made.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.harness.moe_dims import MoEDims, capacity
from perfbench.reference import lm

Weights = Dict[str, torch.Tensor]


def top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """``[..., E]`` -> the k chosen experts ``[..., k]``, largest first,
    ties to the lower index."""
    picks, masked = [], logits.float()
    for _ in range(k):
        pick = torch.argmax(masked, dim=-1)
        picks.append(pick)
        masked = masked.scatter(-1, pick[..., None], float("-inf"))
    return torch.stack(picks, dim=-1)


def kept(experts: torch.Tensor, n_experts: int, cap: int) -> torch.Tensor:
    """``[S, K]`` chosen experts of one row -> ``[S, K]`` bool: whether the
    assignment is among its expert's first ``cap`` in token-major order."""
    flat = experts.reshape(-1)
    onehot = F.one_hot(flat, n_experts)
    before = torch.cumsum(onehot, dim=0) - onehot
    pos = torch.gather(before, 1, flat[:, None])[:, 0]
    return (pos < cap).reshape(experts.shape)


def moe_ffn(h: torch.Tensor, w: Weights, p: str, dims: MoEDims,
            precision: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h`` ``[B, S, D]`` (normalised) -> (FFN output ``[B, S, D]``, aux
    a 0-d f32 tensor)."""
    b, s, d = h.shape
    e, k = dims.experts, dims.top_k
    cap = capacity(dims, s)
    logits = lm._mm(h, w[p + "moe.router"], precision)          # [B, S, E]
    probs = torch.softmax(logits.float(), dim=-1)
    first = F.one_hot(torch.argmax(logits.float(), dim=-1), e).float()
    aux = (e * (first.mean(1) * probs.mean(1)).sum(-1)).mean()
    w1, w3, w2 = (w[p + "moe." + n].unbind(0) for n in ("w1", "w3", "w2"))
    rows = []
    for r in range(b):
        with torch.no_grad():
            experts = top_k(logits[r], k)                        # [S, K]
            keep = kept(experts, e, cap)
        gate = torch.softmax(torch.gather(logits[r], -1, experts).float(),
                             dim=-1) * keep
        row = torch.zeros_like(h[r])
        for x in range(e):
            tok, slot = torch.nonzero((experts == x) & keep, as_tuple=True)
            if tok.numel() == 0:
                continue
            xin = h[r][tok]
            y = lm._mm(F.silu(lm._mm(xin, w1[x], precision))
                       * lm._mm(xin, w3[x], precision), w2[x], precision)
            row = row.index_add(0, tok, y * gate[tok, slot][:, None]
                                .to(y.dtype))
        rows.append(row)
    return torch.stack(rows), aux


def layer(x: torch.Tensor, w: Weights, i: int, dims: MoEDims,
          precision: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer: ``(x_out, aux)``."""
    p = f"layers.{i}."
    b, s, _ = x.shape
    hd = dims.head_dim
    h = lm.rms_norm(x, w[p + "ln1"], dims.eps)
    q = lm._mm(h, w[p + "wq"], precision).reshape(b, s, dims.heads, hd)
    kk = lm._mm(h, w[p + "wk"], precision).reshape(b, s, dims.kv_heads, hd)
    v = lm._mm(h, w[p + "wv"], precision).reshape(b, s, dims.kv_heads, hd)
    q, kk = lm.rope(q, dims.rope_theta), lm.rope(kk, dims.rope_theta)
    o = lm.attention(q, kk, v).reshape(b, s, dims.heads * hd)
    x = x + lm._mm(o, w[p + "wo"], precision)
    y, aux = moe_ffn(lm.rms_norm(x, w[p + "ln2"], dims.eps), w, p, dims,
                     precision)
    return x + y, aux


def head_nll(x: torch.Tensor, w: Weights, dims: MoEDims,
             labels: torch.Tensor, precision: str) -> torch.Tensor:
    """Mean next-token cross-entropy (f32) of the last hidden state."""
    x = lm.rms_norm(x, w["final_norm"], dims.eps)
    logits = lm._mm(x, w["lm_head"], precision).float()[:, :-1]
    logits = logits[..., :dims.vocab]
    labels = labels.long()[:, 1:]
    return (torch.logsumexp(logits, -1)
            - torch.gather(logits, -1, labels[..., None])[..., 0]).mean()


def loss(w: Weights, dims: MoEDims, batch: Dict[str, torch.Tensor],
         precision: str) -> torch.Tensor:
    """The whole step's loss with every weight alive (small sizes)."""
    x = F.embedding(batch["tokens"].long(), w["embed"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(dims.layers):
        x, a = checkpoint(layer, x, w, i, dims, precision,
                          use_reentrant=False)
        aux = aux + a
    return head_nll(x, w, dims, batch["labels"], precision) + \
        dims.aux_coef * aux


LayerWeights = Callable[[int], Weights]
OnGrads = Callable[[Dict[str, torch.Tensor]], None]


def blocked_value_and_grad(dims: MoEDims, batch: Dict[str, torch.Tensor],
                           layer_weights: LayerWeights, outer: Weights,
                           on_grads: OnGrads, precision: str,
                           scale: float = 1.0) -> float:
    """``scale`` x the loss of ``batch`` (one rank's rows) and its
    gradient, one layer's weights alive at a time.

    ``layer_weights(i)`` makes layer i's weights (its leaves under their
    names); ``outer`` holds ``embed``, ``final_norm`` and ``lm_head``.
    ``on_grads`` receives each group's gradients as they are done: the
    head's, then layer L-1's .. layer 0's, then the embedding's, each a
    ``{name: f32 tensor}`` of this rank's part (``scale`` applied), to sum
    over ranks.  Returns this rank's scaled loss."""
    tokens, labels = batch["tokens"].long(), batch["labels"]
    with torch.no_grad():
        x = F.embedding(tokens, outer["embed"])
        inputs: List[torch.Tensor] = []
        aux_total = 0.0
        for i in range(dims.layers):
            inputs.append(x)
            w = layer_weights(i)
            x, a = layer(x, w, i, dims, precision)
            aux_total += float(a)
            del w
    head = {k: outer[k].detach().requires_grad_(True)
            for k in ("final_norm", "lm_head")}
    xl = x.detach().requires_grad_(True)
    with torch.enable_grad():
        nll = head_nll(xl, head, dims, labels, precision) * scale
        gs = torch.autograd.grad(nll, [xl, *head.values()])
    value = float(nll.detach()) + scale * dims.aux_coef * aux_total
    gx = gs[0]
    on_grads({k: g.float() for k, g in zip(head, gs[1:])})
    del head, gs, xl, x
    for i in reversed(range(dims.layers)):
        w = {k: t.detach().requires_grad_(True)
             for k, t in layer_weights(i).items()}
        xin = inputs.pop().detach().requires_grad_(True)
        with torch.enable_grad():
            out, a = layer(xin, w, i, dims, precision)
            total = (out.float() * gx.float()).sum() + \
                scale * dims.aux_coef * a
            gs = torch.autograd.grad(total, [xin, *w.values()])
        gx = gs[0].to(xin.dtype)
        grads = {k: g.float() for k, g in zip(w, gs[1:])}
        del w, gs, out, a, total, xin
        on_grads(grads)
        del grads
    emb = torch.zeros(outer["embed"].shape, dtype=torch.float32,
                      device=gx.device)
    emb.index_add_(0, tokens.reshape(-1), gx.float().reshape(-1, dims.d))
    on_grads({"embed": emb})
    return value


def first_change(w: torch.Tensor, g: torch.Tensor, train: Dict
                 ) -> torch.Tensor:
    """The weight's change by AdamW's first step from zero moments on the
    summed gradient ``g`` (``lm.Optimizer``'s arithmetic at step 1), stored
    back in the weight's dtype as ``lm.Optimizer`` stores it."""
    b1, b2 = train["b1"], train["b2"]
    lr = lm.schedule(train, 1)
    m = torch.zeros_like(g).mul_(b1).add_(g, alpha=1 - b1)
    v = torch.zeros_like(g).mul_(b2).addcmul_(g, g, value=1 - b2)
    u = -lr * (m / (1 - b1)) / (torch.sqrt(v / (1 - b2)) + train["eps"])
    if train["weight_decay"]:
        u = u - lr * train["weight_decay"] * w.float()
    return (w.float() + u).to(w.dtype).float() - w.float()


def value_and_grad(w: Weights, dims: MoEDims,
                   batch: Dict[str, torch.Tensor], precision: str
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The loss and every leaf's f32 gradient with all weights alive (the
    CPU tests' small sizes)."""
    names = list(w)
    live = {k: w[k].detach().requires_grad_(True) for k in names}
    with torch.enable_grad():
        value = loss(live, dims, batch, precision)
        gs = torch.autograd.grad(value, list(live.values()),
                                 allow_unused=True, materialize_grads=True)
    return float(value.detach()), {k: g.float() for k, g in zip(names, gs)}


def layer_names(dims: MoEDims, i: int) -> List[str]:
    p = f"layers.{i}."
    return [p + n for n in ("ln1", "wq", "wk", "wv", "wo", "ln2",
                            "moe.router", "moe.w1", "moe.w3", "moe.w2")]


OUTER = ("embed", "final_norm", "lm_head")
