"""GNN models in the aggregate-update paradigm (paper Section II-A).

Port of ``repro/graph/models.py``: GCN (Eq. 3) and GraphSAGE (Eq. 4) on the
fixed-shape sampled ``MiniBatch`` blocks.  Each destination has exactly
``fanout`` sampled neighbours, so the aggregation has several equivalent
implementations (``GNNConfig.agg_impl``):

* ``dense``        — reshape to [n_dst, fanout, F] and reduce,
* ``segsum``       — flat edge list + ``index_add_``,
* ``kernel``       — the segment-sum kernel (``kernels.ops``), then the
  update as a matrix product,
* ``kernel_fused`` — the fused aggregate+update layer kernel (the paper's
  Section IV-C datapath).

The reference's names ``pallas`` and ``pallas_fused`` are accepted for the
last two.  Parameters are a plain dict of tensors (``w1``, ``b1``, ...),
laid out as in the reference so weights carry across with
``params_from_numpy``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops as kops
from .sampler import MiniBatch, frontier_sizes

__all__ = ["GNNConfig", "init_params", "params_from_numpy", "forward",
           "loss_fn", "param_count", "AGG_IMPLS"]

Params = Dict[str, torch.Tensor]

# accepted agg_impl names -> the implementation they select
AGG_IMPLS = {"dense": "dense", "segsum": "segsum",
             "kernel": "kernel", "pallas": "kernel",
             "kernel_fused": "kernel_fused", "pallas_fused": "kernel_fused"}


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    model: str = "sage"                 # "sage" | "gcn"
    layer_dims: Tuple[int, ...] = (100, 256, 47)   # (f0, f1, f2) Table III
    fanouts: Tuple[int, ...] = (25, 10)
    num_classes: int = 47
    agg_impl: str = "dense"             # see AGG_IMPLS

    def __post_init__(self):
        if self.model not in ("sage", "gcn"):
            raise ValueError(f"unknown model {self.model!r}")
        if self.agg_impl not in AGG_IMPLS:
            raise ValueError(f"unknown agg_impl {self.agg_impl!r}; "
                             f"have {sorted(AGG_IMPLS)}")

    @property
    def num_layers(self) -> int:
        return len(self.layer_dims) - 1

    @property
    def impl(self) -> str:
        return AGG_IMPLS[self.agg_impl]

    def dims_in_out(self) -> Sequence[Tuple[int, int]]:
        return list(zip(self.layer_dims[:-1], self.layer_dims[1:]))


def param_count(params: Params) -> int:
    return sum(int(p.numel()) for p in params.values())


def init_params(cfg: GNNConfig, generator: Optional[torch.Generator] = None,
                device: Optional[torch.device] = None,
                dtype: torch.dtype = torch.float32) -> Params:
    """N(0, 1/fan_in) weights and zero biases, drawn on the host from
    ``generator`` (so the values do not depend on the device) and placed on
    ``device``.  The draws differ from the reference's ``jax.random``; to
    compare the two, carry the reference's weights across with
    ``params_from_numpy``."""
    params: Params = {}
    for l, (fin, fout) in enumerate(cfg.dims_in_out(), start=1):
        fan_in = 2 * fin if cfg.model == "sage" else fin
        w = torch.randn((fan_in, fout), generator=generator,
                        dtype=dtype) / math.sqrt(fan_in)
        params[f"w{l}"] = w.to(device) if device is not None else w
        params[f"b{l}"] = torch.zeros((fout,), dtype=dtype, device=device)
    return params


def params_from_numpy(arrays: Mapping[str, object],
                      device: Optional[torch.device] = None) -> Params:
    """Parameters from any mapping of array-likes (numpy arrays, or the
    reference's arrays, which ``np.asarray`` converts) as float32 tensors
    on ``device``."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
            for k, v in arrays.items()}


# ---------------------------------------------------------------- aggregation


def _agg_dense(x_nbr, w_edge, n_dst: int, fanout: int) -> torch.Tensor:
    xn = x_nbr.reshape(n_dst, fanout, -1)
    if w_edge is None:                       # SAGE mean
        return xn.mean(dim=1)
    return (xn * w_edge.reshape(n_dst, fanout, 1)).sum(dim=1)


def _agg_segsum(x_nbr, w_edge, n_dst: int, fanout: int) -> torch.Tensor:
    seg = torch.arange(n_dst, device=x_nbr.device).repeat_interleave(fanout)
    contrib = x_nbr if w_edge is None else x_nbr * w_edge[:, None]
    s = torch.zeros((n_dst, x_nbr.shape[1]), dtype=contrib.dtype,
                    device=x_nbr.device).index_add(0, seg, contrib)
    return s / fanout if w_edge is None else s


def _aggregate(cfg: GNNConfig, x_nbr, w_edge, n_dst: int, fanout: int):
    impl = cfg.impl
    if impl == "dense":
        return _agg_dense(x_nbr, w_edge, n_dst, fanout)
    if impl == "segsum":
        return _agg_segsum(x_nbr, w_edge, n_dst, fanout)
    we = (torch.full((x_nbr.shape[0],), 1.0 / fanout, dtype=x_nbr.dtype,
                     device=x_nbr.device)
          if w_edge is None else w_edge)
    return kops.segment_weighted_sum_regular(x_nbr, we, fanout)


def _fused_layer(params: Params, cfg: GNNConfig, layer: int, x_self, x_nbr,
                 w_edge, self_scale, fanout: int) -> torch.Tensor:
    """Whole GNN layer through the fused kernel (the aggregate never
    reaches device memory)."""
    w = params[f"w{layer}"]
    b = params[f"b{layer}"]
    fin = x_self.shape[-1]
    if cfg.model == "sage":
        # concat(x_self, mean_nbrs) @ W == x_self @ W[:fin] + mean @ W[fin:]
        we = torch.full((x_nbr.shape[0],), 1.0 / fanout, dtype=x_nbr.dtype,
                        device=x_nbr.device)
        ones = torch.ones((x_self.shape[0],), dtype=x_self.dtype,
                          device=x_self.device)
        return kops.fused_gnn_update(x_self, x_nbr, we, ones,
                                     w[:fin], w[fin:], b, fanout)
    # gcn: (agg + self_scale * x_self) @ W — the same W on both terms
    return kops.fused_gnn_update(x_self, x_nbr, w_edge, self_scale,
                                 w, w, b, fanout)


# ------------------------------------------------------------------- forward


def forward(params: Params, cfg: GNNConfig, batch: MiniBatch,
            x0: torch.Tensor) -> torch.Tensor:
    """Logits for the batch targets, [B, f_L].  ``x0`` holds the features
    of the innermost frontier (layer-0 inputs) and ``batch`` is on the same
    device (``MiniBatch.to``)."""
    L = cfg.num_layers
    if L != len(batch.fanouts):
        raise ValueError(f"{L} layers but fanouts {batch.fanouts}")
    sizes = frontier_sizes(batch.batch_size, batch.fanouts)
    x = x0.to(params["w1"].dtype)
    # layer 1 consumes hop L (innermost), layer L consumes hop 1
    for layer in range(1, L + 1):
        hop = L - layer
        n_dst = sizes[hop]
        fanout = batch.fanouts[hop]
        x_self = x[:n_dst]
        x_nbr = x[n_dst:]
        if cfg.model == "gcn":
            sdeg = batch.hop_src_deg[hop].to(x.dtype)
            ddeg = batch.hop_dst_deg[hop].to(x.dtype)
            norm = 1.0 / torch.sqrt((sdeg + 1.0) * (ddeg + 1.0))
            # unbiased estimate of the true-neighbourhood sum
            w_edge = norm * (ddeg / fanout)
            self_w = 1.0 / (ddeg.reshape(n_dst, fanout)[:, 0] + 1.0)
        else:
            w_edge = None
            self_w = None
        if cfg.impl == "kernel_fused":
            h = _fused_layer(params, cfg, layer, x_self, x_nbr, w_edge,
                             self_w, fanout)
        else:
            agg = _aggregate(cfg, x_nbr, w_edge, n_dst, fanout)
            if cfg.model == "gcn":
                a = agg + x_self * self_w[:, None]
            else:
                a = torch.cat([x_self, agg], dim=-1)
            h = a @ params[f"w{layer}"] + params[f"b{layer}"]
        x = torch.relu(h) if layer < L else h
    return x


def loss_fn(params: Params, cfg: GNNConfig, batch: MiniBatch,
            x0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean negative log-likelihood, accuracy) of the batch targets."""
    logits = forward(params, cfg, batch, x0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = batch.labels.long()
    nll = -logp.gather(1, labels[:, None]).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return nll, acc
