"""Per-cell (arch x shape x mesh) steps, arguments and layouts for the
dry-run (port of ``repro/launch/cellspecs.py``).

Nothing here holds real memory: a ``Cell`` builds the parameters, the
AdamW state, the batch and the decode cache under a ``FakeTensorMode``
(the counterpart of ``jax.eval_shape``), as DTensors laid out by the rule
tables (``dist.params_shardings`` and the rules below), and runs its step
under the ambient mesh and policy.  The rules are functions of a leaf's
name and shape, equal to the reference's on every leaf.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Mapping, Sequence

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import distribute_tensor

from ..configs import ShapeSpec, input_specs
from ..dist import (Spec, axis_sizes, constrain, current_policy, pspec,
                    shard_params, to_placements, use_mesh, use_policy)
from ..models import (ModelConfig, init_decode_cache, init_params,
                      make_prefill_step, make_serve_step, make_train_step)
from ..optim import adamw

__all__ = ["Cell", "build_cell", "microbatch_ladder"]


def _dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return sizes.get("pod", 1) * sizes.get("data", 1)


def _batch_shardable(global_batch: int, mesh) -> bool:
    return global_batch % _dp_size(mesh) == 0


def _batch_pspecs(cfg: ModelConfig, shape: ShapeSpec, mesh,
                  batch: Mapping[str, Any]) -> Dict[str, Spec]:
    """The data inputs: the batch dim over (pod, data) when it divides."""
    bdim = ("pod", "data") if _batch_shardable(shape.global_batch, mesh) \
        else None
    with use_mesh(mesh):
        return {k: pspec(bdim, *([None] * (len(v.shape) - 1)))
                for k, v in batch.items()}


def _cache_pspec(name: str, leaf_shape: Sequence[int], cfg: ModelConfig,
                 shape: ShapeSpec, mesh) -> Spec:
    """Decode-cache leaf ``name`` of shape ``leaf_shape`` (stacked over
    layers, as in the reference).  Reads the ambient policy."""
    bshard = _batch_shardable(shape.global_batch, mesh)
    msize = axis_sizes(mesh).get("model", 1)
    nd = len(leaf_shape)
    b_ax = ("pod", "data") if bshard else None
    seq_ax = None if bshard else ("pod", "data")

    def spec(*tail) -> Spec:
        with use_mesh(mesh):
            return pspec(*([None] * (nd - len(tail))), *tail)

    if name in ("k", "v"):            # [..., B, C, Hkv, hd]
        h_ax = "model" if leaf_shape[-2] % msize == 0 else None
        c_ax: Any = None
        if not bshard and leaf_shape[-3] % 32 == 0:
            c_ax = seq_ax            # long_500k: batch 1, split the stream
        elif h_ax is None and leaf_shape[-3] % msize == 0:
            # kv heads do not divide |model|: split the cache length over
            # it (split-KV), or 32k-token caches replicate
            c_ax = "model"
        if current_policy() == "serve2d":
            # the batch keeps only 'pod'; 'data' splits the cache length
            c_ax = (("data", c_ax) if isinstance(c_ax, str)
                    else ("data",) if c_ax is None else c_ax)
        return spec(b_ax, c_ax, h_ax, None)
    if name == "conv":                # [..., B, conv_dim, K]
        c_ax = "model" if leaf_shape[-2] % msize == 0 else None
        return spec(b_ax, c_ax, None)
    if name in ("h", "s"):            # [..., B, H, P, N] / [..., B, H, K, V]
        h_ax = "model" if leaf_shape[-3] % msize == 0 else None
        return spec(b_ax, h_ax, None, None)
    if name in ("tm_x", "cm_x"):      # [..., B, d]
        d_ax = "model" if leaf_shape[-1] % msize == 0 else None
        return spec(b_ax, d_ax)
    return spec()                     # slot_pos, pos: replicated


def _prefill_out_pspec(name: str, leaf_shape: Sequence[int],
                       cfg: ModelConfig, shape: ShapeSpec, mesh) -> Spec:
    """A prefill output's cache leaf: ``attn_kv``'s [L, B, S, Hkv, hd]."""
    bshard = _batch_shardable(shape.global_batch, mesh)
    b_ax = ("pod", "data") if bshard else None
    msize = axis_sizes(mesh).get("model", 1)
    nd = len(leaf_shape)
    with use_mesh(mesh):
        if name == "attn_kv" and nd >= 4:
            h_ax = "model" if leaf_shape[-2] % msize == 0 else None
            # split-KV: kv heads that do not divide |model| give it the
            # sequence instead
            s_ax = ("model" if h_ax is None and leaf_shape[-3] % msize == 0
                    else None)
            return pspec(*([None] * (nd - 4)), b_ax, s_ax, h_ax, None)
        return pspec(*([None] * nd))


def microbatch_ladder(shape: ShapeSpec, mesh):
    """Valid gradient-accumulation factors for a train cell: n divides the
    global batch and keeps each microbatch shardable."""
    if shape.step != "train":
        return [1]
    dp = _dp_size(mesh)
    out = [n for n in (1, 2, 4, 8, 16)
           if shape.global_batch % n == 0
           and (shape.global_batch // n) % dp == 0]
    return out or [1]


def _distribute(t: torch.Tensor, mesh, spec: Spec):
    return distribute_tensor(t, mesh, to_placements(mesh, spec),
                             src_data_rank=None)


def _cache_leaves(cache) -> Dict[str, torch.Tensor]:
    """``{"<group>.<field>": tensor}`` of a decode cache's dataclasses."""
    return {f"{group}.{f.name}": getattr(c, f.name)
            for group, c in cache.items() for f in dataclasses.fields(c)}


class Cell:
    """One (arch x shape x mesh) cell, its fake arguments laid out as the
    reference lays them out, and its step."""

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec, mesh,
                 microbatches: int = 1, policy: str = "tp2d",
                 device: str = "cpu"):
        self.cfg, self.shape, self.mesh = cfg, shape, mesh
        self.microbatches, self.policy = microbatches, policy
        self.fake = FakeTensorMode()
        with self.fake, use_mesh(mesh), use_policy(policy):
            model = init_params(cfg, torch.Generator().manual_seed(0),
                                device)
            self.p_shard = shard_params(model, mesh)
            batch = input_specs(cfg, shape, device)
            bspec = _batch_pspecs(cfg, shape, mesh, batch)
            self.batch = {k: _distribute(v, mesh, bspec[k])
                          for k, v in batch.items()}
            self.model = model
            if shape.step == "train":
                opt = adamw(3e-4)
                self.opt_state = opt.init(dict(model.named_parameters()))
                self.fn = make_train_step(cfg, opt,
                                          microbatches=microbatches)
                self.args = (model, self.opt_state, self.batch)
            elif shape.step == "prefill":
                self.fn = make_prefill_step(cfg)
                self.args = (model, self.batch)
            else:
                cache = init_decode_cache(cfg, shape.global_batch,
                                          shape.seq_len, device)
                for group, c in cache.items():
                    for f in dataclasses.fields(c):
                        t = getattr(c, f.name)
                        setattr(c, f.name, _distribute(t, mesh, _cache_pspec(
                            f.name, t.shape, cfg, shape, mesh)))
                self.cache = cache
                self.fn = make_serve_step(cfg)
                self.args = (model, cache, self.batch)

    def arg_tensors(self) -> Dict[str, torch.Tensor]:
        """Every tensor argument of the step by name (parameters, AdamW
        moments, batch, decode cache)."""
        out = {f"params.{k}": p for k, p in self.model.named_parameters()}
        if self.shape.step == "train":
            for group in ("m", "v"):
                out.update({f"opt.{group}.{k}": t
                            for k, t in self.opt_state[group].items()})
        out.update({f"batch.{k}": t for k, t in self.batch.items()})
        if self.shape.step == "decode":
            out.update({f"cache.{k}": t
                        for k, t in _cache_leaves(self.cache).items()})
        return out

    def run(self, *modes):
        """One step under the fake mode (then ``modes``, dispatch modes that
        see its ops), the mesh and the policy; the outputs laid out as the
        reference's ``out_shardings`` lay them."""
        with contextlib.ExitStack() as stack:
            stack.enter_context(self.fake)
            for m in modes:
                stack.enter_context(m)
            stack.enter_context(use_mesh(self.mesh))
            stack.enter_context(use_policy(self.policy))
            out = self.fn(*self.args)
            if self.shape.step == "train":
                return out
            b_ax = ("pod", "data") if _batch_shardable(
                self.shape.global_batch, self.mesh) else None
            logits = constrain(out[0], b_ax, None, "model")
            caches = out[1]
            if self.shape.step == "prefill" and caches is not None:
                caches = {name: tuple(
                    t.redistribute(self.mesh, to_placements(
                        self.mesh, _prefill_out_pspec(
                            name, t.shape, self.cfg, self.shape, self.mesh)))
                    for t in kv) for name, kv in caches.items()}
            return logits, caches

    def out_tensors(self, out) -> list:
        """The step's output tensors: the updated parameters, AdamW state
        and metrics; or the logits and caches."""
        if self.shape.step == "train":
            _, state, metrics = out
            return (list(self.model.parameters())
                    + [t for g in ("m", "v") for t in state[g].values()]
                    + list(metrics.values()))
        logits, caches = out
        if caches is None:
            return [logits]
        if self.shape.step == "decode":
            return [logits, *_cache_leaves(caches).values()]
        return [logits, *(t for kv in caches.values() for t in kv)]


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
               microbatches: int = 1, policy: str = "tp2d",
               device: str = "cpu") -> Cell:
    return Cell(cfg, shape, mesh, microbatches=microbatches, policy=policy,
                device=device)
