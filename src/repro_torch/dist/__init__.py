"""Sharding context and constraint helpers (port of ``repro/dist``).

The model code never names placements: layers call ``constrain`` /
``constrain_act`` / ``constrain_proj`` with *logical* axis tuples (e.g.
``("pod", "data")`` for the batch dim) and this module decides what
survives on the ambient ``DeviceMesh``, with the reference's rules:

  * axes absent from the mesh are dropped (with no mesh, or a mesh of one
    rank, every constraint is the identity),
  * a mesh axis is used at most once in a spec (first occurrence wins),
  * a dim whose size the axes' product does not divide is replicated.

A spec is a tuple with one entry per tensor dim: ``None``, an axis name, or
a tuple of names (the reference's ``PartitionSpec`` entries).
``to_placements`` maps it onto DTensor placements, one per mesh dim:
``Shard(d)`` where the mesh dim's name sits in entry ``d``, else
``Replicate()``.  A tensor dim spread over several mesh dims is split by
them in mesh order (the first one major), as JAX splits a dim over an axis
tuple written in mesh order, which every spec of the reference is.

``constrain*`` redistribute a DTensor to those placements (the reference's
``with_sharding_constraint``); a plain tensor passes through.  The mesh and
the policy (``"tp2d"``, ``"dp"``, ``"serve2d"``, ``"ep"``) are ambient
context per thread (``use_mesh`` / ``use_policy``), so one model source
runs as pure DP, FSDP x TP, weight-stationary decode or expert parallel.
"""
from __future__ import annotations

import contextlib
import threading
from typing import (Any, Callable, Dict, Iterator, List, Mapping,
                    Optional, Sequence, Tuple, Union)

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)

from .collectives import (exchange_peer_rows, hierarchical_psum_mean,
                          peer_gather_rows, ring_order)

__all__ = [
    "use_mesh", "current_mesh", "use_policy", "current_policy",
    "carry_context", "axis_sizes", "pspec", "to_placements", "spec_of",
    "constrain_spec", "proj_dims",
    "act_dims", "act_serve_dims", "constrain", "constrain_act",
    "constrain_act_serve", "constrain_proj", "constrain_proj_serve",
    "params_shardings", "shard_params", "shard_batch",
    "shard_map_compat", "local_shards", "exchange_peer_rows",
    "hierarchical_psum_mean", "peer_gather_rows", "ring_order",
]

AxisDim = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisDim, ...]

_ctx = threading.local()


def _stack(name: str) -> list:
    st = getattr(_ctx, name, None)
    if st is None:
        st = []
        setattr(_ctx, name, st)
    return st


def current_mesh():
    """The ambient ``DeviceMesh`` set by ``use_mesh`` (None without one)."""
    st = _stack("mesh")
    return st[-1] if st else None


def current_policy() -> str:
    """The ambient parallelism policy ('tp2d' | 'dp' | 'serve2d' | 'ep')."""
    st = _stack("policy")
    return st[-1] if st else "tp2d"


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[Any]:
    """Set the ambient mesh; ``use_mesh(None)`` is a no-op, so callers wrap
    one-process paths unconditionally.  Under a mesh a plain tensor meeting
    a DTensor reads as replicated (``implicit_replication``): the model's
    index ramps and masks are built on every rank alike."""
    outer = current_mesh()
    _stack("mesh").append(mesh)
    try:
        # entered once (the outermost mesh): leaving it switches it off
        with (implicit_replication() if mesh is not None and outer is None
              else contextlib.nullcontext()):
            yield mesh
    finally:
        _stack("mesh").pop()


@contextlib.contextmanager
def use_policy(policy: str) -> Iterator[str]:
    _stack("policy").append(policy)
    try:
        yield policy
    finally:
        _stack("policy").pop()


def carry_context(fn: Callable) -> Callable:
    """``fn`` bound to the mesh and policy ambient now: it runs under them
    whatever thread calls it.  A rematerialised forward runs in the
    backward, which autograd runs in its own thread for CUDA tensors, where
    this module's thread-local context is empty."""
    mesh, policy = current_mesh(), current_policy()

    def run(*args, **kwargs):
        with use_mesh(mesh), use_policy(policy):
            return fn(*args, **kwargs)

    return run


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (empty for None)."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _mesh_size(mesh) -> int:
    size = 1
    for n in axis_sizes(mesh).values():
        size *= n
    return size


# ------------------------------------------------------------------- pspec


def _norm_dim(dim: AxisDim, names: Sequence[str], used: set) -> AxisDim:
    """One spec entry filtered against the mesh's axes and those used."""
    if dim is None or not names:
        return None
    cand = (dim,) if isinstance(dim, str) else tuple(dim)
    kept = tuple(n for n in cand if n in names and n not in used)
    used.update(kept)
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else kept


def pspec(*dims: AxisDim) -> Spec:
    """A spec against the ambient mesh: absent axes dropped, each axis used
    once (first occurrence wins); all ``None`` with no mesh."""
    names = tuple(axis_sizes(current_mesh()))
    used: set = set()
    return tuple(_norm_dim(d, names, used) for d in dims)


def _axes_size(mesh, dim: AxisDim) -> int:
    if dim is None:
        return 1
    sizes = axis_sizes(mesh)
    size = 1
    for n in ((dim,) if isinstance(dim, str) else dim):
        size *= sizes[n]
    return size


def _fit_spec(mesh, shape: Sequence[int], spec: Spec) -> Spec:
    """Entries that do not divide their dim's size become None."""
    full = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d if d is None or size % _axes_size(mesh, d) == 0 else None
                 for size, d in zip(shape, full))


def to_placements(mesh, spec: Spec) -> Tuple[Any, ...]:
    """One placement per mesh dim: ``Shard(d)`` where the dim's name is in
    entry ``d`` of ``spec``, else ``Replicate()`` (also for a mesh dim of
    size 1, where the two lay the data out alike)."""
    out = []
    for name, size in zip(mesh.mesh_dim_names, mesh.shape):
        dim = next((d for d, e in enumerate(spec) if e is not None and (
            e == name if isinstance(e, str) else name in e)), None)
        out.append(Replicate() if dim is None or size == 1 else Shard(dim))
    return tuple(out)


def spec_of(t: DTensor) -> Spec:
    """The spec a DTensor's placements give (``to_placements`` inverted):
    for each dim, the mesh axes that shard it, in mesh order."""
    dims: list = [[] for _ in range(t.dim())]
    for name, p in zip(t.device_mesh.mesh_dim_names, t.placements):
        if isinstance(p, Shard):
            dims[p.dim].append(name)
    return tuple(None if not d else d[0] if len(d) == 1 else tuple(d)
                 for d in dims)


# --------------------------------------------------------------- constrain


def _active(x) -> Optional[Any]:
    """The mesh a constraint applies to, or None for the identity."""
    mesh = current_mesh()
    if mesh is None or _mesh_size(mesh) == 1 or not isinstance(x, DTensor):
        return None
    return mesh


def constrain_spec(mesh, shape: Sequence[int], *dims: AxisDim) -> Spec:
    """The spec ``constrain`` applies on ``mesh`` to a tensor of ``shape``:
    ``dims`` against the mesh, fitted to the shape."""
    with use_mesh(mesh):
        return _fit_spec(mesh, shape, pspec(*dims))


def constrain(x: torch.Tensor, *dims: AxisDim) -> torch.Tensor:
    """Redistribute a DTensor to the spec ``dims`` fitted to its shape; the
    identity with no mesh, a mesh of one rank, or a plain tensor."""
    mesh = _active(x)
    if mesh is None:
        return x
    placements = to_placements(mesh, constrain_spec(mesh, x.shape, *dims))
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def proj_dims(mesh, n_heads: int) -> Spec:
    """``constrain_proj``'s dims: the head dim over ``model`` only when the
    head count divides it."""
    msize = axis_sizes(mesh).get("model", 1)
    h_ax = "model" if msize > 1 and n_heads % msize == 0 else None
    return (("pod", "data"), None, h_ax)


def act_dims(mesh, shape: Sequence[int]) -> Spec:
    """``constrain_act``'s dims for a [B, S, ...] tensor under the ambient
    policy: tp2d puts the batch over (pod, data) and the sequence over
    model; a batch the dp axes do not divide gives them to the sequence;
    'dp' shards the batch only."""
    policy = current_policy()
    names = axis_sizes(mesh)
    dp_size = _axes_size(mesh, tuple(n for n in ("pod", "data")
                                     if n in names))
    if shape[0] % max(dp_size, 1) == 0:
        b_ax: AxisDim = ("pod", "data")
        s_ax: AxisDim = None if policy == "dp" else "model"
    else:
        b_ax = None
        s_ax = (("pod", "data") if policy == "dp"
                else ("pod", "data", "model"))
    return (b_ax, s_ax, *([None] * (len(shape) - 2)))


def act_serve_dims(ndim: int) -> Spec:
    """``constrain_act_serve``'s dims: the batch over pod only under
    'serve2d' (data splits the KV cache's length), else over (pod, data)."""
    b_ax: AxisDim = (("pod",) if current_policy() == "serve2d"
                     else ("pod", "data"))
    return (b_ax, *([None] * (ndim - 1)))


def constrain_proj(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Attention projections [B, S, H*hd] (``proj_dims``)."""
    mesh = _active(x)
    return x if mesh is None else constrain(x, *proj_dims(mesh, n_heads))


def constrain_act(x: torch.Tensor) -> torch.Tensor:
    """Block-boundary activations [B, S, d] (``act_dims``)."""
    mesh = _active(x)
    if mesh is None or x.dim() < 3:
        return x
    return constrain(x, *act_dims(mesh, x.shape))


def constrain_act_serve(x: torch.Tensor) -> torch.Tensor:
    """Decode activations [B, 1, d] (``act_serve_dims``)."""
    if _active(x) is None:
        return x
    return constrain(x, *act_serve_dims(x.dim()))


def constrain_proj_serve(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Decode projections [B, 1, H*hd]: the batch as in
    ``constrain_act_serve``, the head dim as in ``constrain_proj``.  The
    reference has no constraint here; DTensor needs one, since it cannot
    split a dim sharded by a non-divisor of the heads into [H, hd]."""
    mesh = _active(x)
    if mesh is None:
        return x
    return constrain(x, act_serve_dims(3)[0], None,
                     proj_dims(mesh, n_heads)[2])


# ------------------------------------------------------- parameter shardings


def params_shardings(named: Mapping[str, torch.Tensor],
                     mesh) -> Dict[str, Tuple[Any, ...]]:
    """``{name: placements}`` for parameters (or optimizer-state leaves
    under the same names): ``sharding.param_pspec`` leaf by leaf."""
    from .sharding import param_pspec, stack_sizes
    stacks = stack_sizes(named)
    with use_mesh(mesh):
        return {k: to_placements(mesh, param_pspec(k, t, stacks.get(k, ())))
                for k, t in named.items()}


def shard_params(model: torch.nn.Module, mesh) -> Dict[str, Tuple[Any, ...]]:
    """Replace each parameter of ``model`` by a DTensor laid out by
    ``params_shardings`` and return the placements.  Every rank holds the
    same full values and keeps its own shard (no communication)."""
    named = dict(model.named_parameters())
    placements = params_shardings(named, mesh)
    for name, p in named.items():
        mod, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(mod), leaf, torch.nn.Parameter(
            distribute_tensor(p.detach(), mesh, placements[name],
                              src_data_rank=None),
            requires_grad=p.requires_grad))
    return placements


def shard_batch(batch: Mapping[str, torch.Tensor],
                mesh) -> Dict[str, torch.Tensor]:
    """A batch every rank holds in full, as DTensors with the leading dim
    over (pod, data) where it divides; each rank keeps its rows."""
    out = {}
    with use_mesh(mesh):
        for k, v in batch.items():
            spec = _fit_spec(mesh, v.shape, pspec(("pod", "data")))
            out[k] = distribute_tensor(torch.as_tensor(v), mesh,
                                       to_placements(mesh, spec),
                                       src_data_rank=None)
    return out


# ---------------------------------------------------------------- shard_map


def local_shards() -> int:
    """How many distinct shards the innermost ``shard_map_compat`` region
    splits its inputs into (1 outside one), in its forward and in its
    backward: a cost counted per rank inside it, times this, is the
    region's global cost."""
    st = _stack("shards")
    return st[-1] if st else 1


class _RegionEdge(torch.autograd.Function):
    """Identity on a region's tensors whose backward enters (``push``, on
    the outputs) or leaves (on the inputs) the region's shard count, so the
    backward's ops inside the region read it too."""

    @staticmethod
    def forward(ctx, push: bool, shards: int, *ts):
        ctx.push, ctx.shards = push, shards
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.push:
            _stack("shards").append(ctx.shards)
        else:
            _stack("shards").pop()
        return (None, None, *grads)


def _edge(push: bool, shards: int, items):
    """``items`` with its grad-requiring tensors passed through a
    ``_RegionEdge`` (all of them through one node)."""
    items = list(items)
    idx = [i for i, t in enumerate(items)
           if isinstance(t, torch.Tensor) and t.requires_grad]
    if idx and torch.is_grad_enabled():
        for i, t in zip(idx, _RegionEdge.apply(push, shards,
                                               *(items[i] for i in idx))):
            items[i] = t
    return items


def shard_map_compat(f: Callable, mesh, in_specs: Sequence[Spec],
                     out_specs: Union[Spec, List[Spec]]) -> Callable:
    """``f`` on each rank's local shards (``local_map``): DTensor inputs
    are redistributed to ``in_specs`` (one per argument; a plain tensor
    argument is read as replicated first), ``f`` sees plain local
    tensors, and its output is read as a DTensor laid out by
    ``out_specs`` (a list of specs for a tuple of outputs).  Autograd
    flows through (``to_local`` / ``from_local`` are differentiable).  As
    in the reference, the caller fits the specs to the shapes."""
    in_pl = tuple(to_placements(mesh, s) for s in in_specs)
    replicate = tuple(Replicate() for _ in mesh.shape)
    # local_map reads a tuple as one entry per output, a list as one output
    out_pl = (tuple(to_placements(mesh, s) for s in out_specs)
              if isinstance(out_specs, list)
              else list(to_placements(mesh, out_specs)))
    sizes = list(mesh.shape)
    split = {i for pl in in_pl for i, p in enumerate(pl)
             if isinstance(p, Shard)}
    shards = 1
    for i in split:
        shards *= sizes[i]

    def counted(*args):
        args = _edge(False, shards, args)
        _stack("shards").append(shards)
        try:
            out = f(*args)
        finally:
            _stack("shards").pop()
        if isinstance(out, tuple):
            return tuple(_edge(True, shards, out))
        return _edge(True, shards, [out])[0]

    mapped = local_map(counted, out_placements=out_pl, in_placements=in_pl,
                       device_mesh=mesh, redistribute_inputs=True)

    def call(*args):
        # a plain tensor is the same on every rank (implicit replication):
        # read it as a replicated DTensor, so each rank takes its shard
        return mapped(*(DTensor.from_local(a, mesh, replicate,
                                           run_check=False)
                        if isinstance(a, torch.Tensor)
                        and not isinstance(a, DTensor) else a
                        for a in args))

    return call
