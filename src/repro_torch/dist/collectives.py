"""Peer feature exchange of the sharded hot-feature plane, and the
hierarchical gradient mean over a device mesh.

Port of ``repro/dist/collectives.py``.  Each accelerator
pins a disjoint hot shard (``graph.featcache.ShardedFeatureCache``); a
frontier row that misses locally but is resident on a peer shard is served
by one gather on the peer's device (``kernels.ops.gather_rows``: K1, or K4
at ``pipeline_depth`` 2..4) plus one hop of only those rows to the reader's
device, instead of a host ship.  ``exchange_peer_rows`` walks the requests
in the deterministic ring order (me+1, me+2, ..., wrap) that every trainer
derives identically, so the combined transfer-source layout is
reproducible.

The gather runs on the owner's card and its current stream, whatever card
the caller is on (``kernels.ops`` launches every kernel on its tensor's
device).  The hop is ``.to(dest, non_blocking=True)`` under the caller's
current stream (the trainer's transfer stream).  With logical accelerators
sharing one card it is a no-op; across cards PyTorch runs the copy on the
owner's stream after the gather and makes the reader's stream wait for it
(``tests/test_torch_cuda.py`` checks this on two cards).

``hierarchical_psum_mean`` averages each rank's tensors over the ambient
``DeviceMesh`` in the reference's three steps: a reduce-scatter inside the
pod (the mesh dims other than ``pod``), an all-reduce across pods, an
all-gather inside the pod.
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from ..kernels.ops import gather_rows

__all__ = ["exchange_peer_rows", "hierarchical_psum_mean",
           "peer_gather_rows", "ring_order"]


def ring_order(n: int, me: int) -> List[int]:
    """The other ``n - 1`` ordinals as seen from ``me``: (me+1) % n,
    (me+2) % n, ...  Step s pairs every trainer with a distinct peer, and
    every participant derives the same global schedule locally."""
    n = int(n)
    me = int(me) % max(n, 1)
    return [(me + s) % n for s in range(1, n)]


def peer_gather_rows(block: torch.Tensor, slots, dest_device,
                     pipeline_depth: int = 1) -> torch.Tensor:
    """Serve one peer request: gather ``slots`` rows out of the owner
    shard's device block on the owner's device and current stream, then
    move only those rows to ``dest_device``.  On a card the block is marked
    as used by that stream, so its memory is not reused before the gather
    ran even if its version retires meanwhile."""
    if block.is_cuda:
        block.record_stream(torch.cuda.current_stream(block.device))
    rows = gather_rows(block, slots, pipeline_depth)
    return rows.to(torch.device(dest_device), non_blocking=True)


def exchange_peer_rows(requests: Sequence[Tuple[int, Any, int]],
                       block_of: Callable[[int, int], torch.Tensor],
                       dest_device,
                       pipeline_depth: int = 1) -> List[torch.Tensor]:
    """Pull the requested rows from each peer shard, in the ring order the
    requests were built in.

    ``requests`` is one trainer's ``ShardLookup.peer_requests`` (peer
    ordinal, slots into the peer block, peer version) and ``block_of(peer,
    version)`` resolves the peer shard's device block at the pinned version
    (``FeatureCache.data_on``, which makes the reader's stream wait for the
    commit that wrote it; the caller holds the pins).  Returns one row block
    per request, in request order: the leading segments of the combined
    transfer source the union lookup's ``miss_index`` addresses."""
    return [peer_gather_rows(block_of(int(peer), int(version)), slots,
                             dest_device, pipeline_depth)
            for peer, slots, version in requests]


def _group(mesh, dims: Tuple[str, ...]):
    """The process group over mesh dims ``dims`` (flattened when several)."""
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    sub = mesh if tuple(mesh.mesh_dim_names) == dims else mesh[dims]
    return sub._flatten("_".join(dims)).get_group()


def hierarchical_psum_mean(tree: Any) -> Any:
    """The mean over the ambient mesh's ranks of each rank's ``tree`` (a
    pytree of tensors, the same structure and shapes on every rank), each
    leaf cast back to its dtype.  A leaf whose dim 0 the pod's size divides
    goes reduce-scatter inside the pod, all-reduce across pods, all-gather
    inside the pod; any other leaf takes one all-reduce over the mesh.  The
    identity with no mesh or a mesh of one rank."""
    from . import axis_sizes, current_mesh
    mesh = current_mesh()
    sizes = axis_sizes(mesh)
    n_total = 1
    for n in sizes.values():
        n_total *= n
    if n_total == 1:
        return tree
    names = tuple(mesh.mesh_dim_names)
    local = tuple(n for n in names if n != "pod")
    local_size = 1
    for n in local:
        local_size *= sizes[n]
    groups: dict = {}

    def group(dims: Tuple[str, ...]):
        # each group made once a call, and only where a leaf needs it
        if dims not in groups:
            groups[dims] = _group(mesh, dims)
        return groups[dims]

    leaves, spec = pytree.tree_flatten(tree)
    out = []
    for v in leaves:
        if local and local_size > 1 and v.dim() >= 1 \
                and v.shape[0] % local_size == 0:
            part = torch.empty((v.shape[0] // local_size, *v.shape[1:]),
                               dtype=v.dtype, device=v.device)
            dist.reduce_scatter_tensor(part, v.contiguous(),
                                       group=group(local))
            if "pod" in sizes:
                dist.all_reduce(part, group=group(("pod",)))
            s = torch.empty_like(v)
            dist.all_gather_into_tensor(s, part, group=group(local))
        else:
            s = v.clone()
            dist.all_reduce(s, group=group(names))
        out.append((s / n_total).to(v.dtype))
    return pytree.tree_unflatten(out, spec)
