"""Peer feature exchange of the sharded hot-feature plane.

Port of the peer half of ``repro/dist/collectives.py``.  Each accelerator
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
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import torch

from ..kernels.ops import gather_rows

__all__ = ["exchange_peer_rows", "peer_gather_rows", "ring_order"]


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
