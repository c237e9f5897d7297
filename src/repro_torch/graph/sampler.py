"""Mini-batch Sampler (paper Section III-A).

Port of ``repro/graph/sampler.py``: the GraphSAGE neighbor sampler (uniform
with replacement, zero-degree nodes fall back to self-loops) with two
interchangeable backends:

* ``NumpySampler`` -- vectorized numpy on the host, the paper's "Sampling
  on CPU".  For the same seed its batches are bit-equal to the reference's.
* ``sample_minibatch_torch`` -- torch ops on the device that holds the CSR,
  the paper's "Sampling on Accelerator" (the reference's
  ``sample_minibatch_jax``).  Its draws come from a ``torch.Generator``, not
  threefry, so it agrees with the reference in distribution and layout,
  not bit for bit.

A host ``MiniBatch`` holds numpy arrays and a device one torch tensors;
``to(device)`` gives either as tensors on a device.  The reference runs JAX
with x64 off, so its ids and degrees are int32: the port keeps exact int64
ids (what the loader gathers by) and ships degrees as int32 and labels as
int64 (the dtype ``torch.gather`` indexes with).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from ..device import to_device
from .storage import CSRGraph

__all__ = ["MiniBatch", "NumpySampler", "sample_minibatch_torch",
           "frontier_sizes"]

Array = Union[np.ndarray, torch.Tensor]
_NP = {torch.int64: np.int64, torch.int32: np.int32}


@dataclasses.dataclass
class MiniBatch:
    """A fixed-shape L-hop sampled block structure.

    ``frontier(l)`` = concat(targets, hop_src[0], ..., hop_src[l-1]); hop
    ``l`` (1-based) has ``len(frontier[l-1]) * fanout[l-1]`` edges, dst local
    index ``i // fanout``, src local index ``len(frontier[l-1]) + i``.
    """

    targets: Array               # [B]
    labels: Array                # [B]
    hop_src: Tuple[Array, ...]   # hop l: sampled source global ids
    hop_src_deg: Tuple[Array, ...]  # true degree of each sampled source
    hop_dst_deg: Tuple[Array, ...]  # true degree of each edge's dst
    fanouts: Tuple[int, ...]

    @property
    def batch_size(self) -> int:
        return int(self.targets.shape[0])

    def frontier(self, l: int) -> Array:
        """Global ids of frontier ``l`` (0 = targets), concatenated layout."""
        parts = [self.targets] + list(self.hop_src[:l])
        if len(parts) == 1:
            return self.targets
        if isinstance(self.targets, torch.Tensor):
            return torch.cat(parts)
        return np.concatenate(parts)

    def num_frontier(self, l: int) -> int:
        return frontier_sizes(self.batch_size, self.fanouts)[l]

    def edges_traversed(self) -> int:
        """Total sampled edges (the paper's MTEPS numerator, Eq. 5)."""
        return sum(int(s.shape[0]) for s in self.hop_src)

    def to(self, device: torch.device) -> "MiniBatch":
        """The batch as tensors on ``device``: host arrays through pinned,
        non-blocking copies on CUDA; a device batch's tensors copied (or
        kept, on their own device) with the same dtypes."""
        def put(a: Array, dtype: torch.dtype) -> torch.Tensor:
            if isinstance(a, torch.Tensor):
                return a.to(device=device, dtype=dtype)
            return to_device(np.ascontiguousarray(a, dtype=_NP[dtype]),
                             device)

        return MiniBatch(
            targets=put(self.targets, torch.int64),
            labels=put(self.labels, torch.int64),
            hop_src=tuple(put(s, torch.int64) for s in self.hop_src),
            hop_src_deg=tuple(put(d, torch.int32) for d in self.hop_src_deg),
            hop_dst_deg=tuple(put(d, torch.int32) for d in self.hop_dst_deg),
            fanouts=self.fanouts)

    def record_stream(self, stream) -> None:
        """Mark a device batch's tensors as used by ``stream``, so the
        caching allocator keeps their memory until the work ``stream``
        queued on them has run."""
        for t in (self.targets, self.labels, *self.hop_src,
                  *self.hop_src_deg, *self.hop_dst_deg):
            t.record_stream(stream)


def frontier_sizes(batch: int, fanouts: Sequence[int]) -> Tuple[int, ...]:
    """frontier l size = batch * prod_{h<l}(1 + f_h)."""
    out = [batch]
    cur = batch
    for f in fanouts:
        cur = cur * (1 + f)
        out.append(cur)
    return tuple(out)


class NumpySampler:
    """Host-side vectorized neighbor sampler (paper's CPU Sampler thread)."""

    def __init__(self, graph: CSRGraph, fanouts: Sequence[int] = (25, 10),
                 seed: int = 0):
        self.graph = graph
        self.fanouts = tuple(int(f) for f in fanouts)
        self._rng = np.random.default_rng(seed)
        self._deg = np.diff(graph.indptr)

    def _sample_hop(self, frontier: np.ndarray, fanout: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        deg = self._deg[frontier]
        safe_deg = np.maximum(deg, 1)
        r = self._rng.integers(0, 1 << 31,
                               size=(frontier.shape[0], fanout))
        offs = (r % safe_deg[:, None]) + self.graph.indptr[frontier][:, None]
        src = self.graph.indices[offs].astype(np.int64)
        src = np.where(deg[:, None] == 0, frontier[:, None], src)
        return src.reshape(-1), deg

    def sample(self, targets: np.ndarray, labels: np.ndarray) -> MiniBatch:
        frontier = np.asarray(targets, dtype=np.int64)
        hop_src, hop_sdeg, hop_ddeg = [], [], []
        for f in self.fanouts:
            src, dst_deg = self._sample_hop(frontier, f)
            hop_src.append(src)
            hop_ddeg.append(np.repeat(dst_deg, f))
            hop_sdeg.append(self._deg[src])
            frontier = np.concatenate([frontier, src])
        return MiniBatch(
            targets=np.asarray(targets, np.int64),
            labels=np.asarray(labels, np.int32),
            hop_src=tuple(hop_src),
            hop_src_deg=tuple(hop_sdeg),
            hop_dst_deg=tuple(hop_ddeg),
            fanouts=self.fanouts,
        )


def sample_minibatch_torch(generator: torch.Generator, indptr: torch.Tensor,
                           indices: torch.Tensor, targets: torch.Tensor,
                           labels: torch.Tensor,
                           fanouts: Sequence[int]) -> MiniBatch:
    """The sampler on the device that holds the CSR (``indptr`` int64,
    ``indices``), the paper's "Sampling on Accelerator": the semantics of
    ``NumpySampler`` and of the reference's ``sample_minibatch_jax``.  Each
    hop draws ``randint(0, 1 << 30)`` per edge from ``generator`` (the
    reference's range; the host sampler's is ``1 << 31``), picks neighbour
    ``r % max(deg, 1)`` of its destination, takes the destination itself
    where its degree is 0, and appends the sources to the frontier.  Ids
    and labels come back int64, degrees int32, on the CSR's device."""
    dev = indptr.device
    deg_all = indptr[1:] - indptr[:-1]
    frontier = targets.to(device=dev, dtype=torch.int64)
    hop_src, hop_sdeg, hop_ddeg = [], [], []
    for f in fanouts:
        deg = deg_all[frontier]
        r = torch.randint(0, 1 << 30, (frontier.shape[0], f),
                          generator=generator, device=dev, dtype=torch.int64)
        offs = r % deg.clamp(min=1)[:, None] + indptr[frontier][:, None]
        # a zero-degree destination reads edge 0 (its row may start at
        # num_edges, past the end) and takes the self-loop below
        alone = (deg == 0)[:, None]
        offs = offs.masked_fill(alone, 0)
        src = torch.where(alone, frontier[:, None],
                          indices[offs].to(torch.int64)).reshape(-1)
        hop_src.append(src)
        hop_sdeg.append(deg_all[src].to(torch.int32))
        hop_ddeg.append(deg.to(torch.int32).repeat_interleave(f))
        frontier = torch.cat([frontier, src])
    return MiniBatch(
        targets=targets.to(device=dev, dtype=torch.int64),
        labels=labels.to(device=dev, dtype=torch.int64),
        hop_src=tuple(hop_src), hop_src_deg=tuple(hop_sdeg),
        hop_dst_deg=tuple(hop_ddeg), fanouts=tuple(int(f) for f in fanouts))
