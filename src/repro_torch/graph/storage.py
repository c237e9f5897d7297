"""Graph storage: host-resident topology and the ``FeatureSource`` layer.

Port of ``repro/graph/storage.py`` (dense and hashed backends).  The paper
keeps the graph and its feature matrix in host memory (Section III-B);
device code only ever sees gathered mini-batch tensors.  Everything here is
numpy, and for the same seed every array is bit-identical to the reference.

The partitioned and out-of-core (mmap) backends are not ported yet
(ROADMAP, port queue): ``make_dataset`` raises ``NotImplementedError`` for
them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Protocol, Tuple

import numpy as np

__all__ = [
    "CSRGraph",
    "FeatureSource",
    "DenseFeatures",
    "HashedFeatures",
    "as_feature_source",
    "GraphDataset",
    "synth_powerlaw_graph",
    "make_dataset",
    "DATASET_STATS",
    "TRAIN_SPLIT",
]


@dataclasses.dataclass
class CSRGraph:
    """Compressed-sparse-row adjacency (out-neighbors), host resident."""

    indptr: np.ndarray   # int64 [num_nodes + 1]
    indices: np.ndarray  # int32/int64 [num_edges]

    @property
    def num_nodes(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def nbytes(self) -> int:
        return self.indptr.nbytes + self.indices.nbytes


class FeatureSource(Protocol):
    """Minimal host-side feature storage interface: ``take`` returns a fresh
    ``[len(rows), feat_dim]`` array in ``dtype`` for any int array of node
    ids (duplicates and arbitrary order allowed)."""

    shape: Tuple[int, int]

    @property
    def dtype(self) -> np.dtype: ...

    def take(self, rows: np.ndarray) -> np.ndarray: ...


class DenseFeatures:
    """FeatureSource over one materialized host ndarray."""

    def __init__(self, array: np.ndarray):
        if array.ndim != 2:
            raise ValueError(f"expected [N, F] features, got {array.shape}")
        self.array = array
        self.shape = tuple(array.shape)

    @property
    def dtype(self) -> np.dtype:
        return self.array.dtype

    @property
    def nbytes(self) -> int:
        return self.array.nbytes

    def take(self, rows: np.ndarray) -> np.ndarray:
        return np.take(self.array, np.asarray(rows, dtype=np.int64), axis=0)

    def __getitem__(self, rows):
        return self.take(np.atleast_1d(rows))


def as_feature_source(features) -> "FeatureSource":
    """Normalize a bare ndarray to the protocol."""
    if isinstance(features, np.ndarray):
        return DenseFeatures(features)
    if hasattr(features, "take") and hasattr(features, "shape"):
        return features
    raise TypeError(f"not a FeatureSource: {type(features)!r}")


class HashedFeatures:
    """Deterministic lazily-computed node features: each row is a
    splitmix-style hash of (node id, column, seed) mapped to [-1, 1), so a
    feature matrix too large to materialize is never built."""

    def __init__(self, num_nodes: int, feat_dim: int, seed: int = 0,
                 dtype=np.float32):
        self.shape = (num_nodes, feat_dim)
        self.dtype = np.dtype(dtype)
        self._seed = np.uint64((seed * 0x9E3779B97F4A7C15 + 0xDEADBEEF)
                               & 0xFFFFFFFFFFFFFFFF)
        self._cols = np.arange(feat_dim, dtype=np.uint64)

    @property
    def nbytes_virtual(self) -> int:
        return self.shape[0] * self.shape[1] * self.dtype.itemsize

    def take(self, rows: np.ndarray) -> np.ndarray:
        """Gather feature rows (vectorized splitmix-style hash -> [-1, 1))."""
        rows = np.asarray(rows, dtype=np.uint64)
        x = (rows[:, None] * np.uint64(0x9E3779B97F4A7C15)
             + self._cols[None, :] * np.uint64(0xBF58476D1CE4E5B9)
             + self._seed)
        x ^= x >> np.uint64(31)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(29)
        return ((x >> np.uint64(11)).astype(np.float64)
                / float(1 << 53) * 2.0 - 1.0).astype(self.dtype)

    def materialize(self, chunk_rows: int = 1 << 18) -> np.ndarray:
        """All rows as one array, hashed in chunks so the uint64/float64
        temporaries stay bounded (same bytes as ``take(arange(N))``)."""
        n, f = self.shape
        out = np.empty((n, f), dtype=self.dtype)
        for lo in range(0, n, chunk_rows):
            hi = min(lo + chunk_rows, n)
            out[lo:hi] = self.take(np.arange(lo, hi))
        return out

    def __getitem__(self, rows):
        return self.take(np.atleast_1d(rows))


@dataclasses.dataclass
class GraphDataset:
    name: str
    graph: CSRGraph
    features: "FeatureSource | np.ndarray"
    labels: np.ndarray          # int32 [num_nodes]
    num_classes: int
    feat_dim: int
    layer_dims: Tuple[int, int, int]   # (f0, f1, f2), Table III

    @property
    def num_nodes(self) -> int:
        return self.graph.num_nodes

    @property
    def num_edges(self) -> int:
        return self.graph.num_edges

    @property
    def feature_source(self) -> "FeatureSource":
        return as_feature_source(self.features)

    def take_features(self, rows: np.ndarray) -> np.ndarray:
        return self.feature_source.take(rows)

    def feature_hotness(self) -> np.ndarray:
        """Expected per-node gather frequency under neighbor sampling:
        in-edge mass (how often a node is a sampled neighbor) + 1 (a
        uniformly drawn batch target).  The hot cache ranks by it."""
        counts = np.bincount(
            np.asarray(self.graph.indices, dtype=np.int64),
            minlength=self.num_nodes).astype(np.float64)
        return counts + 1.0


def synth_powerlaw_graph(num_nodes: int, avg_degree: float,
                         seed: int = 0, hub_exponent: float = 2.5,
                         ) -> CSRGraph:
    """Vectorized synthetic power-law multigraph: Zipf-shaped out-degrees,
    destinations drawn toward hub nodes through ``floor(N * u**hub_exponent)``
    mapped by a random permutation.  O(E) time and memory."""
    rng = np.random.default_rng(seed)
    n = int(num_nodes)
    target_edges = int(round(n * avg_degree))
    raw = rng.pareto(1.3, size=n) + 1.0
    deg = np.maximum(1, np.round(raw * (target_edges / raw.sum()))
                     ).astype(np.int64)
    np.minimum(deg, max(8, n // 4), out=deg)
    m = int(deg.sum())
    u = rng.random(m)
    hub_rank = np.minimum((u ** hub_exponent * n).astype(np.int64), n - 1)
    perm = rng.permutation(n).astype(np.int64)
    dst = perm[hub_rank]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    idx_dtype = np.int32 if n < 2**31 else np.int64
    return CSRGraph(indptr=indptr, indices=dst.astype(idx_dtype))


# name -> (num_nodes, num_edges, f0, f1, f2, num_classes)   [Table III]
DATASET_STATS: Dict[str, Tuple[int, int, int, int, int, int]] = {
    "ogbn-products":    (2_449_029,    61_859_140,   100, 256,  47,  47),
    "ogbn-papers100M":  (111_059_956,  1_615_685_872, 128, 256, 172, 172),
    "mag240m-homo":     (121_751_666,  1_297_748_926, 756, 256, 153, 153),
}

# training-split sizes (OGB official splits; an "epoch" iterates these)
TRAIN_SPLIT: Dict[str, int] = {
    "ogbn-products": 196_615,
    "ogbn-papers100M": 1_207_179,
    "mag240m-homo": 1_112_392,
}


def make_dataset(name: str, scale: float = 1.0, seed: int = 0,
                 materialize_features: Optional[bool] = None,
                 feature_backend: str = "auto") -> GraphDataset:
    """Instantiate a (possibly scaled-down) Table-III dataset.

    ``scale`` shrinks |V| while keeping the average degree and the feature
    widths.  ``feature_backend``: ``"dense"`` | ``"hashed"`` | ``"auto"``
    (dense when the matrix fits 2 GiB).  ``"partitioned"`` and ``"mmap"``
    raise ``NotImplementedError``.
    """
    if name not in DATASET_STATS:
        raise KeyError(f"unknown dataset {name!r}; have {list(DATASET_STATS)}")
    if feature_backend in ("partitioned", "mmap"):
        raise NotImplementedError(
            f"feature_backend={feature_backend!r} is not ported yet "
            "(ROADMAP: port queue, out-of-core storage tier)")
    nv, ne, f0, f1, f2, ncls = DATASET_STATS[name]
    n = max(1000, int(nv * scale))
    avg_deg = ne / nv
    graph = synth_powerlaw_graph(n, avg_deg, seed=seed)
    if materialize_features is not None:
        feature_backend = "dense" if materialize_features else "hashed"
    if feature_backend == "auto":
        feature_backend = "dense" if n * f0 * 4 <= 2 * 2**30 else "hashed"
    hashed = HashedFeatures(n, f0, seed=seed)
    if feature_backend == "dense":
        feats: "FeatureSource | np.ndarray" = hashed.materialize()
    elif feature_backend == "hashed":
        feats = hashed
    else:
        raise ValueError(f"unknown feature_backend {feature_backend!r}")
    rng = np.random.default_rng(seed + 1)
    labels = rng.integers(0, ncls, size=n, dtype=np.int32)
    return GraphDataset(name=name, graph=graph, features=feats,
                        labels=labels, num_classes=ncls, feat_dim=f0,
                        layer_dims=(f0, f1, f2))
