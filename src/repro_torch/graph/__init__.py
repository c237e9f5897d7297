"""Graph data layer of the port: storage -> sampler -> hot cache / loader
-> models, with the window prefetcher and the fault injector of the storage
tier, as in ``repro.graph``."""
from .storage import (CSRGraph, DATASET_STATS, TRAIN_SPLIT, DenseFeatures,
                      FeatureSource, GraphDataset, HashedFeatures,
                      MmapFeatures, PartitionedFeatures, as_feature_source,
                      make_dataset, synth_powerlaw_graph)
from .sampler import (MiniBatch, NumpySampler, frontier_sizes,
                      sample_minibatch_torch)
from .featcache import (CacheLookup, CacheStats, FeatureCache, ShardLookup,
                        ShardPlacement, ShardedFeatureCache, UnionLookup,
                        build_cache, build_sharded_cache, compact_lookup,
                        wire_row_bytes)
from .featload import FeatureLoader, LoadStats, MissBlock, ShardMissBlock
from .prefetch import WindowPrefetcher
from .faults import FaultInjector, FaultSpec, WorkerKilled
from .models import (GNNConfig, forward, init_params, loss_fn, param_count,
                     params_from_numpy)

__all__ = [
    "CSRGraph", "DATASET_STATS", "TRAIN_SPLIT", "DenseFeatures",
    "FeatureSource", "GraphDataset", "HashedFeatures", "PartitionedFeatures",
    "MmapFeatures", "as_feature_source",
    "make_dataset", "synth_powerlaw_graph",
    "MiniBatch", "NumpySampler", "frontier_sizes", "sample_minibatch_torch",
    "CacheLookup", "CacheStats", "FeatureCache", "ShardLookup",
    "ShardPlacement", "ShardedFeatureCache", "UnionLookup", "build_cache",
    "build_sharded_cache", "compact_lookup", "wire_row_bytes",
    "FeatureLoader", "LoadStats", "MissBlock", "ShardMissBlock",
    "WindowPrefetcher", "FaultInjector", "FaultSpec", "WorkerKilled",
    "GNNConfig", "forward", "init_params", "loss_fn", "param_count",
    "params_from_numpy",
]
