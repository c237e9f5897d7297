"""Runtime of the port: DRM, performance model, pipeline, protocol and the
hybrid trainer, as in ``repro.core``."""
from .drm import Assignment, DRMEngine, StageTimes
from .hybrid import HybridConfig, HybridGNNTrainer, IterationMetrics
from .perfmodel import (PLATFORMS, PlatformSpec, StagePrediction,
                        WorkloadSpec, calibrate_sampling,
                        initial_task_mapping, mteps, predict,
                        predict_epoch_time)
from .pipeline import PipelineItem, PrefetchPipeline, Stage
from .protocol import Runtime, Synchronizer, TrainerHandle

__all__ = [
    "Assignment", "DRMEngine", "StageTimes",
    "HybridConfig", "HybridGNNTrainer", "IterationMetrics",
    "PLATFORMS", "PlatformSpec", "StagePrediction", "WorkloadSpec",
    "calibrate_sampling", "initial_task_mapping", "mteps", "predict",
    "predict_epoch_time",
    "PipelineItem", "PrefetchPipeline", "Stage",
    "Runtime", "Synchronizer", "TrainerHandle",
]
