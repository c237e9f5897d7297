"""Runtime of the port: DRM, performance model, pipeline, protocol and the
hybrid trainer, as in ``repro.core``."""
from .drm import (Assignment, DRMEngine, KnobAutoTuner, KnobProposal,
                  StageTimes, knob_neighbors)
from .hybrid import HybridConfig, HybridGNNTrainer, IterationMetrics
from .perfmodel import (PLATFORMS, CalibratedKnobModel, KnobBounds,
                        KnobState, PlatformSpec, SignalSnapshot,
                        StagePrediction, WorkloadSpec, calibrate_sampling,
                        initial_task_mapping, mteps, predict,
                        predict_epoch_time)
from .pipeline import (PipelineItem, PipelineStallError, PrefetchPipeline,
                       Stage)
from .protocol import Runtime, Synchronizer, TrainerHandle

__all__ = [
    "Assignment", "DRMEngine", "KnobAutoTuner", "KnobProposal",
    "StageTimes", "knob_neighbors",
    "HybridConfig", "HybridGNNTrainer", "IterationMetrics",
    "CalibratedKnobModel", "KnobBounds", "KnobState", "SignalSnapshot",
    "PLATFORMS", "PlatformSpec", "StagePrediction", "WorkloadSpec",
    "calibrate_sampling", "initial_task_mapping", "mteps", "predict",
    "predict_epoch_time",
    "PipelineItem", "PipelineStallError", "PrefetchPipeline", "Stage",
    "Runtime", "Synchronizer", "TrainerHandle",
]
