"""What one run measured, as the metric readers see it."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from .dims import Dims
from .trace import Trace


@dataclasses.dataclass
class Run:
    dims: Dims
    traffic: Dict[str, Any]
    steps: int                  # steps of the measured window
    window_s: float             # its wall time, first call to last result
    tokens_per_step: int
    step_ms: List[float]        # each window step, from device events
    input_wait_s: List[float]   # host wait for each step's batch
    peak_bytes: int             # the card's, set-up and window
    setup_s: float
    trace: Optional[Trace] = None
