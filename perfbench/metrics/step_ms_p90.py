"""90th percentile of the window's step times, each from a CUDA event
recorded at its boundary and read after the window (no host sync inside
it)."""
import numpy as np


def read(run):
    if len(run.step_ms) < 10:
        return None
    return float(np.percentile(run.step_ms, 90))
