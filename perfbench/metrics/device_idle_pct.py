"""Share of the traced window in which no kernel, copy or set ran on the
card."""
from perfbench.harness.trace import busy


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy(run.trace) / run.trace.window_s)
