"""Mean host milliseconds a window step waited for the pipeline's next
batch (the benchmark's span around ``next()`` on ``TokenPipeline``)."""


def read(run):
    if not run.input_wait_s:
        return None
    return 1e3 * sum(run.input_wait_s) / len(run.input_wait_s)
