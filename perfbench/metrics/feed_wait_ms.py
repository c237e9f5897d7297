"""Host milliseconds the train loop waited for its next batch, from
asking the pipeline to having it: the program's ``pipeline.wait`` spans,
the mean over the traced steps (the program's own reading of what
``input_wait_ms`` times from outside)."""
from perfbench.harness import program


def read(run):
    got = program.steps(run)
    if not got or not any(s.named("pipeline.wait") for s in got):
        return None
    return sum(e["host_ms"] for s in got
               for e in s.named("pipeline.wait")) / len(got)
