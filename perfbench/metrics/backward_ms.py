"""Device milliseconds of the backward in a traced step (the remat
recompute and the attention VJP inside it): the program's ``lm.backward``
spans, summed over the step; the median over the traced steps."""
from perfbench.harness import program


def read(run):
    return program.span_ms(run, "lm.backward")
