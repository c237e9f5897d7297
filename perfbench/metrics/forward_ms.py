"""Device milliseconds of the model's forward in a traced step: the
program's ``lm.forward`` spans (embedding through the head), summed over
the step's microbatches; the median over the traced steps."""
from perfbench.harness import program


def read(run):
    return program.span_ms(run, "lm.forward")
