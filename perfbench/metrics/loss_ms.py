"""Device milliseconds of the loss after the forward in a traced step
(mask, logsumexp, gather, mean): the program's ``lm.loss`` spans, summed
over the step; the median over the traced steps."""
from perfbench.harness import program


def read(run):
    return program.span_ms(run, "lm.loss")
