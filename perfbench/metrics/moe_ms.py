"""Device milliseconds of the routed FFN in a traced step: the program's
``moe.ffn`` spans (one a layer in the forward and one in its remat
recompute), summed over the step; the median over the traced steps."""
from perfbench.harness import program


def read(run):
    return program.span_ms(run, "moe.ffn")
