"""Device milliseconds of the attention's recompute VJP in a traced step:
the program's ``attn.vjp`` spans (one a layer and microbatch), summed
over the step; the median over the traced steps."""
from perfbench.harness import program


def read(run):
    return program.span_ms(run, "attn.vjp")
