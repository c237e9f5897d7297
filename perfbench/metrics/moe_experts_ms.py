"""Device milliseconds of the experts' products in a traced step: the
program's ``moe.experts`` spans (the three ``bmm`` and the SiLU over the
capacity buffer, with the gathers of the sharded expert weights), forward
and recompute, summed over the step; the median over the traced
steps."""
from perfbench.harness import program


def read(run):
    return program.span_ms(run, "moe.experts")
