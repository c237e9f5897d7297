"""Device milliseconds of the optimizer in a traced step (AdamW's update,
its application and the copies into the parameters): the program's
``optim.step`` span; the median over the traced steps."""
from perfbench.harness import program


def read(run):
    return program.span_ms(run, "optim.step")
