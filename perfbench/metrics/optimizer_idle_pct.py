"""Share, in %, of the optimizer's host interval in which the card sat
idle: each traced step's ``optim.step`` span placed on the trace's clock
(through the benchmark's ``pb.step`` and ``pb.input_wait`` annotations,
which wrap the step's ``lm.train_step`` and ``pipeline.wait``) against
the trace's idle gaps; the median over the traced steps.  Nothing where
the anchors leave the clock's offset unsure by more than 0.1 ms."""
from perfbench.harness import program


def read(run):
    return program.idle_share(run, "optim.step")
