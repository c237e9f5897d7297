"""Device milliseconds of the remat recompute in a traced step: the
program's ``lm.layer`` spans that lie inside one of the step's
``lm.backward`` spans on the host's clock (the layer bodies run again,
on autograd's thread), summed over the step; the median over the traced
steps."""
import statistics

from perfbench.harness import program


def _recompute_ms(step):
    backs = step.named("lm.backward")
    return sum(e["device_ms"] for e in step.named("lm.layer")
               if any(b["start_ns"] <= e["start_ns"]
                      and e["end_ns"] <= b["end_ns"] for b in backs))


def read(run):
    got = program.steps(run)
    if not got or not any(s.named("lm.backward") for s in got):
        return None
    return float(statistics.median(_recompute_ms(s) for s in got))
