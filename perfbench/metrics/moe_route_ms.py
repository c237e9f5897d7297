"""Device milliseconds of the routed FFN's data movement and routing in a
traced step: the program's ``moe.route`` (router logits, aux loss, the
index math and gate weights), ``moe.dispatch`` and ``moe.combine`` spans,
forward and recompute, summed over the step; the median over the traced
steps."""
import statistics

from perfbench.harness import program

NAMES = ("moe.route", "moe.dispatch", "moe.combine")


def read(run):
    got = program.steps(run)
    if not got or not any(s.named(n) for s in got for n in NAMES):
        return None
    return float(statistics.median(
        sum(s.device_ms(n) for n in NAMES) for s in got))
