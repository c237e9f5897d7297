"""Times a traced step's caching allocator freed its cache and
synchronized to retry an allocation: the program's ``alloc_retries``
counter on ``lm.train_step``, the mean over the traced steps (0 on a host
without CUDA)."""
from perfbench.harness import program


def read(run):
    got = program.steps(run)
    if not got or any("alloc_retries" not in s.top["counters"]
                      for s in got):
        return None
    return sum(s.top["counters"]["alloc_retries"] for s in got) / len(got)
