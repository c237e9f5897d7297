"""Share, in %, of the capacity buffer's slots that held a token: the
program's ``moe.slots_filled`` over ``moe.slots`` counters, over the
traced steps' forwards and summed over the ranks (``run.moe_counters``);
the rest of the buffer goes through the experts' products as zeros."""


def read(run):
    c = getattr(run, "moe_counters", None)
    if not c or not c.get("moe.slots"):
        return None
    return 100.0 * c["moe.slots_filled"] / c["moe.slots"]
