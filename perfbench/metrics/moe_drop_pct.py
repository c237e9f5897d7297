"""Share, in %, of the router's token-expert assignments dropped past
their expert's capacity: the program's ``moe.dropped`` over
``moe.assignments`` counters, over the traced steps' forwards and summed
over the ranks (``run.moe_counters``)."""


def read(run):
    c = getattr(run, "moe_counters", None)
    if not c or not c.get("moe.assignments"):
        return None
    return 100.0 * c["moe.dropped"] / c["moe.assignments"]
