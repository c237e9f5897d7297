"""Seconds from the process's start to the window's first step: imports,
kernel loads (builds on a checkout's first run), weights, the compared
steps."""


def read(run):
    return run.setup_s
