"""Tokens of every step of the window per second of the window's wall
time (first call to the synchronize after the last step)."""


def read(run):
    return run.steps * run.tokens_per_step / run.window_s
