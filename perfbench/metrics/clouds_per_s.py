"""Pharmacophore clouds completed per second: every cloud of the window over
its whole time (host clock; the window ends with the chain running when
its seconds are up)."""


def read(run):
    return run.clouds / run.window_s
