"""OCP solves completed per second across a fleet of independent loops:
B x cycles of every request of the window over the window's whole time."""


def read(run):
    return run.requests * run.batch * run.cycles / run.window_s
