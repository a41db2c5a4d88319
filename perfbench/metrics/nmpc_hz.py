"""Control cycles of a lap simulation completed per second, single stream:
every cycle of the window's requests over the window's whole time."""


def read(run):
    if run.batch != 1:
        return None
    return run.requests * run.cycles / run.window_s
