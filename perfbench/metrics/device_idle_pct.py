"""Percent of the traced window in which no kernel, copy or set ran on the
device: 100 x (1 - the union of their intervals / the window), both from
the same trace."""


def read(run):
    s = run.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
