"""Device kernels launched per control cycle of the traced requests (a
count; the presolve's kernels included)."""


def read(run):
    if run.summary is None or not run.summary.cycles:
        return None
    n, _ = run.summary.kernel_stats()
    return n / run.summary.cycles if n else None
