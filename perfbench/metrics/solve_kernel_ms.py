"""Device milliseconds per launch of the solve kernel (`ilqr_solve_kernel`),
from the traced requests' device events."""

KERNEL = "ilqr_solve_kernel"


def read(run):
    if run.summary is None:
        return None
    n, secs = run.summary.kernel_stats(KERNEL)
    return 1e3 * secs / n if n else None
