"""Device milliseconds per control cycle of every kernel but the solve
kernel (clip, plant RK4, warm-start shift, output writes, the presolve's
own), over the traced requests' cycles."""

KERNEL = "ilqr_solve_kernel"


def read(run):
    if run.summary is None or not run.summary.cycles:
        return None
    n, secs = run.summary.kernel_stats(exclude=KERNEL)
    return 1e3 * secs / run.summary.cycles if n else None
