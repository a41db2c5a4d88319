"""Share (%) of the traced requests' solve-kernel launches that keep the
track table in global memory: the `ilqr_solve_kernel<T, true, false>`
instantiation (`ops.ilqr.placement`'s "global"), over every
`ilqr_solve_kernel` launch."""

KERNEL = "ilqr_solve_kernel"
GLOBAL = tuple(f"{KERNEL}<{t}, true, false>" for t in ("float", "double"))


def read(run):
    if run.summary is None:
        return None
    n, _ = run.summary.kernel_stats(KERNEL)
    if not n:
        return None
    return 100.0 * sum(run.summary.kernel_stats(name)[0] for name in GLOBAL) / n
