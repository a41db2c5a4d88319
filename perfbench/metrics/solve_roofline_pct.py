"""The solve kernel's share of its roofline: the least time of one launch
at the cell's B (operations over the peak rate or bytes over the bandwidth,
`perfbench/counts.py`) over its measured device time per launch."""

from perfbench import counts

KERNEL = "ilqr_solve_kernel"


def read(run):
    if run.summary is None:
        return None
    n, secs = run.summary.kernel_stats(KERNEL)
    if not n:
        return None
    bound = counts.bound_ms(run.solver, run.batch, run.table_len, run.dtype)
    return 100.0 * bound / (1e3 * secs / n)
