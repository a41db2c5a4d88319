"""The port's plain iLQR twin against the JAX package's Pallas kernel.

`ops.ilqr.backward_forward_reference` and `pallas_ilqr.backward_forward` in
interpret mode (as tests/test_pallas_ilqr.py runs it on the CPU) get the
same linearisation and quadratics, the ones `solver._iterate_pallas` hands
the kernel (solver.py:555-568), and the same packed tables and scalars.
Tolerances are that file's: 1e-11 in float64 and 1e-5 in float32 for the
trajectories, ten times that (relative) for the cost; the sums run in
another order.  The inputs come from test_torch_ilqr.py's `_case`.
"""

import jax.numpy as jnp
import pytest

from lap_time_optimization_tpu.ops import pallas_ilqr as PK
from lap_time_optimization_tpu_torch.ops import ilqr
from test_torch_ilqr import _case, assert_close, base, check_packing  # noqa: F401  (fixture)


@pytest.mark.parametrize("n_con", [14, 16])
@pytest.mark.parametrize("dtype_name", ["float32", "float64"])
def test_twin_matches_pallas_interpret(base, dtype_name, n_con):  # noqa: F811
    c = _case(base, dtype_name, te=(n_con == 16))
    assert c["inputs"][11].shape == (11, n_con)
    check_packing(c)
    got = ilqr.backward_forward_reference(*c["inputs"], substeps=c["cfg"].substeps)
    assert float(got[3]) == 1.0

    jm, jp, cfg, dtype = c["jm"], c["jp"], c["cfg"], c["zs"].dtype
    alphas = (10.0 ** jnp.linspace(0.0, -2.5, cfg.n_linesearch)).astype(dtype)
    zs, us, cost, ok = PK.backward_forward(
        *c["kernel_inputs"], c["zs"], c["us"], c["lams"], PK.tables_matrix(jm, dtype), alphas,
        PK.scal_vector(jm, jp, cfg, c["rho"], c["reg"], dtype),
        N=cfg.horizon, L=cfg.n_linesearch, substeps=cfg.substeps, interpret=True,
    )
    assert float(ok) == 1.0
    assert_close(got, (cost, zs, us), c["tol"])
