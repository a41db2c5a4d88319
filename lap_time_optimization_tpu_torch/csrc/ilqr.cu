// The whole AL-iLQR solve of the horizon NMPC in one launch, for a batch of
// independent OCPs (the single stream is the batch at B = 1).  CUDA C++ for
// sm_90a.
//
// Replaces two Pallas TPU kernels of lap_time_optimization_tpu/ops/, and the
// eager PyTorch around them in mpc/solver.py:
//  * pallas_ilqr.py `backward_forward` (body `_kernel`): one AL-iLQR
//    iteration (Riccati sweep + line-search ladder) of one OCP;
//  * pallas_ilqr_batch.py `backward_forward_batch` (body `_kernel`): the
//    same iteration for B OCPs, each with its own Levenberg reg.
// Here one launch runs everything `solver.solve` / `solve_batch` compute in
// Gauss-Newton mode (the plain version is mpc/solver.py::_solve with the
// iteration twins of ops/ilqr.py): the rollout of us_init; al_iters AL
// rounds of (AL cost, ilqr_iters x [analytic linearisation of the RK4
// step, GN stage and terminal quads, Riccati sweep with the closed-form 2x2
// Quu inverse and the finite-gain flag, L-rung ladder rollout with its PHR
// costs, lowest-index minimal rung, accept if new_cost < cost and the sweep
// stayed finite, reg x0.5 (floored at reg_init) or x100], multiplier update
// on the tightened band with the terminal mask, rho *= rho_scale); then the
// AL-free cost and the max violation on the true band.
//
// What bounds it on the H100: latency.  An OCP is N serial Riccati stages of
// 10x10 products and L ladder rollouts of N x substeps x 4 serial RHS
// evaluations (trig, divisions), repeated al_iters x ilqr_iters times; at
// the main path's shapes (N=10, L=6, substeps=2, 2x5 iterations, n=846) a
// solve reads the 13.5 KB table (f32) and ~0.7 KB per OCP, writes ~1.1 KB
// per OCP and needs ~2.0e6 operations per OCP (chip_smoke.py solve_flops):
// tens of nanoseconds of the card's bytes or FLOPs per OCP, against
// milliseconds of dependent instructions on one warp, most of them the
// serial RK4 chains of the ladder rungs and the linearisation (chip_smoke.py
// times the solve with 1 RK4 substep and with no iLQR iteration to split
// it).  What cost the time before this kernel was everything around the
// per-iteration kernels: ~35,000 eager PyTorch launches per solve, and the
// table reloaded per iteration.
//
// Design:
//  * One warp per OCP.  A block of W warps (W = 1, 2 or 4) holds W instances
//    and ONE copy of the (4, n) lookup table and the scalars in shared
//    memory, loaded once per solve; after that single __syncthreads a warp
//    synchronises only itself (__syncwarp), so instances never wait for each
//    other.  Instance b of a batch is computed exactly as at B = 1.
//  * Everything an OCP keeps between iterations (trajectory, multipliers,
//    stage Jacobians, GN quads, gains, value function, ladder trajectories)
//    sits in the warp's slice of dynamic shared memory for the whole solve,
//    or, past what a block holds, in the same layout in a global workspace
//    (below); scalars (rho, reg, the AL cost) are in registers, identical
//    on every lane.
//  * Lanes split the stage-parallel work: the linearisation one (stage,
//    group of C = LIN_COLS tangent columns) per lane, so a stage's 10
//    columns take ceil(10 / C) lanes and N stages ceil(N ceil(10 / C) / 32)
//    rounds of the warp (1 at N = 10).  A lane carries its C tangents
//    through the 2x4 RK4 stages as BicycleModel.step_and_jacobian does, and
//    at each stage point evaluates the RHS and the partials of
//    rhs_and_jacobian once for all C of them;
//    the GN quads 2 Jr'Jr + rho Jg' diag(act) Jg one stage per lane, over
//    the sparse rows of Jr and Jg; the ladder one rung per lane (rung r on
//    lane r % 32: past 32 rungs a lane runs several in turn); the AL costs
//    and the multiplier update one stage per lane.
//    Each Riccati stage is three warp-synchronous phases of ~4 output
//    elements per lane: P = Vzz [A|B] with Q = l + [A|B]'Vz; the Q blocks
//    [A|B]'P; then the gains (each lane inverts Quu itself) fused with the
//    symmetrised value update.
//  * The rung choice needs no barrier: every lane scans the L costs itself.
//  * Plain FMA loops in full precision: no tensor cores, no TF32 (at 10x10
//    the matrices are below any MMA tile).  Trig is libdevice's.
//  * Non-smooth points follow the plain version: the lookup slope of
//    MPCTrack._uinterp_d (half on a grid point), the vx floor gate (1, 1/2
//    on it, 0 below), sign(mu) as +1 at 0; NaN costs count as +inf in the
//    rung choice, new_cost < cost is false for NaN, max(0, x) keeps NaN.
// Shared memory: the scalars, W slices of solve_slice_elems() elements
// (~4,200 at N=10, L=6, 16 rows: 16.9 KB in f32, 33.8 KB in f64) and, where
// it fits beside them, the (4, n) table (the shared placement).  A longer
// table stays in global memory (the global placement: 333 KB at n = 20,832
// in f32, which the 50 MB L2 holds), read through the kernel's const
// __restrict__ argument.  The launch raises the dynamic limit above 48 KB;
// a block holds 227 KB, so with the table in global memory one slice fits
// up to N = 160 in f32 and 79 in f64 (L=6, 14 rows; a slice grows by ~358
// elements a stage).  Past that, what the block kept in shared memory, the
// scalars and its W slices in the same layout, lives in the block's part of
// a global workspace that the caller allocates, with the table in global
// memory (the workspace placement: 287 KB per OCP at N = 200 in f32, which
// the 50 MB L2 holds), and any horizon runs; only an OCP's slice past 2^31
// elements (32-bit indices) is refused.  The kernel is a template on the
// placement whose only difference is where its pointers point: every
// placement runs the same device functions on the same values, and its
// pointers alias one another as in shared memory (all from one base), so
// the compiler emits the same arithmetic and the placements give the same
// bits.
//
// The model's device functions (the track lookup, the tyres, the RHS, its
// partials, the RK4 step) are in bicycle.cuh, which
// cycle_tail.cu's kernel, the plant of the closed loop, includes too.
//
// C interface (one entry point per type): every pointer is a contiguous
// device buffer in the layouts of ops/ilqr.py::solve (a leading instance
// axis B); `global_table` picks the table's placement and a non-null
// `workspace` (ceil(B / W) x lto_ilqr_solve_workspace_elems() elements)
// the workspace placement, whose table is in global memory; the launch goes
// onto `stream`, allocates nothing and returns cudaGetLastError().
// lto_ilqr_solve_smem_bytes gives the dynamic shared memory of a launch in
// shared memory, or 0 for sizes it does not take; lto_ilqr_solve_blocks_per_sm
// the blocks of a placement that one SM holds at once.

#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "bicycle.cuh"

namespace {

constexpr int NQ = NZ + NU;  // quad variables [z, u]
constexpr int N_CON = 14;
constexpr int WARP = 32;
constexpr int MAX_WARPS = 4;
constexpr size_t MAX_SMEM = 232448;  // what one block may hold on sm_90

// Tangent columns one lane of the linearisation carries through a stage's
// RK4: a stage's NZ columns take G = ceil(NZ / C) lanes, and N stages
// ceil(N G / 32) rounds of the warp (1 at N = 10).  Of C = 2-5, 4 was the
// fastest on an H100 in both element types (h10 f32 with MIN_BLOCKS, h20
// f64), where each column more costs registers and spills (PERF.md
// section 6).
constexpr int LIN_COLS = 4;

// Columns c0 .. c0 + C - 1 (those below NZ) of the step's Jacobian w.r.t.
// [x, u] (BicycleModel.step_and_jacobian), each starting from its column of
// eye(NX, NX+NU) and carried through every RK4 stage; written into the
// stage's Jk (NX x NZ).  At each stage point the RHS and its partials are
// evaluated once (rhs_d) and serve all C columns.
template <typename T, int C>
__device__ void step_jacobian_columns(const T* z, const T* u, int c0, const T* tab, int n,
                                      const T* sc, int substeps, T* Jk) {
  const T h = sc[H];
  T x[NX], xt[NX], kx[NX], ax[NX], v[C][NX], vt[C][NX], av[C][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = xt[i] = z[i];
#pragma unroll
  for (int j = 0; j < C; ++j)
#pragma unroll
    for (int i = 0; i < NX; ++i) v[j][i] = vt[j][i] = i == c0 + j ? T(1) : T(0);
  for (int sub = 0; sub < substeps; ++sub) {
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      RhsD<T> d;
      rhs_d(xt, u, tab, n, sc, kx, d);
      // the stage's weight in the sum and the step to the next stage point
      const T w = st == 0 || st == 3 ? T(1) : T(2);
      const T to = st < 2 ? T(0.5) * h : h;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        T kv[NX];
        rhs_d_apply(d, vt[j], c0 + j, kv);
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          if (st == 0) av[j][i] = kv[i];
          else if (st < 3) av[j][i] = av[j][i] + w * kv[i];
          if (st < 3) vt[j][i] = v[j][i] + to * kv[i];
          else vt[j][i] = v[j][i] = v[j][i] + (h / T(6)) * (av[j][i] + kv[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        if (st == 0) ax[i] = kx[i];
        else if (st < 3) ax[i] = ax[i] + w * kx[i];
        if (st < 3) xt[i] = x[i] + to * kx[i];
        else xt[i] = x[i] = x[i] + (h / T(6)) * (ax[i] + kx[i]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < C; ++j)
    if (c0 + j < NZ)
#pragma unroll
      for (int i = 0; i < NX; ++i) Jk[i * NZ + c0 + j] = v[j][i];
}

// The stage inequalities g <= 0 (mpc/solver.py _constraints) with the lateral
// band shrunk by `margin`; at the terminal stage the input rows 10-13 are
// replaced by -1 (_masked_terminal_constraints).
template <typename T>
__device__ void constraints(const T* z, const T* u, bool terminal, T margin, int n_con,
                            const T* tab, int n, const T* sc, T* g) {
  const T s = z[0], nn = z[1], mu = z[2], vx = z[3], delta = z[6], thr = z[7];
  const T nl = lookup(tab + 1 * n, n, s, sc);
  const T nr = lookup(tab + 2 * n, n, s, sc);
  const T abs_mu = mu >= T(0) ? mu : -mu;
  const T lon = sc[HALF_LEN] * m_sin(abs_mu);
  const T lat = sc[HALF_WID] * m_cos(mu);
  g[0] = nn - lon + lat - nl + margin;
  g[1] = -nn + lon + lat - nr + margin;
  g[2] = -s;
  g[3] = mu - sc[MU_MAX];
  g[4] = -mu - sc[MU_MAX];
  g[5] = -vx;
  g[6] = delta - sc[STEER_MAX];
  g[7] = -delta - sc[STEER_MAX];
  g[8] = thr - sc[THR_MAX];
  g[9] = -thr - sc[THR_MAX];
  if (terminal) {
    g[10] = g[11] = g[12] = g[13] = T(-1);
  } else {
    g[10] = u[0] - sc[DSTEER_MAX];
    g[11] = -u[0] - sc[DSTEER_MAX];
    g[12] = u[1] - sc[DTHR_MAX];
    g[13] = -u[1] - sc[DTHR_MAX];
  }
  if (n_con == N_CON + 2) {  // normalised friction-ellipse rows
    const T m = sc[MASS], lf = sc[LF], lr = sc[LR];
    const Tyres<T> f = tyre_forces(vx, z[4], z[5], delta, sc);
    const T wheelbase = lf + lr;
    const T Fn_f = lr * m * T(GRAV) / wheelbase;
    const T Fn_r = lf * m * T(GRAV) / wheelbase;
    const T longf = T(0.5) * (sc[CM] * thr);
    const T cap_f = (sc[DF] * Fn_f) * (sc[DF] * Fn_f);
    const T cap_r = (sc[DR] * Fn_r) * (sc[DR] * Fn_r);
    g[14] = (longf * longf + f.Fy_f * f.Fy_f - cap_f) / cap_f;
    g[15] = (longf * longf + f.Fy_r * f.Fy_r - cap_r) / cap_r;
  }
}

// PHR penalty sum_i (max(0, lam_i + rho g_i)^2 - lam_i^2) / (2 rho) over the
// tightened constraints
template <typename T>
__device__ T al_penalty(const T* z, const T* u, const T* lam, T rho, int n_con, bool terminal,
                        const T* tab, int n, const T* sc) {
  T g[N_CON + 2];
  constraints(z, u, terminal, sc[MARGIN], n_con, tab, n, sc, g);
  T pen = T(0);
  for (int i = 0; i < n_con; ++i) {
    const T sh = relu_nan(lam[i] + rho * g[i]);
    pen += (sh * sh - lam[i] * lam[i]) / (T(2) * rho);
  }
  return pen;
}

// stage cost lterm + rterm (mpc/solver.py stage_cost)
template <typename T>
__device__ T stage_cost(const T* z, const T* u, const T* tab, int n, const T* sc) {
  const T nn = z[1], mu = z[2], vx = z[3], vy = z[4], delta = z[6];
  const T vref = lookup(tab + 3 * n, n, z[0], sc);
  const T vx_safe = vx < T(1e-3) ? T(1e-3) : vx;
  const T b_dyn = m_atan(vy / vx_safe);
  const T b_kin = m_atan(delta * sc[LR] / (sc[LF] + sc[LR]));
  const T du0 = u[0] - z[NX], du1 = u[1] - z[NX + 1];
  const T dv = vx - sc[VREF_SCALE] * vref;
  const T db = b_dyn - b_kin;
  const T mterm = sc[QN] * (nn * nn) + sc[QMU] * (mu * mu) + vy * vy;
  const T lterm = mterm + dv * dv + sc[QB] * (db * db);
  const T rterm = sc[RDELTA] * (du0 * du0) + sc[RTHR] * (du1 * du1);
  return lterm + rterm;
}

// terminal cost mterm (mpc/solver.py terminal_cost)
template <typename T>
__device__ T terminal_cost(const T* z, const T* sc) {
  const T nn = z[1], mu = z[2], vy = z[4];
  return sc[QN] * (nn * nn) + sc[QMU] * (mu * mu) + vy * vy;
}

template <typename T>
__device__ T al_stage_cost(const T* z, const T* u, const T* lam, T rho, int n_con, const T* tab,
                           int n, const T* sc) {
  return stage_cost(z, u, tab, n, sc) + al_penalty(z, u, lam, rho, n_con, false, tab, n, sc);
}

template <typename T>
__device__ T al_terminal_cost(const T* z, const T* lam, T rho, int n_con, const T* tab, int n,
                              const T* sc) {
  const T zero_u[NU] = {T(0), T(0)};
  return terminal_cost(z, sc) + al_penalty(z, zero_u, lam, rho, n_con, true, tab, n, sc);
}

// One sparse row of Jr or Jg (<= 5 nonzeros) added to the stage's GN quads:
// H += a a' with a = 2 v (residual rows: 2 Jr'Jr) or H += v (act v)'
// (constraint rows: Jg' diag(act) Jg), and G += v * w (w = r or phi).
template <typename T, int K>
__device__ __forceinline__ void add_row(T* Hs, T* Gs, const int (&c)[K], const T (&v)[K], T left,
                                        T right, T w) {
#pragma unroll
  for (int a = 0; a < K; ++a) {
    Gs[c[a]] += v[a] * w;
#pragma unroll
    for (int b = 0; b < K; ++b) Hs[c[a] * NQ + c[b]] += (left * v[a]) * (right * v[b]);
  }
}

// GN quads of the AL stage cost at (z, u, lam) (mpc/solver.py
// _stage_jacobians + _gn): Hs (NQ x NQ) = 2 Jr'Jr + Jg' diag(act) Jg and
// Gs (NQ) = 2 Jr'r + Jg' phi.  The terminal stage (_terminal_quads_gauss_
// newton) takes the first 3 residual rows, the masked constraints, and
// u = u_prev; only its z block is read.
template <typename T>
__device__ void stage_quads(const T* z, const T* u, const T* lam, T rho, bool terminal, int n_con,
                            const T* tab, int n, const T* sc, T* Hs, T* Gs) {
  for (int i = 0; i < NQ * NQ; ++i) Hs[i] = T(0);
  for (int i = 0; i < NQ; ++i) Gs[i] = T(0);
  const T s = z[0], nn = z[1], mu = z[2], vx = z[3], vy = z[4], delta = z[6];
  const T lf = sc[LF], lr = sc[LR];
  // ---- residual rows (stage_residuals)
  T dvref;
  const T vref = lookup_d(tab + 3 * n, n, s, sc, dvref);
  const T vx_safe = vx < T(1e-3) ? T(1e-3) : vx;
  // jnp.maximum's derivative: 1 above the floor, 1/2 on it, 0 below
  const T gate = vx > T(1e-3) ? T(1) : (vx == T(1e-3) ? T(0.5) : T(0));
  const T q = vy / vx_safe;
  const T sq_b = m_sqrt(sc[QB]);
  const T datan = sq_b / (T(1) + q * q);
  const T kin = lr / (lf + lr);
  const T bk = delta * kin;
  const T b_dyn = m_atan(vy / vx_safe);
  const T b_kin = m_atan(delta * lr / (lf + lr));
  const T sq_n = m_sqrt(sc[QN]), sq_mu = m_sqrt(sc[QMU]);
  const T sq_d = m_sqrt(sc[RDELTA]), sq_t = m_sqrt(sc[RTHR]);
  const T two = T(2), one = T(1);
  {
    const int c[1] = {1};
    const T v[1] = {sq_n};
    add_row(Hs, Gs, c, v, two, one, sq_n * nn);
  }
  {
    const int c[1] = {2};
    const T v[1] = {sq_mu};
    add_row(Hs, Gs, c, v, two, one, sq_mu * mu);
  }
  {
    const int c[1] = {4};
    const T v[1] = {one};
    add_row(Hs, Gs, c, v, two, one, vy);
  }
  if (!terminal) {
    {
      const int c[2] = {0, 3};
      const T v[2] = {-sc[VREF_SCALE] * dvref, one};
      add_row(Hs, Gs, c, v, two, one, vx - sc[VREF_SCALE] * vref);
    }
    {
      const int c[3] = {3, 4, 6};
      const T v[3] = {-datan * q / vx_safe * gate, datan / vx_safe, -sq_b * kin / (one + bk * bk)};
      add_row(Hs, Gs, c, v, two, one, sq_b * (b_dyn - b_kin));
    }
    {
      const int c[2] = {NX, NZ};
      const T v[2] = {-sq_d, sq_d};
      add_row(Hs, Gs, c, v, two, one, sq_d * (u[0] - z[NX]));
    }
    {
      const int c[2] = {NX + 1, NZ + 1};
      const T v[2] = {-sq_t, sq_t};
      add_row(Hs, Gs, c, v, two, one, sq_t * (u[1] - z[NX + 1]));
    }
  }
  for (int i = 0; i < NQ; ++i) Gs[i] = two * Gs[i];
  // ---- constraint rows (tightened band; masked at the terminal stage)
  T g[N_CON + 2], phi[N_CON + 2], act[N_CON + 2];
  constraints(z, u, terminal, sc[MARGIN], n_con, tab, n, sc, g);
  for (int i = 0; i < n_con; ++i) {
    phi[i] = relu_nan(lam[i] + rho * g[i]);
    act[i] = phi[i] > T(0) ? rho : T(0);
  }
  T dnl, dnr;
  lookup_d(tab + 1 * n, n, s, sc, dnl);
  lookup_d(tab + 2 * n, n, s, sc, dnr);
  const T sgn = mu >= T(0) ? one : -one;
  const T abs_mu = mu >= T(0) ? mu : -mu;
  const T lon_mu = sc[HALF_LEN] * m_cos(abs_mu) * sgn;
  const T lat_mu = -sc[HALF_WID] * m_sin(mu);
  {
    const int c[3] = {0, 1, 2};
    const T v[3] = {-dnl, one, -lon_mu + lat_mu};
    add_row(Hs, Gs, c, v, one, act[0], phi[0]);
  }
  {
    const int c[3] = {0, 1, 2};
    const T v[3] = {-dnr, -one, lon_mu + lat_mu};
    add_row(Hs, Gs, c, v, one, act[1], phi[1]);
  }
  // rows 2-13: one +-1 entry each
  const int box_col[12] = {0, 2, 2, 3, 6, 6, 7, 7, NZ, NZ, NZ + 1, NZ + 1};
  const T box_val[12] = {-one, one, -one, -one, one, -one, one, -one, one, -one, one, -one};
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const int c[1] = {box_col[i]};
    const T v[1] = {box_val[i]};
    add_row(Hs, Gs, c, v, one, act[2 + i], phi[2 + i]);
  }
  if (n_con == N_CON + 2) {
    const T m = sc[MASS];
    const TyreD<T> t = tyre_partials(vx, vy, z[5], delta, sc);
    const T wheelbase = lf + lr;
    const T cf = sc[DF] * lr * m * T(GRAV) / wheelbase;
    const T cr = sc[DR] * lf * m * T(GRAV) / wheelbase;
    const T cap_f = cf * cf, cap_r = cr * cr;
    const T dlong = two * (T(0.5) * (sc[CM] * z[7])) * (T(0.5) * sc[CM]);
    {
      const int c[5] = {3, 4, 5, 6, 7};
      const T v[5] = {two * t.Fy_f * t.f_vx / cap_f, two * t.Fy_f * t.f_vy / cap_f,
                      two * t.Fy_f * t.f_r / cap_f, two * t.Fy_f * t.f_d / cap_f, dlong / cap_f};
      add_row(Hs, Gs, c, v, one, act[14], phi[14]);
    }
    {
      const int c[4] = {3, 4, 5, 7};
      const T v[4] = {two * t.Fy_r * t.r_vx / cap_r, two * t.Fy_r * t.r_vy / cap_r,
                      two * t.Fy_r * t.r_r / cap_r, dlong / cap_r};
      add_row(Hs, Gs, c, v, one, act[15], phi[15]);
    }
  }
}

// Elements of one instance's slice of shared memory (see Slice).
__host__ __device__ inline size_t solve_slice_elems(int N, int L, int n_con) {
  const size_t Np = (size_t)N + 1;
  const size_t scr = (size_t)(L > 2 * (N + 1) ? L : 2 * (N + 1));
  return Np * NZ + (size_t)N * NU + Np * n_con       // zs, us, lam
         + (size_t)N * NX * NZ                        // J
         + Np * NQ * NQ + Np * NQ                     // H, G
         + (size_t)N * NU + (size_t)N * NU * NZ       // ks, Ks
         + NZ + NZ * NZ + NZ * NQ + NQ * NQ + NQ      // Vz, Vzz, P, Q, qv
         + Np * L * NZ + (size_t)N * L * NU           // zall, uall
         + scr + 1;                                   // scratch, ok
}

template <typename T>
struct Slice {
  T *zs, *us, *lam, *J, *H, *G, *ks, *Ks, *Vz, *Vzz, *P, *Q, *qv, *zall, *uall, *scr, *ok;
  __device__ Slice(T* p, int N, int L, int n_con) {
    const int Np = N + 1;
    zs = p; p += Np * NZ;
    us = p; p += N * NU;
    lam = p; p += Np * n_con;
    J = p; p += N * NX * NZ;
    H = p; p += Np * NQ * NQ;
    G = p; p += Np * NQ;
    ks = p; p += N * NU;
    Ks = p; p += N * NU * NZ;
    Vz = p; p += NZ;
    Vzz = p; p += NZ * NZ;
    P = p; p += NZ * NQ;
    Q = p; p += NQ * NQ;
    qv = p; p += NQ;
    zall = p; p += Np * L * NZ;
    uall = p; p += N * L * NU;
    scr = p; p += (L > 2 * Np ? L : 2 * Np);
    ok = p;
  }
};

// [A | B] of the augmented dynamics, element (m, a), from the stage's step
// Jacobian Jk (NX x NZ, columns [x, u]): x_next does not depend on u_prev,
// and u_prev' = u.
template <typename T>
__device__ __forceinline__ T F(const T* Jk, int m, int a) {
  if (m < NX) {
    if (a < NX) return Jk[m * NZ + a];
    if (a < NZ) return T(0);
    return Jk[m * NZ + a - NU];
  }
  return a == m + NU ? T(1) : T(0);
}

// The Riccati backward sweep for one instance, run by its warp: three
// warp-synchronous phases per stage.  Leaves the gains in S.ks, S.Ks and
// *S.ok = 0 if a feedforward gain was not finite.
template <typename T>
__device__ void riccati(Slice<T>& S, int N, T reg, int lane) {
  // terminal value function: the z block of the terminal quads
  const T* Hn = S.H + N * NQ * NQ;
  for (int e = lane; e < NZ * NZ + NZ; e += WARP) {
    if (e < NZ * NZ) S.Vzz[e] = Hn[(e / NZ) * NQ + e % NZ];
    else S.Vz[e - NZ * NZ] = S.G[N * NQ + e - NZ * NZ];
  }
  if (lane == 0) *S.ok = T(1);
  __syncwarp();
  for (int k = N - 1; k >= 0; --k) {
    const T* Jk = S.J + k * NX * NZ;
    const T* Hk = S.H + k * NQ * NQ;
    const T* Gk = S.G + k * NQ;
    // phase 1: P = Vzz [A|B] (columns u_prev are 0), qv = l + [A|B]' Vz
    for (int e = lane; e < NZ * NZ + NQ; e += WARP) {
      if (e < NZ * NZ) {
        const int i = e / NZ, jj = e % NZ;
        const int j = jj < NX ? jj : jj + NU;
        T acc = T(0);
        for (int m = 0; m < NX; ++m) acc += S.Vzz[i * NZ + m] * F(Jk, m, j);
        if (j >= NZ) acc += S.Vzz[i * NZ + j - NU];
        S.P[i * NQ + j] = acc;
      } else {
        const int a = e - NZ * NZ;
        T acc = T(0);
        for (int m = 0; m < NX; ++m) acc += F(Jk, m, a) * S.Vz[m];
        if (a >= NZ) acc += S.Vz[a - NU];
        S.qv[a] = Gk[a] + acc;
      }
    }
    __syncwarp();
    // phase 2: Qzz, Quz, Quu = the quads + [A|B]' P
    for (int e = lane; e < NZ * NZ + NU * NZ + NU * NU; e += WARP) {
      int a, b;
      if (e < NZ * NZ) {
        a = e / NZ;
        b = e % NZ;
      } else if (e < NZ * NZ + NU * NZ) {
        a = NZ + (e - NZ * NZ) / NZ;
        b = (e - NZ * NZ) % NZ;
      } else {
        a = NZ + (e - NZ * NZ - NU * NZ) / NU;
        b = NZ + (e - NZ * NZ - NU * NZ) % NU;
      }
      T acc = T(0);
      if (b < NX || b >= NZ) {  // P's u_prev columns are 0
        if (a < NX || a >= NZ) {
          for (int m = 0; m < NX; ++m) acc += F(Jk, m, a) * S.P[m * NQ + b];
          if (a >= NZ) acc += S.P[(a - NU) * NQ + b];
        }
      }
      S.Q[a * NQ + b] = Hk[a * NQ + b] + acc;
    }
    __syncwarp();
    // phase 3: [k | K] = -(Quu + reg I)^{-1} [Qu | Quz] (closed-form 2x2
    // inverse, on every lane), then Vz' = Qz + K'Quu k + K'Qu + Quz'k and
    // Vzz' = Qzz + K'Quu K + K'Quz + Quz'K, symmetrised
    const T* Quu = S.Q + NZ * NQ + NZ;      // row stride NQ
    const T* Quz = S.Q + NZ * NQ;           // row stride NQ
    const T q00 = Quu[0], q01 = Quu[1], q10 = Quu[NQ], q11 = Quu[NQ + 1];
    const T ra = q00 + reg, rb = q01, rc = q10, rd = q11 + reg;
    const T det = ra * rd - rb * rc;
    const T i00 = rd / det, i01 = -rb / det, i10 = -rc / det, i11 = ra / det;
    const T* qu = S.qv + NZ;
    const T k0 = -(i00 * qu[0] + i01 * qu[1]);
    const T k1 = -(i10 * qu[0] + i11 * qu[1]);
    for (int e = lane; e < NZ * (NZ + 1) / 2 + NZ; e += WARP) {
      if (e < NZ * (NZ + 1) / 2) {
        // (i, j), i <= j, row-major over the upper triangle
        int i = 0, rem = e;
        while (rem >= NZ - i) {
          rem -= NZ - i;
          ++i;
        }
        const int j = i + rem;
        const T K0i = -(i00 * Quz[i] + i01 * Quz[NQ + i]);
        const T K1i = -(i10 * Quz[i] + i11 * Quz[NQ + i]);
        const T K0j = -(i00 * Quz[j] + i01 * Quz[NQ + j]);
        const T K1j = -(i10 * Quz[j] + i11 * Quz[NQ + j]);
        const T KQ0i = K0i * q00 + K1i * q10, KQ1i = K0i * q01 + K1i * q11;
        const T KQ0j = K0j * q00 + K1j * q10, KQ1j = K0j * q01 + K1j * q11;
        const T vij = S.Q[i * NQ + j] + (KQ0i * K0j + KQ1i * K1j) +
                      (K0i * Quz[j] + K1i * Quz[NQ + j]) + (Quz[i] * K0j + Quz[NQ + i] * K1j);
        const T vji = S.Q[j * NQ + i] + (KQ0j * K0i + KQ1j * K1i) +
                      (K0j * Quz[i] + K1j * Quz[NQ + i]) + (Quz[j] * K0i + Quz[NQ + j] * K1i);
        const T sym = T(0.5) * (vij + vji);
        S.Vzz[i * NZ + j] = sym;
        S.Vzz[j * NZ + i] = sym;
      } else {
        const int j = e - NZ * (NZ + 1) / 2;
        const T K0j = -(i00 * Quz[j] + i01 * Quz[NQ + j]);
        const T K1j = -(i10 * Quz[j] + i11 * Quz[NQ + j]);
        const T KQ0j = K0j * q00 + K1j * q10, KQ1j = K0j * q01 + K1j * q11;
        S.Vz[j] = S.qv[j] + (KQ0j * k0 + KQ1j * k1) + (K0j * qu[0] + K1j * qu[1]) +
                  (Quz[j] * k0 + Quz[NQ + j] * k1);
        S.Ks[(k * NU + 0) * NZ + j] = K0j;
        S.Ks[(k * NU + 1) * NZ + j] = K1j;
        if (j == 0) {
          S.ks[k * NU + 0] = k0;
          S.ks[k * NU + 1] = k1;
          if (!(m_finite(k0) && m_finite(k1))) *S.ok = T(0);
        }
      }
    }
    __syncwarp();
  }
}

// Blocks of MAX_WARPS warps that one SM must hold at once: 3 in float32
// with the table in global memory, which keeps a thread within 168
// registers (a fleet's global placement runs 3 blocks per SM against the
// shared placement's 2); 1 elsewhere, where shared memory sets the blocks
// per SM whatever the registers.
template <typename T, bool GTAB>
constexpr int MIN_BLOCKS = sizeof(T) == 4 && GTAB ? 3 : 1;

// The whole solve for B instances, one warp each (see the note at the top).
// GTAB: the table stays in global memory (the global placement).  GWS: the
// scalars and the slices, laid out as in shared memory, are the block's
// part of the workspace `ws` (the workspace placement; the table global).
template <typename T, bool GTAB, bool GWS>
__global__ void __launch_bounds__(MAX_WARPS * WARP, MIN_BLOCKS<T, GTAB>) ilqr_solve_kernel(
    const T* __restrict__ z0, const T* __restrict__ us_init, const T* __restrict__ lam_init,
    const T* __restrict__ tables, const T* __restrict__ alphas, const T* __restrict__ scal,
    T* __restrict__ us_out, T* __restrict__ zs_out, T* __restrict__ lam_out,
    T* __restrict__ cost_out, T* __restrict__ viol_out, T* __restrict__ ws, int Bt, int W, int N,
    int L, int n_con, int n, int substeps, int al_iters, int ilqr_iters, T rho_init, T rho_scale,
    T reg_init) {
  static_assert(GTAB || !GWS, "the workspace placement reads the table from global memory");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sc = GWS ? ws + (size_t)blockIdx.x * (NS + (size_t)W * solve_slice_elems(N, L, n_con))
              : reinterpret_cast<T*>(smem_raw);
  T* tab_s = sc + NS;
  for (int i = threadIdx.x; i < NS; i += blockDim.x) sc[i] = scal[i];
  if (!GTAB)
    for (int i = threadIdx.x; i < 4 * n; i += blockDim.x) tab_s[i] = tables[i];
  __syncthreads();
  const T* tab = GTAB ? tables : tab_s;

  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int b = blockIdx.x * W + warp;
  if (b >= Bt) return;  // no block-wide barrier follows
  T* slices = GTAB ? tab_s : tab_s + 4 * n;
  Slice<T> S(slices + (size_t)warp * solve_slice_elems(N, L, n_con), N, L, n_con);
  const int Np = N + 1;

  // inputs and the rollout of us_init
  const T* z0b = z0 + (size_t)b * NZ;
  for (int e = lane; e < N * NU; e += WARP) S.us[e] = us_init[(size_t)b * N * NU + e];
  for (int e = lane; e < Np * n_con; e += WARP) S.lam[e] = lam_init[(size_t)b * Np * n_con + e];
  __syncwarp();
  if (lane == 0) {
    T z[NZ];
    for (int i = 0; i < NZ; ++i) S.zs[i] = z[i] = z0b[i];
    for (int k = 0; k < N; ++k) {
      dyn_step(z, S.us + k * NU, tab, n, sc, substeps);
      for (int i = 0; i < NZ; ++i) S.zs[(k + 1) * NZ + i] = z[i];
    }
  }
  __syncwarp();

  constexpr int lin_groups = (NZ + LIN_COLS - 1) / LIN_COLS;
  T rho = rho_init;
  for (int al = 0; al < al_iters; ++al) {
    // the AL cost of the current trajectory, summed in stage order
    for (int k = lane; k < Np; k += WARP) {
      S.scr[k] = k < N ? al_stage_cost(S.zs + k * NZ, S.us + k * NU, S.lam + k * n_con, rho, n_con,
                                       tab, n, sc)
                       : al_terminal_cost(S.zs + N * NZ, S.lam + N * n_con, rho, n_con, tab, n, sc);
    }
    __syncwarp();
    T stage_sum = T(0);
    for (int k = 0; k < N; ++k) stage_sum += S.scr[k];
    T cost = stage_sum + S.scr[N];
    T reg = reg_init;
    __syncwarp();

    for (int it = 0; it < ilqr_iters; ++it) {
      // linearisation: one (stage, group of C tangent columns) per lane
      for (int e = lane; e < N * lin_groups; e += WARP) {
        const int k = e / lin_groups, g = e % lin_groups;
        step_jacobian_columns<T, LIN_COLS>(S.zs + k * NZ, S.us + k * NU, g * LIN_COLS, tab, n, sc,
                                           substeps, S.J + k * NX * NZ);
      }
      // GN quads: one stage per lane (the terminal at u = u_prev)
      for (int k = lane; k < Np; k += WARP) {
        const bool term = k == N;
        const T* z = S.zs + k * NZ;
        stage_quads(z, term ? z + NX : S.us + k * NU, S.lam + k * n_con, rho, term, n_con, tab,
                    n, sc, S.H + k * NQ * NQ, S.G + k * NQ);
      }
      __syncwarp();
      riccati(S, N, reg, lane);

      // ladder: rung r on lane r % 32
      for (int r = lane; r < L; r += WARP) {
        const T alpha = alphas[r];
        T z[NZ], u[NU];
        for (int i = 0; i < NZ; ++i) S.zall[r * NZ + i] = z[i] = S.zs[i];
        T acc = T(0);
        for (int k = 0; k < N; ++k) {
          const T* zr = S.zs + k * NZ;
          for (int c = 0; c < NU; ++c) {
            T fb = T(0);
            for (int j = 0; j < NZ; ++j) fb += S.Ks[(k * NU + c) * NZ + j] * (z[j] - zr[j]);
            u[c] = S.us[k * NU + c] + alpha * S.ks[k * NU + c] + fb;
          }
          acc += al_stage_cost(z, u, S.lam + k * n_con, rho, n_con, tab, n, sc);
          dyn_step(z, u, tab, n, sc, substeps);
          for (int c = 0; c < NU; ++c) S.uall[(k * L + r) * NU + c] = u[c];
          for (int i = 0; i < NZ; ++i) S.zall[((k + 1) * L + r) * NZ + i] = z[i];
        }
        const T c = acc + al_terminal_cost(z, S.lam + N * n_con, rho, n_con, tab, n, sc);
        S.scr[r] = m_finite(c) ? c : m_inf(c);
      }
      __syncwarp();
      // the lowest-index minimal rung, found by every lane
      T new_cost = S.scr[0];
      int best = 0;
      for (int r = 1; r < L; ++r) {
        if (S.scr[r] < new_cost) {
          new_cost = S.scr[r];
          best = r;
        }
      }
      const bool improved = new_cost < cost && *S.ok > T(0.5);
      if (improved) {
        for (int e = lane; e < Np * NZ; e += WARP)
          S.zs[e] = S.zall[((e / NZ) * L + best) * NZ + e % NZ];
        for (int e = lane; e < N * NU; e += WARP)
          S.us[e] = S.uall[((e / NU) * L + best) * NU + e % NU];
        cost = new_cost;
        const T half = reg * T(0.5);
        reg = half < reg_init ? reg_init : half;
      } else {
        reg = reg * T(100);
      }
      __syncwarp();
    }

    // multiplier update on the tightened band, terminal input rows masked
    for (int k = lane; k < Np; k += WARP) {
      T g[N_CON + 2];
      const T zero_u[NU] = {T(0), T(0)};
      const bool term = k == N;
      constraints(S.zs + k * NZ, term ? zero_u : S.us + k * NU, term, sc[MARGIN], n_con, tab, n,
                  sc, g);
      for (int i = 0; i < n_con; ++i)
        S.lam[k * n_con + i] = relu_nan(S.lam[k * n_con + i] + rho * g[i]);
    }
    __syncwarp();
    rho = rho * rho_scale;
  }

  // outputs: the AL-free cost and the max violation on the true band
  for (int k = lane; k < Np; k += WARP) {
    const T zero_u[NU] = {T(0), T(0)};
    const bool term = k == N;
    const T* z = S.zs + k * NZ;
    S.scr[k] = term ? terminal_cost(z, sc) : stage_cost(z, S.us + k * NU, tab, n, sc);
    T g[N_CON + 2];
    constraints(z, term ? zero_u : S.us + k * NU, term, T(0), n_con, tab, n, sc, g);
    T v = -m_inf(T(0));
    for (int i = 0; i < n_con; ++i)
      if (!term || i < 10 || i >= N_CON) v = max_nan(v, g[i]);
    S.scr[Np + k] = v;
  }
  __syncwarp();
  for (int e = lane; e < Np * NZ; e += WARP) zs_out[(size_t)b * Np * NZ + e] = S.zs[e];
  for (int e = lane; e < N * NU; e += WARP) us_out[(size_t)b * N * NU + e] = S.us[e];
  for (int e = lane; e < Np * n_con; e += WARP) lam_out[(size_t)b * Np * n_con + e] = S.lam[e];
  if (lane == 0) {
    T stage_sum = T(0), viol = S.scr[Np];
    for (int k = 0; k < N; ++k) stage_sum += S.scr[k];
    for (int k = 1; k < N; ++k) viol = max_nan(viol, S.scr[Np + k]);
    cost_out[b] = stage_sum + S.scr[N];
    viol_out[b] = max_nan(viol, S.scr[Np + N]);
  }
}

// Sizes the kernel takes: an OCP's slice is indexed with 32-bit ints.
inline bool solve_sizes_ok(int W, int N, int L, int n_con) {
  return W >= 1 && W <= MAX_WARPS && N >= 1 && L >= 1 && (n_con == N_CON || n_con == N_CON + 2) &&
         solve_slice_elems(N, L, n_con) <= INT_MAX;
}

// Dynamic shared memory of one block of W instances with the table in
// shared (gtab = 0) or global memory, or 0 if the sizes are not ones the
// kernel takes or do not fit a block.
template <typename T>
size_t solve_smem_bytes(int W, int N, int L, int n_con, int n, int gtab) {
  if (!solve_sizes_ok(W, N, L, n_con) || n < 2) return 0;
  const size_t table = gtab ? 0 : 4 * (size_t)n;
  const size_t bytes = (NS + table + W * solve_slice_elems(N, L, n_con)) * sizeof(T);
  return bytes <= MAX_SMEM ? bytes : 0;
}

// Elements of one block's part of the workspace placement's workspace: the
// scalars and W slices (0 if the sizes are not ones the kernel takes).
inline size_t solve_workspace_elems(int W, int N, int L, int n_con) {
  if (!solve_sizes_ok(W, N, L, n_con)) return 0;
  return NS + (size_t)W * solve_slice_elems(N, L, n_con);
}

// Above 48 KB a kernel needs its dynamic shared memory limit raised first.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The instantiation of a placement: the table in global memory (gtab), the
// scalars and slices in the workspace (ws).
template <typename T>
auto solve_kernel(bool gtab, bool ws) {
  return ws ? ilqr_solve_kernel<T, true, true>
            : (gtab ? ilqr_solve_kernel<T, true, false> : ilqr_solve_kernel<T, false, false>);
}

template <typename T>
int launch_solve(const T* z0, const T* us_init, const T* lam_init, const T* tables,
                 const T* alphas, const T* scal, T* us_out, T* zs_out, T* lam_out, T* cost_out,
                 T* viol_out, T* ws, int Bt, int W, int N, int L, int n_con, int n, int substeps,
                 int al_iters, int ilqr_iters, int gtab, double rho_init, double rho_scale,
                 double reg_init, void* stream) {
  const size_t bytes = ws ? 0 : solve_smem_bytes<T>(W, N, L, n_con, n, gtab);
  if ((ws ? !solve_sizes_ok(W, N, L, n_con) || n < 2 : bytes == 0) || Bt < 1 || substeps < 1 ||
      al_iters < 0 || ilqr_iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = solve_kernel<T>(gtab, ws != nullptr);
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (Bt + W - 1) / W;
  kernel<<<grid, W * WARP, bytes, static_cast<cudaStream_t>(stream)>>>(z0, us_init, lam_init, tables, alphas, scal, us_out, zs_out, lam_out, cost_out, viol_out, ws, Bt, W, N, L, n_con, n, substeps, al_iters, ilqr_iters, T(rho_init), T(rho_scale), T(reg_init));
  return static_cast<int>(cudaGetLastError());
}

// Blocks of W OCPs that one SM holds at once in a placement, at the
// launch's dynamic shared memory: what its registers, shared memory and
// threads allow together (cudaOccupancyMaxActiveBlocksPerMultiprocessor on
// the current device); minus the cudaError_t where it fails or the sizes are
// refused.
template <typename T>
int solve_blocks_per_sm(int W, int N, int L, int n_con, int n, int gtab, int ws) {
  const size_t bytes = ws ? 0 : solve_smem_bytes<T>(W, N, L, n_con, n, gtab);
  if (ws ? !solve_sizes_ok(W, N, L, n_con) || n < 2 : bytes == 0) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = solve_kernel<T>(gtab || ws, ws);
  cudaError_t err = allow_smem(kernel, bytes);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, W * WARP, bytes);
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace

extern "C" int lto_ilqr_solve_f32(const float* z0, const float* us_init, const float* lam_init,
                                  const float* tables, const float* alphas, const float* scal,
                                  float* us_out, float* zs_out, float* lam_out, float* cost_out,
                                  float* viol_out, float* workspace, int Bt, int W, int N, int L,
                                  int n_con, int n, int substeps, int al_iters, int ilqr_iters,
                                  int global_table, double rho_init, double rho_scale,
                                  double reg_init, void* stream) {
  return launch_solve<float>(z0, us_init, lam_init, tables, alphas, scal, us_out, zs_out, lam_out,
                             cost_out, viol_out, workspace, Bt, W, N, L, n_con, n, substeps,
                             al_iters, ilqr_iters, global_table, rho_init, rho_scale, reg_init,
                             stream);
}

extern "C" int lto_ilqr_solve_f64(const double* z0, const double* us_init,
                                  const double* lam_init, const double* tables,
                                  const double* alphas, const double* scal, double* us_out,
                                  double* zs_out, double* lam_out, double* cost_out,
                                  double* viol_out, double* workspace, int Bt, int W, int N, int L,
                                  int n_con, int n, int substeps, int al_iters, int ilqr_iters,
                                  int global_table, double rho_init, double rho_scale,
                                  double reg_init, void* stream) {
  return launch_solve<double>(z0, us_init, lam_init, tables, alphas, scal, us_out, zs_out,
                              lam_out, cost_out, viol_out, workspace, Bt, W, N, L, n_con, n,
                              substeps, al_iters, ilqr_iters, global_table, rho_init, rho_scale,
                              reg_init, stream);
}

// Dynamic shared memory of a launch in shared memory (element size 4 or 8)
// with the table in shared (global_table = 0) or global memory, 0 if
// refused.
extern "C" long long lto_ilqr_solve_smem_bytes(int elem_size, int W, int N, int L, int n_con,
                                               int n, int global_table) {
  const size_t bytes = elem_size == 8
                           ? solve_smem_bytes<double>(W, N, L, n_con, n, global_table)
                           : solve_smem_bytes<float>(W, N, L, n_con, n, global_table);
  return static_cast<long long>(bytes);
}

// Elements of one block's part of the workspace of a launch in the
// workspace placement, 0 if refused.
extern "C" long long lto_ilqr_solve_workspace_elems(int W, int N, int L, int n_con) {
  return static_cast<long long>(solve_workspace_elems(W, N, L, n_con));
}

// Blocks per SM of a launch (element size 4 or 8) of W OCPs a block with the
// table in shared (global_table = 0) or global memory, or in the workspace
// placement (workspace = 1); minus the cudaError_t where it fails.
extern "C" int lto_ilqr_solve_blocks_per_sm(int elem_size, int W, int N, int L, int n_con, int n,
                                            int global_table, int workspace) {
  return elem_size == 8
             ? solve_blocks_per_sm<double>(W, N, L, n_con, n, global_table, workspace)
             : solve_blocks_per_sm<float>(W, N, L, n_con, n, global_table, workspace);
}
