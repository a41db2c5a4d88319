// One fused AL-iLQR iteration: Riccati backward sweep + line-search ladder
// rollout + rung choice, for one OCP or for a batch of independent OCPs.
// CUDA C++ for sm_90a.
//
// Replaces two Pallas TPU kernels of lap_time_optimization_tpu/ops/:
//  * pallas_ilqr.py `backward_forward` (body `_kernel`): one OCP, `ilqr_kernel`;
//    plain PyTorch twin ops/ilqr.py::backward_forward_reference;
//  * pallas_ilqr_batch.py `backward_forward_batch` (body `_kernel`): B OCPs
//    with a Levenberg reg per instance, `ilqr_batch_kernel`; plain PyTorch
//    twin ops/ilqr.py::backward_forward_batch_reference.
// Both kernels run one device function, `ilqr_iteration`, so the physics,
// the AL costs and the Riccati sweep exist once.
//
// What bounds it: latency, not bytes or FLOPs.  The backward pass is N serial
// stages of 10x10 products (about 10 FMAs per output element); each ladder
// rung is N x substeps x 4 serial evaluations of the bicycle RHS (trig and
// divisions).  At the main path's shapes (N=10, L=6, substeps=2, n=846) the
// whole call reads ~30 KB and does ~10^5 flops, on one SM.
//
// Bring-up design: one thread block of 128 threads per OCP.
//  * The (4, n) lookup tables, the gains, the value function and the ladder's
//    trajectories live in dynamic shared memory.  Lookups use the uniform-grid
//    index arithmetic of mpc/track.py MPCTrack._uinterp: the cell index clipped
//    to [0, n-2] as an integer, frac clipped to [0, 1], and the lap wrap
//    s - floor(s/s_max)*s_max (computed as jnp.mod / torch.remainder do).
//  * Backward pass: one thread per output element of each small product, with
//    __syncthreads() between products; the 2x2 Quu inverse is closed form.
//  * Ladder: one thread per rung runs the scalar RK4 chain and accumulates the
//    PHR augmented-Lagrangian cost; thread 0 then picks the lowest-index rung
//    among the minimal finite costs (NaN counts as +inf) and all threads copy
//    it out.
//  * Plain FMA loops in full precision: no tensor cores, no TF32 (the Riccati
//    recursion needs full fp32, the hazard the Pallas kernel's HIGHEST
//    precision guards against).  Trig is libdevice's (sin/cos/tan/atan/atan2).
// Making it fast is later work: fusing the linearisation and quadraticisation
// into it and capturing a control cycle in a CUDA graph.
//
// Batch design (bring-up): a grid of B blocks, block b running the body above
// on instance b with reg = reg_b[b].  Every block loads the whole (4, n) table
// into its own shared memory (13.5 KB in f32, 27 KB in f64 at n = 846), so
// there is no per-instance table window and no clamp at a window edge: the
// batch kernel equals the single-instance kernel on every instance.  The
// TPU kernel's cost-only ladder pass and re-roll of the winning rung become
// the stored ladder of the body, which returns the same trajectories.  What
// bounds it: the same latency as one OCP (~10^5 dependent flops on one SM),
// with the B blocks in parallel; past what the card holds at once (132 SMs
// times the blocks that registers and shared memory let share an SM) they
// run in waves, and 128 threads per instance leave most lanes idle in the
// serial ladder.  A later redesign maps one instance to a warp or a thread,
// so that all B instances fit in one wave and the table is loaded once per SM.
//
// C interface (one entry point per type and kernel): every pointer is a
// contiguous device buffer in the layouts of ops/ilqr.py::backward_forward
// (with a leading instance axis for backward_forward_batch); the launch goes
// onto `stream`, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int NX = 8;
constexpr int NU = 2;
constexpr int NZ = NX + NU;
constexpr int N_CON = 14;
constexpr int THREADS = 128;

// scalar-vector layout: must mirror ops/ilqr.py SCAL_FIELDS
enum Scal {
  RHO, REG, S_MAX, INV_DS, H,
  MASS, LF, LR, IZ,
  BF, CF, DF, BR, CR, DR,
  CM, CR0, CR2,
  QN, QMU, QB, RDELTA, RTHR, VREF_SCALE,
  MU_MAX, STEER_MAX, THR_MAX, DSTEER_MAX, DTHR_MAX,
  HALF_LEN, HALF_WID, MARGIN, PTV,
  NS
};

constexpr double GRAV = 9.81;

__device__ __forceinline__ float m_sin(float x) { return sinf(x); }
__device__ __forceinline__ double m_sin(double x) { return sin(x); }
__device__ __forceinline__ float m_cos(float x) { return cosf(x); }
__device__ __forceinline__ double m_cos(double x) { return cos(x); }
__device__ __forceinline__ float m_tan(float x) { return tanf(x); }
__device__ __forceinline__ double m_tan(double x) { return tan(x); }
__device__ __forceinline__ float m_atan(float x) { return atanf(x); }
__device__ __forceinline__ double m_atan(double x) { return atan(x); }
__device__ __forceinline__ float m_atan2(float y, float x) { return atan2f(y, x); }
__device__ __forceinline__ double m_atan2(double y, double x) { return atan2(y, x); }
__device__ __forceinline__ float m_fmod(float x, float y) { return fmodf(x, y); }
__device__ __forceinline__ double m_fmod(double x, double y) { return fmod(x, y); }
__device__ __forceinline__ float m_floor(float x) { return floorf(x); }
__device__ __forceinline__ double m_floor(double x) { return floor(x); }
__device__ __forceinline__ bool m_finite(float x) { return isfinite(x); }
__device__ __forceinline__ bool m_finite(double x) { return isfinite(x); }
__device__ __forceinline__ float m_inf(float) { return CUDART_INF_F; }
__device__ __forceinline__ double m_inf(double) { return CUDART_INF; }

// max(0, x) that keeps NaN, as jnp.maximum / torch.clamp do
template <typename T>
__device__ __forceinline__ T relu_nan(T x) { return x < T(0) ? T(0) : x; }

// piecewise-linear lookup of one table row (MPCTrack._uinterp semantics)
template <typename T>
__device__ T lookup(const T* row, int n, T s, const T* sc) {
  const T s_max = sc[S_MAX];
  T sw = m_fmod(s, s_max);
  if (sw != T(0) && ((sw < T(0)) != (s_max < T(0)))) sw += s_max;
  const T t = sw * sc[INV_DS];
  int i;
  if (t >= T(n - 2)) i = n - 2;
  else if (t >= T(0)) i = (int)m_floor(t);
  else i = 0;  // negative or NaN
  T frac = t - T(i);
  frac = frac < T(0) ? T(0) : (frac > T(1) ? T(1) : frac);
  return row[i] * (T(1) - frac) + row[i + 1] * frac;
}

template <typename T>
struct Tyres {
  T Fy_f, Fy_r;
};

// negated Pacejka lateral forces with the static load split
template <typename T>
__device__ Tyres<T> tyre_forces(T vx, T vy, T r, T delta, const T* sc) {
  const T lf = sc[LF], lr = sc[LR], m = sc[MASS];
  const T alpha_f = m_atan2(vy + lf * r, vx) - delta;
  const T alpha_r = m_atan2(vy - lr * r, vx);
  const T wheelbase = lf + lr;
  const T Fn_f = lr * m * T(GRAV) / wheelbase;
  const T Fn_r = lf * m * T(GRAV) / wheelbase;
  Tyres<T> out;
  out.Fy_f = -Fn_f * sc[DF] * m_sin(sc[CF] * m_atan(sc[BF] * alpha_f));
  out.Fy_r = -Fn_r * sc[DR] * m_sin(sc[CR] * m_atan(sc[BR] * alpha_r));
  return out;
}

// curvilinear bicycle RHS (models/bicycle.py BicycleModel.rhs, torque
// vectoring included: ptv is 0 when the model has it off)
template <typename T>
__device__ void rhs(const T* x, const T* u, const T* tab, int n, const T* sc, T* xdot) {
  const T s = x[0], nn = x[1], mu = x[2], vx = x[3], vy = x[4], r = x[5];
  const T delta = x[6], thr = x[7];
  const T m = sc[MASS], lf = sc[LF], lr = sc[LR];
  const T k = lookup(tab, n, s, sc);
  const T cos_mu = m_cos(mu), sin_mu = m_sin(mu);
  const T sdot = (vx * cos_mu - vy * sin_mu) / (T(1) - nn * k);
  const Tyres<T> f = tyre_forces(vx, vy, r, delta, sc);
  const T Fx = sc[CM] * thr - sc[CR0] - sc[CR2] * vx * vx;
  const T cos_d = m_cos(delta), sin_d = m_sin(delta);
  const T rt = m_tan(delta) * vx / (lf + lr);
  const T Mtv = sc[PTV] * (rt - r);
  xdot[0] = sdot;
  xdot[1] = vx * sin_mu + vy * cos_mu;
  xdot[2] = r - k * sdot;
  xdot[3] = (Fx - f.Fy_f * sin_d + m * vy * r) / m;
  xdot[4] = (f.Fy_r + f.Fy_f * cos_d - m * vx * r) / m;
  xdot[5] = (f.Fy_f * lf * cos_d - f.Fy_r * lr + Mtv) / sc[IZ];
  xdot[6] = u[0];
  xdot[7] = u[1];
}

// augmented RK4 step: x integrates over `substeps` increments, u_prev := u
template <typename T>
__device__ void dyn_step(T* z, const T* u, const T* tab, int n, const T* sc, int substeps) {
  const T h = sc[H];
  T x[NX], k1[NX], k2[NX], k3[NX], k4[NX], xt[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = z[i];
  for (int sub = 0; sub < substeps; ++sub) {
    rhs(x, u, tab, n, sc, k1);
#pragma unroll
    for (int i = 0; i < NX; ++i) xt[i] = x[i] + T(0.5) * h * k1[i];
    rhs(xt, u, tab, n, sc, k2);
#pragma unroll
    for (int i = 0; i < NX; ++i) xt[i] = x[i] + T(0.5) * h * k2[i];
    rhs(xt, u, tab, n, sc, k3);
#pragma unroll
    for (int i = 0; i < NX; ++i) xt[i] = x[i] + h * k3[i];
    rhs(xt, u, tab, n, sc, k4);
#pragma unroll
    for (int i = 0; i < NX; ++i)
      x[i] = x[i] + (h / T(6)) * (k1[i] + T(2) * k2[i] + T(2) * k3[i] + k4[i]);
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) z[i] = x[i];
  z[NX] = u[0];
  z[NX + 1] = u[1];
}

// PHR penalty sum_i (max(0, lam_i + rho g_i)^2 - lam_i^2) / (2 rho) over the
// solver-tightened constraints (mpc/solver.py tightened_constraints); at the
// terminal stage the input rows 10-13 are replaced by -1
template <typename T>
__device__ T al_penalty(const T* z, const T* u, const T* lam, int n_con, bool terminal,
                        const T* tab, int n, const T* sc) {
  const T s = z[0], nn = z[1], mu = z[2], vx = z[3], delta = z[6], thr = z[7];
  const T nl = lookup(tab + 1 * n, n, s, sc);
  const T nr = lookup(tab + 2 * n, n, s, sc);
  const T abs_mu = mu >= T(0) ? mu : -mu;
  const T lon = sc[HALF_LEN] * m_sin(abs_mu);
  const T lat = sc[HALF_WID] * m_cos(mu);
  T g[N_CON + 2];
  g[0] = nn - lon + lat - nl + sc[MARGIN];
  g[1] = -nn + lon + lat - nr + sc[MARGIN];
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
  const T rho = sc[RHO];
  T pen = T(0);
  for (int i = 0; i < n_con; ++i) {
    const T sh = relu_nan(lam[i] + rho * g[i]);
    pen += (sh * sh - lam[i] * lam[i]) / (T(2) * rho);
  }
  return pen;
}

// AL stage cost (mpc/solver.py al_stage_cost)
template <typename T>
__device__ T al_stage_cost(const T* z, const T* u, const T* lam, int n_con,
                           const T* tab, int n, const T* sc) {
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
  return lterm + rterm + al_penalty(z, u, lam, n_con, false, tab, n, sc);
}

// AL terminal cost (mpc/solver.py al_terminal_cost)
template <typename T>
__device__ T al_terminal_cost(const T* z, const T* lam, int n_con,
                              const T* tab, int n, const T* sc) {
  const T nn = z[1], mu = z[2], vy = z[4];
  const T zero_u[NU] = {T(0), T(0)};
  const T mterm = sc[QN] * (nn * nn) + sc[QMU] * (mu * mu) + vy * vy;
  return mterm + al_penalty(z, zero_u, lam, n_con, true, tab, n, sc);
}

// The kernels' common body: one iteration for one OCP, run by one block.
// Pointers are the instance's own; `reg` is its Levenberg regularisation.
template <typename T>
__device__ __forceinline__ void ilqr_iteration(
    T* smem, const T* __restrict__ A, const T* __restrict__ B, const T* __restrict__ lz,
    const T* __restrict__ lu, const T* __restrict__ lzz, const T* __restrict__ luu,
    const T* __restrict__ luz, const T* __restrict__ Vz_in, const T* __restrict__ Vzz_in,
    const T* __restrict__ zs, const T* __restrict__ us, const T* __restrict__ lams,
    const T* __restrict__ tables, const T* __restrict__ alphas, const T* __restrict__ scal,
    const T reg, T* __restrict__ zs_out, T* __restrict__ us_out, T* __restrict__ cost_out,
    T* __restrict__ ok_out, int N, int L, int n_con, int n, int substeps) {
  T* sc = smem;                       // NS
  T* tab = sc + NS;                   // 4 * n
  T* Vz = tab + 4 * n;                // NZ
  T* Vzz = Vz + NZ;                   // NZ*NZ
  T* VzzA = Vzz + NZ * NZ;            // NZ*NZ
  T* VzzB = VzzA + NZ * NZ;           // NZ*NU
  T* Qz = VzzB + NZ * NU;             // NZ
  T* Qu = Qz + NZ;                    // NU
  T* Qzz = Qu + NU;                   // NZ*NZ
  T* Quu = Qzz + NZ * NZ;             // NU*NU
  T* Quz = Quu + NU * NU;             // NU*NZ
  T* Vtmp = Quz + NU * NZ;            // NZ*NZ
  T* Vz_new = Vtmp + NZ * NZ;         // NZ
  T* ks = Vz_new + NZ;                // N*NU
  T* Ks = ks + N * NU;                // N*NU*NZ
  T* zall = Ks + N * NU * NZ;         // (N+1)*L*NZ
  T* uall = zall + (N + 1) * L * NZ;  // N*L*NU
  T* costs = uall + N * L * NU;       // L
  __shared__ int best_idx;
  __shared__ bool ok_s;

  const int tid = threadIdx.x;
  for (int i = tid; i < NS; i += THREADS) sc[i] = scal[i];
  for (int i = tid; i < 4 * n; i += THREADS) tab[i] = tables[i];
  for (int i = tid; i < NZ; i += THREADS) Vz[i] = Vz_in[i];
  for (int i = tid; i < NZ * NZ; i += THREADS) Vzz[i] = Vzz_in[i];
  if (tid == 0) ok_s = true;
  __syncthreads();

  // ------------------------------------------------------------- Riccati
  for (int k = N - 1; k >= 0; --k) {
    const T* Ak = A + k * NZ * NZ;
    const T* Bk = B + k * NZ * NU;
    // VzzA = Vzz A, VzzB = Vzz B, Qz = lz + A^T Vz, Qu = lu + B^T Vz
    if (tid < NZ * NZ) {
      const int i = tid / NZ, j = tid % NZ;
      T acc = T(0);
      for (int m = 0; m < NZ; ++m) acc += Vzz[i * NZ + m] * Ak[m * NZ + j];
      VzzA[tid] = acc;
    } else if (tid < NZ * NZ + NZ * NU) {
      const int e = tid - NZ * NZ, i = e / NU, c = e % NU;
      T acc = T(0);
      for (int m = 0; m < NZ; ++m) acc += Vzz[i * NZ + m] * Bk[m * NU + c];
      VzzB[e] = acc;
    } else {
      for (int e = tid - NZ * NZ - NZ * NU; e < NZ + NU; e += THREADS - NZ * NZ - NZ * NU) {
        T acc = T(0);
        if (e < NZ) {
          for (int m = 0; m < NZ; ++m) acc += Ak[m * NZ + e] * Vz[m];
          Qz[e] = lz[k * NZ + e] + acc;
        } else {
          const int c = e - NZ;
          for (int m = 0; m < NZ; ++m) acc += Bk[m * NU + c] * Vz[m];
          Qu[c] = lu[k * NU + c] + acc;
        }
      }
    }
    __syncthreads();
    // Qzz = lzz + A^T (Vzz A), Quz = luz + B^T (Vzz A), Quu = luu + B^T (Vzz B)
    if (tid < NZ * NZ) {
      const int i = tid / NZ, j = tid % NZ;
      T acc = T(0);
      for (int m = 0; m < NZ; ++m) acc += Ak[m * NZ + i] * VzzA[m * NZ + j];
      Qzz[tid] = lzz[k * NZ * NZ + tid] + acc;
    } else if (tid < NZ * NZ + NU * NZ) {
      const int e = tid - NZ * NZ, c = e / NZ, j = e % NZ;
      T acc = T(0);
      for (int m = 0; m < NZ; ++m) acc += Bk[m * NU + c] * VzzA[m * NZ + j];
      Quz[e] = luz[k * NU * NZ + e] + acc;
    } else if (tid < NZ * NZ + NU * NZ + NU * NU) {
      const int e = tid - NZ * NZ - NU * NZ, a = e / NU, c = e % NU;
      T acc = T(0);
      for (int m = 0; m < NZ; ++m) acc += Bk[m * NU + a] * VzzB[m * NU + c];
      Quu[e] = luu[k * NU * NU + e] + acc;
    }
    __syncthreads();
    // [k | K] = -(Quu + reg I)^{-1} [Qu | Quz], closed-form 2x2 inverse
    if (tid < NU * (1 + NZ)) {
      const int c = tid / (1 + NZ), col = tid % (1 + NZ);
      const T a = Quu[0] + reg, b = Quu[1], cc = Quu[2], d = Quu[3] + reg;
      const T det = a * d - b * cc;
      const T i0 = (c == 0 ? d : -cc) / det;
      const T i1 = (c == 0 ? -b : a) / det;
      const T r0 = col == 0 ? Qu[0] : Quz[0 * NZ + col - 1];
      const T r1 = col == 0 ? Qu[1] : Quz[1 * NZ + col - 1];
      const T v = -(i0 * r0 + i1 * r1);
      if (col == 0) ks[k * NU + c] = v;
      else Ks[(k * NU + c) * NZ + col - 1] = v;
    }
    __syncthreads();
    const T* kk = ks + k * NU;
    const T* KK = Ks + k * NU * NZ;
    // Vz' = Qz + K^T Quu k + K^T Qu + Quz^T k
    // Vzz' = Qzz + K^T Quu K + K^T Quz + Quz^T K   (symmetrised below)
    if (tid < NZ * NZ) {
      const int i = tid / NZ, j = tid % NZ;
      const T KQ0 = KK[0 * NZ + i] * Quu[0] + KK[1 * NZ + i] * Quu[2];
      const T KQ1 = KK[0 * NZ + i] * Quu[1] + KK[1 * NZ + i] * Quu[3];
      Vtmp[tid] = Qzz[tid] + (KQ0 * KK[0 * NZ + j] + KQ1 * KK[1 * NZ + j])
                  + (KK[0 * NZ + i] * Quz[0 * NZ + j] + KK[1 * NZ + i] * Quz[1 * NZ + j])
                  + (Quz[0 * NZ + i] * KK[0 * NZ + j] + Quz[1 * NZ + i] * KK[1 * NZ + j]);
    } else if (tid < NZ * NZ + NZ) {
      const int j = tid - NZ * NZ;
      const T KQ0 = KK[0 * NZ + j] * Quu[0] + KK[1 * NZ + j] * Quu[2];
      const T KQ1 = KK[0 * NZ + j] * Quu[1] + KK[1 * NZ + j] * Quu[3];
      Vz_new[j] = Qz[j] + (KQ0 * kk[0] + KQ1 * kk[1])
                  + (KK[0 * NZ + j] * Qu[0] + KK[1 * NZ + j] * Qu[1])
                  + (Quz[0 * NZ + j] * kk[0] + Quz[1 * NZ + j] * kk[1]);
    } else if (tid == NZ * NZ + NZ) {
      if (!(m_finite(kk[0]) && m_finite(kk[1]))) ok_s = false;
    }
    __syncthreads();
    if (tid < NZ * NZ) {
      const int i = tid / NZ, j = tid % NZ;
      Vzz[tid] = T(0.5) * (Vtmp[i * NZ + j] + Vtmp[j * NZ + i]);
    } else if (tid < NZ * NZ + NZ) {
      Vz[tid - NZ * NZ] = Vz_new[tid - NZ * NZ];
    }
    __syncthreads();
  }

  // ------------------------------------------------------ ladder rollout
  if (tid < L) {
    const T alpha = alphas[tid];
    T z[NZ], u[NU];
#pragma unroll
    for (int i = 0; i < NZ; ++i) {
      z[i] = zs[i];
      zall[tid * NZ + i] = z[i];
    }
    T acc = T(0);
    for (int k = 0; k < N; ++k) {
      const T* zr = zs + k * NZ;
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        T fb = T(0);
        for (int j = 0; j < NZ; ++j) fb += Ks[(k * NU + c) * NZ + j] * (z[j] - zr[j]);
        u[c] = us[k * NU + c] + alpha * ks[k * NU + c] + fb;
      }
      acc += al_stage_cost(z, u, lams + k * n_con, n_con, tab, n, sc);
      dyn_step(z, u, tab, n, sc, substeps);
#pragma unroll
      for (int c = 0; c < NU; ++c) uall[(k * L + tid) * NU + c] = u[c];
#pragma unroll
      for (int i = 0; i < NZ; ++i) zall[((k + 1) * L + tid) * NZ + i] = z[i];
    }
    const T c = acc + al_terminal_cost(z, lams + N * n_con, n_con, tab, n, sc);
    costs[tid] = m_finite(c) ? c : m_inf(c);
  }
  __syncthreads();

  // ----------------------------------------- pick the lowest-index best rung
  if (tid == 0) {
    T best = costs[0];
    int idx = 0;
    for (int r = 1; r < L; ++r) {
      if (costs[r] < best) {
        best = costs[r];
        idx = r;
      }
    }
    best_idx = idx;
    *cost_out = best;
    *ok_out = ok_s ? T(1) : T(0);
  }
  __syncthreads();
  for (int e = tid; e < (N + 1) * NZ; e += THREADS) {
    const int k = e / NZ, i = e % NZ;
    zs_out[e] = zall[(k * L + best_idx) * NZ + i];
  }
  for (int e = tid; e < N * NU; e += THREADS) {
    const int k = e / NU, c = e % NU;
    us_out[e] = uall[(k * L + best_idx) * NU + c];
  }
}

// One OCP; its reg is the `reg` entry of `scal`.
template <typename T>
__global__ void __launch_bounds__(THREADS) ilqr_kernel(
    const T* __restrict__ A, const T* __restrict__ B, const T* __restrict__ lz,
    const T* __restrict__ lu, const T* __restrict__ lzz, const T* __restrict__ luu,
    const T* __restrict__ luz, const T* __restrict__ Vz, const T* __restrict__ Vzz,
    const T* __restrict__ zs, const T* __restrict__ us, const T* __restrict__ lams,
    const T* __restrict__ tables, const T* __restrict__ alphas, const T* __restrict__ scal,
    T* __restrict__ zs_out, T* __restrict__ us_out, T* __restrict__ cost_out,
    T* __restrict__ ok_out, int N, int L, int n_con, int n, int substeps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ilqr_iteration(reinterpret_cast<T*>(smem_raw), A, B, lz, lu, lzz, luu, luz, Vz, Vzz, zs,
                 us, lams, tables, alphas, scal, scal[REG], zs_out, us_out, cost_out, ok_out,
                 N, L, n_con, n, substeps);
}

// B independent OCPs, block b on instance b with reg = reg_b[b] (the `reg`
// entry of the shared `scal` is ignored); tables, alphas and scal are shared.
template <typename T>
__global__ void __launch_bounds__(THREADS) ilqr_batch_kernel(
    const T* __restrict__ A, const T* __restrict__ B, const T* __restrict__ lz,
    const T* __restrict__ lu, const T* __restrict__ lzz, const T* __restrict__ luu,
    const T* __restrict__ luz, const T* __restrict__ Vz, const T* __restrict__ Vzz,
    const T* __restrict__ zs, const T* __restrict__ us, const T* __restrict__ lams,
    const T* __restrict__ tables, const T* __restrict__ alphas, const T* __restrict__ scal,
    const T* __restrict__ reg_b, T* __restrict__ zs_out, T* __restrict__ us_out,
    T* __restrict__ cost_out, T* __restrict__ ok_out, int N, int L, int n_con, int n,
    int substeps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t b = blockIdx.x;
  const size_t zn = (size_t)(N + 1) * NZ, un = (size_t)N * NU;
  ilqr_iteration(reinterpret_cast<T*>(smem_raw), A + b * N * NZ * NZ, B + b * N * NZ * NU,
                 lz + b * N * NZ, lu + b * un, lzz + b * N * NZ * NZ, luu + b * N * NU * NU,
                 luz + b * N * NU * NZ, Vz + b * NZ, Vzz + b * NZ * NZ, zs + b * zn,
                 us + b * un, lams + b * (N + 1) * n_con, tables, alphas, scal, reg_b[b],
                 zs_out + b * zn, us_out + b * un, cost_out + b, ok_out + b, N, L, n_con, n,
                 substeps);
}

// Dynamic shared memory of one block (see the carve-up in ilqr_iteration),
// or 0 if the sizes are not ones the kernels take.
template <typename T>
size_t smem_bytes(int N, int L, int n_con, int n, int substeps) {
  if (N < 1 || L < 1 || L > THREADS || n < 2 || substeps < 1 ||
      (n_con != N_CON && n_con != N_CON + 2)) {
    return 0;
  }
  const size_t elems = NS + 4 * (size_t)n + NZ + 4 * NZ * NZ + NZ * NU + NZ + NU +
                       NU * NU + NU * NZ + NZ + (size_t)N * NU + (size_t)N * NU * NZ +
                       (size_t)(N + 1) * L * NZ + (size_t)N * L * NU + L;
  return elems * sizeof(T);
}

// Above 48 KB a kernel needs its dynamic shared memory limit raised first.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int launch(const T* A, const T* B, const T* lz, const T* lu, const T* lzz, const T* luu,
           const T* luz, const T* Vz, const T* Vzz, const T* zs, const T* us, const T* lams,
           const T* tables, const T* alphas, const T* scal, T* zs_out, T* us_out,
           T* cost_out, T* ok_out, int N, int L, int n_con, int n, int substeps,
           void* stream) {
  const size_t bytes = smem_bytes<T>(N, L, n_con, n, substeps);
  if (bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(ilqr_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ilqr_kernel<T><<<1, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      A, B, lz, lu, lzz, luu, luz, Vz, Vzz, zs, us, lams, tables, alphas, scal,
      zs_out, us_out, cost_out, ok_out, N, L, n_con, n, substeps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_batch(const T* A, const T* B, const T* lz, const T* lu, const T* lzz,
                 const T* luu, const T* luz, const T* Vz, const T* Vzz, const T* zs,
                 const T* us, const T* lams, const T* tables, const T* alphas, const T* scal,
                 const T* reg_b, T* zs_out, T* us_out, T* cost_out, T* ok_out, int Bt, int N,
                 int L, int n_con, int n, int substeps, void* stream) {
  const size_t bytes = smem_bytes<T>(N, L, n_con, n, substeps);
  if (bytes == 0 || Bt < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(ilqr_batch_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ilqr_batch_kernel<T><<<Bt, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      A, B, lz, lu, lzz, luu, luz, Vz, Vzz, zs, us, lams, tables, alphas, scal, reg_b,
      zs_out, us_out, cost_out, ok_out, N, L, n_con, n, substeps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lto_ilqr_backward_forward_f32(
    const float* A, const float* B, const float* lz, const float* lu, const float* lzz,
    const float* luu, const float* luz, const float* Vz, const float* Vzz, const float* zs,
    const float* us, const float* lams, const float* tables, const float* alphas,
    const float* scal, float* zs_out, float* us_out, float* cost_out, float* ok_out, int N,
    int L, int n_con, int n, int substeps, void* stream) {
  return launch<float>(A, B, lz, lu, lzz, luu, luz, Vz, Vzz, zs, us, lams, tables, alphas,
                       scal, zs_out, us_out, cost_out, ok_out, N, L, n_con, n, substeps,
                       stream);
}

extern "C" int lto_ilqr_backward_forward_f64(
    const double* A, const double* B, const double* lz, const double* lu, const double* lzz,
    const double* luu, const double* luz, const double* Vz, const double* Vzz,
    const double* zs, const double* us, const double* lams, const double* tables,
    const double* alphas, const double* scal, double* zs_out, double* us_out,
    double* cost_out, double* ok_out, int N, int L, int n_con, int n, int substeps,
    void* stream) {
  return launch<double>(A, B, lz, lu, lzz, luu, luz, Vz, Vzz, zs, us, lams, tables, alphas,
                        scal, zs_out, us_out, cost_out, ok_out, N, L, n_con, n, substeps,
                        stream);
}

extern "C" int lto_ilqr_backward_forward_batch_f32(
    const float* A, const float* B, const float* lz, const float* lu, const float* lzz,
    const float* luu, const float* luz, const float* Vz, const float* Vzz, const float* zs,
    const float* us, const float* lams, const float* tables, const float* alphas,
    const float* scal, const float* reg_b, float* zs_out, float* us_out, float* cost_out,
    float* ok_out, int Bt, int N, int L, int n_con, int n, int substeps, void* stream) {
  return launch_batch<float>(A, B, lz, lu, lzz, luu, luz, Vz, Vzz, zs, us, lams, tables,
                             alphas, scal, reg_b, zs_out, us_out, cost_out, ok_out, Bt, N, L,
                             n_con, n, substeps, stream);
}

extern "C" int lto_ilqr_backward_forward_batch_f64(
    const double* A, const double* B, const double* lz, const double* lu, const double* lzz,
    const double* luu, const double* luz, const double* Vz, const double* Vzz,
    const double* zs, const double* us, const double* lams, const double* tables,
    const double* alphas, const double* scal, const double* reg_b, double* zs_out,
    double* us_out, double* cost_out, double* ok_out, int Bt, int N, int L, int n_con, int n,
    int substeps, void* stream) {
  return launch_batch<double>(A, B, lz, lu, lzz, luu, luz, Vz, Vzz, zs, us, lams, tables,
                              alphas, scal, reg_b, zs_out, us_out, cost_out, ok_out, Bt, N, L,
                              n_con, n, substeps, stream);
}
