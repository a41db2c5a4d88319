// The tail of a closed-loop control cycle in one launch, for a batch of
// independent loops (the single stream is the batch at B = 1).  CUDA C++ for
// sm_90a.
//
// After the cycle's solve (ilqr.cu), the closed loop clips the solve's first
// input to the actuator limits, integrates the plant over one control
// period, shifts the warm start one stage forward and records the cycle's
// outputs (mpc/runner.py `_step_fn`; the plain version is
// ops/cycle_tail.py::tail_reference).  In eager PyTorch that is ~730 kernels
// of a few elements each, one after another; here it is one kernel:
//  * clip: u0 = clamp(us[0], lo, hi) with lo = max(-rate, (-box - act) / dt)
//    and hi = min(rate, (box - act) / dt), act = the state's steer and
//    throttle, as torch.maximum / minimum / clamp take them (NaN propagates;
//    max with lo first, then min with hi);
//  * plant: [x_next, u0] = dyn_step([x, u_prev], u0) of bicycle.cuh, the
//    solve kernel's own RK4 step (substeps increments of h = dt / substeps,
//    the h of the packed scalars), and sdot = (x_next[0] - x[0]) / dt, a
//    division;
//  * shift: us_next = [us[1:], us[-1]] and lam_next = [lam[1:], lam[-1]];
//  * outputs: x_next, u0, the solve's cost and violation and sdot into the
//    caller's rows (each with its own stride between instances; a null
//    pointer skips one), and the new carry x_next, u0, us_next, lam_next.
//
// What bounds it: latency.  Its work is a few thousand operations and a few
// hundred bytes per loop; one thread per loop runs the 4 x substeps serial
// RHS evaluations (trig, divisions) of its plant step.  Blocks hold up to
// 128 loops (one thread each; B = 1 takes one warp), so B = 4096 is 32
// blocks, one wave.  A block copies the shift of its loops' rows with all
// its threads, in order, so the copy is coalesced, and each thread keeps
// several loads in flight.
//
// C interface (one entry point per type): the inputs and the carry outputs
// are contiguous device buffers with a leading instance axis B; the record
// rows are (pointer, stride between instances) pairs; the launch goes onto
// `stream`, allocates nothing and returns cudaGetLastError().

#include <climits>

#include <cuda_runtime.h>

#include "bicycle.cuh"

namespace {

constexpr int TAIL_THREADS = 128;

// torch.minimum: the mirror of bicycle.cuh's max_nan (a NaN in either
// argument is the result).  torch.clamp(v, lo, hi) with tensor bounds is
// min_nan(max_nan(v, lo), hi): NaN in v, then lo, then hi is the result,
// else max with lo, then min with hi.
template <typename T>
__device__ __forceinline__ T min_nan(T m, T x) { return (x < m || x != x) && m == m ? x : m; }

// Shift a block's rows of `rows` stages of `width` one stage forward (the
// last stage repeated), all of the block's threads over its contiguous
// elements.  A thread's elements are independent, so it loads SHIFT_BATCH
// of them before it stores any: its loads wait for memory together, not one
// after another.
constexpr int SHIFT_BATCH = 8;

template <typename T>
__device__ __forceinline__ void shift(const T* __restrict__ src, T* __restrict__ dst, int b0, int nb,
                                      int rows, int width) {
  const int per = rows * width, n = nb * per, last = per - width;
  const long long base = (long long)b0 * per;
  const int step = blockDim.x;
  for (int e0 = threadIdx.x; e0 < n; e0 += SHIFT_BATCH * step) {
    T v[SHIFT_BATCH];
#pragma unroll
    for (int j = 0; j < SHIFT_BATCH; ++j) {
      const int e = e0 + j * step;
      if (e < n) v[j] = src[base + e + (e % per < last ? width : 0)];
    }
#pragma unroll
    for (int j = 0; j < SHIFT_BATCH; ++j) {
      const int e = e0 + j * step;
      if (e < n) dst[base + e] = v[j];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(TAIL_THREADS) cycle_tail_kernel(
    const T* __restrict__ x, const T* __restrict__ us, const T* __restrict__ lam,
    const T* __restrict__ cost, const T* __restrict__ viol, const T* __restrict__ tables,
    const T* __restrict__ scal, T* __restrict__ x_next, T* __restrict__ u_next,
    T* __restrict__ us_next, T* __restrict__ lam_next, T* rec_x, long long sx, T* rec_u,
    long long su, T* rec_cost, long long sc_cost, T* rec_viol, long long sc_viol, T* rec_sdot,
    long long sc_sdot, int Bt, int N, int n_con, int n, int substeps, T dt) {
  __shared__ T sc[NS];
  for (int i = threadIdx.x; i < NS; i += blockDim.x) sc[i] = scal[i];
  __syncthreads();
  const int b0 = blockIdx.x * blockDim.x;
  const int nb = min((int)blockDim.x, Bt - b0);
  shift(us, us_next, b0, nb, N, NU);
  shift(lam, lam_next, b0, nb, N + 1, n_con);

  const int b = b0 + threadIdx.x;
  if (b >= Bt) return;  // no barrier follows
  T z[NZ];
#pragma unroll
  for (int i = 0; i < NX; ++i) z[i] = x[(long long)b * NX + i];
  const T* u_first = us + (long long)b * N * NU;
  const T rate[NU] = {sc[DSTEER_MAX], sc[DTHR_MAX]};
  const T box[NU] = {sc[STEER_MAX], sc[THR_MAX]};
  T u0[NU];
#pragma unroll
  for (int c = 0; c < NU; ++c) {
    const T act = z[6 + c];
    const T lo = max_nan(-rate[c], (-box[c] - act) / dt);
    const T hi = min_nan(rate[c], (box[c] - act) / dt);
    u0[c] = min_nan(max_nan(u_first[c], lo), hi);
  }
  const T s0 = z[0];
  dyn_step(z, u0, tables, n, sc, substeps);  // z = [x_next, u0]
  const T sdot = (z[0] - s0) / dt;

#pragma unroll
  for (int i = 0; i < NX; ++i) x_next[(long long)b * NX + i] = z[i];
#pragma unroll
  for (int c = 0; c < NU; ++c) u_next[(long long)b * NU + c] = u0[c];
  if (rec_x)
#pragma unroll
    for (int i = 0; i < NX; ++i) rec_x[b * sx + i] = z[i];
  if (rec_u)
#pragma unroll
    for (int c = 0; c < NU; ++c) rec_u[b * su + c] = u0[c];
  if (rec_cost) rec_cost[b * sc_cost] = cost[b];
  if (rec_viol) rec_viol[b * sc_viol] = viol[b];
  rec_sdot[b * sc_sdot] = sdot;
}

template <typename T>
int launch_tail(const T* x, const T* us, const T* lam, const T* cost, const T* viol, const T* tables,
                const T* scal, T* x_next, T* u_next, T* us_next, T* lam_next, T* rec_x, long long sx,
                T* rec_u, long long su, T* rec_cost, long long sc_cost, T* rec_viol,
                long long sc_viol, T* rec_sdot, long long sc_sdot, int Bt, int N, int n_con, int n,
                int substeps, double dt, void* stream) {
  // a block's shift indexes its elements with 32-bit ints
  const bool fits = (long long)TAIL_THREADS * (N + 1) * n_con <= INT_MAX;
  if (Bt < 1 || N < 1 || n_con < 1 || !fits || n < 2 || substeps < 1 || rec_sdot == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = Bt >= TAIL_THREADS ? TAIL_THREADS : (Bt + 31) / 32 * 32;
  const int grid = (Bt + threads - 1) / threads;
  cycle_tail_kernel<T><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, us, lam, cost, viol, tables, scal, x_next, u_next, us_next, lam_next, rec_x, sx, rec_u, su,
      rec_cost, sc_cost, rec_viol, sc_viol, rec_sdot, sc_sdot, Bt, N, n_con, n, substeps, T(dt));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lto_cycle_tail_f32(const float* x, const float* us, const float* lam,
                                  const float* cost, const float* viol, const float* tables,
                                  const float* scal, float* x_next, float* u_next, float* us_next,
                                  float* lam_next, float* rec_x, long long sx, float* rec_u,
                                  long long su, float* rec_cost, long long sc_cost,
                                  float* rec_viol, long long sc_viol, float* rec_sdot,
                                  long long sc_sdot, int Bt, int N, int n_con, int n, int substeps,
                                  double dt, void* stream) {
  return launch_tail<float>(x, us, lam, cost, viol, tables, scal, x_next, u_next, us_next, lam_next,
                            rec_x, sx, rec_u, su, rec_cost, sc_cost, rec_viol, sc_viol, rec_sdot,
                            sc_sdot, Bt, N, n_con, n, substeps, dt, stream);
}

extern "C" int lto_cycle_tail_f64(const double* x, const double* us, const double* lam,
                                  const double* cost, const double* viol, const double* tables,
                                  const double* scal, double* x_next, double* u_next,
                                  double* us_next, double* lam_next, double* rec_x, long long sx,
                                  double* rec_u, long long su, double* rec_cost, long long sc_cost,
                                  double* rec_viol, long long sc_viol, double* rec_sdot,
                                  long long sc_sdot, int Bt, int N, int n_con, int n, int substeps,
                                  double dt, void* stream) {
  return launch_tail<double>(x, us, lam, cost, viol, tables, scal, x_next, u_next, us_next,
                             lam_next, rec_x, sx, rec_u, su, rec_cost, sc_cost, rec_viol, sc_viol,
                             rec_sdot, sc_sdot, Bt, N, n_con, n, substeps, dt, stream);
}
