// Batched quasi-static velocity profile: the 3-pass solve of B candidate
// racing lines at once, forward only.  CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel lap_time_optimization_tpu/ops/pallas_velocity.py
// `_fused_solve` (:176, body `_fused_kernel`) behind its entry
// `solve_profile_batch` (:229).  Plain PyTorch twin:
// ops/velocity_batch.py::solve_profile_batch_reference; wrapper
// ops/velocity_batch.py::solve_profile_batch.
//
// What it computes, per candidate row b (samples j = 0..N-1):
//   v_loc[j] = sqrt(mu g / max(k[j], 1e-12))                  (lateral limit)
//   acceleration sweep, forward order, limited by min(engine, traction)
//   braking sweep, flipped order, limited by traction
//   v[j]     = min(v_acc[j], v_dec[j])
// with v' = where(ds >= 0 & v_loc > v_prev, min(v_loc, sqrt(v_prev^2 +
// 2 F(v_prev, k_prev) / m ds)), v_loc).  Each sweep runs two laps of the
// unrolled cyclic recurrence instead of rolling the row to its argmin: the
// update is monotone in v_prev and exact at the global minimum, so every
// value of the second lap is exact (pallas_velocity.py:19-28).  ds is
// (s[j] - s[j-1]) mod s_max on a closed lap; on an open one the seam has
// ds = -1 and restarts the chain.  The engine is the clamp-sum of a <= 8-knot
// map (f0 + sum_i slope_i clamp(v - v_i, 0, w_i), which is jnp.interp's
// clamped extrapolation) or the Pacejka car's T C_m - Cr0 - Cr2 v^2; the
// traction cap is packed as f_cap.  Acceleration is force * (1/mass), as in
// the Pallas kernel.
//
// The kernel takes the function's own inputs, s (B, N) or (N,), k (B, N) and
// s_max (B,) or (), and forms the lateral limit, ds, k_prev and the flipped
// braking streams by index arithmetic: no stream is prepared on the host.
//
// What bounds it: latency.  At the main path's B = 1024, N = 846 in float32
// the function must move ~10.4 MB (s and k in, v out), ~3.1 us at
// 3.35 TB/s, and do ~70 MFLOP, ~1 us at 67 TFLOP/s; but each candidate is a
// serial chain of 2N = 1692 dependent steps (sqrt, compare, select), and
// with one thread per candidate B = 1024 fills only 32 warps on 32 SMs.
//
// Bring-up design:
//  * one thread per candidate, 32 candidates (one warp) per block, so
//    B = 1024 is 32 blocks on 32 SMs; both sweeps advance in one loop of 2N
//    steps (two independent chains give the scheduler some ILP);
//  * the loads coalesce: the block stages a tile of TILE samples of its 32
//    rows through shared memory, read row-segment by row-segment by
//    neighbouring threads, for the forward and the (descending) braking
//    positions; the previous sample's k and s stay in registers;
//  * on the second lap the acceleration sweep writes its tile to `out` and
//    the braking sweep its tile to `scratch` (both staged, coalesced); a
//    last pass of the block takes out = min(out, scratch) over its rows;
//  * min/max propagate NaN as torch.minimum/maximum do, so a degenerate
//    candidate (NaN curvature) gives NaN as in the twin.
// Later designs (ROADMAP): one argmin pass plus one lap per sweep (3N steps
// against 4N), or lap segments in parallel with a monotone fix-up, and
// more than one candidate's chain per thread.
//
// C interface (one entry point per type): contiguous device buffers in the
// layouts above; params = (mass, f_cap, engine constant, engine quadratic,
// mu g); engine = (4, 8) rows knot speeds, slopes, widths, f0.  The launch
// goes onto `stream`, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 32;  // candidates (threads) per block
constexpr int MAX_KNOTS = 8;

template <typename T>
__device__ __forceinline__ T minp(T a, T b) {  // torch.minimum: NaN wins
  return (a < b || isnan(a)) ? a : b;
}

template <typename T>
__device__ __forceinline__ T maxp(T a, T b) {  // torch.maximum: NaN wins
  return (a > b || isnan(a)) ? a : b;
}

// Products that feed a sum are rounded on their own (no fused multiply-add),
// as the twin's separate PyTorch ops round them: near the friction circle's
// saturation sqrt(f_cap^2 - f_lat^2) turns one ulp into ~1e-9 of the profile.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
__device__ __forceinline__ T jmod(T x, T y) {  // jnp.mod / torch.remainder
  T r = fmod(x, y);
  if (r != T(0) && ((r < T(0)) != (y < T(0)))) r += y;
  return r;
}

template <typename T>
struct Vehicle {
  T mass, inv_mass, f_cap, eng_const, eng_quad, mu_g, f0;
  T knot[MAX_KNOTS], slope[MAX_KNOTS], width[MAX_KNOTS];
  bool pacejka;

  __device__ T local_limit(T k) const { return sqrt(mu_g / maxp(k, T(1e-12))); }

  __device__ T traction(T v, T k) const {
    T f_lat = mul(mul(mul(mass, v), v), k);
    T slack = mul(f_cap, f_cap) - mul(f_lat, f_lat);
    return slack > T(0) ? sqrt(maxp(slack, T(1e-12))) : T(0);
  }

  __device__ T engine(T v) const {
    if (pacejka) return eng_const - mul(mul(eng_quad, v), v);
    T f = f0;
#pragma unroll
    for (int i = 0; i < MAX_KNOTS - 1; ++i)
      f = f + mul(slope[i], minp(maxp(v - knot[i], T(0)), width[i]));
    return f;
  }

  __device__ T limit(T v_prev, T v_here, T k_prev, T ds, bool accelerating) const {
    T force = traction(v_prev, k_prev);
    if (accelerating) force = minp(engine(v_prev), force);
    T vlim = sqrt(mul(v_prev, v_prev) + mul(mul(mul(T(2), force), inv_mass), maxp(ds, T(0))));
    return (ds >= T(0) && v_here > v_prev) ? minp(v_here, vlim) : v_here;
  }
};

template <typename T>
struct Tile {  // samples per staged tile: 32 rows x TILE in shared memory
  static constexpr int N = sizeof(T) == 8 ? 16 : 32;
};

template <typename T>
__global__ void __launch_bounds__(ROWS) velocity_profile_batch_kernel(
    const T* __restrict__ s, const T* __restrict__ k, const T* __restrict__ s_max,
    const T* __restrict__ params, const T* __restrict__ engine, T* __restrict__ out,
    T* __restrict__ scratch, int B, int N, int s_stride, int smax_stride, int closed,
    int pacejka) {
  constexpr int TILE = Tile<T>::N;
  __shared__ T k_f[ROWS][TILE + 1], s_f[ROWS][TILE + 1];  // forward positions
  __shared__ T k_b[ROWS][TILE + 1], s_b[ROWS][TILE + 1];  // braking positions
  __shared__ T o_f[ROWS][TILE + 1], o_b[ROWS][TILE + 1];  // second-lap outputs

  const int tx = threadIdx.x;
  const int r0 = blockIdx.x * ROWS;
  const int row = r0 + tx;
  const bool active = row < B;

  Vehicle<T> veh;
  veh.mass = params[0];
  veh.inv_mass = T(1) / veh.mass;
  veh.f_cap = params[1];
  veh.eng_const = params[2];
  veh.eng_quad = params[3];
  veh.mu_g = params[4];
  veh.f0 = engine[3 * MAX_KNOTS];
#pragma unroll
  for (int i = 0; i < MAX_KNOTS; ++i) {
    veh.knot[i] = engine[i];
    veh.slope[i] = engine[MAX_KNOTS + i];
    veh.width[i] = engine[2 * MAX_KNOTS + i];
  }
  veh.pacejka = pacejka != 0;

  const long long krow = (long long)(active ? row : 0) * N;
  const long long srow = (long long)(active ? row : 0) * s_stride;
  const T smax = s_max[active ? (long long)row * smax_stride : 0];

  // carries: each sweep starts at its stream's first sample; "previous"
  // sample of the forward stream's sample 0 is N-1, of the braking one's 0
  T kp_f = k[krow + N - 1], sp_f = s[srow + N - 1];
  T kp_b = k[krow], sp_b = s[srow];
  T va = veh.local_limit(kp_b);  // v_loc[0]
  T vd = veh.local_limit(kp_f);  // v_loc[N-1]

  for (int lap = 0; lap < 2; ++lap) {
    for (int j0 = 0; j0 < N; j0 += TILE) {
      const int cnt = min(TILE, N - j0);
      __syncthreads();  // the previous tile is consumed and written out
      for (int idx = tx; idx < ROWS * TILE; idx += ROWS) {
        const int rr = idx / TILE, jj = idx % TILE, r = r0 + rr;
        if (r < B && jj < cnt) {
          const long long kr = (long long)r * N, sr = (long long)r * s_stride;
          k_f[rr][jj] = k[kr + j0 + jj];
          s_f[rr][jj] = s[sr + j0 + jj];
          k_b[rr][jj] = k[kr + N - 1 - j0 - jj];
          s_b[rr][jj] = s[sr + N - 1 - j0 - jj];
        }
      }
      __syncthreads();
      if (active) {
        for (int jj = 0; jj < cnt; ++jj) {
          const int j = j0 + jj;  // forward sample j, braking sample N-1-j
          const T kf = k_f[tx][jj], sf = s_f[tx][jj];
          const T ds_a = closed ? jmod(sf - sp_f, smax) : (j == 0 ? T(-1) : sf - sp_f);
          va = veh.limit(va, veh.local_limit(kf), kp_f, ds_a, true);
          kp_f = kf;
          sp_f = sf;
          const T kb = k_b[tx][jj], sb = s_b[tx][jj];
          const T ds_d = closed ? jmod(sp_b - sb, smax) : (j == 0 ? T(-1) : sp_b - sb);
          vd = veh.limit(vd, veh.local_limit(kb), kp_b, ds_d, false);
          kp_b = kb;
          sp_b = sb;
          if (lap == 1) {
            o_f[tx][jj] = va;
            o_b[tx][jj] = vd;
          }
        }
      }
      if (lap == 1) {
        __syncthreads();
        for (int idx = tx; idx < ROWS * TILE; idx += ROWS) {
          const int rr = idx / TILE, jj = idx % TILE, r = r0 + rr;
          if (r < B && jj < cnt) {
            const long long kr = (long long)r * N;
            out[kr + j0 + jj] = o_f[rr][jj];
            scratch[kr + N - 1 - j0 - jj] = o_b[rr][jj];
          }
        }
      }
    }
  }
  __syncthreads();  // the block's own global writes are visible to it
  for (long long idx = tx; idx < (long long)ROWS * N; idx += ROWS) {
    const long long r = r0 + idx / N;
    if (r < B) {
      const long long i = r * N + idx % N;
      out[i] = minp(out[i], scratch[i]);
    }
  }
}

template <typename T>
int launch(const T* s, const T* k, const T* s_max, const T* params, const T* engine, T* out,
           T* scratch, int B, int N, int s_stride, int smax_stride, int closed, int pacejka,
           void* stream) {
  const int blocks = (B + ROWS - 1) / ROWS;
  velocity_profile_batch_kernel<T><<<blocks, ROWS, 0, static_cast<cudaStream_t>(stream)>>>(
      s, k, s_max, params, engine, out, scratch, B, N, s_stride, smax_stride, closed, pacejka);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lto_velocity_profile_batch_f32(const float* s, const float* k, const float* s_max,
                                              const float* params, const float* engine,
                                              float* out, float* scratch, int B, int N,
                                              int s_stride, int smax_stride, int closed,
                                              int pacejka, void* stream) {
  return launch<float>(s, k, s_max, params, engine, out, scratch, B, N, s_stride, smax_stride,
                       closed, pacejka, stream);
}

extern "C" int lto_velocity_profile_batch_f64(const double* s, const double* k,
                                              const double* s_max, const double* params,
                                              const double* engine, double* out,
                                              double* scratch, int B, int N, int s_stride,
                                              int smax_stride, int closed, int pacejka,
                                              void* stream) {
  return launch<double>(s, k, s_max, params, engine, out, scratch, B, N, s_stride, smax_stride,
                        closed, pacejka, stream);
}
