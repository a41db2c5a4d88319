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
//   acceleration sweep, ascending j, limited by min(engine, traction)
//   braking sweep, descending j, limited by traction
//   v[j]     = min(v_acc[j], v_dec[j])
// with the step v' = where(ds >= 0 & v_here > v_prev, min(v_here,
// sqrt(v_prev^2 + 2 F(v_prev, k_prev) / m ds)), v_here).  The acceleration
// sweep at j reads k_prev = k[j-1] and ds[j] = (s[j] - s[j-1]) mod s_max; the
// braking sweep at j reads k[j+1] and ds[j+1]; on an open lap ds[0] = -1,
// which restarts the chain at the seam.  The engine is the clamp-sum of a
// <= 8-knot map (f0 + sum_i slope_i clamp(v - v_i, 0, w_i), jnp.interp's
// clamped extrapolation) or the Pacejka car's T C_m - Cr0 - Cr2 v^2; the
// traction cap is packed as f_cap.  Acceleration is force * (1/mass), as in
// the Pallas kernel.
//
// What bounds it.  At the main path's B = 1024, N = 846 in float32 the
// function must move ~10.4 MB (s and k in, v out): ~3.1 us at 3.35 TB/s; its
// ~70 MFLOP take ~1 us at 67 TFLOP/s.  But a sweep is a serial recurrence:
// the floor is the dependent latency of its steps (a traction sqrt, the
// engine's 7-term clamp-sum and the reach's sqrt: a few hundred cycles a
// step) times the longest chain a candidate needs, plus the prologue.
//
// Design (one warp per candidate, W = 1, 2 or 4 candidates per block):
//  * Prologue: the warp copies its rows of s and k into shared memory (or
//    the global scratch, see Placement) with coalesced loads, every load of
//    a lane in flight before the first is used (one round trip to memory
//    for N <= 1024 in float32), and computes
//    three streams once per sample, all lanes in parallel: v_loc, ds (with
//    jmod, so any s is exact) and the curvature itself.  The braking sweep
//    reads the same arrays at j+1: nothing is flipped or rolled.  A warp
//    argmin (torch.argmin's rule: first index, NaN counts as the minimum)
//    finds i0.  (No TMA: the searches pass s as the view s[:, :-1], whose
//    row stride of 847 elements is not a multiple of 16 bytes.)
//  * One lap per sweep, not two.  A step resets to v_here whatever its carry
//    where v_here <= v_prev or v_here is NaN, and a NaN sample resets the
//    step after it.  So on a closed lap both sweeps start at i0 (the global
//    minimum: every carry is >= it, since traction and the engine forces are
//    >= 0; or the first NaN), and on an open lap at the seams (acceleration
//    at j = 0, braking at j = N-1, where ds = -1).  From there the chain is
//    the twin's second lap, operation for operation.
//  * Segments.  Lanes 0-15 run the acceleration sweep and lanes 16-31 the
//    braking sweep; each sweep's lap, in chain order from its start, is cut
//    into P <= 16 segments of ceil(N/P) positions, one lane each.  Pass 1
//    runs every segment from an upper-bound guess, the v_loc of the position
//    before it (segment 0 starts at the reset, so it is exact).  Fix-up
//    rounds: a lane whose carry (the end of the previous segment) changed
//    re-runs from it, and stops at its first value that equals the stored
//    one bit for bit (NaN equal to NaN): from there on the stored chain is
//    the same computation.  Rounds repeat until no carry changed.  Round r
//    makes segment r exact, so there are at most P-1 of them, and the worst
//    case is the serial lap: nothing approximates, nothing falls back.
//  * Serial floor: ceil(N/P) steps of pass 1 plus, per round, the longest
//    re-run.  (CPU counts of the schedule for the searches' lines are in
//    tests/test_torch_velocity_schedule.py.)  Each lane prefetches the next
//    step's inputs from shared memory while its step runs.
//  * The step has no branch: the engine is a template parameter, the
//    braking lanes carry an engine of +inf, and selects replace the
//    where()s, so the engine's chain runs beside traction's.
//  * Epilogue: out[j] = min(v_acc[j], v_dec[j]), coalesced.
//  * Placement.  A candidate's five arrays of N (k, v_loc, ds, v_acc,
//    v_dec) sit in shared memory where W = 1 fits (N <= 11,622 in float32,
//    5,811 in float64); a longer lap keeps them in a global scratch of
//    (B, 5, N) that the wrapper allocates, the same schedule on the same
//    values (a template on the placement: the two give the same bits).
//    __syncwarp orders the warp's global stores as it does its shared ones.
//  * The streams and the epilogue take min/max with NaN winning, as
//    torch.minimum/maximum do; inside the step plain fmin/fmax give the same
//    output (see Vehicle).  Every product that feeds a sum is rounded on its
//    own (__fmul_rn/__dmul_rn), as the twin's separate PyTorch ops round
//    them; sqrt and division are IEEE.
//
// C interface (one entry point per type): device buffers s (B, N) with row
// stride s_stride (0: one row shared), k (B, N) contiguous, s_max (B,) with
// stride smax_stride (0: shared); params = (mass, f_cap, engine constant,
// engine quadratic, mu g); engine = (4, 8) rows knot speeds, slopes, widths,
// f0; scratch (B, 5, N) for the global placement, or null for the shared
// one; W candidates per block, P segments per sweep.  The launch goes onto
// `stream`, allocates nothing and returns cudaGetLastError().
// lto_velocity_profile_batch_smem_bytes gives a block's dynamic shared
// memory in the shared placement, 0 where the sizes are refused.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int WARP = 32;
constexpr int HALF = 16;          // lanes per sweep
constexpr int MAX_WARPS = 4;      // candidates per block
constexpr int MAX_SEGMENTS = HALF;
constexpr int ARRAYS = 5;         // per candidate: k, v_loc, ds, v_acc, v_dec
constexpr size_t MAX_SMEM = 232448;
constexpr int MAX_KNOTS = 8;
constexpr unsigned FULL = 0xffffffffu;

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

// Bit for bit, any NaN equal to any NaN: the fix-up's stop rule.
__device__ __forceinline__ bool same(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b) || (isnan(a) && isnan(b));
}
__device__ __forceinline__ bool same(double a, double b) {
  return __double_as_longlong(a) == __double_as_longlong(b) || (isnan(a) && isnan(b));
}

template <typename T>
__device__ __forceinline__ T jmod(T x, T y) {  // jnp.mod / torch.remainder
  T r = fmod(x, y);
  if (r != T(0) && ((r < T(0)) != (y < T(0)))) r += y;
  return r;
}

// (a, ia) comes before (b, ib) in torch.argmin's order: NaN first, then the
// smaller value, ties to the smaller index; an index < 0 is no sample.
template <typename T>
__device__ __forceinline__ bool before(T a, int ia, T b, int ib) {
  if (ia < 0) return false;
  if (ib < 0) return true;
  if (isnan(a) || isnan(b)) return isnan(a) && (!isnan(b) || ia < ib);
  return a < b || (a == b && ia < ib);
}

__device__ __forceinline__ int wrap(int j, int N) { return j < 0 ? j + N : (j >= N ? j - N : j); }

// The vehicle's constants and the step.  PACEJKA picks the engine at
// compile time.  The step has no branch and no per-sweep select: on the
// braking lanes the engine's constant term is +inf, so min(engine,
// traction) is traction there.  Inside the step NaN needs no care: the step
// returns v_here whenever v_prev, v_here or ds is NaN (a comparison with NaN
// is false), and a NaN curvature makes traction 0 as in the twin.  So with
// finite vehicle constants the inner min/max are plain fmin/fmax (one
// instruction each; their values equal minp/maxp's wherever they reach the
// output), and only the reach can be NaN (a negative root), which the last
// select passes on as min(v_here, NaN) = NaN does.
template <typename T, bool PACEJKA>
struct Vehicle {
  T mass, inv_mass, f_cap, eng_const, eng_quad, mu_g, f0;
  T knot[MAX_KNOTS], slope[MAX_KNOTS], width[MAX_KNOTS];

  __device__ T local_limit(T k) const { return sqrt(mu_g / maxp(k, T(1e-12))); }

  __device__ T traction(T v, T k) const {
    T f_lat = mul(mul(mul(mass, v), v), k);
    T slack = mul(f_cap, f_cap) - mul(f_lat, f_lat);
    const T root = sqrt(fmax(slack, T(1e-12)));
    return slack > T(0) ? root : T(0);
  }

  __device__ T engine(T v) const {
    if (PACEJKA) return eng_const - mul(mul(eng_quad, v), v);
    T f = f0;
#pragma unroll
    for (int i = 0; i < MAX_KNOTS - 1; ++i)
      f = f + mul(slope[i], fmin(fmax(v - knot[i], T(0)), width[i]));
    return f;
  }

  // where(ds >= 0 & v_here > v_prev, minimum(v_here, vlim), v_here)
  __device__ T limit(T v_prev, T v_here, T k_prev, T ds) const {
    const T force = fmin(engine(v_prev), traction(v_prev, k_prev));
    const T vlim = sqrt(mul(v_prev, v_prev) + mul(mul(mul(T(2), force), inv_mass), fmax(ds, T(0))));
    const bool grow = ds >= T(0) && v_here > v_prev;  // v_here is not NaN then
    return grow && !(v_here < vlim) ? vlim : v_here;
  }
};

// One lane's segment of one sweep: positions [c0, c0 + n) of the chain,
// which walks j by `dir` from the sweep's start.
template <typename T, bool PACEJKA>
struct Segment {
  const T *k, *v_loc, *ds;
  T* out;
  int N, dir, j0, n;
  bool acc;

  // Run the segment from carry v.  FIX: stop at the first value equal to
  // the stored one.  The next step's inputs are read before this step's
  // store, so they are in flight while the step runs.
  template <bool FIX>
  __device__ void run(const Vehicle<T, PACEJKA>& veh, T v) const {
    int j = j0, nb = wrap(j0 - dir, N);
    T vh = v_loc[j], kp = k[nb], d = ds[acc ? j : nb], old = FIX ? out[j] : T(0);
    for (int t = 0; t < n; ++t) {
      const int jn = wrap(j + dir, N), nbn = j;  // the next position's neighbour is j
      const T vh_n = v_loc[jn], kp_n = k[nbn], d_n = ds[acc ? jn : nbn];
      const T old_n = FIX ? out[jn] : T(0);
      const T vn = veh.limit(v, vh, kp, d);
      if (FIX && same(vn, old)) return;
      out[j] = vn;
      v = vn;
      j = jn;
      vh = vh_n;
      kp = kp_n;
      d = d_n;
      old = old_n;
    }
  }
};

// GLOBAL: the five arrays in `scratch` (the global placement).
template <typename T, bool PACEJKA, bool GLOBAL>
__global__ void __launch_bounds__(MAX_WARPS * WARP) velocity_profile_batch_kernel(
    const T* __restrict__ s, const T* __restrict__ k, const T* __restrict__ s_max,
    const T* __restrict__ params, const T* __restrict__ engine, T* __restrict__ out,
    T* scratch, int B, int N, int s_stride, int smax_stride, int closed, int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % WARP, w = threadIdx.x / WARP;
  const int row = blockIdx.x * (blockDim.x / WARP) + w;
  if (row >= B) return;  // the whole warp: nothing below syncs the block

  T* k_s = GLOBAL ? scratch + (long long)row * ARRAYS * N
                  : reinterpret_cast<T*>(smem_raw) + (size_t)w * ARRAYS * N;
  T* v_loc = k_s + N;
  T* ds = v_loc + N;
  T* v_acc = ds + N;
  T* v_dec = v_acc + N;

  // ---- prologue: rows into shared memory (s staged in v_acc), then the streams.
  // Every load of a lane is issued before the first is used: the constants,
  // then up to LOAD_BATCH samples of each row (N <= 1024 in float32 in one
  // batch), so the copy costs about one round trip to memory.
  constexpr int LOAD_BATCH = sizeof(T) == 4 ? 32 : 16;
  Vehicle<T, PACEJKA> veh;
  veh.mass = params[0];
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
  const T* s_row = s + (long long)row * s_stride;
  const T* k_row = k + (long long)row * N;
  const T smax = s_max[(long long)row * smax_stride];
  for (int j0 = lane; j0 < N; j0 += WARP * LOAD_BATCH) {
    T kb[LOAD_BATCH], sb[LOAD_BATCH];
#pragma unroll
    for (int u = 0; u < LOAD_BATCH; ++u) {
      const int j = j0 + u * WARP;
      if (j < N) {
        kb[u] = k_row[j];
        sb[u] = s_row[j];
      }
    }
#pragma unroll
    for (int u = 0; u < LOAD_BATCH; ++u) {
      const int j = j0 + u * WARP;
      if (j < N) {
        k_s[j] = kb[u];
        v_acc[j] = sb[u];
      }
    }
  }
  veh.inv_mass = T(1) / veh.mass;
  if (lane >= HALF) {  // the braking sweep is limited by traction alone
    veh.f0 = veh.eng_const = T(INFINITY);
  }
  __syncwarp();
  T best = T(0);
  int i0 = -1;
  for (int j = lane; j < N; j += WARP) {
    const T v = veh.local_limit(k_s[j]);
    v_loc[j] = v;
    const T d = v_acc[j] - v_acc[j == 0 ? N - 1 : j - 1];
    ds[j] = closed ? jmod(d, smax) : (j == 0 ? T(-1) : d);
    if (before(v, j, best, i0)) {
      best = v;
      i0 = j;
    }
  }
#pragma unroll
  for (int off = HALF; off > 0; off /= 2) {  // the warp's argmin, the same on every lane
    const T b = __shfl_xor_sync(FULL, best, off);
    const int ib = __shfl_xor_sync(FULL, i0, off);
    if (before(b, ib, best, i0)) {
      best = b;
      i0 = ib;
    }
  }
  __syncwarp();  // s is read; v_acc now takes the acceleration sweep

  // ---- pass 1: every segment from its guess
  const int sweep = lane / HALF, q = lane % HALF;
  const int L = (N + P - 1) / P;
  Segment<T, PACEJKA> seg;
  seg.k = k_s;
  seg.v_loc = v_loc;
  seg.ds = ds;
  seg.acc = sweep == 0;
  seg.out = seg.acc ? v_acc : v_dec;
  seg.N = N;
  seg.dir = seg.acc ? 1 : -1;
  const int start = closed ? i0 : (seg.acc ? 0 : N - 1);
  const int c0 = q * L;
  seg.n = q < P ? max(0, min(L, N - c0)) : 0;
  seg.j0 = seg.n > 0 ? wrap(start + seg.dir * c0, N) : 0;
  const int prev = wrap(seg.j0 - seg.dir, N);  // the position before the segment
  T used = v_loc[prev];                        // v <= v_loc: an upper bound
  if (seg.n > 0) seg.template run<false>(veh, used);

  // ---- fix-up rounds until no carry changed
  for (;;) {
    __syncwarp();
    const T carry = seg.out[prev];  // the end of the previous segment
    const bool redo = seg.n > 0 && q > 0 && !same(carry, used);
    if (!__any_sync(FULL, redo)) break;
    __syncwarp();  // every carry is read before any segment is rewritten
    if (redo) {
      used = carry;
      seg.template run<true>(veh, carry);
    }
  }
  __syncwarp();

  // ---- epilogue
  T* o_row = out + (long long)row * N;
  for (int j = lane; j < N; j += WARP) o_row[j] = minp(v_acc[j], v_dec[j]);
}

template <typename T>
size_t smem_bytes(int W, int N) {
  if (W < 1 || W > MAX_WARPS || N < 1) return 0;
  const size_t bytes = (size_t)W * ARRAYS * N * sizeof(T);
  return bytes <= MAX_SMEM ? bytes : 0;
}

template <typename T>
int launch(const T* s, const T* k, const T* s_max, const T* params, const T* engine, T* out,
           T* scratch, int B, int N, int s_stride, int smax_stride, int closed, int pacejka,
           int W, int P, void* stream) {
  // the global placement needs no shared memory, only a row offset that fits
  const bool global = scratch != nullptr;
  const size_t bytes = global ? 0 : smem_bytes<T>(W, N);
  const bool sizes = global ? W >= 1 && W <= MAX_WARPS && N >= 1 && N <= INT_MAX / ARRAYS
                            : bytes != 0;
  if (!sizes || B < 1 || P < 1 || P > MAX_SEGMENTS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = global ? (pacejka ? velocity_profile_batch_kernel<T, true, true>
                                  : velocity_profile_batch_kernel<T, false, true>)
                       : (pacejka ? velocity_profile_batch_kernel<T, true, false>
                                  : velocity_profile_batch_kernel<T, false, false>);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (B + W - 1) / W;
  kernel<<<blocks, W * WARP, bytes, static_cast<cudaStream_t>(stream)>>>(s, k, s_max, params, engine, out, scratch, B, N, s_stride, smax_stride, closed, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lto_velocity_profile_batch_f32(const float* s, const float* k, const float* s_max,
                                              const float* params, const float* engine,
                                              float* out, float* scratch, int B, int N,
                                              int s_stride, int smax_stride, int closed,
                                              int pacejka, int W, int P, void* stream) {
  return launch<float>(s, k, s_max, params, engine, out, scratch, B, N, s_stride, smax_stride,
                       closed, pacejka, W, P, stream);
}

extern "C" int lto_velocity_profile_batch_f64(const double* s, const double* k,
                                              const double* s_max, const double* params,
                                              const double* engine, double* out,
                                              double* scratch, int B, int N, int s_stride,
                                              int smax_stride, int closed, int pacejka, int W,
                                              int P, void* stream) {
  return launch<double>(s, k, s_max, params, engine, out, scratch, B, N, s_stride, smax_stride,
                        closed, pacejka, W, P, stream);
}

// Dynamic shared memory of a block of W candidates in the shared placement
// (element size 4 or 8), 0 if refused.
extern "C" long long lto_velocity_profile_batch_smem_bytes(int elem_size, int W, int N) {
  return static_cast<long long>(elem_size == 8 ? smem_bytes<double>(W, N)
                                               : smem_bytes<float>(W, N));
}
