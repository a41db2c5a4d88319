// The curvilinear bicycle model on the device, shared by the port's CUDA
// kernels: the layout of the scalar vector (ops/ilqr.py scal_tail), the
// track lookup, the Pacejka tyres, the RHS, its partials and their
// directional derivatives, and the augmented RK4 step.  Each is the
// counterpart of the plain function named beside it (models/bicycle.py,
// mpc/track.py).  ilqr.cu's solve kernel runs them in its rollouts and
// linearisation; cycle_tail.cu's kernel runs the RK4 step as the plant of
// the closed loop.  Everything here has internal linkage, so each source
// that includes it compiles its own copy.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int NX = 8;
constexpr int NU = 2;
constexpr int NZ = NX + NU;  // augmented state [x, u_prev]

// scalar-vector layout: must mirror ops/ilqr.py SCAL_FIELDS[2:] (scal_tail)
enum Scal {
  S_MAX, INV_DS, H,
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
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double m_fma(double a, double b, double c) { return __fma_rn(a, b, c); }
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

// max that propagates NaN, as torch.maximum / amax do
template <typename T>
__device__ __forceinline__ T max_nan(T m, T x) { return (x > m || x != x) && m == m ? x : m; }

// Cell of the uniform arc grid holding s (mpc/track.py MPCTrack._cell): the
// lap wrap as torch.remainder, the index clipped to [0, n-2] as an integer
// (NaN to 0), and the unclipped frac.
template <typename T>
__device__ __forceinline__ int cell(int n, T s, const T* sc, T& frac) {
  const T s_max = sc[S_MAX];
  T sw = m_fmod(s, s_max);
  if (sw != T(0) && ((sw < T(0)) != (s_max < T(0)))) sw += s_max;
  const T t = sw * sc[INV_DS];
  int i;
  if (t >= T(n - 2)) i = n - 2;
  else if (t >= T(0)) i = (int)m_floor(t);
  else i = 0;  // negative or NaN
  frac = t - T(i);
  return i;
}

template <typename T>
__device__ __forceinline__ T clip01(T f) { return f < T(0) ? T(0) : (f > T(1) ? T(1) : f); }

// piecewise-linear lookup of one table row (MPCTrack._uinterp)
template <typename T>
__device__ T lookup(const T* row, int n, T s, const T* sc) {
  T frac;
  const int i = cell(n, s, sc, frac);
  frac = clip01(frac);
  return row[i] * (T(1) - frac) + row[i + 1] * frac;
}

// value and slope (MPCTrack._uinterp_d): full slope inside the cell, half
// where frac sits exactly on a clip bound, zero beyond
template <typename T>
__device__ T lookup_d(const T* row, int n, T s, const T* sc, T& slope) {
  T frac;
  const int i = cell(n, s, sc, frac);
  const T gain = (frac > T(0) && frac < T(1)) ? T(1)
                 : ((frac == T(0) || frac == T(1)) ? T(0.5) : T(0));
  const T lo = row[i], hi = row[i + 1];
  slope = (hi - lo) * sc[INV_DS] * gain;
  frac = clip01(frac);
  return lo * (T(1) - frac) + hi * frac;
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

// the forces and their partials (BicycleModel.tyre_partials): dFy_f w.r.t.
// (vx, vy, r, delta), dFy_r w.r.t. (vx, vy, r)
template <typename T>
struct TyreD {
  T Fy_f, Fy_r, f_vx, f_vy, f_r, f_d, r_vx, r_vy, r_r;
};

template <typename T>
__device__ TyreD<T> tyre_partials(T vx, T vy, T r, T delta, const T* sc) {
  const T lf = sc[LF], lr = sc[LR], m = sc[MASS];
  const T yf = vy + lf * r, yr = vy - lr * r;
  const T alpha_f = m_atan2(yf, vx) - delta;
  const T alpha_r = m_atan2(yr, vx);
  const T wheelbase = lf + lr;
  const T Fn_f = lr * m * T(GRAV) / wheelbase;
  const T Fn_r = lf * m * T(GRAV) / wheelbase;
  const T bf = sc[BF] * alpha_f, br = sc[BR] * alpha_r;
  const T atf = m_atan(bf), atr = m_atan(br);
  TyreD<T> o;
  o.Fy_f = -Fn_f * sc[DF] * m_sin(sc[CF] * atf);
  o.Fy_r = -Fn_r * sc[DR] * m_sin(sc[CR] * atr);
  const T gf = -Fn_f * sc[DF] * m_cos(sc[CF] * atf) * sc[CF] * sc[BF] / (T(1) + bf * bf);
  const T gr = -Fn_r * sc[DR] * m_cos(sc[CR] * atr) * sc[CR] * sc[BR] / (T(1) + br * br);
  // d atan2(y, x) = (x dy - y dx) / (x^2 + y^2)
  const T qf = gf / (vx * vx + yf * yf);
  const T qr = gr / (vx * vx + yr * yr);
  o.f_vx = -yf * qf;
  o.f_vy = vx * qf;
  o.f_r = lf * vx * qf;
  o.f_d = -gf;
  o.r_vx = -yr * qr;
  o.r_vy = vx * qr;
  o.r_r = -lr * vx * qr;
  return o;
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

// The RHS and its partials w.r.t. x at one point, those of
// BicycleModel.rhs_and_jacobian, evaluated once for any number of tangent
// columns: the nonzero entries of rows 0-5 of d rhs/dx (rows 6-7 are
// d rhs/du = I, and d mudot/dr = 1).
template <typename T>
struct RhsD {
  T s0, s1, s2, s3, s4;  // d sdot / d(s, n, mu, vx, vy)
  T n2, n3, n4;          // d ndot / d(mu, vx, vy)
  T m0, m1, m2, m3, m4;  // d mudot / d(s, n, mu, vx, vy)
  T a3, a4, a5, a6, a7;  // d vxdot / d(vx, vy, r, delta, thr)
  T b3, b4, b5, b6;      // d vydot / d(vx, vy, r, delta)
  T c3, c4, c5, c6;      // d rdot / d(vx, vy, r, delta)
};

template <typename T>
__device__ void rhs_d(const T* x, const T* u, const T* tab, int n, const T* sc, T* xdot,
                      RhsD<T>& d) {
  const T s = x[0], nn = x[1], mu = x[2], vx = x[3], vy = x[4], r = x[5];
  const T delta = x[6], thr = x[7];
  const T m = sc[MASS], lf = sc[LF], lr = sc[LR], Iz = sc[IZ], ptv = sc[PTV];
  T dk;
  const T k = lookup_d(tab, n, s, sc, dk);
  const T cos_mu = m_cos(mu), sin_mu = m_sin(mu);
  const T den = T(1) - nn * k;
  const T num = vx * cos_mu - vy * sin_mu;
  const T sdot = num / den;
  const T sd_s = sdot * nn * dk / den;
  const T sd_n = sdot * k / den;
  const T sd_mu = (-vx * sin_mu - vy * cos_mu) / den;
  const T sd_vx = cos_mu / den;
  const T sd_vy = -sin_mu / den;
  const TyreD<T> t = tyre_partials(vx, vy, r, delta, sc);
  const T Fx = sc[CM] * thr - sc[CR0] - sc[CR2] * vx * vx;
  const T cos_d = m_cos(delta), sin_d = m_sin(delta);
  const T tan_d = m_tan(delta);
  const T rt = tan_d * vx / (lf + lr);
  const T yaw = t.Fy_f * lf * cos_d - t.Fy_r * lr + ptv * (rt - r);
  const T m_vx = ptv * tan_d / (lf + lr);
  const T m_r = -ptv;
  const T m_d = ptv * vx * (T(1) + tan_d * tan_d) / (lf + lr);
  xdot[0] = sdot;
  xdot[1] = vx * sin_mu + vy * cos_mu;
  xdot[2] = r - k * sdot;
  xdot[3] = (Fx - t.Fy_f * sin_d + m * vy * r) / m;
  xdot[4] = (t.Fy_r + t.Fy_f * cos_d - m * vx * r) / m;
  xdot[5] = yaw / Iz;
  xdot[6] = u[0];
  xdot[7] = u[1];
  d.s0 = sd_s;
  d.s1 = sd_n;
  d.s2 = sd_mu;
  d.s3 = sd_vx;
  d.s4 = sd_vy;
  d.n2 = num;
  d.n3 = sin_mu;
  d.n4 = cos_mu;
  d.m0 = -(dk * sdot + k * sd_s);
  d.m1 = -k * sd_n;
  d.m2 = -k * sd_mu;
  d.m3 = -k * sd_vx;
  d.m4 = -k * sd_vy;
  d.a3 = (T(-2) * sc[CR2] * vx - t.f_vx * sin_d) / m;
  d.a4 = (-t.f_vy * sin_d + m * r) / m;
  d.a5 = (-t.f_r * sin_d + m * vy) / m;
  d.a6 = (-t.f_d * sin_d - t.Fy_f * cos_d) / m;
  d.a7 = sc[CM] / m;
  d.b3 = (t.r_vx + t.f_vx * cos_d - m * r) / m;
  d.b4 = (t.r_vy + t.f_vy * cos_d) / m;
  d.b5 = (t.r_r + t.f_r * cos_d - m * vx) / m;
  d.b6 = (t.f_d * cos_d - t.Fy_f * sin_d) / m;
  d.c3 = (t.f_vx * lf * cos_d - t.r_vx * lr + m_vx) / Iz;
  d.c4 = (t.f_vy * lf * cos_d - t.r_vy * lr) / Iz;
  d.c5 = (t.f_r * lf * cos_d - t.r_r * lr + m_r) / Iz;
  d.c6 = (t.f_d * lf * cos_d - t.Fy_f * lf * sin_d + m_d) / Iz;
}

// The directional derivative of the RHS along one tangent column, from the
// partials at its point: dxdot = d rhs/dx . v + d rhs/du e_col (col 8, 9 are
// the inputs).  The compiler contracts these sums into fused multiply-adds;
// row 3's first pair is fused as an explicit m_fma, the way the compiler
// fused it when the partials were formed inside the sum (one evaluation of
// the RHS per column), so that J keeps those bits.
template <typename T>
__device__ __forceinline__ void rhs_d_apply(const RhsD<T>& d, const T* v, int col, T* dxdot) {
  dxdot[0] = d.s0 * v[0] + d.s1 * v[1] + d.s2 * v[2] + d.s3 * v[3] + d.s4 * v[4];
  dxdot[1] = d.n2 * v[2] + d.n3 * v[3] + d.n4 * v[4];
  dxdot[2] = d.m0 * v[0] + d.m1 * v[1] + d.m2 * v[2] + d.m3 * v[3] + d.m4 * v[4] + v[5];
  dxdot[3] = m_fma(d.a4, v[4], d.a3 * v[3]) + d.a5 * v[5] + d.a6 * v[6] + d.a7 * v[7];
  dxdot[4] = d.b3 * v[3] + d.b4 * v[4] + d.b5 * v[5] + d.b6 * v[6];
  dxdot[5] = d.c3 * v[3] + d.c4 * v[4] + d.c5 * v[5] + d.c6 * v[6];
  dxdot[6] = col == NX ? T(1) : T(0);
  dxdot[7] = col == NX + 1 ? T(1) : T(0);
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

}  // namespace
