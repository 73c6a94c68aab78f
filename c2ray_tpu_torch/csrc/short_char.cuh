// The short-characteristics cell step as device functions, shared by the
// L1-shell sweep (csrc/shell_sweep.cu) and the skewed-octant sweep
// (csrc/octant_sweep.cu): cinterp's corner weights, the diagonal boost,
// the path length (c2ray_tpu/sweep/cinterp.py:38-128), and the step of
// one cell (c2ray_tpu/sweep/source_sweep.py:186-244): the LLS column,
// cd_out, the band rates (route_rates of table_rates.cuh: the fixed
// rule's cell_rates, the "auto" blocks or the tau tables), the
// shielding mask and the photon and LLS losses.
//
// Offsets enter as magnitudes: cinterp's signed formulas give the same
// bits for a negative offset as for its mirror (IEEE negation is exact),
// so one code serves every octant and sign.
#pragma once

#include "table_rates.cuh"

namespace c2ray {

constexpr double kSqrt2 = 1.4142135623730951;
constexpr double kSqrt3 = 1.7320508075688772;
constexpr double kMinWeightDenom = 0.6;   // weightf's clamp

__device__ __forceinline__ int wrap(int x, int M) {
  if (x >= 0 && x < M) return x;
  if (x < 0 && x >= -M) return x + M;   // within a period: no division
  if (x >= M && x < 2 * M) return x - M;
  const int r = x % M;
  return r < 0 ? r + M : r;
}

// neutral columns per unit length of a cell's 5 fields:
// stack([h_av0, he_av0, he_av1]) * ndens * abu
template <typename T>
__device__ __forceinline__ void base_cols(const T* f, T bc[3]) {
  bc[0] = f[1] * f[0] * T(1.0 - kAbuHe);
  bc[1] = f[3] * f[0] * T(kAbuHe);
  bc[2] = f[4] * f[0] * T(kAbuHe);
}

// The dominant axis of offset magnitudes (a, b, c) along (x, y, z): z
// wins ties, then y (column_density.f90:107,199,275); 0, 1 or 2.
__device__ __forceinline__ int dominant_axis(int a, int b, int c) {
  if (c >= b && c >= a) return 2;
  if (b >= a && b >= c) return 1;
  return 0;
}

// Bilinear weights of the corners (u_m, v_m), (u, v_m), (u_m, v), (u, v)
// of a cell at magnitudes d_dom >= 1, d_u, d_v (column_density.f90:
// 111-122).
template <typename T>
__device__ __forceinline__ void corner_weights(T d_dom, T d_u, T d_v,
                                               T s[4]) {
  const T alam = (d_dom - T(0.5)) / d_dom;
  const T du = T(2) * xabs(alam * d_u - (d_u - T(0.5)));
  const T dv = T(2) * xabs(alam * d_v - (d_v - T(0.5)));
  s[0] = (T(1) - du) * (T(1) - dv);
  s[1] = du * (T(1) - dv);
  s[2] = (T(1) - du) * dv;
  s[3] = du * dv;
}

// The diagonal boost (column_density.f90:174-184)
template <typename T>
__device__ __forceinline__ T diag_boost(int d_dom, int d_u, int d_v) {
  const bool on_diag = d_dom == 1 && (d_u == 1 || d_v == 1);
  const bool full_diag = d_u == 1 && d_v == 1;
  return on_diag ? (full_diag ? T(kSqrt3) : T(kSqrt2)) : T(1);
}

// The path length through the cell in cell units
// (column_density.f90:194,269,341)
template <typename T>
__device__ __forceinline__ T path_units(T d_dom, T d_u, T d_v) {
  return xsqrt((d_u * d_u + d_v * d_v) / (d_dom * d_dom) + T(1));
}

// cinterp's opacity-weighted column (weightf, column_density.f90:
// 351-376) of four corners, times the boost.  A corner of weight 0 is
// not read: its term is exactly 0 either way, and such a corner may lie
// in the wavefront being written (an off-axis offset 0 stepped to -1)
// or outside the octant's planes (c[k] null).
template <typename T>
__device__ __forceinline__ void interp_columns(const T* const c[4],
                                               const T s[4], T boost,
                                               T cin[3]) {
  const T sig[3] = {T(kSigmaHI), T(kSigmaHeI), T(kSigmaHeII)};
  const T wmin = T(kMinWeightDenom);
  T v[4][3];
  for (int k = 0; k < 4; ++k) {
    const bool read = s[k] != T(0) && c[k] != nullptr;
    for (int q = 0; q < 3; ++q) v[k][q] = read ? c[k][q] : T(0);
  }
  for (int q = 0; q < 3; ++q) {
    T w[4];
    for (int k = 0; k < 4; ++k) w[k] = s[k] / maxp(v[k][q] * sig[q], wmin);
    const T wsum = w[0] + w[1] + w[2] + w[3];
    cin[q] = (v[0][q] * w[0] + v[1][q] * w[1] + v[2][q] * w[2] +
              v[3][q] * w[3]) / wsum;
    cin[q] = cin[q] * boost;
  }
}

// What the cell step needs besides the cell.
template <typename T>
struct StepConsts {
  const T* tab;        // packed band rows in shared memory
  BandTables bt;
  T dr, vol_over_scale, coldensh_lls, max_coldensh;
};

// One cell of a sweep (evolve0D, evolve_point.F90:177-315): the LLS
// column k.coldensh_lls (the homogeneous one, or the cell's own, which
// the shell kernel puts there) added to cin's HI column, cd_out = cin +
// base column x path.  With `deposit`, also the cell's rates into rates[4]
// (zero where shielded: cin_HI >= max_coldensh; the heat in rates[3], 0
// when isothermal), its escape into `ploss` when it lies on the trace
// boundary, and its LLS absorption into `lloss`; without, the band
// rates are not evaluated at all (a cell another octant owns).  kK is
// the table's K (0: k.bt.K at run time), or the route kTableRoute /
// kBlockRoute, whose tables `rt` holds (route_of).  A group of kLanes
// lanes may share the cell (`lane` its lane): each sums its share of the
// bands (cell_rates) and every lane ends with the same outputs.
template <typename T, bool kHeat, int kK = 0, int kLanes = 1>
__device__ __forceinline__ void cell_step(const StepConsts<T>& k,
                                          const T* nfl3, const T* f,
                                          T cin[3], T pu, T dist2,
                                          bool on_bound, bool deposit,
                                          T cd_out[3], T rates[4],
                                          T& ploss, T& lloss, int lane = 0,
                                          const RouteTables<T>* rt = nullptr) {
  const T path = pu * k.dr;
  const bool has_lls = k.coldensh_lls > T(0);
  const T lls_add = k.coldensh_lls * pu;
  if (has_lls) cin[0] += lls_add;
  T bc[3];
  base_cols(f, bc);
  for (int q = 0; q < 3; ++q) cd_out[q] = cin[q] + bc[q] * path;
  if (!deposit) return;
  const T vol_ratio = T(4.0 * kPi) * dist2 * pu;
  const bool live = cin[0] < k.max_coldensh;
  T y[6];
  if constexpr (kHeat) ricotti(f[2], y);
  constexpr int kOut = kHeat ? 6 : 5;
  T r[kOut];
  route_rates<T, kHeat, false, kK>(k.tab, k.bt, rt, nfl3, cin, cd_out,
                                   vol_ratio * k.vol_over_scale, y, r,
                                   nullptr, lane, kLanes);
  for (int q = 0; q < kOut; ++q) r[q] = group_sum<kLanes>(r[q]);
  const T fl = live ? T(1) : T(0);
  rates[0] = fl * r[0] / bc[0];
  rates[1] = fl * r[1] / bc[1];
  rates[2] = fl * r[2] / bc[2];
  if constexpr (kHeat) {
    rates[3] = fl * r[5];
  } else {
    rates[3] = T(0);
  }
  if (live && on_bound) ploss = r[4] / vol_ratio;
  if (live && has_lls) {
    lloss = r[3] / vol_ratio * (-xexpm1(-T(kSigmaHI) * lls_add));
  }
}

// The source cell (evolve_point.F90:140-151): its half-cell columns cc0
// and its rates (the heat unmasked); kK < 0 names the route (its tables
// in rt), any other value the fixed rule at a K known at run time.
template <typename T, bool kHeat, int kK = 0>
__device__ __forceinline__ void source_cell(
    const StepConsts<T>& k, const T* nfl3, const T* f, T cc0[3], T rates[4],
    const RouteTables<T>* rt = nullptr) {
  T bc[3];
  base_cols(f, bc);
  const T half_dr = T(0.5) * k.dr;
  for (int q = 0; q < 3; ++q) cc0[q] = bc[q] * half_dr;
  const T zero3[3] = {T(0), T(0), T(0)};
  T y[6];
  if constexpr (kHeat) ricotti(f[2], y);
  T r[kHeat ? 6 : 5];
  route_rates<T, kHeat, false, (kK < 0 ? kK : 0)>(
      k.tab, k.bt, rt, nfl3, zero3, cc0, k.vol_over_scale, y, r, nullptr);
  rates[0] = r[0] / bc[0];
  rates[1] = r[1] / bc[1];
  rates[2] = r[2] / bc[2];
  if constexpr (kHeat) {
    rates[3] = r[5];
  } else {
    rates[3] = T(0);
  }
}

}  // namespace c2ray
