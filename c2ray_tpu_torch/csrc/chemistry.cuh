// The per-cell chemistry as device functions, shared by the 3D
// chemistry pass (csrc/chemistry.cu) and the 1D radial march
// (csrc/evolve1d.cu): the rate fits, the electron density, the doric
// solver with its two-pass averaging, and the thermal sub-cycle with its
// cooling-table lookup.
//
// Replaces c2ray_tpu/chemistry.py: doric (:150), electrondens (:51),
// prepare_doric_factors (:84); c2ray_tpu/rates.py: rate_coefficients
// (:44); c2ray_tpu/thermal.py: thermal_init (:84), thermal_substeps
// (:119), thermal_finalize (:177); c2ray_tpu/cooling.py: coolin (:120).
//
// doric keeps the two-sector scaling, the quadratic-root identity and
// expm1 of c2ray_tpu/chemistry.py: float32 needs each of them.
#pragma once

#include "common.cuh"

namespace c2ray {

constexpr double kMinFractionalChange = 1.0e-2;
constexpr double kMinFractionOfAtoms = 1.0e-8;
// c2ray_tpu/constants.py
constexpr double kEvToK = 1.0 / 8.617e-05;
constexpr double kTempH0 = 13.598 * kEvToK;
constexpr double kTempHe0 = 24.587 * kEvToK;
constexpr double kTempHe1 = 54.416 * kEvToK;
constexpr double kColH0 = 1.3e-8 * 0.83 * 1.0 / (13.598 * 13.598);
constexpr double kColHe0 = 1.3e-8 * 0.63 * 2.0 / (24.587 * 24.587);
constexpr double kColHe1 = 1.3e-8 * 1.30 * 1.0 / (54.416 * 54.416);
constexpr double kSigmaHHeth = 1.238e-18;
constexpr double kSigmaHHeLya = 9.907e-22;
constexpr double kSigmaHeHeLya = 1.301e-20;
constexpr double kSigmaHeHe2 = 1.690780687052975e-18;
constexpr double kSigmaHHe2 = 1.230695924714239e-19;
constexpr double kBoltzmann = 1.381e-16;                 // k_B
constexpr double kGamma1 = 5.0 / 3.0 - 1.0;              // gamma - 1
// c2ray_tpu/cooling.py: 801 points over log10 T in [1, 9]
constexpr int kTempPoints = 801;
constexpr double kMinTempLog = 1.0;
constexpr double kDTempLog = (9.0 - 1.0) / (801 - 1);
// c2ray_tpu/thermal.py (c2ray_parameters.f90:87-89)
constexpr double kMiniTemp = 1.0;
constexpr double kRelativeDEnergy = 0.1;
constexpr int kMaxSubsteps = 10000;

// How the functions below run.  PerCell, the default (the 3D chemistry
// pass): one thread per cell, IEEE `/`, the cooling table read through
// __ldg.  PerWarp (the 1D march, csrc/evolve1d.cu): the 32 lanes of a
// warp run one cell on identical values, so doric spreads its
// exponentials over the lanes (kSpread), a division is div_flat's (the
// same bits without a branch), and the cooling table lies in shared
// memory (kSharedTable).
struct PerCell {
  static constexpr bool kSpread = false, kSharedTable = false;
  template <typename T>
  static __device__ __forceinline__ T div(T a, T b) { return a / b; }
};
struct PerWarp {
  static constexpr bool kSpread = true, kSharedTable = true;
  template <typename T>
  static __device__ __forceinline__ T div(T a, T b) { return div_flat(a, b); }
};

template <typename T>
struct Ion {
  T h0, h1, he0, he1, he2;
};

template <typename T>
struct IonState {
  Ion<T> cur, avg, old;
};

template <typename T>
struct Rates {
  T arech0, brech0, areche0, breche0, oreche0, areche1, breche1, treche1,
      colli_HI, colli_HeI, colli_HeII, v;
};

template <typename T>
struct Factors {
  T yfrac, zfrac, y2afrac, y2bfrac;
};

// rates.py:rate_coefficients' fits, described here once:
// rate_coefficients (the 3D pass) evaluates them in place, the 1D march
// spreads their powers and exponentials over a warp's lanes
// (csrc/evolve1d.cu: spread_fits).  A recombination fit is
// c lam^a / (1 + (lam / d)^b)^e of lam = 2 T_ion / t.
struct FitArecH0 {
  static constexpr double t_ion = kTempH0, c = 1.269e-13, a = 1.503,
                          d = 0.522, b = 0.470, e = 1.923;
};
struct FitBrecH0 {
  static constexpr double t_ion = kTempH0, c = 2.753e-14, a = 1.500,
                          d = 2.740, b = 0.407, e = 2.242;
};
struct FitBrecHe1 {
  static constexpr double t_ion = kTempHe1, c = 5.5060e-14, a = 1.5,
                          d = 2.740, b = 0.407, e = 2.242;
};
struct FitArecHe1 {
  static constexpr double t_ion = kTempHe1, c = 2.538e-13, a = 1.503,
                          d = 0.522, b = 0.470, e = 1.923;
};
// HeI at and above kFitColdT: c lam^a of lam = 2 T_He0 / t, plus the
// dielectronic term c t^a exp(e1 / t) (1 + f exp(e2 / t))
constexpr double kFitColdT = 9.0e3;
struct FitAHotHe0 {
  static constexpr double t_ion = kTempHe0, c = 3.000e-14, a = 0.654;
};
struct FitBHotHe0 {
  static constexpr double t_ion = kTempHe0, c = 1.260e-14, a = 0.750;
};
struct FitDielectronic {
  static constexpr double c = 1.9e-3, a = -1.5, e1 = -4.7e5, f = 0.3,
                          e2 = -9.4e4;
};
// c (t / 1e4)^a
struct FitTreche1 {
  static constexpr double c = 3.4e-13, a = -0.6;
};
struct FitV {
  static constexpr double c = 0.285, a = 0.119;
};
static_assert(FitArecH0::t_ion == FitBrecH0::t_ion &&
                  FitBrecHe1::t_ion == FitArecHe1::t_ion &&
                  FitAHotHe0::t_ion == FitBHotHe0::t_ion,
              "rate_coefficients computes one lam per pair of fits");

template <typename F, typename T>
__device__ __forceinline__ T recomb_fit(T lam) {
  return T(F::c) * xpow(lam, T(F::a)) /
         xpow(T(1) + xpow(lam / T(F::d), T(F::b)), T(F::e));
}

// rates.py:rate_coefficients
template <typename T>
__device__ Rates<T> rate_coefficients(T t) {
  using D = FitDielectronic;
  Rates<T> r;
  const T lam_H = T(2) * (T(FitArecH0::t_ion) / t);
  r.arech0 = recomb_fit<FitArecH0>(lam_H);
  r.brech0 = recomb_fit<FitBrecH0>(lam_H);
  const T lam_He0 = T(2) * (T(FitAHotHe0::t_ion) / t);
  const T dielectronic = T(D::c) * xpow(t, T(D::a)) * xexp(T(D::e1) / t) *
                         (T(1) + T(D::f) * xexp(T(D::e2) / t));
  const T areche0_hot =
      T(FitAHotHe0::c) * xpow(lam_He0, T(FitAHotHe0::a)) + dielectronic;
  const T breche0_hot =
      T(FitBHotHe0::c) * xpow(lam_He0, T(FitBHotHe0::a)) + dielectronic;
  const bool cold = t < T(kFitColdT);
  r.areche0 = cold ? r.arech0 : areche0_hot;
  r.breche0 = cold ? r.brech0 : breche0_hot;
  r.oreche0 = r.areche0 - r.breche0;
  const T lam_He1 = T(2) * (T(FitBrecHe1::t_ion) / t);
  r.breche1 = recomb_fit<FitBrecHe1>(lam_He1);
  r.areche1 = recomb_fit<FitArecHe1>(lam_He1);
  r.treche1 = T(FitTreche1::c) * xpow(t / T(1.0e4), T(FitTreche1::a));
  r.v = T(FitV::c) * xpow(t / T(1.0e4), T(FitV::a));
  const T sqrtT = xsqrt(t);
  r.colli_HI = T(kColH0) * sqrtT * xexp(-T(kTempH0) / t);
  r.colli_HeI = T(kColHe0) * sqrtT * xexp(-T(kTempHe0) / t);
  r.colli_HeII = T(kColHe1) * sqrtT * xexp(-T(kTempHe1) / t);
  return r;
}

// chemistry.py:electrondens
template <typename T>
__device__ __forceinline__ T electrondens(T ndens, const Ion<T>& x) {
  return ndens * (x.h1 * T(1.0 - kAbuHe) + T(kAbuC) +
                  T(kAbuHe) * (x.he1 + T(2) * x.he2));
}

// chemistry.py:coldens of the three species over `path` into
// chemistry.py:prepare_doric_factors (global_pass.py:_doric_half's
// factors_from takes a unit path, onedim/evolve.py the shell width)
template <typename T, typename P = PerCell>
__device__ Factors<T> factors_from(T ndens, const Ion<T>& x, T path) {
  const T tiny = Limits<T>::tiny();
  const T NHI = x.h0 * ndens * path * T(1.0 - kAbuHe);
  const T NHeI = x.he0 * ndens * path * T(kAbuHe);
  const T NHeII = x.he1 * ndens * path * T(kAbuHe);
  const T inv_a = P::div(T(1), maxp(T(0) + NHI + NHeI, tiny));
  const T nh_a = NHI * inv_a, nhe_a = NHeI * inv_a;
  const T tau_H_heth = nh_a * T(kSigmaHHeth);
  const T tau_He_heth = nhe_a * T(kSigmaHeI);
  const T tau_H_heLya = nh_a * T(kSigmaHHeLya);
  const T tau_He_heLya = nhe_a * T(kSigmaHeHeLya);
  const T inv_b = P::div(T(1), maxp(T(0) + NHI + NHeI + NHeII, tiny));
  const T nh_b = NHI * inv_b, nhe_b = NHeI * inv_b, nhe2_b = NHeII * inv_b;
  const T tau_H_he2th = nh_b * T(kSigmaHHe2);
  const T tau_He_he2th = nhe_b * T(kSigmaHeHe2);
  const T tau_He2_he2th = nhe2_b * T(kSigmaHeII);
  const T denom2 = tau_He2_he2th + tau_He_he2th + tau_H_he2th;
  Factors<T> f;
  f.yfrac = P::div(tau_H_heth, tau_H_heth + tau_He_heth);
  f.zfrac = P::div(tau_H_heLya, tau_H_heLya + tau_He_heLya);
  f.y2afrac = P::div(tau_He2_he2th, denom2);
  f.y2bfrac = P::div(tau_He_he2th, denom2);
  return f;
}

// chemistry.py:_clamp_h (h0 branch first)
template <typename T>
__device__ __forceinline__ void clamp_h(T& h0, T& h1, T eps, T one_m_eps) {
  if (h0 < eps) { h0 = eps; h1 = one_m_eps; }
  if (h1 < eps) { h1 = eps; h0 = one_m_eps; }
}

// chemistry.py:_clamp_h_avg (h1 branch first)
template <typename T>
__device__ __forceinline__ void clamp_h_avg(T& h0, T& h1, T eps,
                                            T one_m_eps) {
  if (h1 < eps) { h1 = eps; h0 = one_m_eps; }
  if (h0 < eps) { h0 = eps; h1 = one_m_eps; }
}

// chemistry.py:_clamp_he
template <typename T, typename P = PerCell>
__device__ __forceinline__ void clamp_he(T& he0, T& he1, T& he2, T eps) {
  if (he0 <= eps || he1 <= eps || he2 <= eps) {
    const T c0 = maxp(he0, eps), c1 = maxp(he1, eps), c2 = maxp(he2, eps);
    const T norm = c0 + c1 + c2;
    he0 = P::div(c0, norm); he1 = P::div(c1, norm); he2 = P::div(c2, norm);
  }
}

template <typename T, typename P = PerCell>
__device__ __forceinline__ T em1_over(T x) {
  return x == T(0) ? T(1) : P::div(xexpm1(x), x);
}

// chemistry.py:doric, term for term.  P::kSpread (the 1D march, whose
// 32 lanes all run the same cell): lane l evaluates the exponential and
// em1_over of lambda_(l mod 3) dt, and __shfl_sync gathers the six
// values -- the same functions of the same operands, so the same bits,
// with one chain of them on the warp's path instead of three.
template <typename T, typename P = PerCell>
__device__ IonState<T> doric(T dt, T ne, const IonState<T>& ion, T pHI,
                             T pHeI, T pHeII, const Factors<T>& fac,
                             const Rates<T>& r, T clump, T eps,
                             T one_m_eps) {
  const T tiny = Limits<T>::tiny();
  const T pfrac = T(0.96);
  const T heliumfraction = T(kAbuHe / (1.0 - kAbuHe));
  const T ffrac = minp(maxp(T(10) * ion.cur.h0, T(0.01)), T(1));
  const T yfrac = fac.yfrac, zfrac = fac.zfrac;
  const T y2afrac = fac.y2afrac, y2bfrac = fac.y2bfrac;
  const T wfrac = T(1.425 - 0.737) + T(0.737) * yfrac;
  const T v = r.v;

  const T alpha_h_B = clump * r.brech0;
  const T alpha_he_1 = clump * r.oreche0;
  const T alpha_he_B = clump * r.breche0;
  const T alpha_he_A = clump * r.areche0;
  const T alpha_he2_B = clump * r.breche1;
  const T alpha_he2_A = clump * r.areche1;
  const T alpha_he2_2 = clump * r.treche1;
  const T alpha_he2_1 = alpha_he2_A - alpha_he2_B;

  const T aih0 = maxp(pHI + ne * r.colli_HI, tiny);
  const T aihe0 = maxp(pHeI + ne * r.colli_HeI, tiny);
  const T aihe1 = maxp(pHeII + ne * r.colli_HeII, tiny);

  // two-sector nondimensionalisation
  const T sH = aih0 + ne * alpha_h_B;
  const T sHe = aihe0 + aihe1 + ne * (alpha_he_A + alpha_he2_A);
  const T a0 = P::div(aihe0, sHe);
  const T a1 = P::div(aihe1, sHe);
  const T nes = P::div(ne, sHe);

  const T Lmat = -sH;
  const T Mt = (yfrac * nes * alpha_he_1 + pfrac * nes * alpha_he_B) *
               heliumfraction;
  const T Nt = ((ffrac * zfrac * (T(1) - v) + v * wfrac) * alpha_he2_B +
                alpha_he2_2 + (T(1) - y2afrac - y2bfrac) * alpha_he2_1) *
               heliumfraction * nes;
  const T Pt = -a0 - a1 - nes * (alpha_he_A - (T(1) - yfrac) * alpha_he_1);
  const T Et = -nes * (alpha_he2_A - y2afrac * alpha_he2_1);
  const T Qt = -a0 +
               nes * alpha_he2_B *
                   (ffrac * (T(1) - zfrac) * (T(1) - v) +
                    v * (T(1.425) - wfrac)) -
               Et + alpha_he2_1 * y2bfrac * nes;

  const T Bt = Et - Pt;
  const T four_aQ = T(4) * a1 * Qt;
  const T St = xsqrt(Bt * Bt + four_aQ);
  const T QHEPt = P::div(T(1), Qt * a1 - Et * Pt);
  // B -+ S with the quadratic-root product identity (B-S)(B+S) = -4aQ
  const T big = Bt >= T(0) ? Bt + St : Bt - St;
  const T small = P::div(-four_aQ, xabs(big) > tiny ? big : tiny);
  const T BmSt = Bt >= T(0) ? small : big;
  const T BpSt = Bt >= T(0) ? big : small;

  const T lambda1 = Lmat;
  const T lambda2 = T(0.5) * sHe * (Et + Pt - St);
  const T lambda3 = T(0.5) * sHe * (Et + Pt + St);

  const T rx = P::div(aih0, sH) +
               P::div(sHe, sH) * ((Mt * Et - Nt * a1) * (a0 * QHEPt));
  const T ry = a0 * (Et * QHEPt);
  const T rz = -a0 * (a1 * QHEPt);

  const T dy = ry - ion.old.he1;
  const T Tz = rz - ion.old.he2;
  const T twoS = T(2) * maxp(St, tiny);
  const T Lm2 = Lmat - lambda2;
  const T Lm3 = Lmat - lambda3;
  const T r2 = P::div(sHe, Lm2 == T(0) ? -tiny : Lm2);
  const T r3 = P::div(sHe, Lm3 == T(0) ? -tiny : Lm3);
  const T u2 = T(-2) * a1 * Nt + Mt * BpSt;
  const T u3 = T(-2) * a1 * Nt + Mt * BmSt;
  const T w2 = Nt * BmSt + T(2) * Qt * Mt;
  const T w3 = Nt * BpSt + T(2) * Qt * Mt;
  const T X2 = P::div((u2 * dy - w2 * Tz) * r2, twoS);
  const T X3 = P::div((-u3 * dy + w3 * Tz) * r3, twoS);
  const T Y2 = P::div(-(BpSt * dy - T(2) * Qt * Tz), twoS);
  const T Y3 = P::div(BmSt * dy - T(2) * Qt * Tz, twoS);
  const T Z2 = P::div(T(2) * a1 * dy + BmSt * Tz, twoS);
  const T Z3 = P::div(-(T(2) * a1 * dy + BpSt * Tz), twoS);
  const T coef1 = ion.old.h1 - rx - X2 - X3;

  const T lam1dt = dt * lambda1;
  const T lam2dt = dt * lambda2;
  const T lam3dt = dt * lambda3;
  T e1, e2, e3, f1, f2, f3;
  if constexpr (P::kSpread) {
    constexpr unsigned kAll = 0xffffffffu;
    const unsigned l = (threadIdx.x & 31u) % 3u;
    const T x = l == 0 ? lam1dt : (l == 1 ? lam2dt : lam3dt);
    const T e = xexp(x), f = em1_over<T, P>(x);
    e1 = __shfl_sync(kAll, e, 0);
    e2 = __shfl_sync(kAll, e, 1);
    e3 = __shfl_sync(kAll, e, 2);
    f1 = __shfl_sync(kAll, f, 0);
    f2 = __shfl_sync(kAll, f, 1);
    f3 = __shfl_sync(kAll, f, 2);
  } else {
    e1 = xexp(lam1dt);
    e2 = xexp(lam2dt);
    e3 = xexp(lam3dt);
  }

  IonState<T> out;
  out.old = ion.old;
  Ion<T>& c = out.cur;
  c.h1 = coef1 * e1 + X2 * e2 + X3 * e3 + rx;
  c.he1 = Y2 * e2 + Y3 * e3 + ry;
  c.he2 = Z2 * e2 + Z3 * e3 + rz;
  c.h0 = T(1) - c.h1;
  c.he0 = T(1) - c.he1 - c.he2;
  clamp_h(c.h0, c.h1, eps, one_m_eps);
  clamp_he<T, P>(c.he0, c.he1, c.he2, eps);

  if constexpr (!P::kSpread) {
    f1 = em1_over<T, P>(lam1dt);
    f2 = em1_over<T, P>(lam2dt);
    f3 = em1_over<T, P>(lam3dt);
  }
  Ion<T>& a = out.avg;
  a.h1 = rx + coef1 * f1 + X2 * f2 + X3 * f3;
  a.he1 = ry + Y2 * f2 + Y3 * f3;
  a.he2 = rz + Z2 * f2 + Z3 * f3;
  a.h0 = T(1) - a.h1;
  a.he0 = T(1) - a.he1 - a.he2;
  clamp_h_avg(a.h0, a.h1, eps, one_m_eps);
  clamp_he<T, P>(a.he0, a.he1, a.he2, eps);
  return out;
}

template <typename T>
__device__ __forceinline__ T half(T a, T b) { return T(0.5) * (a + b); }

// global_pass.py:_doric_half with the iteration's rates: two doric
// passes, their doric factors from the cell columns over `path`, and
// the reference's averaging (onedim/evolve.py:_solve_cell does the same)
template <typename T, typename P = PerCell>
__device__ IonState<T> doric_half(T dt, T ndens, T clump, T pHI, T pHeI,
                                  T pHeII, const Rates<T>& r,
                                  const IonState<T>& ion, T eps,
                                  T one_m_eps, T path) {
  T de = electrondens(ndens, ion.avg);
  const IonState<T> ion1 = doric<T, P>(dt, de, ion, pHI, pHeI, pHeII,
                                       factors_from<T, P>(ndens, ion.cur, path),
                                       r, clump, eps, one_m_eps);
  de = electrondens(ndens, ion1.avg);
  const IonState<T> ion2 = doric<T, P>(dt, de, ion1, pHI, pHeI, pHeII,
                                       factors_from<T, P>(ndens, ion1.cur, path),
                                       r, clump, eps, one_m_eps);
  IonState<T> out;
  out.old = ion.old;
  out.cur.h0 = half(ion2.cur.h0, ion1.cur.h0);
  out.cur.h1 = half(ion2.cur.h1, ion1.cur.h1);
  out.cur.he0 = half(ion2.cur.he0, ion1.cur.he0);
  out.cur.he1 = half(ion2.cur.he1, ion1.cur.he1);
  out.cur.he2 = half(ion2.cur.he2, ion1.cur.he2);
  // the reference averages h_av(0), he_av(0), he_av(1) only
  // (evolve_point.F90:593-595)
  out.avg.h0 = half(ion2.avg.h0, ion1.avg.h0);
  out.avg.h1 = ion2.avg.h1;
  out.avg.he0 = half(ion2.avg.he0, ion1.avg.he0);
  out.avg.he1 = half(ion2.avg.he1, ion1.avg.he1);
  out.avg.he2 = ion2.avg.he2;
  return out;
}

// cooling.py:coolin, one cell: linear in log10 T over the (801, 5)
// table (species last), truncating int cast, row clipped to [0, 799],
// signed fraction (so T < 10 K and T > 1e9 K extrapolate as in JAX).
// The table lies in global memory, read through __ldg, or with
// P::kSharedTable in shared memory (the 1D march keeps a copy there).
template <typename T, typename P = PerCell>
__device__ T coolin(const T* __restrict__ tab, T nucldens, T eldens,
                    const Ion<T>& x, T temp) {
  const T tpos = P::div(xlog10(temp) - T(kMinTempLog), T(kDTempLog));
  const int it = min(max(int(tpos), 0), kTempPoints - 2);
  const T d = tpos - T(it);
  const T xs[5] = {x.h0 * T(1.0 - kAbuHe), x.h1 * T(1.0 - kAbuHe),
                   x.he0 * T(kAbuHe), x.he1 * T(kAbuHe), x.he2 * T(kAbuHe)};
  const T* lo = tab + it * 5;
  T sum = T(0);
  for (int s = 0; s < 5; ++s) {
    const T a = P::kSharedTable ? lo[s] : __ldg(lo + s);
    const T b = P::kSharedTable ? lo[5 + s] : __ldg(lo + 5 + s);
    sum += (a + (b - a) * d) * xs[s];
  }
  return nucldens * eldens * sum;
}

// thermal.py:temper2pressr / pressr2temper
template <typename T>
__device__ __forceinline__ T temper2pressr(T temp, T nd, T ne) {
  return (nd + ne) * T(kBoltzmann) * temp;
}

template <typename T, typename P = PerCell>
__device__ __forceinline__ T pressr2temper(T p, T nd, T ne) {
  return P::div(p, T(kBoltzmann) * (nd + ne));
}

template <typename T>
struct ThermalOut {
  T end_t, avg_t;
  int nsub;
};

// thermal.py:thermal for one cell: thermal_init, the sub-cycle of
// thermal_substeps as a loop of the cell's own steps, thermal_finalize.
// ne_cool is coolin's electron density (the blended ions' average).
template <typename T, typename P = PerCell>
__device__ ThermalOut<T> thermal(T dt, T T0, T ne_cool, T nd,
                                 const IonState<T>& ion, T heating,
                                 const T* __restrict__ tab, T ccf) {
  const T ne_old = electrondens(nd, ion.old);
  const T ne_av = electrondens(nd, ion.avg);
  const T ne_end = electrondens(nd, ion.cur);
  const T u0 = P::div(temper2pressr(T0, nd, ne_old), T(kGamma1));
  // fixed during the sub-cycle, from the initial energy
  const T cosmo_cool_rate = ccf * u0;
  ThermalOut<T> r;
  r.nsub = 0;
  if (!(T0 > T(kMiniTemp))) {   // never enters the loop
    r.end_t = T0;
    r.avg_t = T0;
    return r;
  }
  // floor at minitemp with the consistent u = p / gamma1
  const T u_floor = P::div(temper2pressr(T(kMiniTemp), nd, ne_av),
                           T(kGamma1));
  T u = u0, temp = T0, avg_sum = T(0), cum = T(0);
  while (r.nsub < kMaxSubsteps) {
    const T cooling = coolin<T, P>(tab, nd, ne_cool, ion.avg, temp) +
                      cosmo_cool_rate;
    const T rate = maxp(xabs(cooling - heating), Limits<T>::rate_floor());
    const T dt_thermal = P::div(T(kRelativeDEnergy) * u, rate);
    const T dt_ode = minp(dt_thermal, dt - cum);
    T u_new = u + dt_ode * (heating - cooling);
    T avg_new = avg_sum + T(0.5) * temp * dt_ode;
    T t_new = pressr2temper<T, P>(u_new * T(kGamma1), nd, ne_av);
    avg_new = avg_new + T(0.5) * t_new * dt_ode;
    if (t_new < T(kMiniTemp)) {
      u_new = u_floor;
      t_new = T(kMiniTemp);
    }
    const T cum_new = cum + dt_ode;
    const bool done = cum_new >= dt || xabs(cum_new - dt) < T(1e-6) * dt;
    u = u_new;
    temp = t_new;
    avg_sum = avg_new;
    cum = cum_new;
    ++r.nsub;
    if (done) break;
  }
  r.avg_t = dt > T(0) ? P::div(avg_sum, dt) : T0;
  r.end_t = pressr2temper<T, P>(u * T(kGamma1), nd, ne_end);
  return r;
}

}  // namespace c2ray
