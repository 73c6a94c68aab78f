// The quadrature band rates of one cell as a device function, shared by
// the pyramid sweep (csrc/pyramid_sweep.cu) and the 1D radial march
// (csrc/evolve1d.cu).
//
// Replaces c2ray_tpu/radiation/quadrature.py: _attenuation (:324) and
// _one_source_quad (:330), summed over the source types as
// photoion_rates_quad does: its isothermal branch, with kHeat its
// heating branch (:401-449: per-species thick/thin heating, the Ricotti
// y1R/y2R secondary ionization and heating), with kTrack its
// track_bands output (:388-394).
#pragma once

#include "common.cuh"

namespace c2ray {

constexpr double kTauPhotoLimit = 1.0e-7;  // photo.py:TAU_PHOTO_LIMIT
constexpr double kTauHeatLimit = 1.0e-4;   // photo.py:TAU_HEAT_LIMIT
// ion_freq * hplanck of HI and HeI (c2ray_tpu/constants.py)
constexpr double kIonEnergyHI = 0.241838e15 * 13.598 * 6.6260755e-27;
constexpr double kIonEnergyHeI = 0.241838e15 * 24.587 * 6.6260755e-27;

// The packed band rows' layout: per source type in use, its nflux
// column, its live band count and its first band in the full band axis;
// the rows of the types follow each other.
struct BandTables {
  int K, ntypes;
  int type_col[3], type_nb[3], type_lo[3];
};

// Values per band row: [sig_HI, sig_HeI, sig_HeII, mask_HeI, mask_HeII,
// sighat(K), A(K)], and with heating after those [A_heat_HI(K),
// A_heat_HeI(K), A_heat_HeII(K), f1ion(3), f2ion(3), f1heat(3),
// f2heat(3)] (radiation/quadrature.py:packed_band_rows).
template <bool kHeat>
__host__ __device__ __forceinline__ int row_stride(int K) {
  return kHeat ? 17 + 5 * K : 5 + 2 * K;
}

// Ricotti et al. 2002 secondary-ionization fits of one cell
// (quadrature.py:421-426): y[i] = y1R(i), y[3 + i] = y2R(i)
template <typename T>
__device__ __forceinline__ T y1R(T x, T c, T b, T d) {
  return c * xpow(T(1) - xpow(x, b), d);
}

template <typename T>
__device__ __forceinline__ T y2R(T x, T c, T a, T b) {
  const T xeb = T(1) - xpow(x, b);
  return c * xpow(x, a) * xeb * xeb;
}

template <typename T>
__device__ __forceinline__ void ricotti(T x, T y[6]) {
  y[0] = y1R(x, T(0.3908), T(0.4092), T(1.7592));
  y[1] = y1R(x, T(0.0554), T(0.4614), T(1.6660));
  y[2] = y1R(x, T(1.0), T(0.2663), T(1.3163));
  y[3] = y2R(x, T(0.6941), T(0.2), T(0.38));
  y[4] = y2R(x, T(0.0984), T(0.2), T(0.38));
  y[5] = y2R(x, T(3.9811), T(0.4), T(0.34));
}

// s += x with the rounding carried in c (Kahan).  The heat adds one term
// per band (33 for a 5e4 K blackbody) in sequence; as a plain running
// sum it loses ~2 float32 ulp of the largest heat, 9x the plain
// version's error, whose torch.sum reduces the bands in a tree.
template <typename T>
__device__ __forceinline__ void kahan_add(T& s, T& c, T x) {
  const T y = x - c;
  const T t = s + y;
  c = (t - s) - y;
  s = t;
}

// _one_source_quad summed over the source types (photoion_rates_quad):
// out = photo_cell_{HI,HeI,HeII}, photo_in, photo_out and, with kHeat,
// heat; `y` holds the cell's ricotti() values (heating only).  A caller
// that splits the bands over lanes passes its lane and the lane count:
// each lane then sums the bands b = lane, lane + nlanes, ... of every
// type, and the caller adds the lanes' partial sums.  With kTrack and a
// non-null bstage each band's photo_out is added to
// bstage[band * kStageStride], band in the full band axis.
template <typename T, bool kHeat, bool kTrack, int kStageStride = 1>
__device__ void cell_rates(const T* tab, const BandTables& d, const T* nfl3,
                           const T* cin, const T* cout, T vol, const T* y,
                           T out[kHeat ? 6 : 5], T* bstage, int lane = 0,
                           int nlanes = 1) {
  constexpr int kOut = kHeat ? 6 : 5;
  const int K = d.K;
  const int stride = row_stride<kHeat>(K);
  const T tiny = Limits<T>::tiny();
  for (int q = 0; q < kOut; ++q) out[q] = T(0);
  int b0 = 0;
  for (int t = 0; t < d.ntypes; ++t) {
    const T nfl = nfl3[d.type_col[t]];
    T acc[5] = {T(0), T(0), T(0), T(0), T(0)};
    // heat (compensated), f_ion_HI, f_ion_HeI (quadrature.py:437-439)
    T hacc[3] = {T(0), T(0), T(0)}, hcomp = T(0);
    for (int b = lane; b < d.type_nb[t]; b += nlanes) {
      const T* rb = tab + (b0 + b) * stride;
      const T sHI = rb[0], sHeI = rb[1], sHeII = rb[2];
      const T mHeI = rb[3], mHeII = rb[4];
      const T* sh = rb + 5;
      const T* A = rb + 5 + K;
      const T tau_in = cin[0] * sHI + cin[1] * sHeI + cin[2] * sHeII;
      const T tau_out = cout[0] * sHI + cout[1] * sHeI + cout[2] * sHeII;
      const T tcHI = sHI * (cout[0] - cin[0]);
      const T tcHeI = sHeI * (cout[1] - cin[1]);
      const T tcHeII = sHeII * (cout[2] - cin[2]);
      const T inv = T(1) / maxp(tcHI + tcHeI + tcHeII, tiny);
      T g_in = T(0), g_thick = T(0), g_thin = T(0);
      // per species: sum A_heat (e_in - e_out), sum A_heat sighat e_in
      T h_thick[3] = {T(0), T(0), T(0)}, h_thin[3] = {T(0), T(0), T(0)};
      for (int k = 0; k < K; ++k) {
        const T e_in = xexp(-minp(tau_in * sh[k], T(80)));
        const T e_out = xexp(-minp(tau_out * sh[k], T(80)));
        g_in += A[k] * e_in;
        g_thick += A[k] * (e_in - e_out);
        g_thin += A[k] * sh[k] * e_in;
        if constexpr (kHeat) {
          for (int sp = 0; sp < 3; ++sp) {
            const T Ah = rb[5 + (2 + sp) * K + k];
            h_thick[sp] += Ah * (e_in - e_out);
            h_thin[sp] += Ah * sh[k] * e_in;
          }
        }
      }
      const T dtau = tau_out - tau_in;
      const T phi_in = nfl * g_in;
      const T phi_all = xabs(dtau) > T(kTauPhotoLimit) ? nfl * g_thick
                                                         : nfl * dtau * g_thin;
      acc[0] += tcHI * inv * phi_all / vol;
      acc[1] += mHeI * (tcHeI * inv) * phi_all / vol;
      acc[2] += mHeII * (tcHeII * inv) * phi_all / vol;
      acc[3] += phi_in;
      acc[4] += phi_in - phi_all;
      if constexpr (kTrack) {
        if (bstage) {
          bstage[(d.type_lo[t] + b) * kStageStride] += phi_in - phi_all;
        }
      }
      if constexpr (kHeat) {
        // species_heat (quadrature.py:404-415): thick/thin at the heat
        // limit, masked like the photo rates
        const bool hthick = xabs(dtau) > T(kTauHeatLimit);
        const T tc[3] = {tcHI, tcHeI, tcHeII};
        const T mk[3] = {T(1), mHeI, mHeII};
        T ph[3];
        for (int sp = 0; sp < 3; ++sp) {
          const T thick = tc[sp] * inv * nfl * h_thick[sp] / vol;
          const T thin = nfl * tc[sp] * h_thin[sp] / vol;
          ph[sp] = mk[sp] * (hthick ? thick : thin);
        }
        const T* f = rb + 5 + 5 * K;
        const T fra1 = f[0] * ph[0] + f[1] * ph[1] + f[2] * ph[2];
        const T fra2 = f[3] * ph[0] + f[4] * ph[1] + f[5] * ph[2];
        const T fra3 = f[6] * ph[0] + f[7] * ph[1] + f[8] * ph[2];
        const T fra4 = f[9] * ph[0] + f[10] * ph[1] + f[11] * ph[2];
        kahan_add(hacc[0], hcomp,
                  ph[0] + ph[1] + ph[2] - y[2] * fra3 + y[5] * fra4);
        hacc[1] += y[0] * fra1 - y[3] * fra2;
        hacc[2] += y[1] * fra1 - y[4] * fra2;
      }
    }
    if constexpr (kHeat) {
      out[0] += acc[0] + hacc[1] / T(kIonEnergyHI);
      out[1] += acc[1] + hacc[2] / T(kIonEnergyHeI);
      for (int q = 2; q < 5; ++q) out[q] += acc[q];
      out[5] += hacc[0];
    } else {
      for (int q = 0; q < 5; ++q) out[q] += acc[q];
    }
    b0 += d.type_nb[t];
  }
}

}  // namespace c2ray
