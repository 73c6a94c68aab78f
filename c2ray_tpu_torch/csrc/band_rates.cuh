// The quadrature band rates of one cell as a device function, shared by
// the pyramid sweep (csrc/pyramid_sweep.cu), the shell and octant sweeps
// (through csrc/short_char.cuh) and the 1D radial march
// (csrc/evolve1d.cu).
//
// Replaces c2ray_tpu/radiation/quadrature.py: _attenuation (:324) and
// _one_source_quad (:330), summed over the source types as
// photoion_rates_quad does: its isothermal branch, with kHeat its
// heating branch (:401-449: per-species thick/thin heating, the Ricotti
// y1R/y2R secondary ionization and heating), with kTrack its
// track_bands output (:388-394).
//
// Bound: the 2K node exponentials of every live band (396 per cell and
// source at the bench's 33 blackbody bands and K = 6) on the special-
// function units (SFU), 16 results per SM and clock; around them ~10
// float32 operations per node (25 with heating) that issue beside.
// What held the function back was the instruction count of its band
// loop (float32 SASS of csrc/pyramid_sweep.cu's stage_kernel, K = 6,
// counted by chip_smoke.py's `sass_band_mix`): ~280 instructions per
// band isothermal, ~480 with heating, around 12 MUFU.EX2:
//   - the node loop ran over a runtime K: sighat and A loaded from
//     shared memory at runtime addresses, unrolled by the compiler only
//     partly, with a remainder;
//   - three IEEE divisions by the cell volume per band (six more with
//     heating), each ~10 instructions and a slow-path branch;
//   - both the thick and the thin node sums for every band;
//   - expf: a range reduction of float32-pipe instructions around each
//     MUFU.EX2 (two FFMA.SAT/RM and ~5 more per exponential).
// The design:
//   1. K is a template parameter: the caller dispatches on the table's
//      K (with_nodes: 6, the bench's and the default, and 8; any other
//      K runs the runtime-K instantiation), and the unrolled node loop
//      keeps one band's sighat, A (and A_heat) in registers.
//   2. 1/vol once per cell, a multiplication inside the band loop (the
//      tau-share reciprocal stays per band, with its FLT_MIN floor).
//   3. A band evaluates only the node sums its regime reads (node_sums):
//      a thick band (|dtau| above TAU_PHOTO_LIMIT) skips the sighat
//      sums, a thin one e_out as well; the heat likewise at
//      TAU_HEAT_LIMIT.  The selected sum is the plain version's, op for
//      op.
//   4. A caller may split the bands of a cell over a group of lanes
//      (lane, nlanes): each lane sums the bands b = lane, lane + nlanes,
//      ... of every type, and the caller adds the lanes' partials with
//      group_sum, a fixed xor butterfly that leaves the same bits on
//      every lane.  The 3D sweeps give a cell kCellLanes lanes; the 1D
//      march gives a shell the 32 lanes of its warp.
//   The exponential stays expf.  2^(-tau sighat log2 e) by one
//   MUFU.EX2, log2 e folded into the band rows, ran the float32 stage
//   kernel ~15% faster, but it rounds the exponent differently from the
//   plain version, and a thick band's e_in - e_out cancels when the
//   cell's dtau is small: next to a source, in the 128^3 x 8 main path's
//   state, rates moved by up to 0.7% from the plain version's, far past
//   the float32 gate (1e-4 relative above 1e-4 of the largest rate).
//   The cancellation is the reference's thick-branch formula, which the
//   plain version keeps too.
// Measured mix per band, K = 6, float32, on a thick band's path: 199
// instructions isothermal (12 MUFU.EX2, 141 float32-pipe of them 24
// expf FFMA.SAT/RM, one MUFU.RCP), 292 with heating; the shell kernel
// 197 and 289 (chip_smoke.py phase 22 on an H100 80GB HBM3).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace c2ray {

constexpr double kTauPhotoLimit = 1.0e-7;  // photo.py:TAU_PHOTO_LIMIT
constexpr double kTauHeatLimit = 1.0e-4;   // photo.py:TAU_HEAT_LIMIT
// ion_freq * hplanck of HI and HeI (c2ray_tpu/constants.py)
constexpr double kIonEnergyHI = 0.241838e15 * 13.598 * 6.6260755e-27;
constexpr double kIonEnergyHeI = 0.241838e15 * 24.587 * 6.6260755e-27;

// Lanes per cell in the pyramid and shell sweeps: a power of two that
// divides 32, chosen by measurement (csrc/pyramid_sweep.cu's note).
constexpr int kCellLanes = 2;

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

// Copy the packed band rows into shared memory (every thread of the
// block calls it).
template <typename T, bool kHeat>
__device__ __forceinline__ void load_band_rows(const T* bands, int nbt, int K,
                                               T* tab) {
  const int n = nbt * row_stride<kHeat>(K);
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += blockDim.x) tab[i] = bands[i];
  __syncthreads();
}

// The sum of v over a group of kLanes consecutive lanes of a warp
// (kLanes a power of two dividing 32) by a fixed xor butterfly: every
// lane of the group ends with the same bits (IEEE addition commutes).
template <int kLanes, typename T>
__device__ __forceinline__ T group_sum(T v) {
  if constexpr (kLanes > 1) {
    const unsigned lane = threadIdx.x & 31u;
    const unsigned mask =
        kLanes == 32 ? 0xffffffffu
                     : ((1u << (kLanes % 32)) - 1u) << (lane & ~(kLanes - 1u));
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      v += __shfl_xor_sync(mask, v, off, kLanes);
    }
  }
  return v;
}

// The block's sum of v in a fixed order (deterministic; no float
// atomics), valid in thread 0: a butterfly in each warp, then one over
// the warps' sums in warp 0.  Every thread of the block calls it; `red`
// holds kBlock / 32 values of shared memory.
template <typename T, int kBlock>
__device__ __forceinline__ T block_sum(T* red, T v) {
  v = group_sum<32>(v);
  if ((threadIdx.x & 31u) == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  T total = T(0);
  if (threadIdx.x < 32) {
    total = group_sum<32>(threadIdx.x < kBlock / 32 ? red[threadIdx.x]
                                                    : T(0));
  }
  __syncthreads();
  return total;
}

// Host side: f(std::integral_constant<int, kK>) with kK = K for the K the
// kernels unroll (6, the bench's and the default, and 8), else kK = 0,
// the runtime-K instantiation.
template <typename F>
inline auto with_nodes(int K, F&& f) {
  switch (K) {
    case 6:
      return f(std::integral_constant<int, 6>{});
    case 8:
      return f(std::integral_constant<int, 8>{});
    default:
      return f(std::integral_constant<int, 0>{});
  }
}

// Ricotti et al. 2002 secondary-ionization fits of one cell
// (quadrature.py:421-426), described here once: ricotti evaluates them
// in place, the 1D march spreads their powers over a warp's lanes
// (csrc/evolve1d.cu: spread_fits).  y[i] = y1R(x) = c (1 - x^b)^d of
// FitY1<i>, y[3 + i] = y2R(x) = c x^a (1 - x^b)^2 of FitY2<i>.
template <int i> struct FitY1;
template <> struct FitY1<0> {
  static constexpr double c = 0.3908, b = 0.4092, d = 1.7592;
};
template <> struct FitY1<1> {
  static constexpr double c = 0.0554, b = 0.4614, d = 1.6660;
};
template <> struct FitY1<2> {
  static constexpr double c = 1.0, b = 0.2663, d = 1.3163;
};
template <int i> struct FitY2;
template <> struct FitY2<0> {
  static constexpr double c = 0.6941, a = 0.2, b = 0.38;
};
template <> struct FitY2<1> {
  static constexpr double c = 0.0984, a = 0.2, b = 0.38;
};
template <> struct FitY2<2> {
  static constexpr double c = 3.9811, a = 0.4, b = 0.34;
};

template <typename F, typename T>
__device__ __forceinline__ T y1R(T x) {
  return T(F::c) * xpow(T(1) - xpow(x, T(F::b)), T(F::d));
}

template <typename F, typename T>
__device__ __forceinline__ T y2R(T x) {
  const T xeb = T(1) - xpow(x, T(F::b));
  return T(F::c) * xpow(x, T(F::a)) * xeb * xeb;
}

template <typename T>
__device__ __forceinline__ void ricotti(T x, T y[6]) {
  y[0] = y1R<FitY1<0>>(x);
  y[1] = y1R<FitY1<1>>(x);
  y[2] = y1R<FitY1<2>>(x);
  y[3] = y2R<FitY2<0>>(x);
  y[4] = y2R<FitY2<1>>(x);
  y[5] = y2R<FitY2<2>>(x);
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

// The K-node sums of one band row `rb` in one regime: g_in = sum A e_in;
// g_x = sum A (e_in - e_out) (kThick) or sum A sighat e_in (thin); with
// kHeat, h_x[sp] = sum A_heat (e_in - e_out) (kHThick) or sum A_heat
// sighat e_in.  e_out is evaluated only where a thick sum needs it.
// e^(-tau sighat) is the plain version's exp(-min(tau sighat, 80)) op for
// op: a thick band's e_in - e_out cancels, and in float32 any other
// rounding of it would move a rate near a source by up to ~1% from the
// plain version's (see csrc/pyramid_sweep.cu's note).
template <typename T, bool kHeat, bool kThick, bool kHThick, int kK>
__device__ __forceinline__ void node_sums(const T* rb, int K, T tau_in,
                                          T tau_out, T& g_in, T& g_x,
                                          T h_x[3]) {
  const T* sh = rb + 5;
  const T* A = rb + 5 + K;
  constexpr bool kOut = kThick || (kHeat && kHThick);
#pragma unroll
  for (int k = 0; k < (kK > 0 ? kK : K); ++k) {
    const T e_in = xexp(-minp(tau_in * sh[k], T(80)));
    T e_d = T(0);
    if constexpr (kOut) e_d = e_in - xexp(-minp(tau_out * sh[k], T(80)));
    g_in += A[k] * e_in;
    if constexpr (kThick) {
      g_x += A[k] * e_d;
    } else {
      g_x += A[k] * sh[k] * e_in;
    }
    if constexpr (kHeat) {
      for (int sp = 0; sp < 3; ++sp) {
        const T Ah = rb[5 + (2 + sp) * K + k];
        if constexpr (kHThick) {
          h_x[sp] += Ah * e_d;
        } else {
          h_x[sp] += Ah * sh[k] * e_in;
        }
      }
    }
  }
}

// One band row's terms of _one_source_quad, added to a lane's sums:
// acc the photo_cell_{HI,HeI,HeII}, photo_in and photo_out sums, with
// kHeat hacc the heat (compensated, hcomp) and the f_ion_HI / f_ion_HeI
// sums (quadrature.py:437-439); nfl the type's flux, nv = nfl / vol.
// Returns the band's photo_out (kTrack's staging).  The row holds K
// nodes (kK, or 0: K at run time).
template <typename T, bool kHeat, int kK>
__device__ __forceinline__ T band_terms(const T* rb, int K, T nfl, T nv,
                                        T inv_vol, const T* cin,
                                        const T* cout, const T* y, T acc[5],
                                        T hacc[3], T& hcomp) {
  const T tiny = Limits<T>::tiny();
  const T sHI = rb[0], sHeI = rb[1], sHeII = rb[2];
  const T mHeI = rb[3], mHeII = rb[4];
  const T tau_in = cin[0] * sHI + cin[1] * sHeI + cin[2] * sHeII;
  const T tau_out = cout[0] * sHI + cout[1] * sHeI + cout[2] * sHeII;
  const T tcHI = sHI * (cout[0] - cin[0]);
  const T tcHeI = sHeI * (cout[1] - cin[1]);
  const T tcHeII = sHeII * (cout[2] - cin[2]);
  const T inv = T(1) / maxp(tcHI + tcHeI + tcHeII, tiny);
  // the node sums this band's regime reads: the photo rates thick
  // (e_in - e_out) or thin (sighat e_in) at kTauPhotoLimit, the heat at
  // kTauHeatLimit (thick heat implies thick photo rates)
  const T dtau = tau_out - tau_in;
  const bool thick = xabs(dtau) > T(kTauPhotoLimit);
  const bool hthick = kHeat && xabs(dtau) > T(kTauHeatLimit);
  T g_in = T(0), g_x = T(0), h_x[3] = {T(0), T(0), T(0)};
  if (!thick) {
    node_sums<T, kHeat, false, false, kK>(rb, K, tau_in, tau_out, g_in, g_x,
                                          h_x);
  } else if (!kHeat || hthick) {
    node_sums<T, kHeat, true, true, kK>(rb, K, tau_in, tau_out, g_in, g_x,
                                        h_x);
  } else {
    node_sums<T, kHeat, true, false, kK>(rb, K, tau_in, tau_out, g_in, g_x,
                                         h_x);
  }
  const T phi_in = nfl * g_in;
  const T phi_all = thick ? nfl * g_x : nfl * dtau * g_x;
  const T pv = phi_all * inv_vol;
  acc[0] += tcHI * inv * pv;
  acc[1] += mHeI * (tcHeI * inv) * pv;
  acc[2] += mHeII * (tcHeII * inv) * pv;
  acc[3] += phi_in;
  acc[4] += phi_in - phi_all;
  if constexpr (kHeat) {
    // species_heat (quadrature.py:404-415): thick/thin at the heat
    // limit, masked like the photo rates
    const T tc[3] = {tcHI, tcHeI, tcHeII};
    const T mk[3] = {T(1), mHeI, mHeII};
    T ph[3];
    for (int sp = 0; sp < 3; ++sp) {
      ph[sp] = mk[sp] * (hthick ? tc[sp] * inv * h_x[sp] * nv
                                : tc[sp] * h_x[sp] * nv);
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
  return phi_in - phi_all;
}

// _one_source_quad summed over the source types (photoion_rates_quad):
// out = photo_cell_{HI,HeI,HeII}, photo_in, photo_out and, with kHeat,
// heat; `y` holds the cell's ricotti() values (heating only); `tab` the
// band rows as load_band_rows leaves them.  kK is the table's K, or 0
// for a K known at run time only (d.K).  A caller that splits the bands
// over lanes passes its lane and the lane count: each lane then sums the
// bands b = lane, lane + nlanes, ... of every type, and the caller adds
// the lanes' partial sums (group_sum).  With kTrack and a non-null
// bstage each of this lane's bands adds its photo_out to
// bstage[band * kStageStride], band in the full band axis.
template <typename T, bool kHeat, bool kTrack, int kK, int kStageStride = 1>
__device__ __forceinline__ void cell_rates(const T* tab, const BandTables& d,
                                           const T* nfl3, const T* cin,
                                           const T* cout, T vol, const T* y,
                                           T out[kHeat ? 6 : 5], T* bstage,
                                           int lane = 0, int nlanes = 1) {
  constexpr int kOut = kHeat ? 6 : 5;
  const int K = kK > 0 ? kK : d.K;
  const int stride = row_stride<kHeat>(K);
  const T inv_vol = T(1) / vol;
  for (int q = 0; q < kOut; ++q) out[q] = T(0);
  int b0 = 0;
  for (int t = 0; t < d.ntypes; ++t) {
    const T nfl = nfl3[d.type_col[t]];
    const T nv = nfl * inv_vol;
    T acc[5] = {T(0), T(0), T(0), T(0), T(0)};
    // heat (compensated), f_ion_HI, f_ion_HeI (quadrature.py:437-439)
    T hacc[3] = {T(0), T(0), T(0)}, hcomp = T(0);
    for (int b = lane; b < d.type_nb[t]; b += nlanes) {
      const T phi_out = band_terms<T, kHeat, kK>(
          tab + (b0 + b) * stride, K, nfl, nv, inv_vol, cin, cout, y, acc,
          hacc, hcomp);
      if constexpr (kTrack) {
        if (bstage) bstage[(d.type_lo[t] + b) * kStageStride] += phi_out;
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

// ---- "auto" tables: node groups
//
// quadrature.py:photoion_rates_quad sums _one_source_quad over the
// blocks of each source type (n_nodes="auto": 1 band at K = 12, 26 at
// K = 3 and 6 at K = 6 for the bench's 5e4 K blackbody, 126 exponential
// terms a cell against 198 of the fixed 6-node rule).  The sweep kernels
// take them as node groups (quadrature.py:packed_node_groups): each band
// cut into rows of at most 6 of its nodes (the K = 12 band into two), the
// rows of one source type and K in a group, the groups by descending K
// (the bench: 8 rows at K = 6, 26 at K = 3).  block_rates runs one band
// loop over all rows, band_terms on each: the rows are dealt to the
// lanes of a cell in turn, continuing from one group into the next, so
// the lanes' node terms differ by at most the largest K (63 and 63 at
// two lanes; one block at a time dealt 69 and 57); every lane of a warp
// is in the same group at the same turn, so the switch on K does not
// diverge; only the Ks that rows of at most 6 nodes take in practice (3
// and 6) are unrolled, any other runs at run time.  The lanes' sums and
// the groups' follow that order, not the plain version's per-block sums
// (the same terms; float64 within 1e-12 of it).
//
// A group: (nflux column, unused, rows, K, first row), the ints of
// packed_band_blocks' blocks; at most kMaxBlocks.
constexpr int kMaxBlocks = 24;

struct BandBlocks {
  int n;
  int col[kMaxBlocks], lo[kMaxBlocks], nb[kMaxBlocks], K[kMaxBlocks],
      row0[kMaxBlocks];
};

template <typename T, bool kHeat>
__device__ __forceinline__ void block_rates(const T* tab, const BandBlocks& bl,
                                            const T* nfl3, const T* cin,
                                            const T* cout, T vol, const T* y,
                                            T out[kHeat ? 6 : 5], int lane,
                                            int nlanes) {
  const T inv_vol = T(1) / vol;
  T acc[5] = {T(0), T(0), T(0), T(0), T(0)};
  T hacc[3] = {T(0), T(0), T(0)}, hcomp = T(0);
  int first = 0;   // the lane dealt the group's first row
  for (int g = 0; g < bl.n; ++g) {
    const int K = bl.K[g], n = bl.nb[g];
    const T nfl = nfl3[bl.col[g]];
    const T nv = nfl * inv_vol;
    const int e0 = (lane - first + nlanes) % nlanes;
    const T* rows = tab + bl.row0[g];
    // this lane's rows of the group, at its K
    auto group = [&](auto kk) {
      constexpr int kRowK = decltype(kk)::value;
      const int stride = row_stride<kHeat>(K);
      for (int e = e0; e < n; e += nlanes) {
        band_terms<T, kHeat, kRowK>(rows + e * stride, K, nfl, nv, inv_vol,
                                    cin, cout, y, acc, hacc, hcomp);
      }
    };
    switch (K) {
      case 3:
        group(std::integral_constant<int, 3>{});
        break;
      case 6:
        group(std::integral_constant<int, 6>{});
        break;
      default:
        group(std::integral_constant<int, 0>{});
    }
    first = (first + n) % nlanes;
  }
  for (int q = 0; q < 5; ++q) out[q] = acc[q];
  if constexpr (kHeat) {
    out[0] += hacc[1] / T(kIonEnergyHI);
    out[1] += hacc[2] / T(kIonEnergyHeI);
    out[5] = hacc[0];
  }
}

// ---- The split form of cell_rates for the 1D march (csrc/evolve1d.cu)
//
// The 1D march evaluates one shell's rates up to max_iter times against
// the same incoming columns.  What depends on them alone -- a band's
// tau_in, its K node exponentials e_in, the thin node sum and with
// heating the three thin heat sums -- is the shell's incoming side:
// band_in computes it once per shell into shared memory.  band_out then
// does per iteration what depends on the outgoing columns: tau_out, the
// tau shares, the regime tests (which may flip between iterations) and
// a thick band's e_out.  Every sum, regime test and expression is
// node_sums' and cell_rates', op for op, with every flux 1 (the 1D
// kernel's) and each division div_flat's (common.cuh: the same bits
// without a branch); only photo_cell_{HI,HeI,HeII} and the heat are
// formed, the values the march reads.  The 3D kernels keep cell_rates.

// Values per band of the incoming side, each an array over the nbt
// packed bands (band-fastest, so consecutive lanes read consecutive
// words): tau_in, the thin photo sum, with heating the three thin heat
// sums, then e_in(K).
template <bool kHeat>
__host__ __device__ __forceinline__ int in_values(int K) {
  return (kHeat ? 5 : 2) + K;
}

template <typename T, bool kHeat, int kK>
__device__ __forceinline__ void band_in(const T* tab, const BandTables& d,
                                        const T* cin, T* in, int lane,
                                        int nlanes) {
  const int K = kK > 0 ? kK : d.K;
  const int stride = row_stride<kHeat>(K);
  const int nbt = d.type_nb[0] + d.type_nb[1] + d.type_nb[2];
  const int e0 = kHeat ? 5 : 2;
  int b0 = 0;
  for (int t = 0; t < d.ntypes; ++t) {
    for (int b = b0 + lane; b < b0 + d.type_nb[t]; b += nlanes) {
      const T* rb = tab + b * stride;
      const T* sh = rb + 5;
      const T* A = rb + 5 + K;
      const T tau_in = cin[0] * rb[0] + cin[1] * rb[1] + cin[2] * rb[2];
      T g_x = T(0), h_x[3] = {T(0), T(0), T(0)};
#pragma unroll
      for (int k = 0; k < (kK > 0 ? kK : K); ++k) {
        const T e_in = xexp(-minp(tau_in * sh[k], T(80)));
        in[(e0 + k) * nbt + b] = e_in;
        g_x += A[k] * sh[k] * e_in;
        if constexpr (kHeat) {
          for (int sp = 0; sp < 3; ++sp) {
            h_x[sp] += rb[5 + (2 + sp) * K + k] * sh[k] * e_in;
          }
        }
      }
      in[b] = tau_in;
      in[nbt + b] = g_x;
      if constexpr (kHeat) {
        for (int sp = 0; sp < 3; ++sp) in[(2 + sp) * nbt + b] = h_x[sp];
      }
    }
    b0 += d.type_nb[t];
  }
}

// out = photo_cell_{HI,HeI,HeII} and the heat of this lane's bands from
// the incoming side `in` (band_in's, for the same cin) and the outgoing
// columns; y holds ricotti()'s values (heating only).
template <typename T, bool kHeat, int kK>
__device__ __forceinline__ void band_out(const T* tab, const BandTables& d,
                                         const T* cin, const T* cout,
                                         T inv_vol, const T* y, const T* in,
                                         T out[4], int lane, int nlanes) {
  const int K = kK > 0 ? kK : d.K;
  const int stride = row_stride<kHeat>(K);
  const int nbt = d.type_nb[0] + d.type_nb[1] + d.type_nb[2];
  const int e0 = kHeat ? 5 : 2;
  const T tiny = Limits<T>::tiny();
  for (int q = 0; q < 4; ++q) out[q] = T(0);
  int b0 = 0;
  for (int t = 0; t < d.ntypes; ++t) {
    T acc[3] = {T(0), T(0), T(0)};
    // heat (compensated), f_ion_HI, f_ion_HeI (quadrature.py:437-439)
    T hacc[3] = {T(0), T(0), T(0)}, hcomp = T(0);
    for (int b = b0 + lane; b < b0 + d.type_nb[t]; b += nlanes) {
      const T* rb = tab + b * stride;
      const T sHI = rb[0], sHeI = rb[1], sHeII = rb[2];
      const T mHeI = rb[3], mHeII = rb[4];
      const T* sh = rb + 5;
      const T* A = rb + 5 + K;
      const T tau_in = in[b];
      const T tau_out = cout[0] * sHI + cout[1] * sHeI + cout[2] * sHeII;
      const T tcHI = sHI * (cout[0] - cin[0]);
      const T tcHeI = sHeI * (cout[1] - cin[1]);
      const T tcHeII = sHeII * (cout[2] - cin[2]);
      const T inv = div_flat(T(1), maxp(tcHI + tcHeI + tcHeII, tiny));
      const T dtau = tau_out - tau_in;
      const bool thick = xabs(dtau) > T(kTauPhotoLimit);
      const bool hthick = kHeat && xabs(dtau) > T(kTauHeatLimit);
      // a thin band reads the shell's thin sums; a thick one sums
      // A (e_in - e_out), and with heating A_heat (e_in - e_out) (read
      // only if the heat is thick too)
      T g_x = in[nbt + b], h_x[3] = {T(0), T(0), T(0)};
      if (thick) {
        g_x = T(0);
#pragma unroll
        for (int k = 0; k < (kK > 0 ? kK : K); ++k) {
          const T e_d = in[(e0 + k) * nbt + b] -
                        xexp(-minp(tau_out * sh[k], T(80)));
          g_x += A[k] * e_d;
          if constexpr (kHeat) {
            for (int sp = 0; sp < 3; ++sp) {
              h_x[sp] += rb[5 + (2 + sp) * K + k] * e_d;
            }
          }
        }
      }
      const T phi_all = thick ? g_x : dtau * g_x;
      const T pv = phi_all * inv_vol;
      acc[0] += tcHI * inv * pv;
      acc[1] += mHeI * (tcHeI * inv) * pv;
      acc[2] += mHeII * (tcHeII * inv) * pv;
      if constexpr (kHeat) {
        const T tc[3] = {tcHI, tcHeI, tcHeII};
        const T mk[3] = {T(1), mHeI, mHeII};
        T ph[3];
        for (int sp = 0; sp < 3; ++sp) {
          ph[sp] = mk[sp] * (hthick ? tc[sp] * inv * h_x[sp] * inv_vol
                                    : tc[sp] * in[(2 + sp) * nbt + b] *
                                          inv_vol);
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
      out[0] += acc[0] + div_flat(hacc[1], T(kIonEnergyHI));
      out[1] += acc[1] + div_flat(hacc[2], T(kIonEnergyHeI));
      out[2] += acc[2];
      out[3] += hacc[0];
    } else {
      for (int q = 0; q < 3; ++q) out[q] += acc[q];
    }
    b0 += d.type_nb[t];
  }
}

// ---- "auto" tables in the 1D march: rows dealt to the warp's lanes
//
// The march takes the blocks of "auto" tables (quadrature.py:
// packed_band_blocks: K = 12, 3, 4, 3, 5, 8, 8 for test 1's 1e5 K
// blackbody, 36 bands, 156 nodes) as rows of kRowNodes nodes
// (onedim/evolve.py:_row_deal): every live band of every block cut into
// rows, the last row of a band padded with nodes of weight 0 (sighat
// and A 0: e_in - e_out and A sighat e_in are 0, so the sums gain exact
// zeros).  A row keeps its band's sigmas, masks and f-factors, and a
// band's rates are linear in its node sums (the thin branch dtau x the
// row's thin sum), so its rows add up to it.  Row j lies in slot j / 32
// of lane j % 32; zero rows fill the last slot (their terms are exact
// zeros; the heat's Kahan sum still applies its carry).  Shared memory
// holds the rows slot-major, value-major, lane-fastest: value v of slot
// s, lane l at (s * kRowValues + v) * 32 + l, so every read is
// conflict-free at an immediate offset; the incoming side likewise,
// in_values(kRowNodes) values a row.
//
// Design, from the split of the block-by-block route it replaces
// (tools/profile_torch_iteration.py --oned --auto; PERF.md section 6):
// seven block passes, each on 1-16 of the 32 lanes at ~460
// cycles before its nodes and ~32 a node, were 57% of an iteration.
// Here one pass deals every row: test 1's 59 rows fill 2 slots, 6
// exponentials a lane (the fixed 6-node rule's 36 bands: 2 rounds of 6).
// A row computes both regimes' node sums and selects, where band_out
// branches (a warp holds thick and thin rows alike); each lane forms its
// outputs once.  Every sum, regime test and expression of a row is
// band_out's (band_in's) op for op on its nodes.  Measured and not
// taken (--oned --auto --variants): two slots a turn in one body, for
// their chains to interleave (no faster), rows of 4 or 6 nodes (2-7%
// slower an iteration).
constexpr int kRowNodes = 3;
constexpr int kRowLanes = 32;

// values of a row (row_stride) and of its incoming side (in_values)
template <bool kHeat>
constexpr int kRowValues = kHeat ? 17 + 5 * kRowNodes : 5 + 2 * kRowNodes;
template <bool kHeat>
constexpr int kRowInValues = (kHeat ? 5 : 2) + kRowNodes;

// One row's incoming side: `rb` its first value, `ri` its first
// incoming value (both at this lane); band_in on the row's nodes.
template <typename T, bool kHeat>
__device__ __forceinline__ void row_in(const T* rb, const T* cin, T* ri) {
  constexpr int W = kRowLanes, M = kRowNodes, e0 = kHeat ? 5 : 2;
  const T tau_in = cin[0] * rb[0] + cin[1] * rb[W] + cin[2] * rb[2 * W];
  T g_x = T(0), h_x[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const T sh = rb[(5 + k) * W];
    const T e_in = xexp(-minp(tau_in * sh, T(80)));
    ri[(e0 + k) * W] = e_in;
    g_x += rb[(5 + M + k) * W] * sh * e_in;
    if constexpr (kHeat) {
      for (int sp = 0; sp < 3; ++sp) {
        h_x[sp] += rb[(5 + (2 + sp) * M + k) * W] * sh * e_in;
      }
    }
  }
  ri[0] = tau_in;
  ri[W] = g_x;
  if constexpr (kHeat) {
    for (int sp = 0; sp < 3; ++sp) ri[(2 + sp) * W] = h_x[sp];
  }
}

// One row's terms of band_out, added to this lane's sums: acc the
// photo_cell_{HI,HeI,HeII} sums, with kHeat hacc the heat (compensated,
// hcomp) and the f_ion_HI / f_ion_HeI sums.
template <typename T, bool kHeat>
__device__ __forceinline__ void row_out(const T* rb, const T* ri,
                                        const T* cin, const T* cout,
                                        T inv_vol, const T* y, T acc[3],
                                        T hacc[3], T& hcomp) {
  constexpr int W = kRowLanes, M = kRowNodes, e0 = kHeat ? 5 : 2;
  const T tiny = Limits<T>::tiny();
  const T sHI = rb[0], sHeI = rb[W], sHeII = rb[2 * W];
  const T mHeI = rb[3 * W], mHeII = rb[4 * W];
  const T tau_in = ri[0];
  const T tau_out = cout[0] * sHI + cout[1] * sHeI + cout[2] * sHeII;
  const T tcHI = sHI * (cout[0] - cin[0]);
  const T tcHeI = sHeI * (cout[1] - cin[1]);
  const T tcHeII = sHeII * (cout[2] - cin[2]);
  const T inv = div_flat(T(1), maxp(tcHI + tcHeI + tcHeII, tiny));
  const T dtau = tau_out - tau_in;
  const bool thick = xabs(dtau) > T(kTauPhotoLimit);
  const bool hthick = kHeat && xabs(dtau) > T(kTauHeatLimit);
  // the thick sums A (e_in - e_out) (A_heat (e_in - e_out)) on every
  // row; a thin row takes its incoming thin sums
  T g_d = T(0), h_d[3] = {T(0), T(0), T(0)};
#pragma unroll
  for (int k = 0; k < M; ++k) {
    const T e_d = ri[(e0 + k) * W] -
                  xexp(-minp(tau_out * rb[(5 + k) * W], T(80)));
    g_d += rb[(5 + M + k) * W] * e_d;
    if constexpr (kHeat) {
      for (int sp = 0; sp < 3; ++sp) {
        h_d[sp] += rb[(5 + (2 + sp) * M + k) * W] * e_d;
      }
    }
  }
  const T g_x = thick ? g_d : ri[W];
  const T phi_all = thick ? g_x : dtau * g_x;
  const T pv = phi_all * inv_vol;
  acc[0] += tcHI * inv * pv;
  acc[1] += mHeI * (tcHeI * inv) * pv;
  acc[2] += mHeII * (tcHeII * inv) * pv;
  if constexpr (kHeat) {
    const T tc[3] = {tcHI, tcHeI, tcHeII};
    const T mk[3] = {T(1), mHeI, mHeII};
    T ph[3];
    for (int sp = 0; sp < 3; ++sp) {
      ph[sp] = mk[sp] * (hthick ? tc[sp] * inv * h_d[sp] * inv_vol
                                : tc[sp] * ri[(2 + sp) * W] * inv_vol);
    }
    const T* f = rb + (5 + 5 * M) * W;
    const T fra1 = f[0] * ph[0] + f[W] * ph[1] + f[2 * W] * ph[2];
    const T fra2 = f[3 * W] * ph[0] + f[4 * W] * ph[1] + f[5 * W] * ph[2];
    const T fra3 = f[6 * W] * ph[0] + f[7 * W] * ph[1] + f[8 * W] * ph[2];
    const T fra4 = f[9 * W] * ph[0] + f[10 * W] * ph[1] + f[11 * W] * ph[2];
    kahan_add(hacc[0], hcomp,
              ph[0] + ph[1] + ph[2] - y[2] * fra3 + y[5] * fra4);
    hacc[1] += y[0] * fra1 - y[3] * fra2;
    hacc[2] += y[1] * fra1 - y[4] * fra2;
  }
}

// The incoming side of every row (once per shell)
template <typename T, bool kHeat>
__device__ __forceinline__ void rows_in(const T* tab, int slots,
                                        const T* cin, T* in, int lane) {
  constexpr int R = kRowValues<kHeat> * kRowLanes;
  constexpr int I = kRowInValues<kHeat> * kRowLanes;
#pragma unroll 1
  for (int s = 0; s < slots; ++s) {
    row_in<T, kHeat>(tab + s * R + lane, cin, in + s * I + lane);
  }
}

// out = photo_cell_{HI,HeI,HeII} and the heat of this lane's rows from
// the incoming side `in` (rows_in's, for the same cin) and the outgoing
// columns; y holds ricotti()'s values (heating only).
template <typename T, bool kHeat>
__device__ __forceinline__ void rows_out(const T* tab, int slots,
                                         const T* cin, const T* cout,
                                         T inv_vol, const T* y, const T* in,
                                         T out[4], int lane) {
  constexpr int R = kRowValues<kHeat> * kRowLanes;
  constexpr int I = kRowInValues<kHeat> * kRowLanes;
  T acc[3] = {T(0), T(0), T(0)};
  T hacc[3] = {T(0), T(0), T(0)}, hcomp = T(0);
#pragma unroll 1
  for (int s = 0; s < slots; ++s) {
    row_out<T, kHeat>(tab + s * R + lane, in + s * I + lane, cin, cout,
                      inv_vol, y, acc, hacc, hcomp);
  }
  if constexpr (kHeat) {
    out[0] = acc[0] + div_flat(hacc[1], T(kIonEnergyHI));
    out[1] = acc[1] + div_flat(hacc[2], T(kIonEnergyHeI));
    out[2] = acc[2];
    out[3] = hacc[0];
  } else {
    for (int q = 0; q < 3; ++q) out[q] = acc[q];
    out[3] = T(0);
  }
}

}  // namespace c2ray
