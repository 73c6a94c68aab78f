// The tau-table rate route and the route switch of the sweep kernels.
//
// The tau-table route replaces c2ray_tpu/radiation/photo.py:
// _table_positions (:65), _read (:78), _photo_lookup (:90), _heat_lookup
// (:123) and photoion_rates (:185): per cell, band and source type the
// position of tau_in and tau_out on the 2001-point log-tau grid, linear
// reads of the thick and thin photo tables (and with heating of the
// heat tables), the rate as the difference of the two reads, the thin
// branch below TAU_PHOTO_LIMIT / TAU_HEAT_LIMIT.  table_in / table_out
// are the 1D march's split of it (csrc/evolve1d.cu: once per shell, once
// per iteration); table_rates is the whole of it for one cell of a 3D
// sweep (csrc/pyramid_sweep.cu, and through csrc/short_char.cuh the
// shell and octant sweeps).
//
// Bound: per band and source type, two (thin: one) position
// computations (a log10 each) and two to four table reads, against the
// quadrature's 2K exponentials.  The tables stay in device memory, read
// through the read-only cache (a blackbody's float32 photo records are
// 33 x 2001 x 16 B = 1.06 MB, its heat records 3.2 MB, in the 50 MB
// L2).  Only the 17-value band rows go to shared memory.  A cell's lanes
// (kCellLanes in the pyramid and shell sweeps, the plane's lanes in the
// octant sweep, the warp in the 1D march) split the bands.
//
// The 3D design, from the split of the first one (PERF.md section 6;
// tools/profile_torch_iteration.py --route tau: knock-out copies, 128^3
// x 8 float32 on an H100): its reads took 13% / 29% of the stage kernel
// (isothermal / heating), the positions 18% / nothing (hidden behind
// the reads), the rest -- four IEEE divisions a band and type, seven
// with heating -- two thirds / half; sending every read of a band to one
// row saved nothing with heating, so the reads cost instructions, not
// locality.  So table_rates reads band-major records (TauRec: one
// 16-byte load per position and type instead of two to four word
// gathers and the heating columns' index loads) and takes 1/vol once
// per cell; the positions stay the plain version's log10, op for op
// (rtol 1e-12 in float64, a decided deviation that ROADMAP.md records:
// log10 rounds differently on the card); two lanes a cell, against one
// (14% slower) and four (8% slower).  The 1D march keeps table_in /
// table_out on the unpacked tables (csrc/evolve1d.cu's design).
//
// The route switch: the 3D sweep kernels take their rate route in the
// template parameter kK.  kK >= 0 is the quadrature rule's node count (0:
// known at run time), kTableRoute the tau tables, kBlockRoute the
// "auto" quadrature blocks (band_rates.cuh: block_rates).  The routes'
// tables (RouteTables) travel by value as the last member of each
// kernel's Params, read from the parameter bank like the rest; the
// fixed rule never reads them.
#pragma once

#include "band_rates.cuh"

namespace c2ray {

// radiation/tables.py: tau rows 0..kNumTau at log10 tau = minlogtau +
// dlogtau * (row - 1)
constexpr int kNumTau = 2000;
constexpr double kMinLogTau = -20.0;
constexpr double kDLogTau = (4.0 - (-20.0)) / 2000;
// table route band rows: [sig_HI, sig_HeI, sig_HeII, mask_HeI, mask_HeII,
// the 12 f-factors in radiation/bands.py:F_FACTORS order]
// (radiation/tables.py:packed_table_route)
constexpr int kTableRow = 17;

constexpr int kTableRoute = -1;
constexpr int kBlockRoute = -2;

// The tau route with heating runs as a capped pyramid or octant kernel
// (stage_kernel_capped, plane_kernel_capped, the same body): held to
// kCappedBlocks resident blocks of 256 threads an SM (__launch_bounds__)
// ptxas keeps it to 80 registers, where uncapped it took 100 and held
// two: 8% faster on the pyramid engine, 10% on the octant one
// (tools/profile_torch_iteration.py --route tau --variants uncapped;
// PERF.md section 6).  Every other instantiation keeps the plain
// __launch_bounds__(kBlock) (a minimum of one block moved the isothermal
// tau kernel to 80 registers, 8% slower).  The shell kernel stays whole:
// its body moved into a function for a capped twin slowed its fixed rule
// by 1.2-1.4%.
constexpr int kCappedBlocks = 3;

template <bool kHeat, int kK>
__host__ __device__ constexpr bool route_capped() {
  return kHeat && kK == kTableRoute;
}

// The tau tables of the source types in use as the 3D sweeps read them
// (radiation/tables.py:PackedTauTables): band-major, for each type and
// live band a column over the kNumTau + 1 rows of 4-value records
// (TauRec).  bt.ntypes types, bt.type_col[t] their nflux columns.
template <typename T>
struct TauTables {
  const T* photo;       // (ntypes, b1 - b0, kNumTau + 1, 4)
  const T* heat;        // heating: (ntypes, b1 - b0, 3, kNumTau + 1, 4)
  BandTables bt;
  int b0, b1;           // the bands [b0, b1) of any type's nonzero table
                        // columns
};

// What a 3D sweep needs besides the fixed rule's BandTables: the band
// blocks of "auto" tables or the tau tables, and the values of the band
// rows in shared memory on those routes (a kernel's Params::rt, through
// route_of).
template <typename T>
struct RouteTables {
  BandBlocks blocks;
  TauTables<T> tau;
  int tab_len;
};

template <typename T>
struct Pos {
  int i, i1;
  T r;
};

// photo.py:_table_positions: the truncated row, the next one capped at
// kNumTau, and the residual
template <typename T>
__device__ __forceinline__ Pos<T> table_position(T tau) {
  const T logtau = xlog10(maxp(tau, T(1.0e-20)));
  const T od = minp(maxp(T(1) + div_flat(logtau - T(kMinLogTau), T(kDLogTau)),
                         T(0)), T(kNumTau));
  Pos<T> p;
  p.i = int(od);
  p.r = od - T(p.i);
  p.i1 = min(kNumTau, p.i + 1);
  return p;
}

// photo.py:_read of one column
template <typename T>
__device__ __forceinline__ T table_read(const T* tab, int ncols, int col,
                                        const Pos<T>& p) {
  const T lo = __ldg(tab + size_t(p.i) * ncols + col);
  const T hi = __ldg(tab + size_t(p.i1) * ncols + col);
  return lo + (hi - lo) * p.r;
}

// ---- The 1D march's split (csrc/evolve1d.cu), every flux 1
//
// The table route's incoming side (see band_in in band_rates.cuh): per
// band, arrays over the nb bands, tau_in and per source type the reads
// at its table position -- the thick and thin photo reads and with
// heating the thick and thin heat reads of the three species.
template <bool kHeat>
__host__ __device__ __forceinline__ int table_in_values(int ntypes) {
  return 1 + ntypes * (kHeat ? 8 : 2);
}

template <typename T, bool kHeat, int kLanes, typename A>
__device__ __forceinline__ void table_in(const A& a, const T* rows,
                                         const T* cin, T* in, int lane) {
  const size_t ptab = size_t(kNumTau + 1) * a.nb;
  const size_t htab = size_t(kNumTau + 1) * a.nheat;
  const int nb = a.nb;
  for (int b = lane; b < nb; b += kLanes) {
    const T* rb = rows + b * kTableRow;
    const T tau_in = cin[0] * rb[0] + cin[1] * rb[1] + cin[2] * rb[2];
    const Pos<T> pin = table_position(tau_in);
    in[b] = tau_in;
    T* v = in + nb;
    for (int t = 0; t < a.bt.ntypes; ++t) {
      const T* tk = a.photo_tab + 2 * t * ptab;
      v[0 * nb + b] = table_read(tk, nb, b, pin);
      v[1 * nb + b] = table_read(tk + ptab, nb, b, pin);
      if constexpr (kHeat) {
        const T* hk = a.heat_tab + 2 * t * htab;
        for (int sp = 0; sp < 3; ++sp) {
          const int col = a.hbin[3 * b + sp];
          v[(2 + sp) * nb + b] = table_read(hk, a.nheat, col, pin);
          v[(5 + sp) * nb + b] = table_read(hk + htab, a.nheat, col, pin);
        }
      }
      v += (kHeat ? 8 : 2) * nb;
    }
  }
}

// photo.py:photoion_rates with every flux 1, this lane's bands (their
// rows `rows`), from the incoming side `in` (table_in's, for the same
// cin): r =
// photo_cell_{HI,HeI,HeII} and the heat.  A thin band reads no table: its
// rates are dtau times the shell's thin reads; a thick band reads its
// table at tau_out (the heat tables only where the heat is thick too).
template <typename T, bool kHeat, int kLanes, typename A>
__device__ __forceinline__ void table_out(const A& a, const T* rows,
                                          const T* cin, const T* cout, T vol,
                                          const T* y, const T* in, T r[4],
                                          int lane) {
  const T tiny = Limits<T>::tiny();
  const size_t ptab = size_t(kNumTau + 1) * a.nb;
  const size_t htab = size_t(kNumTau + 1) * a.nheat;
  const int nb = a.nb;
  T p[3] = {T(0), T(0), T(0)};
  // heat (compensated), f_ion_HI, f_ion_HeI (photo.py:_heat_lookup)
  T heat = T(0), hcomp = T(0), fion[2] = {T(0), T(0)};
  for (int b = lane; b < nb; b += kLanes) {
    const T* rb = rows + b * kTableRow;
    const T sHI = rb[0], sHeI = rb[1], sHeII = rb[2];
    const T mHeI = rb[3], mHeII = rb[4];
    const T tau_in = in[b];
    const T tau_out = cout[0] * sHI + cout[1] * sHeI + cout[2] * sHeII;
    // the tau-weighted species split (scale_int2/3)
    const T tc[3] = {sHI * (cout[0] - cin[0]), sHeI * (cout[1] - cin[1]),
                     sHeII * (cout[2] - cin[2])};
    const T inv = div_flat(T(1), maxp(tc[0] + tc[1] + tc[2], tiny));
    const T sc[3] = {tc[0] * inv, tc[1] * inv, tc[2] * inv};
    const T dtau = tau_out - tau_in;
    const bool thick = xabs(dtau) > T(kTauPhotoLimit);
    const bool hthick = kHeat && xabs(dtau) > T(kTauHeatLimit);
    Pos<T> pout{0, 0, T(0)};
    if (thick) pout = table_position(tau_out);
    const T* v = in + nb;
    for (int t = 0; t < a.bt.ntypes; ++t) {
      const T* tk = a.photo_tab + 2 * t * ptab;
      const T phi_all = thick ? v[b] - table_read(tk, nb, b, pout)
                              : dtau * v[nb + b];
      p[0] += div_flat(sc[0] * phi_all, vol);
      p[1] += div_flat(mHeI * sc[1] * phi_all, vol);
      p[2] += div_flat(mHeII * sc[2] * phi_all, vol);
      if constexpr (kHeat) {
        const T mk[3] = {T(1), mHeI, mHeII};
        const T* hk = a.heat_tab + 2 * t * htab;
        const T* f = rb + 5;
        T ph[3];
        for (int sp = 0; sp < 3; ++sp) {
          const T hin = v[(2 + sp) * nb + b];
          ph[sp] = mk[sp] *
                   (hthick ? div_flat(sc[sp] * (hin - table_read(
                                                     hk, a.nheat,
                                                     a.hbin[3 * b + sp], pout)),
                                      vol)
                           : div_flat(tc[sp] * v[(5 + sp) * nb + b], vol));
        }
        const T fra1 = f[0] * ph[0] + f[1] * ph[1] + f[2] * ph[2];
        const T fra2 = f[3] * ph[0] + f[4] * ph[1] + f[5] * ph[2];
        const T fra3 = f[6] * ph[0] + f[7] * ph[1] + f[8] * ph[2];
        const T fra4 = f[9] * ph[0] + f[10] * ph[1] + f[11] * ph[2];
        kahan_add(heat, hcomp,
                  ph[0] + ph[1] + ph[2] - y[2] * fra3 + y[5] * fra4);
        fion[0] += y[0] * fra1 - y[3] * fra2;
        fion[1] += y[1] * fra1 - y[4] * fra2;
      }
      v += (kHeat ? 8 : 2) * nb;
    }
  }
  r[0] = p[0];
  r[1] = p[1];
  r[2] = p[2];
  r[3] = T(0);
  if constexpr (kHeat) {
    r[0] += div_flat(fion[0], T(kIonEnergyHI));
    r[1] += div_flat(fion[1], T(kIonEnergyHeI));
    r[3] = heat;
  }
}

// ---- One cell of a 3D sweep
//
// A record of a band-major column at row i (PackedTauTables): the thick
// table's v[i] and v[i1] - v[i], the thin table's (photo) or the heat
// tables' likewise, i1 = min(i + 1, kNumTau).  One 16-byte load in
// float32 (two in float64) gives both rows of a read and the thin (or
// thin heat) read beside it; table_read's lo + (hi - lo) r is then
// v + d r, the same bits, d being the same IEEE subtraction made when the
// tables were packed.
template <typename T>
struct TauRec {
  T v, d, tv, td;
};

__device__ __forceinline__ TauRec<float> load_rec(const float* p) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  return {q.x, q.y, q.z, q.w};
}

__device__ __forceinline__ TauRec<double> load_rec(const double* p) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  return {a.x, a.y, b.x, b.y};
}

// photo.py:_read from a record's value and difference
template <typename T>
__device__ __forceinline__ T rec_read(T v, T d, T r) {
  return v + d * r;
}

// The values of one column
constexpr size_t kTauColumn = size_t(kNumTau + 1) * 4;
//
// photo.py:photoion_rates of one cell (the types' fluxes nfl3 at their
// columns, the cell's scaled volume `vol`), over this lane's bands b =
// b0 + lane, b0 + lane + nlanes, ... below b1: the bands where some type
// has a nonzero table column (radiation/tables.py:live_band_range; the
// plain version's other bands add zeros): out =
// photo_cell_{HI,HeI,HeII}, photo_in, photo_out and, with kHeat, heat;
// `y` holds the cell's ricotti() values (heating only); `rows` the band
// rows in shared memory.  The caller adds the lanes' sums (group_sum).
template <typename T, bool kHeat>
__device__ __forceinline__ void table_rates(const T* rows,
                                            const TauTables<T>& a,
                                            const T* nfl3, const T* cin,
                                            const T* cout, T vol, const T* y,
                                            T out[kHeat ? 6 : 5], int lane,
                                            int nlanes) {
  const T tiny = Limits<T>::tiny();
  const int nl = a.b1 - a.b0;
  const T inv_vol = T(1) / vol;
  T p[5] = {T(0), T(0), T(0), T(0), T(0)};
  // heat (compensated), f_ion_HI, f_ion_HeI (photo.py:_heat_lookup)
  T heat = T(0), hcomp = T(0), fion[2] = {T(0), T(0)};
  for (int b = a.b0 + lane; b < a.b1; b += nlanes) {
    const T* rb = rows + b * kTableRow;
    const T sHI = rb[0], sHeI = rb[1], sHeII = rb[2];
    const T mHeI = rb[3], mHeII = rb[4];
    const T tau_in = cin[0] * sHI + cin[1] * sHeI + cin[2] * sHeII;
    const T tau_out = cout[0] * sHI + cout[1] * sHeI + cout[2] * sHeII;
    const T tc[3] = {sHI * (cout[0] - cin[0]), sHeI * (cout[1] - cin[1]),
                     sHeII * (cout[2] - cin[2])};
    const T inv = T(1) / maxp(tc[0] + tc[1] + tc[2], tiny);
    const T sc[3] = {tc[0] * inv, tc[1] * inv, tc[2] * inv};
    const T dtau = tau_out - tau_in;
    const bool thick = xabs(dtau) > T(kTauPhotoLimit);
    const bool hthick = kHeat && xabs(dtau) > T(kTauHeatLimit);
    const Pos<T> pin = table_position(tau_in);
    Pos<T> pout{0, 0, T(0)};
    if (thick) pout = table_position(tau_out);
    for (int t = 0; t < a.bt.ntypes; ++t) {
      const T nfl = nfl3[a.bt.type_col[t]];
      const size_t column = size_t(t) * nl + (b - a.b0);
      const T* col = a.photo + column * kTauColumn;
      const TauRec<T> ri = load_rec(col + 4 * pin.i);
      const T phi_in = nfl * rec_read(ri.v, ri.d, pin.r);
      T phi_all;
      if (thick) {
        const TauRec<T> ro = load_rec(col + 4 * pout.i);
        phi_all = phi_in - nfl * rec_read(ro.v, ro.d, pout.r);
      } else {
        phi_all = nfl * dtau * rec_read(ri.tv, ri.td, pin.r);
      }
      p[0] += sc[0] * phi_all * inv_vol;
      p[1] += mHeI * sc[1] * phi_all * inv_vol;
      p[2] += mHeII * sc[2] * phi_all * inv_vol;
      p[3] += phi_in;
      p[4] += phi_in - phi_all;
      if constexpr (kHeat) {
        const T mk[3] = {T(1), mHeI, mHeII};
        const T* hcol = a.heat + 3 * column * kTauColumn;
        const T* f = rb + 5;
        T ph[3];
        for (int sp = 0; sp < 3; ++sp) {
          const T* hc = hcol + sp * kTauColumn;
          const TauRec<T> hi = load_rec(hc + 4 * pin.i);
          if (hthick) {
            const TauRec<T> ho = load_rec(hc + 4 * pout.i);
            const T hin = nfl * rec_read(hi.v, hi.d, pin.r);
            const T hout = nfl * rec_read(ho.v, ho.d, pout.r);
            ph[sp] = mk[sp] * (sc[sp] * (hin - hout) * inv_vol);
          } else {
            ph[sp] = mk[sp] * (nfl * tc[sp] * rec_read(hi.tv, hi.td, pin.r) *
                               inv_vol);
          }
        }
        const T fra1 = f[0] * ph[0] + f[1] * ph[1] + f[2] * ph[2];
        const T fra2 = f[3] * ph[0] + f[4] * ph[1] + f[5] * ph[2];
        const T fra3 = f[6] * ph[0] + f[7] * ph[1] + f[8] * ph[2];
        const T fra4 = f[9] * ph[0] + f[10] * ph[1] + f[11] * ph[2];
        kahan_add(heat, hcomp,
                  ph[0] + ph[1] + ph[2] - y[2] * fra3 + y[5] * fra4);
        fion[0] += y[0] * fra1 - y[3] * fra2;
        fion[1] += y[1] * fra1 - y[4] * fra2;
      }
    }
  }
  for (int q = 0; q < 5; ++q) out[q] = p[q];
  if constexpr (kHeat) {
    out[0] += fion[0] / T(kIonEnergyHI);
    out[1] += fion[1] / T(kIonEnergyHeI);
    out[5] = heat;
  }
}

// The rates of one cell of a 3D sweep on the route kK names: the fixed
// rule (cell_rates at kK nodes, with kTrack the band staging), the
// "auto" blocks (block_rates) or the tau tables (table_rates; `tab`
// then holds their band rows).  rt is read on those two routes only
// (the fixed rule's callers pass null: its code is the parent's).
template <typename T, bool kHeat, bool kTrack, int kK, int kStageStride = 1>
__device__ __forceinline__ void route_rates(
    const T* tab, const BandTables& d, const RouteTables<T>* rt,
    const T* nfl3, const T* cin, const T* cout, T vol, const T* y,
    T out[kHeat ? 6 : 5], T* bstage, int lane = 0, int nlanes = 1) {
  if constexpr (kK == kTableRoute) {
    table_rates<T, kHeat>(tab, rt->tau, nfl3, cin, cout, vol, y, out, lane,
                          nlanes);
  } else if constexpr (kK == kBlockRoute) {
    block_rates<T, kHeat>(tab, rt->blocks, nfl3, cin, cout, vol, y, out,
                          lane, nlanes);
  } else {
    cell_rates<T, kHeat, kTrack, kK, kStageStride>(tab, d, nfl3, cin, cout,
                                                   vol, y, out, bstage, lane,
                                                   nlanes);
  }
}

// The values of the band rows a block loads into shared memory: the
// fixed rule's nbt rows of row_stride(K), else the route's tab_len.
template <typename T, bool kHeat, int kK>
__host__ __device__ __forceinline__ int route_tab_len(
    int nbt, const BandTables& d, const RouteTables<T>* rt) {
  if constexpr (kK < 0) {
    return rt->tab_len;
  } else {
    return nbt * row_stride<kHeat>(d.K);
  }
}

// load_band_rows on the route kK names
template <typename T, bool kHeat, int kK>
__device__ __forceinline__ void load_route_rows(const T* bands, int nbt,
                                                const BandTables& d,
                                                const RouteTables<T>* rt,
                                                T* tab) {
  if constexpr (kK < 0) {
    for (int i = threadIdx.x; i < rt->tab_len; i += blockDim.x) {
      tab[i] = bands[i];
    }
    __syncthreads();
  } else {
    load_band_rows<T, kHeat>(bands, nbt, d.K, tab);
  }
}

// The route tables of a kernel on route kK: its parameters' (Params::rt)
// on the tau-table and block routes, else null.
template <int kK, typename T>
__device__ __forceinline__ const RouteTables<T>* route_of(
    const RouteTables<T>& rt) {
  if constexpr (kK >= 0) {
    return nullptr;
  } else {
    return &rt;
  }
}

// Host side: f(std::integral_constant<int, kK>) with kK the route of a
// sweep (0 the fixed rule, whose K with_nodes then picks; kTableRoute;
// kBlockRoute) -- the instantiations a sweep source compiles.
template <typename F>
inline auto with_route(int route, int K, F&& f) {
  switch (route) {
    case kTableRoute:
      return f(std::integral_constant<int, kTableRoute>{});
    case kBlockRoute:
      return f(std::integral_constant<int, kBlockRoute>{});
    default:
      return with_nodes(K, f);
  }
}

// Host side: f(std::integral_constant<int, kK>) with kK the source-cell
// kernel's route: the sweep's route, or 0 on the fixed rule (the source
// cell reads its K at run time).
template <typename F>
inline auto with_source_route(int route, F&& f) {
  switch (route) {
    case kTableRoute:
      return f(std::integral_constant<int, kTableRoute>{});
    case kBlockRoute:
      return f(std::integral_constant<int, kBlockRoute>{});
    default:
      return f(std::integral_constant<int, 0>{});
  }
}

// Host side: the route of a launch from the host ints the wrappers pass
// (sweep/source_sweep.py:_route_args): [route, tab_len, then on the block
// route the node groups' count and per group (column, 0, rows, K, first
// row value), on
// the table route nb, nheat, ntypes, the types' columns and the live
// bands b0, b1]; and the tau tables' device pointers: photo and heat the
// columns of PackedTauTables, hbin unread (the packing resolved it).
template <typename T>
inline int parse_route(const int* ri, const T* photo, const T* heat,
                       const int* hbin, RouteTables<T>& rt) {
  rt = RouteTables<T>{};
  if (ri == nullptr) return 0;
  const int route = ri[0];
  rt.tab_len = ri[1];
  if (route == kBlockRoute) {
    rt.blocks.n = ri[2];
    for (int i = 0; i < rt.blocks.n && i < kMaxBlocks; ++i) {
      const int* b = ri + 3 + 5 * i;
      rt.blocks.col[i] = b[0];
      rt.blocks.lo[i] = b[1];
      rt.blocks.nb[i] = b[2];
      rt.blocks.K[i] = b[3];
      rt.blocks.row0[i] = b[4];
    }
  } else if (route == kTableRoute) {
    (void)hbin;
    rt.tau.photo = photo;
    rt.tau.heat = heat;
    rt.tau.bt.ntypes = ri[4];
    for (int t = 0; t < 3; ++t) rt.tau.bt.type_col[t] = ri[5 + t];
    rt.tau.b0 = ri[8];
    rt.tau.b1 = ri[9];
  }
  return route;
}

}  // namespace c2ray
