// One timestep of the 1D program: the radial march over the shells with
// each shell's fixed point, in one launch of one warp.  Variants: the
// quadrature rate route or the tau-table route (template flag kTable),
// each isothermal or with heating (template flag kHeat: the heating
// rates, the T-dependent rate fits and the thermal sub-cycle).
//
// Replaces c2ray_tpu/onedim/evolve.py: _solve_cell (:104) inside the
// radial lax.scan of make_evolve1d / evolve1d (:190-239), with
// _cell_photorates (:79) and _cell_columns (:95); on the table route
// c2ray_tpu/radiation/photo.py: _table_positions (:65), _read (:78),
// _photo_lookup (:90), _heat_lookup (:123) and photoion_rates (:185);
// on the quadrature route cell_rates (csrc/band_rates.cuh); the
// chemistry device functions of csrc/chemistry.cuh.
//
// Algorithm (the same as evolve1d_plain in onedim/evolve.py): the
// incoming column triplet starts at the boundary columns; shell i runs
// up to max_iter rounds of {rates from the incoming columns and the
// columns of its averaged fractions over dr, per-atom rates plus the UV
// background, two doric passes averaged, with heating the thermal
// sub-cycle, the 1% test on h0, he0, he1, he2 and T}; a shell whose
// incoming HI column is above kMaxColdensh1D keeps its state (its solve
// still runs and its iteration count is still reported); the outgoing
// columns add the columns of the final averaged fractions.
//
// Lanes: each of the 32 lanes takes the bands b = lane, lane + 32, ...
// of every source type (quadrature: the K exponentials of each, with
// the packed band rows in shared memory; tables: two interpolated reads
// of each table, through __ldg from global memory or L2 -- the
// (2001 x nb) tables per source type are ~0.75 MB in float32, too big
// for shared memory).  The lane partial sums (the heat a Kahan sum per
// lane) are added by a shuffle butterfly: a fixed order whose result is
// bit-identical on every lane, so every lane then runs the two doric
// passes, the thermal sub-cycle and the convergence test on the same
// values, with no broadcast and no divergence, and a result repeats to
// the last digit between calls.
//
// Bound: the 1D problem is one serial chain (shell i needs shell i-1's
// converged column), as the JAX scan is; one launch uses one SM of the
// card's 132.  Per fixed-point iteration the chain is the rate
// evaluation of a lane's bands (quadrature: 2K exponentials per band;
// tables: two log10 and dependent global reads per band), 5 shuffle
// levels, then two doric solves (each a square root, 3 exp, 3 expm1 and
// ~20 divisions in sequence) and, with heating, the sub-cycle's
// sub-steps, each a log10, two table reads and a division in sequence.
// Latency, not throughput, bounds it; nothing here tries to hide it yet.
// The quadrature route takes band_rates.cuh's band loop (K unrolled by
// with_nodes, 1/vol once per shell, only the sums a band's regime
// reads), which shortens the rate part of the chain; the march itself is
// not redesigned.

#include "band_rates.cuh"
#include "chemistry.cuh"

namespace c2ray {
namespace {

constexpr int kLanes = 32;
constexpr double kMaxColdensh1D = 2.0e26;    // onedim/evolve.py:MAX_COLDENSH_1D
// radiation/tables.py: tau rows 0..kNumTau at log10 tau = minlogtau +
// dlogtau * (row - 1)
constexpr int kNumTau = 2000;
constexpr double kMinLogTau = -20.0;
constexpr double kDLogTau = (4.0 - (-20.0)) / 2000;
// table route band rows: [sig_HI, sig_HeI, sig_HeII, mask_HeI, mask_HeII,
// the 12 f-factors in radiation/bands.py:F_FACTORS order]
constexpr int kTableRow = 17;

template <typename T>
struct Args1D {
  const T* ndens;       // (mesh)
  const T* temper;      // (mesh)
  const T* xh;          // (mesh, 2)
  const T* xhe;         // (mesh, 3)
  const T* vol;         // (mesh) shell volumes / flux_scale
  const T* bands;       // quadrature: packed rows; tables: (nb, kTableRow)
  const int* hbin;      // tables: (nb, 3) heating-table column per species
  const T* photo_tab;   // tables: (ntypes, 2, kNumTau + 1, nb) thick, thin
  const T* heat_tab;    // tables, heating: (ntypes, 2, kNumTau + 1, nheat)
  const T* cool_tab;    // heating: (801, 5)
  T* xh_out;
  T* xhe_out;
  T* temper_out;
  int* nits;            // (mesh) fixed-point iterations of each shell
  int* counters;        // summed iterations, largest; thermal sub-steps:
                        // largest of one iteration, summed
  int mesh, nbt, nb, nheat, max_iter;
  BandTables bt;        // quadrature rows; tables: ntypes only
  T dr, dt, clump, eps, one_m_eps, ccf;
  T g[3], bnd[3];
};

// onedim/evolve.py:_cell_columns (chemistry.py:coldens per species)
template <typename T>
__device__ __forceinline__ void cell_columns(T dr, const Ion<T>& x, T nd,
                                             T cc[3]) {
  cc[0] = x.h0 * nd * dr * T(1.0 - kAbuHe);
  cc[1] = x.he0 * nd * dr * T(kAbuHe);
  cc[2] = x.he1 * nd * dr * T(kAbuHe);
}

// onedim/evolve.py's convergence test (|new - old| / new)
template <typename T>
__device__ __forceinline__ bool conv1d(T nw, T old) {
  return xabs(nw - old) / nw < T(kMinFractionalChange) ||
         nw < T(kMinFractionOfAtoms);
}

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
  const T od = minp(maxp(T(1) + (logtau - T(kMinLogTau)) / T(kDLogTau),
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

// photo.py:photoion_rates with every flux 1, this lane's bands:
// r = photo_cell_{HI,HeI,HeII} and the heat
template <typename T, bool kHeat>
__device__ void table_rates(const Args1D<T>& a, const T* cin,
                            const T* cout, T vol, const T* y, T r[4],
                            int lane) {
  const T tiny = Limits<T>::tiny();
  const size_t ptab = size_t(kNumTau + 1) * a.nb;
  const size_t htab = size_t(kNumTau + 1) * a.nheat;
  T p[3] = {T(0), T(0), T(0)};
  // heat (compensated), f_ion_HI, f_ion_HeI (photo.py:_heat_lookup)
  T heat = T(0), hcomp = T(0), fion[2] = {T(0), T(0)};
  for (int b = lane; b < a.nb; b += kLanes) {
    const T* rb = a.bands + b * kTableRow;
    const T sHI = rb[0], sHeI = rb[1], sHeII = rb[2];
    const T mHeI = rb[3], mHeII = rb[4];
    const T tau_in = cin[0] * sHI + cin[1] * sHeI + cin[2] * sHeII;
    const T tau_out = cout[0] * sHI + cout[1] * sHeI + cout[2] * sHeII;
    const Pos<T> pin = table_position(tau_in);
    const Pos<T> pout = table_position(tau_out);
    // the tau-weighted species split (scale_int2/3)
    const T tc[3] = {sHI * (cout[0] - cin[0]), sHeI * (cout[1] - cin[1]),
                     sHeII * (cout[2] - cin[2])};
    const T inv = T(1) / maxp(tc[0] + tc[1] + tc[2], tiny);
    const T sc[3] = {tc[0] * inv, tc[1] * inv, tc[2] * inv};
    const T dtau = tau_out - tau_in;
    const bool thick = xabs(dtau) > T(kTauPhotoLimit);
    for (int t = 0; t < a.bt.ntypes; ++t) {
      const T* tk = a.photo_tab + 2 * t * ptab;
      const T* tn = tk + ptab;
      const T phi_in = table_read(tk, a.nb, b, pin);
      const T phi_all = thick ? phi_in - table_read(tk, a.nb, b, pout)
                              : dtau * table_read(tn, a.nb, b, pin);
      p[0] += sc[0] * phi_all / vol;
      p[1] += mHeI * sc[1] * phi_all / vol;
      p[2] += mHeII * sc[2] * phi_all / vol;
    }
    if constexpr (kHeat) {
      const bool hthick = xabs(dtau) > T(kTauHeatLimit);
      const T mk[3] = {T(1), mHeI, mHeII};
      const int* hb = a.hbin + 3 * b;
      const T* f = rb + 5;
      for (int t = 0; t < a.bt.ntypes; ++t) {
        const T* hk = a.heat_tab + 2 * t * htab;
        const T* hn = hk + htab;
        T ph[3];
        for (int sp = 0; sp < 3; ++sp) {
          const int col = hb[sp];
          const T hin = table_read(hk, a.nheat, col, pin);
          const T hout = table_read(hk, a.nheat, col, pout);
          const T thk = sc[sp] * (hin - hout) / vol;
          const T thn = tc[sp] * table_read(hn, a.nheat, col, pin) / vol;
          ph[sp] = mk[sp] * (hthick ? thk : thn);
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
  r[0] = p[0];
  r[1] = p[1];
  r[2] = p[2];
  r[3] = T(0);
  if constexpr (kHeat) {
    r[0] += fion[0] / T(kIonEnergyHI);
    r[1] += fion[1] / T(kIonEnergyHeI);
    r[3] = heat;
  }
}

// kK: the quadrature table's K (0: a.bt.K at run time; 0 on the table
// route)
template <typename T, bool kHeat, bool kTable, int kK>
__global__ void __launch_bounds__(kLanes) evolve1d_kernel(const Args1D<T> a) {
  extern __shared__ unsigned char smem[];
  T* tab = reinterpret_cast<T*>(smem);
  const int lane = threadIdx.x;
  if constexpr (!kTable) {
    load_band_rows<T, kHeat>(a.bands, a.nbt, a.bt.K, tab);
  }
  const T ones[3] = {T(1), T(1), T(1)};   // every source type's flux
  T cd[3] = {a.bnd[0], a.bnd[1], a.bnd[2]};
  int it_sum = 0, it_max = 0, sub_max = 0, sub_sum = 0;
  for (int i = 0; i < a.mesh; ++i) {
    const T nd = a.ndens[i], vol = a.vol[i], t0 = a.temper[i];
    const Ion<T> f0{a.xh[2 * i], a.xh[2 * i + 1], a.xhe[3 * i],
                    a.xhe[3 * i + 1], a.xhe[3 * i + 2]};
    IonState<T> ion{f0, f0, f0};
    T temper1 = t0, avg_t = t0;
    // isothermal: avg_t stays t0, so the fits are the same every round
    Rates<T> rates = rate_coefficients(t0);
    int nit = 0;
    bool done = false;
    while (!done && nit < a.max_iter) {
      const Ion<T> prev = ion.avg;
      const T temper2 = temper1;
      // photo rates from the incoming columns and the averaged fractions
      T cc[3];
      cell_columns(a.dr, ion.avg, nd, cc);
      const T cout[3] = {cd[0] + cc[0], cd[1] + cc[1], cd[2] + cc[2]};
      T y[6];
      if constexpr (kHeat) ricotti(ion.avg.h1, y);
      T r[4];
      if constexpr (kTable) {
        table_rates<T, kHeat>(a, cd, cout, vol, y, r, lane);
      } else {
        T o[kHeat ? 6 : 5];
        cell_rates<T, kHeat, false, kK>(tab, a.bt, ones, cd, cout, vol, y, o,
                                        nullptr, lane, kLanes);
        r[0] = o[0];
        r[1] = o[1];
        r[2] = o[2];
        r[3] = T(0);
        if constexpr (kHeat) r[3] = o[5];
      }
      for (int q = 0; q < (kHeat ? 4 : 3); ++q) {
        r[q] = group_sum<kLanes>(r[q]);
      }
      const T pHI = r[0] / (ion.avg.h0 * nd * T(1.0 - kAbuHe)) + a.g[0];
      const T pHeI = r[1] / (ion.avg.he0 * nd * T(kAbuHe)) + a.g[1];
      const T pHeII = r[2] / (ion.avg.he1 * nd * T(kAbuHe)) + a.g[2];
      if constexpr (kHeat) rates = rate_coefficients(avg_t);
      const IonState<T> nw = doric_half(a.dt, nd, a.clump, pHI, pHeI, pHeII,
                                        rates, ion, a.eps, a.one_m_eps, a.dr);
      T temper1_new = t0, avg_t_new = avg_t;
      if constexpr (kHeat) {
        const ThermalOut<T> th = thermal(a.dt, t0, electrondens(nd, nw.avg),
                                         nd, nw, r[3], a.cool_tab, a.ccf);
        temper1_new = th.end_t;
        avg_t_new = th.avg_t;
        sub_max = max(sub_max, th.nsub);
        sub_sum += th.nsub;
      }
      done = conv1d(nw.avg.h0, prev.h0) && conv1d(nw.avg.he0, prev.he0) &&
             conv1d(nw.avg.he1, prev.he1) && conv1d(nw.avg.he2, prev.he2) &&
             xabs(temper1_new - temper2) / temper1_new <
                 T(kMinFractionalChange);
      ion = nw;
      temper1 = temper1_new;
      avg_t = avg_t_new;
      ++nit;
    }
    // fully shielded shells keep their state (evolve_new.F90:395-404)
    const bool shielded = cd[0] > T(kMaxColdensh1D);
    const Ion<T> fin = shielded ? f0 : ion.cur;
    const Ion<T> fav = shielded ? f0 : ion.avg;
    // the outgoing columns add the averaged shell column
    T cc[3];
    cell_columns(a.dr, fav, nd, cc);
    for (int c = 0; c < 3; ++c) cd[c] = cd[c] + cc[c];
    if (lane == 0) {
      a.xh_out[2 * i] = fin.h0;
      a.xh_out[2 * i + 1] = fin.h1;
      a.xhe_out[3 * i] = fin.he0;
      a.xhe_out[3 * i + 1] = fin.he1;
      a.xhe_out[3 * i + 2] = fin.he2;
      a.temper_out[i] = shielded ? t0 : temper1;
      a.nits[i] = nit;
    }
    it_sum += nit;
    it_max = max(it_max, nit);
  }
  if (lane == 0) {
    a.counters[0] = it_sum;
    a.counters[1] = it_max;
    a.counters[2] = sub_max;
    a.counters[3] = sub_sum;
  }
}

template <typename T, bool kHeat, bool kTable>
int run_evolve1d(const Args1D<T>& a, cudaStream_t stream) {
  const size_t smem =
      kTable ? 0 : size_t(a.nbt) * row_stride<kHeat>(a.bt.K) * sizeof(T);
  auto kernel = with_nodes(kTable ? 0 : a.bt.K, [](auto kk) {
    return evolve1d_kernel<T, kHeat, kTable, kTable ? 0 : decltype(kk)::value>;
  });
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<1, kLanes, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace c2ray

extern "C" {

// Returns the cudaError_t of the launch (0 on success).  The quadrature
// route reads bands as packed rows (nbt of them, K nodes, per type its
// live band count and first band); the table route reads bands as
// (nb, 17) rows, hbin, photo_tab and, with heating, heat_tab.  cool_tab
// is read with heating only.
#define C2RAY_EVOLVE1D_ENTRY(NAME, T, HEAT, TABLE)                          \
  int NAME(const T* ndens, const T* temper, const T* xh, const T* xhe,     \
           const T* vol, const T* bands, const int* hbin,                  \
           const T* photo_tab, const T* heat_tab, const T* cool_tab,       \
           T* xh_out, T* xhe_out, T* temper_out, int* nits, int* counters, \
           int mesh, int nbt, int K, int ntypes, int nb0, int nb1,         \
           int nb2, int lo0, int lo1, int lo2, int nb, int nheat,          \
           int max_iter, double dr, double dt, double clump, double g0,    \
           double g1, double g2, double eps, double ccf, double bnd0,      \
           double bnd1, double bnd2, void* stream) {                       \
    c2ray::Args1D<T> a;                                                    \
    a.ndens = ndens; a.temper = temper; a.xh = xh; a.xhe = xhe;            \
    a.vol = vol; a.bands = bands; a.hbin = hbin; a.photo_tab = photo_tab;  \
    a.heat_tab = heat_tab; a.cool_tab = cool_tab; a.xh_out = xh_out;       \
    a.xhe_out = xhe_out; a.temper_out = temper_out; a.nits = nits;         \
    a.counters = counters;                                                 \
    a.mesh = mesh; a.nbt = nbt; a.nb = nb; a.nheat = nheat;                \
    a.max_iter = max_iter;                                                 \
    const int nbs[3] = {nb0, nb1, nb2}, los[3] = {lo0, lo1, lo2};          \
    a.bt.K = K; a.bt.ntypes = ntypes;                                      \
    for (int t = 0; t < 3; ++t) {                                          \
      a.bt.type_col[t] = t;                                                \
      a.bt.type_nb[t] = t < ntypes ? nbs[t] : 0;                           \
      a.bt.type_lo[t] = t < ntypes ? los[t] : 0;                           \
    }                                                                      \
    a.dr = T(dr); a.dt = T(dt); a.clump = T(clump); a.eps = T(eps);        \
    a.one_m_eps = T(1.0 - eps); a.ccf = T(ccf);                            \
    a.g[0] = T(g0); a.g[1] = T(g1); a.g[2] = T(g2);                        \
    a.bnd[0] = T(bnd0); a.bnd[1] = T(bnd1); a.bnd[2] = T(bnd2);            \
    return c2ray::run_evolve1d<T, HEAT, TABLE>(                            \
        a, static_cast<cudaStream_t>(stream));                             \
  }

C2RAY_EVOLVE1D_ENTRY(evolve1d_quad_iso_f32, float, false, false)
C2RAY_EVOLVE1D_ENTRY(evolve1d_quad_iso_f64, double, false, false)
C2RAY_EVOLVE1D_ENTRY(evolve1d_quad_heat_f32, float, true, false)
C2RAY_EVOLVE1D_ENTRY(evolve1d_quad_heat_f64, double, true, false)
C2RAY_EVOLVE1D_ENTRY(evolve1d_table_iso_f32, float, false, true)
C2RAY_EVOLVE1D_ENTRY(evolve1d_table_iso_f64, double, false, true)
C2RAY_EVOLVE1D_ENTRY(evolve1d_table_heat_f32, float, true, true)
C2RAY_EVOLVE1D_ENTRY(evolve1d_table_heat_f64, double, true, true)

}  // extern "C"
