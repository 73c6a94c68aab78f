// One timestep of the 1D program: the radial march over the shells with
// each shell's fixed point, in one launch of one warp.  Variants: the
// quadrature rate route (a fixed rule, kK its K, or "auto" tables, kK =
// kBlockRoute) or the tau-table route (template flag kTable), each
// isothermal or with heating (template flag kHeat: the heating rates,
// the T-dependent rate fits and the thermal sub-cycle).
//
// Replaces c2ray_tpu/onedim/evolve.py: _solve_cell (:104) inside the
// radial lax.scan of make_evolve1d / evolve1d (:190-239), with
// _cell_photorates (:79) and _cell_columns (:95); on the table route
// c2ray_tpu/radiation/photo.py: _table_positions (:65), _read (:78),
// _photo_lookup (:90), _heat_lookup (:123) and photoion_rates (:185);
// on the quadrature route band_in / band_out (csrc/band_rates.cuh,
// cell_rates' split form; on "auto" tables, with the blocks loop of
// c2ray_tpu/radiation/quadrature.py:486-489, rows_in / rows_out), on
// the table route table_in / table_out
// (csrc/table_rates.cuh); the chemistry device functions of
// csrc/chemistry.cuh.
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
// Launch shape: one block of one warp per timestep.  The march is one
// serial chain (shell i needs shell i-1's converged column), as the JAX
// scan is, so one SM of the card's 132 runs it and latency, not
// throughput, bounds it: one warp's dependent instructions, each waiting
// for the one before.  Each lane takes the bands b = lane, lane + 32,
// ... of every source type (on "auto" tables its rows of band_rates.cuh's
// row deal: every block's bands cut into rows of 3 nodes, dealt to the
// lanes in one pass); a shuffle butterfly adds the
// lanes' partial rates (the heat a Kahan sum per lane) in a fixed order
// that leaves the same bits on every lane, so every lane then runs the
// chemistry on the same values, with no broadcast and no divergence, and
// a result repeats to the last digit between calls.  A second warp (a
// lane per band at test 1's 36-47 bands) would add a barrier and a
// shared-memory sum to every iteration to save part of the rate side,
// which is not where the time goes on a fixed rule (below); on "auto"
// tables the row deal fills the 32 lanes (band_rates.cuh).
//
// Design, from the cycles each part of an iteration took on the
// chip (clock64 stamps in a copy of this file that
// tools/profile_torch_iteration.py --oned builds; test 1 at 10000
// shells, float32, isothermal / heating / tau tables; PERF.md section
// 6):
//   1. The incoming side is hoisted out of the fixed-point loop: per
//      shell, once, band_in (band_rates.cuh) or table_in keeps a band's
//      tau_in, its K exponentials e_in and thin sums (tables: the reads
//      at tau_in's position) in shared memory; per iteration band_out /
//      table_out do the outgoing side only: tau_out, the tau shares, the
//      regime tests (which may flip between iterations), a thick band's
//      e_out or its reads at tau_out.  1343 / 1370 / 1357 cycles an
//      iteration before.
//   2. The rate fits (rate_coefficients and the Ricotti fits: 29 pows,
//      5 exps), 6960 of 17586 cycles with heating, run one pow and one
//      exp per lane in two rounds (spread_fits), gathered by shuffles;
//      doric's three exp and three expm1 likewise (chemistry.cuh,
//      PerWarp).  The same functions of the same operands: the same
//      bits.
//   3. The (801, 5) cooling table lies in shared memory beside the band
//      rows, and the table route's band rows too.
//   4. Every float division of the march is div_flat (common.cuh): the
//      compiler's division wraps its slow-path branch in a convergence
//      barrier, so a lone warp ran the ~50 divisions of an iteration one
//      after the other (doric's two passes, ~4400 of ~6000 cycles).
//      div_flat gives the same bits without a branch, so independent
//      divisions overlap.  float64 keeps `/`.
//   The lane reduction (173 cycles, 2-3%) is left as it was.
// Measured per float32 iteration over 12 steps, the previous kernel
// (commit a26c0a1) -> this one (NVIDIA H100 80GB HBM3, 700 W, the two
// builds in turns): 3.915 -> 2.232 us isothermal, 8.571 -> 4.335 us
// heating, 4.528 -> 3.316 us on the tau tables; doric's two passes
// still take ~3200-3800 of ~4900-8500 cycles, a dependent chain now.
// The quadrature route takes band_rates.cuh's unrolled node loop (K a
// template parameter).  "auto" tables take band_rates.cuh's row deal:
// their earlier block-by-block route spent 57% of an iteration in seven
// passes over 1-16 lanes each (--oned --auto).  Per float32 iteration
// over 12 steps, the block route (commit e7dcd29) -> the row deal, the
// two builds in turns on the same card: 4.535 -> 2.023 us isothermal,
// 7.177 -> 3.727 us heating (the outgoing side 5926 -> 856 cycles).

#include "band_rates.cuh"
#include "chemistry.cuh"
#include "table_rates.cuh"

namespace c2ray {
namespace {

constexpr int kLanes = 32;
constexpr double kMaxColdensh1D = 2.0e26;    // onedim/evolve.py:MAX_COLDENSH_1D

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
  int slots;            // "auto" tables: the rows' slots (band_rates.cuh:
                        // rows_in / rows_out)
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
  return div_flat(xabs(nw - old), nw) < T(kMinFractionalChange) ||
         nw < T(kMinFractionOfAtoms);
}

// ---- The rate fits, spread over the warp's lanes
//
// rates.py:rate_coefficients(t) (chemistry.cuh) and the Ricotti fits
// ricotti(x) (band_rates.cuh) take 17 + 12 pows, 5 exps and a square
// root in sequence on every lane.  Here each lane evaluates one pow of
// the first round (the inner powers), one exp, then one pow of the
// second round (the outer (1 + ...)^e and (1 - ...)^d, of a first-round
// value shuffled in), on per-lane operands: the same instructions on
// every lane, no branch on the lane index.  __shfl_sync gathers the
// values.  The operands and coefficients are the fits' own (FitArecH0
// ... in chemistry.cuh, FitY1 / FitY2 in band_rates.cuh); each value is
// the same function of the same operands as in rate_coefficients and
// ricotti, so it keeps its bits, and the values are combined in those
// functions' expression order.

// The first round, one slot per lane: pow(mul * (n / d) / div, e) with
// (n, d, mul) = (t_ion, t, 2) (a fit's lam = 2 T_ion / t), (t, 1e4, 1),
// (t, 1, 1) or (x, 1, 1) by `kind` (a division by 1 and a product with 1
// are exact).  Slots are named by the value they give.
enum FitKind { kFitLambda, kFitT4, kFitT, kFitX };
enum Pow1Slot {
  kArecH0Lam, kArecH0In, kBrecH0Lam, kBrecH0In, kDielT, kAHotLam, kBHotLam,
  kBrecHe1Lam, kBrecHe1In, kArecHe1Lam, kArecHe1In, kTreche1T4, kVT4,
  kY1In0, kY1In1, kY1In2, kY2A0, kY2B0, kY2A1, kY2B1, kY2A2, kY2B2,
  kPow1Slots
};
struct Pow1Op {
  int kind;
  double num, div, e;
};
__constant__ Pow1Op kPow1Ops[] = {
    {kFitLambda, FitArecH0::t_ion, 1.0, FitArecH0::a},
    {kFitLambda, FitArecH0::t_ion, FitArecH0::d, FitArecH0::b},
    {kFitLambda, FitBrecH0::t_ion, 1.0, FitBrecH0::a},
    {kFitLambda, FitBrecH0::t_ion, FitBrecH0::d, FitBrecH0::b},
    {kFitT, 0.0, 1.0, FitDielectronic::a},
    {kFitLambda, FitAHotHe0::t_ion, 1.0, FitAHotHe0::a},
    {kFitLambda, FitBHotHe0::t_ion, 1.0, FitBHotHe0::a},
    {kFitLambda, FitBrecHe1::t_ion, 1.0, FitBrecHe1::a},
    {kFitLambda, FitBrecHe1::t_ion, FitBrecHe1::d, FitBrecHe1::b},
    {kFitLambda, FitArecHe1::t_ion, 1.0, FitArecHe1::a},
    {kFitLambda, FitArecHe1::t_ion, FitArecHe1::d, FitArecHe1::b},
    {kFitT4, 0.0, 1.0, FitTreche1::a},
    {kFitT4, 0.0, 1.0, FitV::a},
    {kFitX, 0.0, 1.0, FitY1<0>::b},
    {kFitX, 0.0, 1.0, FitY1<1>::b},
    {kFitX, 0.0, 1.0, FitY1<2>::b},
    {kFitX, 0.0, 1.0, FitY2<0>::a},
    {kFitX, 0.0, 1.0, FitY2<0>::b},
    {kFitX, 0.0, 1.0, FitY2<1>::a},
    {kFitX, 0.0, 1.0, FitY2<1>::b},
    {kFitX, 0.0, 1.0, FitY2<2>::a},
    {kFitX, 0.0, 1.0, FitY2<2>::b},
};
// The second round: pow(1 + sgn * (first-round slot src), e)
enum Pow2Slot {
  kArecH0Out, kBrecH0Out, kBrecHe1Out, kArecHe1Out, kY1Out0, kY1Out1,
  kY1Out2, kPow2Slots
};
struct Pow2Op {
  int src;
  double sgn, e;
};
__constant__ Pow2Op kPow2Ops[] = {
    {kArecH0In, 1.0, FitArecH0::e},     {kBrecH0In, 1.0, FitBrecH0::e},
    {kBrecHe1In, 1.0, FitBrecHe1::e},   {kArecHe1In, 1.0, FitArecHe1::e},
    {kY1In0, -1.0, FitY1<0>::d},        {kY1In1, -1.0, FitY1<1>::d},
    {kY1In2, -1.0, FitY1<2>::d},
};
// The exps: exp(arg / t)
enum ExpSlot { kDielE1, kDielE2, kColliHI, kColliHeI, kColliHeII, kExpSlots };
__constant__ double kExpArgs[] = {FitDielectronic::e1, FitDielectronic::e2,
                                  -kTempH0, -kTempHe0, -kTempHe1};
static_assert(sizeof(kPow1Ops) / sizeof(Pow1Op) == kPow1Slots &&
                  sizeof(kPow2Ops) / sizeof(Pow2Op) == kPow2Slots &&
                  sizeof(kExpArgs) / sizeof(double) == kExpSlots &&
                  kPow1Slots <= kLanes,
              "one slot of each round per lane");

// This lane's operands in the working type, loaded once per launch;
// lanes past a round's slots repeat its last one.
template <typename T>
struct FitOps {
  bool lambda, by_t4, of_x;
  int src;
  T num, div, e1, sgn, e2, arg;
};

template <typename T>
__device__ __forceinline__ FitOps<T> fit_ops(int lane) {
  const Pow1Op& p = kPow1Ops[min(lane, kPow1Slots - 1)];
  const Pow2Op& q = kPow2Ops[min(lane, kPow2Slots - 1)];
  return FitOps<T>{p.kind == kFitLambda, p.kind == kFitT4, p.kind == kFitX,
                   q.src, T(p.num), T(p.div), T(p.e), T(q.sgn), T(q.e),
                   T(kExpArgs[min(lane, kExpSlots - 1)])};
}

// rate_coefficients(t) into `r` and, with kRicotti, ricotti(x) into y.
template <typename T, bool kRicotti>
__device__ __forceinline__ void spread_fits(const FitOps<T>& o, T t, T x,
                                            Rates<T>& r, T y[6]) {
  constexpr unsigned kAll = 0xffffffffu;
  using D = FitDielectronic;
  const T n = o.lambda ? o.num : (o.of_x ? x : t);
  const T d = o.lambda ? t : (o.by_t4 ? T(1.0e4) : T(1));
  const T q = (o.lambda ? T(2) : T(1)) * div_flat(n, d);
  const T p1 = xpow(div_flat(q, o.div), o.e1);
  const T ex = xexp(div_flat(o.arg, t));
  const T p2 = xpow(T(1) + o.sgn * __shfl_sync(kAll, p1, o.src), o.e2);
  T P1[kPow1Slots], P2[kPow2Slots], E[kExpSlots];
#pragma unroll
  for (int j = 0; j < kPow1Slots; ++j) P1[j] = __shfl_sync(kAll, p1, j);
#pragma unroll
  for (int j = 0; j < kPow2Slots; ++j) P2[j] = __shfl_sync(kAll, p2, j);
#pragma unroll
  for (int j = 0; j < kExpSlots; ++j) E[j] = __shfl_sync(kAll, ex, j);
  // rate_coefficients' expressions (recomb_fit: c lam^a / outer)
  r.arech0 = div_flat(T(FitArecH0::c) * P1[kArecH0Lam], P2[kArecH0Out]);
  r.brech0 = div_flat(T(FitBrecH0::c) * P1[kBrecH0Lam], P2[kBrecH0Out]);
  const T dielectronic = T(D::c) * P1[kDielT] * E[kDielE1] *
                         (T(1) + T(D::f) * E[kDielE2]);
  const T areche0_hot = T(FitAHotHe0::c) * P1[kAHotLam] + dielectronic;
  const T breche0_hot = T(FitBHotHe0::c) * P1[kBHotLam] + dielectronic;
  const bool cold = t < T(kFitColdT);
  r.areche0 = cold ? r.arech0 : areche0_hot;
  r.breche0 = cold ? r.brech0 : breche0_hot;
  r.oreche0 = r.areche0 - r.breche0;
  r.breche1 = div_flat(T(FitBrecHe1::c) * P1[kBrecHe1Lam], P2[kBrecHe1Out]);
  r.areche1 = div_flat(T(FitArecHe1::c) * P1[kArecHe1Lam], P2[kArecHe1Out]);
  r.treche1 = T(FitTreche1::c) * P1[kTreche1T4];
  r.v = T(FitV::c) * P1[kVT4];
  const T sqrtT = xsqrt(t);
  r.colli_HI = T(kColH0) * sqrtT * E[kColliHI];
  r.colli_HeI = T(kColHe0) * sqrtT * E[kColliHeI];
  r.colli_HeII = T(kColHe1) * sqrtT * E[kColliHeII];
  if constexpr (kRicotti) {
    // y1R: c (outer power); y2R: c x^a xeb xeb
    y[0] = T(FitY1<0>::c) * P2[kY1Out0];
    y[1] = T(FitY1<1>::c) * P2[kY1Out1];
    y[2] = T(FitY1<2>::c) * P2[kY1Out2];
    const T xeb0 = T(1) - P1[kY2B0], xeb1 = T(1) - P1[kY2B1],
            xeb2 = T(1) - P1[kY2B2];
    y[3] = T(FitY2<0>::c) * P1[kY2A0] * xeb0 * xeb0;
    y[4] = T(FitY2<1>::c) * P1[kY2A1] * xeb1 * xeb1;
    y[5] = T(FitY2<2>::c) * P1[kY2A2] * xeb2 * xeb2;
  }
}

// kK: the quadrature table's K (0: a.bt.K at run time; 0 on the table
// route), or kBlockRoute: "auto" tables, dealt as rows of kRowNodes.
// The "auto" instantiations ask for one resident block (a launch has
// one): ptxas then keeps more registers (102 -> 112 isothermal, float32)
// and schedules the march's doric passes with fewer stalls, 2.75 -> 2.03
// us an isothermal iteration (PERF.md section 6); 0 (no minimum)
// leaves the other instantiations as they were.
template <typename T, bool kHeat, bool kTable, int kK>
__global__ void __launch_bounds__(kLanes, kK == kBlockRoute ? 1 : 0)
    evolve1d_kernel(const Args1D<T> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  constexpr bool kBlocks = kK == kBlockRoute;
  // shared memory: the band rows, the shell's incoming side, with
  // heating the cooling table
  T* tab = reinterpret_cast<T*>(smem);
  const int nrow = kTable    ? a.nb * kTableRow
                   : kBlocks ? a.slots * kRowValues<kHeat> * kRowLanes
                             : a.nbt * row_stride<kHeat>(kK > 0 ? kK : a.bt.K);
  for (int k = lane; k < nrow; k += kLanes) tab[k] = a.bands[k];
  T* in = tab + nrow;
  T* cool = in + (kTable    ? a.nb * table_in_values<kHeat>(a.bt.ntypes)
                  : kBlocks ? a.slots * kRowInValues<kHeat> * kRowLanes
                            : a.nbt * in_values<kHeat>(a.bt.K));
  if constexpr (kHeat) {
    for (int k = lane; k < kTempPoints * 5; k += kLanes) {
      cool[k] = a.cool_tab[k];
    }
  }
  __syncwarp();
  const FitOps<T> fo = fit_ops<T>(lane);
  T cd[3] = {a.bnd[0], a.bnd[1], a.bnd[2]};
  int it_sum = 0, it_max = 0, sub_max = 0, sub_sum = 0;
  for (int i = 0; i < a.mesh; ++i) {
    const T nd = a.ndens[i], vol = a.vol[i], t0 = a.temper[i];
    const Ion<T> f0{a.xh[2 * i], a.xh[2 * i + 1], a.xhe[3 * i],
                    a.xhe[3 * i + 1], a.xhe[3 * i + 2]};
    const T inv_vol = div_flat(T(1), vol);
    IonState<T> ion{f0, f0, f0};
    T temper1 = t0, avg_t = t0;
    Rates<T> rates;
    T y[6];
    // isothermal: avg_t stays t0, so the fits are the same every round
    if constexpr (!kHeat) spread_fits<T, false>(fo, t0, T(1), rates, y);
    // the incoming side, fixed while the shell iterates
    if constexpr (kTable) {
      table_in<T, kHeat, kLanes>(a, tab, cd, in, lane);
    } else if constexpr (kBlocks) {
      rows_in<T, kHeat>(tab, a.slots, cd, in, lane);
    } else {
      band_in<T, kHeat, kK>(tab, a.bt, cd, in, lane, kLanes);
    }
    int nit = 0;
    bool done = false;
    while (!done && nit < a.max_iter) {
      const Ion<T> prev = ion.avg;
      const T temper2 = temper1;
      // the fits at the previous round's average temperature and HII
      // fraction
      if constexpr (kHeat) {
        spread_fits<T, true>(fo, avg_t, ion.avg.h1, rates, y);
      }
      // photo rates from the incoming columns and the averaged fractions
      T cc[3];
      cell_columns(a.dr, ion.avg, nd, cc);
      const T cout[3] = {cd[0] + cc[0], cd[1] + cc[1], cd[2] + cc[2]};
      T r[4];
      if constexpr (kTable) {
        table_out<T, kHeat, kLanes>(a, tab, cd, cout, vol, y, in, r, lane);
      } else if constexpr (kBlocks) {
        rows_out<T, kHeat>(tab, a.slots, cd, cout, inv_vol, y, in, r,
                           lane);
      } else {
        band_out<T, kHeat, kK>(tab, a.bt, cd, cout, inv_vol, y, in, r, lane,
                               kLanes);
      }
      for (int q = 0; q < (kHeat ? 4 : 3); ++q) {
        r[q] = group_sum<kLanes>(r[q]);
      }
      const T pHI = div_flat(r[0], ion.avg.h0 * nd * T(1.0 - kAbuHe)) + a.g[0];
      const T pHeI = div_flat(r[1], ion.avg.he0 * nd * T(kAbuHe)) + a.g[1];
      const T pHeII = div_flat(r[2], ion.avg.he1 * nd * T(kAbuHe)) + a.g[2];
      const IonState<T> nw =
          doric_half<T, PerWarp>(a.dt, nd, a.clump, pHI, pHeI, pHeII, rates, ion,
                              a.eps, a.one_m_eps, a.dr);
      T temper1_new = t0, avg_t_new = avg_t;
      if constexpr (kHeat) {
        const ThermalOut<T> th = thermal<T, PerWarp>(
            a.dt, t0, electrondens(nd, nw.avg), nd, nw, r[3], cool, a.ccf);
        temper1_new = th.end_t;
        avg_t_new = th.avg_t;
        sub_max = max(sub_max, th.nsub);
        sub_sum += th.nsub;
      }
      done = conv1d(nw.avg.h0, prev.h0) && conv1d(nw.avg.he0, prev.he0) &&
             conv1d(nw.avg.he1, prev.he1) && conv1d(nw.avg.he2, prev.he2) &&
             div_flat(xabs(temper1_new - temper2), temper1_new) <
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

// The shared memory of a launch: the quadrature band rows, the shell's incoming side, with heating the
// cooling table.
template <typename T, bool kHeat, bool kTable>
size_t evolve1d_smem(const Args1D<T>& a) {
  const size_t n =
      (kTable ? size_t(a.nb) * (kTableRow + table_in_values<kHeat>(a.bt.ntypes))
              : size_t(a.nbt) * (row_stride<kHeat>(a.bt.K) +
                                 in_values<kHeat>(a.bt.K))) +
      (kHeat ? kTempPoints * 5 : 0);
  return n * sizeof(T);
}

template <typename T, bool kHeat, bool kTable>
int run_evolve1d(const Args1D<T>& a, cudaStream_t stream) {
  const size_t smem = evolve1d_smem<T, kHeat, kTable>(a);
  auto kernel = with_nodes(kTable ? 0 : a.bt.K, [](auto kk) {
    return evolve1d_kernel<T, kHeat, kTable, kTable ? 0 : decltype(kk)::value>;
  });
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<1, kLanes, smem, stream>>>(a);
  return cudaGetLastError();
}

// "auto" tables: shared memory holds the rows, their incoming side and,
// with heating, the cooling table
template <typename T, bool kHeat>
int run_evolve1d_rows(const Args1D<T>& a, cudaStream_t stream) {
  const size_t rows =
      size_t(a.slots) * kRowLanes * (kRowValues<kHeat> + kRowInValues<kHeat>);
  const size_t smem = (rows + (kHeat ? kTempPoints * 5 : 0)) * sizeof(T);
  auto kernel = evolve1d_kernel<T, kHeat, false, kBlockRoute>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<1, kLanes, smem, stream>>>(a);
  return cudaGetLastError();
}

// div_flat against `/`, elementwise (the card test of div_flat)
__global__ void div_check_kernel(const float* a, const float* b,
                                 float* q_flat, float* q_ieee, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    q_flat[i] = div_flat(a[i], b[i]);
    q_ieee[i] = a[i] / b[i];
  }
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
    a.slots = 0;                                                           \
    return c2ray::run_evolve1d<T, HEAT, TABLE>(                            \
        a, static_cast<cudaStream_t>(stream));                             \
  }

// "auto" tables, the same contract: bands holds the rows as
// onedim/evolve.py:_row_deal lays them out, `slots` of 32 rows each
// (band_rates.cuh: rows_in / rows_out).
#define C2RAY_EVOLVE1D_AUTO_ENTRY(NAME, T, HEAT)                            \
  int NAME(const T* ndens, const T* temper, const T* xh, const T* xhe,     \
           const T* vol, const T* bands, const T* cool_tab, T* xh_out,     \
           T* xhe_out, T* temper_out, int* nits, int* counters, int mesh,  \
           int slots, int max_iter, double dr, double dt, double clump,    \
           double g0, double g1, double g2, double eps, double ccf,        \
           double bnd0, double bnd1, double bnd2, void* stream) {          \
    c2ray::Args1D<T> a{};                                                  \
    a.ndens = ndens; a.temper = temper; a.xh = xh; a.xhe = xhe;            \
    a.vol = vol; a.bands = bands; a.cool_tab = cool_tab;                   \
    a.xh_out = xh_out; a.xhe_out = xhe_out; a.temper_out = temper_out;     \
    a.nits = nits; a.counters = counters;                                  \
    a.mesh = mesh; a.max_iter = max_iter;                                  \
    a.slots = slots;                                                       \
    a.dr = T(dr); a.dt = T(dt); a.clump = T(clump); a.eps = T(eps);        \
    a.one_m_eps = T(1.0 - eps); a.ccf = T(ccf);                            \
    a.g[0] = T(g0); a.g[1] = T(g1); a.g[2] = T(g2);                        \
    a.bnd[0] = T(bnd0); a.bnd[1] = T(bnd1); a.bnd[2] = T(bnd2);            \
    return c2ray::run_evolve1d_rows<T, HEAT>(                              \
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
C2RAY_EVOLVE1D_AUTO_ENTRY(evolve1d_auto_iso_f32, float, false)
C2RAY_EVOLVE1D_AUTO_ENTRY(evolve1d_auto_iso_f64, double, false)
C2RAY_EVOLVE1D_AUTO_ENTRY(evolve1d_auto_heat_f32, float, true)
C2RAY_EVOLVE1D_AUTO_ENTRY(evolve1d_auto_heat_f64, double, true)

// q_flat = div_flat(a, b) and q_ieee = a / b for n float pairs; returns
// the cudaError_t of the launch.
int evolve1d_div_check(const float* a, const float* b, float* q_flat,
                       float* q_ieee, int n, void* stream) {
  c2ray::div_check_kernel<<<(n + 255) / 256, 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      a, b, q_flat, q_ieee, n);
  return cudaGetLastError();
}

}  // extern "C"
