// Per-cell chemistry fixed point with the pass write-back: the
// isothermal variant, and the heating variant (template flag kHeat)
// with the thermal sub-cycle and its cooling-table lookup inside.
//
// Replaces c2ray_tpu/sweep/global_pass.py: _chem_iteration (:140) inside
// the in-graph lockstep of _do_chemistry_global (:637-655), and
// _finalize_pass (:658), with c2ray_tpu/chemistry.py: doric (:150),
// electrondens (:51), prepare_doric_factors (:84), and
// c2ray_tpu/rates.py: rate_coefficients (:44); with kHeat also
// c2ray_tpu/thermal.py: thermal_init (:84), thermal_substeps (:119),
// thermal_finalize (:177), and c2ray_tpu/cooling.py: coolin (:120).
//
// One thread runs one cell's fixed point: clamped IonState
// (state.py:65-76), then up to max_iter rounds of {rate fits (once at
// t_iso when isothermal, at the cell's averaged T each round when
// heating), two doric solves averaged, damped blend from iteration
// damp_after on, and when heating the electron density of the blended
// ions and the thermal sub-cycle, then the 1% convergence test},
// leaving on the cell's own convergence.  A frozen cell never changes
// in JAX's masked lockstep, so the per-thread iteration index equals
// the lockstep's global one and the result matches cell for cell.  The
// same holds one level down: the thermal sub-cycle is a per-thread loop
// of at most kMaxSubsteps steps, and the lockstep's cap on its global
// index equals the cell's own step count while it is active
// (thermal.py:119-126).  The write-back and conv_flag follow; conv_flag
// is a block count (__syncthreads_count) plus an integer atomicAdd, and
// the largest per-cell iteration and sub-step counts integer
// atomicMax: exact and deterministic.
//
// Bound: arithmetic per cell (two doric solves per iteration, each with
// 3 exp + 3 expm1 + a sqrt and ~20 divisions; heating adds 16 powers
// and 6 exps of the rate fits per iteration and, per sub-step, a log10,
// 10 table reads and ~15 operations) times the cell's iteration and
// sub-step counts; memory is one read of 20 (heating 22) and one write
// of 12 values per cell, plus the 801 x 5 cooling table, read through
// the read-only cache (16 KB in f32, 32 KB in f64).  Cells of a warp
// that converge early idle until the warp's slowest cell finishes: the
// cost of the convergence tail is per warp, not per grid, which is what
// the TPU's compaction loop tried to buy.  A warp holding one hot
// I-front cell runs its ~100+ sub-steps while the rest idle; the third
// counter reports the largest sub-step count so a run shows it.
//
// The per-cell functions (rate fits, doric, thermal, coolin) are in
// csrc/chemistry.cuh, shared with the 1D march (csrc/evolve1d.cu).

#include "chemistry.cuh"

namespace c2ray {
namespace {

constexpr int kBlock = 256;

template <typename T>
__device__ __forceinline__ T blend(T nw, T old, T damp) {
  return nw + damp * (old - nw);
}

template <typename T>
__device__ __forceinline__ Ion<T> blend(const Ion<T>& n, const Ion<T>& o,
                                        T d) {
  return Ion<T>{blend(n.h0, o.h0, d), blend(n.h1, o.h1, d),
                blend(n.he0, o.he0, d), blend(n.he1, o.he1, d),
                blend(n.he2, o.he2, d)};
}

template <typename T>
__device__ __forceinline__ bool conv(T nw, T old) {
  return xabs((nw - old) / nw) < T(kMinFractionalChange) ||
         nw < T(kMinFractionOfAtoms);
}

template <typename T>
__device__ __forceinline__ bool big_change(T nw, T old) {
  return xabs(nw - old) > T(kMinFractionalChange) &&
         xabs((nw - old) / nw) > T(kMinFractionalChange) &&
         nw > T(kMinFractionOfAtoms);
}

// Input rows (n cells each): 0 ndens, 1-5 h0 h1 he0 he1 he2,
// 6-10 h_av0..he_av2, 11-15 h_int0..he_int2, 16 t_av, 17 phih,
// 18 phihe0, 19 phihe1; heating also 20 t_final, 21 phiheat.  Output
// rows: 0-4 h_int0..he_int2, 5-9 h_av0..he_av2, 10 t_inter, 11 t_av.
// counters[0] += conv_flag, counters[1] = max(iterations),
// counters[2] = max(thermal sub-steps of one iteration), heating only.
template <typename T, bool kHeat>
__global__ void __launch_bounds__(kBlock)
chemistry_kernel(const T* __restrict__ in, const T* __restrict__ clumping,
                 int clump_stride, const T* __restrict__ cool_tab,
                 T* __restrict__ out, int* __restrict__ counters, long long n,
                 T dt, T t_iso, T ccf, T eps, T one_m_eps, int max_iter,
                 int damp_after, T damp_factor) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < n;
  bool changed = false;
  int nit = 0, nsub = 0;
  if (in_range) {
    auto row = [&](int k) { return in[(long long)k * n + i]; };
    const T ndens = row(0);
    const T clump = clumping[clump_stride ? i : 0];
    const T pHI = row(17), pHeI = row(18), pHeII = row(19);
    auto clamped = [&](int k0) {
      return Ion<T>{maxp(row(k0), eps), maxp(row(k0 + 1), eps),
                    maxp(row(k0 + 2), eps), maxp(row(k0 + 3), eps),
                    maxp(row(k0 + 4), eps)};
    };
    IonState<T> ion;
    ion.old = clamped(1);
    ion.avg = clamped(6);
    ion.cur = clamped(11);
    // _chem_setup: the isothermal temperature and its fixed rates, or
    // temper0 = temper1 = t_final and avg_t = t_av
    Rates<T> rates;
    T temper0, temper1, avg_t, pheat = T(0);
    if constexpr (kHeat) {
      temper0 = row(20);
      temper1 = temper0;
      avg_t = row(16);
      pheat = row(21);
    } else {
      rates = rate_coefficients(t_iso);
      temper0 = temper1 = avg_t = t_iso;
    }

    while (nit < max_iter) {
      const T damp = nit >= damp_after ? damp_factor : T(0);
      if constexpr (kHeat) rates = rate_coefficients(avg_t);
      IonState<T> nw = doric_half(dt, ndens, clump, pHI, pHeI, pHeII, rates,
                                  ion, eps, one_m_eps, T(1));
      nw.cur = blend(nw.cur, ion.cur, damp);
      nw.avg = blend(nw.avg, ion.avg, damp);
      nw.old = blend(nw.old, ion.old, damp);
      // _chem_iteration: isothermal T stays temper0 == t_iso
      T temper1_new = temper0, avg_t_new = avg_t;
      if constexpr (kHeat) {
        const ThermalOut<T> th =
            thermal(dt, temper0, electrondens(ndens, nw.avg), ndens, nw,
                    pheat, cool_tab, ccf);
        temper1_new = blend(th.end_t, temper1, damp);
        avg_t_new = blend(th.avg_t, avg_t, damp);
        nsub = max(nsub, th.nsub);
      }
      // _conv_freeze
      const bool done = conv(nw.avg.h0, ion.avg.h0) &&
                        conv(nw.avg.he0, ion.avg.he0) &&
                        conv(nw.avg.he2, ion.avg.he2) &&
                        xabs((temper1_new - temper1) / temper1_new) <
                            T(kMinFractionalChange);
      ion = nw;
      temper1 = temper1_new;
      avg_t = avg_t_new;
      ++nit;
      if (done) break;
    }

    // _finalize_pass
    const T st_t_av = row(16);
    changed = big_change(ion.avg.h0, row(6)) ||
              big_change(ion.avg.he0, row(8)) ||
              big_change(ion.avg.he2, row(10)) ||
              (xabs((st_t_av - avg_t) / avg_t) > T(0.1) &&
               xabs(avg_t - st_t_av) > T(100));
    const T vals[12] = {ion.cur.h0, ion.cur.h1, ion.cur.he0, ion.cur.he1,
                        ion.cur.he2, ion.avg.h0, ion.avg.h1, ion.avg.he0,
                        ion.avg.he1, ion.avg.he2, temper1, avg_t};
    for (int k = 0; k < 12; ++k) out[(long long)k * n + i] = vals[k];
  }
  const int block_changed = __syncthreads_count(changed);
  for (int off = 16; off > 0; off >>= 1) {
    nit = max(nit, __shfl_down_sync(0xffffffffu, nit, off));
    if constexpr (kHeat)
      nsub = max(nsub, __shfl_down_sync(0xffffffffu, nsub, off));
  }
  if ((threadIdx.x & 31) == 0) {
    if (nit > 0) atomicMax(&counters[1], nit);
    if (kHeat && nsub > 0) atomicMax(&counters[2], nsub);
  }
  if (threadIdx.x == 0 && block_changed) atomicAdd(&counters[0],
                                                   block_changed);
}

template <typename T, bool kHeat>
int run_chemistry(const T* in, const T* clumping, int clump_stride,
                  const T* cool_tab, T* out, int* counters, long long n,
                  double dt, double t_iso, double ccf, double epsilon,
                  int max_iter, int damp_after, double damp_factor,
                  cudaStream_t stream) {
  const long long blocks = (n + kBlock - 1) / kBlock;
  chemistry_kernel<T, kHeat><<<(unsigned)blocks, kBlock, 0, stream>>>(
      in, clumping, clump_stride, cool_tab, out, counters, n, T(dt),
      T(t_iso), T(ccf), T(epsilon), T(1.0 - epsilon), max_iter, damp_after,
      T(damp_factor));
  return cudaGetLastError();
}

}  // namespace
}  // namespace c2ray

extern "C" {

// Returns the cudaError_t of the launch (0 on success).  cool_tab is
// the (801, 5) cooling table (read by the heating variant only).
#define C2RAY_CHEM_ENTRY(NAME, T, HEAT)                                    \
  int NAME(const T* in, const T* clumping, int clump_stride,              \
           const T* cool_tab, T* out, int* counters, long long n,         \
           double dt, double t_iso, double ccf, double epsilon,           \
           int max_iter, int damp_after, double damp_factor,              \
           void* stream) {                                                \
    return c2ray::run_chemistry<T, HEAT>(                                 \
        in, clumping, clump_stride, cool_tab, out, counters, n, dt,       \
        t_iso, ccf, epsilon, max_iter, damp_after, damp_factor,           \
        static_cast<cudaStream_t>(stream));                               \
  }

C2RAY_CHEM_ENTRY(chemistry_iso_f32, float, false)
C2RAY_CHEM_ENTRY(chemistry_iso_f64, double, false)
C2RAY_CHEM_ENTRY(chemistry_heat_f32, float, true)
C2RAY_CHEM_ENTRY(chemistry_heat_f64, double, true)

}  // extern "C"
