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
// One thread runs one cell's fixed point at a time: clamped IonState
// (state.py:65-76), then up to max_iter rounds of {rate fits (once at
// t_iso when isothermal, at the cell's averaged T each round when
// heating), two doric solves averaged, damped blend from iteration
// damp_after on, and when heating the electron density of the blended
// ions and the thermal sub-cycle, then the 1% convergence test},
// leaving on the cell's own convergence.  A frozen cell never changes
// in JAX's masked lockstep, so the per-cell iteration index equals the
// lockstep's global one and the result matches cell for cell.  The
// same holds one level down: the thermal sub-cycle is a per-thread loop
// of at most kMaxSubsteps steps, and the lockstep's cap on its global
// index equals the cell's own step count while it is active
// (thermal.py:119-126).  The write-back and conv_flag follow.
//
// Bound: the arithmetic of the iterations and sub-steps the cells take
// (two doric solves per iteration, each with 3 exp + 3 expm1 + a sqrt
// and ~20 divisions; heating adds 16 powers and 6 exps of the rate fits
// per iteration and, per sub-step, a log10, 3 divisions, 10 table reads
// and ~15 operations), at the rates of the card's pipes; memory is one
// read of 20 (heating 22) and one write of 12 values per cell.  Measured
// on the H100 (tools/profile_torch_iteration.py --chem, PERF.md): the
// isothermal fits at the one t_iso took a third of the cycles, and at
// the heating states a warp ran only 59-80% of its lanes' steps (cells
// by an ionization front take 8-40 iterations and up to 1000 sub-steps,
// their neighbours 2).  So:
//   - The grid is persistent (as many blocks as fit on the SMs) and a
//     lane whose cell is done takes the next one at once: the lanes that
//     want a cell vote (__ballot_sync) and one atomicAdd per warp hands
//     out consecutive cells.  Each cell's arithmetic is the same, so the
//     outputs are the same bits, and the counters stay integer
//     reductions (per lane, then per warp: exact and deterministic).
//   - Isothermal: the rates at t_iso are computed once per block, by
//     the same device function, into shared memory.
//   - At most 64 registers a thread in float32 (kMinBlocks = 4 blocks
//     of 256 an SM: 32 warps): 3-4% faster than at 80 (3 blocks), 17%
//     (isothermal) faster than at 87 (2 blocks).
//   - The inputs are read where they lie: the kernel takes a pointer
//     and an element stride per row (the rate grids are strided views
//     of the sweep's (n, 4) slab; a scalar clumping has stride 0), so
//     the wrapper stacks nothing.
// Measured and not taken (tools/profile_torch_iteration.py --chem
// --variants, which builds them from a copy of this file): div_flat for
// the divisions (PerCell keeps IEEE `/`: with div_flat's float64
// arithmetic the kernel ran 14-29% slower and its outputs were no
// longer the earlier kernel's bits); the cooling table in shared memory
// (as fast as __ldg through L1); other hand-outs: a warp that takes
// cells only once all its lanes are free (its 32 neighbours together,
// as the one-cell-a-thread grid), only once 8 or 16 lanes are, or at
// once only while one of its cells has run 2-8 iterations.  Where the
// fronts move they ran up to 39% slower; where they have settled no
// more than 1.5% faster.
//
// The per-cell functions (rate fits, doric, thermal, coolin) are in
// csrc/chemistry.cuh, shared with the 1D march (csrc/evolve1d.cu).

#include <algorithm>

#include "chemistry.cuh"

namespace c2ray {
namespace {

constexpr int kBlock = 256;
// blocks of kBlock threads an SM must hold (__launch_bounds__; a cap of
// 65536 / (kBlock * kMinBlocks) registers a thread); float64 takes one
constexpr int kMinBlocks = 4;
template <typename T>
constexpr int kMinBlocksOf = sizeof(T) == 4 ? kMinBlocks : 1;
constexpr unsigned kAll = 0xffffffffu;

// Input rows, n cells each, in this order (global_pass.CHEM_ROWS):
// 0 ndens, 1-5 h0 h1 he0 he1 he2, 6-10 h_av0..he_av2, 11-15
// h_int0..he_int2, 16 t_av, 17 phih, 18 phihe0, 19 phihe1, 20 t_final,
// 21 phiheat (20 and 21 read by the heating variant only), 22 clumping
// (stride 0: one value for every cell).
constexpr int kRows = 23;
enum Row { kNdens = 0, kH0 = 1, kHAv0 = 6, kHeAv0 = 8, kHeAv2 = 10,
           kHInt0 = 11, kTAv = 16, kPhiH = 17, kPhiHe0 = 18, kPhiHe1 = 19,
           kTFinal = 20, kPhiHeat = 21, kClump = 22 };

template <typename T>
struct Rows {
  const T* p[kRows];
  long long stride[kRows];
  __device__ __forceinline__ T operator()(int k, long long i) const {
    return __ldg(p[k] + i * stride[k]);
  }
};

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

// One cell's fixed point in flight: its inputs and its iterate.
template <typename T>
struct Cell {
  IonState<T> ion;
  T ndens, clump, pHI, pHeI, pHeII, pheat, temper0, temper1, avg_t;
  int nit;
};

// _chem_setup: the clamped IonState, the isothermal temperature or
// temper0 = temper1 = t_final and avg_t = t_av
template <typename T, bool kHeat>
__device__ __forceinline__ Cell<T> load_cell(const Rows<T>& in, long long i,
                                             T t_iso, T eps) {
  Cell<T> c;
  auto clamped = [&](int k0) {
    return Ion<T>{maxp(in(k0, i), eps), maxp(in(k0 + 1, i), eps),
                  maxp(in(k0 + 2, i), eps), maxp(in(k0 + 3, i), eps),
                  maxp(in(k0 + 4, i), eps)};
  };
  c.ndens = in(kNdens, i);
  c.clump = in(kClump, i);
  c.pHI = in(kPhiH, i);
  c.pHeI = in(kPhiHe0, i);
  c.pHeII = in(kPhiHe1, i);
  c.ion.old = clamped(kH0);
  c.ion.avg = clamped(kHAv0);
  c.ion.cur = clamped(kHInt0);
  if constexpr (kHeat) {
    c.temper0 = in(kTFinal, i);
    c.temper1 = c.temper0;
    c.avg_t = in(kTAv, i);
    c.pheat = in(kPhiHeat, i);
  } else {
    c.temper0 = c.temper1 = c.avg_t = t_iso;
    c.pheat = T(0);
  }
  c.nit = 0;
  return c;
}

// counters[0] += conv_flag, counters[1] = max(iterations),
// counters[2] = max(thermal sub-steps of one iteration), heating only;
// counters[4:6], zero at the launch, is the next cell to hand out (a
// 64-bit count).  Output rows (n cells each): 0-4 h_int0..he_int2, 5-9
// h_av0..he_av2, 10 t_inter, 11 t_av.
template <typename T, bool kHeat>
__global__ void __launch_bounds__(kBlock, kMinBlocksOf<T>)
chemistry_kernel(const Rows<T> in, const T* __restrict__ cool,
                 T* __restrict__ out, int* __restrict__ counters, long long n,
                 T dt, T t_iso, T ccf, T eps, T one_m_eps, int max_iter,
                 int damp_after, T damp_factor) {
  __shared__ Rates<T> fixed;
  if (!kHeat && threadIdx.x == 0) fixed = rate_coefficients(t_iso);
  __syncthreads();
  Rates<T> rates;
  if constexpr (!kHeat) rates = fixed;

  unsigned long long* next =
      reinterpret_cast<unsigned long long*>(counters + 4);
  const unsigned lane = threadIdx.x & 31u;
  int changed = 0, it_max = 0, sub_max = 0;
  long long i = n;          // this lane's cell (n: none)
  bool need = true;         // wants a cell
  Cell<T> c;
  while (true) {
    // hand out cells: one atomicAdd per warp, consecutive cells in
    // lane order
    const unsigned want = __ballot_sync(kAll, need);
    if (want) {
      const int leader = __ffs(want) - 1;
      unsigned long long base = 0;
      if (lane == unsigned(leader)) base = atomicAdd(next, __popc(want));
      base = __shfl_sync(kAll, base, leader);
      if (need) {
        i = (long long)(base + __popc(want & ((1u << lane) - 1u)));
        need = false;
        if (i < n) c = load_cell<T, kHeat>(in, i, t_iso, eps);
      }
    }
    const bool work = !need && i < n;
    if (!__any_sync(kAll, work)) break;
    if (!work) continue;

    bool finished = c.nit >= max_iter;
    if (!finished) {
      // one iteration of the cell's fixed point
      const T damp = c.nit >= damp_after ? damp_factor : T(0);
      if constexpr (kHeat) rates = rate_coefficients(c.avg_t);
      IonState<T> nw = doric_half(dt, c.ndens, c.clump, c.pHI, c.pHeI,
                                  c.pHeII, rates, c.ion, eps, one_m_eps,
                                  T(1));
      nw.cur = blend(nw.cur, c.ion.cur, damp);
      nw.avg = blend(nw.avg, c.ion.avg, damp);
      nw.old = blend(nw.old, c.ion.old, damp);
      // _chem_iteration: isothermal T stays temper0 == t_iso
      T temper1_new = c.temper0, avg_t_new = c.avg_t;
      if constexpr (kHeat) {
        const ThermalOut<T> th =
            thermal(dt, c.temper0, electrondens(c.ndens, nw.avg), c.ndens,
                    nw, c.pheat, cool, ccf);
        temper1_new = blend(th.end_t, c.temper1, damp);
        avg_t_new = blend(th.avg_t, c.avg_t, damp);
        sub_max = max(sub_max, th.nsub);
      }
      // _conv_freeze
      const bool done = conv(nw.avg.h0, c.ion.avg.h0) &&
                        conv(nw.avg.he0, c.ion.avg.he0) &&
                        conv(nw.avg.he2, c.ion.avg.he2) &&
                        xabs((temper1_new - c.temper1) / temper1_new) <
                            T(kMinFractionalChange);
      c.ion = nw;
      c.temper1 = temper1_new;
      c.avg_t = avg_t_new;
      ++c.nit;
      finished = done || c.nit >= max_iter;
    }
    if (finished) {
      // _finalize_pass
      const T st_t_av = in(kTAv, i);
      changed += big_change(c.ion.avg.h0, in(kHAv0, i)) ||
                 big_change(c.ion.avg.he0, in(kHeAv0, i)) ||
                 big_change(c.ion.avg.he2, in(kHeAv2, i)) ||
                 (xabs((st_t_av - c.avg_t) / c.avg_t) > T(0.1) &&
                  xabs(c.avg_t - st_t_av) > T(100));
      it_max = max(it_max, c.nit);
      const T vals[12] = {c.ion.cur.h0, c.ion.cur.h1, c.ion.cur.he0,
                          c.ion.cur.he1, c.ion.cur.he2, c.ion.avg.h0,
                          c.ion.avg.h1, c.ion.avg.he0, c.ion.avg.he1,
                          c.ion.avg.he2, c.temper1, c.avg_t};
      for (int k = 0; k < 12; ++k) out[(long long)k * n + i] = vals[k];
      need = true;
    }
  }
  changed = __reduce_add_sync(kAll, changed);
  it_max = __reduce_max_sync(kAll, it_max);
  if constexpr (kHeat) sub_max = __reduce_max_sync(kAll, sub_max);
  if (lane == 0) {
    if (changed) atomicAdd(&counters[0], changed);
    if (it_max > 0) atomicMax(&counters[1], it_max);
    if (kHeat && sub_max > 0) atomicMax(&counters[2], sub_max);
  }
}

template <typename T, bool kHeat>
int run_chemistry(const void* const* rows, const long long* strides,
                  const T* cool_tab, T* out, int* counters, long long n,
                  int sms, double dt, double t_iso, double ccf,
                  double epsilon, int max_iter, int damp_after,
                  double damp_factor, cudaStream_t stream) {
  Rows<T> in;
  for (int k = 0; k < kRows; ++k) {
    in.p[k] = static_cast<const T*>(rows[k]);
    in.stride[k] = strides[k];
  }
  const auto kernel = chemistry_kernel<T, kHeat>;
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kBlock, 0);
  if (err != cudaSuccess) return err;
  if (n <= 0) return cudaSuccess;
  const long long blocks =
      std::min<long long>((n + kBlock - 1) / kBlock,
                          (long long)std::max(per_sm, 1) * sms);
  kernel<<<unsigned(blocks), kBlock, 0, stream>>>(
      in, cool_tab, out, counters, n, T(dt), T(t_iso), T(ccf), T(epsilon),
      T(1.0 - epsilon), max_iter, damp_after, T(damp_factor));
  return cudaGetLastError();
}

}  // namespace
}  // namespace c2ray

extern "C" {

// Returns the cudaError_t of the launch (0 on success).  rows, strides:
// host arrays of the 23 input rows' device pointers and element strides
// (see Row); cool_tab: the (801, 5) cooling table (read by the heating
// variant only); counters: 6 ints, zero; sms: the card's SM count.
#define C2RAY_CHEM_ENTRY(NAME, T, HEAT)                                    \
  int NAME(const void* const* rows, const long long* strides,             \
           const T* cool_tab, T* out, int* counters, long long n, int sms, \
           double dt, double t_iso, double ccf, double epsilon,           \
           int max_iter, int damp_after, double damp_factor,              \
           void* stream) {                                                \
    return c2ray::run_chemistry<T, HEAT>(                                 \
        rows, strides, cool_tab, out, counters, n, sms, dt, t_iso, ccf,   \
        epsilon, max_iter, damp_after, damp_factor,                       \
        static_cast<cudaStream_t>(stream));                               \
  }

C2RAY_CHEM_ENTRY(chemistry_iso_f32, float, false)
C2RAY_CHEM_ENTRY(chemistry_iso_f64, double, false)
C2RAY_CHEM_ENTRY(chemistry_heat_f32, float, true)
C2RAY_CHEM_ENTRY(chemistry_heat_f64, double, true)

}  // extern "C"
