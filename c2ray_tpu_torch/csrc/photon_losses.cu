// Photon-loss redistribution: spread each band's escaped photon rate
// uniformly over the grid and add the per-ion rates it gives to the
// three photo-ionization rate grids, in place.
//
// Replaces c2ray_tpu/sweep/photon_losses.py: distribute_photon_losses
// (:45), two contractions there,
//
//     denom[c, b] = N[c, :] @ sig[:, b]          (n, 3) @ (3, nb)
//     dphi[c, s]  = (1 / denom)[c, :] @ W[:, s]  (n, nb) @ (nb, 3)
//
// with N the epsilon-floored neutral densities of a cell and
// W[b, s] = L_b sig_s(b) / (n V).  One thread per cell keeps its 3
// densities in registers and walks the bands: denom_b, its reciprocal,
// and the three sums dphi_s += W[b, s] / denom_b.  Neither (n, nb)
// intermediate exists.
//
// The caller passes sig divided by its largest value (and W built from
// that sig): the factor cancels in W / denom, and float32 then never
// meets a denominator that flushes to 0 (a 1e-30 floor times sig ~1e-18
// is below float32's range).
//
// Bound: memory.  Per cell 4 values read, 3 read and written: 10
// values, 84 MB at 128^3 in float32, 25 us at 3.35 TB/s.  The band loop
// costs as much again unless it is lean: 47 bands x 2M cells are 99M
// reciprocals (24 us on the special-function units), and every
// instruction per band costs ~2.2 us at the card's issue rate.  So:
//   - The (nb, 6) band table lies in the constant bank (packed from the
//     band escape by pack_kernel, then copied there on the launch's
//     stream: nothing waits for the host) and the band
//     loop is unrolled whole, in groups of 8 bands (kGroups, the table
//     padded with rows (1, 1, 1, 0, 0, 0) that add +0): no shared-memory
//     load and no loop branch.  The compiler reads the bank into
//     uniform registers (3 ULDC.64 a band), so a thread takes kCells
//     cells and shares them: a band costs 9 instructions a cell (the
//     3-term denominator, the reciprocal and its Newton step, 3 FFMAs)
//     and the 3 ULDCs once.
//   - The float32 reciprocal is MUFU.RCP refined by one Newton step
//     (within an ulp of IEEE 1 / x; the denominators are normal
//     numbers, at least 1e-30 times the smallest scaled sig), not the
//     compiler's IEEE division with its range check and slow-path
//     branch; float64 keeps 1.0 / x.
//   - The rate row read and written whole: with the sweep's (n, 4)
//     layout (rstride 4, the three grids one row, 16-byte aligned) a
//     cell's (phih, phihe0, phihe1, phiheat) is one 16-byte load and
//     one 16-byte store in float32 (two of each in float64), phiheat
//     written back with its own bits; any other layout takes three
//     strided read-modify-writes.
// The constant bank is one per library: two launches on two streams
// would race for it (the port runs on one stream).

#include "common.cuh"

namespace c2ray {
namespace {

constexpr int kBlock = 256;
// cells a thread takes: each band's table operands, loaded once into
// uniform registers (ULDC), serve them all
constexpr int kCells = 2;
constexpr int kBandGroup = 8;
constexpr int kMaxGroups = 6;
constexpr int kMaxBands = kBandGroup * kMaxGroups;   // 48

__constant__ float c_tab_f32[kMaxBands * 6];
__constant__ double c_tab_f64[kMaxBands * 6];

template <typename T>
__device__ __forceinline__ T tab(int k) {
  if constexpr (sizeof(T) == 4) {
    return c_tab_f32[k];
  } else {
    return c_tab_f64[k];
  }
}

__device__ __forceinline__ float recip(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return fmaf(r, fmaf(-x, r, 1.0f), r);
}
__device__ __forceinline__ double recip(double x) { return 1.0 / x; }

// the rate row of a cell as 16-byte words: float4, or two double2
template <typename T> struct Row4;
template <> struct Row4<float> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) {
    v = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ void store(float* p) const {
    *reinterpret_cast<float4*>(p) = v;
  }
  __device__ __forceinline__ void add(float a, float b, float c) {
    v.x += a; v.y += b; v.z += c;
  }
};
template <> struct Row4<double> {
  double2 lo, hi;
  __device__ __forceinline__ void load(const double* p) {
    lo = reinterpret_cast<const double2*>(p)[0];
    hi = reinterpret_cast<const double2*>(p)[1];
  }
  __device__ __forceinline__ void store(double* p) const {
    reinterpret_cast<double2*>(p)[0] = lo;
    reinterpret_cast<double2*>(p)[1] = hi;
  }
  __device__ __forceinline__ void add(double a, double b, double c) {
    lo.x += a; lo.y += b; hi.x += c;
  }
};

// c_tab: (kGroups * 8, 6) rows [sig_HI, sig_HeI, sig_HeII, W_HI, W_HeI,
// W_HeII]; whole_row: phih is the first word of 16-byte aligned rows of
// 4 (phihe0, phihe1 the next two).  A thread takes kCells cells, kBlock
// apart.
template <typename T, int kGroups>
__global__ void __launch_bounds__(kBlock)
photon_losses_kernel(const T* __restrict__ ndens, const T* __restrict__ h_av0,
                     const T* __restrict__ he_av0,
                     const T* __restrict__ he_av1, long long n, T floor,
                     T* phih, T* phihe0, T* phihe1, long long rstride,
                     bool whole_row) {
  const long long c0 = (long long)blockIdx.x * (kBlock * kCells) +
                       threadIdx.x;
  if (c0 >= n) return;
  T n0[kCells], n1[kCells], n2[kCells], d0[kCells], d1[kCells], d2[kCells];
#pragma unroll
  for (int j = 0; j < kCells; ++j) {
    // a cell past the end computes on cell c0 and stores nothing
    const long long c = c0 + j * kBlock < n ? c0 + j * kBlock : c0;
    const T nd = ndens[c];
    n0[j] = maxp(nd * h_av0[c] * T(1.0 - kAbuHe), floor);
    n1[j] = maxp(nd * he_av0[c] * T(kAbuHe), floor);
    n2[j] = maxp(nd * he_av1[c] * T(kAbuHe), floor);
    d0[j] = d1[j] = d2[j] = T(0);
  }
#pragma unroll
  for (int b = 0; b < kGroups * kBandGroup; ++b) {
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      const T inv = recip(n0[j] * tab<T>(6 * b) + n1[j] * tab<T>(6 * b + 1) +
                          n2[j] * tab<T>(6 * b + 2));
      d0[j] += inv * tab<T>(6 * b + 3);
      d1[j] += inv * tab<T>(6 * b + 4);
      d2[j] += inv * tab<T>(6 * b + 5);
    }
  }
#pragma unroll
  for (int j = 0; j < kCells; ++j) {
    const long long c = c0 + j * kBlock;
    if (c >= n) break;
    if (whole_row) {
      Row4<T> r;
      r.load(phih + 4 * c);
      r.add(d0[j], d1[j], d2[j]);
      r.store(phih + 4 * c);
    } else {
      phih[c * rstride] += d0[j];
      phihe0[c * rstride] += d1[j];
      phihe1[c * rstride] += d2[j];
    }
  }
}

// The band table from the band escape: one thread per (band, species),
// row b = [sig (3), W = (plb_b sig) / (n V) (3)] in float64 rounded once
// to T, W = 0 in the padding rows (photon_losses.py: band_table is its
// plain version).  sig: (rows, 3) float64, padded with ones.
template <typename T>
__global__ void pack_kernel(const T* __restrict__ plb,
                            const double* __restrict__ sig, int nb,
                            double nv, T* __restrict__ tab, int rows) {
  const int k = threadIdx.x;
  if (k >= 3 * rows) return;
  const int b = k / 3, s = k % 3;
  const double sg = sig[k];
  tab[6 * b + s] = T(sg);
  tab[6 * b + 3 + s] = b < nb ? T((double(plb[b]) * sg) / nv) : T(0);
}

template <typename T>
int run(const T* ndens, const T* h_av0, const T* he_av0, const T* he_av1,
        const T* plb, const double* sig, int nb, double nv, T* tab_dev,
        int rows, long long n, double floor, T* phih, T* phihe0, T* phihe1,
        long long rstride, cudaStream_t stream) {
  const int groups = rows / kBandGroup;
  if (rows % kBandGroup != 0 || groups < 1 || groups > kMaxGroups ||
      nb > rows)
    return cudaErrorInvalidValue;
  pack_kernel<T><<<1, 3 * rows, 0, stream>>>(plb, sig, nb, nv, tab_dev, rows);
  const size_t bytes = sizeof(T) * 6 * rows;
  cudaError_t err;
  if constexpr (sizeof(T) == 4) {
    err = cudaMemcpyToSymbolAsync(c_tab_f32, tab_dev, bytes, 0,
                                  cudaMemcpyDeviceToDevice, stream);
  } else {
    err = cudaMemcpyToSymbolAsync(c_tab_f64, tab_dev, bytes, 0,
                                  cudaMemcpyDeviceToDevice, stream);
  }
  if (err != cudaSuccess) return err;
  const bool whole = rstride == 4 && phihe0 == phih + 1 &&
                     phihe1 == phih + 2 &&
                     reinterpret_cast<unsigned long long>(phih) % 16 == 0;
  void (*kernel)(const T*, const T*, const T*, const T*, long long, T, T*,
                 T*, T*, long long, bool) = photon_losses_kernel<T, 6>;
  switch (groups) {
    case 1: kernel = photon_losses_kernel<T, 1>; break;
    case 2: kernel = photon_losses_kernel<T, 2>; break;
    case 3: kernel = photon_losses_kernel<T, 3>; break;
    case 4: kernel = photon_losses_kernel<T, 4>; break;
    case 5: kernel = photon_losses_kernel<T, 5>; break;
  }
  const unsigned blocks =
      unsigned((n + kBlock * kCells - 1) / (kBlock * kCells));
  kernel<<<blocks, kBlock, 0, stream>>>(ndens, h_av0, he_av0, he_av1, n,
                                        T(floor), phih, phihe0, phihe1,
                                        rstride, whole);
  return cudaGetLastError();
}

}  // namespace
}  // namespace c2ray

extern "C" {

// Returns the cudaError_t of the table copy and the launches (0 on
// success).  plb: the nb bands' escape; sig: (rows, 3) float64, rows a
// multiple of 8 up to 48; nv: n V; tab: (rows, 6) scratch that receives
// the packed table.
#define C2RAY_PLOSS_ENTRY(NAME, T)                                           \
  int NAME(const T* ndens, const T* h_av0, const T* he_av0,                 \
           const T* he_av1, const T* plb, const double* sig, int nb,        \
           double nv, T* tab, int rows, long long n, double floor, T* phih, \
           T* phihe0, T* phihe1, long long rstride, void* stream) {         \
    return c2ray::run<T>(ndens, h_av0, he_av0, he_av1, plb, sig, nb, nv,    \
                         tab, rows, n, floor, phih, phihe0, phihe1,         \
                         rstride, static_cast<cudaStream_t>(stream));       \
  }

C2RAY_PLOSS_ENTRY(photon_losses_f32, float)
C2RAY_PLOSS_ENTRY(photon_losses_f64, double)

}  // extern "C"
