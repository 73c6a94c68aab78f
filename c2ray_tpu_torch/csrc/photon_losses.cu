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
// and the three sums dphi_s += W[b, s] / denom_b, the (3 + 3) x nb table
// in shared memory.  Neither (n, nb) intermediate exists.  The sums are
// added in place to phih / phihe0 / phihe1 (strided views of the
// sweep's (n, 4) rate grid), which saves three n-value temporaries and
// their reads.
//
// The caller passes sig divided by its largest value (and W built from
// that sig): the factor cancels in W / denom, and float32 then never
// meets a denominator that flushes to 0 (a 1e-30 floor times sig ~1e-18
// is below float32's range).
//
// Bound: memory.  Per cell 4 values read, 3 read and written: 10
// values, 84 MB at 128^3 in float32, 25 us at 3.35 TB/s; the nb
// reciprocals per cell (99M at 47 bands) take about as long on the
// special-function units.

#include "common.cuh"

namespace c2ray {
namespace {

constexpr int kBlock = 256;

// tab: (nb, 6) rows [sig_HI, sig_HeI, sig_HeII, W_HI, W_HeI, W_HeII]
template <typename T>
__global__ void __launch_bounds__(kBlock)
photon_losses_kernel(const T* ndens, const T* h_av0, const T* he_av0,
                     const T* he_av1, const T* tab_g, int nb, long long n,
                     T floor, T* phih, T* phihe0, T* phihe1,
                     long long rstride) {
  extern __shared__ unsigned char smem[];
  T* tab = reinterpret_cast<T*>(smem);
  for (int i = threadIdx.x; i < 6 * nb; i += blockDim.x) tab[i] = tab_g[i];
  __syncthreads();
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const T nd = ndens[c];
  const T n0 = maxp(nd * h_av0[c] * T(1.0 - kAbuHe), floor);
  const T n1 = maxp(nd * he_av0[c] * T(kAbuHe), floor);
  const T n2 = maxp(nd * he_av1[c] * T(kAbuHe), floor);
  T d0 = T(0), d1 = T(0), d2 = T(0);
  for (int b = 0; b < nb; ++b) {
    const T* r = tab + 6 * b;
    const T inv = T(1) / (n0 * r[0] + n1 * r[1] + n2 * r[2]);
    d0 += inv * r[3];
    d1 += inv * r[4];
    d2 += inv * r[5];
  }
  phih[c * rstride] += d0;
  phihe0[c * rstride] += d1;
  phihe1[c * rstride] += d2;
}

template <typename T>
int run(const T* ndens, const T* h_av0, const T* he_av0, const T* he_av1,
        const T* tab, int nb, long long n, double floor, T* phih, T* phihe0,
        T* phihe1, long long rstride, cudaStream_t stream) {
  const size_t smem = size_t(6) * nb * sizeof(T);
  const long long blocks = (n + kBlock - 1) / kBlock;
  photon_losses_kernel<T><<<unsigned(blocks), kBlock, smem, stream>>>(
      ndens, h_av0, he_av0, he_av1, tab, nb, n, T(floor), phih, phihe0,
      phihe1, rstride);
  return cudaGetLastError();
}

}  // namespace
}  // namespace c2ray

extern "C" {

// Returns the cudaError_t of the launch (0 on success).
#define C2RAY_PLOSS_ENTRY(NAME, T)                                           \
  int NAME(const T* ndens, const T* h_av0, const T* he_av0,                 \
           const T* he_av1, const T* tab, int nb, long long n, double floor,\
           T* phih, T* phihe0, T* phihe1, long long rstride, void* stream) { \
    return c2ray::run<T>(ndens, h_av0, he_av0, he_av1, tab, nb, n, floor,   \
                         phih, phihe0, phihe1, rstride,                     \
                         static_cast<cudaStream_t>(stream));                \
  }

C2RAY_PLOSS_ENTRY(photon_losses_f32, float)
C2RAY_PLOSS_ENTRY(photon_losses_f64, double)

}  // extern "C"
