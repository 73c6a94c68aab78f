// The device work of one rank of the x-slab domain decomposition around
// its windowed traces: the halo-extended field slab, the window adds
// into the halo-extended rate slab, and the fold of that slab back onto
// the rank's own cells.  The collectives between ranks (NCCL or gloo
// send/recv and all-reduce) are torch.distributed calls of the wrapper
// (c2ray_tpu_torch/parallel/halo.py); these kernels only copy and add.
//
// Replaces c2ray_tpu/parallel/domain.py:
//  - halo_pack: the stacked, epsilon-floored field channels
//    (:350-359), the x-halo concatenation of exchange_slab_halo (:81-97)
//    and _cyclic_pad on y and z (:130, :363-364).  Out (X, Y, Y, C) with
//    X = HL + NC + HR, Y = M + 2P: x planes [0, HL) from the received
//    left halo, then the rank's planes [c0, c0 + NC), then the right
//    halo; y and z wrap periodically by P.  With HL = HR = P = 0 it packs
//    the planes a rank sends.  A copy with a max: equal to its plain
//    version to the bit.
//  - window_accumulate: one source's dynamic_update_slice(rc, patch +
//    cube) of the source scan (:393-397).  One launch per source, in the
//    scan's order, each thread adding one value of a window row: the
//    same sums in the same order as JAX's scan, without atomics.
//  - fold_halo: _fold_cyclic on y then z (:137-148, :406-407), then the
//    local half of fold_slab_halo (:100-127, :408): the received x-halo
//    chunks added onto the rank's planes, in the order of its loop.
//    Per cell the y fold adds the tail pad then the head pad, the z fold
//    the same over y-folded values, as JAX's .at[].add sequence does, so
//    the result equals its plain version to the bit.  `planar` writes
//    the four rate grids de-interleaved (4, n, M, M) as domain.py:409-416
//    splits them; else interleaved (n, M, M, 4), the planes a rank sends.
//
// Bound: memory, all three.  halo_pack reads C values and writes C per
// output cell; window_accumulate reads the cube and reads and writes the
// window of rc; fold_halo reads up to 9 rc values per channel of an
// output cell (where the pads overlap the core) and the received
// chunks, and writes one.  Neighbouring threads touch neighbouring z
// (window_accumulate: neighbouring values of a window row).

#include "common.cuh"

namespace c2ray {
namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// Each kernel runs one block row per (plane, row) of its output --
// blockIdx.z the x plane, blockIdx.y the y row -- and its threads along
// the row, so no thread divides an index.

template <typename T>
__global__ void __launch_bounds__(kBlock)
halo_pack_kernel(const T* f0, const T* f1, const T* f2, const T* f3,
                 const T* f4, const T* lls, int C, const T* left,
                 const T* right, int M, int HL, int c0, int NC, int P,
                 T eps, T* out) {
  const int Y = M + 2 * P;
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  if (z >= Y) return;
  const int x = blockIdx.z, y = blockIdx.y;
  const long long yz = (long long)wrap(y - P, M) * M + wrap(z - P, M);
  T* o = out + (((long long)x * Y + y) * Y + z) * C;
  if (x < HL) {
    const T* s = left + ((long long)x * M * M + yz) * C;
    for (int c = 0; c < C; ++c) o[c] = s[c];
  } else if (x < HL + NC) {
    const long long cell = (long long)(c0 + x - HL) * M * M + yz;
    o[0] = f0[cell];
    o[1] = maxp(f1[cell], eps);
    o[2] = maxp(f2[cell], eps);
    o[3] = maxp(f3[cell], eps);
    o[4] = maxp(f4[cell], eps);
    if (C > 5) o[5] = lls[cell];
  } else {
    const T* s = right + ((long long)(x - HL - NC) * M * M + yz) * C;
    for (int c = 0; c < C; ++c) o[c] = s[c];
  }
}

// a thread per value of a window row (Mw cells x 4 channels)
template <typename T>
__global__ void __launch_bounds__(kBlock)
window_accumulate_kernel(T* rc, const T* cube, int Y, int Z, int Mw, int s0,
                         int s1, int s2) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= 4 * Mw) return;
  const int a = blockIdx.z, b = blockIdx.y;
  T* r = rc + (((long long)(s0 + a) * Y + (s1 + b)) * Z + s2) * 4 + v;
  *r = *r + cube[((long long)a * Mw + b) * Mw * 4 + v];
}

// the y-folded value of rc at plane x, row y (core coordinates), padded
// column zz: the core, plus the tail pad where y >= M - P, plus the head
// pad where y < P
template <typename T>
__device__ __forceinline__ T fold_y(const T* plane, int Y, int M, int P,
                                    int y, int zz, int ch) {
  T v = plane[((long long)(y + P) * Y + zz) * 4 + ch];
  if (y >= M - P) v = v + plane[((long long)(y - (M - P)) * Y + zz) * 4 + ch];
  if (y < P) v = v + plane[((long long)(y + P + M) * Y + zz) * 4 + ch];
  return v;
}

// chunks: nchunk rows (first plane in recv, first local plane, planes)
template <typename T>
__global__ void __launch_bounds__(kBlock)
fold_halo_kernel(const T* rc, int M, int P, int x0, int nx, const T* recv,
                 const int* chunks, int nchunk, int planar, T* out) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  if (z >= M) return;
  const int x = blockIdx.z, y = blockIdx.y;
  const int Y = M + 2 * P;
  const long long mm = (long long)M * M;
  const long long n = (long long)nx * mm;
  const long long i = x * mm + (long long)y * M + z;
  const T* plane = rc + (long long)(x0 + x) * Y * Y * 4;
  for (int ch = 0; ch < 4; ++ch) {
    T v = fold_y(plane, Y, M, P, y, z + P, ch);
    if (z >= M - P) v = v + fold_y(plane, Y, M, P, y, z - (M - P), ch);
    if (z < P) v = v + fold_y(plane, Y, M, P, y, z + P + M, ch);
    for (int k = 0; k < nchunk; ++k) {
      const int b0 = chunks[3 * k], lo = chunks[3 * k + 1];
      if (x >= lo && x < lo + chunks[3 * k + 2]) {
        v = v + recv[((long long)(b0 + x - lo) * mm + (long long)y * M + z) *
                         4 + ch];
      }
    }
    out[planar ? ch * n + i : i * 4 + ch] = v;
  }
}

dim3 grid_for(int row, int rows, int planes) {
  return dim3((row + kBlock - 1) / kBlock, rows, planes);
}

}  // namespace
}  // namespace c2ray

extern "C" {

// Each entry returns the cudaError_t of its launch (0 on success); the
// planes and rows of a launch are at most 65535 each.
#define C2RAY_HALO_ENTRIES(SFX, T)                                            \
  int halo_pack_##SFX(const T* f0, const T* f1, const T* f2, const T* f3,     \
                      const T* f4, const T* lls, int C, const T* left,        \
                      const T* right, int M, int HL, int c0, int NC, int HR,  \
                      int P, double eps, T* out, void* stream) {              \
    const int Y = M + 2 * P;                                                  \
    c2ray::halo_pack_kernel<T>                                                \
        <<<c2ray::grid_for(Y, Y, HL + NC + HR), c2ray::kBlock, 0,             \
           static_cast<cudaStream_t>(stream)>>>(f0, f1, f2, f3, f4, lls, C,   \
                                                left, right, M, HL, c0, NC,   \
                                                P, T(eps), out);              \
    return cudaGetLastError();                                                \
  }                                                                           \
  int window_accumulate_##SFX(T* rc, const T* cube, int X, int Y, int Z,      \
                              int Mw, int s0, int s1, int s2, void* stream) { \
    (void)X;                                                                  \
    c2ray::window_accumulate_kernel<T>                                        \
        <<<c2ray::grid_for(4 * Mw, Mw, Mw), c2ray::kBlock, 0,                 \
           static_cast<cudaStream_t>(stream)>>>(rc, cube, Y, Z, Mw, s0, s1,   \
                                                s2);                          \
    return cudaGetLastError();                                                \
  }                                                                           \
  int fold_halo_##SFX(const T* rc, int M, int P, int x0, int nx,              \
                      const T* recv, const int* chunks, int nchunk,           \
                      int planar, T* out, void* stream) {                     \
    c2ray::fold_halo_kernel<T>                                                \
        <<<c2ray::grid_for(M, M, nx), c2ray::kBlock, 0,                       \
           static_cast<cudaStream_t>(stream)>>>(rc, M, P, x0, nx, recv,       \
                                                chunks, nchunk, planar, out); \
    return cudaGetLastError();                                                \
  }

C2RAY_HALO_ENTRIES(f32, float)
C2RAY_HALO_ENTRIES(f64, double)

}  // extern "C"
