// The sum of a source group's rate slabs into the rate grids: for every
// cell, the slabs of the group's live sources added in source order, and
// that group sum added into the grids in place.
//
// Replaces no TPU kernel: it is the glue of
// c2ray_tpu/sweep/pyramid_sweep.py:sweep_pyramid_source_batch (:496), the
// masked sum over a group's sources that XLA fuses there, which PyTorch
// runs as three passes (a where-copy of the slabs, a reduction, an add).
// Its plain twin is sweep/pyramid_sweep.py:accumulate_group_plain.
//
// Order: a cell's group sum starts at 0 and adds each source's value in
// source order, 0 for a source the mask drops (torch.where's 0.0), then
// rg += sum; the caller adds its groups in order.  No atomics, so the
// grids are the same bits on every run.
//
// Bound: bytes.  Each live source's slab is read once, the grids are read
// and written once, nothing else: (live + 2) * M^3 * 4 * sizeof(T) at
// 3.35 TB/s (2.5 GB, 0.75 ms at 250^3 x 8 float32).  The design: a
// thread owns one 16-byte word of a cell's row (a float4, or half a
// double row), so each warp reads 512 consecutive bytes of a slab; a
// chunk of kChunk sources' loads is issued before any of them is added,
// so each thread keeps up to 128 bytes in flight; the slabs are read
// with the streaming hint (read once, not kept in L2); one word a thread
// gives every SM full occupancy over the whole grid (61k blocks at 250^3
// float32).  A dropped source's slab is not read.

#include <cstddef>
#include <cuda_runtime.h>

namespace c2ray {
namespace {

constexpr int kBlock = 256;
constexpr int kChunk = 8;

__device__ __forceinline__ float4 zero_word(float4) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ double2 zero_word(double2) {
  return make_double2(0.0, 0.0);
}
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ double2 add(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}

// V: the 16-byte word (float4 or double2); n: words in one grid
template <typename V>
__global__ void __launch_bounds__(kBlock)
group_accumulate_kernel(V* __restrict__ rg, const V* __restrict__ slab,
                        const bool* __restrict__ live, int S, size_t n) {
  const size_t w = size_t(blockIdx.x) * kBlock + threadIdx.x;
  if (w >= n) return;
  const V zero = zero_word(V{});
  V acc = zero;
  for (int s0 = 0; s0 < S; s0 += kChunk) {
    V v[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int s = s0 + j;
      v[j] = (s < S && live[s]) ? __ldcs(slab + size_t(s) * n + w) : zero;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (s0 + j < S) acc = add(acc, v[j]);
    }
  }
  rg[w] = add(rg[w], acc);
}

template <typename V>
int run_accumulate(void* rg, const void* slab, const bool* live, int S,
                   long long n, cudaStream_t stream) {
  if (S < 1 || n < 1) return cudaErrorInvalidValue;
  const long long blocks = (n + kBlock - 1) / kBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  group_accumulate_kernel<V><<<unsigned(blocks), kBlock, 0, stream>>>(
      static_cast<V*>(rg), static_cast<const V*>(slab), live, S, size_t(n));
  return cudaGetLastError();
}

}  // namespace
}  // namespace c2ray

extern "C" {

// rg (M^3, 4) += the live sources' rows of slab (S, M^3, 4), both
// contiguous and 16-byte aligned; `live` (S,) bools on the device;
// `words` = M^3 * 4 * sizeof(T) / 16.  Returns the launch's cudaError_t.
int group_accumulate_f32(void* rg, const void* slab, const bool* live, int S,
                         long long words, void* stream) {
  return c2ray::run_accumulate<float4>(rg, slab, live, S, words,
                                       static_cast<cudaStream_t>(stream));
}

int group_accumulate_f64(void* rg, const void* slab, const bool* live, int S,
                         long long words, void* stream) {
  return c2ray::run_accumulate<double2>(rg, slab, live, S, words,
                                        static_cast<cudaStream_t>(stream));
}

}  // extern "C"
