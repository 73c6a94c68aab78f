// Pyramid short-characteristics sweep of a source batch, with the
// quadrature band rates as a device function (cell_rates of
// csrc/band_rates.cuh, shared with the 1D march): the isothermal variant,
// the heating variant (template flag kHeat), each with the band-resolved
// escape (template flag kTrack) or without, and each with a per-cell LLS
// column (a nullable pointer) or the homogeneous one.
//
// Replaces c2ray_tpu/sweep/pyramid_sweep.py: trace_centered (:116) and
// sweep_pyramid_source_batch (:496), with
// c2ray_tpu/radiation/quadrature.py: _attenuation (:324) and
// _one_source_quad (:330) -- its isothermal branch, and with kHeat its
// heating branch too (:401-449: per-species thick/thin heating, the
// Ricotti y1R/y2R secondary ionization and heating); with kTrack its
// track_bands output (:388-394, pyramid_sweep.py:289-295); with the LLS
// pointer the per-cell LLS channel (pyramid_sweep.py:170,256-267).
//
// Algorithm (the same as the plain version in pyramid_sweep.py): every
// source owns an outgoing-column cube cd[s] (M^3 x 3, source-centred,
// not zeroed: every cell is written before it is read; index ctr +
// offset with ctr = M/2 - 1).  Layers
// l = 1..Rf run in order; within a layer the x, y, z stages run in
// order, one launch each over (source, sign, u, v).  A stage-m cell at
// |offset_m| = l reads its four cinterp corners on layer l-1 along m,
// shifted toward the source by 0 or 1 in u and v; the stage order
// guarantees those cells are already written.  Rates go to a
// per-source slab in absolute coordinates ((srcpos + offset) mod M is a
// bijection for offsets in -(M/2-1)..M/2), summed over sources by the
// caller in fixed order.  Photon and LLS losses are reduced per block
// into a partials buffer, summed in fixed order by the caller: no
// float atomics, so the sweep is deterministic.
//
// Bound: the SFU's exponentials, 2K per live band, cell and source (396
// at the bench's 33 blackbody bands and K = 6: 1.589 ms at 128^3 x 8),
// not memory (each cell reads 4 corner 3-vectors and 5 fields); the
// band tables sit in shared memory.  What held the earlier design (one
// thread per cell, a runtime-K node loop) at 7x that bound (12x with
// heating) was instruction issue: its band loop (`sass_band_mix` of
// chip_smoke.py on the float32 SASS, K = 6) took ~280 instructions per
// band isothermal and ~480 with heating around 12 MUFU.EX2, with 4
// (heating 7 and more) IEEE divisions per band; and one thread walked
// all 33 bands of a cell.  The design:
//   - band_rates.cuh's band loop: K a template parameter (with_nodes: 6
//     and 8 unrolled, any other K at run time), 1/vol once per cell, only
//     the node sums a band's regime reads.  Now 199 instructions per
//     band isothermal, 292 with heating: 12 MUFU.EX2, one MUFU.RCP (the
//     tau share).  The exponential stays the plain version's expf (why:
//     band_rates.cuh).
//   - kCellLanes = 2 lanes per cell, by measurement
//     (tools/profile_torch_iteration.py --lanes 1,2,4,8, in turns; H100
//     80GB HBM3, 700 W, 128^3 x 8 f32, stage kernel ms for G = 1, 2, 4,
//     8: isothermal 7.85, 7.80, 9.25, 12.87; heating 10.63, 10.77, 12.94,
//     18.16; the shell kernel's in shell_sweep.cu).  Each lane of a group
//     repeats the cell's corner reads, interpolation, columns, Ricotti
//     terms and index arithmetic (the same bits in every lane), which
//     costs more than the band split gains beyond two lanes (one lane
//     is 1% faster here with heating, 5% slower in the shell kernel, so
//     both kernels take two).  Each lane
//     sums the bands b = lane, lane + G, ... of every type; the partial
//     sums meet in group_sum's fixed butterfly; lane 0 writes cd, the
//     slab and the losses; with kTrack each lane stages its own bands.
//     The stage grid is G threads per cell.
//   - the losses reduce per block by warp butterflies (block_sum), not a
//     shared-memory tree with a barrier per level.
//   - each kernel opts in to the shared memory it needs only above the
//     default 48 KB (allow_smem): an opt-in at the exact size of a
//     smaller table left a later, larger one unable to launch.
// Measured (chip_smoke.py, same card, the main path's states): stage
// kernel 7.61 ms isothermal (before: 10.99), 11.20 ms heating (before:
// 18.77); of the sweep's CUDA-event time the 192 launches' device time
// leaves 0.42 and 0.36 ms (5.5%, 3.2%) to launch gaps and the sweep's
// other work (phase 22); layers 1-16 take 0.60 and 0.93 ms of it.  The
// heating table row holds 17 + 5K values (47 at K = 6): up to 53 KB for
// 141 bands in f64, above the default 48 KB, so the kernels may opt in
// to the card's 227 KB.
//
// Per-cell LLS: the cell being entered adds lls[cell] * path_units to
// its incoming HI column and loses phi_in (1 - e^-tau_LLS) to the fog,
// as the homogeneous column does; one load per cell, no exponential
// more than the homogeneous path (the expm1 of the LLS loss).
//
// Band tracking (kTrack): a live cell on the trace boundary (the only
// cells whose escape counts) stages its outgoing photon rate per band
// (phi_in - phi_all, summed over the source types that share a band,
// / vol_ratio) in a shared [nb_all][kBlock] array; a block holding such
// a cell reduces the array by a fixed tree into its per-block partial
// (S, nslots, nb_all), which the caller sums in fixed order:
// deterministic, no float atomics.  Boundary cells lie only in the last
// layer or two, so every other block skips the staging and the
// reduction after one __syncthreads_or (a reduction in every block cost
// +24% of the isothermal stage kernels at 128^3 x 8).  nb_all * kBlock
// values of shared memory (96 KB in float64 at 47 bands).

// The rate routes (kK, csrc/table_rates.cuh): kTableRoute replaces
// c2ray_tpu/radiation/photo.py:photoion_rates (:185) in the stage and
// source-cell kernels -- per cell, band and source type the tau
// positions and the band-major table records (table_rates), bound by
// those operations (the tables sit in L2); kBlockRoute the "auto" quadrature's sum
// over its node groups (quadrature.py:486-489, block_rates), bound like
// the fixed rule by the 2 sum(nb K) exponentials.  Both run with the
// homogeneous or the per-cell LLS column, not with kTrack.

#include "table_rates.cuh"

namespace c2ray {
namespace {

constexpr int kBlock = 256;
constexpr double kSqrt2 = 1.4142135623730951;
constexpr double kSqrt3 = 1.7320508075688772;
constexpr double kMinWeightDenom = 0.6;

template <typename T>
struct Params {
  const T* fields;    // (M^3, 5): ndens, h_av0, h_av1, he_av0, he_av1
  const int* srcpos;  // (S, 3)
  const T* nflux;     // (S, 3)
  const T* bands;     // (nbt, stride) live bands of every source type
  const T* lls;       // (M^3) per-cell LLS columns, or null
  T* cd;              // (S, M, M, M, 3) outgoing columns
  T* slab;            // (S, M^3, 4) per-source rates, zeroed off the box
  T* partials;        // (S, nslots, 2) photon / LLS loss per block
  T* band_partials;   // (S, nslots, nb_all) band escape per block (kTrack)
  int M, S, Rf, Rb, nslots, nbt, nb_all;
  BandTables bt;   // the packed band rows' layout
  T dr, vol_over_scale, coldensh_lls, max_coldensh;
  RouteTables<T> rt;   // the tau-table or block route's (kK < 0)
};

__device__ __forceinline__ int wrap(int x, int M) {
  if (x >= 0 && x < M) return x;
  if (x < 0 && x >= -M) return x + M;   // within a period: no division
  if (x >= M && x < 2 * M) return x - M;
  const int r = x % M;
  return r < 0 ? r + M : r;
}

// neutral columns per unit length at an absolute cell:
// stack([h_av0, he_av0, he_av1]) * ndens * abu
template <typename T>
__device__ __forceinline__ void base_cols(const T* f, T bc[3]) {
  bc[0] = f[1] * f[0] * T(1.0 - kAbuHe);
  bc[1] = f[3] * f[0] * T(kAbuHe);
  bc[2] = f[4] * f[0] * T(kAbuHe);
}

// Source cell (evolve_point.F90:140-151): seeds cd with the half-cell
// columns and writes the source cell's own rates (its heat unmasked,
// c2ray_tpu/sweep/pyramid_sweep.py:444); kK: the route
// (table_rates.cuh), 0 the fixed rule.
template <typename T, bool kHeat, int kK>
__global__ void source_cell_kernel(Params<T> p) {
  extern __shared__ unsigned char smem[];
  T* tab = reinterpret_cast<T*>(smem);
  load_route_rows<T, kHeat, kK>(p.bands, p.nbt, p.bt, route_of<kK>(p.rt),
                                tab);
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= p.S) return;
  const int M = p.M, ctr = M / 2 - 1;
  const int* sp = p.srcpos + 3 * s;
  const size_t flat =
      (size_t(wrap(sp[0], M)) * M + wrap(sp[1], M)) * M + wrap(sp[2], M);
  const T* f = p.fields + flat * 5;
  T bc[3], cc0[3];
  base_cols(f, bc);
  const T half_dr = T(0.5) * p.dr;
  for (int c = 0; c < 3; ++c) cc0[c] = bc[c] * half_dr;
  T* cd0 = p.cd + ((((size_t)s * M + ctr) * M + ctr) * M + ctr) * 3;
  for (int c = 0; c < 3; ++c) cd0[c] = cc0[c];
  const T zero3[3] = {T(0), T(0), T(0)};
  T y[6];
  if constexpr (kHeat) ricotti(f[2], y);
  T r[kHeat ? 6 : 5];
  route_rates<T, kHeat, false, kK>(
      tab, p.bt, route_of<kK>(p.rt), p.nflux + 3 * s, zero3, cc0,
      p.vol_over_scale, y, r, nullptr);
  T* out = p.slab + ((size_t)s * M * M * M + flat) * 4;
  out[0] = r[0] / bc[0];
  out[1] = r[1] / bc[1];
  out[2] = r[2] / bc[2];
  if constexpr (kHeat) {
    out[3] = r[5];
  } else {
    out[3] = T(0);
  }
}

// One (layer l, stage m) step: a group of kCellLanes lanes per (sign,
// u, v) of the plane pair |offset_m| = l, blockIdx.y = source; the table
// has kK nodes (0: p.bt.K at run time), or kK names the route
// (table_rates.cuh; kTrack on the fixed rule only).  The arithmetic is
// compute_stage (pyramid_sweep.py:205-310).
template <typename T, bool kHeat, bool kTrack, int kK>
__device__ __forceinline__ void stage_body(const Params<T>& p, int l, int m,
                                           int slot0) {
  extern __shared__ unsigned char smem[];
  T* tab = reinterpret_cast<T*>(smem);
  T* red = tab + route_tab_len<T, kHeat, kK>(
                     p.nbt, p.bt, route_of<kK>(p.rt));   // 2 * kBlock
  T* bst = red + 2 * kBlock;                       // nb_all * kBlock (kTrack)
  T* mine = bst + threadIdx.x;                     // this thread's column
  load_route_rows<T, kHeat, kK>(p.bands, p.nbt, p.bt, route_of<kK>(p.rt),
                                tab);

  const int s = blockIdx.y;
  const int M = p.M, ctr = M / 2 - 1;
  const int W = 2 * l + 1;
  // the cell of this lane's group (uniform over the group) and the lane
  const int idx = (blockIdx.x * blockDim.x + threadIdx.x) / kCellLanes;
  const int lane = threadIdx.x % kCellLanes;
  T ploss = T(0), lloss = T(0);
  bool contrib = false;   // a live boundary cell: its escape counts

  if (idx < 2 * W * W) {
    const bool fwd = idx < W * W;
    const int rem = fwd ? idx : idx - W * W;
    const int u = rem / W - l, v = rem % W - l;
    // window per stage: x |b|,|c| <= l-1; y |a| <= l, |c| <= l-1;
    // z |a|,|b| <= l; offsets within -Rb..Rf
    const int lim_u = (m == 0) ? l - 1 : l;
    const int lim_v = (m == 2) ? l : l - 1;
    const bool valid = abs(u) <= lim_u && abs(v) <= lim_v &&
                       u >= -p.Rb && u <= p.Rf && v >= -p.Rb && v <= p.Rf &&
                       (fwd ? l <= p.Rf : l <= p.Rb);
    if (valid) {
      const int sg = fwd ? 1 : -1;
      const int au = (m == 0) ? 1 : 0;   // axis of u
      const int av = (m == 2) ? 1 : 2;   // axis of v
      const int su = (u > 0) - (u < 0), sv = (v > 0) - (v < 0);
      auto cd_at = [&](int om, int ou, int ov) -> T* {
        int q[3];
        q[m] = om; q[au] = ou; q[av] = ov;
        return p.cd +
               ((((size_t)s * M + ctr + q[0]) * M + ctr + q[1]) * M +
                ctr + q[2]) * 3;
      };
      const int om = sg * (l - 1);
      const T* c4 = cd_at(om, u, v);             // W
      const T* c3 = cd_at(om, u - su, v);        // C_mu
      const T* c2 = cd_at(om, u, v - sv);        // C_mv
      const T* c1 = cd_at(om, u - su, v - sv);   // C_mm

      const T lf = T(l);
      const T d_u = T(abs(u)), d_v = T(abs(v));
      const T alam = (lf - T(0.5)) / lf;
      const T du = T(2) * xabs(alam * d_u - (d_u - T(0.5)));
      const T dv = T(2) * xabs(alam * d_v - (d_v - T(0.5)));
      const T s1 = (T(1) - du) * (T(1) - dv);
      const T s2 = du * (T(1) - dv);
      const T s3 = (T(1) - du) * dv;
      const T s4 = du * dv;
      const T sig[3] = {T(kSigmaHI), T(kSigmaHeI), T(kSigmaHeII)};
      const T wmin = T(kMinWeightDenom);
      const bool on_diag = (l == 1) && (abs(u) == 1 || abs(v) == 1);
      const bool full_diag = abs(u) == 1 && abs(v) == 1;
      const T boost = on_diag ? (full_diag ? T(kSqrt3) : T(kSqrt2)) : T(1);
      T cin[3];
      for (int c = 0; c < 3; ++c) {
        const T w1 = s1 / maxp(c1[c] * sig[c], wmin);
        const T w2 = s2 / maxp(c2[c] * sig[c], wmin);
        const T w3 = s3 / maxp(c3[c] * sig[c], wmin);
        const T w4 = s4 / maxp(c4[c] * sig[c], wmin);
        const T wsum = w1 + w2 + w3 + w4;
        cin[c] = (c1[c] * w1 + c2[c] * w2 + c3[c] * w3 + c4[c] * w4) / wsum;
        cin[c] = cin[c] * boost;
      }
      const T path_units = xsqrt((d_u * d_u + d_v * d_v) / (lf * lf) + T(1));
      const T path = path_units * p.dr;

      int o[3];
      o[m] = sg * l; o[au] = u; o[av] = v;
      const int* sp = p.srcpos + 3 * s;
      const size_t flat = (size_t(wrap(sp[0] + o[0], M)) * M +
                           wrap(sp[1] + o[1], M)) * M + wrap(sp[2] + o[2], M);
      // LLS column of the cell being entered, or the homogeneous one
      const bool has_lls = p.lls != nullptr || p.coldensh_lls > T(0);
      const T lls_add =
          (p.lls != nullptr ? p.lls[flat] : p.coldensh_lls) * path_units;
      if (has_lls) cin[0] += lls_add;
      const T* f = p.fields + flat * 5;
      T bc[3], cout[3];
      base_cols(f, bc);
      for (int c = 0; c < 3; ++c) cout[c] = cin[c] + bc[c] * path;

      const T dist2 = d_u * d_u + d_v * d_v + lf * lf;
      const T vol_ratio = T(4.0 * kPi) * dist2 * path_units;
      const bool live = cin[0] < p.max_coldensh;
      const bool on_bound = u == p.Rf || u == -p.Rb || v == p.Rf ||
                            v == -p.Rb || (fwd ? l == p.Rf : l == p.Rb);
      contrib = live && on_bound;
      if constexpr (kTrack) {
        if (contrib) {
          for (int b = 0; b < p.nb_all; ++b) mine[b * kBlock] = T(0);
        }
      }
      T y[6];
      if constexpr (kHeat) ricotti(f[2], y);
      // this lane's bands, then the group's sum: the same bits on every
      // lane of the group
      constexpr int kOut = kHeat ? 6 : 5;
      T r[kOut];
      route_rates<T, kHeat, kTrack, kK, kBlock>(
          tab, p.bt, route_of<kK>(p.rt), p.nflux + 3 * s, cin, cout,
          vol_ratio * p.vol_over_scale, y, r, contrib ? mine : nullptr, lane,
          kCellLanes);
      for (int q = 0; q < kOut; ++q) r[q] = group_sum<kCellLanes>(r[q]);
      if constexpr (kTrack) {
        if (contrib) {
          for (int b = 0; b < p.nb_all; ++b) mine[b * kBlock] /= vol_ratio;
        }
      }

      if (lane == 0) {
        const T fl = live ? T(1) : T(0);
        T* out = p.slab + ((size_t)s * M * M * M + flat) * 4;
        out[0] = fl * r[0] / bc[0];
        out[1] = fl * r[1] / bc[1];
        out[2] = fl * r[2] / bc[2];
        if constexpr (kHeat) {
          out[3] = fl * r[5];
        } else {
          out[3] = T(0);
        }
        if (contrib) ploss = r[4] / vol_ratio;
        if (live && has_lls) {
          const T tau_lls = T(kSigmaHI) * lls_add;
          lloss = r[3] / vol_ratio * (-xexpm1(-tau_lls));
        }
        T* dst = cd_at(sg * l, u, v);
        for (int c = 0; c < 3; ++c) dst[c] = cout[c];
      }
    }
  }

  // deterministic block reduction of the two losses
  const T pl = block_sum<T, kBlock>(red, ploss);
  const T ll = block_sum<T, kBlock>(red, lloss);
  if (threadIdx.x == 0) {
    T* dst = p.partials + ((size_t)s * p.nslots + slot0 + blockIdx.x) * 2;
    dst[0] = pl;
    dst[1] = ll;
  }
  if constexpr (kTrack) {
    // only a block with a live boundary cell has band escape; the
    // others leave their partial at the caller's zero (the condition is
    // uniform over the block, so the barriers below are safe)
    if (__syncthreads_or(contrib)) {
      if (!contrib) {
        for (int b = 0; b < p.nb_all; ++b) mine[b * kBlock] = T(0);
      }
      __syncthreads();
      // the same fixed tree over each band's column
      for (int w = kBlock / 2; w > 0; w >>= 1) {
        for (int i = threadIdx.x; i < p.nb_all * w; i += kBlock) {
          const int b = i / w, j = i - b * w;
          bst[b * kBlock + j] += bst[b * kBlock + j + w];
        }
        __syncthreads();
      }
      T* dst = p.band_partials +
               ((size_t)s * p.nslots + slot0 + blockIdx.x) * p.nb_all;
      for (int b = threadIdx.x; b < p.nb_all; b += kBlock) {
        dst[b] = bst[b * kBlock];
      }
    }
  }
}

template <typename T, bool kHeat, bool kTrack, int kK>
__global__ void __launch_bounds__(kBlock)
stage_kernel(Params<T> p, int l, int m, int slot0) {
  stage_body<T, kHeat, kTrack, kK>(p, l, m, slot0);
}

// the route_capped instantiations (table_rates.cuh)
template <typename T, bool kHeat, bool kTrack, int kK>
__global__ void __launch_bounds__(kBlock, kCappedBlocks)
stage_kernel_capped(Params<T> p, int l, int m, int slot0) {
  stage_body<T, kHeat, kTrack, kK>(p, l, m, slot0);
}

inline int stage_blocks(int l) {
  const int W = 2 * l + 1;
  return (2 * W * W * kCellLanes + kBlock - 1) / kBlock;
}

template <typename T, bool kHeat, bool kTrack>
int run_sweep(const T* fields, const int* srcpos, const T* nflux,
              const T* bands, const T* lls, T* cd, T* slab, T* partials,
              T* band_partials, int M, int S, int Rf, int Rb, int K,
              int ntypes, int nb_all, const int cols[3], const int nbs[3],
              const int los[3], double dr, double vol_over_scale,
              double coldensh_lls, double max_coldensh, const int* route,
              const T* photo, const T* heat_tab, const int* hbin,
              cudaStream_t stream) {
  Params<T> p;
  p.fields = fields; p.srcpos = srcpos; p.nflux = nflux; p.bands = bands;
  p.lls = lls; p.cd = cd; p.slab = slab; p.partials = partials;
  p.band_partials = band_partials;
  p.M = M; p.S = S; p.Rf = Rf; p.Rb = Rb; p.bt.K = K; p.bt.ntypes = ntypes;
  p.nb_all = nb_all;
  p.nbt = 0;
  for (int t = 0; t < 3; ++t) {
    p.bt.type_col[t] = t < ntypes ? cols[t] : 0;
    p.bt.type_nb[t] = t < ntypes ? nbs[t] : 0;
    p.bt.type_lo[t] = t < ntypes ? los[t] : 0;
    p.nbt += p.bt.type_nb[t];
  }
  p.nslots = 0;
  for (int l = 1; l <= Rf; ++l) p.nslots += 3 * stage_blocks(l);
  p.dr = T(dr); p.vol_over_scale = T(vol_over_scale);
  p.coldensh_lls = T(coldensh_lls); p.max_coldensh = T(max_coldensh);
  const int rk = parse_route(route, photo, heat_tab, hbin, p.rt);
  if (kTrack && rk < 0) return cudaErrorInvalidValue;

  const size_t tab_bytes =
      (rk < 0 ? size_t(p.rt.tab_len)
              : size_t(p.nbt) * row_stride<kHeat>(K)) * sizeof(T);
  const size_t smem = tab_bytes + 2 * kBlock * sizeof(T) +
                      (kTrack ? size_t(nb_all) * kBlock * sizeof(T) : 0);
  using Fn = void (*)(Params<T>, int, int, int);
  using SrcFn = void (*)(Params<T>);
  Fn stage;
  if constexpr (kTrack) {
    stage = with_nodes(K, [](auto kk) -> Fn {
      return stage_kernel<T, kHeat, true, decltype(kk)::value>;
    });
  } else {
    stage = with_route(rk, K, [](auto kk) -> Fn {
      constexpr int k = decltype(kk)::value;
      if constexpr (route_capped<kHeat, k>()) {
        return stage_kernel_capped<T, kHeat, false, k>;
      } else {
        return stage_kernel<T, kHeat, false, k>;
      }
    });
  }
  const SrcFn source = with_source_route(rk, [](auto kk) -> SrcFn {
    return source_cell_kernel<T, kHeat, decltype(kk)::value>;
  });
  // each kernel opted in to the shared memory it takes above the default
  cudaError_t err = allow_smem(source, tab_bytes);
  if (err != cudaSuccess) return err;
  err = allow_smem(stage, smem);
  if (err != cudaSuccess) return err;
  source<<<(S + 31) / 32, 32, tab_bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int slot = 0;
  for (int l = 1; l <= Rf; ++l) {
    const int nblk = stage_blocks(l);
    for (int m = 0; m < 3; ++m) {
      stage<<<dim3(nblk, S), kBlock, smem, stream>>>(p, l, m, slot);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      slot += nblk;
    }
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace c2ray

extern "C" {

// number of per-block loss slots a sweep of forward extent Rf writes
int pyramid_sweep_slots(int Rf) {
  int n = 0;
  for (int l = 1; l <= Rf; ++l) n += 3 * c2ray::stage_blocks(l);
  return n;
}

// Returns the cudaError_t of the launches (0 on success).  lls and
// band_partials may be null (no per-cell LLS; no band tracking); `route`
// the host ints of parse_route (table_rates.cuh: the fixed rule, the
// "auto" blocks or the tau tables, whose device tables photo, heat_tab
// and hbin are then read; else null; the track entries take the fixed
// rule only).
#define C2RAY_SWEEP_ENTRY(NAME, T, HEAT, TRACK)                             \
  int NAME(const T* fields, const int* srcpos, const T* nflux,             \
           const T* bands, const T* lls, T* cd, T* slab, T* partials,      \
           T* band_partials, int M, int S, int Rf, int Rb, int K,          \
           int ntypes, int nb_all, int col0, int nb0, int lo0, int col1,   \
           int nb1, int lo1, int col2, int nb2, int lo2, double dr,        \
           double vol_over_scale, double coldensh_lls, double max_coldensh, \
           const int* route, const T* photo, const T* heat_tab,            \
           const int* hbin, void* stream) {                                \
    const int cols[3] = {col0, col1, col2};                                \
    const int nbs[3] = {nb0, nb1, nb2};                                    \
    const int los[3] = {lo0, lo1, lo2};                                    \
    return c2ray::run_sweep<T, HEAT, TRACK>(                               \
        fields, srcpos, nflux, bands, lls, cd, slab, partials,             \
        band_partials, M, S, Rf, Rb, K, ntypes, nb_all, cols, nbs, los,    \
        dr, vol_over_scale, coldensh_lls, max_coldensh, route, photo,      \
        heat_tab, hbin, static_cast<cudaStream_t>(stream));                \
  }

C2RAY_SWEEP_ENTRY(pyramid_sweep_f32, float, false, false)
C2RAY_SWEEP_ENTRY(pyramid_sweep_f64, double, false, false)
C2RAY_SWEEP_ENTRY(pyramid_sweep_heat_f32, float, true, false)
C2RAY_SWEEP_ENTRY(pyramid_sweep_heat_f64, double, true, false)
C2RAY_SWEEP_ENTRY(pyramid_sweep_track_f32, float, false, true)
C2RAY_SWEEP_ENTRY(pyramid_sweep_track_f64, double, false, true)
C2RAY_SWEEP_ENTRY(pyramid_sweep_heat_track_f32, float, true, true)
C2RAY_SWEEP_ENTRY(pyramid_sweep_heat_track_f64, double, true, true)

}  // extern "C"
