// L1-shell short-characteristics sweep of a source batch: the general
// engine, for any trace extent (odd meshes, max_subbox), with the
// quadrature band rates as a device function (cell_rates of
// csrc/band_rates.cuh) through the shared cell step of
// csrc/short_char.cuh; isothermal, or with kHeat the heating branch.
//
// Replaces c2ray_tpu/sweep/source_sweep.py: _sweep_one_source_stacked
// (:138) under the source vmap of sweep_sources_accumulate (:285), with
// c2ray_tpu/sweep/cinterp.py: cinterp_shell (:38).
//
// Algorithm (the same as the plain version, source_sweep.py:
// shell_sweep_plain): every source owns an outgoing-column cube cd[s]
// (M^3 x 3, absolute coordinates, zeroed per sweep).  The source cell
// seeds it; then shells s = |di|+|dj|+|dk| = 1..n_shells run in order,
// one launch each, a group of lanes per (source, cell of the shell)
// over the compact table (cells sorted by shell, packed offsets and
// boundary flags: the padded table is 55% padding at 128^3, and no
// thread runs on padding).  A cell reads its four cinterp corners
// through the periodic wrap; they lie in earlier shells
// (c2ray_tpu/sweep/geometry.py: 5-10), except corners of weight 0,
// which are not read, so a shell's writes to cd never race its reads.
// Rates go to a per-source slab in absolute coordinates (each trace
// offset is one cell: the extents span at most M), summed over sources
// by the caller in fixed order; photon and LLS losses reduce per block
// into partials, summed in fixed order by the caller: no float atomics,
// the sweep is deterministic.  With a per-cell LLS grid (`lls`, else
// null) the cell being entered adds its own column times the path to
// the incoming HI column and counts its LLS loss, as csrc/pyramid_sweep.cu
// does; the cell step takes it as that cell's coldensh_lls.
//
// Bound: the K-node exponentials of every live band, cell and source on
// the SFU, as in csrc/pyramid_sweep.cu (1.589 ms at 128^3 x 8); here
// each cell also gathers its four corners (12 values) from anywhere in
// the source's cube, and the shells near the source and the trace
// corners are narrow launches.  What held the earlier design (one
// thread per cell, a runtime-K node loop) at 7.9x that bound (12.5x
// with heating) was instruction issue in the band loop, as in the
// pyramid kernel.  The design is the pyramid kernel's: the band loop of
// band_rates.cuh (K unrolled, 1/vol once per cell, only the sums a
// band's regime reads: 197 instructions per band isothermal, 289 with
// heating, 12 MUFU.EX2 and one MUFU.RCP on a thick band's path, float32
// SASS at K = 6, chip_smoke.py `sass_band_mix`), and kCellLanes = 2
// lanes per cell (tools/profile_torch_iteration.py --lanes 1,2,4,8 on an
// H100 80GB HBM3 at 700 W, 128^3 x 8 f32, shell kernel ms for G = 1, 2,
// 4, 8: isothermal 9.82, 8.40, 8.88, 11.51; heating 11.51, 10.90, 12.67,
// 17.42) through cell_step (short_char.cuh), whose lanes share the
// cell's bands and end with the same rates; lane 0 writes cd, the slab
// and the losses; wrap() takes no division for an offset within one
// period.  Measured (chip_smoke.py, the main path's states): 8.28 ms
// isothermal (before: 12.50), 11.22 ms heating (before: 19.85); launch
// gaps and the sweep's other work 0.44 and 0.45 ms of the sweep's
// CUDA-event time (phase 22).

// The rate routes (kK, csrc/table_rates.cuh) through cell_step: the
// tau tables (kTableRoute, photo.py:photoion_rates) and the "auto"
// quadrature blocks (kBlockRoute, quadrature.py:486-489), bound as in
// csrc/pyramid_sweep.cu's note.

#include "short_char.cuh"

namespace c2ray {
namespace {

constexpr int kBlock = 256;

template <typename T>
struct Params {
  const T* fields;    // (M^3, 5): ndens, h_av0, h_av1, he_av0, he_av1
  const int* srcpos;  // (S, 3)
  const T* nflux;     // (S, 3)
  const T* bands;     // (nbt, stride) live bands of every source type
  const T* lls;       // (M^3) per-cell LLS columns, or null
  const int* cells;   // (n_cells,) packed offsets sorted by shell
  T* cd;              // (S, M^3, 3) outgoing columns, zeroed
  T* slab;            // (S, M^3, 4) per-source rates, zeroed
  T* partials;        // (S, nslots, 2) photon / LLS loss per block
  int M, S, nslots, nbt;
  StepConsts<T> k;
  RouteTables<T> rt;   // the tau-table or block route's (kK < 0)
};

template <typename T>
__device__ __forceinline__ size_t src_flat(const Params<T>& p, int s) {
  const int* sp = p.srcpos + 3 * s;
  const int M = p.M;
  return (size_t(wrap(sp[0], M)) * M + wrap(sp[1], M)) * M + wrap(sp[2], M);
}

// The source cell of each source: seeds cd, writes its rates (kK: the
// route, table_rates.cuh; 0 the fixed rule).
template <typename T, bool kHeat, int kK>
__global__ void source_cell_kernel(Params<T> p) {
  extern __shared__ unsigned char smem[];
  T* tab = reinterpret_cast<T*>(smem);
  load_route_rows<T, kHeat, kK>(p.bands, p.nbt, p.k.bt,
                                route_of<kK>(p.rt), tab);
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= p.S) return;
  StepConsts<T> k = p.k;
  k.tab = tab;
  const size_t n = size_t(p.M) * p.M * p.M;
  const size_t flat = src_flat(p, s);
  T cc0[3], r[4];
  source_cell<T, kHeat, kK>(k, p.nflux + 3 * s, p.fields + flat * 5, cc0, r,
                            route_of<kK>(p.rt));
  T* cd0 = p.cd + ((size_t)s * n + flat) * 3;
  for (int q = 0; q < 3; ++q) cd0[q] = cc0[q];
  T* out = p.slab + ((size_t)s * n + flat) * 4;
  for (int q = 0; q < 4; ++q) out[q] = r[q];
}

// One shell: a group of kCellLanes lanes per cell start..start+count-1
// of the compact table, blockIdx.y = source; the table has kK nodes (0:
// p.k.bt.K at run time), or kK names the route (table_rates.cuh).  The
// arithmetic is cinterp_shell + shell_step (c2ray_tpu/sweep/cinterp.py:
// 38-128, source_sweep.py:186-244).
template <typename T, bool kHeat, int kK>
__global__ void __launch_bounds__(kBlock)
shell_kernel(Params<T> p, long long start, int count, int slot0) {
  extern __shared__ unsigned char smem[];
  T* tab = reinterpret_cast<T*>(smem);
  T* red = tab + route_tab_len<T, kHeat, kK>(
                     p.nbt, p.k.bt, route_of<kK>(p.rt));   // kBlock
  load_route_rows<T, kHeat, kK>(p.bands, p.nbt, p.k.bt,
                                route_of<kK>(p.rt), tab);

  const int s = blockIdx.y;
  const int M = p.M;
  const size_t n = size_t(M) * M * M;
  // the cell of this lane's group (uniform over the group) and the lane
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / kCellLanes;
  const int lane = threadIdx.x % kCellLanes;
  T ploss = T(0), lloss = T(0);
  if (i < count) {
    const int packed = p.cells[start + i];
    const int d[3] = {(packed & 1023) - 512, ((packed >> 10) & 1023) - 512,
                      ((packed >> 20) & 1023) - 512};
    const bool on_bound = (packed >> 30) & 1;
    const int da[3] = {abs(d[0]), abs(d[1]), abs(d[2])};
    const int dom = dominant_axis(da[0], da[1], da[2]);
    const int au = dom == 0 ? 1 : 0;   // canonical (u, v): the other two
    const int av = dom == 2 ? 1 : 2;   // axes in ascending order
    const T d_dom = T(da[dom]), d_u = T(da[au]), d_v = T(da[av]);
    T sw[4];
    corner_weights(d_dom, d_u, d_v, sw);

    // the cell and its corners in absolute coordinates: one step back
    // along the dominant axis, and 0 or 1 back along u and v (Fortran
    // sign: +1 for an offset 0)
    const int* sp = p.srcpos + 3 * s;
    int pos[3];
    for (int q = 0; q < 3; ++q) pos[q] = wrap(sp[q] + d[q], M);
    const int sg[3] = {d[0] >= 0 ? 1 : -1, d[1] >= 0 ? 1 : -1,
                       d[2] >= 0 ? 1 : -1};
    const T* cds = p.cd + (size_t)s * n * 3;
    auto corner = [&](bool u_minus, bool v_minus) -> const T* {
      int q[3] = {pos[0], pos[1], pos[2]};
      q[dom] = wrap(q[dom] - sg[dom], M);
      if (u_minus) q[au] = wrap(q[au] - sg[au], M);
      if (v_minus) q[av] = wrap(q[av] - sg[av], M);
      return cds + ((size_t(q[0]) * M + q[1]) * M + q[2]) * 3;
    };
    const T* const c[4] = {corner(true, true), corner(false, true),
                           corner(true, false), corner(false, false)};
    T cin[3];
    interp_columns(c, sw, diag_boost<T>(da[dom], da[au], da[av]), cin);
    const T pu = path_units(d_dom, d_u, d_v);
    const T dist2 = T(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);

    StepConsts<T> k = p.k;
    k.tab = tab;
    const size_t flat = (size_t(pos[0]) * M + pos[1]) * M + pos[2];
    // the LLS column of the cell being entered, or the homogeneous one
    if (p.lls != nullptr) k.coldensh_lls = p.lls[flat];
    T cd_out[3], r[4], pl = T(0), ll = T(0);
    cell_step<T, kHeat, kK, kCellLanes>(k, p.nflux + 3 * s,
                                        p.fields + flat * 5, cin, pu, dist2,
                                        on_bound, true, cd_out, r, pl, ll,
                                        lane, route_of<kK>(p.rt));
    if (lane == 0) {
      ploss = pl;
      lloss = ll;
      T* dst = p.cd + ((size_t)s * n + flat) * 3;
      for (int q = 0; q < 3; ++q) dst[q] = cd_out[q];
      T* out = p.slab + ((size_t)s * n + flat) * 4;
      for (int q = 0; q < 4; ++q) out[q] = r[q];
    }
  }
  const T pl = block_sum<T, kBlock>(red, ploss);
  const T ll = block_sum<T, kBlock>(red, lloss);
  if (threadIdx.x == 0) {
    T* dst = p.partials + ((size_t)s * p.nslots + slot0 + blockIdx.x) * 2;
    dst[0] = pl;
    dst[1] = ll;
  }
}

inline int shell_blocks(long long count) {
  return int((count * kCellLanes + kBlock - 1) / kBlock);
}

template <typename T, bool kHeat>
int run_sweep(const T* fields, const int* srcpos, const T* nflux,
              const T* bands, const T* lls, const int* cells,
              const long long* starts,
              T* cd, T* slab, T* partials, int M, int S, int n_shells, int K,
              int ntypes, const int cols[3], const int nbs[3],
              const int los[3], double dr, double vol_over_scale,
              double coldensh_lls, double max_coldensh, const int* route,
              const T* photo, const T* heat_tab, const int* hbin,
              cudaStream_t stream) {
  Params<T> p;
  p.fields = fields; p.srcpos = srcpos; p.nflux = nflux; p.bands = bands;
  p.lls = lls; p.cells = cells; p.cd = cd; p.slab = slab; p.partials = partials;
  p.M = M; p.S = S;
  p.k.bt.K = K; p.k.bt.ntypes = ntypes;
  p.nbt = 0;
  for (int t = 0; t < 3; ++t) {
    p.k.bt.type_col[t] = t < ntypes ? cols[t] : 0;
    p.k.bt.type_nb[t] = t < ntypes ? nbs[t] : 0;
    p.k.bt.type_lo[t] = t < ntypes ? los[t] : 0;
    p.nbt += p.k.bt.type_nb[t];
  }
  p.nslots = 0;
  for (int k = 0; k < n_shells; ++k) {
    p.nslots += shell_blocks(starts[k + 1] - starts[k]);
  }
  p.k.tab = nullptr;
  p.k.dr = T(dr); p.k.vol_over_scale = T(vol_over_scale);
  p.k.coldensh_lls = T(coldensh_lls); p.k.max_coldensh = T(max_coldensh);
  const int rk = parse_route(route, photo, heat_tab, hbin, p.rt);

  const size_t tab_bytes =
      (rk < 0 ? size_t(p.rt.tab_len)
              : size_t(p.nbt) * row_stride<kHeat>(K)) * sizeof(T);
  const size_t smem = tab_bytes + kBlock * sizeof(T);
  using Fn = void (*)(Params<T>, long long, int, int);
  using SrcFn = void (*)(Params<T>);
  const Fn shell = with_route(rk, K, [](auto kk) -> Fn {
    return shell_kernel<T, kHeat, decltype(kk)::value>;
  });
  const SrcFn source = with_source_route(rk, [](auto kk) -> SrcFn {
    return source_cell_kernel<T, kHeat, decltype(kk)::value>;
  });
  cudaError_t err = allow_smem(source, tab_bytes);
  if (err != cudaSuccess) return err;
  err = allow_smem(shell, smem);
  if (err != cudaSuccess) return err;
  source<<<(S + 31) / 32, 32, tab_bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int slot = 0;
  for (int k = 0; k < n_shells; ++k) {
    const long long count = starts[k + 1] - starts[k];
    const int nblk = shell_blocks(count);
    shell<<<dim3(nblk, S), kBlock, smem, stream>>>(p, starts[k], int(count),
                                                   slot);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    slot += nblk;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace c2ray

extern "C" {

// number of per-block loss slots per source of a sweep over these shells
int shell_sweep_slots(const long long* starts, int n_shells) {
  int n = 0;
  for (int k = 0; k < n_shells; ++k) {
    n += c2ray::shell_blocks(starts[k + 1] - starts[k]);
  }
  return n;
}

// Returns the cudaError_t of the launches (0 on success).  `lls` is the
// (M^3) per-cell LLS columns or null (then coldensh_lls, homogeneous);
// `starts` is a host array of n_shells + 1 offsets into `cells`; `route`
// the host ints of parse_route (table_rates.cuh: the fixed rule, the
// "auto" blocks or the tau tables, whose device tables photo, heat_tab
// and hbin are then read; else null).
#define C2RAY_SHELL_ENTRY(NAME, T, HEAT)                                     \
  int NAME(const T* fields, const int* srcpos, const T* nflux,              \
           const T* bands, const T* lls, const int* cells,                  \
           const long long* starts, T* cd, T* slab, T* partials, int M,     \
           int S, int n_shells, int K,                                      \
           int ntypes, int col0, int nb0, int lo0, int col1, int nb1,       \
           int lo1, int col2, int nb2, int lo2, double dr,                  \
           double vol_over_scale, double coldensh_lls, double max_coldensh, \
           const int* route, const T* photo, const T* heat_tab,             \
           const int* hbin, void* stream) {                                 \
    const int cols[3] = {col0, col1, col2};                                 \
    const int nbs[3] = {nb0, nb1, nb2};                                     \
    const int los[3] = {lo0, lo1, lo2};                                     \
    return c2ray::run_sweep<T, HEAT>(                                       \
        fields, srcpos, nflux, bands, lls, cells, starts, cd, slab,         \
        partials, M, S, n_shells, K, ntypes, cols, nbs, los, dr,            \
        vol_over_scale,                                                     \
        coldensh_lls, max_coldensh, route, photo, heat_tab, hbin,           \
        static_cast<cudaStream_t>(stream));                                 \
  }

C2RAY_SHELL_ENTRY(shell_sweep_f32, float, false)
C2RAY_SHELL_ENTRY(shell_sweep_f64, double, false)
C2RAY_SHELL_ENTRY(shell_sweep_heat_f32, float, true)
C2RAY_SHELL_ENTRY(shell_sweep_heat_f64, double, true)

}  // extern "C"
