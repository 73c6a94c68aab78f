// Skewed-octant short-characteristics sweep of a source batch (even cubic
// mesh, full periodic extents +M/2 / -(M/2-1)), with the quadrature band
// rates through the shared cell step of csrc/short_char.cuh; isothermal,
// or with kHeat the heating branch.
//
// Replaces c2ray_tpu/sweep/octant_sweep.py: sweep_octant_source_batch
// (:113), computing the same function; it is not a copy of that XLA
// program's plane-window scan and roll-and-stitch.
//
// Algorithm (the same as the plain version, octant_sweep.py:
// octant_sweep_plain): around each source the 8 octants (signs of the
// offset) are swept in the octant frame (a, b, c) = |offset| along
// x, y, z, a cube of (R+1)^3 cells, R = M/2.  The causal hyperplane
// a+b+c = s is a triangular slice stored as a plane P_s[b, c]; every
// cinterp corner of a cell on plane s lies on plane s-1, s-2 or s-3 at
// [b or b-1, c or c-1] (octant_sweep.py:188-206).  Each (source, octant)
// keeps a ring of four planes ((R+1)^2 x 3 values each; 1.6 MB per
// source at 128^3 in float32, against 25 MB for a column cube), and
// planes s = 1..3R run in order, one launch each: a valid cell (a in
// 0..R toward +, 0..R-1 toward -, and b, c likewise) writes its outgoing
// columns to slot s mod 4 and reads the three other slots, so a launch
// never reads what it writes.
//
// Ownership: an offset on a face between octants is computed in each of
// them (its columns feed that octant's later planes; the corner weights
// toward the other side are exactly 0, so the values agree) but belongs
// to one: positive octants own the zero faces, negative octants reach
// -(R-1).  Only the owner evaluates the band rates, writes them straight
// into the per-source slab in absolute coordinates, and counts the
// photon loss (live & on_bound & owned, octant_sweep.py:260-265); the
// source cell is deposited once, by its own kernel.  No LLS loss:
// lls_loss is 0 even with a homogeneous LLS column, as in JAX (:328).
// Photon losses reduce per block into partials, summed in fixed order by
// the caller: no float atomics, the sweep is deterministic.
//
// Bound: the K-node exponentials of every live band, owned cell and
// source (the unique cells; face cells of other octants skip their
// rates), as in csrc/pyramid_sweep.cu: 1.589 ms at 128^3 x 8.  The band
// loop is the pyramid kernel's (band_rates.cuh: K unrolled by
// with_nodes, 1/vol once per cell, only the sums a band's regime reads).
// What held the earlier launch back (one thread per position of the
// (R+1)^2 plane, every octant and source, 11.5 ms isothermal and 18.1
// ms with heating, 1.5x the pyramid kernel): 68% of the launched
// threads held no valid cell (they stored zeros and left; warps
// straddled rows and the triangle's diagonal edge, so a warp with a few
// valid lanes ran the whole band loop for them), and the planes near
// both ends of the sweep hold a few hundred to a few thousand cells, so
// each of those launches cost at least one cell's serial band loop.
// The design:
//   1. Only the valid positions are launched.  The wrapper enumerates
//      them once per mesh as rows of consecutive c (plane_rows in
//      sweep/octant_sweep.py: per plane, the rows of every octant with
//      their first position in the plane's compact order); a group of
//      lanes takes position i of its plane, finds its row by a binary
//      search over the plane's row starts (at most 8 (R+1) rows), and
//      neighbouring groups hold neighbouring cells of a row.  The blocks
//      of a plane follow its own count.  Nothing writes an invalid
//      position: the wrapper fills the ring with NaN, so a corner read
//      of a slot this sweep did not write turns the outputs to NaN,
//      which the kernel-vs-plain gates would catch.  It does not happen:
//      a corner of nonzero weight is a valid cell of plane s-1..s-3
//      (its coordinates are the cell's or one less, and an offset 0
//      stepped to -1 has weight exactly 0), and interp_columns never
//      reads a corner of weight 0.
//   2. A group of kLanes lanes per cell, chosen per launch by the
//      wrapper from the plane's cell steps over all sources
//      (octant_sweep.py:_plane_lanes): 8 lanes on the narrowest planes,
//      where one cell's serial band loop sets the launch's time, down
//      to 1 from about a fifth of a wave of the card up, where every
//      extra lane only repeats the row search, the corner reads and the
//      interpolation (each plane timed at 1, 2, 4 and 8 lanes by
//      tools/profile_torch_iteration.py --octant --lanes; PERF.md).
//      cell_step splits the cell's bands over the group and
//      closes them with group_sum, and lane 0 writes the columns, the
//      rates and the loss.
//   3. The photon-loss partials: one slot per (source, plane, block),
//      the planes' slots one after another in the wrapper's plan.

// The rate routes (kK, csrc/table_rates.cuh) through cell_step: the
// tau tables (kTableRoute, photo.py:photoion_rates) and the "auto"
// quadrature blocks (kBlockRoute, quadrature.py:486-489), at every lane
// count, bound as in csrc/pyramid_sweep.cu's note; the tau route with
// heating as plane_kernel_capped (table_rates.cuh: route_capped).

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
  const int4* rows;   // the planes' rows: [octant, b, first c, first
                      // position in the plane] (octant_sweep.py:plane_rows)
  T* ring;            // (S, 8, 4, R+1, R+1, 3) plane ring, NaN-filled
  T* slab;            // (S, M^3, 4) per-source rates, zeroed
  T* partials;        // (S, nslots) photon loss per block
  int M, S, R, nslots, nbt;
  StepConsts<T> k;
  RouteTables<T> rt;   // the tau-table or block route's (kK < 0)
};

// A plane's launch (a row of the wrapper's plan): its rows
// rows[row0, row0 + nrows), its valid positions over the 8 octants, the
// lanes per cell, the blocks per source and the first loss slot.
struct PlanePlan {
  int row0, nrows, ncells, lanes, nblk, slot0;
};

// octant o = 4 ix + 2 iy + iz, sign -1 where the bit is set
// (octant_sweep.py:_octant_signs order)
__device__ __forceinline__ int octant_sign(int o, int axis) {
  return (o >> (2 - axis)) & 1 ? -1 : 1;
}

// The source cell of each source: seeds plane 0 of its 8 rings, writes
// its rates (kK: the route, table_rates.cuh; 0 the fixed rule).
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
  const int M = p.M, R1 = p.R + 1;
  const size_t n = size_t(M) * M * M;
  const int* sp = p.srcpos + 3 * s;
  const size_t flat =
      (size_t(wrap(sp[0], M)) * M + wrap(sp[1], M)) * M + wrap(sp[2], M);
  T cc0[3], r[4];
  source_cell<T, kHeat, kK>(k, p.nflux + 3 * s, p.fields + flat * 5, cc0, r,
                            route_of<kK>(p.rt));
  for (int o = 0; o < 8; ++o) {
    T* dst = p.ring + ((size_t)s * 8 + o) * 4 * R1 * R1 * 3;   // slot 0
    for (int q = 0; q < 3; ++q) dst[q] = cc0[q];
  }
  T* out = p.slab + ((size_t)s * n + flat) * 4;
  for (int q = 0; q < 4; ++q) out[q] = r[q];
}

// Plane s of every (source, octant): blockIdx.y = source, a group of
// kLanes lanes per valid position of the plane (compact order: octant,
// then b, then c); the table has kK nodes (0: p.k.bt.K at run time), or
// kK names the route (table_rates.cuh).
// The arithmetic is plane_step (octant_sweep.py:157-267).
template <typename T, bool kHeat, int kK, int kLanes>
__device__ __forceinline__ void plane_body(const Params<T>& p, int s,
                                           const PlanePlan& q) {
  extern __shared__ unsigned char smem[];
  T* tab = reinterpret_cast<T*>(smem);
  T* red = tab + route_tab_len<T, kHeat, kK>(
                     p.nbt, p.k.bt, route_of<kK>(p.rt));   // kBlock
  load_route_rows<T, kHeat, kK>(p.bands, p.nbt, p.k.bt,
                                route_of<kK>(p.rt), tab);

  const int src = blockIdx.y;
  const int M = p.M, R = p.R, R1 = R + 1;
  // the position of this lane's group (uniform over the group), the lane
  const int i = (blockIdx.x * kBlock + threadIdx.x) / kLanes;
  const int lane = threadIdx.x % kLanes;
  T ploss = T(0);
  if (i < q.ncells) {
    // its row: the last of the plane's rows that starts at or before i
    const int4* rw = p.rows + q.row0;
    int lo = 0, hi = q.nrows;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(&rw[mid].w) <= i) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    const int4 row = __ldg(&rw[lo]);
    const int o = row.x, b = row.y, c = row.z + (i - row.w), a = s - b - c;
    const int sx = octant_sign(o, 0), sy = octant_sign(o, 1),
              sz = octant_sign(o, 2);
    const int vx = sx > 0 ? R : R - 1, vy = sy > 0 ? R : R - 1,
              vz = sz > 0 ? R : R - 1;
    T* ring = p.ring + ((size_t)src * 8 + o) * 4 * R1 * R1 * 3;
    const int dom = dominant_axis(a, b, c);
    const int abc[3] = {a, b, c};
    const int du_i = abc[dom == 0 ? 1 : 0], dv_i = abc[dom == 2 ? 1 : 2];
    const T d_dom = T(abc[dom]), d_u = T(du_i), d_v = T(dv_i);
    T sw[4];
    corner_weights(d_dom, d_u, d_v, sw);
    // corner (a-da, b-db, c-dc) -> plane s-da-db-dc at [b-db, c-dc];
    // null off the plane's edge
    auto at = [&](int back, int bb, int cc) -> const T* {
      if (bb < 0 || cc < 0) return nullptr;
      return ring + ((size_t)((s - back) & 3) * R1 * R1 + bb * R1 + cc) * 3;
    };
    // (u_m, v_m), (u, v_m), (u_m, v), (u, v) for the dominant axis
    // (octant_sweep.py:192-205)
    const T* c1 = at(3, b - 1, c - 1);
    const T *c2, *c3, *c4;
    if (dom == 2) {
      c2 = at(2, b - 1, c - 1); c3 = at(2, b, c - 1); c4 = at(1, b, c - 1);
    } else if (dom == 1) {
      c2 = at(2, b - 1, c - 1); c3 = at(2, b - 1, c); c4 = at(1, b - 1, c);
    } else {
      c2 = at(2, b, c - 1); c3 = at(2, b - 1, c); c4 = at(1, b, c);
    }
    const T* const cs[4] = {c1, c2, c3, c4};
    T cin[3];
    interp_columns(cs, sw, diag_boost<T>(abc[dom], du_i, dv_i), cin);
    const T pu = path_units(d_dom, d_u, d_v);
    const T af = T(a), bf = T(b), cf = T(c);
    const T dist2 = af * af + bf * bf + cf * cf;

    const int* sp = p.srcpos + 3 * src;
    const size_t flat = (size_t(wrap(sp[0] + sx * a, M)) * M +
                         wrap(sp[1] + sy * b, M)) * M +
                        wrap(sp[2] + sz * c, M);
    const bool owned = (a > 0 || sx > 0) && (b > 0 || sy > 0) &&
                       (c > 0 || sz > 0);
    const bool on_bound = a == vx || b == vy || c == vz;
    StepConsts<T> k = p.k;
    k.tab = tab;
    T cd_out[3], r[4], pl = T(0), lloss = T(0);
    cell_step<T, kHeat, kK, kLanes>(k, p.nflux + 3 * src, p.fields + flat * 5,
                                    cin, pu, dist2, on_bound, owned, cd_out,
                                    r, pl, lloss, lane,
                                    route_of<kK>(p.rt));
    if (lane == 0) {
      ploss = pl;
      T* dst = ring + ((size_t)(s & 3) * R1 * R1 + b * R1 + c) * 3;
      for (int q3 = 0; q3 < 3; ++q3) dst[q3] = cd_out[q3];
      if (owned) {
        T* out = p.slab + ((size_t)src * M * M * M + flat) * 4;
        for (int q4 = 0; q4 < 4; ++q4) out[q4] = r[q4];
      }
    }
  }
  const T pl = block_sum<T, kBlock>(red, ploss);
  if (threadIdx.x == 0) {
    p.partials[(size_t)src * p.nslots + q.slot0 + blockIdx.x] = pl;
  }
}

template <typename T, bool kHeat, int kK, int kLanes>
__global__ void __launch_bounds__(kBlock)
plane_kernel(Params<T> p, int s, PlanePlan q) {
  plane_body<T, kHeat, kK, kLanes>(p, s, q);
}

// the route_capped instantiations (table_rates.cuh)
template <typename T, bool kHeat, int kK, int kLanes>
__global__ void __launch_bounds__(kBlock, kCappedBlocks)
plane_kernel_capped(Params<T> p, int s, PlanePlan q) {
  plane_body<T, kHeat, kK, kLanes>(p, s, q);
}

template <typename T>
using PlaneFn = void (*)(Params<T>, int, PlanePlan);

template <typename T, bool kHeat, int kLanes>
PlaneFn<T> plane_with_nodes(int route, int K) {
  return with_route(route, K, [](auto kk) -> PlaneFn<T> {
    constexpr int k = decltype(kk)::value;
    if constexpr (route_capped<kHeat, k>()) {
      return plane_kernel_capped<T, kHeat, k, kLanes>;
    } else {
      return plane_kernel<T, kHeat, k, kLanes>;
    }
  });
}

// The plane kernel of the route (0: the fixed rule of K nodes) and G
// lanes per cell (G in kPlaneLanes), else null.
constexpr int kPlaneLanes[4] = {1, 2, 4, 8};

template <typename T, bool kHeat>
PlaneFn<T> plane_fn(int route, int K, int G) {
  switch (G) {
    case 1:
      return plane_with_nodes<T, kHeat, 1>(route, K);
    case 2:
      return plane_with_nodes<T, kHeat, 2>(route, K);
    case 4:
      return plane_with_nodes<T, kHeat, 4>(route, K);
    case 8:
      return plane_with_nodes<T, kHeat, 8>(route, K);
    default:
      return nullptr;
  }
}

template <typename T, bool kHeat>
int run_sweep(const T* fields, const int* srcpos, const T* nflux,
              const T* bands, const int* rows, T* ring, T* slab, T* partials,
              const int* plan, int nslots, int M, int S, int K, int ntypes,
              const int cols[3], const int nbs[3], const int los[3],
              double dr, double vol_over_scale, double coldensh_lls,
              double max_coldensh, const int* route, const T* photo,
              const T* heat_tab, const int* hbin, cudaStream_t stream) {
  Params<T> p;
  p.fields = fields; p.srcpos = srcpos; p.nflux = nflux; p.bands = bands;
  p.rows = reinterpret_cast<const int4*>(rows);
  p.ring = ring; p.slab = slab; p.partials = partials;
  p.M = M; p.S = S; p.R = M / 2; p.nslots = nslots;
  p.k.bt.K = K; p.k.bt.ntypes = ntypes;
  p.nbt = 0;
  for (int t = 0; t < 3; ++t) {
    p.k.bt.type_col[t] = t < ntypes ? cols[t] : 0;
    p.k.bt.type_nb[t] = t < ntypes ? nbs[t] : 0;
    p.k.bt.type_lo[t] = t < ntypes ? los[t] : 0;
    p.nbt += p.k.bt.type_nb[t];
  }
  p.k.tab = nullptr;
  p.k.dr = T(dr); p.k.vol_over_scale = T(vol_over_scale);
  p.k.coldensh_lls = T(coldensh_lls); p.k.max_coldensh = T(max_coldensh);
  const int rk = parse_route(route, photo, heat_tab, hbin, p.rt);

  const size_t tab_bytes =
      (rk < 0 ? size_t(p.rt.tab_len)
              : size_t(p.nbt) * row_stride<kHeat>(K)) * sizeof(T);
  const size_t smem = tab_bytes + kBlock * sizeof(T);
  using SrcFn = void (*)(Params<T>);
  const SrcFn source = with_source_route(rk, [](auto kk) -> SrcFn {
    return source_cell_kernel<T, kHeat, decltype(kk)::value>;
  });
  cudaError_t err = allow_smem(source, tab_bytes);
  if (err != cudaSuccess) return err;
  for (int G : kPlaneLanes) {
    err = allow_smem(plane_fn<T, kHeat>(rk, K, G), smem);
    if (err != cudaSuccess) return err;
  }
  source<<<(S + 31) / 32, 32, tab_bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  for (int s = 1; s <= 3 * p.R; ++s) {
    const int* r = plan + 6 * (s - 1);
    const PlanePlan q = {r[0], r[1], r[2], r[3], r[4], r[5]};
    if (q.ncells == 0) continue;
    const PlaneFn<T> plane = plane_fn<T, kHeat>(rk, K, q.lanes);
    if (plane == nullptr) return cudaErrorInvalidValue;
    plane<<<dim3(q.nblk, S), kBlock, smem, stream>>>(p, s, q);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace c2ray

extern "C" {

// Returns the cudaError_t of the launches (0 on success).  `rows` is the
// device table of plane_rows (n_rows x 4 ints); `plan` a host array of
// 3R rows [row0, nrows, ncells, lanes, nblk, slot0], one per plane s =
// 1..3R; `partials` holds nslots slots per source; `route` the host ints
// of parse_route (table_rates.cuh), with the tau tables' device tables
// photo, heat_tab and hbin on that route (else null).
#define C2RAY_OCTANT_ENTRY(NAME, T, HEAT)                                    \
  int NAME(const T* fields, const int* srcpos, const T* nflux,              \
           const T* bands, const int* rows, T* ring, T* slab, T* partials,  \
           const int* plan, int nslots, int M, int S, int K, int ntypes,    \
           int col0, int nb0, int lo0, int col1, int nb1, int lo1,          \
           int col2, int nb2, int lo2, double dr, double vol_over_scale,    \
           double coldensh_lls, double max_coldensh, const int* route,      \
           const T* photo, const T* heat_tab, const int* hbin,              \
           void* stream) {                                                  \
    const int cols[3] = {col0, col1, col2};                                 \
    const int nbs[3] = {nb0, nb1, nb2};                                     \
    const int los[3] = {lo0, lo1, lo2};                                     \
    return c2ray::run_sweep<T, HEAT>(                                       \
        fields, srcpos, nflux, bands, rows, ring, slab, partials, plan,     \
        nslots, M, S, K, ntypes, cols, nbs, los, dr, vol_over_scale,        \
        coldensh_lls, max_coldensh, route, photo, heat_tab, hbin,           \
        static_cast<cudaStream_t>(stream));                                 \
  }

C2RAY_OCTANT_ENTRY(octant_sweep_f32, float, false)
C2RAY_OCTANT_ENTRY(octant_sweep_f64, double, false)
C2RAY_OCTANT_ENTRY(octant_sweep_heat_f32, float, true)
C2RAY_OCTANT_ENTRY(octant_sweep_heat_f64, double, true)

}  // extern "C"
