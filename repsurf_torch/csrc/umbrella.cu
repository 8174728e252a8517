// Fused umbrella geometry: kernels that compute one function, each the
// counterpart of one Pallas kernel of repsurf_tpu/ops/pallas/umbrella.py.
//
//   umbrella_tq_kernel    replaces _umbrella_tq_kernel (:302), an aligned
//                         group of kTqLanes = 4 lanes per query;
//   umbrella_full_kernel  replaces _umbrella_kernel (:88), one warp per
//                         query;
//   umbrella_slab_kernel  replaces _umbrella_slab_kernel (:606), x-sorted
//   + umbrella_slab_      slabs of 128 queries against a 3-slab window with
//     resolve_kernel      the exactness guard in the kernel, then the
//                         queries the window cannot vouch for re-solved
//                         over the whole cloud by a second launch.
//
// What bounds them on the H100: the k-nearest-neighbour scan.  The tq and
// full kernels test all N candidates of every query, a few flops and a
// compare each: O(N^2) instruction-bound work per sample against an output of
// G*C floats per query.  The slab's window pass tests 384 candidates per
// query; its re-solve pass scans the whole cloud for the queries it lists.
// What the designs do about it:
//   * one scan for tq, full and the slab's re-solve (screened_scan): an
//     aligned group of L lanes takes one query; the candidates are tiled
//     through shared memory as float4, so the cloud leaves L2 once per
//     block; each lane scans every L-th candidate of a tile into its own
//     k-best list in registers, screening U = min(32, kTile / L)
//     candidates at a time against the group's smallest k-th distance and
//     inserting the few that pass afterwards, in index order (a warp whose
//     lanes insert at different candidates would otherwise take the
//     insertion path at nearly every candidate), and the group merges its
//     lists in k shuffle rounds (merge_lanes, knn_topk.cuh).  tq takes
//     L = 4 and 32 queries a block, full L = 32 (the TPU kernel's one
//     query across its lanes) and kFullWarps queries a block: two fixed
//     instantiations of one body (group_block), so they cannot drift apart.
//   * one fan epilogue (lane_fan_features): lane s of the group takes the
//     neighbours and fans g = s (mod L); the azimuths, the sorted neighbours
//     and the merged indices meet in a per-query row of shared memory; the
//     sign comes from fan 0's lane by a shuffle and the first good fan from
//     a group minimum.  With L = 32 and G <= 14 a lane holds one fan.
//   * stores: tq and full stage the block's queries, one contiguous span of
//     the output, in shared memory and write it with 16-byte stores from
//     consecutive threads (knn_topk::store_span); the slab kernels write
//     each query's row at its original index through its own staged row
//     and the same span store, four lanes a row.
//   * slab: a block takes 32 queries of one slab (4 lanes each, 128
//     threads) with the 3-slab window staged as float4 (x, y, z, original
//     index).  The window is x-sorted, not in index order, so its lists
//     insert by the (d^2, index) pair (List::insert_any_order), the
//     query's own slab first.  The group's merged
//     k-th distance and the query's margin to the nearest x outside the
//     window give the guard in the kernel; a query it cannot vouch for
//     takes a slot of its sample's list from atomicAdd(resolved + b, 1) and
//     skips the epilogue.  The re-solve pass runs on the same stream on a
//     fixed grid whose blocks stride over resolved[b], read on the device
//     (the design of knn_window.cu), 32 listed queries of one sample a
//     block through the shared scan and epilogue: the host never waits.
// Every form builds its fans with the same two functions (make_fan and
// put_fan below, the counterparts of _fan_geometry_pack /
// _fan_geometry_pack_tq) over the same neighbour list, so the kernels are
// bit-equal to one another.  repsurf_umbrella_tq_scan_floor is the tq launch
// without the fan geometry and the feature stores, and
// repsurf_umbrella_full_warps the full kernel at 8, 16 or 32 warps a block:
// measurements, not features.
//
// The list length is a template parameter KMAX (9 or 17) and k a runtime
// value k <= KMAX: every index into the per-thread arrays must be a
// compile-time constant for them to stay in registers, and two lengths keep
// the models' k = 9 tight while k up to 17 (G <= 16, the JAX auto bound)
// still works.  Style, rotation and the plane constant are runtime flags,
// uniform over a launch.
//
// Per query q (semantics identical to the plain version in
// ops/kernels/umbrella.py, the composition of geometry/umbrella.py):
//   * kNN over the valid points with direct coordinate differences; invalid
//     points sit at 1e10; ascending on (d^2, index); a slot at >= 1e10 is
//     missing and takes point 0's coordinates;
//   * with skip, kNN column 0 (q itself) is dropped: G = k - 1, else G = k;
//     the neighbours are taken relative to q;
//   * stable ascending rank by azimuth phi = atan2(y, x) / 2pi + 0.5, in the
//     FIXED_ROTATION_ROWS frame when rotate (the reference's truncated
//     0.7071 literals);
//   * fan g = (q, sorted g, sorted g+1 mod G): unit normal (zero for a
//     degenerate fan), its sign set by fan 0's x component; centroid / 3;
//     the centroid's xyz2sphere; the plane constant n.c / sqrt(3);
//   * degenerate fans take the first good fan's centroid, normal and
//     constant (fan 0 when all are degenerate); the polar channels keep
//     their own centroid's;
//   * channels in the style's order: [center, polar, normal, const] (cls),
//     [polar, normal, const, center] (seg), [center, polar, normal] without
//     the constant.
// The per-sample random inversion of the normal is left to the caller.
//
// Exactness: products and sums are rounded one by one (-fmad=false), in the
// order the plain version writes them; division and sqrt are IEEE.

#include <cuda_runtime.h>
#include <math.h>

#include "knn_topk.cuh"

namespace {

using knn_topk::kBig;

constexpr int kTqQueries = 32;  // tq, slab: queries per block
constexpr int kTqLanes = 4;     // tq, slab: lanes per query
constexpr int kTile = 512;      // tq, full, re-solve: candidates per shared tile
constexpr int kFullWarps = 8;   // full: queries (warps) per block
constexpr int kSlab = 128;      // slab: points per slab
constexpr int kWindow = 3 * kSlab;
constexpr int kMaxFans = 16;    // tq: G <= 16
constexpr int kMaxLanes = 128;  // full, slab: G * C <= 128

// FIXED_ROTATION_ROWS, row-vector points: xr = x R00 + y R10 + z R20,
// yr = x R01 + y R11 + z R21
constexpr float kR00 = 0.5f, kR10 = 0.7071f, kR20 = -0.5f;
constexpr float kR01 = -0.5f, kR11 = 0.7071f, kR21 = 0.5f;

struct Opts {
  int skip;    // 1: kNN column 0 dropped
  int rotate;  // 1: azimuth in the fixed rotated frame
  int g;       // fans per point
  int c;       // channels per fan: 10 with the plane constant, 9 without
  int o_center, o_polar, o_normal, o_pos;  // channel offsets (o_pos < 0: none)
};

__device__ __forceinline__ float azimuth(float x, float y) {
  const float two_pi = 2.0f * (float)M_PI;
  const bool xy0 = (x == 0.0f) && (y == 0.0f);
  return atan2f(y, xy0 ? 1.0f : x) / two_pi + 0.5f;
}

// the sorting key of a neighbour relative to q
__device__ __forceinline__ float fan_azimuth(float x, float y, float z, int rotate) {
  if (rotate) return azimuth(kR00 * x + kR10 * y + kR20 * z, kR01 * x + kR11 * y + kR21 * z);
  return azimuth(x, y);
}

struct Fan {
  float cx, cy, cz, ux, uy, uz, pv;
  bool deg;
};

// the cross product of a and b and its squared norm (0: a degenerate fan)
__device__ __forceinline__ float cross(float ax, float ay, float az, float bx, float by,
                                       float bz, float& nx, float& ny, float& nz) {
  nx = ay * bz - az * by;
  ny = az * bx - ax * bz;
  nz = ax * by - ay * bx;
  return nx * nx + ny * ny + nz * nz;
}

// triangle (origin, a, b): signed unit normal, centroid, plane constant
__device__ __forceinline__ Fan make_fan(float ax, float ay, float az, float bx,
                                        float by, float bz, float sign) {
  Fan f;
  float nx, ny, nz;
  const float s2 = cross(ax, ay, az, bx, by, bz, nx, ny, nz);
  f.deg = s2 == 0.0f;
  const float norm = sqrtf(f.deg ? 1.0f : s2);
  f.ux = (f.deg ? 0.0f : nx / norm) * sign;
  f.uy = (f.deg ? 0.0f : ny / norm) * sign;
  f.uz = (f.deg ? 0.0f : nz / norm) * sign;
  f.cx = (ax + bx) / 3.0f;
  f.cy = (ay + by) / 3.0f;
  f.cz = (az + bz) / 3.0f;
  f.pv = (f.ux * f.cx + f.uy * f.cy + f.uz * f.cz) / sqrtf(3.0f);
  return f;
}

// One fan's C channels at p: the polar channels from the fan's own
// centroid (xyz2sphere), the rest from r (the fan itself, or the first good
// fan when it is degenerate).
__device__ __forceinline__ void put_fan(const Fan& f, const Fan& r, const Opts& o, float* p) {
  const float pi = (float)M_PI;
  const float s2c = f.cx * f.cx + f.cy * f.cy + f.cz * f.cz;
  const bool zero = s2c == 0.0f;
  const float rho = zero ? 0.0f : sqrtf(s2c);
  const float u = fminf(fmaxf(f.cz / (zero ? 1.0f : rho), -1.0f), 1.0f);
  const float th = fabsf(u) >= 1.0f ? (u > 0.0f ? 0.0f : pi) : acosf(u);
  p[o.o_center + 0] = r.cx;
  p[o.o_center + 1] = r.cy;
  p[o.o_center + 2] = r.cz;
  p[o.o_polar + 0] = rho;
  p[o.o_polar + 1] = (zero ? 0.0f : th) / pi;
  p[o.o_polar + 2] = azimuth(f.cx, f.cy);
  p[o.o_normal + 0] = r.ux;
  p[o.o_normal + 1] = r.uy;
  p[o.o_normal + 2] = r.uz;
  if (o.o_pos >= 0) p[o.o_pos] = r.pv;
}

__device__ __forceinline__ int successor(int g, int G) { return g + 1 < G ? g + 1 : 0; }

// the lanes of the calling lane's aligned group of L
template <int L>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (L == 32) {
    return knn_topk::kFullMask;
  } else {
    return ((1u << L) - 1) << ((threadIdx.x & 31) & ~(L - 1));
  }
}

// The group epilogue of L lanes: lane `sub` takes the neighbours and the
// fans g = sub (mod L).  nb[0 .. G) are the query's neighbour indices in
// kNN order (self column already dropped); phi, rx, ry, rz the query's
// shared row (G floats each); out its G*C outputs.  Called together by the
// lanes of `mask`, which holds the group: the whole warp where every group
// of it gets here, else group_mask<L>().
template <int L>
__device__ __forceinline__ void lane_fan_features(const int* nb, const float* __restrict__ src,
                                                  float qx, float qy, float qz, const Opts& o,
                                                  float* phi, float* rx, float* ry, float* rz,
                                                  int sub, unsigned mask, float* out) {
  constexpr int F = (kMaxFans + L - 1) / L;  // fans a lane at most
  const int G = o.g;
  float gx[F], gy[F], gz[F], ph[F];
  // own neighbours, relative to q, and their azimuths into the shared row
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int g = sub + L * f;
    gx[f] = gy[f] = gz[f] = ph[f] = 0.0f;
    if (g < G) {
      const int j = nb[g];
      gx[f] = src[j * 3 + 0] - qx;
      gy[f] = src[j * 3 + 1] - qy;
      gz[f] = src[j * 3 + 2] - qz;
      ph[f] = fan_azimuth(gx[f], gy[f], gz[f], o.rotate);
      phi[g] = ph[f];
    }
  }
  __syncwarp(mask);
  // stable ascending rank among the query's G azimuths; each own neighbour
  // to its sorted place in the row
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int g = sub + L * f;
    if (g < G) {
      int r = 0;
      for (int j = 0; j < G; ++j) {
        const float pj = phi[j];
        r += (pj < ph[f]) || (pj == ph[f] && j < g);
      }
      rx[r] = gx[f];
      ry[r] = gy[f];
      rz[r] = gz[f];
    }
  }
  __syncwarp(mask);
  // the sign, from fan 0 on the group's first lane
  const int lead = (threadIdx.x & 31) & ~(L - 1);
  float sign = 1.0f;
  if (sub == 0) {
    const int h = successor(0, G);
    sign = make_fan(rx[0], ry[0], rz[0], rx[h], ry[h], rz[h], 1.0f).ux > 0.0f ? 1.0f : -1.0f;
  }
  sign = __shfl_sync(mask, sign, lead);
  // the first good fan: the lowest non-degenerate fan over the group
  int first = G;
#pragma unroll
  for (int f = F - 1; f >= 0; --f) {
    const int g = sub + L * f;
    float nx, ny, nz;
    if (g < G) {
      const int h = successor(g, G);
      if (cross(rx[g], ry[g], rz[g], rx[h], ry[h], rz[h], nx, ny, nz) != 0.0f) first = g;
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    first = min(first, __shfl_xor_sync(mask, first, off));
  const int rg = first == G ? 0 : first;
  // own fans; a degenerate one takes the first good fan, built from the row
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int g = sub + L * f;
    if (g < G) {
      const int h = successor(g, G);
      const Fan fan = make_fan(rx[g], ry[g], rz[g], rx[h], ry[h], rz[h], sign);
      if (fan.deg) {
        const int rh = successor(rg, G);
        const Fan rep = make_fan(rx[rg], ry[rg], rz[rg], rx[rh], ry[rh], rz[rh], sign);
        put_fan(fan, rep, o, out + g * o.c);
      } else {
        put_fan(fan, fan, o, out + g * o.c);
      }
    }
  }
}

// Shared memory, in floats, each part a multiple of 4 (16-byte aligned):
// a span of q queries' outputs with 3 floats of slack for its 16-byte phase;
// one query's own row of outputs, the same; the per-query rows of the
// epilogue (the merged indices, the azimuths, the sorted neighbours).
__host__ __device__ inline int span_floats(int q, const Opts& o) {
  return (q * o.g * o.c + 3 + 3) & ~3;
}
__host__ __device__ inline int row_floats(const Opts& o) { return (o.g + o.skip) + 4 * o.g; }
__host__ __device__ inline int rows_floats(int q, const Opts& o) {
  return (q * row_floats(o) + 3) & ~3;
}

// The screened scan: one query's KMAX best over the whole cloud src [n, 3],
// split over an aligned group of L lanes (lane `sub`), the cloud staged
// through `tile` (kTile float4s) by all NT threads of the block, every one
// of which calls it (the barriers).
//
// Each lane takes every L-th candidate, in index order, into its own k
// best.  A chunk of U of the lane's candidates is screened against an upper
// bound on the query's k-th distance, taken at the chunk's start, into a
// bit mask; the marked ones are then inserted in index order, each against
// the lane's own current k-th.  A warp so takes the insertion path once per
// marked candidate of its busiest lane, not once per candidate that any
// lane inserts.  The bound is the group's least k-th (min over its lanes of
// each list's end): a candidate above it cannot reach the merged k best;
// one equal to it may, so it is kept.
template <int L, int NT, int KMAX>
__device__ __forceinline__ void screened_scan(const float* __restrict__ src, int n, int nv,
                                              float4* tile, float qx, float qy, float qz,
                                              int sub, knn_topk::List<KMAX>& best) {
  constexpr int U = kTile / L < 32 ? kTile / L : 32;
  best.reset();
  for (int base = 0; base < n; base += kTile) {
    __syncthreads();
    for (int t = threadIdx.x; t < kTile && base + t < n; t += NT) {
      const float* p = src + (size_t)(base + t) * 3;
      tile[t] = make_float4(p[0], p[1], p[2], 0.0f);
    }
    __syncthreads();
    const int len = min(kTile, n - base);
    const int lv = min(len, nv - base);  // the tile's valid candidates; the rest sit at 1e10
    for (int t0 = 0; t0 < len; t0 += U * L) {  // the same trip count on every lane
      float w = best.worst();
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1)
        w = fminf(w, __shfl_xor_sync(knn_topk::kFullMask, w, off));
      unsigned marked = 0;
      const float4* tp = tile + t0 + sub;
      if (t0 + U * L <= lv) {  // a whole chunk of valid candidates
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float4 p = tp[u * L];
          if (knn_topk::dist2(p.x, p.y, p.z, qx, qy, qz) <= w) marked |= 1u << u;
        }
      } else {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int t = t0 + sub + u * L;
          if (t < len) {
            const float4 p = tp[u * L];
            const float d2 = t < lv ? knn_topk::dist2(p.x, p.y, p.z, qx, qy, qz) : kBig;
            if (d2 <= w) marked |= 1u << u;
          }
        }
      }
      while (marked) {
        const int u = __ffs(marked) - 1;
        marked &= marked - 1;
        const int t = t0 + sub + u * L;
        const float4 p = tp[u * L];
        const float d2 = t < lv ? knn_topk::dist2(p.x, p.y, p.z, qx, qy, qz) : kBig;
        // index order: a distance equal to the current worst never enters
        if (d2 < best.worst()) best.insert_in_order(d2, base + t);
      }
    }
  }
}

// One query's fans from its group's lane lists (screened_scan's): the
// k-round merge, then the lane epilogue into qout (G*C floats of shared
// memory).  row: the query's shared row (row_floats).  Called by every lane
// of the warp.
template <int L, int KMAX>
__device__ __forceinline__ void query_fans(knn_topk::List<KMAX>& best,
                                           const float* __restrict__ src, float qx, float qy,
                                           float qz, const Opts& o, int sub, float* row,
                                           float* qout) {
  const int k = o.g + o.skip;
  int* nb = reinterpret_cast<int*>(row);
  float* phi = row + k;
  // the merged (d^2, index) pairs reach every lane of the group; lane
  // r mod L keeps pair r's index (a missing slot: point 0) in the row
  knn_topk::merge_lanes<L>(best, k, [&](int r, float d, int i) {
    if ((r & (L - 1)) == sub) nb[r] = d >= kBig ? 0 : i;
  });
  __syncwarp();
  lane_fan_features<L>(nb + o.skip, src, qx, qy, qz, o, phi, phi + o.g, phi + 2 * o.g,
                       phi + 3 * o.g, sub, knn_topk::kFullMask, qout);
}

// The body of the tq and full kernels: Q queries a block, L lanes each, the
// block's contiguous span of the output staged and written by store_span.
template <int L, int Q, int KMAX>
__device__ __forceinline__ void group_block(const float* __restrict__ xyz,
                                            const int* __restrict__ valid, int n, const Opts& o,
                                            float* __restrict__ out) {
  constexpr int NT = Q * L;
  extern __shared__ float4 smem4[];
  float4* tile = smem4;
  float* stage = reinterpret_cast<float*>(smem4 + kTile);
  float* rows = stage + span_floats(Q, o);

  const int b = blockIdx.y;
  const int sub = threadIdx.x & (L - 1);
  const int ql = threadIdx.x / L;
  const int q0 = blockIdx.x * Q;
  const int q = q0 + ql;
  const int nv = valid == nullptr ? n : valid[b];
  const float* src = xyz + (size_t)b * n * 3;
  // a group past N scans, merges and fans all the same: the shuffles need
  // the whole warp, the barriers the whole block; only its stores are cut
  const bool live = q < n;
  const float qx = live ? src[q * 3 + 0] : 0.0f;
  const float qy = live ? src[q * 3 + 1] : 0.0f;
  const float qz = live ? src[q * 3 + 2] : 0.0f;
  knn_topk::List<KMAX> best;
  screened_scan<L, NT>(src, n, nv, tile, qx, qy, qz, sub, best);
  const int gc = o.g * o.c;
  float* dst = out + ((size_t)b * n + q0) * gc;
  // stage[pad + e] holds the span's element e (knn_topk::store_span)
  const int pad = knn_topk::span_pad(dst);
  query_fans<L>(best, src, qx, qy, qz, o, sub, rows + ql * row_floats(o), stage + pad + ql * gc);
  __syncthreads();
  knn_topk::store_span(dst, stage, min(Q, n - q0) * gc, threadIdx.x, NT);
}

template <int KMAX, bool kFloor>
__global__ void __launch_bounds__(kTqQueries * kTqLanes)
    umbrella_tq_kernel(const float* __restrict__ xyz,
                       const int* __restrict__ valid, int n, Opts o,
                       float* __restrict__ out) {
  constexpr int L = kTqLanes;
  if constexpr (kFloor) {
    // the scan floor: the k best distances summed, so nothing is elided
    extern __shared__ float4 smem4[];
    const int b = blockIdx.y;
    const int sub = threadIdx.x & (L - 1);
    const int q = blockIdx.x * kTqQueries + threadIdx.x / L;
    const bool live = q < n;
    const float* src = xyz + (size_t)b * n * 3;
    knn_topk::List<KMAX> best;
    screened_scan<L, kTqQueries * L>(src, n, valid == nullptr ? n : valid[b], smem4,
                                     live ? src[q * 3 + 0] : 0.0f, live ? src[q * 3 + 1] : 0.0f,
                                     live ? src[q * 3 + 2] : 0.0f, sub, best);
    float acc = 0.0f;
    knn_topk::merge_lanes<L>(best, o.g + o.skip, [&](int, float d, int) { acc += d; });
    if (live && sub == 0) out[(size_t)b * n + q] = acc;
  } else {
    group_block<L, kTqQueries, KMAX>(xyz, valid, n, o, out);
  }
}

template <int KMAX, int W>
__global__ void __launch_bounds__(W * 32)
    umbrella_full_kernel(const float* __restrict__ xyz,
                         const int* __restrict__ valid, int n, Opts o,
                         float* __restrict__ out) {
  group_block<32, W, KMAX>(xyz, valid, n, o, out);
}

// One query's G*C row at dst from the lanes' epilogue output in stage
// (stage[pad + e], pad = span_pad(dst)): the group's L lanes store it.
template <int L>
__device__ __forceinline__ void store_row(float* __restrict__ dst, const float* stage, int gc,
                                          int sub) {
  __syncwarp(group_mask<L>());
  knn_topk::store_span(dst, stage, gc, sub, L);
}

// The window pass: a block takes 32 queries of slab blockIdx.x / 4 of
// sample blockIdx.y, four lanes each, against the slab's 3-slab window.
template <int KMAX>
__global__ void __launch_bounds__(kTqQueries * kTqLanes)
    umbrella_slab_kernel(const int* __restrict__ order,
                         const float* __restrict__ xyz,
                         const int* __restrict__ valid, int n, Opts o,
                         float* __restrict__ out, int* __restrict__ resolved,
                         int* __restrict__ fails) {
  constexpr int L = kTqLanes, Q = kTqQueries;
  extern __shared__ float4 smem4[];
  float4* win = smem4;
  float* stage = reinterpret_cast<float*>(smem4 + kWindow);
  float* rows = stage + Q * span_floats(1, o);
  const int b = blockIdx.y;
  const int s = blockIdx.x / (kSlab / Q);
  const int n_slabs = n / kSlab;
  const int c0 = min(max(s - 1, 0), n_slabs - 3);
  const int nv = valid == nullptr ? n : valid[b];
  const int* ob = order + (size_t)b * n;
  const float* src = xyz + (size_t)b * n * 3;
  // the window as (x, y, z, original index bits)
  for (int t = threadIdx.x; t < kWindow; t += Q * L) {
    const int j = ob[c0 * kSlab + t];
    win[t] = make_float4(src[j * 3 + 0], src[j * 3 + 1], src[j * 3 + 2], __int_as_float(j));
  }
  __syncthreads();

  const int sub = threadIdx.x & (L - 1);
  const int ql = threadIdx.x / L;
  const int qi = ob[blockIdx.x * Q + ql];  // the query's original index
  const float qx = src[qi * 3 + 0], qy = src[qi * 3 + 1], qz = src[qi * 3 + 2];
  const int k = o.g + o.skip;
  // lane sub: window slots t = sub (mod L), screened 32 at a time as in
  // screened_scan, the query's own slab first (the nearest x, so the bound
  // tightens before the other two slabs).  x-sorted, not index order: the
  // list inserts by the (d^2, original index) pair, whatever the order.
  knn_topk::List<KMAX> best;
  best.reset();
  for (int c = 0; c < 3; ++c) {
    static_assert(kSlab == 32 * L, "a slab is one chunk of the group's lanes");
    const int t0 = ((s - c0 + c) % 3) * kSlab;
    float w = best.worst();
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1)
      w = fminf(w, __shfl_xor_sync(knn_topk::kFullMask, w, off));
    const float4* tp = win + t0 + sub;
    unsigned marked = 0;
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      const float4 p = tp[u * L];
      const float d2 =
          __float_as_int(p.w) < nv ? knn_topk::dist2(p.x, p.y, p.z, qx, qy, qz) : kBig;
      if (d2 <= w) marked |= 1u << u;
    }
    while (marked) {
      const int u = __ffs(marked) - 1;
      marked &= marked - 1;
      const float4 p = tp[u * L];
      const int j = __float_as_int(p.w);
      best.insert_any_order(j < nv ? knn_topk::dist2(p.x, p.y, p.z, qx, qy, qz) : kBig, j);
    }
  }
  int* nb = reinterpret_cast<int*>(rows + ql * row_floats(o));
  float kd = kBig;
  knn_topk::merge_lanes<L>(best, k, [&](int r, float d, int i) {
    if ((r & (L - 1)) == sub) nb[r] = d >= kBig ? 0 : i;
    if (r == k - 1) kd = fminf(d, kBig);
  });
  // the guard (umbrella.py:827-830): the k-th distance must clear the
  // margin to the nearest x-excluded point.  Points left of the window
  // exist iff c0 > 0, right of it iff c0 < n_slabs - 3 and the window's last
  // point is valid (invalid points sort last).
  const float wlo = win[0].x, whi = win[kWindow - 1].x;
  const bool right_valid = __float_as_int(win[kWindow - 1].w) < nv;
  const float ml = c0 > 0 ? qx - wlo : kBig;
  const float mr = (c0 < n_slabs - 3 && right_valid) ? whi - qx : kBig;
  const float m = 0.999f * fmaxf(fminf(ml, mr), 0.0f);
  if ((kd >= m * m || kd >= kBig) && qi < nv) {
    // the re-solve pass writes this query's row
    if (sub == 0) fails[(size_t)b * n + atomicAdd(resolved + b, 1)] = qi;
    return;
  }
  // a good query's group goes on alone: the warp's other groups may be gone
  const unsigned mask = group_mask<L>();
  __syncwarp(mask);
  const int gc = o.g * o.c;
  float* dst = out + ((size_t)b * n + qi) * gc;
  float* qstage = stage + ql * span_floats(1, o);
  float* phi = reinterpret_cast<float*>(nb) + k;
  lane_fan_features<L>(nb + o.skip, src, qx, qy, qz, o, phi, phi + o.g, phi + 2 * o.g,
                       phi + 3 * o.g, sub, mask, qstage + knn_topk::span_pad(dst));
  store_row<L>(dst, qstage, gc, sub);
}

// The re-solve pass: the listed queries of sample blockIdx.y, 32 a block,
// the blocks striding over resolved[b].
template <int KMAX>
__global__ void __launch_bounds__(kTqQueries * kTqLanes)
    umbrella_slab_resolve_kernel(const float* __restrict__ xyz,
                                 const int* __restrict__ valid, int n, Opts o,
                                 const int* __restrict__ resolved,
                                 const int* __restrict__ fails, float* __restrict__ out) {
  constexpr int L = kTqLanes, Q = kTqQueries;
  extern __shared__ float4 smem4[];
  float4* tile = smem4;
  float* stage = reinterpret_cast<float*>(smem4 + kTile);
  float* rows = stage + Q * span_floats(1, o);
  const int b = blockIdx.y;
  const int sub = threadIdx.x & (L - 1);
  const int ql = threadIdx.x / L;
  const int nv = valid == nullptr ? n : valid[b];
  const float* src = xyz + (size_t)b * n * 3;
  const int count = resolved[b];
  const int gc = o.g * o.c;
  float* qstage = stage + ql * span_floats(1, o);
  for (int j0 = blockIdx.x * Q; j0 < count; j0 += gridDim.x * Q) {
    // a group past the list scans all the same (the barriers); no store
    const bool live = j0 + ql < count;
    const int qi = live ? fails[(size_t)b * n + j0 + ql] : 0;
    const float qx = src[qi * 3 + 0], qy = src[qi * 3 + 1], qz = src[qi * 3 + 2];
    knn_topk::List<KMAX> best;
    screened_scan<L, Q * L>(src, n, nv, tile, qx, qy, qz, sub, best);
    float* dst = out + ((size_t)b * n + qi) * gc;
    query_fans<L>(best, src, qx, qy, qz, o, sub, rows + ql * row_floats(o),
                  qstage + knn_topk::span_pad(dst));
    if (live) {
      store_row<L>(dst, qstage, gc, sub);
    }
  }
}

// Opts from the entry's flags; false for a shape the kernels do not take
bool make_opts(int k, int skip, int rotate, int dist, int seg, Opts* o) {
  o->skip = skip ? 1 : 0;
  o->rotate = rotate ? 1 : 0;
  o->g = k - o->skip;
  o->c = dist ? 10 : 9;
  if (!dist) {
    o->o_center = 0, o->o_polar = 3, o->o_normal = 6, o->o_pos = -1;
  } else if (seg) {
    o->o_polar = 0, o->o_normal = 3, o->o_pos = 6, o->o_center = 7;
  } else {
    o->o_center = 0, o->o_polar = 3, o->o_normal = 6, o->o_pos = 9;
  }
  return k >= 1 && k <= 17 && o->g >= 1;
}

template <typename F>
int dispatch(int k, F launch) {
  if (k <= 9) return launch(std::integral_constant<int, 9>{});
  return launch(std::integral_constant<int, 17>{});
}

// bytes of shared memory: every layout stays under the default 48 KB for
// G <= 16, C <= 10 (tq) and G * C <= 128 (full, slab)
size_t smem_bytes(int tile_float4s, int stage_floats, int queries, const Opts& o) {
  return sizeof(float) * (4 * tile_float4s + stage_floats + rows_floats(queries, o));
}

template <bool kFloor>
int tq_entry(const float* xyz, const int* valid, int batch, int n, int k, int skip, int rotate,
             int dist, int seg, float* out, cudaStream_t stream) {
  Opts o;
  if (!make_opts(k, skip, rotate, dist, seg, &o) || o.g > kMaxFans)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kTqQueries - 1) / kTqQueries, batch);
  const size_t smem = kFloor ? sizeof(float4) * kTile
                             : smem_bytes(kTile, span_floats(kTqQueries, o), kTqQueries, o);
  return dispatch(k, [&](auto kc) {
    umbrella_tq_kernel<decltype(kc)::value, kFloor>
        <<<grid, kTqQueries * kTqLanes, smem, stream>>>(xyz, valid, n, o, out);
    return (int)cudaGetLastError();
  });
}

template <int W, int KMAX>
int full_launch(const float* xyz, const int* valid, int batch, int n, const Opts& o, float* out,
                cudaStream_t stream) {
  const dim3 grid((n + W - 1) / W, batch);
  umbrella_full_kernel<KMAX, W><<<grid, W * 32, smem_bytes(kTile, span_floats(W, o), W, o),
                                  stream>>>(xyz, valid, n, o, out);
  return (int)cudaGetLastError();
}

bool slab_opts(int n, int k, int skip, int rotate, int dist, int seg, Opts* o) {
  return make_opts(k, skip, rotate, dist, seg, o) && o->g * o->c <= kMaxLanes &&
         n % kSlab == 0 && n >= kWindow;
}

}  // namespace

// All of them: xyz [B, N, 3] f32, valid [B] i32 or null, k the kNN size
// (k <= 17), skip / rotate / dist / seg the flags of the entry
// (drop_self, rotate, return_dist, style == 'seg'); out [B, N, G, C] f32.
// Each returns cudaGetLastError(), or cudaErrorInvalidValue for a shape it
// does not take.

// G <= 16
extern "C" int repsurf_umbrella_tq(const float* xyz, const int* valid,
                                   int batch, int n, int k, int skip,
                                   int rotate, int dist, int seg, float* out,
                                   cudaStream_t stream) {
  return tq_entry<false>(xyz, valid, batch, n, k, skip, rotate, dist, seg, out, stream);
}

// The same launch without the fan geometry and the feature stores: each
// query's k best squared distances summed into out [B, N] (a measurement of
// the scan and the merge, not a feature).
extern "C" int repsurf_umbrella_tq_scan_floor(const float* xyz, const int* valid, int batch,
                                              int n, int k, int skip, int rotate, int dist,
                                              int seg, float* out, cudaStream_t stream) {
  return tq_entry<true>(xyz, valid, batch, n, k, skip, rotate, dist, seg, out, stream);
}

// G * C <= 128
extern "C" int repsurf_umbrella_full(const float* xyz, const int* valid,
                                     int batch, int n, int k, int skip,
                                     int rotate, int dist, int seg, float* out,
                                     cudaStream_t stream) {
  Opts o;
  if (!make_opts(k, skip, rotate, dist, seg, &o) || o.g * o.c > kMaxLanes)
    return (int)cudaErrorInvalidValue;
  return dispatch(k, [&](auto kc) {
    return full_launch<kFullWarps, decltype(kc)::value>(xyz, valid, batch, n, o, out, stream);
  });
}

// The full kernel at `warps` queries a block (8, 16 or 32; k <= 9): the
// block-size sweep behind kFullWarps, a measurement.
extern "C" int repsurf_umbrella_full_warps(const float* xyz, const int* valid, int batch, int n,
                                           int k, int skip, int rotate, int dist, int seg,
                                           int warps, float* out, cudaStream_t stream) {
  Opts o;
  if (!make_opts(k, skip, rotate, dist, seg, &o) || o.g * o.c > kMaxLanes || k > 9)
    return (int)cudaErrorInvalidValue;
  if (warps == 8) return full_launch<8, 9>(xyz, valid, batch, n, o, out, stream);
  if (warps == 16) return full_launch<16, 9>(xyz, valid, batch, n, o, out, stream);
  if (warps == 32) return full_launch<32, 9>(xyz, valid, batch, n, o, out, stream);
  return (int)cudaErrorInvalidValue;
}

// The slab's window pass.  G * C <= 128, N % 128 == 0 and N >= 384.  order
// [B, N] i32: each sample's point indices x-sorted (invalid points last);
// out in the original point order, the rows of the failing queries left
// unwritten; resolved [B] i32, zero on entry, their count on exit; fails
// [B, N] i32, their indices in its first resolved[b] slots (in no set
// order).
extern "C" int repsurf_umbrella_slab(const int* order, const float* xyz,
                                     const int* valid, int batch, int n,
                                     int k, int skip, int rotate, int dist,
                                     int seg, float* out, int* resolved, int* fails,
                                     cudaStream_t stream) {
  Opts o;
  if (!slab_opts(n, k, skip, rotate, dist, seg, &o)) return (int)cudaErrorInvalidValue;
  const dim3 grid(n / kTqQueries, batch);
  const size_t smem = smem_bytes(kWindow, kTqQueries * span_floats(1, o), kTqQueries, o);
  return dispatch(k, [&](auto kc) {
    umbrella_slab_kernel<decltype(kc)::value><<<grid, kTqQueries * kTqLanes, smem, stream>>>(
        order, xyz, valid, n, o, out, resolved, fails);
    return (int)cudaGetLastError();
  });
}

// The slab's re-solve pass, on the window pass's outputs: the rows of the
// listed queries over the whole valid cloud; `blocks` blocks a sample stride
// over its list.
extern "C" int repsurf_umbrella_slab_resolve(const float* xyz, const int* valid, int batch,
                                             int n, int k, int skip, int rotate, int dist,
                                             int seg, const int* resolved, const int* fails,
                                             int blocks, float* out, cudaStream_t stream) {
  Opts o;
  if (!slab_opts(n, k, skip, rotate, dist, seg, &o) || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks, batch);
  const size_t smem = smem_bytes(kTile, kTqQueries * span_floats(1, o), kTqQueries, o);
  return dispatch(k, [&](auto kc) {
    umbrella_slab_resolve_kernel<decltype(kc)::value>
        <<<grid, kTqQueries * kTqLanes, smem, stream>>>(xyz, valid, n, o, resolved, fails, out);
    return (int)cudaGetLastError();
  });
}
