// Fused umbrella geometry: three kernels that compute one function, each
// the counterpart of one Pallas kernel of repsurf_tpu/ops/pallas/umbrella.py.
//
//   umbrella_tq_kernel    replaces _umbrella_tq_kernel (:302), an aligned
//                         group of kTqLanes = 4 lanes per query;
//   umbrella_full_kernel  replaces _umbrella_kernel (:88), one warp per
//                         query;
//   umbrella_slab_kernel  replaces _umbrella_slab_kernel (:606), x-sorted
//                         slabs of 128 queries against a 3-slab window, with
//                         the exactness guard's outputs.
//
// What bounds them on the H100: the k-nearest-neighbour scan.  The tq and
// full kernels test all N candidates of every query, a few flops and a
// compare each: O(N^2) instruction-bound work per sample against an output of
// G*C floats per query.  The slab kernel tests 384 candidates per query and
// leaves the queries its window cannot vouch for to the wrapper's re-solve.
// What the designs do about it:
//   * tq: 32 queries a block, L = kTqLanes = 4 lanes each.  The candidates
//     are tiled through shared memory as float4, so the cloud leaves L2
//     once per block; each lane scans every L-th candidate
//     of a tile into its own k-best list in registers, screening 32
//     candidates at a time against the group's smallest k-th distance and
//     inserting the few that pass afterwards, in index order (a warp whose
//     lanes insert at different candidates would otherwise take the
//     insertion path at nearly every candidate), and the group merges its
//     lists in k shuffle rounds (merge_lanes, knn_topk.cuh).  The fan
//     geometry is split over the group too: lane s takes the neighbours and
//     fans g = s (mod L); the azimuths, the sorted neighbours and the merged
//     indices meet in a per-query row of shared memory; the sign comes from
//     fan 0's lane by a shuffle and the first good fan from a group minimum.
//     Each query's G*C features land in a shared-memory stage, and the block
//     writes its queries' contiguous span with 16-byte stores from
//     consecutive threads.  Four lanes were the fastest split measured at
//     every path shape (the cls eval batch, R2's passes): fewer leave the
//     card under-filled and the epilogue serial, more keep more part-filled
//     lists and merge longer.
//   * full: the TPU kernel spreads one query's scan across lanes; here one
//     warp takes one query, each lane scans every 32nd candidate of a shared
//     tile with its own k-best list, and the warp merges the 32 lists in k
//     rounds of a shuffle arg-min on (d^2, index); lane 0 runs the
//     one-thread epilogue.
//   * slab: one block per (sample, slab), the 3-slab window staged once in
//     shared memory, one thread per query.
// Every form builds its fans with the same two functions (make_fan and
// put_fan below, the counterparts of _fan_geometry_pack /
// _fan_geometry_pack_tq), so the kernels stay bit-equal to one another.
// repsurf_umbrella_tq_scan_floor is the tq launch without the fan geometry
// and the feature stores: the scan and merge alone, for the measurement.
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

constexpr int kTqQueries = 32;    // tq: queries per block
constexpr int kTqLanes = 4;       // tq: lanes per query
constexpr int kTqTile = 512;      // tq: candidates per shared tile
constexpr int kTile = 256;        // full: candidates per shared tile
constexpr int kFullWarps = 8;     // full: queries (warps) per block
constexpr int kSlab = 128;        // slab: points per slab, queries per block
constexpr int kWindow = 3 * kSlab;
constexpr int kMaxFans = 16;      // tq: G <= 16
constexpr int kMaxLanes = 128;    // full, slab: G * C <= 128

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

// The one-thread epilogue: fan geometry from the neighbours' coordinates
// relative to q, in kNN order (gx[g], g < o.g), into one point's G*C
// outputs.
template <int KMAX>
__device__ __forceinline__ void fan_features(const float (&gx)[KMAX],
                                             const float (&gy)[KMAX],
                                             const float (&gz)[KMAX],
                                             const Opts& o,
                                             float* __restrict__ out) {
  const int G = o.g;
  float phi[KMAX];
#pragma unroll
  for (int g = 0; g < KMAX; ++g) phi[g] = fan_azimuth(gx[g], gy[g], gz[g], o.rotate);
  // stable ascending rank, then the coordinates in sorted order
  int rank[KMAX];
#pragma unroll
  for (int g = 0; g < KMAX; ++g) {
    int r = 0;
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < G) r += (phi[j] < phi[g]) || (phi[j] == phi[g] && j < g);
    rank[g] = r;
  }
  float sx[KMAX], sy[KMAX], sz[KMAX];
#pragma unroll
  for (int r = 0; r < KMAX; ++r) {
    sx[r] = 0.0f;
    sy[r] = 0.0f;
    sz[r] = 0.0f;
#pragma unroll
    for (int g = 0; g < KMAX; ++g) {
      if (g < G && rank[g] == r) {
        sx[r] = gx[g];
        sy[r] = gy[g];
        sz[r] = gz[g];
      }
    }
  }
// fan g pairs sorted g with its successor, sorted (g + 1) mod G
#define UMB_B(arr, g) ((g) + 1 < G ? arr[((g) + 1) % KMAX] : arr[0])
  const float sign =
      make_fan(sx[0], sy[0], sz[0], UMB_B(sx, 0), UMB_B(sy, 0), UMB_B(sz, 0), 1.0f).ux > 0.0f
          ? 1.0f
          : -1.0f;
  // the first good fan (fan 0 when every fan is degenerate)
  float ax = sx[0], ay = sy[0], az = sz[0];
  float bx = UMB_B(sx, 0), by = UMB_B(sy, 0), bz = UMB_B(sz, 0);
#pragma unroll
  for (int g = KMAX - 1; g >= 0; --g) {
    float nx, ny, nz;
    if (g < G && cross(sx[g], sy[g], sz[g], UMB_B(sx, g), UMB_B(sy, g), UMB_B(sz, g), nx, ny,
                       nz) != 0.0f) {
      ax = sx[g], ay = sy[g], az = sz[g];
      bx = UMB_B(sx, g), by = UMB_B(sy, g), bz = UMB_B(sz, g);
    }
  }
  const Fan rep = make_fan(ax, ay, az, bx, by, bz, sign);
#pragma unroll
  for (int g = 0; g < KMAX; ++g) {
    if (g >= G) continue;
    const Fan f = make_fan(sx[g], sy[g], sz[g], UMB_B(sx, g), UMB_B(sy, g), UMB_B(sz, g), sign);
    if (f.deg) {
      put_fan(f, rep, o, out + g * o.c);
    } else {
      put_fan(f, f, o, out + g * o.c);
    }
  }
#undef UMB_B
}

// From a finished k-best list of (d^2, index) to the point's features:
// drop column 0 when skipping, take the fan neighbours relative to q from
// src [N, 3] (a missing slot: point 0), run the one-thread epilogue.
template <int KMAX>
__device__ __forceinline__ void emit(knn_topk::List<KMAX>& best,
                                     const float* __restrict__ src, float qx,
                                     float qy, float qz, const Opts& o,
                                     float* __restrict__ out) {
  if (o.skip) {
#pragma unroll
    for (int s = 0; s < KMAX - 1; ++s) {
      best.d[s] = best.d[s + 1];
      best.i[s] = best.i[s + 1];
    }
  }
  float gx[KMAX], gy[KMAX], gz[KMAX];
#pragma unroll
  for (int g = 0; g < KMAX; ++g) {
    gx[g] = 0.0f;
    gy[g] = 0.0f;
    gz[g] = 0.0f;
    if (g < o.g) {
      const int j = best.d[g] >= kBig ? 0 : best.i[g];
      gx[g] = src[j * 3 + 0] - qx;
      gy[g] = src[j * 3 + 1] - qy;
      gz[g] = src[j * 3 + 2] - qz;
    }
  }
  fan_features<KMAX>(gx, gy, gz, o, out);
}

// The group epilogue of L lanes: lane `sub` takes the neighbours and the
// fans g = sub (mod L).  nb[0 .. G) are the query's neighbour indices in
// kNN order (self column already dropped); phi, rx, ry, rz the query's
// shared row (G floats each); out its G*C outputs.  Called by every lane of
// the warp together (the shuffles name the whole warp).
template <int L>
__device__ __forceinline__ void lane_fan_features(const int* nb, const float* __restrict__ src,
                                                  float qx, float qy, float qz, const Opts& o,
                                                  float* phi, float* rx, float* ry, float* rz,
                                                  int sub, float* out) {
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
  __syncwarp();
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
  __syncwarp();
  // the sign, from fan 0 on the group's first lane
  const int lane = threadIdx.x & 31;
  const int lead = lane & ~(L - 1);
  float sign = 1.0f;
  if (sub == 0) {
    const int h = successor(0, G);
    sign = make_fan(rx[0], ry[0], rz[0], rx[h], ry[h], rz[h], 1.0f).ux > 0.0f ? 1.0f : -1.0f;
  }
  sign = __shfl_sync(knn_topk::kFullMask, sign, lead);
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
    first = min(first, __shfl_xor_sync(knn_topk::kFullMask, first, off));
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

// The tq kernel's shared memory: the candidate tile, the output stage of
// the block's 32 queries (3 floats of slack for the span's alignment), and
// a row per query (the merged indices, the azimuths, the sorted
// neighbours).  In floats, each part a multiple of 4.
struct TqLayout {
  int stage, row;

  __host__ __device__ static TqLayout of(const Opts& o, bool scan_only) {
    TqLayout t;
    t.stage = scan_only ? 0 : (kTqQueries * o.g * o.c + 3 + 3) & ~3;
    t.row = scan_only ? 0 : (o.g + o.skip) + 4 * o.g;
    return t;
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * (4 * kTqTile + stage + ((kTqQueries * row + 3) & ~3));
  }
};

template <int KMAX, bool kFloor>
__global__ void __launch_bounds__(kTqQueries * kTqLanes)
    umbrella_tq_kernel(const float* __restrict__ xyz,
                       const int* __restrict__ valid, int n, Opts o,
                       float* __restrict__ out) {
  constexpr int L = kTqLanes;
  extern __shared__ float4 smem4[];
  float4* tile = smem4;
  const TqLayout lay = TqLayout::of(o, kFloor);
  float* stage = reinterpret_cast<float*>(smem4 + kTqTile);
  float* rows = stage + lay.stage;

  const int b = blockIdx.y;
  const int sub = threadIdx.x & (L - 1);
  const int ql = threadIdx.x / L;
  const int q0 = blockIdx.x * kTqQueries;
  const int q = q0 + ql;
  const int nv = valid == nullptr ? n : valid[b];
  const int k = o.g + o.skip;
  const float* src = xyz + (size_t)b * n * 3;
  // a group past N scans, merges and fans all the same: the shuffles need
  // the whole warp, the barriers the whole block; only its stores are cut
  const bool live = q < n;
  const float qx = live ? src[q * 3 + 0] : 0.0f;
  const float qy = live ? src[q * 3 + 1] : 0.0f;
  const float qz = live ? src[q * 3 + 2] : 0.0f;

  // each lane: every L-th candidate, in index order, into its own k best.
  // A chunk of 32 of the lane's candidates is screened against an upper
  // bound on the query's k-th distance, taken at the chunk's start, into a
  // bit mask; the marked ones are then inserted in index order, each
  // against the lane's own current k-th.  A warp so takes the insertion
  // path once per marked candidate of its busiest lane, not once per
  // candidate that any lane inserts.  The bound is the group's least k-th
  // (min over its lanes of each list's end): a candidate above it cannot
  // reach the merged k best; one equal to it may, so it is kept.
  knn_topk::List<KMAX> best;
  best.reset();
  for (int base = 0; base < n; base += kTqTile) {
    __syncthreads();
    for (int t = threadIdx.x; t < kTqTile && base + t < n; t += kTqQueries * L) {
      const float* p = src + (size_t)(base + t) * 3;
      tile[t] = make_float4(p[0], p[1], p[2], 0.0f);
    }
    __syncthreads();
    const int len = min(kTqTile, n - base);
    const int lv = min(len, nv - base);  // the tile's valid candidates; the rest sit at 1e10
    for (int t0 = 0; t0 < len; t0 += 32 * L) {  // the same trip count on every lane
      float w = best.worst();
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1)
        w = fminf(w, __shfl_xor_sync(knn_topk::kFullMask, w, off));
      unsigned marked = 0;
      const float4* tp = tile + t0 + sub;
      if (t0 + 32 * L <= lv) {  // a whole chunk of valid candidates
#pragma unroll
        for (int u = 0; u < 32; ++u) {
          const float4 p = tp[u * L];
          if (knn_topk::dist2(p.x, p.y, p.z, qx, qy, qz) <= w) marked |= 1u << u;
        }
      } else {
#pragma unroll
        for (int u = 0; u < 32; ++u) {
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

  if constexpr (kFloor) {
    // the scan floor: the k best distances summed, so nothing is elided
    float acc = 0.0f;
    knn_topk::merge_lanes<L>(best, k, [&](int, float d, int) { acc += d; });
    if (live && sub == 0) out[(size_t)b * n + q] = acc;
    return;
  } else {
    const int gc = o.g * o.c;
    float* dst = out + ((size_t)b * n + q0) * gc;
    // stage[pad + e] holds the span's element e (knn_topk::store_span)
    const int pad = knn_topk::span_pad(dst);
    float* qout = stage + pad + ql * gc;
    int* nb = reinterpret_cast<int*>(rows + ql * lay.row);
    float* phi = rows + ql * lay.row + k;
    // the merged (d^2, index) pairs reach every lane of the group; lane
    // r mod L keeps pair r's index (a missing slot: point 0) in the row
    knn_topk::merge_lanes<L>(best, k, [&](int r, float d, int i) {
      if ((r & (L - 1)) == sub) nb[r] = d >= kBig ? 0 : i;
    });
    __syncwarp();
    lane_fan_features<L>(nb + o.skip, src, qx, qy, qz, o, phi, phi + o.g, phi + 2 * o.g,
                         phi + 3 * o.g, sub, qout);
    __syncthreads();
    knn_topk::store_span(dst, stage, min(kTqQueries, n - q0) * gc, threadIdx.x,
                         kTqQueries * L);
  }
}

template <int KMAX>
__global__ void __launch_bounds__(kFullWarps * 32)
    umbrella_full_kernel(const float* __restrict__ xyz,
                         const int* __restrict__ valid, int n, int k, Opts o,
                         float* __restrict__ out) {
  __shared__ float tx[kTile], ty[kTile], tz[kTile];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kFullWarps + (threadIdx.x >> 5);
  const int nv = valid == nullptr ? n : valid[b];
  const float* src = xyz + (size_t)b * n * 3;
  const bool live = q < n;  // uniform over the warp
  const float qx = live ? src[q * 3 + 0] : 0.0f;
  const float qy = live ? src[q * 3 + 1] : 0.0f;
  const float qz = live ? src[q * 3 + 2] : 0.0f;

  // each lane: every 32nd candidate, in index order, its own k best
  knn_topk::List<KMAX> best;
  best.reset();
  for (int base = 0; base < n; base += kTile) {
    __syncthreads();
    for (int t = threadIdx.x; t < kTile && base + t < n; t += kFullWarps * 32) {
      const int j = base + t;
      tx[t] = src[j * 3 + 0];
      ty[t] = src[j * 3 + 1];
      tz[t] = src[j * 3 + 2];
    }
    __syncthreads();
    const int len = min(kTile, n - base);
    for (int t = lane; t < len; t += 32) {
      const int j = base + t;
      float d2 = knn_topk::dist2(tx[t], ty[t], tz[t], qx, qy, qz);
      if (j >= nv) d2 = kBig;
      if (d2 < best.worst()) best.insert(d2, j);
    }
  }
  if (!live) return;

  // k rounds of the warp's arg-min on (d^2, index) (knn_topk.cuh)
  knn_topk::List<KMAX> merged;
  merged.reset();
  knn_topk::merge_lanes<32>(best, k, [&](int r, float d, int i) {
    merged.d[r] = d;
    merged.i[r] = i;
  });
  if (lane != 0) return;
  emit<KMAX>(merged, src, qx, qy, qz, o, out + ((size_t)b * n + q) * o.g * o.c);
}

template <int KMAX>
__global__ void __launch_bounds__(kSlab)
    umbrella_slab_kernel(const float4* __restrict__ table,
                         const float* __restrict__ xyz,
                         const int* __restrict__ valid, int n, int k, Opts o,
                         float* __restrict__ out, float* __restrict__ kth,
                         float* __restrict__ margin) {
  __shared__ float4 win[kWindow];
  const int b = blockIdx.y;
  const int s = blockIdx.x;
  const int n_slabs = n / kSlab;
  const int c0 = min(max(s - 1, 0), n_slabs - 3);
  const int nv = valid == nullptr ? n : valid[b];
  const float4* tb = table + (size_t)b * n;
  for (int t = threadIdx.x; t < kWindow; t += kSlab) win[t] = tb[c0 * kSlab + t];
  __syncthreads();

  const float4 qp = tb[s * kSlab + threadIdx.x];
  const int qi = (int)qp.w;  // the query's original index
  knn_topk::List<KMAX> best;
  best.reset();
  for (int t = 0; t < kWindow; ++t) {
    const float4 p = win[t];
    const int j = (int)p.w;
    float d2 = knn_topk::dist2(p.x, p.y, p.z, qp.x, qp.y, qp.z);
    if (j >= nv) d2 = kBig;
    // x-sorted, not index order: the list compares (d^2, original index)
    best.insert(d2, j);
  }
  float kd = kBig;
#pragma unroll
  for (int r = 0; r < KMAX; ++r)
    if (r == k - 1) kd = fminf(best.d[r], kBig);
  // margin to the nearest x-excluded point: points left of the window exist
  // iff c0 > 0, right of it iff c0 < n_slabs - 3 and the window's last point
  // is valid (invalid points sort last)
  const float wlo = win[0].x, whi = win[kWindow - 1].x;
  const bool right_valid = (int)win[kWindow - 1].w < nv;
  const float ml = c0 > 0 ? qp.x - wlo : kBig;
  const float mr = (c0 < n_slabs - 3 && right_valid) ? whi - qp.x : kBig;
  const size_t row = (size_t)b * n + qi;
  kth[row] = kd;
  margin[row] = fmaxf(fminf(ml, mr), 0.0f);
  emit<KMAX>(best, xyz + (size_t)b * n * 3, qp.x, qp.y, qp.z, o,
             out + row * o.g * o.c);
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

template <bool kFloor>
int tq_entry(const float* xyz, const int* valid, int batch, int n, int k, int skip, int rotate,
             int dist, int seg, float* out, cudaStream_t stream) {
  Opts o;
  if (!make_opts(k, skip, rotate, dist, seg, &o) || o.g > kMaxFans)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kTqQueries - 1) / kTqQueries, batch);
  const size_t smem = TqLayout::of(o, kFloor).bytes();  // under 48 KB: G <= 16, C <= 10
  return dispatch(k, [&](auto kc) {
    umbrella_tq_kernel<decltype(kc)::value, kFloor>
        <<<grid, kTqQueries * kTqLanes, smem, stream>>>(xyz, valid, n, o, out);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// All three: xyz [B, N, 3] f32, valid [B] i32 or null, k the kNN size
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
  const dim3 grid((n + kFullWarps - 1) / kFullWarps, batch);
  return dispatch(k, [&](auto kc) {
    umbrella_full_kernel<decltype(kc)::value>
        <<<grid, kFullWarps * 32, 0, stream>>>(xyz, valid, n, k, o, out);
    return (int)cudaGetLastError();
  });
}

// G * C <= 128, N % 128 == 0 and N >= 384.  table [B, N, 4] f32: each
// sample x-sorted (invalid points last), rows (x, y, z, original index);
// out, kth [B, N] and margin [B, N] in the original point order.
extern "C" int repsurf_umbrella_slab(const float* table, const float* xyz,
                                     const int* valid, int batch, int n,
                                     int k, int skip, int rotate, int dist,
                                     int seg, float* out, float* kth,
                                     float* margin, cudaStream_t stream) {
  Opts o;
  if (!make_opts(k, skip, rotate, dist, seg, &o) || o.g * o.c > kMaxLanes ||
      n % kSlab != 0 || n < kWindow)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n / kSlab, batch);
  return dispatch(k, [&](auto kc) {
    umbrella_slab_kernel<decltype(kc)::value><<<grid, kSlab, 0, stream>>>(
        reinterpret_cast<const float4*>(table), xyz, valid, n, k, o, out, kth,
        margin);
    return (int)cudaGetLastError();
  });
}
