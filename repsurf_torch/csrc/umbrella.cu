// Fused umbrella geometry: three kernels that compute one function, each
// the counterpart of one Pallas kernel of repsurf_tpu/ops/pallas/umbrella.py.
//
//   umbrella_tq_kernel    replaces _umbrella_tq_kernel (:302), one thread
//                         per query;
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
//   * tq: the candidates are tiled through shared memory, so the cloud
//     leaves device memory once per block of 128 queries; each thread keeps
//     its k best in registers.  Many queries per sample fill the card.
//   * full: the TPU kernel spreads one query's scan across lanes; here one
//     warp takes one query, each lane scans every 32nd candidate of a shared
//     tile with its own k-best list, and the warp merges the 32 lists in k
//     rounds of a shuffle arg-min on (d^2, index).  32 lanes per query keep
//     the card busy when there are few queries.
//   * slab: one block per (sample, slab), the 3-slab window staged once in
//     shared memory, one thread per query.
// All three run the same fan geometry (fan_features below, the counterpart
// of _fan_geometry_pack / _fan_geometry_pack_tq) in registers: nothing but
// the features (and the slab's two guard values) is written.
//
// The list length is a template parameter KMAX (9 or 17) and k a runtime
// value k <= KMAX: every index into the per-thread arrays must be a
// compile-time constant for them to stay in registers, and two lengths keep
// the models' k = 9 tight while k up to 17 (G <= 16, the JAX auto bound)
// still works.  Style, rotation and the plane constant are runtime flags,
// uniform over a launch, so each kernel has two instantiations, not sixteen.
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

constexpr int kThreads = 128;     // tq: queries per block
constexpr int kTile = 256;        // tq, full: candidates per shared tile
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

struct Fan {
  float cx, cy, cz, ux, uy, uz, pv;
  bool deg;
};

// triangle (origin, a, b): signed unit normal, centroid, plane constant
__device__ __forceinline__ Fan make_fan(float ax, float ay, float az, float bx,
                                        float by, float bz, float sign) {
  Fan f;
  const float nx = ay * bz - az * by;
  const float ny = az * bx - ax * bz;
  const float nz = ax * by - ay * bx;
  const float s2 = nx * nx + ny * ny + nz * nz;
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

// Fan geometry from the neighbours' coordinates relative to q, in kNN
// order (gx[g], g < o.g), into one point's G*C outputs.
template <int KMAX>
__device__ __forceinline__ void fan_features(const float (&gx)[KMAX],
                                             const float (&gy)[KMAX],
                                             const float (&gz)[KMAX],
                                             const Opts& o,
                                             float* __restrict__ out) {
  const int G = o.g;
  float phi[KMAX];
#pragma unroll
  for (int g = 0; g < KMAX; ++g) {
    float x = gx[g], y = gy[g];
    if (o.rotate) {
      x = kR00 * gx[g] + kR10 * gy[g] + kR20 * gz[g];
      y = kR01 * gx[g] + kR11 * gy[g] + kR21 * gz[g];
    }
    phi[g] = azimuth(x, y);
  }
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
#define UMB_FAN(g, sign)                                                   \
  make_fan(sx[g], sy[g], sz[g], (g) + 1 < G ? sx[((g) + 1) % KMAX] : sx[0], \
           (g) + 1 < G ? sy[((g) + 1) % KMAX] : sy[0],                     \
           (g) + 1 < G ? sz[((g) + 1) % KMAX] : sz[0], sign)
  const float sign = UMB_FAN(0, 1.0f).ux > 0.0f ? 1.0f : -1.0f;
  // the first good fan (fan 0 when every fan is degenerate)
  Fan rep = UMB_FAN(0, sign);
  bool found = false;
#pragma unroll
  for (int g = KMAX - 1; g >= 0; --g) {
    if (g < G) {
      const Fan f = UMB_FAN(g, sign);
      if (!f.deg || (g == 0 && !found)) {
        rep = f;
        found = true;
      }
    }
  }
  const float pi = (float)M_PI;
#pragma unroll
  for (int g = 0; g < KMAX; ++g) {
    if (g >= G) continue;
    const Fan f = UMB_FAN(g, sign);
    const Fan r = f.deg ? rep : f;
    // xyz2sphere of the fan's own (unrepaired) centroid
    const float s2c = f.cx * f.cx + f.cy * f.cy + f.cz * f.cz;
    const bool zero = s2c == 0.0f;
    const float rho = zero ? 0.0f : sqrtf(s2c);
    const float u = fminf(fmaxf(f.cz / (zero ? 1.0f : rho), -1.0f), 1.0f);
    const float th = fabsf(u) >= 1.0f ? (u > 0.0f ? 0.0f : pi) : acosf(u);
    float* p = out + g * o.c;
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
#undef UMB_FAN
}

// From a finished k-best list of (d^2, index) to the point's features:
// drop column 0 when skipping, take the fan neighbours relative to q from
// src [N, 3] (a missing slot: point 0), run the fan geometry.
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

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
    umbrella_tq_kernel(const float* __restrict__ xyz,
                       const int* __restrict__ valid, int n, Opts o,
                       float* __restrict__ out) {
  __shared__ float tx[kTile], ty[kTile], tz[kTile];
  const int b = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const int nv = valid == nullptr ? n : valid[b];
  const float* src = xyz + (size_t)b * n * 3;
  const bool live = q < n;
  const float qx = live ? src[q * 3 + 0] : 0.0f;
  const float qy = live ? src[q * 3 + 1] : 0.0f;
  const float qz = live ? src[q * 3 + 2] : 0.0f;

  knn_topk::List<KMAX> best;
  best.reset();
  for (int base = 0; base < n; base += kTile) {
    __syncthreads();
    for (int t = threadIdx.x; t < kTile && base + t < n; t += kThreads) {
      const int j = base + t;
      tx[t] = src[j * 3 + 0];
      ty[t] = src[j * 3 + 1];
      tz[t] = src[j * 3 + 2];
    }
    __syncthreads();
    const int len = min(kTile, n - base);
    for (int t = 0; t < len; ++t) {
      const int j = base + t;
      float d2 = knn_topk::dist2(tx[t], ty[t], tz[t], qx, qy, qz);
      if (j >= nv) d2 = kBig;
      // candidates arrive in index order: a distance equal to the current
      // worst never enters, so the test on the distance alone suffices
      if (d2 < best.worst()) best.insert(d2, j);
    }
  }
  if (!live) return;
  emit<KMAX>(best, src, qx, qy, qz, o, out + ((size_t)b * n + q) * o.g * o.c);
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
  Opts o;
  if (!make_opts(k, skip, rotate, dist, seg, &o) || o.g > kMaxFans)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  return dispatch(k, [&](auto kc) {
    umbrella_tq_kernel<decltype(kc)::value>
        <<<grid, kThreads, 0, stream>>>(xyz, valid, n, o, out);
    return (int)cudaGetLastError();
  });
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
