// The k-best list shared by the kNN kernels (knn.cu, knn_window.cu,
// umbrella.cu), the merges that split one query's scan over lanes, and the
// staged span store of the umbrella and ball-feature kernels.
//
// One thread keeps its K best (squared distance, point index) pairs sorted
// ascending by the pair: a smaller distance first, and the lower index first
// among equal distances.  Comparing the pair, and not the distance alone,
// makes the result independent of the order the candidates arrive in: the
// window kernel scans them in grid-cell order, not index order.
//
// For K <= 32 the list lives in registers: every index into it is a
// compile-time constant, so an insertion is one unrolled compare-and-swap
// pass.  Longer lists sit in local memory and shift with an early stop.
//
// A query whose scan is split over lanes (each lane its own list over its
// share of the candidates) gets its k best back in k rounds of an arg-min
// on the pair over the lanes' heads: merge_lanes within a warp by shuffles,
// merge_rows across the warps of a block through shared memory.  A point
// index appears in one lane's share only, so the merged list is the one a
// single list over every candidate would hold, bit for bit.

#pragma once

#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace knn_topk {

// a missing neighbour, and every point at or beyond valid[b], sits here
constexpr float kBig = 1e10f;

__device__ __forceinline__ bool before(float d, int i, float od, int oi) {
  return d < od || (d == od && i < oi);
}

template <int K>
struct List {
  float d[K];
  int i[K];

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      d[s] = INFINITY;
      i[s] = 0x7fffffff;
    }
  }

  __device__ __forceinline__ float worst() const { return d[K - 1]; }

  __device__ __forceinline__ void insert(float dd, int ii) {
    if (!before(dd, ii, d[K - 1], i[K - 1])) return;
    if constexpr (K <= 32) {
      d[K - 1] = dd;
      i[K - 1] = ii;
#pragma unroll
      for (int s = K - 1; s > 0; --s) {
        if (before(d[s], i[s], d[s - 1], i[s - 1])) {
          const float td = d[s];
          d[s] = d[s - 1];
          d[s - 1] = td;
          const int ti = i[s];
          i[s] = i[s - 1];
          i[s - 1] = ti;
        }
      }
    } else {
      int s = K - 1;
      while (s > 0 && before(dd, ii, d[s - 1], i[s - 1])) {
        d[s] = d[s - 1];
        i[s] = i[s - 1];
        --s;
      }
      d[s] = dd;
      i[s] = ii;
    }
  }

  // insert() for a scan in index order, K <= 32: ii exceeds every index in
  // the list, so (dd, ii) goes after every entry of distance <= dd, and
  // each slot takes its new value from comparisons on the distance alone,
  // all made on the old list (no chain of compare-and-swaps)
  __device__ __forceinline__ void insert_in_order(float dd, int ii) {
    static_assert(K <= 32, "insert_in_order keeps the list in registers");
    bool lt[K];
#pragma unroll
    for (int s = 0; s < K; ++s) lt[s] = dd < d[s];
#pragma unroll
    for (int s = K - 1; s > 0; --s) {
      d[s] = lt[s - 1] ? d[s - 1] : (lt[s] ? dd : d[s]);
      i[s] = lt[s - 1] ? i[s - 1] : (lt[s] ? ii : i[s]);
    }
    d[0] = lt[0] ? dd : d[0];
    i[0] = lt[0] ? ii : i[0];
  }

  // insert() with each slot's new value taken from comparisons of the pair
  // on the old list, all independent (no chain of compare-and-swaps), K <=
  // 32: for candidates in any order, as the umbrella slab's x-sorted window
  __device__ __forceinline__ void insert_any_order(float dd, int ii) {
    static_assert(K <= 32, "insert_any_order keeps the list in registers");
    bool lt[K];
#pragma unroll
    for (int s = 0; s < K; ++s) lt[s] = before(dd, ii, d[s], i[s]);
#pragma unroll
    for (int s = K - 1; s > 0; --s) {
      d[s] = lt[s - 1] ? d[s - 1] : (lt[s] ? dd : d[s]);
      i[s] = lt[s - 1] ? i[s - 1] : (lt[s] ? ii : i[s]);
    }
    d[0] = lt[0] ? dd : d[0];
    i[0] = lt[0] ? ii : i[0];
  }

  // the first k entries (see store_slot)
  __device__ __forceinline__ void store(int k, int* idx, float* dist) const {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (s < k) store_slot(d[s], i[s], idx + s, dist + s);
    }
  }

  // one output slot; a pair at or above kBig is missing: (0, sqrt(1e10))
  static __device__ __forceinline__ void store_slot(float dd, int ii, int* idx, float* dist) {
    const bool missing = dd >= kBig;
    *idx = missing ? 0 : ii;
    *dist = sqrtf(missing ? kBig : dd);
  }
};

constexpr unsigned kFullMask = 0xffffffffu;

// the smaller pair of the lanes of each aligned group of L (a power of two
// up to 32), on every lane of the group
template <int L>
__device__ __forceinline__ void group_min(float& d, int& i) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(kFullMask, d, off);
    const int oi = __shfl_xor_sync(kFullMask, i, off);
    if (before(od, oi, d, i)) {
      d = od;
      i = oi;
    }
  }
}

// Merge the lists of each aligned group of L lanes: k rounds, in each of
// which the group's smallest head wins, emit(r, d, i) sees it on every lane
// of the group, and the lane that holds it pops it (every lane holding the
// empty sentinel pops too: those are all alike).  Every lane of the warp
// calls it with the same k, since the shuffles name the whole warp.  The
// lanes' lists are consumed.
template <int L, int K, typename Emit>
__device__ __forceinline__ void merge_lanes(List<K>& best, int k, Emit emit) {
  if constexpr (K <= 32) {
    // registers: pop by shifting, every index a compile-time constant
#pragma unroll
    for (int r = 0; r < K; ++r) {
      if (r >= k) break;
      float d = best.d[0];
      int i = best.i[0];
      group_min<L>(d, i);
      emit(r, d, i);
      const bool pop = best.d[0] == d && best.i[0] == i;
#pragma unroll
      for (int s = 0; s < K - 1; ++s) {
        if (pop) {
          best.d[s] = best.d[s + 1];
          best.i[s] = best.i[s + 1];
        }
      }
      if (pop) {
        best.d[K - 1] = INFINITY;
        best.i[K - 1] = 0x7fffffff;
      }
    }
  } else {
    // local memory: pop by moving a head, no shift
    int h = 0;
    for (int r = 0; r < k; ++r) {
      const float hd = h < K ? best.d[h] : INFINITY;
      const int hi = h < K ? best.i[h] : 0x7fffffff;
      float d = hd;
      int i = hi;
      group_min<L>(d, i);
      emit(r, d, i);
      h += (hd == d && hi == i) ? 1 : 0;
    }
  }
}

// Merge `rows` ascending lists of at least k pairs each (row w at
// d[w * stride], i[w * stride], rows <= 32) in k rounds of a warp arg-min
// over the rows' heads; called by one whole warp, emit(r, d, i) on every
// lane.
template <typename Emit>
__device__ __forceinline__ void merge_rows(const float* d, const int* i, int rows, int stride,
                                           int k, Emit emit) {
  const int lane = threadIdx.x & 31;
  const float* rd = d + lane * stride;
  const int* ri = i + lane * stride;
  int h = 0;
  for (int r = 0; r < k; ++r) {
    const float hd = lane < rows ? rd[h] : INFINITY;
    const int hi = lane < rows ? ri[h] : 0x7fffffff;
    float md = hd;
    int mi = hi;
    group_min<32>(md, mi);
    emit(r, md, mi);
    h += (lane < rows && hd == md && hi == mi) ? 1 : 0;
  }
}

// the squared distance as the plain version writes it: differences, then
// (dx*dx + dy*dy) + dz*dz, each op rounded on its own (-fmad=false)
__device__ __forceinline__ float dist2(float px, float py, float pz, float qx,
                                       float qy, float qz) {
  const float dx = px - qx, dy = py - qy, dz = pz - qz;
  return dx * dx + dy * dy + dz * dz;
}

// Staged output spans (the umbrella tq and ball-feature kernels): a span of
// `total` floats at dst is first written to shared memory as stage[pad + e]
// for element e, pad = span_pad(dst), so that a 16-byte boundary of dst
// falls on one of the stage; then `count` threads (tid = 0 .. count-1) write
// it with 16-byte stores from consecutive threads, between a scalar head
// (up to dst's first 16-byte boundary) and a scalar tail.  stage itself is
// 16-byte aligned.
__device__ __forceinline__ int span_pad(const float* dst) {
  return (int)((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);
}

__device__ __forceinline__ void store_span(float* __restrict__ dst, const float* stage,
                                           int total, int tid, int count) {
  const int pad = span_pad(dst);
  const int head = min((4 - pad) & 3, total);
  if (tid < head) dst[tid] = stage[pad + tid];
  const int body = (total - head) >> 2;
  const float4* s4 = reinterpret_cast<const float4*>(stage + pad + head);
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int v = tid; v < body; v += count) d4[v] = s4[v];
  const int e = head + 4 * body + tid;
  if (e < total) dst[e] = stage[pad + e];
}

// Call launch(std::integral_constant<int, K>{}) with a compile-time list
// length K >= k: exact lengths for the k the models use (3, 9, 32), else the
// next power of two (the list then keeps K best, of which the first k are
// stored).  The caller has checked 1 <= k <= kMaxK.
constexpr int kMaxK = 256;

template <typename F>
int dispatch_k(int k, F launch) {
  using std::integral_constant;
  if (k == 3) return launch(integral_constant<int, 3>{});
  if (k == 9) return launch(integral_constant<int, 9>{});
  if (k <= 4) return launch(integral_constant<int, 4>{});
  if (k <= 8) return launch(integral_constant<int, 8>{});
  if (k <= 16) return launch(integral_constant<int, 16>{});
  if (k <= 32) return launch(integral_constant<int, 32>{});
  if (k <= 64) return launch(integral_constant<int, 64>{});
  if (k <= 128) return launch(integral_constant<int, 128>{});
  return launch(integral_constant<int, 256>{});
}

}  // namespace knn_topk
