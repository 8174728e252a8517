// The k-best list shared by the kNN kernels (knn.cu, knn_window.cu).
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

#pragma once

#include <math.h>

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

  // the first k entries; a slot at or above kBig is missing: (0, sqrt(1e10))
  __device__ __forceinline__ void store(int k, int* idx, float* dist) const {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (s < k) {
        const bool missing = d[s] >= kBig;
        idx[s] = missing ? 0 : i[s];
        dist[s] = sqrtf(missing ? kBig : d[s]);
      }
    }
  }
};

// the squared distance as the plain version writes it: differences, then
// (dx*dx + dy*dy) + dz*dz, each op rounded on its own (-fmad=false)
__device__ __forceinline__ float dist2(float px, float py, float pz, float qx,
                                       float qy, float qz) {
  const float dx = px - qx, dy = py - qy, dz = pz - qz;
  return dx * dx + dy * dy + dz * dz;
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
