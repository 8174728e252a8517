// Exact brute-force k-nearest neighbours: one thread per query, or a group
// of L lanes per query when there are too few queries to fill the card.
//
// Replaces repsurf_tpu/ops/pallas/knn.py:_knn_kernel (entry knn_pallas).
//
// What bounds it on the H100: every query scans all N reference points, a
// handful of flops and one compare each, plus a K-step insertion for the
// rare candidate that beats the current k-th: O(M N) issue-bound work
// against M*k outputs.  The TPU kernel held a [rows, N] distance block in
// VMEM and ran k min-extraction passes over it; here the reference points
// are tiled through shared memory (every thread of a block reads the same
// tile, so the cloud leaves device memory once per block of queries) and
// each thread keeps its k best in registers (knn_topk.cuh), so nothing but
// the [B, M, k] results is written.
//
// Two routes, chosen by the caller from the shape alone (ops/kernels/knn.py):
//   * knn_kernel: one thread per query.  At the seg stages' small clouds
//     (1,250 -> 312 points: 624 queries, 5 blocks on 132 SMs) most of the
//     card idles while each thread scans the whole cloud alone;
//   * knn_split_kernel<K, L>: an aligned group of L = 8, 16 or 32 lanes per
//     query, each lane over every L-th candidate of the tile with its own
//     list, the group's lists merged in k shuffle rounds (merge_lanes).  L
//     times the threads, 1/L of the serial scan each.
//
// Semantics (identical to the plain version in ops/kernels/knn.py): squared
// distances from direct differences; points at or beyond valid[b] sit at
// 1e10; ascending, the lowest index first on ties; a slot at or above 1e10
// is missing and reads (0, sqrt(1e10)); the distance output is the sqrt.

#include <cuda_runtime.h>

#include "knn_topk.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSplitThreads = 256;
constexpr int kTile = 512;

// the block's share of the reference points into shared memory
__device__ __forceinline__ void load_tile(const float* __restrict__ src, int base, int n,
                                          float* tx, float* ty, float* tz) {
  for (int t = threadIdx.x; t < kTile && base + t < n; t += blockDim.x) {
    const int j = base + t;
    tx[t] = src[j * 3 + 0];
    ty[t] = src[j * 3 + 1];
    tz[t] = src[j * 3 + 2];
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
    knn_kernel(const float* __restrict__ xyz, const float* __restrict__ q,
               const int* __restrict__ valid, int n, int m, int k,
               int* __restrict__ idx_out, float* __restrict__ dist_out) {
  __shared__ float tx[kTile], ty[kTile], tz[kTile];
  const int b = blockIdx.y;
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const int nv = valid == nullptr ? n : valid[b];
  const float* src = xyz + (size_t)b * n * 3;
  const bool live = qi < m;
  const float* qp = q + ((size_t)b * m + (live ? qi : 0)) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];

  knn_topk::List<K> best;
  best.reset();
  for (int base = 0; base < n; base += kTile) {
    __syncthreads();
    load_tile(src, base, n, tx, ty, tz);
    __syncthreads();
    const int len = min(kTile, n - base);
    for (int t = 0; t < len; ++t) {
      const int j = base + t;
      float d2 = knn_topk::dist2(tx[t], ty[t], tz[t], qx, qy, qz);
      if (j >= nv) d2 = knn_topk::kBig;
      // candidates arrive in index order: a distance equal to the current
      // k-th never enters, so the cheap test on the distance alone suffices
      if (d2 < best.worst()) best.insert(d2, j);
    }
  }
  if (!live) return;
  const size_t o = ((size_t)b * m + qi) * k;
  best.store(k, idx_out + o, dist_out + o);
}

template <int K, int L>
__global__ void __launch_bounds__(kSplitThreads)
    knn_split_kernel(const float* __restrict__ xyz, const float* __restrict__ q,
                     const int* __restrict__ valid, int n, int m, int k,
                     int* __restrict__ idx_out, float* __restrict__ dist_out) {
  __shared__ float tx[kTile], ty[kTile], tz[kTile];
  const int b = blockIdx.y;
  const int sub = threadIdx.x & (L - 1);
  const int qi = blockIdx.x * (kSplitThreads / L) + threadIdx.x / L;
  const int nv = valid == nullptr ? n : valid[b];
  const float* src = xyz + (size_t)b * n * 3;
  // a group past M scans and merges all the same: the shuffles need the
  // whole warp
  const bool live = qi < m;
  const float* qp = q + ((size_t)b * m + (live ? qi : 0)) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];

  // each lane: every L-th candidate, in index order, its own k best
  knn_topk::List<K> best;
  best.reset();
  for (int base = 0; base < n; base += kTile) {
    __syncthreads();
    load_tile(src, base, n, tx, ty, tz);
    __syncthreads();
    const int len = min(kTile, n - base);
    for (int t = sub; t < len; t += L) {
      const int j = base + t;
      float d2 = knn_topk::dist2(tx[t], ty[t], tz[t], qx, qy, qz);
      if (j >= nv) d2 = knn_topk::kBig;
      if (d2 < best.worst()) best.insert(d2, j);
    }
  }
  const size_t o = ((size_t)b * m + (live ? qi : 0)) * k;
  knn_topk::merge_lanes<L>(best, k, [&](int r, float d, int i) {
    if (live && (r & (L - 1)) == sub)
      knn_topk::List<K>::store_slot(d, i, idx_out + o + r, dist_out + o + r);
  });
}

template <int K, int L>
int launch_split(const float* xyz, const float* q, const int* valid, int batch, int n,
                 int m, int k, int* idx_out, float* dist_out, cudaStream_t stream) {
  constexpr int per_block = kSplitThreads / L;
  const dim3 grid((m + per_block - 1) / per_block, batch);
  knn_split_kernel<K, L><<<grid, kSplitThreads, 0, stream>>>(xyz, q, valid, n, m, k,
                                                             idx_out, dist_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repsurf_knn_max_k() { return knn_topk::kMaxK; }

// xyz [B, N, 3] f32, q [B, M, 3] f32, valid [B] i32 or null; idx_out
// [B, M, k] i32, dist_out [B, M, k] f32; lanes per query: 1 (knn_kernel),
// 8, 16 or 32 (knn_split_kernel).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for k outside [1, 256] or another lane count.
extern "C" int repsurf_knn(const float* xyz, const float* q, const int* valid,
                           int batch, int n, int m, int k, int lanes, int* idx_out,
                           float* dist_out, cudaStream_t stream) {
  if (k < 1 || k > knn_topk::kMaxK) return (int)cudaErrorInvalidValue;
  return knn_topk::dispatch_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    switch (lanes) {
      case 1: {
        const dim3 grid((m + kThreads - 1) / kThreads, batch);
        knn_kernel<K><<<grid, kThreads, 0, stream>>>(xyz, q, valid, n, m, k, idx_out,
                                                     dist_out);
        return (int)cudaGetLastError();
      }
      case 8:
        return launch_split<K, 8>(xyz, q, valid, batch, n, m, k, idx_out, dist_out, stream);
      case 16:
        return launch_split<K, 16>(xyz, q, valid, batch, n, m, k, idx_out, dist_out, stream);
      case 32:
        return launch_split<K, 32>(xyz, q, valid, batch, n, m, k, idx_out, dist_out, stream);
      default:
        return (int)cudaErrorInvalidValue;
    }
  });
}
