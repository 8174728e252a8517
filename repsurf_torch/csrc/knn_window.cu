// Exact k-nearest neighbours at scene scale over a 3-D grid of cells, one
// thread per query.
//
// Replaces repsurf_tpu/ops/pallas/knn_window.py:_window_kernel (entry
// knn_window).
//
// What bounds it on the H100: a brute scan costs O(M N) (80,000 x 80,000 x 2
// for the umbrella); the window cuts each query's candidates to the points
// of the 3 x 3 x 3 cells around its own, a few times k.  The TPU kernel
// padded queries into per-column blocks and chained nine DMAs into VMEM;
// here the grid is sized from (N, k) as the JAX package sizes it, the points
// are sorted by cell on the device (plain torch ops in the wrapper, as the
// JAX package prepares them in XLA), so each (x, y) column's z-range is one
// contiguous run of the sorted array, and the queries are visited in cell
// order, so the threads of a warp read the same runs (broadcast loads from
// L1).  What bounds the kernel is then the latency of those nine runs, not
// arithmetic.
//
// Exactness guard: an unscanned point lies outside the scanned block of
// cells on some axis, so it is at least as far from the query as the
// nearest face of the block that is not the grid's own outer face.  A query
// whose k-th distance does not clear that gap (with a slack for the f32
// rounding of the cell assignment) rescans the whole cloud inside the
// kernel and counts itself in resolved[b].  A wrong grid is slow, never
// wrong.
//
// Candidates arrive in cell order, not index order, so the list compares
// (squared distance, original index) as a pair (knn_topk.cuh): the result
// equals the brute kernel's, bit for bit, lowest index first on ties.

#include <cuda_runtime.h>

#include "knn_topk.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxK = 128;

template <int K>
__global__ void __launch_bounds__(kThreads) knn_window_kernel(
    const float4* __restrict__ pts,   // [B, N] sorted by cell; w = index bits
    const int* __restrict__ starts,   // [B, cells + 1] run starts per cell
    const float* __restrict__ q,      // [B, M, 3]
    const int* __restrict__ qorder,   // [B, M] queries in cell order
    const float* __restrict__ lo,     // [B, 3] grid origin
    const float* __restrict__ cs,     // [B, 3] cell size
    const float* __restrict__ slack,  // [B] rounding allowance of the guard
    int n, int m, int k, int gxy, int gz, int* __restrict__ idx_out,
    float* __restrict__ dist_out, int* __restrict__ resolved) {
  const int b = blockIdx.y;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= m) return;
  const int cells = gxy * gxy * gz;
  const int* st = starts + (size_t)b * (cells + 1);
  const float4* p = pts + (size_t)b * n;
  const int qi = qorder[(size_t)b * m + t];
  const float* qp = q + ((size_t)b * m + qi) * 3;
  const float qv[3] = {qp[0], qp[1], qp[2]};
  const int gmax[3] = {gxy - 1, gxy - 1, gz - 1};

  // the query's cell (clamped into the grid) and the scanned block around it
  int c_lo[3], c_hi[3];
  float gap = INFINITY;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float o = lo[b * 3 + a], s = cs[b * 3 + a];
    const float f = floorf((qv[a] - o) / s);
    const int c = (int)fminf(fmaxf(f, 0.0f), (float)gmax[a]);
    c_lo[a] = max(c - 1, 0);
    c_hi[a] = min(c + 1, gmax[a]);
    if (c_lo[a] > 0) gap = fminf(gap, qv[a] - (o + (float)c_lo[a] * s));
    if (c_hi[a] < gmax[a])
      gap = fminf(gap, (o + (float)(c_hi[a] + 1) * s) - qv[a]);
  }

  knn_topk::List<K> best;
  best.reset();
  for (int cx = c_lo[0]; cx <= c_hi[0]; ++cx) {
    for (int cy = c_lo[1]; cy <= c_hi[1]; ++cy) {
      const int col = (cx * gxy + cy) * gz;
      const int e = st[col + c_hi[2] + 1];
      for (int j = st[col + c_lo[2]]; j < e; ++j) {
        const float4 c = p[j];
        best.insert(knn_topk::dist2(c.x, c.y, c.z, qv[0], qv[1], qv[2]),
                    __float_as_int(c.w));
      }
    }
  }

  const float bound = 0.999f * (gap - slack[b]);
  if (!(bound > 0.0f && best.worst() < bound * bound)) {
    // the window may have missed a neighbour: scan every valid point
    // (the valid points are the first st[cells] of the sorted array)
    best.reset();
    const int nv = st[cells];
    for (int j = 0; j < nv; ++j) {
      const float4 c = p[j];
      best.insert(knn_topk::dist2(c.x, c.y, c.z, qv[0], qv[1], qv[2]),
                  __float_as_int(c.w));
    }
    atomicAdd(resolved + b, 1);
  }
  const size_t o = ((size_t)b * m + qi) * k;
  best.store(k, idx_out + o, dist_out + o);
}

}  // namespace

extern "C" int repsurf_knn_window_max_k() { return kMaxK; }

// pts [B, N, 4] f32 (x, y, z, original index as int bits) sorted by cell,
// invalid points last; starts [B, gxy*gxy*gz + 1] i32; q [B, M, 3] f32;
// qorder [B, M] i32; lo, cs [B, 3] f32; slack [B] f32; idx_out [B, M, k]
// i32; dist_out [B, M, k] f32; resolved [B] i32, added to.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for k outside [1, 128].
extern "C" int repsurf_knn_window(const float* pts, const int* starts,
                                  const float* q, const int* qorder,
                                  const float* lo, const float* cs,
                                  const float* slack, int batch, int n, int m,
                                  int k, int gxy, int gz, int* idx_out,
                                  float* dist_out, int* resolved,
                                  cudaStream_t stream) {
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  const dim3 grid((m + kThreads - 1) / kThreads, batch);
  return knn_topk::dispatch_k(k, [&](auto kc) {
    knn_window_kernel<decltype(kc)::value><<<grid, kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(pts), starts, q, qorder, lo, cs, slack,
        n, m, k, gxy, gz, idx_out, dist_out, resolved);
    return (int)cudaGetLastError();
  });
}
