// Exact k-nearest neighbours at scene scale over a 3-D grid of cells: a
// window pass, one thread per query, then a re-solve pass over the queries
// the window cannot vouch for, one block per query.
//
// Replaces repsurf_tpu/ops/pallas/knn_window.py:_window_kernel (entry
// knn_window) and the tiered brute re-solve of its failing queries
// (knn_window.py:447-533).
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
// rounding of the cell assignment) writes nothing: it takes a slot of its
// sample's list of failing queries from atomicAdd(resolved + b, 1), with
// the last squared distance of its list (the K-th, K >= k) beside it.  A wrong grid is slow,
// never wrong.
//
// The re-solve pass (knn_resolve_kernel) takes the list on the same stream:
// a fixed grid whose blocks stride over resolved[b], read on the device, so
// the host never waits on the count.  A block of 16 warps scans the whole
// valid cloud for one query, each thread over every 512th point with its own
// list, four loads in flight at a time, the lists merged by shuffles within
// each warp and through shared memory across the warps (knn_topk.cuh).  The
// window's K candidates are real points, so its K-th distance bounds the
// true k-th from above: a candidate beyond it cannot be among the k best,
// and skipping it spares the list upkeep that would otherwise bound the
// scan (a candidate at the bound itself may still win on its index).  A serial rescan inside the
// failing query's own thread would keep the whole grid waiting on that one
// thread: 80,000 loads and insertions at 80,000 -> 20,000, k = 32, about
// 14 ms on an H100 for 2 to 4 such queries a sample.
//
// Candidates arrive in cell order, not index order, so the list compares
// (squared distance, original index) as a pair (knn_topk.cuh): the result
// equals the brute kernel's, bit for bit, lowest index first on ties.

#include <cuda_runtime.h>

#include "knn_topk.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kResolveWarps = 16;
constexpr int kResolveThreads = kResolveWarps * 32;
constexpr int kResolveBatch = 4;  // loads a thread keeps in flight
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
    float* __restrict__ dist_out, int* __restrict__ resolved, int* __restrict__ fails,
    float* __restrict__ fail_kth) {
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
    // the window may have missed a neighbour: the re-solve pass writes
    // this query's row
    const size_t slot = (size_t)b * m + atomicAdd(resolved + b, 1);
    fails[slot] = qi;
    fail_kth[slot] = best.worst();
    return;
  }
  const size_t o = ((size_t)b * m + qi) * k;
  best.store(k, idx_out + o, dist_out + o);
}

template <int K>
__global__ void __launch_bounds__(kResolveThreads) knn_resolve_kernel(
    const float4* __restrict__ pts,     // [B, N] sorted by cell; w = index bits
    const int* __restrict__ starts,     // [B, cells + 1]; starts[cells] = valid
    const float* __restrict__ q,        // [B, M, 3]
    const int* __restrict__ fails,      // [B, M] failing queries, resolved[b] of them
    const float* __restrict__ fail_kth, // [B, M] their window K-th squared distances
    const int* __restrict__ resolved,   // [B]
    int n, int m, int k, int cells, int* __restrict__ idx_out,
    float* __restrict__ dist_out) {
  __shared__ float sd[kResolveWarps][K];
  __shared__ int si[kResolveWarps][K];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float4* p = pts + (size_t)b * n;
  const int nv = starts[(size_t)b * (cells + 1) + cells];
  const int count = resolved[b];
  for (int j = blockIdx.x; j < count; j += gridDim.x) {
    const int qi = fails[(size_t)b * m + j];
    const float bound = fail_kth[(size_t)b * m + j];
    const float* qp = q + ((size_t)b * m + qi) * 3;
    const float qx = qp[0], qy = qp[1], qz = qp[2];
    // every thread: every 512th valid point (cell order, so the pair test)
    knn_topk::List<K> best;
    best.reset();
    for (int t0 = threadIdx.x; t0 < nv; t0 += kResolveBatch * kResolveThreads) {
      float4 c[kResolveBatch];
#pragma unroll
      for (int u = 0; u < kResolveBatch; ++u) {
        const int t = t0 + u * kResolveThreads;
        c[u] = t < nv ? p[t] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < kResolveBatch; ++u) {
        const float d2 = knn_topk::dist2(c[u].x, c[u].y, c[u].z, qx, qy, qz);
        if (t0 + u * kResolveThreads < nv && d2 <= bound) best.insert(d2, __float_as_int(c[u].w));
      }
    }
    knn_topk::merge_lanes<32>(best, k, [&](int r, float d, int i) {
      if ((r & 31) == lane) {
        sd[warp][r] = d;
        si[warp][r] = i;
      }
    });
    __syncthreads();
    if (warp == 0) {
      const size_t o = ((size_t)b * m + qi) * k;
      knn_topk::merge_rows(&sd[0][0], &si[0][0], kResolveWarps, K, k,
                           [&](int r, float d, int i) {
                             if ((r & 31) == lane)
                               knn_topk::List<K>::store_slot(d, i, idx_out + o + r,
                                                             dist_out + o + r);
                           });
    }
    __syncthreads();  // the rows are read before the next query writes them
  }
}

}  // namespace

extern "C" int repsurf_knn_window_max_k() { return kMaxK; }

// The window pass.  pts [B, N, 4] f32 (x, y, z, original index as int bits)
// sorted by cell, invalid points last; starts [B, gxy*gxy*gz + 1] i32; q
// [B, M, 3] f32; qorder [B, M] i32; lo, cs [B, 3] f32; slack [B] f32;
// idx_out [B, M, k] i32; dist_out [B, M, k] f32, the rows of the failing
// queries left unwritten; resolved [B] i32, zero on entry, the failing
// queries' count on exit; fails [B, M] i32, their indices in its first
// resolved[b] slots (in no set order); fail_kth [B, M] f32 beside it, the
// last squared distance of each one's window list.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for k outside [1, 128].
extern "C" int repsurf_knn_window(const float* pts, const int* starts,
                                  const float* q, const int* qorder,
                                  const float* lo, const float* cs,
                                  const float* slack, int batch, int n, int m,
                                  int k, int gxy, int gz, int* idx_out,
                                  float* dist_out, int* resolved, int* fails,
                                  float* fail_kth, cudaStream_t stream) {
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  const dim3 grid((m + kThreads - 1) / kThreads, batch);
  return knn_topk::dispatch_k(k, [&](auto kc) {
    knn_window_kernel<decltype(kc)::value><<<grid, kThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(pts), starts, q, qorder, lo, cs, slack,
        n, m, k, gxy, gz, idx_out, dist_out, resolved, fails, fail_kth);
    return (int)cudaGetLastError();
  });
}

// The re-solve pass, on the window pass's outputs: the rows of the failing
// queries, exact over the whole valid cloud; `blocks` blocks a sample stride
// over its list.  Returns cudaGetLastError(), or cudaErrorInvalidValue for k
// outside [1, 128] or blocks < 1.
extern "C" int repsurf_knn_window_resolve(const float* pts, const int* starts,
                                          const float* q, const int* fails,
                                          const float* fail_kth, const int* resolved,
                                          int batch, int n, int m,
                                          int k, int cells, int blocks, int* idx_out,
                                          float* dist_out, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || blocks < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks, batch);
  return knn_topk::dispatch_k(k, [&](auto kc) {
    knn_resolve_kernel<decltype(kc)::value><<<grid, kResolveThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(pts), starts, q, fails, fail_kth, resolved, n, m, k,
        cells, idx_out, dist_out);
    return (int)cudaGetLastError();
  });
}
