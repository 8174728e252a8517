// The per-chunk mean of the whole-scene protocol's normalisation
// (eval_s3dis: coord - np.mean(coord, 0)), in numpy's rounding.
//
// Replaces no Pallas kernel: the JAX package normalises its chunks with
// numpy on the host.  The port cuts a room's chunks on the card, and numpy's
// float32 np.mean(x, 0) over a C-contiguous [n, D] array is a sequential sum
// over the rows in index order (the first row, then each next row added),
// then one division by n.  A tree reduction rounds otherwise, by about 1e-5 m
// at 80,000 points, which moves every coordinate of the chunk; so each
// (chunk, axis) is summed by one thread, in index order.
//
// What bounds it on the H100: the chain of n dependent adds of one thread
// (about 4 cycles each in float32), not the n * D * sizeof(T) bytes read.
// The design keeps that chain fed: one block a chunk; warps 1..3 stage the
// next tile of rows into shared memory while lanes 0..D-1 of warp 0 add up
// the current one, so no add waits on device memory.
//
// Semantics (the plain version, ops/kernels/chunk_mean.py, is numpy's
// np.mean): out[b, a] = (x[b, 0, a] + ... + x[b, m-1, a]) / m, summed left
// to right in T, m = valid[b] (or n), the division IEEE.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // warp 0 sums, warps 1..3 stage
constexpr int kTile = 512;     // rows a stage
constexpr int kMaxDim = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_mean_kernel(const T* __restrict__ x, const int* __restrict__ valid, int n, int d,
                  T* __restrict__ out) {
  __shared__ T stage[2][kTile * kMaxDim];
  const int m = valid ? valid[blockIdx.x] : n;
  const size_t chunk = (size_t)blockIdx.x * n * d;
  const int tiles = (m + kTile - 1) / kTile;
  const int tid = threadIdx.x;
  auto load = [&](int t) {
    const int len = min(kTile, m - t * kTile) * d;
    const T* src = x + chunk + (size_t)t * kTile * d;
    for (int i = tid - 32; i < len; i += kThreads - 32) stage[t & 1][i] = src[i];
  };
  if (tid >= 32) load(0);
  __syncthreads();
  T acc = T(0);
  for (int t = 0; t < tiles; ++t) {
    if (tid >= 32) {
      if (t + 1 < tiles) load(t + 1);
    } else if (tid < d) {
      const T* s = stage[t & 1];
      const int rows = min(kTile, m - t * kTile);
      int i = 0;
      if (t == 0) {  // numpy starts from the first row
        acc = s[tid];
        i = 1;
      }
#pragma unroll 8
      for (; i < rows; ++i) acc = acc + s[i * d + tid];
    }
    __syncthreads();
  }
  if (tid < d) out[blockIdx.x * d + tid] = acc / T(m);
}

template <typename T>
int launch(const void* x, const int* valid, int batch, int n, int d, void* out,
           cudaStream_t stream) {
  chunk_mean_kernel<T><<<batch, kThreads, 0, stream>>>(
      static_cast<const T*>(x), valid, n, d, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, N, D] float32 (is_double 0) or float64 (1), contiguous; valid [B]
// i32 (each in 1..N) or null for N; out [B, D] of x's type.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for D outside [1, 4]
// or an empty shape.
extern "C" int repsurf_chunk_mean(const void* x, const int* valid, int batch, int n, int d,
                                  int is_double, void* out, cudaStream_t stream) {
  if (d < 1 || d > kMaxDim || n < 1 || batch < 1) return (int)cudaErrorInvalidValue;
  return is_double ? launch<double>(x, valid, batch, n, d, out, stream)
                   : launch<float>(x, valid, batch, n, d, out, stream);
}
