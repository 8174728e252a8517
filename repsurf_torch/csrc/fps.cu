// Masked furthest-point sampling, one thread block per sample.
//
// Replaces repsurf_tpu/ops/pallas/fps.py:_fps_kernel.
//
// What bounds it on the H100: the npoint rounds are sequential, and each
// round is a sweep over N points followed by a block-wide argmax.  The sweep
// is a handful of flops per point; the time goes to the two block barriers
// of the argmax and to round latency, not to memory.  The design keeps the
// coordinates and the running min-distance in shared memory for the whole
// loop (16 bytes a point: 32 KB at N = 2048), so device memory is read once
// per sample and written once per selected index.  One sample per block
// leaves most SMs idle below a batch of 132; a later version can split a
// sample over a cluster.
//
// Semantics (identical to the plain version in ops/kernels/fps.py): seed at
// index 0; running min of squared distance, every point included; argmax
// with the lowest index on ties; points at or beyond valid[b] start at -1,
// below every real distance, so they are never picked.
//
// Exactness: the squared distance is (dx*dx + dy*dy) + dz*dz, each product
// and sum rounded on its own (the build passes -fmad=false), as in the
// plain version.  An FMA would move distances by an ulp and flip ties.

#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ bool better(float v, int i, float ov, int oi) {
  return ov > v || (ov == v && oi < i);
}

__global__ void fps_kernel(const float* __restrict__ xyz,
                           const int* __restrict__ valid, int n, int npoint,
                           int* __restrict__ idx_out,
                           float* __restrict__ xyz_out) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = xs + n;
  float* zs = ys + n;
  float* dist = zs + n;
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  __shared__ int s_far;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nv = valid == nullptr ? n : valid[b];
  const float* src = xyz + (size_t)b * n * 3;

  for (int j = tid; j < n; j += kThreads) {
    xs[j] = src[j * 3 + 0];
    ys[j] = src[j * 3 + 1];
    zs[j] = src[j * 3 + 2];
    dist[j] = j < nv ? 1e10f : -1.0f;
  }
  __syncthreads();

  int far = 0;
  for (int i = 0; i < npoint; ++i) {
    const float cx = xs[far], cy = ys[far], cz = zs[far];
    if (tid == 0) {
      idx_out[(size_t)b * npoint + i] = far;
      if (xyz_out != nullptr) {
        float* o = xyz_out + ((size_t)b * npoint + i) * 3;
        o[0] = cx;
        o[1] = cy;
        o[2] = cz;
      }
    }
    float best = -FLT_MAX;
    int besti = n;
    for (int j = tid; j < n; j += kThreads) {
      const float dx = xs[j] - cx, dy = ys[j] - cy, dz = zs[j] - cz;
      const float d2 = dx * dx + dy * dy + dz * dz;
      const float t = fminf(dist[j], d2);
      dist[j] = t;
      if (t > best) {  // j rises within a thread: strict > keeps the first
        best = t;
        besti = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, besti, off);
      if (better(best, besti, ov, oi)) {
        best = ov;
        besti = oi;
      }
    }
    if (lane == 0) {
      red_v[warp] = best;
      red_i[warp] = besti;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < kThreads / 32 ? red_v[lane] : -FLT_MAX;
      besti = lane < kThreads / 32 ? red_i[lane] : n;
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, besti, off);
        if (better(best, besti, ov, oi)) {
          best = ov;
          besti = oi;
        }
      }
      if (lane == 0) s_far = besti;
    }
    __syncthreads();
    far = s_far;
  }
}

}  // namespace

extern "C" int repsurf_fps_max_points() {
  // dynamic shared memory without opting in above the 48 KB default
  return (48 * 1024) / (4 * sizeof(float));
}

// xyz [B, N, 3] f32, valid [B] i32 or null, idx_out [B, npoint] i32,
// xyz_out [B, npoint, 3] f32 or null.  Returns cudaGetLastError().
extern "C" int repsurf_fps(const float* xyz, const int* valid, int batch,
                           int n, int npoint, int* idx_out, float* xyz_out,
                           cudaStream_t stream) {
  const size_t smem = (size_t)4 * n * sizeof(float);
  fps_kernel<<<batch, kThreads, smem, stream>>>(xyz, valid, n, npoint, idx_out,
                                                xyz_out);
  return (int)cudaGetLastError();
}
