// Masked furthest-point sampling: one thread block per sample for clouds
// of up to 12,800 points, a thread-block cluster per sample for scene-size
// clouds.
//
// Replaces repsurf_tpu/ops/pallas/fps.py:_fps_kernel.
//
// What bounds it on the H100: the npoint rounds are sequential, and each
// round is a sweep over N points followed by a block-wide argmax.  The sweep
// is a handful of flops per point; the time goes to the two block barriers
// of the argmax and to round latency, not to memory.  The design keeps the
// coordinates and the running min-distance in shared memory for the whole
// loop (16 bytes a point: 32 KB at N = 2048, 200 KB at 12,800, opted in
// above the 48 KB default), so device memory is read once per sample and
// written once per selected index.
//
// Scene-size clouds (the seg slice samples 20,000 of 80,000 points) need
// 1.28 MB, past the 227 KB one block can hold.  fps_cluster_kernel splits
// the cloud over a cluster of up to 8 blocks (12,800 points, 200 KB, each):
// every round each block sweeps its own slice and reduces it to one
// candidate (distance, global index, coordinates), publishes it in its
// shared memory, and after one cluster barrier every warp reads the
// cluster's candidates through distributed shared memory and takes the
// max, lowest global index on ties.  The candidate slots alternate between
// two buffers by round parity, so one cluster barrier a round suffices: a
// block overwrites a slot only after the next barrier, which every reader
// of the slot's previous use has passed.
//
// Semantics (identical to the plain version in ops/kernels/fps.py): seed at
// index 0; running min of squared distance, every point included; argmax
// with the lowest index on ties; points at or beyond valid[b] start at -1,
// below every real distance, so they are never picked.
//
// Exactness: the squared distance is (dx*dx + dy*dy) + dz*dz, each product
// and sum rounded on its own (the build passes -fmad=false), as in the
// plain version.  An FMA would move distances by an ulp and flip ties.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
// one block's share of a cloud: 200 KB of the 227 KB of shared memory
constexpr int kBlockPoints = 12800;
constexpr int kClusterThreads = 512;  // measured best of 256, 512 and 1024
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kClusterBlockPoints = kBlockPoints;

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

__device__ __forceinline__ void warp_argmax(float& best, int& besti) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, besti, off);
    if (better(best, besti, ov, oi)) {
      best = ov;
      besti = oi;
    }
  }
}

// blockIdx.x / cluster size = sample; the block of cluster rank r holds
// points [r * chunk, min((r + 1) * chunk, n)).
__global__ void __launch_bounds__(kClusterThreads)
    fps_cluster_kernel(const float* __restrict__ xyz,
                       const int* __restrict__ valid, int n, int npoint,
                       int chunk, int* __restrict__ idx_out,
                       float* __restrict__ xyz_out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = xs + chunk;
  float* zs = ys + chunk;
  float* dist = zs + chunk;
  __shared__ float red_v[kClusterThreads / 32];
  __shared__ int red_i[kClusterThreads / 32];
  // this block's candidate, two slots by round parity
  __shared__ float pub_v[2], pub_x[2], pub_y[2], pub_z[2];
  __shared__ int pub_i[2];

  const int b = blockIdx.x / csize;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nv = valid == nullptr ? n : valid[b];
  const float* src = xyz + (size_t)b * n * 3;
  const int base = rank * chunk;
  const int len = max(0, min(chunk, n - base));

  for (int j = tid; j < len; j += kClusterThreads) {
    xs[j] = src[(base + j) * 3 + 0];
    ys[j] = src[(base + j) * 3 + 1];
    zs[j] = src[(base + j) * 3 + 2];
    dist[j] = base + j < nv ? 1e10f : -1.0f;
  }
  int far = 0;
  float cx = src[0], cy = src[1], cz = src[2];
  // every block of the cluster is running and initialised before any
  // reads another's shared memory
  cluster.sync();

  for (int i = 0; i < npoint; ++i) {
    if (rank == 0 && tid == 0) {
      idx_out[(size_t)b * npoint + i] = far;
      if (xyz_out != nullptr) {
        float* o = xyz_out + ((size_t)b * npoint + i) * 3;
        o[0] = cx;
        o[1] = cy;
        o[2] = cz;
      }
    }
    float best = -FLT_MAX;
    int besti = INT_MAX;
    for (int j = tid; j < len; j += kClusterThreads) {
      const float dx = xs[j] - cx, dy = ys[j] - cy, dz = zs[j] - cz;
      const float d2 = dx * dx + dy * dy + dz * dz;
      const float t = fminf(dist[j], d2);
      dist[j] = t;
      if (t > best) {  // j rises within a thread: strict > keeps the first
        best = t;
        besti = base + j;
      }
    }
    warp_argmax(best, besti);
    if (lane == 0) {
      red_v[warp] = best;
      red_i[warp] = besti;
    }
    __syncthreads();
    const int slot = i & 1;
    if (warp == 0) {
      best = lane < kClusterThreads / 32 ? red_v[lane] : -FLT_MAX;
      besti = lane < kClusterThreads / 32 ? red_i[lane] : INT_MAX;
      warp_argmax(best, besti);
      if (lane == 0) {
        const int l = besti - base;
        const bool mine = l >= 0 && l < len;
        pub_v[slot] = best;
        pub_i[slot] = besti;
        pub_x[slot] = mine ? xs[l] : 0.0f;
        pub_y[slot] = mine ? ys[l] : 0.0f;
        pub_z[slot] = mine ? zs[l] : 0.0f;
      }
    }
    cluster.sync();
    // every warp takes the cluster's argmax itself: lane r reads rank r
    float v = -FLT_MAX, x = 0.0f, y = 0.0f, z = 0.0f;
    int vi = INT_MAX;
    if (lane < csize) {
      v = *cluster.map_shared_rank(&pub_v[slot], lane);
      vi = *cluster.map_shared_rank(&pub_i[slot], lane);
      x = *cluster.map_shared_rank(&pub_x[slot], lane);
      y = *cluster.map_shared_rank(&pub_y[slot], lane);
      z = *cluster.map_shared_rank(&pub_z[slot], lane);
    }
    int src_lane = lane;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, vi, off);
      const int ol = __shfl_down_sync(0xffffffffu, src_lane, off);
      if (better(v, vi, ov, oi)) {
        v = ov;
        vi = oi;
        src_lane = ol;
      }
    }
    src_lane = __shfl_sync(0xffffffffu, src_lane, 0);
    far = __shfl_sync(0xffffffffu, vi, 0);
    cx = __shfl_sync(0xffffffffu, x, src_lane);
    cy = __shfl_sync(0xffffffffu, y, src_lane);
    cz = __shfl_sync(0xffffffffu, z, src_lane);
  }
  // no block leaves while another may still read its candidate slots
  cluster.sync();
}

}  // namespace

extern "C" int repsurf_fps_max_points() {
  return kMaxCluster * kClusterBlockPoints;
}

extern "C" int repsurf_fps_block_points() { return kBlockPoints; }

// xyz [B, N, 3] f32, valid [B] i32 or null, idx_out [B, npoint] i32,
// xyz_out [B, npoint, 3] f32 or null.  N <= 12,800 runs one block per
// sample (a round costs a third of the cluster kernel's at 1,250 points),
// a larger N a cluster of ceil(N / 12,800) blocks per sample.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for N beyond
// repsurf_fps_max_points().
extern "C" int repsurf_fps(const float* xyz, const int* valid, int batch,
                           int n, int npoint, int* idx_out, float* xyz_out,
                           cudaStream_t stream) {
  if (n <= kBlockPoints) {
    const size_t smem = (size_t)4 * n * sizeof(float);
    const cudaError_t err = cudaFuncSetAttribute(
        fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    fps_kernel<<<batch, kThreads, smem, stream>>>(xyz, valid, n, npoint,
                                                  idx_out, xyz_out);
    return (int)cudaGetLastError();
  }
  if (n > repsurf_fps_max_points()) return (int)cudaErrorInvalidValue;
  const int csize = (n + kClusterBlockPoints - 1) / kClusterBlockPoints;
  const int chunk = (n + csize - 1) / csize;
  const size_t smem = (size_t)4 * chunk * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize * batch);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel, xyz, valid, n, npoint,
                           chunk, idx_out, xyz_out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
