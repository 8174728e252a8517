// Masked furthest-point sampling: one thread block per sample for clouds
// of up to 8,192 points, a thread-block cluster of up to 16 blocks per
// sample for scene-size clouds (up to 131,072 points).
//
// Replaces repsurf_tpu/ops/pallas/fps.py:_fps_kernel.
//
// What bounds it on the H100: the npoint rounds are sequential, and each
// round is a sweep over N points followed by an argmax over the whole
// cloud.  The sweep is a handful of flops a point; the time goes to the
// latency of the round (the reduction, the barrier, the exchange between
// the blocks of a cluster), not to memory.  The design cuts each cost of a
// round:
//
//   * the sweep reads registers: each thread of a 256-thread block holds P
//     points (P a compile-time 1..32, points base + tid + k * T), their
//     coordinates and running distances, for the whole loop.  A copy of
//     the coordinates in shared memory (16 bytes a point) serves only the
//     lookup of a winner's coordinates.  Eight warps a block keep the
//     reduction short (measured against 512 and 1,024 threads);
//   * one 64-bit key a candidate: the order-preserving bits of the distance
//     in the high word, 0xFFFFFFFF - global index in the low word, so the
//     argmax with the lowest index on ties is one unsigned max
//     (__reduce_max_sync on the high word, then on the low word among the
//     lanes that hold it);
//   * one block barrier a round: warp leaders write their keys to shared
//     memory (two buffers by round parity), one __syncthreads(), and every
//     warp then reduces the block's keys itself;
//   * one cluster exchange a round, one-sided: each block pushes its key
//     and its winner's coordinates into every peer's shared memory with
//     st.async, which completes their bytes on the peer's mbarrier (one a
//     round parity, armed each round with the bytes it expects), and every
//     thread waits on its own block's mbarrier alone: no cluster-wide
//     barrier, no remote load.  Where the cluster holds at most 32 warps
//     (4 blocks), every warp pushes its own key and the block barrier goes
//     too; with more candidates than that the remote stores cost more than
//     the barrier saves (measured).  Then lane j of every warp reads
//     candidate j, key and coordinates at once.
//
// Two slots by parity are enough: a block writes a parity's slots in a
// peer again two rounds later, after it has received the peer's candidates
// of the round between, which the peer's warps push only after reading
// those slots.
//
// Semantics (identical to the plain version in ops/kernels/fps.py): seed at
// index 0; running min of squared distance, every point included; argmax
// with the lowest index on ties; points at or beyond valid[b] start at -1,
// below every real distance, so they are never picked.  Slots past N start
// at -FLT_MAX, below -1.
//
// Exactness: the squared distance is (dx*dx + dy*dy) + dz*dz, each product
// and sum rounded on its own (the build passes -fmad=false), as in the
// plain version.  An FMA would move distances by an ulp and flip ties.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxP = 32;  // points a thread
constexpr int kBlockPoints = kThreads * kMaxP;  // one block's largest cloud
constexpr int kClusterP = 20;  // points a thread the cluster size aims at
constexpr int kMaxCluster = 16;  // the H100's non-portable cluster size
constexpr int kMaxCand = 32;  // candidates a round, one a lane
constexpr unsigned kCandBytes = 24;  // a key and a float4 of coordinates
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned long long make_key(float d, unsigned idx) {
  unsigned u = __float_as_uint(d);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // order-preserving
  return ((unsigned long long)u << 32) | (0xFFFFFFFFu - idx);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long k) {
  const unsigned hi = __reduce_max_sync(kFull, (unsigned)(k >> 32));
  const unsigned lo = __reduce_max_sync(kFull, (unsigned)(k >> 32) == hi ? (unsigned)k : 0u);
  return ((unsigned long long)hi << 32) | lo;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the address of the same shared variable in the block of cluster rank r
__device__ __forceinline__ unsigned peer_addr(unsigned addr, int r) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(r));
  return out;
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// a store into a peer's shared memory that completes its bytes on the
// peer's mbarrier
__device__ __forceinline__ void st_async(unsigned addr, unsigned long long v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];"
               ::"r"(addr), "l"(v), "r"(bar) : "memory");
}

__device__ __forceinline__ void st_async(unsigned addr, float4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(addr), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
      "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar) : "memory");
}

// blockIdx.x / csize = sample; the block of cluster rank r holds points
// [r * chunk, (r + 1) * chunk), chunk = blockDim.x * P.  csize 1 is a
// plain launch (no cluster, no exchange).  wpush: every warp pushes its
// own key (csize * warps <= 32), else the block's key after the block
// barrier.  probe != 0 skips the sweep (the distances stay as
// initialised), so a round is only its reduction and exchange: the
// round-latency floor of this launch shape.
template <int P>
__global__ void __launch_bounds__(kThreads, 1)
    fps_kernel(const float* __restrict__ xyz, const int* __restrict__ valid, int n,
               int npoint, int csize, int wpush, int probe, int* __restrict__ idx_out,
               float* __restrict__ xyz_out) {
  extern __shared__ float4 s_xyz[];
  __shared__ unsigned long long wkey[2][kWarps];
  __shared__ unsigned long long ckey[2][kMaxCand];
  __shared__ __align__(16) float4 cxyz[2][kMaxCand];
  __shared__ __align__(8) unsigned long long mbar[2];

  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = T >> 5;
  const int rank = csize > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int b = blockIdx.x / csize;
  const int nv = valid == nullptr ? n : valid[b];
  const float* src = xyz + (size_t)b * n * 3;
  const int base = rank * T * P;
  const int ncand = wpush ? csize * nwarps : csize;
  const int slot = wpush ? rank * nwarps + warp : rank;

  float px[P], py[P], pz[P], pd[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int l = tid + k * T;
    const int g = base + l;
    const bool real = g < n;
    px[k] = real ? src[g * 3 + 0] : 0.0f;
    py[k] = real ? src[g * 3 + 1] : 0.0f;
    pz[k] = real ? src[g * 3 + 2] : 0.0f;
    pd[k] = g < nv ? 1e10f : (real ? -1.0f : -FLT_MAX);
    s_xyz[l] = make_float4(px[k], py[k], pz[k], 0.0f);
  }
  int far = 0;
  float cx = src[0], cy = src[1], cz = src[2];
  if (csize > 1) {
    if (tid == 0) {
      mbar_init(smem_addr(&mbar[0]), 1);
      mbar_init(smem_addr(&mbar[1]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // every block of the cluster is running, its mbarriers set up, before
    // any writes another's shared memory
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }

  for (int i = 0; i < npoint; ++i) {
    const int par = i & 1;
    if (csize > 1 && tid == 0) mbar_expect(smem_addr(&mbar[par]), ncand * kCandBytes);
    if (rank == 0 && tid == 0) {
      idx_out[(size_t)b * npoint + i] = far;
      if (xyz_out != nullptr) {
        float* o = xyz_out + ((size_t)b * npoint + i) * 3;
        o[0] = cx;
        o[1] = cy;
        o[2] = cz;
      }
    }
    float best = __int_as_float(0xff800000);  // -inf
    int bk = 0;
    if (!probe) {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const float dx = px[k] - cx, dy = py[k] - cy, dz = pz[k] - cz;
        const float d2 = dx * dx + dy * dy + dz * dz;
        pd[k] = fminf(pd[k], d2);
        if (pd[k] > best) {  // k rises with the index: strict > keeps the first
          best = pd[k];
          bk = k;
        }
      }
    } else {
      best = pd[0];
    }
    unsigned long long key = warp_max(make_key(best, (unsigned)(base + tid + bk * T)));
    if (!wpush) {
      if (lane == 0) wkey[par][warp] = key;
      __syncthreads();
      key = warp_max(lane < nwarps ? wkey[par][lane] : 0ull);
    }
    const int win = (int)(0xFFFFFFFFu - (unsigned)key);  // global index
    if (csize == 1) {
      const float4 c = s_xyz[win];
      far = win;
      cx = c.x;
      cy = c.y;
      cz = c.z;
      continue;
    }
    if (wpush || warp == 0) {
      const float4 c = s_xyz[win - base];
      if (lane < csize) {
        const unsigned bar = peer_addr(smem_addr(&mbar[par]), lane);
        st_async(peer_addr(smem_addr(&ckey[par][slot]), lane), key, bar);
        st_async(peer_addr(smem_addr(&cxyz[par][slot]), lane), c, bar);
      }
    }
    mbar_wait(smem_addr(&mbar[par]), (unsigned)(i >> 1) & 1u);
    const unsigned long long mine = lane < ncand ? ckey[par][lane] : 0ull;
    const float4 c = cxyz[par][lane < ncand ? lane : 0];
    const unsigned long long top = warp_max(mine);
    const int src_lane = __ffs(__ballot_sync(kFull, mine == top)) - 1;
    far = (int)(0xFFFFFFFFu - (unsigned)top);
    cx = __shfl_sync(kFull, c.x, src_lane);
    cy = __shfl_sync(kFull, c.y, src_lane);
    cz = __shfl_sync(kFull, c.z, src_lane);
  }
  // no block leaves while a peer may still write into its shared memory
  if (csize > 1) cg::this_cluster().sync();
}

// The launch shape for a cloud of n points: points a thread, threads a
// block, blocks a cluster (1: a plain launch), and whether every warp
// pushes its own key.
struct Shape {
  int p, threads, csize, wpush;
};

Shape shape_for(int n) {
  if (n <= kBlockPoints) {
    const int p = (n + kThreads - 1) / kThreads;
    const int t = ((n + p - 1) / p + 31) / 32 * 32;
    return {p, t, 1, 0};
  }
  int cs = (n + kThreads * kClusterP - 1) / (kThreads * kClusterP);
  cs = cs < kMaxCluster ? cs : kMaxCluster;
  const int p = (n + cs * kThreads - 1) / (cs * kThreads);
  cs = (n + p * kThreads - 1) / (p * kThreads);  // no block without points
  return {p, kThreads, cs, cs * kWarps <= kMaxCand ? 1 : 0};
}

template <int P>
cudaError_t launch(const Shape& s, const float* xyz, const int* valid, int batch, int n,
                   int npoint, int probe, int* idx_out, float* xyz_out,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float4) * (size_t)s.threads * P;
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (s.csize == 1) {
    fps_kernel<P><<<batch, s.threads, smem, stream>>>(xyz, valid, n, npoint, 1, 0, probe,
                                                      idx_out, xyz_out);
    return cudaGetLastError();
  }
  if (s.csize > 8) {
    err = cudaFuncSetAttribute(fps_kernel<P>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(s.csize * batch);
  cfg.blockDim = dim3(s.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s.csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fps_kernel<P>, xyz, valid, n, npoint, s.csize, s.wpush,
                           probe, idx_out, xyz_out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int P = 1>
cudaError_t dispatch(const Shape& s, const float* xyz, const int* valid, int batch, int n,
                     int npoint, int probe, int* idx_out, float* xyz_out,
                     cudaStream_t stream) {
  if constexpr (P > kMaxP) {
    return cudaErrorInvalidValue;
  } else {
    if (s.p == P) {
      return launch<P>(s, xyz, valid, batch, n, npoint, probe, idx_out, xyz_out, stream);
    }
    return dispatch<P + 1>(s, xyz, valid, batch, n, npoint, probe, idx_out, xyz_out, stream);
  }
}

}  // namespace

extern "C" int repsurf_fps_max_points() { return kMaxCluster * kThreads * kMaxP; }

extern "C" int repsurf_fps_block_points() { return kBlockPoints; }

// The blocks a cluster for a cloud of n points (1: one block a sample).
extern "C" int repsurf_fps_cluster_size(int n) { return shape_for(n).csize; }

// xyz [B, N, 3] f32, valid [B] i32 or null, idx_out [B, npoint] i32,
// xyz_out [B, npoint, 3] f32 or null.  N <= 8,192 runs one block per
// sample, a larger N a cluster of up to 16 blocks per sample (see
// shape_for).  Returns the CUDA error of the launch (a refused cluster
// launch included), or cudaErrorInvalidValue for N beyond
// repsurf_fps_max_points().
extern "C" int repsurf_fps(const float* xyz, const int* valid, int batch, int n,
                           int npoint, int* idx_out, float* xyz_out,
                           cudaStream_t stream) {
  if (n < 1 || n > repsurf_fps_max_points()) return (int)cudaErrorInvalidValue;
  return (int)dispatch(shape_for(n), xyz, valid, batch, n, npoint, 0, idx_out, xyz_out,
                       stream);
}

// A measurement, not a sampler: the same launch shape and rounds as
// repsurf_fps with the sweep removed (idx_out gets a constant index), so
// its time over npoint is the round-latency floor of that shape.
extern "C" int repsurf_fps_round_floor(const float* xyz, int batch, int n, int npoint,
                                       int* idx_out, cudaStream_t stream) {
  if (n < 1 || n > repsurf_fps_max_points()) return (int)cudaErrorInvalidValue;
  return (int)dispatch(shape_for(n), xyz, nullptr, batch, n, npoint, 1, idx_out, nullptr,
                       stream);
}
