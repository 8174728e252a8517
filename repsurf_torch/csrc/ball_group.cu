// Fused ball query + grouping, one warp per query, and the scatter-add that
// is the backward of both groupings.
//
// Replaces repsurf_tpu/ops/pallas/ball_group.py:
//   * _ball_feat_kernel (wide C) and _ball_feat_t_kernel (C <= 48), the
//     SA-CD split (ball_feature_kernel): both are TPU layouts of one
//     function; this one kernel serves both surface-abstraction stages;
//   * _ball_kernel, the grouping of every channel (ball_group_kernel);
//   * the custom VJPs _ball_feat_bwd and _ball_group_bwd, one scatter-add
//     of the cotangent through the selection (ball_scatter_kernel).
//
// What bounds the forwards on the H100: the grouped output.  At the second
// stage of the classifier (M = 128, S = 64, C = 141) every query writes
// S*(C+3) floats, 37 KB, against a scan of at most N = 512 candidates; the
// kernels are bound by device-memory writes.  The design scans the
// candidates 32 at a time with one warp ballot, so the in-order selection
// costs a popcount per hit, stops as soon as S hits are found, and then
// writes each query's outputs with consecutive lanes on consecutive
// addresses.  Each forward can also write the selection, [B, M, S] int32,
// which the backward reuses instead of searching again.
//
// Per query (semantics identical to the plain versions in
// ops/kernels/ball_group.py): the first S valid points, in index order,
// with d2 <= r2 (d2 from direct coordinate differences, r2 = the f32
// rounding of radius**2); a short ball is padded with its first hit; an
// empty ball gathers point 0.  Outputs:
//   ball_feature: pos  [B, M, S, 3|6]: the neighbour minus the query (+ its
//                      xyz2sphere); feat [B, M, S, C-3]: channels 3.. of tcat;
//   ball_group:   out  [B, M, S, C]: every channel of tcat.
//
// Exactness: d2 = (dx*dx + dy*dy) + dz*dz rounded op by op (-fmad=false);
// the radius test is exact against the plain version's.
//
// The backward, dst[b, n, coff + c] = sum of g[b, m, s, c] over the slots
// with sel[b, m, s] = n, is deterministic and takes one launch
// (ball_scatter_kernel): each block builds the runs of one cloud's slots
// grouped by point itself, then sums them.  The keys are point indices
// below N, so a counting sort fits:
//   * a histogram per warp: each warp owns a contiguous segment of the
//     cloud's slots, loads its keys 8 tiles of 32 at a time, and counts
//     them with shared-memory atomics into its own row of a [16, points]
//     table (counts do not depend on the order);
//   * a scan, key-major and warp-minor, so each (key, warp) gets where its
//     slots start;
//   * the placement: each warp walks its segment again in the same order
//     and puts a slot at its (key, warp) cursor plus its rank among the
//     lanes of its tile that hold the key (__match_any_sync).  Atomic
//     placement with a sort of each piece afterwards measured slower: the
//     padded slots of a short ball share a key and serialise the atomics.
// The sort is stable: each point's run lists its slots in ascending (m, s)
// order, exactly selection_csr's runs, and one thread sums one (point,
// channel) over its run in that order.  No atomics on the values: the
// result is bit-equal run to run and to a sequential float32 sum in
// ascending (m, s) order.
//
// The blocks of a cloud split its points (enough blocks for 4 an SM); each
// rebuilds the runs of its own points only, from a scan of all the cloud's
// keys.  The runs live in shared memory (the table, the starts, and up to
// M*S slot ids, 16-bit where M*S < 65,536); a cloud too large for that
// takes the same kernel with the table in a global scratch and the slot
// ids written straight to their place in the cloud's runs.  Consecutive
// threads take consecutive output channels of a point (pairs of channels,
// one float2 load, where C is even), so a warp reads whole cotangent rows.
// It is bound by reading the cotangent once (SA2: [64, 128, 64, 138] f32,
// 290 MB).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxS = 128;
constexpr int kScatterThreads = 512;

// The warp's selection for one query: slots[0 .. min(count, nsample)) get
// the first in-radius valid points in index order; returns count (which
// may exceed nsample).  Called by all 32 lanes together.
__device__ int ball_select(const float* __restrict__ src, int nv, float qx,
                           float qy, float qz, float r2, int nsample,
                           int* slots, int lane) {
  int count = 0;
  for (int base = 0; base < nv && count < nsample; base += 32) {
    const int j = base + lane;
    bool hit = false;
    if (j < nv) {
      const float dx = src[j * 3 + 0] - qx;
      const float dy = src[j * 3 + 1] - qy;
      const float dz = src[j * 3 + 2] - qz;
      hit = dx * dx + dy * dy + dz * dz <= r2;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    const int slot = count + __popc(mask & ((1u << lane) - 1u));
    if (hit && slot < nsample) slots[slot] = j;
    count += __popc(mask);
  }
  __syncwarp();
  return count;
}

__global__ void ball_feature_kernel(const float* __restrict__ xyz,
                                    const float* __restrict__ new_xyz,
                                    const float* __restrict__ tcat,
                                    const int* __restrict__ valid, int batch,
                                    int n, int m, int c, int nsample, float r2,
                                    int return_polar, float* __restrict__ pos,
                                    float* __restrict__ feat,
                                    int* __restrict__ sel_out) {
  __shared__ int sel[kWarps][kMaxS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int query = blockIdx.x * kWarps + warp;
  if (query >= batch * m) return;  // whole warps leave together
  const int b = query / m;
  const int nv = valid == nullptr ? n : valid[b];
  const float* src = xyz + (size_t)b * n * 3;
  const float qx = new_xyz[(size_t)query * 3 + 0];
  const float qy = new_xyz[(size_t)query * 3 + 1];
  const float qz = new_xyz[(size_t)query * 3 + 2];
  int* slots = sel[warp];

  const int count = ball_select(src, nv, qx, qy, qz, r2, nsample, slots, lane);
  const int filled = min(count, nsample);
  const int first = count == 0 ? 0 : slots[0];

  const int pc = return_polar ? 6 : 3;
  float* pout = pos + (size_t)query * nsample * pc;
  for (int s = lane; s < nsample; s += 32) {
    const int j = s < filled ? slots[s] : first;
    if (sel_out != nullptr) sel_out[(size_t)query * nsample + s] = j;
    const float rx = src[j * 3 + 0] - qx;
    const float ry = src[j * 3 + 1] - qy;
    const float rz = src[j * 3 + 2] - qz;
    float* o = pout + s * pc;
    o[0] = rx;
    o[1] = ry;
    o[2] = rz;
    if (return_polar) {
      const float pi = (float)M_PI;
      const float s2 = rx * rx + ry * ry + rz * rz;
      const bool zero = s2 == 0.0f;
      const float rho = zero ? 0.0f : sqrtf(s2);
      const float u = fminf(fmaxf(rz / (zero ? 1.0f : rho), -1.0f), 1.0f);
      float th;
      if (fabsf(u) >= 1.0f) {
        th = u > 0.0f ? 0.0f : pi;
      } else {
        th = acosf(u);
      }
      const bool xy0 = (rx == 0.0f) && (ry == 0.0f);
      o[3] = rho;
      o[4] = (zero ? 0.0f : th) / pi;
      o[5] = atan2f(ry, xy0 ? 1.0f : rx) / (2.0f * pi) + 0.5f;
    }
  }

  const int fc = c - 3;
  const float* tsrc = tcat + (size_t)b * n * c;
  float* fout = feat + (size_t)query * nsample * fc;
  for (int e = lane; e < nsample * fc; e += 32) {
    const int s = e / fc;
    const int ch = e - s * fc;
    const int j = s < filled ? slots[s] : first;
    fout[e] = tsrc[(size_t)j * c + 3 + ch];
  }
}

__global__ void ball_group_kernel(const float* __restrict__ xyz,
                                  const float* __restrict__ new_xyz,
                                  const float* __restrict__ tcat,
                                  const int* __restrict__ valid, int batch,
                                  int n, int m, int c, int nsample, float r2,
                                  float* __restrict__ out,
                                  int* __restrict__ sel_out) {
  __shared__ int sel[kWarps][kMaxS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int query = blockIdx.x * kWarps + warp;
  if (query >= batch * m) return;  // whole warps leave together
  const int b = query / m;
  const int nv = valid == nullptr ? n : valid[b];
  const float* src = xyz + (size_t)b * n * 3;
  int* slots = sel[warp];

  const int count = ball_select(src, nv, new_xyz[(size_t)query * 3 + 0],
                                new_xyz[(size_t)query * 3 + 1],
                                new_xyz[(size_t)query * 3 + 2], r2, nsample,
                                slots, lane);
  const int filled = min(count, nsample);
  const int first = count == 0 ? 0 : slots[0];
  if (sel_out != nullptr) {
    for (int s = lane; s < nsample; s += 32) {
      sel_out[(size_t)query * nsample + s] = s < filled ? slots[s] : first;
    }
  }
  const float* tsrc = tcat + (size_t)b * n * c;
  float* gout = out + (size_t)query * nsample * c;
  for (int e = lane; e < nsample * c; e += 32) {
    const int s = e / c;
    const int ch = e - s * c;
    const int j = s < filled ? slots[s] : first;
    gout[e] = tsrc[(size_t)j * c + ch];
  }
}

constexpr int kScatterWarps = kScatterThreads / 32;
constexpr int kUnroll = 8;  // tiles of keys a warp loads at once
// blocks a cloud: enough for this many 512-thread blocks an SM (measured
// against 1 to 8)
constexpr int kBlocksPerSm = 4;

// ints of a block's global workspace: starts and the cursor table
__host__ __device__ inline int scatter_ws_ints(int len) {
  return len + 1 + kScatterWarps * len;
}

// Exclusive scan of v[0 .. count) in place, v[count] = the total; called by
// the whole block.
__device__ void block_exclusive_scan(int* v, int count, int* warp_sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (count + kScatterThreads - 1) / kScatterThreads;
  const int lo = min(count, tid * per), hi = min(count, lo + per);
  int sum = 0;
  for (int j = lo; j < hi; ++j) sum += v[j];
  int incl = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kScatterWarps ? warp_sums[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += o;
    }
    if (lane < kScatterWarps) warp_sums[lane] = w;  // inclusive
  }
  __syncthreads();
  int run = incl - sum + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int j = lo; j < hi; ++j) {
    const int x = v[j];
    v[j] = run;
    run += x;
  }
  if (tid == kScatterThreads - 1) v[count] = run;
  __syncthreads();
}

// blockIdx.x = b * splits + split; the block takes points [k0, k0 + len)
// of cloud b.  Its workspace: starts [len + 1] and the cursor table
// [kScatterWarps, len], int, then (shared variant) the slot ids, up to q
// of them, of type Idx (16 bits where q < 65,536, so more blocks fit an
// SM).
// ws_global != null: starts and table at ws_global + blockIdx.x *
// scatter_ws_ints(len), the slot ids in order_global [B * q] at their place
// in the cloud's runs.  runs_order [B*q] / runs_starts [B*N + 1], when not
// null, get the runs as selection_csr gives them.
template <typename Idx>
__global__ void __launch_bounds__(kScatterThreads)
    ball_scatter_kernel(const int* __restrict__ sel, const float* __restrict__ g, int n,
                        int q, int c_in, int coff, int splits, int len,
                        int* __restrict__ ws_global, int* __restrict__ order_global,
                        float* __restrict__ dst, int* __restrict__ runs_order,
                        int* __restrict__ runs_starts) {
  extern __shared__ int ws_shared[];
  __shared__ int warp_sums[kScatterWarps];
  __shared__ int s_below;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / splits;
  const int k0 = (blockIdx.x - b * splits) * len;
  const int nk = min(n, k0 + len) - k0;
  int* starts = ws_global != nullptr ? ws_global + (size_t)blockIdx.x * scatter_ws_ints(len)
                                     : ws_shared;
  int* table = starts + len + 1;
  const int* keys = sel + (size_t)b * q;

  for (int j = tid; j < kScatterWarps * len; j += kScatterThreads) table[j] = 0;
  if (tid == 0) s_below = 0;
  __syncthreads();

  // each warp's segment of slots, in tiles of 32 loaded kUnroll at a time
  const int seg = ((q + kScatterWarps * 32 - 1) / (kScatterWarps * 32)) * 32;
  const int w_lo = min(q, warp * seg), w_hi = min(q, w_lo + seg);
  int* cursor = table + warp * len;  // this warp's row, indexed by key - k0
  int below = 0;  // slots of points before k0: where this block's runs start
  for (int p0 = w_lo; p0 < w_hi; p0 += 32 * kUnroll) {
    int kk[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u * 32 + lane;
      kk[u] = p < w_hi ? keys[p] : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = kk[u];
      below += k >= 0 && k < k0;
      if (k >= k0 && k < k0 + nk) atomicAdd(&cursor[k - k0], 1);  // a count: any order
    }
  }
  below = __reduce_add_sync(0xffffffffu, below);
  if (lane == 0 && below) atomicAdd(&s_below, below);
  __syncthreads();

  // key-major, warp-minor: each (key, warp) cursor starts after the key's
  // slots in earlier warps; starts[] holds each key's total, then its start
  for (int kl = tid; kl < nk; kl += kScatterThreads) {
    int run = 0;
    for (int w = 0; w < kScatterWarps; ++w) {
      const int v = table[w * len + kl];
      table[w * len + kl] = run;
      run += v;
    }
    starts[kl] = run;
  }
  __syncthreads();
  block_exclusive_scan(starts, nk, warp_sums);
  const int base = s_below;
  Idx* order_s = reinterpret_cast<Idx*>(table + kScatterWarps * len);
  int* order_g = order_global != nullptr ? order_global + (size_t)b * q + base : nullptr;

  const unsigned lower = (1u << lane) - 1u;
  for (int p0 = w_lo; p0 < w_hi; p0 += 32 * kUnroll) {
    int kk[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u * 32 + lane;
      kk[u] = p < w_hi ? keys[p] : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = kk[u];
      const bool in = k >= k0 && k < k0 + nk;
      const unsigned peers = __match_any_sync(0xffffffffu, in ? k : -1);
      if (in) {
        const int at = starts[k - k0] + cursor[k - k0] + __popc(peers & lower);
        const int p = p0 + u * 32 + lane;
        if (order_g != nullptr) {
          order_g[at] = p;
        } else {
          order_s[at] = (Idx)p;
        }
      }
      __syncwarp();
      if (in && lane == __ffs(peers) - 1) cursor[k - k0] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();

  const int total = starts[nk];
  if (runs_order != nullptr) {
    const int off = b * q;
    for (int j = tid; j < total; j += kScatterThreads) {
      runs_order[off + base + j] = off + (order_g != nullptr ? order_g[j] : (int)order_s[j]);
    }
    for (int kl = tid; kl < nk; kl += kScatterThreads) {
      runs_starts[(size_t)b * n + k0 + kl] = off + base + starts[kl];
    }
    if (tid == 0 && k0 + nk == n && b == (int)gridDim.x / splits - 1) {
      runs_starts[(size_t)(b + 1) * n] = (b + 1) * q;
    }
  }

  const int wout = coff + c_in;
  const float* gb = g + (size_t)b * q * c_in;
  float* out = dst + ((size_t)b * n + k0) * wout;
  for (int e = tid; e < nk * coff; e += kScatterThreads) out[e / coff * wout + e % coff] = 0.0f;
  if ((c_in & 1) == 0) {
    // channel pairs, one float2 load a slot; each channel still sums its
    // run in order, alone
    const int h = c_in >> 1;
    for (int e = tid; e < nk * h; e += kScatterThreads) {
      const int kl = e / h;
      const int cp = e - kl * h;
      const float2* gp = reinterpret_cast<const float2*>(gb) + cp;
      float2 acc = make_float2(0.0f, 0.0f);
      const int hi = starts[kl + 1];
#pragma unroll 8
      for (int j = starts[kl]; j < hi; ++j) {
        const int slot = order_g != nullptr ? order_g[j] : (int)order_s[j];
        const float2 v = gp[(size_t)slot * h];
        acc.x += v.x;
        acc.y += v.y;
      }
      float* o = out + kl * wout + coff + 2 * cp;
      o[0] = acc.x;
      o[1] = acc.y;
    }
    return;
  }
  for (int e = tid; e < nk * c_in; e += kScatterThreads) {
    const int kl = e / c_in;
    const int ch = e - kl * c_in;
    float acc = 0.0f;
    const int hi = starts[kl + 1];
#pragma unroll 8
    for (int j = starts[kl]; j < hi; ++j) {
      const int slot = order_g != nullptr ? order_g[j] : (int)order_s[j];
      acc += gb[(size_t)slot * c_in + ch];
    }
    out[kl * wout + coff + ch] = acc;
  }
}

// The grid and workspace of the scatter for B clouds of n points and q
// slots: splits a cloud, points a block, and either shared-memory bytes
// (16-bit indices when q fits them) or the global scratch ints.
struct ScatterPlan {
  int splits, len;
  bool narrow;
  size_t smem;
  long long scratch;
};

ScatterPlan scatter_plan(int batch, int n, int q) {
  int dev = 0, sms = 132, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  int splits = (kBlocksPerSm * sms + batch - 1) / batch;
  const int most = (n + 31) / 32;  // at least 32 points a block
  splits = splits < most ? splits : most;
  splits = splits > 1 ? splits : 1;
  const int len = (n + splits - 1) / splits;
  splits = (n + len - 1) / len;
  const size_t statics = sizeof(int) * (kScatterWarps + 1);
  const bool narrow = q < 65536;
  const size_t idx = narrow ? sizeof(unsigned short) : sizeof(int);
  const size_t smem = sizeof(int) * (size_t)scatter_ws_ints(len) + idx * (size_t)q;
  if (smem + statics <= (size_t)optin) return {splits, len, narrow, smem, 0};
  return {splits, len, false, 0,
          (long long)scatter_ws_ints(len) * batch * splits + (long long)batch * q};
}

}  // namespace

extern "C" int repsurf_ball_feature_max_nsample() { return kMaxS; }

// xyz [B, N, 3], new_xyz [B, M, 3], tcat [B, N, C] f32 (channels 0:3 are
// xyz itself), valid [B] i32 or null; pos [B, M, S, 3|6], feat
// [B, M, S, C-3] f32; sel [B, M, S] i32 or null (not written).  Returns
// cudaGetLastError().
extern "C" int repsurf_ball_feature(const float* xyz, const float* new_xyz,
                                    const float* tcat, const int* valid,
                                    int batch, int n, int m, int c,
                                    int nsample, float r2, int return_polar,
                                    float* pos, float* feat, int* sel,
                                    cudaStream_t stream) {
  if (nsample > kMaxS || c < 3) return (int)cudaErrorInvalidValue;
  const int blocks = (batch * m + kWarps - 1) / kWarps;
  ball_feature_kernel<<<blocks, kWarps * 32, 0, stream>>>(
      xyz, new_xyz, tcat, valid, batch, n, m, c, nsample, r2, return_polar,
      pos, feat, sel);
  return (int)cudaGetLastError();
}

// xyz [B, N, 3], new_xyz [B, M, 3], tcat [B, N, C] f32, valid [B] i32 or
// null; out [B, M, S, C] f32; sel [B, M, S] i32 or null.
extern "C" int repsurf_ball_group(const float* xyz, const float* new_xyz,
                                  const float* tcat, const int* valid,
                                  int batch, int n, int m, int c, int nsample,
                                  float r2, float* out, int* sel,
                                  cudaStream_t stream) {
  if (nsample > kMaxS || c < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (batch * m + kWarps - 1) / kWarps;
  ball_group_kernel<<<blocks, kWarps * 32, 0, stream>>>(
      xyz, new_xyz, tcat, valid, batch, n, m, c, nsample, r2, out, sel);
  return (int)cudaGetLastError();
}

// Global scratch ints repsurf_ball_scatter needs for B clouds of n points
// and q = M*S slots: 0 where the runs fit in shared memory.
extern "C" long long repsurf_ball_scatter_scratch(int batch, int n, int q) {
  return scatter_plan(batch, n, q).scratch;
}

// sel [B, q] i32 (q = M*S; values in [0, n), others are ignored), g [B, q,
// C_in] f32; scratch: repsurf_ball_scatter_scratch ints or null when that
// is 0; dst [B, n, coff + C_in] f32, channels 0:coff written as 0.
// runs_order [B*q] / runs_starts [B*n + 1] i32, both null on the model
// path: the runs, as selection_csr returns them.  Returns
// cudaGetLastError().
extern "C" int repsurf_ball_scatter(const int* sel, const float* g, int batch, int n, int q,
                                    int c_in, int coff, int* scratch, float* dst,
                                    int* runs_order, int* runs_starts, cudaStream_t stream) {
  if (batch < 1 || n < 1 || q < 0 || c_in < 1 || coff < 0) return (int)cudaErrorInvalidValue;
  const ScatterPlan plan = scatter_plan(batch, n, q);
  if (plan.scratch > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(batch * plan.splits);
  if (plan.scratch > 0) {
    ball_scatter_kernel<int><<<blocks, kScatterThreads, 0, stream>>>(
        sel, g, n, q, c_in, coff, plan.splits, plan.len, scratch + (size_t)batch * q,
        scratch, dst, runs_order, runs_starts);
  } else if (plan.narrow) {
    const cudaError_t err = cudaFuncSetAttribute(ball_scatter_kernel<unsigned short>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
    if (err != cudaSuccess) return (int)err;
    ball_scatter_kernel<unsigned short><<<blocks, kScatterThreads, plan.smem, stream>>>(
        sel, g, n, q, c_in, coff, plan.splits, plan.len, nullptr, nullptr, dst, runs_order,
        runs_starts);
  } else {
    const cudaError_t err = cudaFuncSetAttribute(ball_scatter_kernel<int>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
    if (err != cudaSuccess) return (int)err;
    ball_scatter_kernel<int><<<blocks, kScatterThreads, plan.smem, stream>>>(
        sel, g, n, q, c_in, coff, plan.splits, plan.len, nullptr, nullptr, dst, runs_order,
        runs_starts);
  }
  return (int)cudaGetLastError();
}
