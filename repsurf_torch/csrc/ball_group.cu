// Fused ball query + grouping, one warp per query, and the scatter-add that
// is the backward of both groupings.
//
// Replaces repsurf_tpu/ops/pallas/ball_group.py:
//   * _ball_feat_kernel (wide C) and _ball_feat_t_kernel (C <= 48), the
//     SA-CD split (ball_feature_kernel, ball_feature_kernel_wide): both are
//     TPU layouts of one function; one body serves both surface-abstraction
//     stages, instantiated for short and long spans (kWideSpan);
//   * _ball_kernel, the grouping of every channel (ball_group_kernel,
//     ball_group_kernel_wide);
//   * the custom VJPs _ball_feat_bwd and _ball_group_bwd, one scatter-add
//     of the cotangent through the selection (ball_scatter_kernel).
//
// What bounds the forwards on the H100: the grouped output.  At the second
// stage of the classifier (M = 128, S = 64, C = 141) every query writes
// S*(C+3) floats, 37 KB, against a scan of at most N = 512 candidates; the
// kernels are bound by device-memory writes.  Both forwards are one body
// (ball_body): blocks of 8 queries of one sample stage its coordinates in
// shared memory, each warp selects from them 32 candidates a ballot (four
// independent ballots a step), so the in-order selection costs a popcount
// per hit and stops as soon as S hits are found (staged_select); each
// query's grouped channels go out as one contiguous span of 16-byte stores
// walked without a division per element (walk_span: channels 3.. for the
// feature kernel, after its pos; every channel for the row grouping).
// Each forward can also write the selection, [B, M, S] int32, which the
// backward reuses instead of searching again.
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

#include "knn_topk.cuh"

namespace {

constexpr int kBallWarps = 8;    // both forwards: queries (warps) per block
constexpr int kStage = 2048;     // staged points (24 KB)
constexpr int kPosStage = 32 * 6 + 4;  // ball_feature: a round of pos, 16-byte slack
constexpr int kMaxS = 128;
// A query's span of at least this many floats (16 float4 rounds a lane) takes
// the wide instantiation of a forward: the walk unrolled 8 times (8 spans'
// loads in flight a lane) and at most 64 registers (4 blocks an SM); a
// shorter one the narrow (no unroll, the compiler's registers).  Each won
// at its SA shape for both forwards (device time on the H100 against
// unrolls of 1, 2, 4 and 8 and register caps of 4, 5 and 6 blocks an SM;
// an unrolled walk over a short span only adds registers).
constexpr int kWideSpan = 2048;
constexpr int kScatterThreads = 512;

// The staged selection, shared by both forwards; called by every thread of
// the block (it holds the block's barriers).  The block stages its sample's
// valid coordinates in shared memory as three planes (kStage points at a
// time); each live warp tests 32 candidates a ballot, four independent
// ballots a step, puts hits in index order, and stops after the step that
// reaches nsample hits; the block stops staging once no warp needs more.
// slots[0 .. min(count, nsample)) get the first in-radius valid points in
// index order; returns count (which may exceed nsample).  On return the
// stage holds the whole valid cloud when nv <= kStage.
__device__ __forceinline__ int staged_select(const float* __restrict__ src, int nv,
                                             float qx, float qy, float qz, float r2,
                                             int nsample, bool live, int* slots, float* px,
                                             float* py, float* pz, int lane) {
  int count = 0;
  for (int base = 0; base < nv; base += kStage) {
    if (!__syncthreads_or(live && count < nsample)) break;  // the stage is free
    const int len = min(kStage, nv - base);
    for (int t = threadIdx.x; t < len; t += blockDim.x) {
      const float* p = src + (size_t)(base + t) * 3;
      px[t] = p[0];
      py[t] = p[1];
      pz[t] = p[2];
    }
    __syncthreads();
    if (!live) continue;
    // four ballots of 32 a step, independent of each other; hits past the
    // S-th of a step are counted but never written
    for (int t0 = 0; t0 < len && count < nsample; t0 += 4 * 32) {
      unsigned mask[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = t0 + 32 * u + lane;
        bool hit = false;
        if (t < len) {
          const float dx = px[t] - qx;
          const float dy = py[t] - qy;
          const float dz = pz[t] - qz;
          hit = dx * dx + dy * dy + dz * dz <= r2;
        }
        mask[u] = __ballot_sync(0xffffffffu, hit);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (mask[u] == 0u) continue;  // uniform over the warp; most ballots of a small ball
        const int slot = count + __popc(mask[u] & ((1u << lane) - 1u));
        if ((mask[u] >> lane & 1u) && slot < nsample) slots[slot] = base + t0 + 32 * u + lane;
        count += __popc(mask[u]);
      }
    }
  }
  return count;
}

// One query's [S, w] span of grouped channels, shared by both forwards:
// out[s * w + ch] = trow[pick(s) * c + ch], pick(s) = slots[s] for s <
// filled, else first (trow is the sample's tcat plus the channel offset).
// The warp writes it as 16-byte stores, four elements a lane, between a
// scalar head (up to out's first 16-byte boundary) and a scalar tail; each
// lane keeps its (slot, channel) and steps it by 128 elements with a carry:
// no integer division per element; the loop unrolled kSpans times.  w >= 1.
template <int kSpans>
__device__ __forceinline__ void walk_span(float* __restrict__ out,
                                          const float* __restrict__ trow, int c, int w,
                                          int nsample, const int* slots, int filled,
                                          int first, int lane) {
  const int total = nsample * w;
  const int head = min((4 - knn_topk::span_pad(out)) & 3, total);
  const int body = (total - head) >> 2;
  // the head and the tail, at most 3 elements each
  auto put = [&](int e) {
    const int s = e / w;
    out[e] = trow[(size_t)(s < filled ? slots[s] : first) * c + e - s * w];
  };
  if (lane < head) put(lane);
  if (head + 4 * body + lane < total) put(head + 4 * body + lane);
  // the body: lane l's float4 v = l, l + 32, ...; (s, ch) its first element
  const int step_s = 128 / w, step_ch = 128 - step_s * w;
  int s = (head + 4 * lane) / w;
  int ch = head + 4 * lane - s * w;
  float4* f4 = reinterpret_cast<float4*>(out + head);
#pragma unroll kSpans
  for (int v = lane; v < body; v += 32) {
    float val[4];
    int ss = s, cc = ch;
    int j = ss < filled ? slots[ss] : first;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      val[u] = trow[(size_t)j * c + cc];
      if (++cc == w) {
        cc = 0;
        ++ss;
        if (u < 3) j = ss < filled ? slots[ss] : first;
      }
    }
    f4[v] = make_float4(val[0], val[1], val[2], val[3]);
    s += step_s;
    ch += step_ch;
    if (ch >= w) {
      ch -= w;
      ++s;
    }
  }
}

// The body of both forwards: grid (ceil(M / kBallWarps), B), blocks of
// kBallWarps queries of one sample, a warp a query, the selection by
// staged_select; kWide: the walk unrolled 8 times (see kWideSpan).
//   kPos (ball_feature_kernel): pos through a shared stage of 32 slots at a
//     time and knn_topk::store_span (each lane one slot of a round, which
//     also writes sel when asked), then channels 3.. of tcat by walk_span
//     into feat [B, M, S, C-3] (`out`);
//   !kPos (ball_group_kernel): sel as a span of S ints when asked, then
//     every channel of tcat by walk_span into out [B, M, S, C]; out null
//     skips the walk (repsurf_ball_group_select_floor, a measurement).
template <bool kPos, bool kWide>
__device__ __forceinline__ void ball_body(const float* __restrict__ xyz,
                                          const float* __restrict__ new_xyz,
                                          const float* __restrict__ tcat,
                                          const int* __restrict__ valid, int n, int m, int c,
                                          int nsample, float r2, int return_polar,
                                          float* __restrict__ pos, float* __restrict__ out,
                                          int* __restrict__ sel_out) {
  __shared__ float px[kStage], py[kStage], pz[kStage];
  __shared__ int sel[kBallWarps][kMaxS];
  __shared__ __align__(16) float pstage[kPos ? kBallWarps : 1][kPos ? kPosStage : 4];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int mq = blockIdx.x * kBallWarps + warp;
  const bool live = mq < m;  // uniform over the warp
  const int nv = valid == nullptr ? n : valid[b];
  const float* src = xyz + (size_t)b * n * 3;
  const size_t query = (size_t)b * m + (live ? mq : 0);
  const float qx = new_xyz[query * 3 + 0];
  const float qy = new_xyz[query * 3 + 1];
  const float qz = new_xyz[query * 3 + 2];
  int* slots = sel[warp];

  const int count = staged_select(src, nv, qx, qy, qz, r2, nsample, live, slots, px, py, pz,
                                  lane);
  if (!live) return;
  __syncwarp();
  const int filled = min(count, nsample);
  const int first = count == 0 ? 0 : slots[0];

  if (!kPos) {
    if (sel_out != nullptr) {
      for (int s = lane; s < nsample; s += 32) {
        sel_out[query * nsample + s] = s < filled ? slots[s] : first;
      }
    }
    if (out != nullptr) {
      walk_span<kWide ? 8 : 1>(out + query * nsample * c, tcat + (size_t)b * n * c, c, c, nsample,
                            slots, filled, first, lane);
    }
    return;
  }

  // pos: each lane one slot of a round of 32, staged, then the round's span;
  // the whole valid cloud is still staged when it fits: read it there
  const bool staged = nv >= 1 && nv <= kStage;
  const int pc = return_polar ? 6 : 3;
  float* pout = pos + query * nsample * pc;
  float* stage = pstage[warp];
  const int pad = knn_topk::span_pad(pout);  // the same for every round: 32 * pc = 0 mod 4
  for (int s0 = 0; s0 < nsample; s0 += 32) {
    const int s = s0 + lane;
    if (s < nsample) {
      const int j = s < filled ? slots[s] : first;
      if (sel_out != nullptr) sel_out[query * nsample + s] = j;
      const float rx = (staged ? px[j] : src[j * 3 + 0]) - qx;
      const float ry = (staged ? py[j] : src[j * 3 + 1]) - qy;
      const float rz = (staged ? pz[j] : src[j * 3 + 2]) - qz;
      float* o = stage + pad + lane * pc;
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
    __syncwarp();
    knn_topk::store_span(pout + s0 * pc, stage, min(32, nsample - s0) * pc, lane, 32);
    __syncwarp();
  }

  // feat: channels 3.. of tcat's selected rows
  if (c > 3) {
    walk_span<kWide ? 8 : 1>(out + query * nsample * (c - 3), tcat + (size_t)b * n * c + 3, c,
                           c - 3, nsample, slots, filled, first, lane);
  }
}

// Each forward in two instantiations (see kWideSpan): narrow, with the
// registers the compiler picks for 256 threads, and wide, with at most 64
// (4 blocks an SM).
__global__ void __launch_bounds__(kBallWarps * 32)
    ball_feature_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                        const float* __restrict__ tcat, const int* __restrict__ valid, int n,
                        int m, int c, int nsample, float r2, int return_polar,
                        float* __restrict__ pos, float* __restrict__ feat,
                        int* __restrict__ sel_out) {
  ball_body<true, false>(xyz, new_xyz, tcat, valid, n, m, c, nsample, r2, return_polar, pos,
                         feat, sel_out);
}

__global__ void __launch_bounds__(kBallWarps * 32, 4)
    ball_feature_kernel_wide(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                             const float* __restrict__ tcat, const int* __restrict__ valid, int n,
                             int m, int c, int nsample, float r2, int return_polar,
                             float* __restrict__ pos, float* __restrict__ feat,
                             int* __restrict__ sel_out) {
  ball_body<true, true>(xyz, new_xyz, tcat, valid, n, m, c, nsample, r2, return_polar, pos,
                        feat, sel_out);
}

__global__ void __launch_bounds__(kBallWarps * 32)
    ball_group_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                      const float* __restrict__ tcat, const int* __restrict__ valid, int n,
                      int m, int c, int nsample, float r2, float* __restrict__ out,
                      int* __restrict__ sel_out) {
  ball_body<false, false>(xyz, new_xyz, tcat, valid, n, m, c, nsample, r2, 0, nullptr, out,
                          sel_out);
}

__global__ void __launch_bounds__(kBallWarps * 32, 4)
    ball_group_kernel_wide(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                           const float* __restrict__ tcat, const int* __restrict__ valid, int n,
                           int m, int c, int nsample, float r2, float* __restrict__ out,
                           int* __restrict__ sel_out) {
  ball_body<false, true>(xyz, new_xyz, tcat, valid, n, m, c, nsample, r2, 0, nullptr, out,
                         sel_out);
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
  const dim3 grid((m + kBallWarps - 1) / kBallWarps, batch);
  const auto kernel =
      nsample * (c - 3) >= kWideSpan ? ball_feature_kernel_wide : ball_feature_kernel;
  kernel<<<grid, kBallWarps * 32, 0, stream>>>(xyz, new_xyz, tcat, valid, n, m, c, nsample, r2,
                                               return_polar, pos, feat, sel);
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
  const dim3 grid((m + kBallWarps - 1) / kBallWarps, batch);
  const auto kernel = nsample * c >= kWideSpan ? ball_group_kernel_wide : ball_group_kernel;
  kernel<<<grid, kBallWarps * 32, 0, stream>>>(xyz, new_xyz, tcat, valid, n, m, c, nsample, r2,
                                               out, sel);
  return (int)cudaGetLastError();
}

// The row kernel's launch for C channels without its output walk: the
// staged selection and sel [B, M, S] i32 alone.  A measurement of the
// selection, the floor under repsurf_ball_group's time.
extern "C" int repsurf_ball_group_select_floor(const float* xyz, const float* new_xyz,
                                               const int* valid, int batch, int n, int m,
                                               int c, int nsample, float r2, int* sel,
                                               cudaStream_t stream) {
  if (nsample > kMaxS || c < 1 || sel == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid((m + kBallWarps - 1) / kBallWarps, batch);
  const auto kernel = nsample * c >= kWideSpan ? ball_group_kernel_wide : ball_group_kernel;
  kernel<<<grid, kBallWarps * 32, 0, stream>>>(xyz, new_xyz, nullptr, valid, n, m, c, nsample,
                                               r2, nullptr, sel);
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
