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
// with sel[b, m, s] = n, is deterministic: the wrapper hands it the slots
// grouped by point (a stable sort of b*N + sel, so each point's slots are
// in ascending (m, s) order, and the start of each point's run), and one
// thread sums one (point, channel) over its run in that order.  No atomics:
// the result is bit-equal run to run and to a sequential float32 sum in
// ascending (m, s) order.  It is bound by reading the cotangent once (SA2:
// [64, 128, 64, 138] f32, 290 MB, each element read by one thread);
// consecutive threads take consecutive channels of a point, so a wide
// cotangent row is read by consecutive lanes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxS = 128;
constexpr int kScatterThreads = 256;

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

// One thread per (point row, output channel); rows = B * N.
__global__ void ball_scatter_kernel(const float* __restrict__ g,
                                    const int* __restrict__ order,
                                    const int* __restrict__ starts, int rows,
                                    int c_in, int coff,
                                    float* __restrict__ dst) {
  const int c_out = c_in + coff;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)rows * c_out) return;
  const int row = (int)(e / c_out);
  const int ch = (int)(e - (size_t)row * c_out) - coff;
  float acc = 0.0f;
  if (ch >= 0) {
    const int hi = starts[row + 1];
    for (int k = starts[row]; k < hi; ++k) {
      acc += g[(size_t)order[k] * c_in + ch];
    }
  }
  dst[e] = acc;
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

// g [P, C_in] f32 (P = B*M*S slots); order [P] i32, the slots grouped by
// point in ascending slot order; starts [rows + 1] i32, where each point's
// run begins; dst [rows, coff + C_in] f32, channels 0:coff written as 0.
extern "C" int repsurf_ball_scatter(const float* g, const int* order,
                                    const int* starts, int rows, int c_in,
                                    int coff, float* dst,
                                    cudaStream_t stream) {
  if (rows < 1 || c_in < 1 || coff < 0) return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)rows * (c_in + coff);
  const unsigned blocks =
      (unsigned)((total + kScatterThreads - 1) / kScatterThreads);
  ball_scatter_kernel<<<blocks, kScatterThreads, 0, stream>>>(
      g, order, starts, rows, c_in, coff, dst);
  return (int)cudaGetLastError();
}
