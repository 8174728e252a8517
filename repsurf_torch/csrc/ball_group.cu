// Fused ball query + grouping + SA-CD input split, one warp per query.
//
// Replaces repsurf_tpu/ops/pallas/ball_group.py:_ball_feat_kernel (wide C)
// and :_ball_feat_t_kernel (C <= 48).  Both are TPU layouts of one function;
// this one kernel serves both surface-abstraction stages.
//
// What bounds it on the H100: the grouped output.  At the second stage of
// the classifier (M = 128, S = 64, C = 141) every query writes S*(C+3)
// floats, 37 KB, against a scan of at most N = 512 candidates; the kernel is
// bound by device-memory writes.  The design scans the candidates 32 at a
// time with one warp ballot, so the in-order selection costs a popcount per
// hit, stops as soon as S hits are found, and then writes each query's
// outputs with consecutive lanes on consecutive addresses.
//
// Per query (semantics identical to the plain version in
// ops/kernels/ball_group.py): the first S valid points, in index order,
// with d2 <= r2 (d2 from direct coordinate differences, r2 = the f32
// rounding of radius**2); a short ball is padded with its first hit; an
// empty ball gathers point 0.  Outputs:
//   pos  [B, M, S, 3|6]: the neighbour minus the query (+ its xyz2sphere);
//   feat [B, M, S, C-3]: channels 3.. of tcat, gathered as they are.
//
// Exactness: d2 = (dx*dx + dy*dy) + dz*dz rounded op by op (-fmad=false);
// the radius test is exact against the plain version's.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxS = 128;

__global__ void ball_feature_kernel(const float* __restrict__ xyz,
                                    const float* __restrict__ new_xyz,
                                    const float* __restrict__ tcat,
                                    const int* __restrict__ valid, int batch,
                                    int n, int m, int c, int nsample, float r2,
                                    int return_polar, float* __restrict__ pos,
                                    float* __restrict__ feat) {
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
  const int filled = min(count, nsample);
  const int first = count == 0 ? 0 : slots[0];

  const int pc = return_polar ? 6 : 3;
  float* pout = pos + (size_t)query * nsample * pc;
  for (int s = lane; s < nsample; s += 32) {
    const int j = s < filled ? slots[s] : first;
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

}  // namespace

extern "C" int repsurf_ball_feature_max_nsample() { return kMaxS; }

// xyz [B, N, 3], new_xyz [B, M, 3], tcat [B, N, C] f32 (channels 0:3 are
// xyz itself), valid [B] i32 or null; pos [B, M, S, 3|6], feat
// [B, M, S, C-3] f32.  Returns cudaGetLastError().
extern "C" int repsurf_ball_feature(const float* xyz, const float* new_xyz,
                                    const float* tcat, const int* valid,
                                    int batch, int n, int m, int c,
                                    int nsample, float r2, int return_polar,
                                    float* pos, float* feat,
                                    cudaStream_t stream) {
  if (nsample > kMaxS || c < 3) return (int)cudaErrorInvalidValue;
  const int blocks = (batch * m + kWarps - 1) / kWarps;
  ball_feature_kernel<<<blocks, kWarps * 32, 0, stream>>>(
      xyz, new_xyz, tcat, valid, batch, n, m, c, nsample, r2, return_polar,
      pos, feat);
  return (int)cudaGetLastError();
}
