// Fused umbrella geometry for the classification style, one thread per
// query point.
//
// Replaces repsurf_tpu/ops/pallas/umbrella.py:_umbrella_tq_kernel (with its
// _fan_geometry_pack_tq).
//
// What bounds it on the H100: the k-nearest-neighbour scan, N candidates per
// query, a few flops and up to K compare-and-swap steps each: O(N^2) work per
// sample, issue-bound, against an output of only G*C floats per query.  The
// design tiles the candidates through shared memory (every thread of a block
// reads the same tile, so the cloud leaves device memory once per block),
// keeps the K best in a register list sorted by insertion, and runs the whole
// fan geometry in registers: nothing but the [B, N, G, C] features is written.
//
// Per query q (semantics identical to the plain version in
// ops/kernels/umbrella.py):
//   * kNN over the valid points with direct coordinate differences; invalid
//     points sit at 1e10; ascending, lowest index first on ties (a candidate
//     enters the list only on a strict <, candidates scanned in index order);
//     a slot at >= 1e10 is missing and takes point 0's coordinates;
//   * kNN column 0 is dropped (cls), leaving G = K - 1 fan neighbours, taken
//     relative to q;
//   * stable ascending rank by azimuth phi = atan2(y, x) / 2pi + 0.5;
//   * fan g = (q, sorted g, sorted g+1 mod G): unit normal (zero for a
//     degenerate fan), its sign set by fan 0's x component; centroid / 3;
//     the centroid's xyz2sphere; the plane constant n.c / sqrt(3);
//   * degenerate fans take the first good fan's centroid, normal and
//     constant (fan 0 when all are degenerate);
//   * channels [cx, cy, cz, rho, theta, phi, nx, ny, nz, const].
// The per-sample random inversion of the normal is left to the caller.
//
// Exactness: products and sums are rounded one by one (-fmad=false), in the
// order the plain version writes them; division and sqrt are IEEE.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 256;
constexpr float kBig = 1e10f;

__device__ __forceinline__ float azimuth(float x, float y) {
  const float two_pi = 2.0f * (float)M_PI;
  const bool xy0 = (x == 0.0f) && (y == 0.0f);
  return atan2f(y, xy0 ? 1.0f : x) / two_pi + 0.5f;
}

template <int K, int SKIP>
__global__ void umbrella_kernel(const float* __restrict__ xyz,
                                const int* __restrict__ valid, int n,
                                float* __restrict__ out,
                                int* __restrict__ knn_out) {
  constexpr int G = K - SKIP;
  constexpr int C = 10;
  __shared__ float tx[kTile], ty[kTile], tz[kTile];

  const int b = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const int nv = valid == nullptr ? n : valid[b];
  const float* src = xyz + (size_t)b * n * 3;
  const bool live = q < n;
  const float qx = live ? src[q * 3 + 0] : 0.0f;
  const float qy = live ? src[q * 3 + 1] : 0.0f;
  const float qz = live ? src[q * 3 + 2] : 0.0f;

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bi[s] = 0;
  }

  for (int base = 0; base < n; base += kTile) {
    __syncthreads();
    for (int t = threadIdx.x; t < kTile && base + t < n; t += kThreads) {
      const int j = base + t;
      tx[t] = src[j * 3 + 0];
      ty[t] = src[j * 3 + 1];
      tz[t] = src[j * 3 + 2];
    }
    __syncthreads();
    const int len = min(kTile, n - base);
    for (int t = 0; t < len; ++t) {
      const int j = base + t;
      const float dx = tx[t] - qx, dy = ty[t] - qy, dz = tz[t] - qz;
      float d2 = dx * dx + dy * dy + dz * dz;
      if (j >= nv) d2 = kBig;
      if (d2 < bd[K - 1]) {
        bd[K - 1] = d2;
        bi[K - 1] = j;
#pragma unroll
        for (int s = K - 1; s > 0; --s) {
          if (bd[s] < bd[s - 1]) {  // strict: an equal distance stays behind
            const float td = bd[s];
            bd[s] = bd[s - 1];
            bd[s - 1] = td;
            const int ti = bi[s];
            bi[s] = bi[s - 1];
            bi[s - 1] = ti;
          }
        }
      }
    }
  }
  if (!live) return;
  if (knn_out != nullptr) {
    int* ko = knn_out + ((size_t)b * n + q) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) ko[s] = bd[s] >= kBig ? 0 : bi[s];
  }

  // fan neighbours relative to q; a missing slot takes point 0
  float gx[G], gy[G], gz[G], phi[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int j = bd[g + SKIP] >= kBig ? 0 : bi[g + SKIP];
    gx[g] = src[j * 3 + 0] - qx;
    gy[g] = src[j * 3 + 1] - qy;
    gz[g] = src[j * 3 + 2] - qz;
    phi[g] = azimuth(gx[g], gy[g]);
  }

  // stable ascending rank, then scatter into sorted order
  int rank[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    int r = 0;
#pragma unroll
    for (int j = 0; j < G; ++j)
      r += (phi[j] < phi[g]) || (phi[j] == phi[g] && j < g);
    rank[g] = r;
  }
  float sx[G], sy[G], sz[G];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    sx[r] = 0.0f;
    sy[r] = 0.0f;
    sz[r] = 0.0f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (rank[g] == r) {
        sx[r] = gx[g];
        sy[r] = gy[g];
        sz[r] = gz[g];
      }
    }
  }

  float cx[G], cy[G], cz[G], ux[G], uy[G], uz[G], pv[G];
  float rho[G], theta[G], phic[G];
  bool deg[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int h = (g + 1) % G;
    const float nx = sy[g] * sz[h] - sz[g] * sy[h];
    const float ny = sz[g] * sx[h] - sx[g] * sz[h];
    const float nz = sx[g] * sy[h] - sy[g] * sx[h];
    const float s2 = nx * nx + ny * ny + nz * nz;
    deg[g] = s2 == 0.0f;
    const float norm = sqrtf(deg[g] ? 1.0f : s2);
    ux[g] = deg[g] ? 0.0f : nx / norm;
    uy[g] = deg[g] ? 0.0f : ny / norm;
    uz[g] = deg[g] ? 0.0f : nz / norm;
    cx[g] = (sx[g] + sx[h]) / 3.0f;
    cy[g] = (sy[g] + sy[h]) / 3.0f;
    cz[g] = (sz[g] + sz[h]) / 3.0f;
  }
  const float sign = ux[0] > 0.0f ? 1.0f : -1.0f;
  const float pi = (float)M_PI;
  const float sqrt3 = sqrtf(3.0f);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    ux[g] *= sign;
    uy[g] *= sign;
    uz[g] *= sign;
    const float s2c = cx[g] * cx[g] + cy[g] * cy[g] + cz[g] * cz[g];
    const bool zero = s2c == 0.0f;
    const float r = zero ? 0.0f : sqrtf(s2c);
    const float u = fminf(fmaxf(cz[g] / (zero ? 1.0f : r), -1.0f), 1.0f);
    float th;
    if (fabsf(u) >= 1.0f) {
      th = u > 0.0f ? 0.0f : pi;
    } else {
      th = acosf(u);
    }
    rho[g] = r;
    theta[g] = (zero ? 0.0f : th) / pi;
    phic[g] = azimuth(cx[g], cy[g]);
    pv[g] = (ux[g] * cx[g] + uy[g] * cy[g] + uz[g] * cz[g]) / sqrt3;
  }

  // first good fan (fan 0 when every fan is degenerate)
  int fo = 0;
#pragma unroll
  for (int g = G - 1; g >= 0; --g)
    if (!deg[g]) fo = g;
  float rc[7] = {0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g == fo) {
      rc[0] = cx[g];
      rc[1] = cy[g];
      rc[2] = cz[g];
      rc[3] = ux[g];
      rc[4] = uy[g];
      rc[5] = uz[g];
      rc[6] = pv[g];
    }
  }

  float* o = out + ((size_t)b * n + q) * G * C;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const bool bad = deg[g];
    o[g * C + 0] = bad ? rc[0] : cx[g];
    o[g * C + 1] = bad ? rc[1] : cy[g];
    o[g * C + 2] = bad ? rc[2] : cz[g];
    o[g * C + 3] = rho[g];
    o[g * C + 4] = theta[g];
    o[g * C + 5] = phic[g];
    o[g * C + 6] = bad ? rc[3] : ux[g];
    o[g * C + 7] = bad ? rc[4] : uy[g];
    o[g * C + 8] = bad ? rc[5] : uz[g];
    o[g * C + 9] = bad ? rc[6] : pv[g];
  }
}

}  // namespace

// xyz [B, N, 3] f32, valid [B] i32 or null, out [B, N, k-1, 10] f32
// (classification style: kNN column 0 dropped); knn_out [B, N, k] i32 or
// null receives the kNN indices, a missing slot as 0.  Only k = 9, the repo's
// group size 8 + 1, is instantiated; any other k is refused.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for another k.
extern "C" int repsurf_umbrella_cls(const float* xyz, const int* valid,
                                    int batch, int n, int k, float* out,
                                    int* knn_out, cudaStream_t stream) {
  if (k != 9) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  umbrella_kernel<9, 1><<<grid, kThreads, 0, stream>>>(xyz, valid, n, out,
                                                        knn_out);
  return (int)cudaGetLastError();
}
