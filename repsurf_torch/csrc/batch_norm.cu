// Batch norm over the trailing channel axis of a channels-last tensor, with
// masked statistics and the ReLU that follows it: the training statistics,
// the normalisation, and the backward of both.
//
// Replaces no Pallas kernel: the JAX package leaves MaskedBatchNorm to XLA,
// which fuses its passes.  The port ran it as a dozen torch ops a call, each
// a full pass over x, and autograd's backward as many again (about 45
// passes over x's size a call with the ReLU).  Every one of these kernels is
// bound by the bytes it moves: a few operations an element against the
// H100's 3.35 TB/s.  These move x's size ten times a call:
//
//   forward, training   bn_count_kernel counts the mask's rows;
//                       bn_sum_kernel<MeanOp> reads x once for the mean,
//                       bn_sum_kernel<VarOp> once more for the centred
//                       second moment (each finished by bn_sum_finish_kernel
//                       where the sum spans blocks), which also update the
//                       running buffers; bn_normalize_kernel reads x and
//                       writes y = (x - mean) * (invstd * weight) + bias,
//                       ReLU'd;
//   forward, eval       bn_normalize_kernel alone, invstd from running_var;
//   backward            bn_sum_kernel<GradOp> reads g and x once for
//                       sum(g'), sum(g' * (x - mean)) and sum(g' * k) per
//                       channel (g' is g where the ReLU passed it, found by
//                       recomputing y's sign from x, so y is neither saved
//                       nor read), bn_sum_kernel<VarGradOp> reads x for the
//                       variance path's sum, bn_backward_dx_kernel reads g and
//                       x and writes dx.
//
// Every value is the one the module's torch composition computes (and
// autograd's backward of it), bit for bit, on the same card: the same
// float operations on each element in the same order (-fmad=false keeps
// nvcc from contracting any of them), and each per-channel sum taken in the
// order torch's own reduction takes it.  That order is torch's
// setReduceConfig and ReduceOp (ATen/native/cuda/Reduce.cuh) for a sum over
// the rows of a contiguous [rows, C] tensor: V = 4, 2 or 1 channels a
// thread, a (bw, bh) block, each thread four accumulators over rows
// y + cta * bh + i * step, added 0 + 1 + 2 + 3, a shared-memory tree over y,
// and across ctas blocks a staged sum in cta order and the same tree.
// sum_order() computes that launch shape from the rows, C and the card's
// SM count and threads a multiprocessor, as torch does.  So training takes
// the steps the reference takes: any other order of the sums, however
// exact, moves a ReLU or a max-pool at its near-ties and, through them and
// AdamW, the run (PERF.md, §6).  Sums over more than 2^31 bytes,
// which torch splits into 32-bit sub-reductions, are taken in one.
//
// Semantics (the plain versions in ops/kernels/batch_norm.py; the module's
// composition in nn/layers.py): a row counts where mask[row / group_rows]
// (every row without a mask); cnt = max(count, 1); mean = sum(x w) / cnt;
// var = max(sum((x - mean)^2 w) / cnt, 0); invstd = rsqrt(var + eps);
// running_mean = running_mean * (1 - momentum) + momentum * mean and
// running_var likewise with var * cnt / max(cnt - 1, 1).  Every row is
// normalised.  Rows outside the mask are not read by the sums (their terms
// are zeros, which leave a sum as it is).
//
// No kernel allocates: the wrapper passes the scratch
// (repsurf_bn_scratch_bytes).  The elementwise kernels cut the rows into one
// contiguous range a block, `lanes` threads a row with VEC channels each (a
// 4-, 8- or 16-byte access) and `rpi` rows side by side, so a warp reads
// consecutive addresses whatever C is.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 256;  // elementwise: threads a block, lanes x rows an iteration
constexpr int kMaxThreads = 512;  // C = 2048 in float4 accesses a slice (Geometry)
constexpr int kMaxBlocks = 2048;  // elementwise: about four waves over the H100's 132 SMs
constexpr int kMinIters = 16;     // elementwise: iterations a block at least
constexpr int kMinRows = 128;     // elementwise: rows a block at least
constexpr int kUnroll = 4;        // elementwise: iterations whose loads are in flight at once
constexpr int kSumThreads = 512;  // torch's MAX_NUM_THREADS for a float or double sum
constexpr int kSumAcc = 4;        // torch's vt0: accumulators a thread
constexpr int kSumMaxK = 3;       // sums a pass
constexpr int kFinishAhead = 4;   // staged sums a finishing thread loads at once
constexpr int kCountThreads = 256;
constexpr int kCountBlocks = 128;

template <typename T, int V>
struct Vec;
template <> struct Vec<float, 1> { using type = float; };
template <> struct Vec<float, 2> { using type = float2; };
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<double, 1> { using type = double; };
template <> struct Vec<double, 2> { using type = double2; };

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, T (&out)[V]) {
  if constexpr (sizeof(T) * V > 16) {  // double x 4: two 16-byte loads
    T half[V / 2];
    load_vec<T, V / 2>(p, half);
#pragma unroll
    for (int j = 0; j < V / 2; ++j) out[j] = half[j];
    load_vec<T, V / 2>(p + V / 2, half);
#pragma unroll
    for (int j = 0; j < V / 2; ++j) out[V / 2 + j] = half[j];
  } else {
    using W = typename Vec<T, V>::type;
    const W w = *reinterpret_cast<const W*>(p);
    const T* s = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = s[j];
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const T (&in)[V]) {
  using W = typename Vec<T, V>::type;
  W w;
  T* s = reinterpret_cast<T*>(&w);
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = in[j];
  *reinterpret_cast<W*>(p) = w;
}

__device__ __forceinline__ float t_rsqrt(float v) { return rsqrtf(v); }
__device__ __forceinline__ double t_rsqrt(double v) { return rsqrt(v); }

// The mask group of a thread's row, advanced by `step` rows at a time with
// no division: group = row / group_rows, rem = row % group_rows.
struct Groups {
  long long group, rem, dq, dr, size;
  __device__ __forceinline__ Groups(long long row, long long step, long long group_rows)
      : group(row / group_rows), rem(row % group_rows), dq(step / group_rows),
        dr(step % group_rows), size(group_rows) {}
  __device__ __forceinline__ void advance() {
    group += dq;
    rem += dr;
    if (rem >= size) {
      rem -= size;
      ++group;
    }
  }
};

template <typename T>
__device__ __forceinline__ T channel_invstd(const T* scale, int ch, int from_var, T eps) {
  return from_var ? t_rsqrt(scale[ch] + eps) : scale[ch];
}

// ---- torch's order of a sum over the rows of [rows, C] -------------------

// setReduceConfig's choices for this layout (a reduction over the outer,
// strided dimension: "vectorize along output").
struct SumOrder {
  int vec, bw, bh, gx, ctas;
  int out_mult_x, out_mult_y, step_output;
  long long in_mult_y, in_mult_cta, step_input;
};

long long last_pow2(long long n) {
  n |= n >> 1;
  n |= n >> 2;
  n |= n >> 4;
  n |= n >> 8;
  n |= n >> 16;
  n |= n >> 32;
  const long long r = n - (n >> 1);
  return r < 1 ? 1 : r;
}

long long div_up(long long a, long long b) { return (a + b - 1) / b; }

SumOrder sum_order(long long rows, int c, int num_mp, int max_threads_mp) {
  SumOrder o{};
  o.vec = c % 4 == 0 ? 4 : c % 2 == 0 ? 2 : 1;  // get_output_vec_size, aligned input
  const long long dim0 = c / o.vec, dim1 = rows;
  const int max_threads = kSumThreads / o.vec;  // set_block_dimension
  const int dim0_pow2 = dim0 < max_threads ? (int)last_pow2(dim0) : max_threads;
  const int dim1_pow2 = dim1 < max_threads ? (int)last_pow2(dim1) : max_threads;
  o.bw = dim0_pow2 < 32 ? dim0_pow2 : 32;
  o.bh = dim1_pow2 < max_threads / o.bw ? dim1_pow2 : max_threads / o.bw;
  o.bw = dim0_pow2 < max_threads / o.bh ? dim0_pow2 : max_threads / o.bh;
  long long step_input = 1;
  int step_output = 1;
  o.out_mult_x = step_output;  // split_output(block_width)
  step_output *= o.bw;
  const int threshold = o.bh * 16 < 256 ? o.bh * 16 : 256;
  if (div_up(rows, step_input) >= threshold) {  // split the input across warps
    o.in_mult_y = step_input;
    step_input *= o.bh;
  } else {
    o.out_mult_y = step_output;
    step_output *= o.bh;
  }
  const int target = num_mp * (max_threads_mp / (o.bw * o.bh));
  o.gx = (int)div_up(dim0, step_output);
  o.ctas = 1;
  const long long per_thread = div_up(rows, step_input);
  if (o.in_mult_y != 0 && per_thread >= 256 && o.gx <= target) {
    const long long c1 = div_up(target, o.gx), c2 = div_up(per_thread, 16),
                    c3 = div_up(per_thread, 256);
    const long long least = c1 < c2 ? c1 : c2;
    const long long ctas = least > c3 ? least : c3;
    if (ctas > 1) {
      o.in_mult_cta = step_input;
      step_input *= ctas;
      o.ctas = (int)ctas;
    }
  }
  o.step_input = step_input;
  o.step_output = step_output;
  return o;
}

// ReduceOp::block_y_reduce: a tree over y, each thread adding the one
// `offset` rows below it.  The result is valid at y == 0.
template <typename T, int V, int K>
__device__ __forceinline__ void block_y_sum(T (&v)[K][V], T* buf, int bw, int bh) {
  const int me = threadIdx.x + threadIdx.y * bw, plane = bw * bh * V;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) buf[k * plane + me * V + j] = v[k][j];
  for (int offset = bh / 2; offset > 0; offset >>= 1) {
    __syncthreads();
    if ((int)threadIdx.y < offset && (int)threadIdx.y + offset < bh) {
      const int other = threadIdx.x + (threadIdx.y + offset) * bw;
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          v[k][j] = v[k][j] + buf[k * plane + other * V + j];
          buf[k * plane + me * V + j] = v[k][j];
        }
    }
  }
}

// The K per-channel sums of Op's per-row terms over [rows, C], in torch's
// order: written to `staging` where they span blocks (finished by
// bn_sum_finish_kernel), else handed to Op::finish channel by channel.
template <typename T, int V, typename Op>
__global__ void __launch_bounds__(kSumThreads)
bn_sum_kernel(Op op, SumOrder o, long long rows, int c, T* __restrict__ staging) {
  constexpr int K = Op::K;
  __shared__ T buf[kSumMaxK * kSumThreads];
  const int out_idx =
      (threadIdx.x * o.out_mult_x + threadIdx.y * o.out_mult_y + blockIdx.x * o.step_output) * V;
  const long long in_idx =
      (long long)threadIdx.y * o.in_mult_y + (long long)blockIdx.y * o.in_mult_cta;
  T v[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) v[k][j] = T(0);
  if (out_idx < c && in_idx < rows) {
    const typename Op::template Lane<V> lane(op, out_idx);
    T a[kSumAcc][K][V];
#pragma unroll
    for (int i = 0; i < kSumAcc; ++i)
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int j = 0; j < V; ++j) a[i][k][j] = T(0);
    const long long stride = o.step_input;
    long long idx = in_idx;
    Groups grp(idx, stride, op.group_rows);
    while (idx + (kSumAcc - 1) * stride < rows) {
      typename Op::template Row<V> row[kSumAcc];
#pragma unroll
      for (int i = 0; i < kSumAcc; ++i) {
        row[i].load(op, lane, idx + i * stride, grp.group);
        grp.advance();
      }
#pragma unroll
      for (int i = 0; i < kSumAcc; ++i) row[i].add(lane, a[i]);
      idx += kSumAcc * stride;
    }
#pragma unroll
    for (int i = 0; i < kSumAcc; ++i) {  // the tail, accumulator by accumulator
      if (idx >= rows) break;
      typename Op::template Row<V> row;
      row.load(op, lane, idx, grp.group);
      grp.advance();
      row.add(lane, a[i]);
      idx += stride;
    }
#pragma unroll
    for (int i = 1; i < kSumAcc; ++i)
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int j = 0; j < V; ++j) a[0][k][j] = a[0][k][j] + a[i][k][j];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < V; ++j) v[k][j] = a[0][k][j];
  }
  const bool tree = o.in_mult_y != 0;
  if (tree) block_y_sum<T, V, K>(v, buf, o.bw, o.bh);
  if (out_idx >= c || (tree && threadIdx.y != 0)) return;
  if (o.ctas > 1) {
    const size_t slot = threadIdx.x + ((size_t)blockIdx.y + (size_t)blockIdx.x * o.ctas) * o.bw;
    const size_t plane = (size_t)o.gx * o.ctas * o.bw * V;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < V; ++j) staging[k * plane + slot * V + j] = v[k][j];
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    T s[K];
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] = v[k][j];
    op.finish(out_idx + j, s);
  }
}

// ReduceOp::global_reduce's last block: each thread adds the staged sums of
// ctas y, y + bh, ... in order from 0, then the tree over y.
template <typename T, int V, typename Op>
__global__ void __launch_bounds__(kSumThreads)
bn_sum_finish_kernel(Op op, SumOrder o, int c, const T* __restrict__ staging) {
  constexpr int K = Op::K;
  __shared__ T buf[kSumMaxK * kSumThreads];
  const int out_idx =
      (threadIdx.x * o.out_mult_x + threadIdx.y * o.out_mult_y + blockIdx.x * o.step_output) * V;
  const size_t plane = (size_t)o.gx * o.ctas * o.bw * V;
  T v[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < V; ++j) v[k][j] = T(0);
  // kFinishAhead staged sums loaded ahead of their adds, which keep the order
  for (int i = threadIdx.y; i < o.ctas; i += kFinishAhead * o.bh) {
    T next[kFinishAhead][K][V];
#pragma unroll
    for (int u = 0; u < kFinishAhead; ++u) {
      if (i + u * o.bh >= o.ctas) break;
      const size_t slot =
          threadIdx.x + ((size_t)(i + u * o.bh) + (size_t)blockIdx.x * o.ctas) * o.bw;
#pragma unroll
      for (int k = 0; k < K; ++k) load_vec<T, V>(staging + k * plane + slot * V, next[u][k]);
    }
#pragma unroll
    for (int u = 0; u < kFinishAhead; ++u) {
      if (i + u * o.bh >= o.ctas) break;
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int j = 0; j < V; ++j) v[k][j] = v[k][j] + next[u][k][j];
    }
  }
  block_y_sum<T, V, K>(v, buf, o.bw, o.bh);
  if (threadIdx.y != 0 || out_idx >= c) return;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    T s[K];
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] = v[k][j];
    op.finish(out_idx + j, s);
  }
}

// ---- the sums' terms and what each channel's sums give --------------------

// What every op shares: x [rows, C], the mask (null: every row counts) and
// the composition's float cnt = max(w.sum(), 1), [1].
template <typename T>
struct Common {
  const T* x;
  const unsigned char* mask;
  long long group_rows;
  int c;
  T* cnt;
  __device__ __forceinline__ bool counted(long long group) const {
    return mask == nullptr || mask[group] != 0;
  }
};

// sum(x w): the mean's numerator.
template <typename T>
struct MeanOp : Common<T> {
  static constexpr int K = 1;
  const unsigned long long* count;  // counted mask entries, or null: every row
  long long rows;
  T* mean;
  template <int V>
  struct Lane {
    int c0;
    __device__ __forceinline__ Lane(const MeanOp&, int c0_) : c0(c0_) {}
  };
  template <int V>
  struct Row {
    T x[V];
    bool on;
    __device__ __forceinline__ void load(const MeanOp& op, const Lane<V>& ln, long long r,
                                         long long group) {
      on = op.counted(group);
      if (on) load_vec<T, V>(op.x + r * op.c + ln.c0, x);
    }
    __device__ __forceinline__ void add(const Lane<V>&, T (&acc)[1][V]) const {
      if (!on) return;
#pragma unroll
      for (int j = 0; j < V; ++j) acc[0][j] = acc[0][j] + x[j] * T(1);
    }
  };
  __device__ __forceinline__ void finish(int ch, const T (&s)[1]) const {
    const long long n = count ? (long long)count[0] * this->group_rows : rows;
    const T cnt = n < 1 ? T(1) : (T)n;
    if (ch == 0) this->cnt[0] = cnt;
    mean[ch] = s[0] / cnt;
  }
};

// sum((x - mean)^2 w): the variance, invstd and the running buffers.
template <typename T>
struct VarOp : Common<T> {
  static constexpr int K = 1;
  const T* mean;
  T eps, keep, momentum;
  T *invstd, *running_mean, *running_var;
  template <int V>
  struct Lane {
    int c0;
    T m[V];
    __device__ __forceinline__ Lane(const VarOp& op, int c0_) : c0(c0_) {
#pragma unroll
      for (int j = 0; j < V; ++j) m[j] = op.mean[c0 + j];
    }
  };
  template <int V>
  struct Row {
    T x[V];
    bool on;
    __device__ __forceinline__ void load(const VarOp& op, const Lane<V>& ln, long long r,
                                         long long group) {
      on = op.counted(group);
      if (on) load_vec<T, V>(op.x + r * op.c + ln.c0, x);
    }
    __device__ __forceinline__ void add(const Lane<V>& ln, T (&acc)[1][V]) const {
      if (!on) return;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const T d = x[j] - ln.m[j];
        acc[0][j] = acc[0][j] + (d * d) * T(1);
      }
    }
  };
  __device__ __forceinline__ void finish(int ch, const T (&s)[1]) const {
    const T cnt = this->cnt[0];
    T var = s[0] / cnt;
    if (var < T(0)) var = T(0);
    invstd[ch] = t_rsqrt(var + eps);
    const T less = cnt - T(1) < T(1) ? T(1) : cnt - T(1);
    const T unbiased = var * cnt / less;
    running_mean[ch] = running_mean[ch] * keep + momentum * mean[ch];
    running_var[ch] = running_var[ch] * keep + momentum * unbiased;
  }
};

// What the backward's ops share: the gradient g, mean, invstd (or the
// running variance, from_var), weight, bias, the ReLU.
template <typename T>
struct GradCommon : Common<T> {
  const T *g, *mean, *scale, *weight, *bias;
  int from_var, relu;
  T eps;
};

// A thread's channel constants in the backward; k = invstd * weight.
template <typename T, int V>
struct GradLane {
  int c0, relu;
  T m[V], inv[V], k[V], b[V];
  __device__ __forceinline__ GradLane(const GradCommon<T>& op, int c0_)
      : c0(c0_), relu(op.relu) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      m[j] = op.mean[c0 + j];
      inv[j] = channel_invstd(op.scale, c0 + j, op.from_var, op.eps);
      k[j] = inv[j] * op.weight[c0 + j];
      b[j] = op.bias[c0 + j];
    }
  }
  // g where the ReLU passed it: torch's threshold_backward on relu(y)
  __device__ __forceinline__ T passed(T g, T d, int j) const {
    return (relu && d * k[j] + b[j] <= T(0)) ? T(0) : g;
  }
};

// sum(g'), sum(g' d), sum(g' k) over every row, d = x - mean: dbias,
// dweight and, with batch statistics, the variance path's dcs and the mean
// path's first term m1 = -sum(g' k), in autograd's order of operations.
template <typename T>
struct GradOp : GradCommon<T> {
  static constexpr int K = 3;
  T *dweight, *dbias, *dcs, *m1;  // dcs, m1 null: running statistics
  template <int V>
  using Lane = GradLane<T, V>;
  template <int V>
  struct Row {
    T g[V], x[V];
    __device__ __forceinline__ void load(const GradOp& op, const Lane<V>& ln, long long r,
                                         long long) {
      load_vec<T, V>(op.g + r * op.c + ln.c0, g);
      load_vec<T, V>(op.x + r * op.c + ln.c0, x);
    }
    __device__ __forceinline__ void add(const Lane<V>& ln, T (&acc)[3][V]) const {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const T d = x[j] - ln.m[j];
        const T gp = ln.passed(g[j], d, j);
        acc[0][j] = acc[0][j] + gp;
        acc[1][j] = acc[1][j] + gp * d;
        acc[2][j] = acc[2][j] + gp * ln.k[j];
      }
    }
  };
  __device__ __forceinline__ void finish(int ch, const T (&s)[3]) const {
    const T inv = channel_invstd(this->scale, ch, this->from_var, this->eps);
    dbias[ch] = s[0];
    dweight[ch] = s[1] * inv;
    if (dcs == nullptr) return;
    const T dinv = s[1] * this->weight[ch];
    const T dvar = (T(-0.5) * dinv) * ((inv * inv) * inv);
    dcs[ch] = dvar / this->cnt[0];
    m1[ch] = -s[2];
  }
};

// sum((dcs w) (2 d)) over the counted rows: the mean path's second term,
// then ds = (m1 + m2) / cnt.
template <typename T>
struct VarGradOp : Common<T> {
  static constexpr int K = 1;
  const T *mean, *dcs, *m1;
  T* ds;
  template <int V>
  struct Lane {
    int c0;
    T m[V], dc[V];
    __device__ __forceinline__ Lane(const VarGradOp& op, int c0_) : c0(c0_) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        m[j] = op.mean[c0 + j];
        dc[j] = op.dcs[c0 + j];
      }
    }
  };
  template <int V>
  struct Row {
    T x[V];
    bool on;
    __device__ __forceinline__ void load(const VarGradOp& op, const Lane<V>& ln, long long r,
                                         long long group) {
      on = op.counted(group);
      if (on) load_vec<T, V>(op.x + r * op.c + ln.c0, x);
    }
    __device__ __forceinline__ void add(const Lane<V>& ln, T (&acc)[1][V]) const {
      if (!on) return;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const T d = x[j] - ln.m[j];
        acc[0][j] = acc[0][j] + (ln.dc[j] * T(1)) * (T(2) * d);
      }
    }
  };
  __device__ __forceinline__ void finish(int ch, const T (&s)[1]) const {
    const T m2 = -s[0];
    ds[ch] = (m1[ch] + m2) / this->cnt[0];
  }
};

__global__ void __launch_bounds__(kCountThreads)
bn_count_kernel(const unsigned char* __restrict__ mask, long long groups,
                unsigned long long* __restrict__ count) {
  __shared__ unsigned long long part[kCountThreads];
  unsigned long long n = 0;
  for (long long i = (long long)blockIdx.x * kCountThreads + threadIdx.x; i < groups;
       i += (long long)gridDim.x * kCountThreads)
    n += mask[i] != 0;
  part[threadIdx.x] = n;
  __syncthreads();
  for (int s = kCountThreads / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) part[threadIdx.x] += part[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) atomicAdd(count, part[0]);  // integers: any order gives one sum
}

// ---- the elementwise kernels ------------------------------------------------

// Where a block's threads sit: lane (VEC channels from c0, in the block's
// slice of lanes * VEC channels, blockIdx.y) and row in the iteration
// (sub); the block's rows [r0, r1).
struct Place {
  int lane, sub, c0;
  long long r0, r1;
};

__device__ __forceinline__ Place place(long long rows, int lanes, int vec,
                                       long long rows_per_block) {
  Place p;
  p.lane = threadIdx.x % lanes;
  p.sub = threadIdx.x / lanes;
  p.c0 = ((int)blockIdx.y * lanes + p.lane) * vec;
  p.r0 = (long long)blockIdx.x * rows_per_block;
  p.r1 = p.r0 + rows_per_block < rows ? p.r0 + rows_per_block : rows;
  return p;
}

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
bn_normalize_kernel(const T* __restrict__ x, long long rows, int c, int lanes, int rpi,
                    long long rows_per_block, const T* __restrict__ mean,
                    const T* __restrict__ scale, int from_var, T eps,
                    const T* __restrict__ weight, const T* __restrict__ bias, int relu,
                    T* __restrict__ y) {
  const Place p = place(rows, lanes, V, rows_per_block);
  T m[V], a[V], b[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {  // the module's inv * self.weight, one T product
    m[j] = mean[p.c0 + j];
    a[j] = channel_invstd(scale, p.c0 + j, from_var, eps) * weight[p.c0 + j];
    b[j] = bias[p.c0 + j];
  }
  for (long long r = p.r0 + p.sub; r < p.r1; r += (long long)kUnroll * rpi) {
    T v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long rr = r + (long long)u * rpi;
      if (rr < p.r1) load_vec<T, V>(x + rr * c + p.c0, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long rr = r + (long long)u * rpi;
      if (rr >= p.r1) continue;
      T o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        o[j] = (v[u][j] - m[j]) * a[j] + b[j];  // torch's three ops, each rounded
        if (relu && o[j] == o[j]) o[j] = max(o[j], T(0));  // torch.relu: NaN passes
      }
      store_vec<T, V>(y + rr * c + p.c0, o);
    }
  }
}

// dx = (c1 + c2) + c3, autograd's sum of the three paths into x: c1 = g' k
// (the output), c2 = (dcs w) (2 d) (the variance), c3 = ds w (the mean);
// with running statistics (ds null) c1 alone.
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
bn_backward_dx_kernel(GradCommon<T> op, int lanes, int rpi, long long rows,
                      long long rows_per_block, const T* __restrict__ dcs,
                      const T* __restrict__ ds, T* __restrict__ dx) {
  const Place p = place(rows, lanes, V, rows_per_block);
  const GradLane<T, V> ln(op, p.c0);
  T dc[V], dsv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    dc[j] = ds ? dcs[p.c0 + j] : T(0);
    dsv[j] = ds ? ds[p.c0 + j] : T(0);
  }
  long long r = p.r0 + p.sub;
  Groups grp(r, rpi, op.group_rows);
  for (; r < p.r1; r += (long long)kUnroll * rpi) {
    T gv[kUnroll][V], xv[kUnroll][V];
    T w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long rr = r + (long long)u * rpi;
      w[u] = T(0);
      if (rr < p.r1) {
        w[u] = op.counted(grp.group) ? T(1) : T(0);
        load_vec<T, V>(op.g + rr * op.c + p.c0, gv[u]);
        load_vec<T, V>(op.x + rr * op.c + p.c0, xv[u]);
      }
      grp.advance();
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long rr = r + (long long)u * rpi;
      if (rr >= p.r1) continue;
      T o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const T d = xv[u][j] - ln.m[j];
        const T c1 = ln.passed(gv[u][j], d, j) * ln.k[j];
        if (ds) {
          const T c2 = (dc[j] * w[u]) * (T(2) * d);
          const T c3 = dsv[j] * w[u];
          o[j] = (c1 + c2) + c3;
        } else {
          o[j] = c1;
        }
      }
      store_vec<T, V>(dx + rr * op.c + p.c0, o);
    }
  }
}

// ---- launch shapes and entries ---------------------------------------------

// The elementwise kernels' launch shape over x [rows, c] with accesses of
// vec values; geometry takes the widest that c and every row-major
// pointer's alignment (the OR of their addresses) allow.  A row of more than
// kMaxThreads accesses is cut into the fewest equal slices of at most that
// many, one a grid row (blockIdx.y): every element takes the same
// operations whatever its slice.  False for a shape the kernels do not take.
struct Geometry {
  int vec, lanes, slices, rpi, threads, blocks;
  long long rows_per_block;
};

bool shape(long long rows, int c, int vec, Geometry* geo) {
  if (c < 1 || rows < 0 || c % vec != 0) return false;
  const int all = c / vec;
  int slices = (all + kMaxThreads - 1) / kMaxThreads;
  while (all % slices != 0) ++slices;
  geo->vec = vec;
  geo->slices = slices;
  geo->lanes = all / slices;
  geo->rpi = geo->lanes >= kRowThreads ? 1 : kRowThreads / geo->lanes;
  geo->threads = geo->lanes * geo->rpi;
  long long per = (rows + kMaxBlocks - 1) / kMaxBlocks;
  long long least = (long long)geo->rpi * kMinIters;
  if (least < kMinRows) least = kMinRows;
  if (per < least) per = least;
  per = (per + geo->rpi - 1) / geo->rpi * geo->rpi;
  geo->rows_per_block = per;
  geo->blocks = rows == 0 ? 1 : (int)((rows + per - 1) / per);
  return true;
}

bool geometry(long long rows, int c, int is_double, uintptr_t addresses, Geometry* geo) {
  const int item = is_double ? 8 : 4;
  int vec = 1;
  for (int v = is_double ? 2 : 4; v > 1; v /= 2) {
    if (c % v == 0 && addresses % (uintptr_t)(v * item) == 0) {
      vec = v;
      break;
    }
  }
  return shape(rows, c, vec, geo);
}

// Calls body.template run<T, V>() for the type and the width V.
template <typename Body>
int dispatch(int is_double, int vec, const Body& body) {
  if (is_double) {
    if (vec == 4) return body.template run<double, 4>();
    if (vec == 2) return body.template run<double, 2>();
    return body.template run<double, 1>();
  }
  if (vec == 4) return body.template run<float, 4>();
  if (vec == 2) return body.template run<float, 2>();
  return body.template run<float, 1>();
}

// Where the scratch's parts lie: the staging (kSumMaxK planes), then the
// mask's count and the backward's per-channel dcs, m1, ds.
struct Scratch {
  size_t staging, count, dcs, m1, ds, bytes;
};

Scratch scratch_layout(const SumOrder& o, int c, int item) {
  auto up = [](size_t n) { return (n + 15) / 16 * 16; };
  Scratch s;
  s.staging = 0;
  const size_t plane = o.ctas > 1 ? (size_t)o.gx * o.ctas * o.bw * o.vec : 0;
  s.count = up(kSumMaxK * plane * item);
  s.dcs = s.count + 16;
  s.m1 = s.dcs + up((size_t)c * item);
  s.ds = s.m1 + up((size_t)c * item);
  s.bytes = s.ds + up((size_t)c * item);
  return s;
}

// One sum in torch's order with Op's finish: one launch, or two where the
// sum spans blocks.
template <typename T, int V, typename Op>
int launch_sum(const Op& op, const SumOrder& o, long long rows, int c, T* staging,
               cudaStream_t stream) {
  const dim3 block(o.bw, o.bh), grid(o.gx, o.ctas);
  bn_sum_kernel<T, V, Op><<<grid, block, 0, stream>>>(op, o, rows, c, staging);
  const int err = (int)cudaGetLastError();
  if (err != 0 || o.ctas == 1) return err;
  bn_sum_finish_kernel<T, V, Op><<<dim3(o.gx), block, 0, stream>>>(op, o, c, staging);
  return (int)cudaGetLastError();
}

template <typename T>
void set_common(Common<T>* op, const void* x, const unsigned char* mask, long long group_rows,
                int c, void* cnt) {
  op->x = static_cast<const T*>(x);
  op->mask = mask;
  op->group_rows = group_rows;
  op->c = c;
  op->cnt = static_cast<T*>(cnt);
}

struct StatsLaunch {
  const void* x;
  const unsigned char* mask;
  long long rows, groups, group_rows;
  int c;
  double momentum, eps;
  void *running_mean, *running_var, *mean, *invstd, *cnt;
  char* scratch;
  SumOrder order;
  cudaStream_t stream;
  template <typename T, int V>
  int run() const {
    const Scratch s = scratch_layout(order, c, sizeof(T));
    T* staging = reinterpret_cast<T*>(scratch + s.staging);
    unsigned long long* count = nullptr;
    if (mask != nullptr) {
      count = reinterpret_cast<unsigned long long*>(scratch + s.count);
      int err = (int)cudaMemsetAsync(count, 0, sizeof(*count), stream);
      if (err != 0) return err;
      long long blocks = div_up(groups, kCountThreads);
      if (blocks > kCountBlocks) blocks = kCountBlocks;
      if (blocks < 1) blocks = 1;
      bn_count_kernel<<<(int)blocks, kCountThreads, 0, stream>>>(mask, groups, count);
      err = (int)cudaGetLastError();
      if (err != 0) return err;
    }
    MeanOp<T> mop;
    set_common<T>(&mop, x, mask, group_rows, c, cnt);
    mop.count = count;
    mop.rows = rows;
    mop.mean = static_cast<T*>(mean);
    const int err = launch_sum<T, V>(mop, order, rows, c, staging, stream);
    if (err != 0) return err;
    VarOp<T> vop;
    set_common<T>(&vop, x, mask, group_rows, c, cnt);
    vop.mean = static_cast<const T*>(mean);
    vop.eps = (T)eps;
    vop.keep = (T)(1.0 - momentum);
    vop.momentum = (T)momentum;
    vop.invstd = static_cast<T*>(invstd);
    vop.running_mean = static_cast<T*>(running_mean);
    vop.running_var = static_cast<T*>(running_var);
    return launch_sum<T, V>(vop, order, rows, c, staging, stream);
  }
};

struct NormalizeLaunch {
  const void* x;
  long long rows;
  int c;
  const void *mean, *scale;
  int from_var;
  double eps;
  const void *weight, *bias;
  int relu;
  void* y;
  cudaStream_t stream;
  Geometry geo;
  template <typename T, int V>
  int run() const {
    if constexpr (sizeof(T) * V > 16) {
      return (int)cudaErrorInvalidValue;
    } else {
      bn_normalize_kernel<T, V><<<dim3(geo.blocks, geo.slices), geo.threads, 0, stream>>>(
          static_cast<const T*>(x), rows, c, geo.lanes, geo.rpi, geo.rows_per_block,
          static_cast<const T*>(mean), static_cast<const T*>(scale), from_var, (T)eps,
          static_cast<const T*>(weight), static_cast<const T*>(bias), relu, static_cast<T*>(y));
      return (int)cudaGetLastError();
    }
  }
};

struct BackwardLaunch {
  const void *grad, *x;
  const unsigned char* mask;
  long long rows, group_rows;
  int c;
  const void *mean, *scale;
  int from_var;
  double eps;
  const void *weight, *bias;
  void* cnt;  // null: running statistics
  int relu;
  void *dx, *dweight, *dbias;
  char* scratch;
  SumOrder order;
  cudaStream_t stream;
  Geometry geo;
  template <typename T>
  void set_grad(GradCommon<T>* op) const {
    set_common<T>(op, x, mask, group_rows, c, cnt);
    op->g = static_cast<const T*>(grad);
    op->mean = static_cast<const T*>(mean);
    op->scale = static_cast<const T*>(scale);
    op->weight = static_cast<const T*>(weight);
    op->bias = static_cast<const T*>(bias);
    op->from_var = from_var;
    op->relu = relu;
    op->eps = (T)eps;
  }
  template <typename T, int W>
  int dx_launch(const GradCommon<T>& op, const T* dcs, const T* ds) const {
    bn_backward_dx_kernel<T, W><<<dim3(geo.blocks, geo.slices), geo.threads, 0, stream>>>(
        op, geo.lanes, geo.rpi, rows, geo.rows_per_block, dcs, ds, static_cast<T*>(dx));
    return (int)cudaGetLastError();
  }
  template <typename T, int V>
  int run() const {  // V: the sums' width (torch's); the dx kernel takes geo.vec
    const Scratch s = scratch_layout(order, c, sizeof(T));
    T* staging = reinterpret_cast<T*>(scratch + s.staging);
    T* dcs = cnt ? reinterpret_cast<T*>(scratch + s.dcs) : nullptr;
    T* m1 = cnt ? reinterpret_cast<T*>(scratch + s.m1) : nullptr;
    T* ds = cnt ? reinterpret_cast<T*>(scratch + s.ds) : nullptr;
    GradOp<T> gop;
    set_grad<T>(&gop);
    gop.dweight = static_cast<T*>(dweight);
    gop.dbias = static_cast<T*>(dbias);
    gop.dcs = dcs;
    gop.m1 = m1;
    int err = launch_sum<T, V>(gop, order, rows, c, staging, stream);
    if (err != 0) return err;
    if (cnt != nullptr) {
      VarGradOp<T> vop;
      set_common<T>(&vop, x, mask, group_rows, c, cnt);
      vop.mean = static_cast<const T*>(mean);
      vop.dcs = dcs;
      vop.m1 = m1;
      vop.ds = ds;
      err = launch_sum<T, V>(vop, order, rows, c, staging, stream);
      if (err != 0) return err;
    }
    GradCommon<T> op;
    set_grad<T>(&op);
    if constexpr (sizeof(T) == 4) {
      if (geo.vec == 4) return dx_launch<T, 4>(op, dcs, ds);
    }
    if (geo.vec == 2) return dx_launch<T, 2>(op, dcs, ds);
    return dx_launch<T, 1>(op, dcs, ds);
  }
};

}  // namespace

// The scratch that the entries below need over x [rows, c] of float32
// (is_double 0) or float64 (1) on a card of num_mp SMs and max_threads_mp
// threads a multiprocessor, in bytes; -1 for a shape they do not take.
extern "C" long long repsurf_bn_scratch_bytes(long long rows, int c, int is_double, int num_mp,
                                              int max_threads_mp) {
  if (rows < 1 || c < 1) return -1;
  const SumOrder o = sum_order(rows, c, num_mp, max_threads_mp);
  return (long long)scratch_layout(o, c, is_double ? 8 : 4).bytes;
}

// Training statistics of x [rows, c] (float32, is_double 0, or float64, 1;
// contiguous, 16-byte aligned): mask null (every row counts) or `groups`
// bytes, row r counting where mask[r / group_rows] != 0.  Writes mean and
// invstd [c] and cnt [1] (x's type, max(counted rows, 1)), updates
// running_mean / running_var [c] in place.  Two to six launches (and a
// memset) on `stream`.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int repsurf_bn_stats(const void* x, const unsigned char* mask, long long rows, int c,
                                long long groups, long long group_rows, int is_double,
                                double momentum, double eps, void* running_mean,
                                void* running_var, void* mean, void* invstd, void* cnt,
                                void* scratch, int num_mp, int max_threads_mp,
                                cudaStream_t stream) {
  if (rows < 1 || c < 1 || group_rows < 1 || (uintptr_t)x % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const SumOrder order = sum_order(rows, c, num_mp, max_threads_mp);
  const StatsLaunch launch{x, mask, rows, groups, group_rows, c, momentum, eps, running_mean,
                           running_var, mean, invstd, cnt, static_cast<char*>(scratch), order,
                           stream};
  return dispatch(is_double, order.vec, launch);
}

// y = (x - mean) * (invstd * weight) + bias over x [rows, c], ReLU'd when
// relu; invstd = scale, or rsqrt(scale + eps) when from_var (the running
// variance).  One launch.
extern "C" int repsurf_bn_normalize(const void* x, long long rows, int c, int is_double,
                                    const void* mean, const void* scale, int from_var, double eps,
                                    const void* weight, const void* bias, int relu, void* y,
                                    cudaStream_t stream) {
  Geometry geo;
  if (!geometry(rows, c, is_double, (uintptr_t)x | (uintptr_t)y, &geo))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const NormalizeLaunch launch{x, rows, c, mean, scale, from_var, eps, weight, bias, relu, y,
                               stream, geo};
  return dispatch(is_double, geo.vec, launch);
}

// The backward of repsurf_bn_normalize (and, with cnt given, of the
// statistics of repsurf_bn_stats) for the gradient grad of y: dx [rows, c],
// dweight and dbias [c].  cnt null: the statistics were the running ones.
// Two to five launches.
extern "C" int repsurf_bn_backward(const void* grad, const void* x, const unsigned char* mask,
                                   long long rows, int c, long long group_rows, int is_double,
                                   const void* mean, const void* scale, int from_var, double eps,
                                   const void* weight, const void* bias, void* cnt, int relu,
                                   void* dx, void* dweight, void* dbias, void* scratch,
                                   int num_mp, int max_threads_mp, cudaStream_t stream) {
  Geometry geo;
  const uintptr_t addresses = (uintptr_t)grad | (uintptr_t)x | (uintptr_t)dx;
  if (rows < 1 || group_rows < 1 || addresses % 16 != 0 ||
      !geometry(rows, c, is_double, addresses, &geo))
    return (int)cudaErrorInvalidValue;
  const SumOrder order = sum_order(rows, c, num_mp, max_threads_mp);
  const BackwardLaunch launch{grad, x, mask, rows, group_rows, c, mean, scale, from_var, eps,
                              weight, bias, cnt, relu, dx, dweight, dbias,
                              static_cast<char*>(scratch), order, stream, geo};
  return dispatch(is_double, order.vec, launch);
}
