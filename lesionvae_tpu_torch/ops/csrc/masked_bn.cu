// The fleet's masked BatchNorm followed by ReLU, forward and backward, by hand
// for Hopper (sm_90a): one BatchNorm layer of all T members of the stacked
// model at once, channel-last.
//
// x: (T, N, L, C) contiguous, float32 or bfloat16; its R = N*L rows a member
// are the member's N samples times L positions.  mask: (T, N) float32 of 0/1
// or none (every row counts).  weight, bias: (T, C) float32 rows (a member
// stride apart); running mean and variance: (T, C) float32, contiguous.
// Statistics are float32.  For member t and channel c (every operation
// rounds once, in this order, as the plain PyTorch version's kernels do):
//
//   cnt  = max(sum_n mask[t,n] * L, 1)
//   mean = (sum_r m_r x_r) / cnt;   var = (sum_r ((x_r - mean)^2) m_r) / cnt
//   running_mean' = 0.9 rm + 0.1 mean;  running_var' = 0.9 rv + 0.1 (var*cnt / max(cnt-1, 1))
//   sd   = sqrt(var + eps)      (eval: mean, var = the running statistics)
//   float32:  y = relu(((x - mean) / sd) * w + b)
//   bfloat16: a = w / sd, b' = b - mean*a, y = relu(bf16(bf16(x * bf16(a)) + bf16(b')))
//   relu(y) = y < 0 ? 0 : y     (NaN stays NaN, as F.relu keeps it)
//
// Backward, from x and dy alone (nothing of the forward's chain is kept):
// y is recomputed bit for bit, g = y <= 0 ? 0 : dy (PyTorch's
// threshold_backward on the output), xh = (x - mean) / sd, and
//
//   S1 = sum_r g_r,  S2 = sum_r g_r xh_r        over ALL rows, pad rows too
//   dbias = S1,  dweight = S2
//   dx = (w / sd) * (g - (m/cnt) * (S1 + xh * S2))     (eval: (w / sd) * g)
//
// A pad row (m = 0) enters neither mean nor var but is normalised with them,
// so its output and gradient enter S1 and S2: masking those sums would get
// the pad rows' share wrong.
//
// No Pallas original: this replaces what XLA fuses of MaskedBatchNorm
// (lesionvae_tpu/models/layers.py:41) and the nn.relu after it in the
// vmapped fleet step (lesionvae_tpu/train/batched.py:241).  PyTorch runs the
// same math as some 20 elementwise and reduction kernels forward and 30
// backward, each a full pass over the activations.
//
// What bounds it: device memory.  The least traffic is x read and y written
// forward, x and dy read and dx written backward; a few FP32 operations an
// element against 67 TFLOP/s are far below that.  This design re-reads x for
// the two-pass variance and the backward re-reads x and dy for dx: four
// passes forward (training) and five backward where the bound has two and
// three, the price of a deterministic order without atomics.
//
// Order of every sum (the plain version repeats it; so do two calls): rows
// split into chunks of CHUNK = LANES*J consecutive rows; lane s of a chunk
// adds rows s, s+LANES, ... of it one after another from 0; the LANES lanes
// are added in a tree (s += s+16, +8, +4, +2, +1); the chunk partials,
// written to a (T, K, C) buffer, are added in chunk order by every block
// that needs the total, so no block waits for another and no float atomic
// is used.
//
// The design for the card: a block is (chunk, tile of CT channels, member),
// 256 threads; a thread takes one channel and four lanes of the chunk (q,
// q+8, q+16, q+24: 32 elements), keeps the four lane sums side by side and
// takes the tree's first two levels itself, the other three across threads
// in shared memory.  A warp reads 32 neighbouring channels of a row.  Each
// row step loads all its values before any is used: the IEEE quotient's
// slow path is a call, and loads are not moved across it.  The rows' masks
// come to shared memory once a block (one integer division a row), and m/cnt
// is 1/cnt, computed once, for a row whose mask is 1.  Four kernels, five
// launches a layer in training:
//
//   stats_kernel phase 0: chunk partials of sum m x
//   stats_kernel phase 1: mean (chunk-0 blocks write it), partials of sum (x-mean)^2 m
//   apply_kernel:         var and the running statistics (chunk-0 blocks), y
//   grad_sums_kernel:     chunk partials of S1, S2
//   grad_apply_kernel:    S1, S2 -> dbias, dweight (chunk-0 blocks), dx
//
// C interface (loaded with ctypes): each function returns
// cudaGetLastError() after its launch.  Pointers of a (T, C) parameter come
// with the member stride of its rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CT = 32;             // channels a block: threadIdx.x
constexpr int LANES = 32;          // row lanes of a chunk
constexpr int GROUPS = 8;          // threads a channel: threadIdx.y
constexpr int SLOTS = LANES / GROUPS;  // lanes a thread: q, q+8, q+16, q+24
constexpr int J = 8;               // rows a lane takes of its chunk
constexpr int CHUNK = LANES * J;   // rows a chunk
constexpr int THREADS = CT * GROUPS;

struct Geometry {
  int N, L, C, K, R;               // rows R = N*L a member (< 2^31), K chunks of them
  long long w_stride, b_stride;    // member strides of weight and bias
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// max(sum_n mask[t, n] * L, 1) to every thread of the block: warp 0 sums
// the 0/1 mask (exact in any order), the product and the clamp as the plain
// version takes them.  No mask: N * L.
__device__ float member_count(const float* __restrict__ mask, int t, const Geometry& g) {
  __shared__ float s_cnt;
  if (threadIdx.y == 0) {
    float s = 0.f;
    if (mask != nullptr) {
      const float* m = mask + static_cast<long long>(t) * g.N;
      for (int n = threadIdx.x; n < g.N; n += 32) s = __fadd_rn(s, m[n]);
      for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    } else {
      s = static_cast<float>(g.N);
    }
    if (threadIdx.x == 0) s_cnt = fmaxf(__fmul_rn(s, static_cast<float>(g.L)), 1.f);
  }
  __syncthreads();
  return s_cnt;
}

// row j of lane (threadIdx.y + i * GROUPS) of the block's chunk
__device__ __forceinline__ int row_of(int j, int i) {
  return blockIdx.x * CHUNK + j * LANES + threadIdx.y + i * GROUPS;
}

// the mask of every row of the block's chunk into shared memory, one row a
// thread (1 without a mask and past the last row); slot(j, i) finds a row's
static_assert(THREADS == CHUNK, "one thread a row of the chunk");
__device__ __forceinline__ void chunk_masks(const float* __restrict__ mask, int t,
                                            const Geometry& g, float* s_mask) {
  const int k = threadIdx.y * CT + threadIdx.x;
  const int r = blockIdx.x * CHUNK + k;
  s_mask[k] = (mask == nullptr || r >= g.R) ? 1.f
                                            : mask[static_cast<long long>(t) * g.N + r / g.L];
  __syncthreads();
}

__device__ __forceinline__ int slot(int j, int i) { return j * LANES + threadIdx.y + i * GROUPS; }

// sum over k of part[t, k, c] in chunk order, to every thread of the block
// whose channel is c: the block loads GROUPS chunk partials at a time into
// shared memory, warp 0 adds them in order
__device__ float chunk_total(const float* __restrict__ part, int t, int c, const Geometry& g,
                             float (*sh)[CT]) {
  const float* p = part + static_cast<long long>(t) * g.K * g.C + c;
  float s = 0.f;
  for (int k0 = 0; k0 < g.K; k0 += GROUPS) {
    const int k = k0 + threadIdx.y;
    sh[threadIdx.y][threadIdx.x] = (k < g.K && c < g.C) ? p[static_cast<long long>(k) * g.C] : 0.f;
    __syncthreads();
    if (threadIdx.y == 0) {
      const int n = min(GROUPS, g.K - k0);
      for (int i = 0; i < n; ++i)
        s = k0 + i == 0 ? sh[0][threadIdx.x] : __fadd_rn(s, sh[i][threadIdx.x]);
    }
    __syncthreads();
  }
  if (threadIdx.y == 0) sh[0][threadIdx.x] = s;
  __syncthreads();
  s = sh[0][threadIdx.x];
  __syncthreads();
  return s;
}

// the thread's four lane sums through the lane tree: the levels that pair
// lanes 16 and 8 apart inside the thread, the rest across threads; the
// block's chunk partial lands in part[t, k, c]
__device__ __forceinline__ void lane_tree(float (&acc)[SLOTS], float (*sh)[CT],
                                          float* __restrict__ part, int t, int c,
                                          const Geometry& g) {
  acc[0] = __fadd_rn(acc[0], acc[2]);
  acc[1] = __fadd_rn(acc[1], acc[3]);
  sh[threadIdx.y][threadIdx.x] = __fadd_rn(acc[0], acc[1]);
  __syncthreads();
  for (int w = GROUPS / 2; w > 0; w >>= 1) {
    if (threadIdx.y < w)
      sh[threadIdx.y][threadIdx.x] =
          __fadd_rn(sh[threadIdx.y][threadIdx.x], sh[threadIdx.y + w][threadIdx.x]);
    __syncthreads();
  }
  if (threadIdx.y == 0 && c < g.C)
    part[(static_cast<long long>(t) * g.K + blockIdx.x) * g.C + c] = sh[0][threadIdx.x];
  __syncthreads();
}

// the normalised value xh and the forward's output of one element
template <typename X>
struct Norm {
  float mean, sd, w, b, a16, b16;

  __device__ __forceinline__ void init(float mean_, float var, float w_, float b_, float eps) {
    mean = mean_;
    w = w_;
    b = b_;
    sd = __fsqrt_rn(__fadd_rn(var, eps));
    const float a = __fdiv_rn(w, sd);
    a16 = round_bf16(a);
    b16 = round_bf16(__fsub_rn(b, __fmul_rn(mean, a)));
  }
  __device__ __forceinline__ float xh(float v) const { return __fdiv_rn(__fsub_rn(v, mean), sd); }
  __device__ __forceinline__ float y(float v, float z) const;
};

template <>
__device__ __forceinline__ float Norm<float>::y(float, float z) const {
  return relu(__fadd_rn(__fmul_rn(z, w), b));
}

template <>
__device__ __forceinline__ float Norm<__nv_bfloat16>::y(float v, float) const {
  return relu(round_bf16(__fadd_rn(round_bf16(__fmul_rn(v, a16)), b16)));
}

// ---------------------------------------------------------------- kernels
// A thread takes one channel and four lanes of its block's chunk, 32
// elements; its four lane sums run side by side.
//
// phase 0: chunk partials of sum m x into part_out.  phase 1: mean from
// part_in's chunk partials (chunk-0 blocks write it), then chunk partials of
// sum (x - mean)^2 m into part_out.
template <typename X>
__global__ void __launch_bounds__(THREADS)
stats_kernel(const X* __restrict__ x, const float* __restrict__ mask,
             const float* __restrict__ part_in, float* __restrict__ part_out,
             float* __restrict__ mean_out, Geometry g, int phase) {
  __shared__ float sh[GROUPS][CT];
  __shared__ float s_mask[CHUNK];
  const int t = blockIdx.z;
  const int c = blockIdx.y * CT + threadIdx.x;
  chunk_masks(mask, t, g, s_mask);
  float mean = 0.f;
  if (phase == 1) {
    const float cnt = member_count(mask, t, g);
    mean = __fdiv_rn(chunk_total(part_in, t, c, g, sh), cnt);
    if (blockIdx.x == 0 && threadIdx.y == 0 && c < g.C)
      mean_out[static_cast<long long>(t) * g.C + c] = mean;
  }
  const X* xt = x + static_cast<long long>(t) * g.R * g.C + c;
  float acc[SLOTS] = {0.f, 0.f, 0.f, 0.f};
  if (c < g.C) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float v[SLOTS];
#pragma unroll
      for (int i = 0; i < SLOTS; ++i) {
        const int r = row_of(j, i);
        v[i] = r < g.R ? widen(xt[static_cast<long long>(r) * g.C]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < SLOTS; ++i) {
        if (row_of(j, i) < g.R) {
          const float m = s_mask[slot(j, i)];
          if (phase == 0) {
            acc[i] = __fadd_rn(acc[i], __fmul_rn(v[i], m));
          } else {
            const float d = __fsub_rn(v[i], mean);
            acc[i] = __fadd_rn(acc[i], __fmul_rn(__fmul_rn(d, d), m));
          }
        }
      }
    }
  }
  lane_tree(acc, sh, part_out, t, c, g);
}

// y = relu(bn(x)).  Training: var from part2's chunk partials, mean as the
// stats kernel wrote it; chunk-0 blocks write var and the new running
// statistics.  Eval: mean and var are the running statistics.
template <typename X>
__global__ void __launch_bounds__(THREADS)
apply_kernel(const X* __restrict__ x, X* __restrict__ y, const float* __restrict__ mask,
             const float* __restrict__ part2, const float* __restrict__ mean_in,
             float* __restrict__ var_out, const float* __restrict__ w,
             const float* __restrict__ b, const float* __restrict__ rm,
             const float* __restrict__ rv, float* __restrict__ new_rm,
             float* __restrict__ new_rv, Geometry g, int training, float eps,
             float momentum, float keep) {
  __shared__ float sh[GROUPS][CT];
  const int t = blockIdx.z;
  const int c = blockIdx.y * CT + threadIdx.x;
  const long long tc = static_cast<long long>(t) * g.C + c;
  float mean = 0.f, var = 0.f;
  if (training) {
    const float cnt = member_count(mask, t, g);
    var = __fdiv_rn(chunk_total(part2, t, c, g, sh), cnt);
    if (c < g.C) {
      mean = mean_in[tc];
      if (blockIdx.x == 0 && threadIdx.y == 0) {
        var_out[tc] = var;
        const float unbiased =
            __fdiv_rn(__fmul_rn(var, cnt), fmaxf(__fsub_rn(cnt, 1.f), 1.f));
        new_rm[tc] = __fadd_rn(__fmul_rn(keep, rm[tc]), __fmul_rn(momentum, mean));
        new_rv[tc] = __fadd_rn(__fmul_rn(keep, rv[tc]), __fmul_rn(momentum, unbiased));
      }
    }
  } else if (c < g.C) {
    mean = rm[tc];
    var = rv[tc];
  }
  if (c >= g.C) return;
  Norm<X> nm;
  nm.init(mean, var, w[t * g.w_stride + c], b[t * g.b_stride + c], eps);
  const long long base = static_cast<long long>(t) * g.R * g.C + c;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    float v[SLOTS];
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      const int r = row_of(j, i);
      v[i] = r < g.R ? widen(x[base + static_cast<long long>(r) * g.C]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      const int r = row_of(j, i);
      if (r < g.R) narrow(y + base + static_cast<long long>(r) * g.C, nm.y(v[i], nm.xh(v[i])));
    }
  }
}

// chunk partials of S1 = sum g and S2 = sum g xh over every row
template <typename X>
__global__ void __launch_bounds__(THREADS)
grad_sums_kernel(const X* __restrict__ x, const X* __restrict__ dy,
                 const float* __restrict__ mean, const float* __restrict__ var,
                 const float* __restrict__ w, const float* __restrict__ b,
                 float* __restrict__ part3, float* __restrict__ part4, Geometry g,
                 float eps) {
  __shared__ float sh[GROUPS][CT];
  const int t = blockIdx.z;
  const int c = blockIdx.y * CT + threadIdx.x;
  float acc1[SLOTS] = {0.f, 0.f, 0.f, 0.f}, acc2[SLOTS] = {0.f, 0.f, 0.f, 0.f};
  if (c < g.C) {
    const long long tc = static_cast<long long>(t) * g.C + c;
    Norm<X> nm;
    nm.init(mean[tc], var[tc], w[t * g.w_stride + c], b[t * g.b_stride + c], eps);
    const long long base = static_cast<long long>(t) * g.R * g.C + c;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float v[SLOTS], d[SLOTS];
#pragma unroll
      for (int i = 0; i < SLOTS; ++i) {
        const int r = row_of(j, i);
        const long long e = base + static_cast<long long>(r) * g.C;
        v[i] = r < g.R ? widen(x[e]) : 0.f;
        d[i] = r < g.R ? widen(dy[e]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < SLOTS; ++i) {
        if (row_of(j, i) < g.R) {
          const float z = nm.xh(v[i]);
          const float gr = nm.y(v[i], z) <= 0.f ? 0.f : d[i];
          acc1[i] = __fadd_rn(acc1[i], gr);
          acc2[i] = __fadd_rn(acc2[i], __fmul_rn(gr, z));
        }
      }
    }
  }
  lane_tree(acc1, sh, part3, t, c, g);
  lane_tree(acc2, sh, part4, t, c, g);
}

// S1, S2 from their chunk partials (chunk-0 blocks write dbias and
// dweight), then dx.  m/cnt is 1/cnt, computed once, for a row whose mask
// is 1, the quotient for any other
template <typename X>
__global__ void __launch_bounds__(THREADS)
grad_apply_kernel(const X* __restrict__ x, const X* __restrict__ dy, X* __restrict__ dx,
                  const float* __restrict__ mask, const float* __restrict__ mean,
                  const float* __restrict__ var, const float* __restrict__ w,
                  const float* __restrict__ b, const float* __restrict__ part3,
                  const float* __restrict__ part4, float* __restrict__ dw,
                  float* __restrict__ db, Geometry g, int training, float eps) {
  __shared__ float sh[GROUPS][CT];
  __shared__ float s_mask[CHUNK];
  const int t = blockIdx.z;
  const int c = blockIdx.y * CT + threadIdx.x;
  const long long tc = static_cast<long long>(t) * g.C + c;
  if (training) chunk_masks(mask, t, g, s_mask);
  const float S1 = chunk_total(part3, t, c, g, sh);
  const float S2 = chunk_total(part4, t, c, g, sh);
  const float cnt = training ? member_count(mask, t, g) : 1.f;
  if (c >= g.C) return;
  if (blockIdx.x == 0 && threadIdx.y == 0) {
    db[tc] = S1;
    dw[tc] = S2;
  }
  Norm<X> nm;
  nm.init(mean[tc], var[tc], w[t * g.w_stride + c], b[t * g.b_stride + c], eps);
  const float coef = __fdiv_rn(nm.w, nm.sd);
  const float rcnt = __fdiv_rn(1.f, cnt);
  const long long base = static_cast<long long>(t) * g.R * g.C + c;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    float v[SLOTS], d[SLOTS], m[SLOTS];
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      const int r = row_of(j, i);
      const long long e = base + static_cast<long long>(r) * g.C;
      v[i] = r < g.R ? widen(x[e]) : 0.f;
      d[i] = r < g.R ? widen(dy[e]) : 0.f;
      m[i] = training ? s_mask[slot(j, i)] : 1.f;
    }
#pragma unroll
    for (int i = 0; i < SLOTS; ++i) {
      const int r = row_of(j, i);
      if (r < g.R) {
        const long long e = base + static_cast<long long>(r) * g.C;
        const float z = nm.xh(v[i]);
        const float gr = nm.y(v[i], z) <= 0.f ? 0.f : d[i];
        float out;
        if (training) {
          const float mc = m[i] == 1.f ? rcnt : __fdiv_rn(m[i], cnt);
          out = __fmul_rn(coef, __fsub_rn(gr, __fmul_rn(mc, __fadd_rn(S1, __fmul_rn(z, S2)))));
        } else {
          out = __fmul_rn(coef, gr);
        }
        narrow(dx + e, out);
      }
    }
  }
}

Geometry geometry(int N, int L, int C, long long w_stride, long long b_stride) {
  Geometry g;
  g.N = N;
  g.L = L;
  g.C = C;
  g.R = N * L;
  g.K = (g.R + CHUNK - 1) / CHUNK;
  g.w_stride = w_stride;
  g.b_stride = b_stride;
  return g;
}

dim3 grid(const Geometry& g, int T) { return dim3(g.K, (g.C + CT - 1) / CT, T); }

}  // namespace

extern "C" {

int lesionvae_masked_bn_stats(const void* x, int bf16, const float* mask,
                              const float* part_in, float* part_out, float* mean, int T,
                              int N, int L, int C, int phase, void* stream) {
  const Geometry g = geometry(N, L, C, 0, 0);
  const dim3 block(CT, GROUPS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    stats_kernel<__nv_bfloat16><<<grid(g, T), block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), mask, part_in, part_out, mean, g, phase);
  else
    stats_kernel<float><<<grid(g, T), block, 0, s>>>(static_cast<const float*>(x), mask,
                                                     part_in, part_out, mean, g, phase);
  return static_cast<int>(cudaGetLastError());
}

int lesionvae_masked_bn_apply(const void* x, int bf16, void* y, const float* mask,
                              const float* part2, const float* mean, float* var,
                              const float* w, long long w_stride, const float* b,
                              long long b_stride, const float* rm, const float* rv,
                              float* new_rm, float* new_rv, int T, int N, int L, int C,
                              int training, float eps, float momentum, float keep,
                              void* stream) {
  const Geometry g = geometry(N, L, C, w_stride, b_stride);
  const dim3 block(CT, GROUPS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    apply_kernel<__nv_bfloat16><<<grid(g, T), block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), mask, part2,
        mean, var, w, b, rm, rv, new_rm, new_rv, g, training, eps, momentum, keep);
  else
    apply_kernel<float><<<grid(g, T), block, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), mask, part2, mean, var, w, b,
        rm, rv, new_rm, new_rv, g, training, eps, momentum, keep);
  return static_cast<int>(cudaGetLastError());
}

int lesionvae_masked_bn_grad_sums(const void* x, int bf16, const void* dy,
                                  const float* mean, const float* var, const float* w,
                                  long long w_stride, const float* b, long long b_stride,
                                  float* part3, float* part4, int T, int N, int L, int C,
                                  float eps, void* stream) {
  const Geometry g = geometry(N, L, C, w_stride, b_stride);
  const dim3 block(CT, GROUPS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    grad_sums_kernel<__nv_bfloat16><<<grid(g, T), block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy), mean,
        var, w, b, part3, part4, g, eps);
  else
    grad_sums_kernel<float><<<grid(g, T), block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), mean, var, w, b, part3,
        part4, g, eps);
  return static_cast<int>(cudaGetLastError());
}

int lesionvae_masked_bn_grad_apply(const void* x, int bf16, const void* dy, void* dx,
                                   const float* mask, const float* mean, const float* var,
                                   const float* w, long long w_stride, const float* b,
                                   long long b_stride, const float* part3,
                                   const float* part4, float* dw, float* db, int T, int N,
                                   int L, int C, int training, float eps, void* stream) {
  const Geometry g = geometry(N, L, C, w_stride, b_stride);
  const dim3 block(CT, GROUPS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    grad_apply_kernel<__nv_bfloat16><<<grid(g, T), block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
        static_cast<__nv_bfloat16*>(dx), mask, mean, var, w, b, part3, part4, dw, db, g,
        training, eps);
  else
    grad_apply_kernel<float><<<grid(g, T), block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), static_cast<float*>(dx),
        mask, mean, var, w, b, part3, part4, dw, db, g, training, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
