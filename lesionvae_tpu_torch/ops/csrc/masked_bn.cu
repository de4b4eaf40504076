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
// threshold_backward on the output), xh = (x - mean) / sd (bfloat16, whose
// forward never forms xh: (x - mean) * (1 / sd)), and
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
// Order of every sum (the plain version repeats it; so do two calls): rows
// split into chunks of CHUNK = LANES*J consecutive rows; lane s of a chunk
// adds rows s, s+LANES, ... of it one after another from 0; the LANES lanes
// are added in a tree (s += s+16, +8, +4, +2, +1); the chunk partials are
// added in chunk order by every block that needs the total, so no float
// atomic is used and no sum depends on which block ends first.
//
// What bounds it: device memory.  The least traffic is x read and y written
// forward, x and dy read and dx written backward (five passes); a few FP32
// operations an element against 67 TFLOP/s are far below that.  The
// cluster route makes those five passes and no more; what holds it short
// of them on an H100 is each block's phases: its rows arrive, it sums,
// waits at two cluster barriers (one backward), then writes, and six
// blocks an SM forward (shared memory) and three backward do not keep the
// memory busy through the others' waits.  bf16 halves the bytes but not the
// instructions an element, which then weigh as much as the bytes; so its
// backward forms xh as a product with 1/sd, not a quotient (float32 divides
// once an element and keeps xh for dx).  Readings in PERF.md section 6.
//
// The design for the card.  A block is 256 threads over SLOTS = 2 chunks of
// one member and one channel tile: a tile row is VECTORS = 4 16-byte vectors
// (16 float32 or 32 bf16 channels, 64 bytes), a thread one vector (V
// channels) of one lane of one chunk: its J = 8 rows.  The thread's bits:
// 0-1 the vector, 2-4 the lane's bits 2-4, 5-6 its bits 0-1, 7 the chunk,
// so the tree's first three levels (lanes 16, 8, 4 apart) are warp shuffles
// (a butterfly gives lane s of s < w exactly a_s + a_{s+w}) and the last two
// are four nodes a channel in shared memory.  A row's mask (m/cnt in the
// backward) comes to shared memory once a block (one integer division a
// row).  Offsets inside a member are 32-bit (R*C < 2^31); full chunks take
// no row test, the ragged last chunk is a separate instance.
//
// Two routes, chosen by shape before the launch (ops/masked_bn.py::route):
//
//   cluster (training, R <= MAX_CLUSTER*SLOTS*CHUNK, C*itemsize a multiple
//   of 16): one thread-block cluster a (member, channel tile), ceil(K/SLOTS)
//   blocks holding all K chunks of the group's rows in shared memory, loaded
//   once with cp.async in two commit groups a thread (rows 0-3, then 4-7:
//   the sums start on the first half while the second is in flight).  The
//   chunk partials go through distributed shared memory (map_shared_rank,
//   barrier.cluster); every block adds them in chunk order.
//     cluster_forward_kernel:  sum m x -> mean -> sum (x-mean)^2 m over the
//       rows in shared memory -> var and the running statistics (rank 0) ->
//       y, one launch a layer
//     cluster_backward_kernel: S1, S2 -> dbias, dweight (rank 0) -> dx from
//       the rows already in shared memory, one launch a layer; the sums'
//       pass writes each element's g over its dy and, float32, its xh over
//       its x, so dx takes no second quotient there
//   Device memory sees the bound's five passes; two launches a layer.
//
//   general (any other shape): the same blocks with their rows in registers
//   and the chunk partials through a (T, K, C) buffer in device memory, five
//   launches a layer in training (stats_kernel phase 0 and 1, apply_kernel,
//   grad_sums_kernel, grad_apply_kernel), nine passes; 16-byte vectors where
//   C*itemsize is a multiple of 16, else one channel a vector.  A member of
//   many chunks makes each block's serial chunk totals long, so they read
//   GLOBAL_CHAIN partials in flight where a cluster's read CHAIN.
//
//   Eval is apply_kernel alone, one pass.
//
// C interface (loaded with ctypes): each function returns the launch's
// error, else cudaGetLastError().  Pointers of a (T, C) parameter come with
// the member stride of its rows.  lesionvae_masked_bn_init sets the cluster
// kernels' shared-memory and cluster-size attributes; it runs once, before
// any launch and outside any graph capture.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int LANES = 32;          // row lanes of a chunk
constexpr int J = 8;               // rows a lane takes of its chunk
constexpr int CHUNK = LANES * J;   // rows a chunk
constexpr int VECTORS = 4;         // 16-byte vectors a row of a channel tile
constexpr int SLOTS = 2;           // chunks a block
constexpr int THREADS = SLOTS * LANES * VECTORS;
constexpr int VECTOR_BYTES = 16;
constexpr int MAX_CT = VECTORS * 8;  // channels a tile at most (bf16)
constexpr int NODES = 4;           // lane-tree nodes a channel after the shuffles
constexpr int MAX_CLUSTER = 16;    // blocks a cluster (non-portable above 8)
constexpr int CHAIN = 8;           // chunk partials in flight a thread adding a cluster's
constexpr int GLOBAL_CHAIN = 32;   // ... adding the general route's, from device memory
// blocks an SM each kernel is compiled for (__launch_bounds__ caps the
// registers): the cluster forward's shared memory holds six, the
// backward's three; the general kernels keep their rows in registers
constexpr int FORWARD_BLOCKS = 6, BACKWARD_BLOCKS = 3, GENERAL_BLOCKS = 2;
static_assert(THREADS == 256 && VECTORS == 4 && LANES == 32, "the thread bits below");

struct Geometry {
  int N, L, C, R, K;               // rows R = N*L a member (R*C < 2^31), K chunks of them
  long long w_stride, b_stride;    // member strides of weight and bias
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }
__device__ __forceinline__ float bf16_bits_to_float(unsigned h) { return __uint_as_float(h << 16); }
__device__ __forceinline__ unsigned float_to_bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// V values of X as they sit in memory (Raw) <-> V floats
template <typename X, int V>
struct Vec;

template <>
struct Vec<float, 4> {
  using Raw = uint4;
  __device__ static void unpack(const Raw& u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x), f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z), f[3] = __uint_as_float(u.w);
  }
  __device__ static Raw pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static void unpack(const Raw& u, float (&f)[8]) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static Raw pack(const float (&f)[8]) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = float_to_bf16_bits(f[2 * i]) | (float_to_bf16_bits(f[2 * i + 1]) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Vec<float, 1> {
  using Raw = float;
  __device__ static void unpack(const Raw& u, float (&f)[1]) { f[0] = u; }
  __device__ static Raw pack(const float (&f)[1]) { return f[0]; }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  using Raw = unsigned short;
  __device__ static void unpack(const Raw& u, float (&f)[1]) { f[0] = bf16_bits_to_float(u); }
  __device__ static Raw pack(const float (&f)[1]) {
    return static_cast<Raw>(float_to_bf16_bits(f[0]));
  }
};

// the thread's place: its vector of V channels of one lane of one chunk
template <int V>
struct Pos {
  int tid, vec, lo, lane, slot, chunk, c0;
  bool node;  // lane bits 2-4 are 0: the thread writes its lanes' tree node
  __device__ explicit Pos(int block) {
    tid = threadIdx.x;
    vec = tid & 3;
    lo = (tid >> 5) & 3;
    lane = ((tid >> 2) & 7) * 4 + lo;
    node = ((tid >> 2) & 7) == 0;
    slot = tid >> 7;
    chunk = block * SLOTS + slot;
    c0 = blockIdx.y * (VECTORS * V) + vec * V;
  }
  __device__ int row(int j) const { return chunk * CHUNK + j * LANES + lane; }
  __device__ int row_slot(int j) const { return slot * CHUNK + j * LANES + lane; }
};

// ------------------------------------------------------------ rows and masks
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cp.async of the thread's J rows of each of the A arrays (member bases in
// src) into its slots of shared memory, [A][J][THREADS] 16-byte words: one
// commit group for rows 0..J/2-1 of every array, one for the rest.  Rows
// past R and channels past C are zero-filled without a read.
template <typename X, int V, int A>
__device__ __forceinline__ void load_rows_async(const X* const (&src)[A], uint4* data,
                                                const Pos<V>& p, const Geometry& g, bool live) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int a = 0; a < A; ++a) {
#pragma unroll
      for (int j = h * J / 2; j < (h + 1) * J / 2; ++j) {
        const int r = p.row(j);
        const bool ok = live && r < g.R;
        cp_async16(data + (a * J + j) * THREADS + p.tid, src[a] + (ok ? r * g.C + p.c0 : 0), ok);
      }
    }
    cp_async_commit();
  }
}

// the thread's rows in shared memory; WAIT: the first read of rows 0 and
// J/2 waits for their commit group
template <bool WAIT>
struct SharedRows {
  const uint4* data;
  int tid;
  __device__ __forceinline__ uint4 operator()(int a, int j) const {
    if (WAIT && a == 0 && j == 0) cp_async_wait<1>();
    if (WAIT && a == 0 && j == J / 2) cp_async_wait<0>();
    return data[(a * J + j) * THREADS + tid];
  }
};

// the thread's rows in registers, every load issued before any is used
template <typename X, int V, int A>
struct RegisterRows {
  using Raw = typename Vec<X, V>::Raw;
  Raw r[A][J];
  __device__ __forceinline__ void load(const X* const (&src)[A], const Pos<V>& p,
                                       const Geometry& g, bool live) {
#pragma unroll
    for (int a = 0; a < A; ++a)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int row = p.row(j);
        r[a][j] = live && row < g.R
                      ? *reinterpret_cast<const Raw*>(src[a] + row * g.C + p.c0)
                      : Raw{};
      }
  }
  __device__ __forceinline__ Raw operator()(int a, int j) const { return r[a][j]; }
};

// The masks a block needs, loaded before its rows so that they are not
// queued behind them: the mask of each row of the block's chunks (1 without
// a mask, 0 past the last row), two a thread, and warp 0's lane share of
// sum_n mask[t, n] (exact in any order for a 0/1 mask).
constexpr int ROWS_A_THREAD = SLOTS * CHUNK / THREADS;
struct Masks {
  float row[ROWS_A_THREAD];
  float count;

  __device__ __forceinline__ void load(const float* __restrict__ mask, int t, const Geometry& g,
                                       int block, bool rows = true) {
    const float* m = mask == nullptr ? nullptr : mask + static_cast<long long>(t) * g.N;
#pragma unroll
    for (int i = 0; i < ROWS_A_THREAD && rows; ++i) {
      const int r = block * SLOTS * CHUNK + threadIdx.x + i * THREADS;
      row[i] = r >= g.R ? 0.f : m == nullptr ? 1.f : m[r / g.L];
    }
    count = 0.f;
    if (threadIdx.x < 32) {
      if (m != nullptr) {
        for (int n = threadIdx.x; n < g.N; n += 32) count = __fadd_rn(count, m[n]);
      } else if (threadIdx.x == 0) {
        count = static_cast<float>(g.N);
      }
    }
  }

  // max(sum_n mask[t, n] * L, 1) to every thread (warp 0 adds the lanes'
  // shares, then the product and the clamp as the plain version takes them)
  __device__ __forceinline__ float member_count(const Geometry& g, float* s_cnt) const {
    if (threadIdx.x < 32) {
      float s = count;
      for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
      if (threadIdx.x == 0) *s_cnt = fmaxf(__fmul_rn(s, static_cast<float>(g.L)), 1.f);
    }
    __syncthreads();
    return *s_cnt;
  }

  // each row's mask into s_row, or with mc its m/cnt (1/cnt, computed once,
  // for a mask of 1)
  __device__ __forceinline__ void stage(float* s_row, bool mc, float cnt) const {
    const float rcnt = mc ? __fdiv_rn(1.f, cnt) : 0.f;
#pragma unroll
    for (int i = 0; i < ROWS_A_THREAD; ++i)
      s_row[threadIdx.x + i * THREADS] =
          mc ? (row[i] == 1.f ? rcnt : __fdiv_rn(row[i], cnt)) : row[i];
  }
};

// ------------------------------------------------------------ the lane tree
// The thread's V lane sums through the tree's levels 16, 8, 4 (shuffles);
// the threads of lane bits 2-4 = 0 keep the four nodes a channel left, in
// node[SLOTS][NODES][MAX_CT]
template <int V>
__device__ __forceinline__ void lane_levels(float (&acc)[V], const Pos<V>& p, float* node) {
#pragma unroll
  for (int o = 16; o >= 4; o >>= 1)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], __shfl_xor_sync(0xffffffffu, acc[i], o));
  if (p.node) {
#pragma unroll
    for (int i = 0; i < V; ++i) node[(p.slot * NODES + p.lo) * MAX_CT + p.vec * V + i] = acc[i];
  }
}

// after a __syncthreads: the last two levels, (n0 + n2) + (n1 + n3), for
// every (sum q, slot, channel c < CT) of the block; put(q, slot, c, partial)
template <int CT, typename Put>
__device__ __forceinline__ void node_partials(const float* node, int sums, Put put) {
  for (int u = threadIdx.x; u < sums * SLOTS * CT; u += THREADS) {
    const int q = u / (SLOTS * CT), slot = (u / CT) % SLOTS, c = u % CT;
    const float* n = node + (q * SLOTS + slot) * NODES * MAX_CT + c;
    put(q, slot, c,
        __fadd_rn(__fadd_rn(n[0], n[2 * MAX_CT]), __fadd_rn(n[MAX_CT], n[3 * MAX_CT])));
  }
}

// sum over k < K of part(k) in chunk order: the first partial, then each
// next one added; W loads in flight at a time
template <int W, typename Part>
__device__ __forceinline__ float chain(int K, Part part) {
  float s = 0.f;
  for (int k0 = 0; k0 < K; k0 += W) {
    float v[W];
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = k0 + i < K ? part(k0 + i) : 0.f;
#pragma unroll
    for (int i = 0; i < W; ++i)
      if (k0 + i < K) s = k0 + i == 0 ? v[i] : __fadd_rn(s, v[i]);
  }
  return s;
}

// split cluster barrier: arrive when this block reads no more of the
// others' shared memory, wait before leaving so no block leaves while
// another may still read its partials
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// ------------------------------------------------------------ element math
template <typename X>
struct Norm {
  float mean, sd, rsd, w, b, a, a16, b16;

  __device__ __forceinline__ void init(float mean_, float var, float w_, float b_, float eps) {
    mean = mean_;
    w = w_;
    b = b_;
    sd = __fsqrt_rn(__fadd_rn(var, eps));
    rsd = __fdiv_rn(1.f, sd);
    a = __fdiv_rn(w, sd);  // also the backward's w / sd
    a16 = round_bf16(a);
    b16 = round_bf16(__fsub_rn(b, __fmul_rn(mean, a)));
  }
  __device__ __forceinline__ float xh(float v) const;          // (x - mean) / sd
  __device__ __forceinline__ float y(float v, float z) const;  // relu(bn(x)) from x and xh
  __device__ __forceinline__ float out(float v) const;         // relu(bn(x)) from x
};

// float32 divides, as the forward's output needs; bf16, whose output is the
// folded affine, forms xh for the backward alone, as a product with 1/sd
template <>
__device__ __forceinline__ float Norm<float>::xh(float v) const {
  return __fdiv_rn(__fsub_rn(v, mean), sd);
}
template <>
__device__ __forceinline__ float Norm<__nv_bfloat16>::xh(float v) const {
  return __fmul_rn(__fsub_rn(v, mean), rsd);
}

template <>
__device__ __forceinline__ float Norm<float>::y(float, float z) const {
  return relu(__fadd_rn(__fmul_rn(z, w), b));
}
template <>
__device__ __forceinline__ float Norm<float>::out(float v) const { return y(v, xh(v)); }

template <>
__device__ __forceinline__ float Norm<__nv_bfloat16>::y(float v, float) const {
  return relu(round_bf16(__fadd_rn(round_bf16(__fmul_rn(v, a16)), b16)));
}
template <>
__device__ __forceinline__ float Norm<__nv_bfloat16>::out(float v) const { return y(v, 0.f); }

// the thread's V channels: mean and var from stat[0], stat[1] (indexed by
// the tile's channel), weight and bias from device memory
template <typename X, int V>
__device__ __forceinline__ void init_norms(Norm<X> (&nm)[V], const float* mean, const float* var,
                                           const float* __restrict__ w,
                                           const float* __restrict__ b, int t, const Pos<V>& p,
                                           const Geometry& g, bool live, float eps) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = p.c0 + i;
    nm[i].init(mean[p.vec * V + i], var[p.vec * V + i], live ? w[t * g.w_stride + c] : 1.f,
               live ? b[t * g.b_stride + c] : 0.f, eps);
  }
}

// ------------------------------------------------------------ passes over a thread's rows
// PHASE 0: acc += x m;  PHASE 1: acc += ((x - mean)^2) m
template <typename X, int V, bool TAIL, int PHASE, typename Rows>
__device__ __forceinline__ void stats_pass(const Rows& rows, const float* s_row, const Pos<V>& p,
                                           const Geometry& g, const float (&mean)[V],
                                           float (&acc)[V]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    float v[V];
    Vec<X, V>::unpack(rows(0, j), v);
    const float m = s_row[p.row_slot(j)];
    if (TAIL && p.row(j) >= g.R) continue;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (PHASE == 0) {
        acc[i] = __fadd_rn(acc[i], __fmul_rn(v[i], m));
      } else {
        const float d = __fsub_rn(v[i], mean[i]);
        acc[i] = __fadd_rn(acc[i], __fmul_rn(__fmul_rn(d, d), m));
      }
    }
  }
}

template <typename X, int V, int PHASE, typename Rows>
__device__ __forceinline__ void stats_rows(bool tail, const Rows& rows, const float* s_row,
                                           const Pos<V>& p, const Geometry& g,
                                           const float (&mean)[V], float (&acc)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  if (tail)
    stats_pass<X, V, true, PHASE>(rows, s_row, p, g, mean, acc);
  else
    stats_pass<X, V, false, PHASE>(rows, s_row, p, g, mean, acc);
}

// y of the thread's rows
template <typename X, int V, bool TAIL, typename Rows>
__device__ __forceinline__ void apply_pass(const Rows& rows, X* __restrict__ yt,
                                           const Pos<V>& p, const Geometry& g,
                                           const Norm<X> (&nm)[V]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    float v[V];
    Vec<X, V>::unpack(rows(0, j), v);
    const int r = p.row(j);
    if (TAIL && r >= g.R) continue;
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = nm[i].out(v[i]);
    *reinterpret_cast<typename Vec<X, V>::Raw*>(yt + r * g.C + p.c0) = Vec<X, V>::pack(v);
  }
}

template <typename X, int V, typename Rows>
__device__ __forceinline__ void apply_rows(bool tail, bool live, const Rows& rows,
                                           X* __restrict__ yt, const Pos<V>& p,
                                           const Geometry& g, const Norm<X> (&nm)[V]) {
  if (!live) return;
  if (tail)
    apply_pass<X, V, true>(rows, yt, p, g, nm);
  else
    apply_pass<X, V, false>(rows, yt, p, g, nm);
}

// S1 += g, S2 += g xh over the thread's rows (x: array 0, dy: array 1).
// STORE (rows in shared memory): each element's g is written over its dy
// and, float32, its xh over its x, for the second pass
template <typename X, int V, bool TAIL, bool STORE, typename Rows>
__device__ __forceinline__ void grad_sums_pass(const Rows& rows, uint4* store, const Pos<V>& p,
                                               const Geometry& g, const Norm<X> (&nm)[V],
                                               float (&s1)[V], float (&s2)[V]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    float v[V], d[V];
    Vec<X, V>::unpack(rows(0, j), v);
    Vec<X, V>::unpack(rows(1, j), d);
    if (TAIL && p.row(j) >= g.R) continue;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float z = nm[i].xh(v[i]);
      d[i] = nm[i].y(v[i], z) <= 0.f ? 0.f : d[i];
      v[i] = z;
      s1[i] = __fadd_rn(s1[i], d[i]);
      s2[i] = __fadd_rn(s2[i], __fmul_rn(d[i], z));
    }
    if constexpr (STORE) {
      if constexpr (std::is_same<X, float>::value) store[j * THREADS + p.tid] = Vec<X, V>::pack(v);
      store[(J + j) * THREADS + p.tid] = Vec<X, V>::pack(d);
    }
  }
}

template <typename X, int V, bool STORE, typename Rows>
__device__ __forceinline__ void grad_sums_rows(bool tail, const Rows& rows, uint4* store,
                                               const Pos<V>& p, const Geometry& g,
                                               const Norm<X> (&nm)[V], float (&s1)[V],
                                               float (&s2)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
  if (tail)
    grad_sums_pass<X, V, true, STORE>(rows, store, p, g, nm, s1, s2);
  else
    grad_sums_pass<X, V, false, STORE>(rows, store, p, g, nm, s1, s2);
}

// dx of the thread's rows; s_row holds each row's m/cnt (training).
// STORED: array 1 holds g and, float32, array 0 xh (grad_sums_pass's STORE)
template <typename X, int V, bool TAIL, bool TRAINING, bool STORED, typename Rows>
__device__ __forceinline__ void grad_apply_pass(const Rows& rows, X* __restrict__ dxt,
                                                const float* s_row, const Pos<V>& p,
                                                const Geometry& g, const Norm<X> (&nm)[V],
                                                const float (&S1)[V], const float (&S2)[V]) {
  constexpr bool HAS_XH = STORED && std::is_same<X, float>::value;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    float v[V], d[V];
    Vec<X, V>::unpack(rows(0, j), v);
    Vec<X, V>::unpack(rows(1, j), d);
    const float mc = TRAINING ? s_row[p.row_slot(j)] : 0.f;
    const int r = p.row(j);
    if (TAIL && r >= g.R) continue;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float z = HAS_XH ? v[i] : nm[i].xh(v[i]);
      const float gr = STORED ? d[i] : nm[i].y(v[i], z) <= 0.f ? 0.f : d[i];
      v[i] = TRAINING ? __fmul_rn(nm[i].a, __fsub_rn(gr, __fmul_rn(mc, __fadd_rn(S1[i], __fmul_rn(z, S2[i])))))
                      : __fmul_rn(nm[i].a, gr);
    }
    *reinterpret_cast<typename Vec<X, V>::Raw*>(dxt + r * g.C + p.c0) = Vec<X, V>::pack(v);
  }
}

template <typename X, int V, bool STORED, typename Rows>
__device__ __forceinline__ void grad_apply_rows(bool tail, bool live, bool training,
                                                const Rows& rows, X* __restrict__ dxt,
                                                const float* s_row, const Pos<V>& p,
                                                const Geometry& g, const Norm<X> (&nm)[V],
                                                const float (&S1)[V], const float (&S2)[V]) {
  if (!live) return;
  if (training) {
    if (tail)
      grad_apply_pass<X, V, true, true, STORED>(rows, dxt, s_row, p, g, nm, S1, S2);
    else
      grad_apply_pass<X, V, false, true, STORED>(rows, dxt, s_row, p, g, nm, S1, S2);
  } else {
    if (tail)
      grad_apply_pass<X, V, true, false, STORED>(rows, dxt, s_row, p, g, nm, S1, S2);
    else
      grad_apply_pass<X, V, false, false, STORED>(rows, dxt, s_row, p, g, nm, S1, S2);
  }
}

// ------------------------------------------------------------ cluster route
// The cluster's totals of `sums` sums for every channel c < CT, a thread a
// (sum q, channel): chunk k's partial lies in block k / SLOTS, slot
// k % SLOTS, of part[q]; put(q, c, total)
template <int CT, typename Put>
__device__ __forceinline__ void cluster_totals(cg::cluster_group& cluster,
                                               float (*part)[SLOTS * MAX_CT], int sums, int K,
                                               Put put) {
  if (threadIdx.x < sums * CT) {
    const int q = threadIdx.x / CT, c = threadIdx.x % CT;
    put(q, c, chain<CHAIN>(K, [&](int k) {
      return cluster.map_shared_rank(part[q], k / SLOTS)[(k % SLOTS) * MAX_CT + c];
    }));
  }
}

// training forward, one launch: a cluster is (member blockIdx.z, channel
// tile blockIdx.y), its blocks blockIdx.x take chunks 2x and 2x+1
template <typename X>
__global__ void __launch_bounds__(THREADS, FORWARD_BLOCKS)
cluster_forward_kernel(const X* __restrict__ x, X* __restrict__ y, const float* __restrict__ mask,
                       const float* __restrict__ w, const float* __restrict__ b,
                       const float* __restrict__ rm, const float* __restrict__ rv,
                       float* __restrict__ mean_out, float* __restrict__ var_out,
                       float* __restrict__ new_rm, float* __restrict__ new_rv, Geometry g,
                       float eps, float momentum, float keep) {
  constexpr int V = VECTOR_BYTES / sizeof(X);
  constexpr int CT = VECTORS * V;
  extern __shared__ uint4 s_data[];  // [J][THREADS]: the thread's rows of x
  __shared__ float s_row[SLOTS * CHUNK];
  __shared__ float s_node[SLOTS * NODES * MAX_CT];
  __shared__ float s_part[2][SLOTS * MAX_CT];  // chunk partials, read across the cluster
  __shared__ float s_stat[2][MAX_CT];          // mean, var of the tile's channels
  __shared__ float s_cnt;
  cg::cluster_group cluster = cg::this_cluster();
  const int block = blockIdx.x, t = blockIdx.z;
  const Pos<V> p(block);
  const long long base = static_cast<long long>(t) * g.R * g.C;
  const bool live = p.c0 < g.C, tail = (p.chunk + 1) * CHUNK > g.R;
  const X* const src[1] = {x + base};
  load_rows_async<X, V, 1>(src, s_data, p, g, live);
  Masks masks;  // after the rows: in the forward that measured faster
  masks.load(mask, t, g, block);
  const float cnt = masks.member_count(g, &s_cnt);
  masks.stage(s_row, false, cnt);
  __syncthreads();

  float acc[V], mean[V] = {};
  for (int phase = 0; phase < 2; ++phase) {
    if (phase == 0)
      stats_rows<X, V, 0>(tail, SharedRows<true>{s_data, p.tid}, s_row, p, g, mean, acc);
    else
      stats_rows<X, V, 1>(tail, SharedRows<false>{s_data, p.tid}, s_row, p, g, mean, acc);
    lane_levels(acc, p, s_node);
    __syncthreads();
    node_partials<CT>(s_node, 1, [&](int, int slot, int c, float v) {
      s_part[phase][slot * MAX_CT + c] = v;
    });
    cluster.sync();
    cluster_totals<CT>(cluster, &s_part[phase], 1, g.K, [&](int, int c, float total) {
      const float stat = __fdiv_rn(total, cnt);
      s_stat[phase][c] = stat;
      const int gc = blockIdx.y * CT + c;
      if (phase == 1 && block == 0 && gc < g.C) {
        const long long tc = static_cast<long long>(t) * g.C + gc;
        const float mu = s_stat[0][c];
        const float unbiased = __fdiv_rn(__fmul_rn(stat, cnt), fmaxf(__fsub_rn(cnt, 1.f), 1.f));
        mean_out[tc] = mu;
        var_out[tc] = stat;
        new_rm[tc] = __fadd_rn(__fmul_rn(keep, rm[tc]), __fmul_rn(momentum, mu));
        new_rv[tc] = __fadd_rn(__fmul_rn(keep, rv[tc]), __fmul_rn(momentum, unbiased));
      }
    });
    if (phase == 1) cluster_arrive();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < V; ++i) mean[i] = s_stat[0][p.vec * V + i];
  }
  Norm<X> nm[V];
  init_norms(nm, s_stat[0], s_stat[1], w, b, t, p, g, live, eps);
  apply_rows(tail, live, SharedRows<false>{s_data, p.tid}, y + base, p, g, nm);
  cluster_wait();
}

// backward, one launch: the same clusters, x and dy in shared memory
template <typename X>
__global__ void __launch_bounds__(THREADS, BACKWARD_BLOCKS)
cluster_backward_kernel(const X* __restrict__ x, const X* __restrict__ dy, X* __restrict__ dx,
                        const float* __restrict__ mask, const float* __restrict__ mean,
                        const float* __restrict__ var, const float* __restrict__ w,
                        const float* __restrict__ b, float* __restrict__ dw,
                        float* __restrict__ db, Geometry g, int training, float eps) {
  constexpr int V = VECTOR_BYTES / sizeof(X);
  constexpr int CT = VECTORS * V;
  extern __shared__ uint4 s_data[];  // [2][J][THREADS]: the thread's rows of x, then dy
  __shared__ float s_row[SLOTS * CHUNK];
  __shared__ float s_node[2][SLOTS * NODES * MAX_CT];
  __shared__ float s_part[2][SLOTS * MAX_CT];
  __shared__ float s_stat[2][MAX_CT];  // mean, var; then S1, S2
  __shared__ float s_cnt;
  cg::cluster_group cluster = cg::this_cluster();
  const int block = blockIdx.x, t = blockIdx.z;
  const Pos<V> p(block);
  const long long base = static_cast<long long>(t) * g.R * g.C;
  const bool live = p.c0 < g.C, tail = (p.chunk + 1) * CHUNK > g.R;
  Masks masks;
  if (training) masks.load(mask, t, g, block);
  const X* const src[2] = {x + base, dy + base};
  load_rows_async<X, V, 2>(src, s_data, p, g, live);
  if (threadIdx.x < CT) {
    const int gc = blockIdx.y * CT + threadIdx.x;
    const long long tc = static_cast<long long>(t) * g.C + gc;
    s_stat[0][threadIdx.x] = gc < g.C ? mean[tc] : 0.f;
    s_stat[1][threadIdx.x] = gc < g.C ? var[tc] : 1.f;
  }
  if (training) masks.stage(s_row, true, masks.member_count(g, &s_cnt));
  __syncthreads();
  Norm<X> nm[V];
  init_norms(nm, s_stat[0], s_stat[1], w, b, t, p, g, live, eps);

  float s1[V], s2[V];
  grad_sums_rows<X, V, true>(tail, SharedRows<true>{s_data, p.tid}, s_data, p, g, nm, s1, s2);
  lane_levels(s1, p, s_node[0]);
  lane_levels(s2, p, s_node[1]);
  __syncthreads();
  node_partials<CT>(&s_node[0][0], 2, [&](int q, int slot, int c, float v) {
    s_part[q][slot * MAX_CT + c] = v;
  });
  cluster.sync();
  cluster_totals<CT>(cluster, s_part, 2, g.K, [&](int q, int c, float S) {
    s_stat[q][c] = S;
    const int gc = blockIdx.y * CT + c;
    if (block == 0 && gc < g.C) (q == 0 ? db : dw)[static_cast<long long>(t) * g.C + gc] = S;
  });
  cluster_arrive();
  __syncthreads();
  float S1[V], S2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) S1[i] = s_stat[0][p.vec * V + i], S2[i] = s_stat[1][p.vec * V + i];
  grad_apply_rows<X, V, true>(tail, live, training != 0, SharedRows<false>{s_data, p.tid},
                             dx + base, s_row, p, g, nm, S1, S2);
  cluster_wait();
}

// ------------------------------------------------------------ general route
// chunk k's partial of member t, channel gc in a (T, K, C) buffer
__device__ __forceinline__ float global_total(const float* __restrict__ part, int t, int gc,
                                              const Geometry& g) {
  const float* p = part + static_cast<long long>(t) * g.K * g.C + gc;
  return chain<GLOBAL_CHAIN>(g.K, [&](int k) { return p[static_cast<long long>(k) * g.C]; });
}

// the block's chunk partials of `sums` sums into (T, K, C) buffers
template <int CT>
__device__ __forceinline__ void global_partials(const float* node, int sums, float* part0,
                                                float* part1, int t, const Geometry& g) {
  node_partials<CT>(node, sums, [&](int q, int slot, int c, float v) {
    const int k = blockIdx.x * SLOTS + slot, gc = blockIdx.y * CT + c;
    if (k < g.K && gc < g.C)
      (q == 0 ? part0 : part1)[(static_cast<long long>(t) * g.K + k) * g.C + gc] = v;
  });
}

// phase 0: chunk partials of sum m x into part_out.  phase 1: mean from
// part_in's chunk partials (chunk-0 blocks write it), then chunk partials of
// sum (x - mean)^2 m into part_out.
template <typename X, int V>
__global__ void __launch_bounds__(THREADS, GENERAL_BLOCKS)
stats_kernel(const X* __restrict__ x, const float* __restrict__ mask,
             const float* __restrict__ part_in, float* __restrict__ part_out,
             float* __restrict__ mean_out, Geometry g, int phase) {
  constexpr int CT = VECTORS * V;
  __shared__ float s_row[SLOTS * CHUNK];
  __shared__ float s_node[SLOTS * NODES * MAX_CT];
  __shared__ float s_stat[MAX_CT];
  __shared__ float s_cnt;
  const int t = blockIdx.z;
  const Pos<V> p(blockIdx.x);
  const long long base = static_cast<long long>(t) * g.R * g.C;
  const bool live = p.c0 < g.C, tail = (p.chunk + 1) * CHUNK > g.R;
  Masks masks;
  masks.load(mask, t, g, blockIdx.x);
  RegisterRows<X, V, 1> rows;
  const X* const src[1] = {x + base};
  rows.load(src, p, g, live);
  masks.stage(s_row, false, 0.f);
  float acc[V], mean[V] = {};
  if (phase == 1) {
    const float cnt = masks.member_count(g, &s_cnt);
    if (threadIdx.x < CT) {
      const int gc = blockIdx.y * CT + threadIdx.x;
      const float mu = gc < g.C ? __fdiv_rn(global_total(part_in, t, gc, g), cnt) : 0.f;
      s_stat[threadIdx.x] = mu;
      if (blockIdx.x == 0 && gc < g.C) mean_out[static_cast<long long>(t) * g.C + gc] = mu;
    }
  }
  __syncthreads();
  if (phase == 1) {
#pragma unroll
    for (int i = 0; i < V; ++i) mean[i] = s_stat[p.vec * V + i];
    stats_rows<X, V, 1>(tail, rows, s_row, p, g, mean, acc);
  } else {
    stats_rows<X, V, 0>(tail, rows, s_row, p, g, mean, acc);
  }
  lane_levels(acc, p, s_node);
  __syncthreads();
  global_partials<CT>(s_node, 1, part_out, nullptr, t, g);
}

// y = relu(bn(x)).  Training: var from part2's chunk partials, mean as the
// stats kernel wrote it; chunk-0 blocks write var and the new running
// statistics.  Eval: mean and var are the running statistics.
template <typename X, int V>
__global__ void __launch_bounds__(THREADS, GENERAL_BLOCKS)
apply_kernel(const X* __restrict__ x, X* __restrict__ y, const float* __restrict__ mask,
             const float* __restrict__ part2, const float* __restrict__ mean_in,
             float* __restrict__ var_out, const float* __restrict__ w,
             const float* __restrict__ b, const float* __restrict__ rm,
             const float* __restrict__ rv, float* __restrict__ new_rm,
             float* __restrict__ new_rv, Geometry g, int training, float eps,
             float momentum, float keep) {
  constexpr int CT = VECTORS * V;
  __shared__ float s_stat[2][MAX_CT];
  __shared__ float s_cnt;
  const int t = blockIdx.z;
  const Pos<V> p(blockIdx.x);
  const long long base = static_cast<long long>(t) * g.R * g.C;
  const bool live = p.c0 < g.C, tail = (p.chunk + 1) * CHUNK > g.R;
  Masks masks;
  if (training) masks.load(mask, t, g, blockIdx.x, false);
  RegisterRows<X, V, 1> rows;
  const X* const src[1] = {x + base};
  rows.load(src, p, g, live);
  const float cnt = training ? masks.member_count(g, &s_cnt) : 1.f;
  if (threadIdx.x < CT) {
    const int c = threadIdx.x, gc = blockIdx.y * CT + c;
    const long long tc = static_cast<long long>(t) * g.C + gc;
    float mu = 0.f, var = 1.f;
    if (gc < g.C) {
      if (training) {
        mu = mean_in[tc];
        var = __fdiv_rn(global_total(part2, t, gc, g), cnt);
        if (blockIdx.x == 0) {
          const float unbiased = __fdiv_rn(__fmul_rn(var, cnt), fmaxf(__fsub_rn(cnt, 1.f), 1.f));
          var_out[tc] = var;
          new_rm[tc] = __fadd_rn(__fmul_rn(keep, rm[tc]), __fmul_rn(momentum, mu));
          new_rv[tc] = __fadd_rn(__fmul_rn(keep, rv[tc]), __fmul_rn(momentum, unbiased));
        }
      } else {
        mu = rm[tc];
        var = rv[tc];
      }
    }
    s_stat[0][c] = mu;
    s_stat[1][c] = var;
  }
  __syncthreads();
  Norm<X> nm[V];
  init_norms(nm, s_stat[0], s_stat[1], w, b, t, p, g, live, eps);
  apply_rows(tail, live, rows, y + base, p, g, nm);
}

// chunk partials of S1 = sum g and S2 = sum g xh over every row
template <typename X, int V>
__global__ void __launch_bounds__(THREADS, GENERAL_BLOCKS)
grad_sums_kernel(const X* __restrict__ x, const X* __restrict__ dy,
                 const float* __restrict__ mean, const float* __restrict__ var,
                 const float* __restrict__ w, const float* __restrict__ b,
                 float* __restrict__ part3, float* __restrict__ part4, Geometry g,
                 float eps) {
  constexpr int CT = VECTORS * V;
  __shared__ float s_node[2][SLOTS * NODES * MAX_CT];
  __shared__ float s_stat[2][MAX_CT];
  const int t = blockIdx.z;
  const Pos<V> p(blockIdx.x);
  const long long base = static_cast<long long>(t) * g.R * g.C;
  const bool live = p.c0 < g.C, tail = (p.chunk + 1) * CHUNK > g.R;
  RegisterRows<X, V, 2> rows;
  const X* const src[2] = {x + base, dy + base};
  rows.load(src, p, g, live);
  if (threadIdx.x < CT) {
    const int gc = blockIdx.y * CT + threadIdx.x;
    const long long tc = static_cast<long long>(t) * g.C + gc;
    s_stat[0][threadIdx.x] = gc < g.C ? mean[tc] : 0.f;
    s_stat[1][threadIdx.x] = gc < g.C ? var[tc] : 1.f;
  }
  __syncthreads();
  Norm<X> nm[V];
  init_norms(nm, s_stat[0], s_stat[1], w, b, t, p, g, live, eps);
  float s1[V], s2[V];
  grad_sums_rows<X, V, false>(tail, rows, nullptr, p, g, nm, s1, s2);
  lane_levels(s1, p, s_node[0]);
  lane_levels(s2, p, s_node[1]);
  __syncthreads();
  global_partials<CT>(&s_node[0][0], 2, part3, part4, t, g);
}

// S1, S2 from their chunk partials (chunk-0 blocks write dbias and
// dweight), then dx
template <typename X, int V>
__global__ void __launch_bounds__(THREADS, GENERAL_BLOCKS)
grad_apply_kernel(const X* __restrict__ x, const X* __restrict__ dy, X* __restrict__ dx,
                  const float* __restrict__ mask, const float* __restrict__ mean,
                  const float* __restrict__ var, const float* __restrict__ w,
                  const float* __restrict__ b, const float* __restrict__ part3,
                  const float* __restrict__ part4, float* __restrict__ dw,
                  float* __restrict__ db, Geometry g, int training, float eps) {
  constexpr int CT = VECTORS * V;
  __shared__ float s_row[SLOTS * CHUNK];
  __shared__ float s_stat[4][MAX_CT];  // mean, var, S1, S2
  __shared__ float s_cnt;
  const int t = blockIdx.z;
  const Pos<V> p(blockIdx.x);
  const long long base = static_cast<long long>(t) * g.R * g.C;
  const bool live = p.c0 < g.C, tail = (p.chunk + 1) * CHUNK > g.R;
  Masks masks;
  if (training) masks.load(mask, t, g, blockIdx.x);
  RegisterRows<X, V, 2> rows;
  const X* const src[2] = {x + base, dy + base};
  rows.load(src, p, g, live);
  if (training) masks.stage(s_row, true, masks.member_count(g, &s_cnt));
  if (threadIdx.x < 2 * CT) {
    const int q = threadIdx.x / CT, c = threadIdx.x % CT, gc = blockIdx.y * CT + c;
    const long long tc = static_cast<long long>(t) * g.C + gc;
    float S = 0.f;
    if (gc < g.C) {
      S = global_total(q == 0 ? part3 : part4, t, gc, g);
      if (blockIdx.x == 0) (q == 0 ? db : dw)[tc] = S;
      s_stat[q][c] = q == 0 ? mean[tc] : var[tc];
    } else {
      s_stat[q][c] = q == 0 ? 0.f : 1.f;
    }
    s_stat[2 + q][c] = S;
  }
  __syncthreads();
  Norm<X> nm[V];
  init_norms(nm, s_stat[0], s_stat[1], w, b, t, p, g, live, eps);
  float S1[V], S2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) S1[i] = s_stat[2][p.vec * V + i], S2[i] = s_stat[3][p.vec * V + i];
  grad_apply_rows<X, V, false>(tail, live, training != 0, rows, dx + base, s_row, p, g, nm,
                               S1, S2);
}

// ------------------------------------------------------------ host side
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

template <int V>
dim3 grid(const Geometry& g, int T) {
  return dim3((g.K + SLOTS - 1) / SLOTS, (g.C + VECTORS * V - 1) / (VECTORS * V), T);
}

// Launch<X, V>::run(...) of a general-route kernel for the activations'
// type and the vector width: 16 bytes, or one channel where a row's
// channels are no whole number of 16-byte words
template <template <typename, int> class Launch, typename... Args>
int dispatch(int bf16, int vector, Args... args) {
  if (bf16) {
    if (vector)
      Launch<__nv_bfloat16, 8>::run(args...);
    else
      Launch<__nv_bfloat16, 1>::run(args...);
  } else {
    if (vector)
      Launch<float, 4>::run(args...);
    else
      Launch<float, 1>::run(args...);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename X, int V>
struct StatsLaunch {
  static void run(Geometry g, int T, cudaStream_t s, const void* x, const float* mask,
                  const float* part_in, float* part_out, float* mean, int phase) {
    stats_kernel<X, V><<<grid<V>(g, T), THREADS, 0, s>>>(static_cast<const X*>(x), mask, part_in,
                                                          part_out, mean, g, phase);
  }
};

template <typename X, int V>
struct ApplyLaunch {
  static void run(Geometry g, int T, cudaStream_t s, const void* x, void* y, const float* mask,
                  const float* part2, const float* mean, float* var, const float* w,
                  const float* b, const float* rm, const float* rv, float* new_rm,
                  float* new_rv, int training, float eps, float momentum, float keep) {
    apply_kernel<X, V><<<grid<V>(g, T), THREADS, 0, s>>>(
        static_cast<const X*>(x), static_cast<X*>(y), mask, part2, mean, var, w, b, rm, rv,
        new_rm, new_rv, g, training, eps, momentum, keep);
  }
};

template <typename X, int V>
struct GradSumsLaunch {
  static void run(Geometry g, int T, cudaStream_t s, const void* x, const void* dy,
                  const float* mean, const float* var, const float* w, const float* b,
                  float* part3, float* part4, float eps) {
    grad_sums_kernel<X, V><<<grid<V>(g, T), THREADS, 0, s>>>(
        static_cast<const X*>(x), static_cast<const X*>(dy), mean, var, w, b, part3, part4, g,
        eps);
  }
};

template <typename X, int V>
struct GradApplyLaunch {
  static void run(Geometry g, int T, cudaStream_t s, const void* x, const void* dy, void* dx,
                  const float* mask, const float* mean, const float* var, const float* w,
                  const float* b, const float* part3, const float* part4, float* dw, float* db,
                  int training, float eps) {
    grad_apply_kernel<X, V><<<grid<V>(g, T), THREADS, 0, s>>>(
        static_cast<const X*>(x), static_cast<const X*>(dy), static_cast<X*>(dx), mask, mean,
        var, w, b, part3, part4, dw, db, g, training, eps);
  }
};

constexpr size_t kForwardSmem = static_cast<size_t>(J) * THREADS * VECTOR_BYTES;
constexpr size_t kBackwardSmem = 2 * kForwardSmem;

// one cluster of `cluster` blocks a (member, channel tile): blocks past the
// last chunk hold nothing and only join the barriers
template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, const Geometry& g, int T, int V, int cluster, size_t smem,
                   cudaStream_t stream, Args... args) {
  if (cluster < 1 || cluster > MAX_CLUSTER || cluster * SLOTS < g.K)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (g.C + VECTORS * V - 1) / (VECTORS * V), T);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename Kernel>
cudaError_t allow_clusters(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

}  // namespace

extern "C" {

int lesionvae_masked_bn_init() {
  cudaError_t err = allow_clusters(cluster_forward_kernel<float>, kForwardSmem);
  if (err == cudaSuccess) err = allow_clusters(cluster_forward_kernel<__nv_bfloat16>, kForwardSmem);
  if (err == cudaSuccess) err = allow_clusters(cluster_backward_kernel<float>, kBackwardSmem);
  if (err == cudaSuccess)
    err = allow_clusters(cluster_backward_kernel<__nv_bfloat16>, kBackwardSmem);
  return static_cast<int>(err);
}

// clusters of `cluster` blocks of one cluster kernel the card can hold at
// once (cudaOccupancyMaxActiveClusters), or minus the error
int lesionvae_masked_bn_active_clusters(int bf16, int backward, int cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = backward ? kBackwardSmem : kForwardSmem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  cudaError_t err;
  if (bf16)
    err = backward ? cudaOccupancyMaxActiveClusters(&n, cluster_backward_kernel<__nv_bfloat16>, &cfg)
                   : cudaOccupancyMaxActiveClusters(&n, cluster_forward_kernel<__nv_bfloat16>, &cfg);
  else
    err = backward ? cudaOccupancyMaxActiveClusters(&n, cluster_backward_kernel<float>, &cfg)
                   : cudaOccupancyMaxActiveClusters(&n, cluster_forward_kernel<float>, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

int lesionvae_masked_bn_cluster_forward(const void* x, int bf16, void* y, const float* mask,
                                        float* mean, float* var, const float* w,
                                        long long w_stride, const float* b, long long b_stride,
                                        const float* rm, const float* rv, float* new_rm,
                                        float* new_rv, int T, int N, int L, int C, int cluster,
                                        float eps, float momentum, float keep, void* stream) {
  const Geometry g = geometry(N, L, C, w_stride, b_stride);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_cluster(cluster_forward_kernel<__nv_bfloat16>, g, T, 8, cluster,
                          kForwardSmem, s, static_cast<const __nv_bfloat16*>(x),
                          static_cast<__nv_bfloat16*>(y), mask, w, b, rm, rv, mean, var, new_rm,
                          new_rv, g, eps, momentum, keep);
  return launch_cluster(cluster_forward_kernel<float>, g, T, 4, cluster, kForwardSmem, s,
                        static_cast<const float*>(x), static_cast<float*>(y), mask, w, b, rm, rv,
                        mean, var, new_rm, new_rv, g, eps, momentum, keep);
}

int lesionvae_masked_bn_cluster_backward(const void* x, int bf16, const void* dy, void* dx,
                                         const float* mask, const float* mean, const float* var,
                                         const float* w, long long w_stride, const float* b,
                                         long long b_stride, float* dw, float* db, int T, int N,
                                         int L, int C, int cluster, int training, float eps,
                                         void* stream) {
  const Geometry g = geometry(N, L, C, w_stride, b_stride);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_cluster(cluster_backward_kernel<__nv_bfloat16>, g, T, 8, cluster,
                          kBackwardSmem, s, static_cast<const __nv_bfloat16*>(x),
                          static_cast<const __nv_bfloat16*>(dy), static_cast<__nv_bfloat16*>(dx),
                          mask, mean, var, w, b, dw, db, g, training, eps);
  return launch_cluster(cluster_backward_kernel<float>, g, T, 4, cluster, kBackwardSmem, s,
                        static_cast<const float*>(x), static_cast<const float*>(dy),
                        static_cast<float*>(dx), mask, mean, var, w, b, dw, db, g, training, eps);
}

int lesionvae_masked_bn_stats(const void* x, int bf16, int vector, const float* mask,
                              const float* part_in, float* part_out, float* mean, int T, int N,
                              int L, int C, int phase, void* stream) {
  return dispatch<StatsLaunch>(bf16, vector, geometry(N, L, C, 0, 0), T,
                               static_cast<cudaStream_t>(stream), x, mask, part_in, part_out,
                               mean, phase);
}

int lesionvae_masked_bn_apply(const void* x, int bf16, int vector, void* y, const float* mask,
                              const float* part2, const float* mean, float* var, const float* w,
                              long long w_stride, const float* b, long long b_stride,
                              const float* rm, const float* rv, float* new_rm, float* new_rv,
                              int T, int N, int L, int C, int training, float eps, float momentum,
                              float keep, void* stream) {
  return dispatch<ApplyLaunch>(bf16, vector, geometry(N, L, C, w_stride, b_stride), T,
                               static_cast<cudaStream_t>(stream), x, y, mask, part2, mean, var,
                               w, b, rm, rv, new_rm, new_rv, training, eps, momentum, keep);
}

int lesionvae_masked_bn_grad_sums(const void* x, int bf16, int vector, const void* dy,
                                  const float* mean, const float* var, const float* w,
                                  long long w_stride, const float* b, long long b_stride,
                                  float* part3, float* part4, int T, int N, int L, int C,
                                  float eps, void* stream) {
  return dispatch<GradSumsLaunch>(bf16, vector, geometry(N, L, C, w_stride, b_stride), T,
                                  static_cast<cudaStream_t>(stream), x, dy, mean, var, w, b,
                                  part3, part4, eps);
}

int lesionvae_masked_bn_grad_apply(const void* x, int bf16, int vector, const void* dy, void* dx,
                                   const float* mask, const float* mean, const float* var,
                                   const float* w, long long w_stride, const float* b,
                                   long long b_stride, const float* part3, const float* part4,
                                   float* dw, float* db, int T, int N, int L, int C, int training,
                                   float eps, void* stream) {
  return dispatch<GradApplyLaunch>(bf16, vector, geometry(N, L, C, w_stride, b_stride), T,
                                   static_cast<cudaStream_t>(stream), x, dy, dx, mask, mean, var,
                                   w, b, part3, part4, dw, db, training, eps);
}

}  // extern "C"
