// The clip -> decay -> Adam step of the fleet and of the single VAE with
// float32 storage, as two hand-written Hopper (sm_90a) kernels: the gradient
// gather with each member's norm, and the update.
//
// Replaces what XLA fuses on the TPU, where no Pallas kernel exists:
// the global norm of lesionvae_tpu/train/lowmem.py:132-133 and
// lesionvae_tpu/train/trainer.py:99-100, and the float32 branch of
// _fused_update (lowmem.py:97-104) or make_optimizer's leaf body
// (trainer.py:106-115).  Plain PyTorch runs the gather as one copy a leaf
// and the norm and the update as some thirty elementwise kernels over
// float32 temporaries of the whole buffer.
//
// 1. grad_sq_norm: T members, L leaf gradients (T, *shape), float32 or
//    bf16, with any strides a member's dims can be merged into a row stride
//    and at most two column strides (autograd returns the dense and
//    convolution weights' gradients transposed inside a member).  Each leaf
//    is copied into its packed destination rows (row-major inside a member;
//    none when the destination pointer is null), and each member's float32
//    sum of squares and its root are written.
//
//    The sum's order, which ops/adam.py::grad_sq_norm_plain repeats
//    operation for operation:
//    - a leaf is a matrix of R rows and C columns in the packed row's order:
//      R = its first dim and C the product of the rest, or, for a leaf of
//      one dim of n elements, ceil(n / 64) rows of 64;
//    - it is cut into tiles of 32 rows x 64 columns, row tiles outer; the
//      tiles of every leaf, in the table's order, are numbered 0..n_tiles-1;
//    - in a tile, thread t (of 256) takes the elements of column t % 64 in
//      rows t / 64 + 4k, k = 0..7, and adds their squares one after another
//      to +0 (an element outside the leaf adds nothing);
//    - the 256 threads' sums are added in a tree: a[t] += a[t + w] for
//      w = 128, 64, ..., 1; a[0] is the tile's partial;
//    - a second launch adds each member's partials the same way: thread t
//      adds partials t, t + 256, ... one after another to +0, then the tree.
//    So the kernel is bit-equal to its plain version, and two calls give
//    the same bits.
//
// 2. adam_step: in place on float32 (T, n) rows p, m, v with the gradient g,
//    for member t and each element (one rounding an operation, IEEE
//    quotient and root, in this order):
//      g  = g_norm[t] < clip ? g : (g / g_norm[t]) * clip
//      g  = g + wd*p
//      m' = (1-b1)*g + b1*m;   v' = (1-b2)*(g*g) + b2*v
//      p  = p + -lr * ((m' / bc1[t]) / (sqrt(v' / bc2[t]) + eps))
//    A member whose finite[t] is 0 keeps its p, m and v bit for bit.  NaN
//    and infinities pass through as the plain chain passes them.
//
// What bounds them.  The gather moves each gradient element twice (read,
// and written to the packed rows), 8 bytes in float32; the update 28 bytes
// an element (p, m, v read and written, g read).  Both are far below the
// card's operation rate, so bytes bound both.  The design:
// - gather: a block a (tile, member).  Where a leaf's rows are the source's
//   fastest dim (a transposed gradient), the block reads down the rows, a
//   warp's 32 rows of one column in one 128-byte line, into shared memory
//   and takes the tile back out in the packed order; else each thread reads
//   its column directly.  Each thread issues its 8 loads before it uses
//   one.  The leaf table (pointers, strides, shapes) is a kernel parameter,
//   so nothing is copied to the device at a launch and the launch captures
//   into a CUDA graph (__grid_constant__: read in place, never copied to a
//   thread's local memory); a block finds its leaf by a binary search over
//   the leaves' first tiles.
// - update: blockIdx.y is the member, a grid-stride loop over the row, one
//   16-byte load of each of p, m, v, g a thread where the rows' stride is a
//   multiple of 4, then the rest one element a thread.  The per-member
//   scalars are read once a thread; the clip branch is uniform over a block.
// Both build with --fmad=false, so no product and sum contract into an FMA.
//
// C interface (loaded with ctypes): each entry returns cudaGetLastError()
// after its launches.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE_R = 32;
constexpr int TILE_C = 64;
constexpr int PER_THREAD = TILE_R * TILE_C / THREADS;  // 8 elements a thread
constexpr int ROW_STEP = THREADS / TILE_C;             // 4 rows a pass
constexpr int WARPS = THREADS / 32;
constexpr int MAX_LEAVES = 48;

// one leaf; ops/adam.py::Leaf is the same layout
struct Leaf {
  const void* src;  // member 0's element (0, 0)
  void* dst;        // member 0's packed rows, or null
  int src_member;   // elements between members
  int dst_member;
  int s0;           // source stride of a row
  int s1, s2;       // column c: (c / d2) * s1 + (c % d2) * s2
  int rows, cols, d2;
  int n;            // elements a member
  int bf16;         // 1: bf16 source and destination, 0: float32
  int first_tile;   // its first tile's number
  int col_tiles;    // tiles across its columns
};
static_assert(sizeof(Leaf) == 64, "Leaf must match ops/adam.py");

struct Table {
  Leaf leaf[MAX_LEAVES];
  int count;
};

template <bool BF16>
__device__ __forceinline__ float load_wide(const void* base, long long i) {
  if (BF16) {
    return __uint_as_float(static_cast<uint32_t>(static_cast<const uint16_t*>(base)[i])
                           << 16);
  }
  return static_cast<const float*>(base)[i];
}

// x came from load_wide<BF16>: its bits go back unchanged
template <bool BF16>
__device__ __forceinline__ void store_narrow(void* base, long long i, float x) {
  if (BF16) {
    static_cast<uint16_t*>(base)[i] = static_cast<uint16_t>(__float_as_uint(x) >> 16);
  } else {
    static_cast<float*>(base)[i] = x;
  }
}

__device__ __forceinline__ long long col_offset(const Leaf& L, int c) {
  if (L.d2 == L.cols) return static_cast<long long>(c) * L.s2;
  return static_cast<long long>(c / L.d2) * L.s1 + static_cast<long long>(c % L.d2) * L.s2;
}

__device__ __forceinline__ bool inside(const Leaf& L, int r, int c) {
  return r < L.rows && c < L.cols && static_cast<long long>(r) * L.cols + c < L.n;
}

// a[0] of a[t] += a[t + w], w = THREADS/2 .. 1, with a[t] = acc; thread 0
// holds it
__device__ __forceinline__ float tree_sum(float acc, float* red) {
  const int t = threadIdx.x;
  red[t] = acc;
  __syncthreads();
#pragma unroll
  for (int w = THREADS / 2; w >= 32; w /= 2) {
    if (t < w) red[t] = __fadd_rn(red[t], red[t + w]);
    __syncthreads();
  }
  float v = 0.f;
  if (t < 32) {
    v = red[t];
#pragma unroll
    for (int w = 16; w >= 1; w /= 2) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, w));
  }
  return v;
}

template <bool BF16>
__device__ __forceinline__ void tile(const Leaf& L, int member, int j, float* partial) {
  __shared__ float sm[TILE_C][TILE_R + 1];
  __shared__ float red[THREADS];
  const int t = threadIdx.x;
  const int tr = j / L.col_tiles;
  const int r0 = tr * TILE_R, c0 = (j - tr * L.col_tiles) * TILE_C;
  const long long src = static_cast<long long>(member) * L.src_member;
  const int c = c0 + t % TILE_C, q = t / TILE_C;
  float x[PER_THREAD];
  if (L.s0 == 1 && L.s2 != 1) {
    // rows are the source's fastest dim: a warp reads 32 rows of a column
    const int lane = t % 32, w = t / 32, r = r0 + lane;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int cc = c0 + w + WARPS * k;
      x[k] = inside(L, r, cc) ? load_wide<BF16>(L.src, src + r + col_offset(L, cc)) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) sm[w + WARPS * k][lane] = x[k];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) x[k] = sm[t % TILE_C][q + ROW_STEP * k];
  } else {
    const long long coff = c < L.cols ? col_offset(L, c) : 0;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int r = r0 + q + ROW_STEP * k;
      x[k] = inside(L, r, c)
                 ? load_wide<BF16>(L.src, src + static_cast<long long>(r) * L.s0 + coff)
                 : 0.f;
    }
  }
  const long long dst = static_cast<long long>(member) * L.dst_member;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int r = r0 + q + ROW_STEP * k;
    if (!inside(L, r, c)) continue;
    acc = __fadd_rn(acc, __fmul_rn(x[k], x[k]));
    if (L.dst) store_narrow<BF16>(L.dst, dst + static_cast<long long>(r) * L.cols + c, x[k]);
  }
  const float s = tree_sum(acc, red);
  if (t == 0) *partial = s;
}

__global__ void __launch_bounds__(THREADS)
norm_tiles_kernel(const __grid_constant__ Table table, float* __restrict__ partials,
                  int n_tiles) {
  const int i = blockIdx.x, member = blockIdx.y;
  int lo = 0, hi = table.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (table.leaf[mid].first_tile <= i) lo = mid; else hi = mid - 1;
  }
  const Leaf& L = table.leaf[lo];
  float* partial = partials + static_cast<long long>(member) * n_tiles + i;
  if (L.bf16) {
    tile<true>(L, member, i - L.first_tile, partial);
  } else {
    tile<false>(L, member, i - L.first_tile, partial);
  }
}

__global__ void __launch_bounds__(THREADS)
norm_finish_kernel(const float* __restrict__ partials, int n_tiles, float* __restrict__ sq,
                   float* __restrict__ g_norm) {
  __shared__ float red[THREADS];
  const int member = blockIdx.x;
  const float* row = partials + static_cast<long long>(member) * n_tiles;
  float acc = 0.f;
  for (int i = threadIdx.x; i < n_tiles; i += THREADS) acc = __fadd_rn(acc, row[i]);
  const float s = tree_sum(acc, red);
  if (threadIdx.x == 0) {
    sq[member] = s;
    g_norm[member] = __fsqrt_rn(s);
  }
}

struct Consts {
  float clip, wd, b1, one_minus_b1, b2, one_minus_b2, neg_lr, eps;
};

struct Member {
  float g_norm, bc1, bc2;
  bool scale;  // the gradient is over the clip: scale it to the clip
};

__device__ __forceinline__ void update1(float& p, float& m, float& v, float g,
                                        const Consts& q, const Member& w) {
  if (w.scale) g = __fmul_rn(__fdiv_rn(g, w.g_norm), q.clip);
  g = __fadd_rn(g, __fmul_rn(q.wd, p));
  const float m2 = __fadd_rn(__fmul_rn(q.one_minus_b1, g), __fmul_rn(q.b1, m));
  const float v2 =
      __fadd_rn(__fmul_rn(q.one_minus_b2, __fmul_rn(g, g)), __fmul_rn(q.b2, v));
  const float d = __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, w.bc2)), q.eps);
  p = __fadd_rn(p, __fmul_rn(q.neg_lr, __fdiv_rn(__fdiv_rn(m2, w.bc1), d)));
  m = m2;
  v = v2;
}

__global__ void __launch_bounds__(THREADS)
adam_kernel(float* __restrict__ p, float* __restrict__ m, float* __restrict__ v,
            const float* __restrict__ g, const float* __restrict__ g_norm,
            const float* __restrict__ bc1, const float* __restrict__ bc2,
            const uint8_t* __restrict__ finite, long long n, long long stride, int vec,
            Consts q) {
  const int t = blockIdx.y;
  if (!finite[t]) return;
  Member w;
  w.g_norm = g_norm[t];
  w.bc1 = bc1[t];
  w.bc2 = bc2[t];
  w.scale = !(w.g_norm < q.clip);
  const long long row = t * stride;
  float* p_row = p + row;
  float* m_row = m + row;
  float* v_row = v + row;
  const float* g_row = g + row;
  const long long first = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * THREADS;
  long long done = 0;
  if (vec) {
    const long long n4 = n / 4;
    for (long long i = first; i < n4; i += step) {
      float4 pp = reinterpret_cast<const float4*>(p_row)[i];
      float4 mm = reinterpret_cast<const float4*>(m_row)[i];
      float4 vv = reinterpret_cast<const float4*>(v_row)[i];
      const float4 gg = reinterpret_cast<const float4*>(g_row)[i];
      update1(pp.x, mm.x, vv.x, gg.x, q, w);
      update1(pp.y, mm.y, vv.y, gg.y, q, w);
      update1(pp.z, mm.z, vv.z, gg.z, q, w);
      update1(pp.w, mm.w, vv.w, gg.w, q, w);
      reinterpret_cast<float4*>(p_row)[i] = pp;
      reinterpret_cast<float4*>(m_row)[i] = mm;
      reinterpret_cast<float4*>(v_row)[i] = vv;
    }
    done = n4 * 4;
  }
  for (long long e = done + first; e < n; e += step) {
    float pe = p_row[e], me = m_row[e], ve = v_row[e];
    update1(pe, me, ve, g_row[e], q, w);
    p_row[e] = pe;
    m_row[e] = me;
    v_row[e] = ve;
  }
}

}  // namespace

// leaves: `count` Leaf records in host memory (copied into the launch's
// parameters); partials: float32 (members, n_tiles); sq, g_norm: float32
// (members).
extern "C" int lesionvae_grad_sq_norm(const void* leaves, int count, int members,
                                      int n_tiles, void* partials, void* sq,
                                      void* g_norm, void* stream) {
  if (count <= 0 || count > MAX_LEAVES || members <= 0 || members > 65535 ||
      n_tiles <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table table;
  memset(&table, 0, sizeof(table));
  memcpy(table.leaf, leaves, static_cast<size_t>(count) * sizeof(Leaf));
  table.count = count;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  norm_tiles_kernel<<<dim3(static_cast<unsigned>(n_tiles), static_cast<unsigned>(members)),
                      THREADS, 0, s>>>(table, static_cast<float*>(partials), n_tiles);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  norm_finish_kernel<<<members, THREADS, 0, s>>>(
      static_cast<const float*>(partials), n_tiles, static_cast<float*>(sq),
      static_cast<float*>(g_norm));
  return static_cast<int>(cudaGetLastError());
}

// p, m, v, g: float32 (members, n) with `stride` elements between rows,
// 16-byte aligned; vec: 1 when the stride is a multiple of 4 (16-byte loads),
// else 0; g_norm, bc1, bc2: float32 (members); finite: one byte a member.
extern "C" int lesionvae_adam_step(void* p, void* m, void* v, const void* g,
                                   const void* g_norm, const void* bc1, const void* bc2,
                                   const void* finite, int members, long long n,
                                   long long stride, int vec, float clip, float wd,
                                   float b1, float one_minus_b1, float b2,
                                   float one_minus_b2, float neg_lr, float eps,
                                   void* stream) {
  if (members <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (members > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const long long per_thread = vec ? 4 : 1;
  long long blocks = (n / per_thread + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;  // the scalar tail still needs threads
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;  // grid-stride covers the rest
  const Consts q{clip, wd, b1, one_minus_b1, b2, one_minus_b2, neg_lr, eps};
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(members));
  adam_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<float*>(m), static_cast<float*>(v),
      static_cast<const float*>(g), static_cast<const float*>(g_norm),
      static_cast<const float*>(bc1), static_cast<const float*>(bc2),
      static_cast<const uint8_t*>(finite), n, stride, vec, q);
  return static_cast<int>(cudaGetLastError());
}

// out: 9 ints, for norm_tiles_kernel, norm_finish_kernel and adam_kernel in
// turn: registers a thread, local memory bytes a thread, static shared
// memory bytes a block.
extern "C" int lesionvae_adam_attributes(int* out) {
  const void* fns[3] = {reinterpret_cast<const void*>(norm_tiles_kernel),
                        reinterpret_cast<const void*>(norm_finish_kernel),
                        reinterpret_cast<const void*>(adam_kernel)};
  for (int i = 0; i < 3; ++i) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, fns[i]);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[3 * i] = a.numRegs;
    out[3 * i + 1] = static_cast<int>(a.localSizeBytes);
    out[3 * i + 2] = static_cast<int>(a.sharedSizeBytes);
  }
  return 0;
}
