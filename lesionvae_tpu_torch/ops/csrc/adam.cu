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
//    - in a tile, logical lane t (of 256) takes the elements of column
//      t % 64 in rows t / 64 + 4k, k = 0..7, and adds their squares one
//      after another to +0 (an element outside the leaf adds nothing, or
//      adds +0: the same bits);
//    - the 256 lanes' sums are added in a tree: a[t] += a[t + w] for
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
// - gather: a warp a (member, tile), WARPS warps a block, the blocks in
//   tile order (g = member * n_tiles + tile), so the card holds a window of
//   consecutive tiles at once.  Lane i of the warp takes the tile's columns
//   2i and 2i + 1 in all 32 rows: the 8 logical lanes b + 2i + 64q (b = 0,
//   1; q = 0..3) of the sum's order.  It issues all its loads, straight
//   into registers, before it uses one: where a leaf's rows are the
//   source's fastest dim (the dense and convolution weights' gradients as
//   autograd returns them), each column's 32 rows in 16-byte loads where
//   every column starts 16-byte aligned; else each row's two columns as one
//   bf16x2 or float2 load where every row starts at an even element; else
//   element by element.  The tree's first two levels (w = 128, 64) are the
//   lane's own adds, the next five warp shuffles, the last its two
//   columns' add: the order above with no shared memory and no barrier.
//   The lane stores its two columns of a row into the packed destination as
//   one bf16x2 or float2 where every packed row starts at an even element,
//   else one element at a time.  Each leaf's routes are worked out on the
//   host (ops/adam.py::leaf_route).  The leaf table (pointers, strides,
//   shapes, routes) is a kernel parameter, so nothing is copied to the
//   device at a launch and the launch captures into a CUDA graph
//   (__grid_constant__: read in place, never copied to a thread's local
//   memory); a warp finds its tile's leaf by a binary search over the
//   leaves' first tiles.  At its 90 registers a thread the card holds two
//   8-warp blocks an SM: 16 tiles' loads in flight (128 KB float32, 64 KB
//   bf16).  Staging tiles through a shared-memory ring with cp.async, a
//   warp taking 64-row pairs in bf16, and more or fewer tiles an SM all
//   measured slower (PERF.md, Findings).
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

constexpr int THREADS = 256;  // a tile's logical lanes; the finishing block's threads
constexpr int TILE_R = 32;
constexpr int TILE_C = 64;
constexpr int WARPS = 8;      // warps (tiles) a block of the gather
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
  int rows_fast;    // 1: rows are the source's fastest dim (loaded down the columns)
  int src_vec;      // elements a load: 16 bytes' worth down a column, a pair along a row, or 1
  int dst_vec;      // elements a destination store: 2 (bf16x2, float2) or 1
};
static_assert(sizeof(Leaf) == 80, "Leaf must match ops/adam.py");

struct Table {
  Leaf leaf[MAX_LEAVES];
  int count;
};
static_assert(sizeof(Table) + 32 <= 4096, "the table must fit a kernel's parameters");

__device__ __forceinline__ long long col_offset(const Leaf& L, int c) {
  if (L.d2 == L.cols) return static_cast<long long>(c) * L.s2;
  return static_cast<long long>(c / L.d2) * L.s1 + static_cast<long long>(c % L.d2) * L.s2;
}

// raw bits of element i of a bf16 or float32 array
template <bool BF16>
__device__ __forceinline__ uint32_t load1(const void* base, long long i) {
  if (BF16) return __ldg(static_cast<const unsigned short*>(base) + i);
  return __ldg(static_cast<const unsigned int*>(base) + i);
}

// the raw bits of two elements (b0, b1: 16-bit values in bf16) into the
// packed destination at p: one store where `pair`, else those in the leaf
template <bool BF16>
__device__ __forceinline__ void store_pair(unsigned char* p, bool pair, bool ok0, bool ok1,
                                           uint32_t b0, uint32_t b1) {
  if (BF16) {
    unsigned short* q = reinterpret_cast<unsigned short*>(p);
    if (pair) {
      *reinterpret_cast<uint32_t*>(q) = b0 | (b1 << 16);
    } else {
      if (ok0) q[0] = static_cast<unsigned short>(b0);
      if (ok1) q[1] = static_cast<unsigned short>(b1);
    }
  } else {
    uint32_t* q = reinterpret_cast<uint32_t*>(p);
    if (pair) {
      *reinterpret_cast<uint2*>(q) = make_uint2(b0, b1);
    } else {
      if (ok0) q[0] = b0;
      if (ok1) q[1] = b1;
    }
  }
}

// the tree of a tile's 256 logical lanes from lane-held sums a[q][b] of
// logical lane b + 2 * lane + 64q: w = 128 and 64 in the lane, 32 .. 2
// across lanes, 1 in the lane; lane 0 holds the tile's partial
__device__ __forceinline__ float lane_tree(float (&a)[4][2]) {
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    a[0][b] = __fadd_rn(a[0][b], a[2][b]);
    a[1][b] = __fadd_rn(a[1][b], a[3][b]);
    a[0][b] = __fadd_rn(a[0][b], a[1][b]);
#pragma unroll
    for (int w = 16; w >= 1; w /= 2)
      a[0][b] = __fadd_rn(a[0][b], __shfl_down_sync(0xffffffffu, a[0][b], w));
  }
  return __fadd_rn(a[0][0], a[0][1]);
}

__device__ __forceinline__ void add_square(float& a, float x) {
  a = __fadd_rn(a, __fmul_rn(x, x));
}

// Tile j of leaf L of `member`, the leaf's rows loaded along them: lane
// `lane` takes columns c = c0 + 2 * lane and c + 1 of the tile's rows (+0
// outside the leaf), stores them into the packed rows and returns the
// tile's partial on lane 0.  bf16 values stay two columns a register.
template <bool BF16>
__device__ __forceinline__ float gather_rows(const Leaf& L, int member, int j, int lane) {
  constexpr int E = BF16 ? 2 : 4;  // bytes an element
  const int tr = j / L.col_tiles;
  const int r0 = tr * TILE_R, c = (j - tr * L.col_tiles) * TILE_C + 2 * lane;
  const int nr = L.rows - r0 < TILE_R ? L.rows - r0 : TILE_R;  // rows of the tile in the leaf
  // a leaf of one dim ends inside its last row: that row holds n - last * cols
  const int last = (L.n - 1) / L.cols, tail = L.n - last * L.cols;
  // element (r, cc) at src + r * s0 + col_offset(cc); column c + 1 lies
  // step1 elements after column c (one, where src_vec says pairs)
  const long long o0 = c < L.cols ? col_offset(L, c) : 0;
  const long long step1 = (c + 1 < L.cols ? col_offset(L, c + 1) : 0) - o0;
  const unsigned char* p = static_cast<const unsigned char*>(L.src) +
                           (static_cast<long long>(member) * L.src_member +
                            static_cast<long long>(r0) * L.s0 + o0) * E;
  uint32_t x0[TILE_R], x1[TILE_R];  // (r0 + r, c) and (r0 + r, c + 1); bf16: both in x0[r]
#pragma unroll
  for (int r = 0; r < TILE_R; ++r) {
    x0[r] = x1[r] = 0u;
    if (r < nr) {
      const int lim = r0 + r == last ? tail : L.cols;
      const bool ok0 = c < lim, ok1 = c + 1 < lim;
      if (ok1 && L.src_vec == 2) {
        if (BF16) {
          x0[r] = __ldg(reinterpret_cast<const unsigned int*>(p));
        } else {
          const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
          x0[r] = w.x;
          x1[r] = w.y;
        }
      } else {
        const uint32_t v0 = ok0 ? load1<BF16>(p, 0) : 0u;
        const uint32_t v1 = ok1 ? load1<BF16>(p, step1) : 0u;
        if (BF16) {
          x0[r] = v0 | (v1 << 16);
        } else {
          x0[r] = v0;
          x1[r] = v1;
        }
      }
    }
    p += static_cast<long long>(L.s0) * E;
  }
  float a[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int r = 0; r < TILE_R; ++r) {  // logical lane b + 2 * lane + 64q takes row 4k + q
    add_square(a[r % 4][0], __uint_as_float(BF16 ? x0[r] << 16 : x0[r]));
    add_square(a[r % 4][1], __uint_as_float(BF16 ? x0[r] & 0xffff0000u : x1[r]));
  }
  if (L.dst) {
    unsigned char* d = static_cast<unsigned char*>(L.dst) +
                       (static_cast<long long>(member) * L.dst_member +
                        static_cast<long long>(r0) * L.cols + c) * E;
#pragma unroll
    for (int r = 0; r < TILE_R; ++r) {
      if (r < nr) {
        const int lim = r0 + r == last ? tail : L.cols;
        const bool ok0 = c < lim, ok1 = c + 1 < lim;
        store_pair<BF16>(d, ok1 && L.dst_vec == 2, ok0, ok1,
                         BF16 ? x0[r] & 0xffffu : x0[r], BF16 ? x0[r] >> 16 : x1[r]);
      }
      d += static_cast<long long>(L.cols) * E;
    }
  }
  return lane_tree(a);
}

// Tile j of leaf L of `member`, the leaf's rows the source's fastest dim:
// lane `lane` loads columns c = c0 + 2 * lane and c + 1 down the tile's 32
// rows (16-byte loads where src_vec says so, +0 outside the leaf), keeping
// bf16 values two rows a register; stores them into the packed rows and
// returns the tile's partial on lane 0.
template <bool BF16>
__device__ __forceinline__ float gather_cols(const Leaf& L, int member, int j, int lane) {
  constexpr int E = BF16 ? 2 : 4;  // bytes an element
  constexpr int VW = 16 / E;       // elements a 16-byte load
  constexpr int PER = 4 / E;       // elements a register
  const int tr = j / L.col_tiles;
  const int r0 = tr * TILE_R, c = (j - tr * L.col_tiles) * TILE_C + 2 * lane;
  const bool ok0 = c < L.cols, ok1 = c + 1 < L.cols;
  const long long src = static_cast<long long>(member) * L.src_member + r0;
  const unsigned char* p0 = static_cast<const unsigned char*>(L.src) +
                            (src + (ok0 ? col_offset(L, c) : 0)) * E;  // element (r0, c)
  const unsigned char* p1 = static_cast<const unsigned char*>(L.src) +
                            (src + (ok1 ? col_offset(L, c + 1) : 0)) * E;
  const int nr = L.rows - r0;  // rows of the leaf from r0 (may exceed TILE_R)
  uint32_t w0[TILE_R / PER], w1[TILE_R / PER];  // word k: rows k * PER .. of c, c + 1
#pragma unroll
  for (int k = 0; k < TILE_R / PER; ++k) w0[k] = w1[k] = 0u;
#pragma unroll
  for (int v = 0; v < TILE_R / VW; ++v) {
    if (L.src_vec > 1 && v * VW + VW <= nr) {
      if (ok0) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(p0) + v);
        w0[4 * v] = q.x; w0[4 * v + 1] = q.y; w0[4 * v + 2] = q.z; w0[4 * v + 3] = q.w;
      }
      if (ok1) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(p1) + v);
        w1[4 * v] = q.x; w1[4 * v + 1] = q.y; w1[4 * v + 2] = q.z; w1[4 * v + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int m = 0; m < VW; ++m) {
        const int r = v * VW + m, sh = BF16 ? 16 * (r % 2) : 0;
        if (r < nr) {
          if (ok0) w0[r / PER] |= load1<BF16>(p0, r) << sh;
          if (ok1) w1[r / PER] |= load1<BF16>(p1, r) << sh;
        }
      }
    }
  }
  // row r's value as float bits: a bf16 word's high half masked, or its low
  // half shifted up; a float32 word as it is
#define ROW_BITS(w, r) \
  (BF16 ? ((r) % 2 ? (w)[(r) / 2] & 0xffff0000u : (w)[(r) / 2] << 16) : (w)[(r)])
  float a[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int r = 0; r < TILE_R; ++r) {  // logical lane b + 2 * lane + 64q takes row 4k + q
    add_square(a[r % 4][0], __uint_as_float(ROW_BITS(w0, r)));
    add_square(a[r % 4][1], __uint_as_float(ROW_BITS(w1, r)));
  }
  if (L.dst) {
    unsigned char* d = static_cast<unsigned char*>(L.dst) +
                       (static_cast<long long>(member) * L.dst_member +
                        static_cast<long long>(r0) * L.cols + c) * E;
    const bool pair = ok1 && L.dst_vec == 2;
#pragma unroll
    for (int r = 0; r < TILE_R; ++r) {
      if (r < nr) {
        store_pair<BF16>(d, pair, ok0, ok1, BF16 ? ROW_BITS(w0, r) >> 16 : w0[r],
                         BF16 ? ROW_BITS(w1, r) >> 16 : w1[r]);
      }
      d += static_cast<long long>(L.cols) * E;
    }
  }
#undef ROW_BITS
  return lane_tree(a);
}

__global__ void __launch_bounds__(WARPS * 32)
norm_tiles_kernel(const __grid_constant__ Table table, float* __restrict__ partials,
                  int n_tiles, int total) {
  const int lane = threadIdx.x % 32;
  const int g = blockIdx.x * WARPS + threadIdx.x / 32;  // (member, tile) of this warp
  if (g >= total) return;
  const int member = g / n_tiles, i = g - member * n_tiles;
  int lo = 0, hi = table.count - 1;  // the leaf: the last whose first tile is at most i
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (table.leaf[mid].first_tile <= i) lo = mid; else hi = mid - 1;
  }
  const Leaf& L = table.leaf[lo];
  const int j = i - L.first_tile;
  float s;
  if (L.rows_fast) {
    s = L.bf16 ? gather_cols<true>(L, member, j, lane) : gather_cols<false>(L, member, j, lane);
  } else {
    s = L.bf16 ? gather_rows<true>(L, member, j, lane) : gather_rows<false>(L, member, j, lane);
  }
  if (lane == 0) partials[g] = s;  // (member, tile) of the (T, n_tiles) workspace
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
// leaves: `count` Leaf records in host memory (copied into the launch's
// parameters); partials: float32 (members, n_tiles); sq, g_norm: float32
// (members).
extern "C" int lesionvae_grad_sq_norm(const void* leaves, int count, int members,
                                      int n_tiles, void* partials, void* sq,
                                      void* g_norm, void* stream) {
  const long long total = static_cast<long long>(members) * n_tiles;
  if (count <= 0 || count > MAX_LEAVES || members <= 0 || n_tiles <= 0 ||
      total > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table table;
  memset(&table, 0, sizeof(table));
  memcpy(table.leaf, leaves, static_cast<size_t>(count) * sizeof(Leaf));
  table.count = count;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((total + WARPS - 1) / WARPS);
  norm_tiles_kernel<<<blocks, WARPS * 32, 0, s>>>(table, static_cast<float*>(partials),
                                                  n_tiles, static_cast<int>(total));
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

// blocks of the gather an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the error
extern "C" int lesionvae_norm_blocks_per_sm() {
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, norm_tiles_kernel, WARPS * 32, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
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
