// The fleet's member-batched convolutions, Conv1d and ConvTranspose1d with
// k = 5, padding 2, stride 1, forward and backward, as hand-written Hopper
// (sm_90a) kernels on channel-last activations.
//
// Replaces what XLA compiles on the TPU, where no Pallas kernel exists:
// nn.Conv in lesionvae_tpu/models/layers.py:165-213 (Conv1d, and
// ConvTranspose1d as a convolution with the kernel flipped) under the fleet
// step's jax.vmap (lesionvae_tpu/train/batched.py:241).  The plain PyTorch
// version (ops/conv1d.py::conv1d_plain) pads, unfolds the k shifted copies
// into a column buffer and runs one batched product; these kernels write
// no column buffer.
//
// For member t of T, x (N, L, C_in) read through its strides, the weight w
// read through its strides as (T, C_in, C_out) at each tap k (a Conv1d
// leaf (T, out, in, 5) read at tap k, a ConvTranspose1d leaf (T, in, out, 5)
// at tap 4 - k):
//
//   y[n, l, o] = b[o] + sum_{k, i} x[n, l + k - 2, i] * W_k[i, o]
//
// with x = 0 outside 0 <= l + k - 2 < L.
//
// 1. conv_fwd: the forward, and the input gradient: dx is the convolution
//    of dy with the kernel flipped along k and transposed in (in, out), so
//    the same kernel takes dy, the leaf's strides swapped and the flip
//    negated, and no bias.  An implicit GEMM: a block takes BM rows of one
//    member (rows are (n, l), n outer; bf16 256) and BN output channels
//    (16, 32 or 64, by C_out; float32: the tile of f32_tile, below).  The
//    rows it needs, its own and the two-row
//    halo of each sample in it, are one contiguous range of the member's
//    padded rows (each sample with two zero rows before and after it), so
//    they are staged into shared memory, the halo's zeros written by the
//    load, BK = 16 input channels at a time with the weight's 5 x 16 x BN
//    tile; output row r at tap k reads staged row P(r) - P(r0) + k, where
//    P(r) = n (L + 4) + l + 2.
//    - float32: FP32 FMA on the CUDA cores, each thread TM rows x 8
//      channels in registers (two groups of 4, one in each half of the
//      tile, so that 8 neighbouring threads read 128 contiguous bytes of
//      the weight tile), summed in the order (chunk of 16 input channels,
//      tap, channel).  The full tile, 256 threads of 4 rows (BM = 8192 /
//      BN), where its grid gives every SM a block; a smaller grid (few
//      members: the single VAE's T = 1) takes 16 channels and fewer rows a
//      block, so that the grid reaches the SMs.  Rows and channels are only
//      cut otherwise among blocks and threads: every tile sums each output
//      in the same order, to the same bits.
//    - bf16: mma.sync m16n8k16 with float32 accumulation, 8 warps each
//      32 rows x BN channels, A and B fragments by ldmatrix (a lane gives
//      its row's address, so the padded-row indirection costs nothing).
//    The bias is added in the epilogue and the output rounded once.
// 2. conv_wgrad: dW_k[i, o] = sum over the member's N * L rows of
//    x[row shifted by k - 2, i] * dy[row, o], and db[o] = sum dy[row, o].
//    A block takes one member, a tile of output channels and of input
//    channels (all 5 taps) and one of `splits` contiguous ranges of rows,
//    staged 64 rows at a time (bf16: 256); it writes float32 partials, and a finishing
//    launch adds each output's `splits` partials in split order and writes
//    dw straight into the leaf's own layout (T, out, in, 5) or
//    (T, in, out, 5), and db, rounded once to the compute dtype.  No
//    atomics: the order is fixed by the shapes, so two calls give the same
//    bits.  db is summed in float64 (one add a row and output channel, off
//    the hot loop), so it is the exact sum rounded once or twice.
//    - float32: 8 output channels x 1 input channel x 5 taps a thread, each
//      stage's 64 rows summed in row order into registers of their own and
//      then added to the total (a two-level sum over the long reductions).
//    - bf16: mma.sync, A = dy^T by ldmatrix.trans from the staged rows of
//      dy, B = the shifted x rows by ldmatrix.trans; a warp 32 x 16 x 5.
//
// What bounds them: in float32, the FP32 operations (2 a multiply-add, 67
// TFLOP/s); the bytes (each tensor once, at 3.35 TB/s) take a quarter of
// that time.  In bf16 on the tensor cores, the bytes.  This first version is
// simple: no wgmma, no TMA, no ring of stages; a block stages a chunk,
// synchronises and computes, and the blocks an SM holds overlap each
// other's loads.
//
// Interface: plain C, loaded with ctypes (ops/conv1d.py); each entry point
// returns the cudaError_t of its launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TAPS = 5;
constexpr int BF16_ROWS = 256;        // rows a bf16 conv_fwd block
constexpr int BK = 16;                // input channels a staged chunk
constexpr int F32_THREADS = 256;      // the full float32 conv_fwd tile's threads,
constexpr int F32_TM = 4;             // its rows a thread,
constexpr int F32_TN = 8;             // and every float32 conv_fwd tile's channels a thread
constexpr int SMS = 132;              // the H100's SMs
constexpr int BF16_THREADS = 128;     // a bf16 conv_wgrad block
constexpr int FWD_BF16_WARPS = 8;
constexpr int F32_ROW = 20;           // a staged float32 row: 16 channels + 4 (80 bytes)
constexpr int BF16_ROW = 24;          // a staged bf16 row: 16 channels + 8 (48 bytes)
constexpr int WG_BR = 64;             // rows a wgrad stage
constexpr int WG_BI = 16;             // input channels a float32 wgrad block
constexpr int WG_TO = 8;              // output channels a float32 wgrad thread
constexpr int WH_BO = 64;             // output channels a bf16 wgrad block
constexpr int WH_BI = 32;             // input channels a bf16 wgrad block
constexpr int WH_BR = 256;            // rows a bf16 wgrad stage
constexpr int WH_DROW = WH_BO + 8;    // a staged bf16 dy row (144 bytes)
constexpr int WH_XROW = WH_BI + 8;    // a staged bf16 x row (80 bytes)
constexpr int FINISH_THREADS = 256;
constexpr int MAX_SHARED = 232448;    // dynamic shared memory a block can use

struct Geometry {
  int N, L, R;       // samples, length, rows a member (N * L)
  int Cin, Cout;
};

// an activation (T, N, L, C) read through its element strides
struct Act {
  long long member;
  int n, l, c;
};

// a weight read as (T, C_in, C_out) at each tap
struct Weight {
  long long member, in, out, tap;
  int flip;          // 1: tap k reads the leaf at 4 - k
};

// rows a float32 conv_fwd block takes: bn / F32_TN threads side by side
// along the output channels, each F32_TN channels x tm rows
__host__ __device__ constexpr int f32_rows(int bn, int tm, int threads) {
  return threads / (bn / F32_TN) * tm;
}

__host__ __device__ constexpr int staged_rows(int rows, int L) {
  return rows + 4 + 4 * ((rows - 1 + L - 1) / L);
}

__device__ __forceinline__ int padded(int r, int L) {
  const int n = r / L;
  return n * (L + 4) + (r - n * L) + 2;
}

// element offset inside a member of padded row p, or -1 for a zero row
__device__ __forceinline__ int source_offset(int p, const Geometry& g, const Act& a) {
  const int n = p / (g.L + 4);
  const int l = p - n * (g.L + 4) - 2;
  return (n < g.N && l >= 0 && l < g.L) ? n * a.n + l * a.l : -1;
}

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero<bf16>() { return __ushort_as_bfloat16(0); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// rows [0, rows) of the staged x: CH channels from c0, ROW elements
// between staged rows; zero rows and channels past C_in are written as 0.
// vec: a thread moves 16 bytes (channels contiguous, every row start and
// C_in a whole number of 16-byte vectors)
template <typename T, int CH, int ROW>
__device__ __forceinline__ void stage_x(T* xs, const int* src, int rows, const T* hm,
                                        int c_stride, int cin, int c0, int vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    constexpr int PER = CH / V;
    for (int e = threadIdx.x; e < rows * PER; e += blockDim.x) {
      const int s = e / PER, q = e - s * PER, c = c0 + q * V;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (src[s] >= 0 && c < cin) v = __ldg(reinterpret_cast<const uint4*>(hm + src[s] + c));
      *reinterpret_cast<uint4*>(xs + s * ROW + q * V) = v;
    }
  } else {
    for (int e = threadIdx.x; e < rows * CH; e += blockDim.x) {
      const int s = e / CH, cc = e - s * CH, c = c0 + cc;
      T v = zero<T>();
      if (src[s] >= 0 && c < cin) v = hm[src[s] + static_cast<long long>(c) * c_stride];
      xs[s * ROW + cc] = v;
    }
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the weight tile of one chunk, 0 outside the weight: ws[k][c][o] with
// ROW elements between rows (the float32 kernel's rows of output channels,
// padded to ROW = BN + 4) or, OUT_MAJOR, ws[k][o][c] (the bf16 kernel's B
// fragments by ldmatrix).  A thread takes one (input, output) channel pair
// and its 5 taps; neighbouring threads take neighbouring channels along the
// leaf's smaller stride, so a warp's loads share lines
template <typename T, int BN, int ROW, bool OUT_MAJOR>
__device__ __forceinline__ void stage_w(T* ws, const T* wm, const Weight& w, int c0, int n0,
                                        const Geometry& g) {
  const bool c_fast = w.in <= w.out;
  for (int e = threadIdx.x; e < BK * BN; e += blockDim.x) {
    const int c = c_fast ? e % BK : e / BN, o = c_fast ? e / BK : e % BN;
    const bool inside = c0 + c < g.Cin && n0 + o < g.Cout;
    const T* src = wm + (c0 + c) * w.in + (n0 + o) * w.out;
#pragma unroll
    for (int k = 0; k < TAPS; ++k) {
      const T v = inside ? src[(w.flip ? TAPS - 1 - k : k) * w.tap] : zero<T>();
      ws[OUT_MAJOR ? (k * BN + o) * ROW + c : (k * BK + c) * ROW + o] = v;
    }
  }
}

// ------------------------------------------------------------ conv_fwd
template <int BN, int TM, int THREADS>
__global__ void __launch_bounds__(THREADS)
    conv_fwd_f32(const float* __restrict__ h, Act ha, int hvec, const float* __restrict__ w,
                 Weight wt, const float* __restrict__ bias, long long bias_member,
                 float* __restrict__ y, Geometry g) {
  constexpr int BM = f32_rows(BN, TM, THREADS), TN = F32_TN;
  constexpr int TX = BN / TN, TY = THREADS / TX;
  constexpr int WROW = BN + 4;   // a staged weight row, 16-byte aligned
  static_assert(TX * TY == THREADS && TY * TM == BM, "a block's rows");
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.z, r0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int r_end = min(r0 + BM, g.R);
  const int p0 = padded(r0, g.L) - 2;
  const int rows = padded(r_end - 1, g.L) - p0 + 3;
  float* ws = reinterpret_cast<float*>(smem);
  float* xs = ws + TAPS * BK * WROW;
  int* src = reinterpret_cast<int*>(xs + staged_rows(BM, g.L) * F32_ROW);
  const float* hm = h + t * ha.member;
  const float* wm = w + t * wt.member;
  for (int s = threadIdx.x; s < rows; s += THREADS) src[s] = source_offset(p0 + s, g, ha);

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  int xrow[TM];
#pragma unroll
  for (int j = 0; j < TM; ++j) {
    const int r = min(r0 + ty + j * TY, r_end - 1);
    xrow[j] = (padded(r, g.L) - p0 - 2) * F32_ROW;
  }
  float acc[TM][TN];
#pragma unroll
  for (int j = 0; j < TM; ++j)
#pragma unroll
    for (int i = 0; i < TN; ++i) acc[j][i] = 0.f;

  for (int c0 = 0; c0 < g.Cin; c0 += BK) {
    __syncthreads();
    stage_x<float, BK, F32_ROW>(xs, src, rows, hm, ha.c, g.Cin, c0, hvec);
    stage_w<float, BN, WROW, false>(ws, wm, wt, c0, n0, g);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TAPS; ++k) {
#pragma unroll
      for (int c = 0; c < BK; ++c) {
        float a[TM];
#pragma unroll
        for (int j = 0; j < TM; ++j) a[j] = xs[xrow[j] + k * F32_ROW + c];
        const float4 b0 = *reinterpret_cast<const float4*>(ws + (k * BK + c) * WROW + tx * 4);
        const float4 b1 =
            *reinterpret_cast<const float4*>(ws + (k * BK + c) * WROW + BN / 2 + tx * 4);
        const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int j = 0; j < TM; ++j)
#pragma unroll
          for (int i = 0; i < TN; ++i) acc[j][i] = fmaf(a[j], b[i], acc[j][i]);
      }
    }
  }

  // the thread's channels: 4 from n0 + 4 tx and 4 from n0 + BN / 2 + 4 tx
  float bv[TN];
  int co[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    co[q] = n0 + q * (BN / 2) + tx * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bv[4 * q + i] =
          (bias != nullptr && co[q] + i < g.Cout) ? bias[t * bias_member + co[q] + i] : 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < TM; ++j) {
    const int r = r0 + ty + j * TY;
    if (r >= r_end) continue;
    float* yr = y + (static_cast<long long>(t) * g.R + r) * g.Cout;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = bias != nullptr ? acc[j][4 * q + i] + bv[4 * q + i] : acc[j][4 * q + i];
      }
      if (g.Cout % 4 == 0 && co[q] + 4 <= g.Cout) {
        *reinterpret_cast<float4*>(yr + co[q]) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (co[q] + i < g.Cout) yr[co[q] + i] = v[i];
        }
      }
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(FWD_BF16_WARPS * 32)
    conv_fwd_bf16(const bf16* __restrict__ h, Act ha, int hvec, const bf16* __restrict__ w,
                  Weight wt, const bf16* __restrict__ bias, long long bias_member,
                  bf16* __restrict__ y, Geometry g) {
  constexpr int BM = BF16_ROWS, WM = BM / FWD_BF16_WARPS, MW = WM / 16, NW = BN / 8;
  static_assert(MW * 16 * FWD_BF16_WARPS == BM && NW % 2 == 0, "a warp's tiles");
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = blockIdx.z, r0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int r_end = min(r0 + BM, g.R);
  const int p0 = padded(r0, g.L) - 2;
  const int rows = padded(r_end - 1, g.L) - p0 + 3;
  bf16* ws = reinterpret_cast<bf16*>(smem);                 // [TAPS][BN][BF16_ROW]
  bf16* xs = ws + TAPS * BN * BF16_ROW;                      // [staged][BF16_ROW]
  int* src = reinterpret_cast<int*>(xs + staged_rows(BM, g.L) * BF16_ROW);
  const bf16* hm = h + t * ha.member;
  const bf16* wm = w + t * wt.member;
  for (int s = threadIdx.x; s < rows; s += blockDim.x) src[s] = source_offset(p0 + s, g, ha);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the staged row each lane addresses for ldmatrix in each m16 tile, at
  // tap 0: rows (lane & 15), channels 8 * (lane >> 4)
  uint32_t a_addr[MW];
#pragma unroll
  for (int mi = 0; mi < MW; ++mi) {
    const int r = min(r0 + warp * WM + mi * 16 + (lane & 15), r_end - 1);
    a_addr[mi] = smem_u32(xs + (padded(r, g.L) - p0 - 2) * BF16_ROW + (lane >> 4) * 8);
  }
  // B: output channels (lane & 7) + 8 (lane >> 4), input channels 8 ((lane >> 3) & 1)
  const uint32_t b_addr =
      smem_u32(ws + ((lane & 7) + (lane >> 4) * 8) * BF16_ROW + ((lane >> 3) & 1) * 8);
  float acc[MW][NW][4];
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int nj = 0; nj < NW; ++nj)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][nj][c] = 0.f;

  for (int c0 = 0; c0 < g.Cin; c0 += BK) {
    __syncthreads();
    stage_x<bf16, BK, BF16_ROW>(xs, src, rows, hm, ha.c, g.Cin, c0, hvec);
    stage_w<bf16, BN, BF16_ROW, true>(ws, wm, wt, c0, n0, g);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TAPS; ++k) {
      uint32_t b[NW][2];
#pragma unroll
      for (int p = 0; p < NW / 2; ++p) {
        uint32_t r[4];
        ldsm_x4(r, b_addr + ((k * BN + p * 16) * BF16_ROW) * 2);
        b[2 * p][0] = r[0];
        b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2];
        b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MW; ++mi) {
        uint32_t a[4];
        ldsm_x4(a, a_addr[mi] + k * BF16_ROW * 2);
#pragma unroll
        for (int nj = 0; nj < NW; ++nj) mma_bf16(acc[mi][nj], a, b[nj][0], b[nj][1]);
      }
    }
  }

  const int gq = lane >> 2, q = lane & 3;
  const bool pairs = g.Cout % 2 == 0;
#pragma unroll
  for (int nj = 0; nj < NW; ++nj) {
    const int co = n0 + nj * 8 + 2 * q;
    float bv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bv[i] = (bias != nullptr && co + i < g.Cout)
                  ? __bfloat162float(bias[t * bias_member + co + i])
                  : 0.f;
    }
#pragma unroll
    for (int mi = 0; mi < MW; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + warp * WM + mi * 16 + gq + 8 * half;
        if (r >= r_end || co >= g.Cout) continue;
        bf16* yr = y + (static_cast<long long>(t) * g.R + r) * g.Cout + co;
        const float v0 = acc[mi][nj][2 * half] + bv[0];
        const float v1 = acc[mi][nj][2 * half + 1] + bv[1];
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(yr) = __floats2bfloat162_rn(v0, v1);
        } else {
          yr[0] = __float2bfloat16_rn(v0);
          if (co + 1 < g.Cout) yr[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// ------------------------------------------------------------ conv_wgrad
// the member's rows [ra, rb) of split `blockIdx.z % splits`
__device__ __forceinline__ void split_rows(const Geometry& g, int splits, int* ra, int* rb) {
  const int sp = blockIdx.z % splits;
  *ra = static_cast<int>(static_cast<long long>(g.R) * sp / splits);
  *rb = static_cast<int>(static_cast<long long>(g.R) * (sp + 1) / splits);
}

template <int BO>
__global__ void __launch_bounds__(BO / WG_TO * WG_BI)
    conv_wgrad_f32(const float* __restrict__ h, Act ha, int hvec, const float* __restrict__ dy,
                   int dvec, float* __restrict__ part, double* __restrict__ dbpart, Geometry g,
                   int splits) {
  constexpr int THREADS = BO / WG_TO * WG_BI, DROW = BO + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int staged = staged_rows(WG_BR, g.L);
  float* dys = reinterpret_cast<float*>(smem);               // [WG_BR][DROW]
  float* xs = dys + WG_BR * DROW;                             // [staged][F32_ROW]
  int* src = reinterpret_cast<int*>(xs + staged * F32_ROW);   // [staged]
  int* srow = src + staged;                                   // [WG_BR]
  const int t = blockIdx.z / splits, sp = blockIdx.z % splits;
  const int i0 = blockIdx.x * WG_BI, o0 = blockIdx.y * BO;
  const float* hm = h + t * ha.member;
  const float* dm = dy + static_cast<long long>(t) * g.R * g.Cout;
  const int ii = threadIdx.x % WG_BI, oi = threadIdx.x / WG_BI;
  const bool with_db = blockIdx.x == 0 && threadIdx.x < BO;
  int ra, rb;
  split_rows(g, splits, &ra, &rb);
  float acc[WG_TO][TAPS];
#pragma unroll
  for (int o = 0; o < WG_TO; ++o)
#pragma unroll
    for (int k = 0; k < TAPS; ++k) acc[o][k] = 0.f;
  double db = 0.0;

  for (int rs = ra; rs < rb; rs += WG_BR) {
    const int n = min(WG_BR, rb - rs);
    const int p0 = padded(rs, g.L) - 2;
    const int rows = padded(rs + n - 1, g.L) - p0 + 3;
    __syncthreads();
    if (dvec) {
      for (int e = threadIdx.x; e < n * (BO / 4); e += THREADS) {
        const int rr = e / (BO / 4), o = (e - rr * (BO / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (o0 + o < g.Cout) {
          v = __ldg(reinterpret_cast<const float4*>(dm + (rs + rr) * g.Cout + o0 + o));
        }
        *reinterpret_cast<float4*>(dys + rr * DROW + o) = v;
      }
    } else {
      for (int e = threadIdx.x; e < n * BO; e += THREADS) {
        const int rr = e / BO, o = e - rr * BO;
        dys[rr * DROW + o] = o0 + o < g.Cout ? dm[(rs + rr) * g.Cout + o0 + o] : 0.f;
      }
    }
    for (int s = threadIdx.x; s < rows; s += THREADS) src[s] = source_offset(p0 + s, g, ha);
    for (int rr = threadIdx.x; rr < n; rr += THREADS) {
      srow[rr] = (padded(rs + rr, g.L) - p0 - 2) * F32_ROW;
    }
    __syncthreads();
    stage_x<float, WG_BI, F32_ROW>(xs, src, rows, hm, ha.c, g.Cin, i0, hvec);
    __syncthreads();
    float st[WG_TO][TAPS];
#pragma unroll
    for (int o = 0; o < WG_TO; ++o)
#pragma unroll
      for (int k = 0; k < TAPS; ++k) st[o][k] = 0.f;
#pragma unroll 4
    for (int rr = 0; rr < n; ++rr) {
      const float4 d0 = *reinterpret_cast<const float4*>(dys + rr * DROW + oi * WG_TO);
      const float4 d1 = *reinterpret_cast<const float4*>(dys + rr * DROW + oi * WG_TO + 4);
      const float d[WG_TO] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
      const int base = srow[rr] + ii;
      float x[TAPS];
#pragma unroll
      for (int k = 0; k < TAPS; ++k) x[k] = xs[base + k * F32_ROW];
#pragma unroll
      for (int o = 0; o < WG_TO; ++o)
#pragma unroll
        for (int k = 0; k < TAPS; ++k) st[o][k] = fmaf(d[o], x[k], st[o][k]);
    }
#pragma unroll
    for (int o = 0; o < WG_TO; ++o)
#pragma unroll
      for (int k = 0; k < TAPS; ++k) acc[o][k] += st[o][k];
    if (with_db) {
      for (int rr = 0; rr < n; ++rr) db += dys[rr * DROW + threadIdx.x];
    }
  }

  const int J = g.Cin * TAPS, i = i0 + ii;
  float* pm = part + (static_cast<long long>(t) * splits + sp) * g.Cout * J;
#pragma unroll
  for (int o = 0; o < WG_TO; ++o) {
    const int oo = o0 + oi * WG_TO + o;
    if (oo >= g.Cout || i >= g.Cin) continue;
#pragma unroll
    for (int k = 0; k < TAPS; ++k) pm[static_cast<long long>(oo) * J + i * TAPS + k] = acc[o][k];
  }
  if (with_db && o0 + threadIdx.x < g.Cout) {
    dbpart[(static_cast<long long>(t) * splits + sp) * g.Cout + o0 + threadIdx.x] = db;
  }
}

__global__ void __launch_bounds__(BF16_THREADS)
    conv_wgrad_bf16(const bf16* __restrict__ h, Act ha, int hvec, const bf16* __restrict__ dy,
                    int dvec, float* __restrict__ part, double* __restrict__ dbpart, Geometry g,
                    int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int staged = staged_rows(WH_BR, g.L);
  bf16* dys = reinterpret_cast<bf16*>(smem);                   // [WH_BR][WH_DROW]
  bf16* xs = dys + WH_BR * WH_DROW;                             // [staged + TAPS][WH_XROW]
  int* src = reinterpret_cast<int*>(xs + (staged + TAPS) * WH_XROW);   // [staged]
  int* srow = src + staged;                                     // [WH_BR], bytes
  const int t = blockIdx.z / splits, sp = blockIdx.z % splits;
  const int i0 = blockIdx.x * WH_BI, o0 = blockIdx.y * WH_BO;
  const bf16* hm = h + t * ha.member;
  const bf16* dm = dy + static_cast<long long>(t) * g.R * g.Cout;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wo = warp >> 1, wi = warp & 1;
  const bool with_db = blockIdx.x == 0 && threadIdx.x < WH_BO;
  int ra, rb;
  split_rows(g, splits, &ra, &rb);
  // the TAPS rows after the staged ones stay zero: a row past the stage's
  // end reads them at every tap
  for (int e = threadIdx.x; e < TAPS * WH_XROW; e += BF16_THREADS) {
    xs[staged * WH_XROW + e] = zero<bf16>();
  }
  float acc[2][2][TAPS][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int k = 0; k < TAPS; ++k)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mi][ni][k][c] = 0.f;
  double db = 0.0;
  const int m = lane >> 3;
  const uint32_t dys_u32 = smem_u32(dys), xs_u32 = smem_u32(xs);

  for (int rs = ra; rs < rb; rs += WH_BR) {
    const int n = min(WH_BR, rb - rs);
    const int p0 = padded(rs, g.L) - 2;
    const int rows = padded(rs + n - 1, g.L) - p0 + 3;
    __syncthreads();
    if (dvec) {
      for (int e = threadIdx.x; e < WH_BR * (WH_BO / 8); e += BF16_THREADS) {
        const int rr = e / (WH_BO / 8), o = (e - rr * (WH_BO / 8)) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (rr < n && o0 + o < g.Cout) {
          v = __ldg(reinterpret_cast<const uint4*>(dm + (rs + rr) * g.Cout + o0 + o));
        }
        *reinterpret_cast<uint4*>(dys + rr * WH_DROW + o) = v;
      }
    } else {
      for (int e = threadIdx.x; e < WH_BR * WH_BO; e += BF16_THREADS) {
        const int rr = e / WH_BO, o = e - rr * WH_BO;
        dys[rr * WH_DROW + o] = (rr < n && o0 + o < g.Cout) ? dm[(rs + rr) * g.Cout + o0 + o]
                                                           : zero<bf16>();
      }
    }
    for (int s = threadIdx.x; s < rows; s += BF16_THREADS) src[s] = source_offset(p0 + s, g, ha);
    for (int rr = threadIdx.x; rr < WH_BR; rr += BF16_THREADS) {
      srow[rr] = (rr < n ? padded(rs + rr, g.L) - p0 - 2 : staged) * WH_XROW * 2;
    }
    __syncthreads();
    stage_x<bf16, WH_BI, WH_XROW>(xs, src, rows, hm, ha.c, g.Cin, i0, hvec);
    __syncthreads();
    for (int ks = 0; ks < (n + 15) / 16; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = ks * 16 + (lane & 7) + (m >> 1) * 8;
        const int o = wo * 32 + mi * 16 + (m & 1) * 8;
        ldsm_x4_trans(a[mi], dys_u32 + (r * WH_DROW + o) * 2);
      }
      const int r = ks * 16 + (lane & 7) + (m & 1) * 8;
      const uint32_t xb = xs_u32 + srow[r] + (wi * 16 + (m >> 1) * 8) * 2;
#pragma unroll
      for (int k = 0; k < TAPS; ++k) {
        uint32_t b[4];
        ldsm_x4_trans(b, xb + k * WH_XROW * 2);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][0][k], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][1][k], a[mi], b[2], b[3]);
        }
      }
    }
    if (with_db) {
      for (int rr = 0; rr < n; ++rr) db += __bfloat162float(dys[rr * WH_DROW + threadIdx.x]);
    }
  }

  const int J = g.Cin * TAPS, gq = lane >> 2, q = lane & 3;
  float* pm = part + (static_cast<long long>(t) * splits + sp) * g.Cout * J;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int o = o0 + wo * 32 + mi * 16 + gq + 8 * (c >> 1);
        const int i = i0 + wi * 16 + ni * 8 + 2 * q + (c & 1);
        if (o >= g.Cout || i >= g.Cin) continue;
#pragma unroll
        for (int k = 0; k < TAPS; ++k) {
          pm[static_cast<long long>(o) * J + i * TAPS + k] = acc[mi][ni][k][c];
        }
      }
  if (with_db && o0 + threadIdx.x < g.Cout) {
    dbpart[(static_cast<long long>(t) * splits + sp) * g.Cout + o0 + threadIdx.x] = db;
  }
}

// each member's partials added in split order into the leaf's layout (db's
// in float64, rounded once to float32 and then to the output's dtype):
// dw (T, out, in, 5) for a Conv1d, (T, in, out, 5) reversed along k for a
// ConvTranspose1d, then db (T, C_out)
template <typename T>
__global__ void __launch_bounds__(FINISH_THREADS)
    conv_wgrad_finish(const float* __restrict__ part, const double* __restrict__ dbpart,
                      T* __restrict__ dw, T* __restrict__ db, int cin, int cout, int splits,
                      int transposed) {
  const int W = cin * cout * TAPS;
  const int e = blockIdx.x * FINISH_THREADS + threadIdx.x, t = blockIdx.y;
  if (e >= W + cout) return;
  const long long J = static_cast<long long>(cin) * TAPS;
  if (e < W) {
    const int kk = e % TAPS, ab = e / TAPS;
    int o, i, k;
    if (transposed) {
      i = ab / cout;
      o = ab - i * cout;
      k = TAPS - 1 - kk;
    } else {
      o = ab / cin;
      i = ab - o * cin;
      k = kk;
    }
    const float* p = part + static_cast<long long>(t) * splits * cout * J + o * J + i * TAPS + k;
    float s = p[0];
    for (int sp = 1; sp < splits; ++sp) s += p[sp * cout * J];
    dw[static_cast<long long>(t) * W + e] = from_float<T>(s);
  } else {
    const int o = e - W;
    const double* p = dbpart + static_cast<long long>(t) * splits * cout + o;
    double s = p[0];
    for (int sp = 1; sp < splits; ++sp) s += p[sp * cout];
    db[static_cast<long long>(t) * cout + o] = from_float<T>(static_cast<float>(s));
  }
}

// ------------------------------------------------------------ host side
int fwd_bn(int cout) { return cout <= 16 ? 16 : (cout <= 32 ? 32 : 64); }

// a float32 conv_fwd tile: output channels, rows a thread, threads
struct F32Tile {
  int bn, tm, threads;
};

long long f32_blocks(const F32Tile& t, int T, int R, int cout) {
  const int rows = f32_rows(t.bn, t.tm, t.threads);
  return static_cast<long long>((R + rows - 1) / rows) * ((cout + t.bn - 1) / t.bn) * T;
}

size_t f32_fwd_shared(const F32Tile& t, int L) {
  return static_cast<size_t>(TAPS) * BK * (t.bn + 4) * 4 +
         staged_rows(f32_rows(t.bn, t.tm, t.threads), L) * (F32_ROW * 4 + 4);
}

size_t bf16_fwd_shared(int bn, int L) {
  return static_cast<size_t>(TAPS) * bn * BF16_ROW * 2 +
         staged_rows(BF16_ROWS, L) * (BF16_ROW * 2 + 4);
}

size_t wgrad_shared(int bo, int L, bool bf) {
  const int staged = staged_rows(WG_BR, L);
  return bf ? static_cast<size_t>(WH_BR) * WH_DROW * 2 + (staged_rows(WH_BR, L) + TAPS) * WH_XROW * 2 +
                  staged_rows(WH_BR, L) * 4 + WH_BR * 4
            : static_cast<size_t>(WG_BR) * (bo + 4) * 4 + staged * (F32_ROW * 4 + 4) +
                  WG_BR * 4;
}

// every kernel function, in the order of lesionvae_conv1d_attributes:
// its threads, and its shared memory at a layer of length L
struct KernelFn {
  const void* fn;
  int threads;
  size_t (*shared)(int L);
};

using F32Fwd = void (*)(const float*, Act, int, const float*, Weight, const float*, long long,
                       float*, Geometry);

struct F32Fn {
  F32Tile tile;
  F32Fwd fn;
};

#define F32_FN(BN, TM, THREADS) {{BN, TM, THREADS}, conv_fwd_f32<BN, TM, THREADS>}

// every float32 conv_fwd kernel function with its tile: the N_FULL full
// tiles (fwd_bn channels, 4 rows a thread, 256 threads: 8192 outputs a
// block), then the smaller ones, 16 output channels each, each with half
// the outputs of the one before: 4096, 2048, 1024, 512, 256 a block
const F32Fn F32_FNS[] = {F32_FN(16, F32_TM, F32_THREADS), F32_FN(32, F32_TM, F32_THREADS),
                         F32_FN(64, F32_TM, F32_THREADS),
                         F32_FN(16, 2, 256), F32_FN(16, 1, 256), F32_FN(16, 1, 128),
                         F32_FN(16, 1, 64),  F32_FN(16, 1, 32)};
#undef F32_FN
constexpr int N_FULL = 3, N_F32 = sizeof(F32_FNS) / sizeof(F32_FNS[0]);

// the float32 conv_fwd tile of a launch, from its shapes alone: the full
// tile where its grid has a block for every SM, else the first smaller tile
// whose grid has, else the smallest
const F32Fn& f32_tile(int T, int R, int cout) {
  int full = 0;
  while (F32_FNS[full].tile.bn != fwd_bn(cout)) ++full;
  if (f32_blocks(F32_FNS[full].tile, T, R, cout) >= SMS) return F32_FNS[full];
  for (int i = N_FULL; i < N_F32; ++i) {
    if (f32_blocks(F32_FNS[i].tile, T, R, cout) >= SMS) return F32_FNS[i];
  }
  return F32_FNS[N_F32 - 1];
}

#define F32_KERNEL(i)                                                                  \
  {reinterpret_cast<const void*>(F32_FNS[i].fn), F32_FNS[i].tile.threads,              \
   [](int L) { return f32_fwd_shared(F32_FNS[i].tile, L); }}

const KernelFn KERNELS[] = {
    F32_KERNEL(0), F32_KERNEL(1), F32_KERNEL(2),
    {reinterpret_cast<const void*>(conv_fwd_bf16<16>), FWD_BF16_WARPS * 32,
     [](int L) { return bf16_fwd_shared(16, L); }},
    {reinterpret_cast<const void*>(conv_fwd_bf16<32>), FWD_BF16_WARPS * 32,
     [](int L) { return bf16_fwd_shared(32, L); }},
    {reinterpret_cast<const void*>(conv_fwd_bf16<64>), FWD_BF16_WARPS * 32,
     [](int L) { return bf16_fwd_shared(64, L); }},
    {reinterpret_cast<const void*>(conv_wgrad_f32<16>), 16 / WG_TO * WG_BI,
     [](int L) { return wgrad_shared(16, L, false); }},
    {reinterpret_cast<const void*>(conv_wgrad_f32<32>), 32 / WG_TO * WG_BI,
     [](int L) { return wgrad_shared(32, L, false); }},
    {reinterpret_cast<const void*>(conv_wgrad_f32<64>), 64 / WG_TO * WG_BI,
     [](int L) { return wgrad_shared(64, L, false); }},
    {reinterpret_cast<const void*>(conv_wgrad_bf16), BF16_THREADS,
     [](int L) { return wgrad_shared(WH_BO, L, true); }},
    {reinterpret_cast<const void*>(conv_wgrad_finish<float>), FINISH_THREADS,
     [](int) { return size_t{0}; }},
    {reinterpret_cast<const void*>(conv_wgrad_finish<bf16>), FINISH_THREADS,
     [](int) { return size_t{0}; }},
    F32_KERNEL(3), F32_KERNEL(4), F32_KERNEL(5), F32_KERNEL(6), F32_KERNEL(7)};
#undef F32_KERNEL
constexpr int N_KERNELS = sizeof(KERNELS) / sizeof(KERNELS[0]);

bool bad_geometry(int T, int N, int L, int cin, int cout) {
  return T <= 0 || T > 65535 || N <= 0 || L <= 0 || cin <= 0 || cout <= 0 ||
         static_cast<long long>(N) * L >= (1LL << 31) / 8 ||
         static_cast<long long>(N) * (L + 4) >= (1LL << 31) / 8;
}

}  // namespace

// the kernels' dynamic shared memory limit, set once before any launch
extern "C" int lesionvae_conv1d_init() {
  for (const KernelFn& k : KERNELS) {
    const cudaError_t err =
        cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SHARED);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// y = conv(h, w) + bias (bias may be null), every member.  h: (T, N, L, C_in)
// at the element strides h_member, h_n, h_l, h_c (hvec: h_c 1 and every row
// start and C_in whole 16-byte vectors); w read as W_k[i, o] =
// w[t * w_member + i * w_in + o * w_out + (flip ? 4 - k : k) * w_tap]; bias
// (T, C_out) rows at bias_member; y: contiguous (T, N, L, C_out).
extern "C" int lesionvae_conv_fwd(const void* h, int bf, long long h_member, int h_n, int h_l,
                                  int h_c, int hvec, const void* w, long long w_member,
                                  long long w_in, long long w_out, long long w_tap, int flip,
                                  const void* bias, long long bias_member, void* y, int T, int N,
                                  int L, int cin, int cout, void* stream) {
  if (bad_geometry(T, N, L, cin, cout)) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{N, L, N * L, cin, cout};
  const Act ha{h_member, h_n, h_l, h_c};
  const Weight wt{w_member, w_in, w_out, w_tap, flip};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf) {
    const int bn = fwd_bn(cout);
    const size_t shared = bf16_fwd_shared(bn, L);
    if (shared > MAX_SHARED) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((g.R + BF16_ROWS - 1) / BF16_ROWS, (cout + bn - 1) / bn, T);
    const bf16 *hp = static_cast<const bf16*>(h), *wp = static_cast<const bf16*>(w),
               *bp = static_cast<const bf16*>(bias);
    bf16* yp = static_cast<bf16*>(y);
    switch (bn) {
      case 16: conv_fwd_bf16<16><<<grid, FWD_BF16_WARPS * 32, shared, s>>>(hp, ha, hvec, wp, wt, bp, bias_member, yp, g); break;
      case 32: conv_fwd_bf16<32><<<grid, FWD_BF16_WARPS * 32, shared, s>>>(hp, ha, hvec, wp, wt, bp, bias_member, yp, g); break;
      default: conv_fwd_bf16<64><<<grid, FWD_BF16_WARPS * 32, shared, s>>>(hp, ha, hvec, wp, wt, bp, bias_member, yp, g);
    }
  } else {
    const F32Fn& f = f32_tile(T, g.R, cout);
    const F32Tile& t = f.tile;
    const F32Fwd kernel = f.fn;
    const size_t shared = f32_fwd_shared(t, L);
    if (shared > MAX_SHARED) return static_cast<int>(cudaErrorInvalidValue);
    const int bm = f32_rows(t.bn, t.tm, t.threads);
    const dim3 grid((g.R + bm - 1) / bm, (cout + t.bn - 1) / t.bn, T);
    kernel<<<grid, t.threads, shared, s>>>(
        static_cast<const float*>(h), ha, hvec, static_cast<const float*>(w), wt,
        static_cast<const float*>(bias), bias_member, static_cast<float*>(y), g);
  }
  return static_cast<int>(cudaGetLastError());
}

// dw, db of every member from h (strided as in lesionvae_conv_fwd) and dy
// (contiguous (T, N, L, C_out); dvec: C_out whole 16-byte vectors): the
// partials launch into part (float32 (T, splits, C_out, C_in * 5)) and
// dbpart (float64 (T, splits, C_out)), then the finishing launch into dw
// (contiguous, (T, out, in, 5), or (T, in, out, 5) when transposed) and db
// (contiguous (T, C_out)), in h's dtype.
extern "C" int lesionvae_conv_wgrad(const void* h, int bf, long long h_member, int h_n, int h_l,
                                    int h_c, int hvec, const void* dy, int dvec, void* part,
                                    void* dbpart, void* dw, void* db, int T, int N, int L, int cin,
                                    int cout, int splits, int transposed, void* stream) {
  if (bad_geometry(T, N, L, cin, cout) || splits <= 0 || splits > N * L ||
      static_cast<long long>(T) * splits > 65535 ||
      static_cast<long long>(splits) * cout * cin * TAPS >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g{N, L, N * L, cin, cout};
  const Act ha{h_member, h_n, h_l, h_c};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(part);
  double* dp = static_cast<double*>(dbpart);
  if (bf) {
    const dim3 grid((cin + WH_BI - 1) / WH_BI, (cout + WH_BO - 1) / WH_BO, T * splits);
    conv_wgrad_bf16<<<grid, BF16_THREADS, wgrad_shared(WH_BO, L, true), s>>>(
        static_cast<const bf16*>(h), ha, hvec, static_cast<const bf16*>(dy), dvec, pp, dp, g,
        splits);
  } else {
    const int bo = fwd_bn(cout);
    const dim3 grid((cin + WG_BI - 1) / WG_BI, (cout + bo - 1) / bo, T * splits);
    const size_t shared = wgrad_shared(bo, L, false);
    const float *hp = static_cast<const float*>(h), *yp = static_cast<const float*>(dy);
    switch (bo) {
      case 16: conv_wgrad_f32<16><<<grid, 16 / WG_TO * WG_BI, shared, s>>>(hp, ha, hvec, yp, dvec, pp, dp, g, splits); break;
      case 32: conv_wgrad_f32<32><<<grid, 32 / WG_TO * WG_BI, shared, s>>>(hp, ha, hvec, yp, dvec, pp, dp, g, splits); break;
      default: conv_wgrad_f32<64><<<grid, 64 / WG_TO * WG_BI, shared, s>>>(hp, ha, hvec, yp, dvec, pp, dp, g, splits);
    }
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_member = cin * cout * TAPS + cout;
  const dim3 fgrid((per_member + FINISH_THREADS - 1) / FINISH_THREADS, T);
  if (bf) {
    conv_wgrad_finish<bf16><<<fgrid, FINISH_THREADS, 0, s>>>(
        pp, dp, static_cast<bf16*>(dw), static_cast<bf16*>(db), cin, cout, splits, transposed);
  } else {
    conv_wgrad_finish<float><<<fgrid, FINISH_THREADS, 0, s>>>(
        pp, dp, static_cast<float*>(dw), static_cast<float*>(db), cin, cout, splits, transposed);
  }
  return static_cast<int>(cudaGetLastError());
}

// out: 3 ints a kernel function, in the order of KERNELS (conv_fwd_f32's
// full tiles <16, 32, 64>, conv_fwd_bf16 <16, 32, 64>, conv_wgrad_f32
// <16, 32, 64>, conv_wgrad_bf16, conv_wgrad_finish <float, bf16>, then
// conv_fwd_f32's smaller tiles, as F32_FNS lists them):
// registers a thread, local memory bytes a thread, blocks an SM holds at
// the shared memory of a layer of length L (0 where it does not fit)
extern "C" int lesionvae_conv1d_attributes(int L, int* out) {
  for (int i = 0; i < N_KERNELS; ++i) {
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, KERNELS[i].fn);
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t shared = KERNELS[i].shared(L);
    int blocks = 0;
    if (shared <= MAX_SHARED) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, KERNELS[i].fn,
                                                          KERNELS[i].threads, shared);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    out[3 * i] = a.numRegs;
    out[3 * i + 1] = static_cast<int>(a.localSizeBytes);
    out[3 * i + 2] = blocks;
  }
  return 0;
}
