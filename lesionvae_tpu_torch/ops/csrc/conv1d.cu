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
//      The chunks go through a ring of FWD_STAGES slots: while a chunk's
//      MMAs run, the next chunks' x rows are in flight as cp.async copies
//      (16 bytes, the halo's zeros by a source size of 0) and the next
//      chunk's weight tile in registers, stored once the MMAs are issued;
//      one barrier a chunk.  An h whose rows are not 16-byte vectors
//      (C_in 13 or 3, a transposed view) is staged by plain loads, a
//      thread a row.  The outputs leave through shared memory, a warp
//      writing whole rows of 16-byte vectors (C_out a multiple of 8).
//    The bias is added in the epilogue and the output rounded once.
// 2. conv_wgrad: dW_k[i, o] = sum over the member's N * L rows of
//    x[row shifted by k - 2, i] * dy[row, o], and db[o] = sum dy[row, o].
//    A block takes one member, a tile of output channels and of input
//    channels (all 5 taps) and one of `splits` contiguous ranges of rows.
//    dw goes straight into the leaf's own layout (T, out, in, 5) or
//    (T, in, out, 5), and db, each rounded once to the compute dtype.  No
//    atomics: the order is fixed by the shapes, so two calls give the same
//    bits.
//    - float32: 8 output channels x 1 input channel x 5 taps a thread,
//      staged 64 rows at a time, each stage's rows summed in row order into
//      registers of their own and then added to the total (a two-level sum
//      over the long reductions).  A block writes float32 partials, and a
//      finishing launch adds each output's `splits` partials in split order.
//      db is summed in float64 (one add a row and output channel, off the
//      hot loop), so it is the exact sum rounded once or twice.
//    - bf16: mma.sync, A = dy^T by ldmatrix.trans from the staged rows of
//      dy, B = the shifted x rows by ldmatrix.trans; a warp 32 x 16 x 5,
//      a block of 4 warps 64 output x 32 input channels, or 32 / 16 where
//      the layer's C_out / C_in fit (the warps left over then split the
//      rows' 16-row steps among them, their sums added in a fixed order).
//      Stages of WH_BR = 64 rows go through a ring of WH_STAGES slots,
//      cp.async copies in flight while a stage's MMAs run (plain loads of
//      x held in registers across them); one barrier a stage.  db comes out of the tensor
//      cores: the warps of the first input-channel tile multiply each A
//      fragment by a B fragment of ones too, so the stage's dy columns are
//      summed in float32 beside the MMAs, in an order fixed by the shapes.
//      The `splits` <= WH_MAX_SPLITS blocks of a (member, tile) form one
//      thread-block cluster: each leaves its float32 sums in shared memory,
//      and each adds its share of the tile's outputs over the cluster's
//      blocks in split order, through distributed shared memory, and writes
//      dw and db: no partials in device memory, no finishing launch.
//
// What bounds them: in float32, the FP32 operations (2 a multiply-add, 67
// TFLOP/s); the bytes (each tensor once, at 3.35 TB/s) take a quarter of
// that time.  In bf16 on the tensor cores, the bytes.  The float32 kernels
// are simple: no ring of stages; a block stages a chunk, synchronises and
// computes, and the blocks an SM holds overlap each other's loads.  The
// bf16 kernels overlap their own loads with their MMAs through their rings
// (mma.sync, no wgmma or TMA: a tile of 16-byte rows with a padded-row
// indirection that ldmatrix reads a lane a row).
//
// Interface: plain C, loaded with ctypes (ops/conv1d.py); each entry point
// returns the cudaError_t of its launches (0 on success).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

namespace cg = cooperative_groups;
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
constexpr int WH_BO = 64;             // output channels a bf16 wgrad block (32 where C_out <= 32)
constexpr int WH_BI = 32;             // input channels a bf16 wgrad block (16 where C_in <= 16)
constexpr int WH_BR = 64;             // rows a bf16 wgrad stage
constexpr int WH_STAGES = 3;          // stages in a bf16 wgrad block's ring
constexpr int WH_MAX_SPLITS = 8;      // blocks a bf16 wgrad cluster (the portable most)
constexpr int FWD_STAGES = 3;         // input-channel chunks in a bf16 conv_fwd block's ring
constexpr uint32_t BF16_ONES = 0x3F803F80u;  // two bf16 ones: an mma B fragment of ones
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

// 16 bytes from src to shared dst, or 16 zero bytes where !full (a source
// size of 0: src is then only a valid address); it lands once the thread's
// cp_async_wait lets its group go
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of the thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [0, rows) of a staged bf16 tile with plain loads, for a tensor whose
// rows are not whole 16-byte vectors: staged row s from element offset
// off(s) of src (-1: a zero row), its CH channels at stride cs from there,
// of which the first nc are real and the rest 0, ROW elements between
// staged rows.  PARTS threads take a row, CH / PARTS channels each, loaded
// together and stored in pairs.  Neighbouring threads take neighbouring
// rows: along them a transposed view's loads are contiguous, and a row's
// channels share their cache lines
template <int CH, int ROW, int PARTS, typename Offset>
__device__ __forceinline__ void stage_rows_plain(bf16* dst, int rows, const bf16* src,
                                                 long long cs, int nc, Offset off) {
  constexpr int PC = CH / PARTS;
  static_assert(PC * PARTS == CH && PC % 2 == 0 && ROW % 2 == 0, "channel pairs");
  for (int e = threadIdx.x; e < rows * PARTS; e += blockDim.x) {
    const int part = PARTS == 1 ? 0 : e / rows, s = e - part * rows, c0 = part * PC;
    const int o = off(s);
    const bf16* r = src + o + c0 * cs;
    bf16 v[PC];
#pragma unroll
    for (int c = 0; c < PC; ++c) v[c] = (o >= 0 && c0 + c < nc) ? r[c * cs] : zero<bf16>();
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst + s * ROW + c0);
#pragma unroll
    for (int c = 0; c < PC; c += 2) d[c / 2] = __halves2bfloat162(v[c], v[c + 1]);
  }
}

// a thread's plain loads of one staged tile (stage_rows_plain's rows and
// channels), held in registers from the stage's issue, before the MMAs of
// the stage before it, to their store into the ring after them, so that
// they are in flight while those MMAs run.  A tile whose rows need more
// threads than the block has is staged at once
template <int CH, int ROW, int PARTS>
struct HeldRows {
  static constexpr int PC = CH / PARTS;
  bf16 v[PC];
  bf16* at;   // where the thread's channels go; null: nothing held

  template <typename Offset>
  __device__ __forceinline__ void load(bf16* dst, int rows, const bf16* src, long long cs,
                                       int nc, Offset off) {
    at = nullptr;
    if (rows * PARTS > static_cast<int>(blockDim.x)) {
      stage_rows_plain<CH, ROW, PARTS>(dst, rows, src, cs, nc, off);
      return;
    }
    const int e = threadIdx.x;
    if (e >= rows * PARTS) return;
    const int part = PARTS == 1 ? 0 : e / rows, s = e - part * rows, c0 = part * PC;
    const int o = off(s);
    const bf16* r = src + o + c0 * cs;
#pragma unroll
    for (int c = 0; c < PC; ++c) v[c] = (o >= 0 && c0 + c < nc) ? r[c * cs] : zero<bf16>();
    at = dst + s * ROW + c0;
  }

  __device__ __forceinline__ void store() const {
    if (at == nullptr) return;
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(at);
#pragma unroll
    for (int c = 0; c < PC; c += 2) d[c / 2] = __halves2bfloat162(v[c], v[c + 1]);
  }
};

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

// a bf16 conv_fwd ring slot, bytes: one chunk's weight tile
// ws[TAPS][BN][BF16_ROW] and its staged x rows xs[staged][BF16_ROW]
__host__ __device__ constexpr int fwd_slot_bytes(int bn, int L) {
  return (TAPS * bn + staged_rows(BF16_ROWS, L)) * BF16_ROW * 2;
}

// the weight elements of one chunk a thread of the bf16 conv_fwd stages:
// (input, output) channel pairs threadIdx.x + j * THREADS with their taps,
// loaded into registers (the leaf is read through its strides, so it is
// not copied as 16-byte vectors) and stored into the ring once the MMAs of
// the chunk before are issued
template <int BN>
struct FwdWeights {
  static constexpr int THREADS = FWD_BF16_WARPS * 32, PER = BK * BN / THREADS;
  bf16 v[PER][TAPS];

  __device__ __forceinline__ void load(const bf16* wm, const Weight& w, int c0, int n0,
                                       const Geometry& g) {
    const bool c_fast = w.in <= w.out;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = threadIdx.x + j * THREADS;
      const int c = c_fast ? e % BK : e / BN, o = c_fast ? e / BK : e % BN;
      const bool inside = c0 + c < g.Cin && n0 + o < g.Cout;
      const bf16* src = wm + (c0 + c) * w.in + (n0 + o) * w.out;
#pragma unroll
      for (int k = 0; k < TAPS; ++k) {
        v[j][k] = inside ? src[(w.flip ? TAPS - 1 - k : k) * w.tap] : zero<bf16>();
      }
    }
  }

  __device__ __forceinline__ void store(bf16* ws, const Weight& w) const {
    const bool c_fast = w.in <= w.out;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int e = threadIdx.x + j * THREADS;
      const int c = c_fast ? e % BK : e / BN, o = c_fast ? e / BK : e % BN;
#pragma unroll
      for (int k = 0; k < TAPS; ++k) ws[(k * BN + o) * BF16_ROW + c] = v[j][k];
    }
  }
};

// one chunk's staged x rows into a ring slot: 16-byte cp.async copies
// (hvec; a zero row or the channels past C_in as 16 zero bytes), else plain
// loads
__device__ __forceinline__ void fwd_bf16_stage_x(bf16* xs, const int* src, int rows,
                                                 const bf16* hm, const Act& ha, int hvec,
                                                 const Geometry& g, int c0) {
  if (hvec) {
    for (int e = threadIdx.x; e < rows * 2; e += blockDim.x) {
      const int s = e >> 1, c = c0 + (e & 1) * 8;
      const bool in = src[s] >= 0 && c < g.Cin;
      cp_async16(xs + s * BF16_ROW + (e & 1) * 8, in ? hm + src[s] + c : hm, in);
    }
  } else {
    stage_rows_plain<BK, BF16_ROW, 1>(xs, rows, hm + static_cast<long long>(c0) * ha.c, ha.c,
                                      min(BK, g.Cin - c0), [&](int s) { return src[s]; });
  }
}

// the bf16 forward: a ring of FWD_STAGES chunks of BK input channels, each
// chunk's x rows copied by cp.async and its weight tile from registers, so
// that the next chunks load while this one's MMAs run; one barrier a chunk
template <int BN>
__global__ void __launch_bounds__(FWD_BF16_WARPS * 32, 2)
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
  const int slot = fwd_slot_bytes(BN, g.L);
  int* src = reinterpret_cast<int*>(smem + FWD_STAGES * slot);   // [staged]
  const bf16* hm = h + t * ha.member;
  const bf16* wm = w + t * wt.member;
  for (int s = threadIdx.x; s < rows; s += blockDim.x) src[s] = source_offset(p0 + s, g, ha);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // each lane's ldmatrix byte offsets inside a slot, at tap 0.  A: the
  // staged row of rows (lane & 15) of each m16 tile, channels 8 (lane >> 4);
  // B: output channels (lane & 7) + 8 (lane >> 4), input channels
  // 8 ((lane >> 3) & 1)
  uint32_t a_off[MW];
#pragma unroll
  for (int mi = 0; mi < MW; ++mi) {
    const int r = min(r0 + warp * WM + mi * 16 + (lane & 15), r_end - 1);
    a_off[mi] = ((TAPS * BN + padded(r, g.L) - p0 - 2) * BF16_ROW + (lane >> 4) * 8) * 2;
  }
  const uint32_t b_off = (((lane & 7) + (lane >> 4) * 8) * BF16_ROW + ((lane >> 3) & 1) * 8) * 2;
  float acc[MW][NW][4];
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int nj = 0; nj < NW; ++nj)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][nj][c] = 0.f;

  const int chunks = (g.Cin + BK - 1) / BK;
  FwdWeights<BN> wv;
  auto ws_of = [&](int j) { return reinterpret_cast<bf16*>(smem + (j % FWD_STAGES) * slot); };
  for (int j = 0; j < FWD_STAGES - 1; ++j) {
    if (j < chunks) {
      fwd_bf16_stage_x(ws_of(j) + TAPS * BN * BF16_ROW, src, rows, hm, ha, hvec, g, j * BK);
      wv.load(wm, wt, j * BK, n0, g);
      wv.store(ws_of(j), wt);
    }
    cp_async_commit();
  }
  for (int j = 0; j < chunks; ++j) {
    cp_async_wait<FWD_STAGES - 2>();
    __syncthreads();
    // chunk jn goes into the slot chunk j - 1 left, which every warp has
    // passed the barrier after
    const int jn = j + FWD_STAGES - 1;
    if (jn < chunks) {
      fwd_bf16_stage_x(ws_of(jn) + TAPS * BN * BF16_ROW, src, rows, hm, ha, hvec, g, jn * BK);
      wv.load(wm, wt, jn * BK, n0, g);
    }
    cp_async_commit();
    const uint32_t base = smem_u32(smem) + (j % FWD_STAGES) * slot;
#pragma unroll
    for (int k = 0; k < TAPS; ++k) {
      uint32_t b[NW][2];
#pragma unroll
      for (int p = 0; p < NW / 2; ++p) {
        uint32_t r[4];
        ldsm_x4(r, base + b_off + ((k * BN + p * 16) * BF16_ROW) * 2);
        b[2 * p][0] = r[0];
        b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2];
        b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MW; ++mi) {
        uint32_t a[4];
        ldsm_x4(a, base + a_off[mi] + k * BF16_ROW * 2);
#pragma unroll
        for (int nj = 0; nj < NW; ++nj) mma_bf16(acc[mi][nj], a, b[nj][0], b[nj][1]);
      }
    }
    if (jn < chunks) wv.store(ws_of(jn), wt);
  }

  const int gq = lane >> 2, q = lane & 3;
  if (g.Cout % 8 == 0) {
    // the outputs through shared memory, where the ring lay once every
    // warp is past its last chunk, so that a warp writes whole rows of
    // 16-byte vectors
    constexpr int YROW = BN + 8;
    __syncthreads();
    bf16* ys = reinterpret_cast<bf16*>(smem) + warp * WM * YROW;
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
      for (int mi = 0; mi < MW; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          *reinterpret_cast<__nv_bfloat162*>(ys + (mi * 16 + gq + 8 * half) * YROW + nj * 8 +
                                             2 * q) =
              __floats2bfloat162_rn(acc[mi][nj][2 * half] + bv[0],
                                    acc[mi][nj][2 * half + 1] + bv[1]);
        }
    }
    __syncwarp();
#pragma unroll
    for (int e = lane; e < WM * NW; e += 32) {
      const int rl = e / NW, vq = e - rl * NW;
      const int r = r0 + warp * WM + rl, co = n0 + vq * 8;
      if (r < r_end && co < g.Cout) {
        *reinterpret_cast<uint4*>(y + (static_cast<long long>(t) * g.R + r) * g.Cout + co) =
            *reinterpret_cast<const uint4*>(ys + rl * YROW + vq * 8);
      }
    }
    return;
  }
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

// a bf16 wgrad ring slot of a bo x bi channel tile, bytes: dy's rows
// dys[WH_BR][bo + 8], the staged x rows and TAPS zero rows after them
// xs[staged + TAPS][bi + 8], and each row's staged x row in bytes srow[WH_BR]
__host__ __device__ constexpr int wh_slot_bytes(int bo, int bi, int L) {
  return WH_BR * (bo + 8) * 2 + (staged_rows(WH_BR, L) + TAPS) * (bi + 8) * 2 + WH_BR * 4;
}

// the loads of the member's rows [rs, rs + n) into a ring slot: dy's BO
// output channels from o0 (0 past C_out and past row n), the x rows they
// read (padded rows p0 ..; BI channels from i0, a zero row or a channel past
// C_in as 0) and each row's staged x row (rows past n: the zero rows).
// dvec / hvec: 16-byte cp.async copies, which land at the thread's
// cp_async_wait; else plain loads, x's held in registers until `held`
// stores them
template <int BO, int BI>
__device__ __forceinline__ void wgrad_bf16_stage(unsigned char* slot, int staged, const bf16* dm,
                                                 int dvec, const bf16* hm, const Act& ha, int hvec,
                                                 const Geometry& g, int rs, int n, int o0,
                                                 int i0, HeldRows<BI, BI + 8, 1>& held) {
  constexpr int DROW = BO + 8, XROW = BI + 8;
  bf16* dys = reinterpret_cast<bf16*>(slot);
  bf16* xs = dys + WH_BR * DROW;
  int* srow = reinterpret_cast<int*>(xs + (staged + TAPS) * XROW);
  const int p0 = padded(rs, g.L) - 2;
  const int rows = padded(rs + n - 1, g.L) - p0 + 3;
  if (dvec) {
    for (int e = threadIdx.x; e < WH_BR * (BO / 8); e += BF16_THREADS) {
      const int rr = e / (BO / 8), o = (e - rr * (BO / 8)) * 8;
      const bool in = rr < n && o0 + o < g.Cout;
      cp_async16(dys + rr * DROW + o, in ? dm + (rs + rr) * g.Cout + o0 + o : dm, in);
    }
  } else {
    stage_rows_plain<BO, DROW, BO / 32>(
        dys, WH_BR, dm + o0, 1, min(BO, g.Cout - o0),
        [&](int rr) { return rr < n ? (rs + rr) * g.Cout : -1; });
  }
  if (hvec) {
    constexpr int PER = BI / 8;
    for (int e = threadIdx.x; e < rows * PER; e += BF16_THREADS) {
      const int s = e / PER, c = i0 + (e - s * PER) * 8;
      const int off = source_offset(p0 + s, g, ha);
      const bool in = off >= 0 && c < g.Cin;
      cp_async16(xs + s * XROW + c - i0, in ? hm + off + c : hm, in);
    }
  } else {
    held.load(xs, rows, hm + static_cast<long long>(i0) * ha.c, ha.c, min(BI, g.Cin - i0),
              [&](int s) { return source_offset(p0 + s, g, ha); });
  }
  for (int rr = threadIdx.x; rr < WH_BR; rr += BF16_THREADS) {
    srow[rr] = (rr < n ? padded(rs + rr, g.L) - p0 - 2 : staged) * XROW * 2;
  }
}

// the bf16 weight gradient.  A cluster of `splits` blocks takes one member's
// tile of BO output x BI input channels (64 x 32, or 32 / 16 where C_out /
// C_in fit: wh_bo, wh_bi), a block one split of its rows, in stages of
// WH_BR rows through a ring of WH_STAGES slots (the next stages load while
// this one's MMAs run; one barrier a stage).  A warp takes 32 output x 16
// input channels; the warps a smaller tile leaves over take every KS-th
// 16-row step as k-slices, whose sums are added in k-slice order.  db comes
// out of the tensor cores: in the warps of the first input-channel tile, one
// more MMA of each A fragment (dy^T) by a B fragment of ones sums the stage's
// dy columns.  The blocks then leave their sums in shared memory, and each
// block adds its share of the tile's outputs over the cluster's blocks in
// split order, reading them through distributed shared memory, and writes dw
// (and db) rounded once, in the leaf's layout: no partials in device memory,
// no finishing launch
template <int BO, int BI>
__global__ void __launch_bounds__(BF16_THREADS, 3)
    conv_wgrad_bf16(const bf16* __restrict__ h, Act ha, int hvec, const bf16* __restrict__ dy,
                    int dvec, bf16* __restrict__ dw, bf16* __restrict__ db, Geometry g,
                    int splits, int transposed) {
  // the warps: WO along the output channels, WI along the input channels,
  // and KS k-slices that take every KS-th 16-row step of a stage
  constexpr int WO = BO / 32, WI = BI / 16, KS = 4 / (WO * WI);
  constexpr int DROW = BO + 8, XROW = BI + 8, RROW = BI * TAPS + 1;
  static_assert(WO * WI * KS * 32 == BF16_THREADS, "a block's warps");
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int staged = staged_rows(WH_BR, g.L), slot = wh_slot_bytes(BO, BI, g.L);
  const int t = blockIdx.z / splits, sp = blockIdx.z % splits;
  const int i0 = blockIdx.x * BI, o0 = blockIdx.y * BO;
  const bf16* hm = h + t * ha.member;
  const bf16* dm = dy + static_cast<long long>(t) * g.R * g.Cout;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wo = warp % WO, wi = warp / WO % WI, kslice = KS == 1 ? 0 : warp / (WO * WI);
  const bool with_db = blockIdx.x == 0 && wi == 0;
  int ra, rb;
  split_rows(g, splits, &ra, &rb);
  const int stages = (rb - ra + WH_BR - 1) / WH_BR;
  // the TAPS rows after each slot's staged ones stay zero: a row past the
  // stage's end reads them at every tap
  for (int e = threadIdx.x; e < WH_STAGES * TAPS * XROW; e += BF16_THREADS) {
    const int j = e / (TAPS * XROW);
    bf16* xs = reinterpret_cast<bf16*>(smem + j * slot) + WH_BR * DROW;
    xs[staged * XROW + e - j * TAPS * XROW] = zero<bf16>();
  }
  HeldRows<BI, XROW, 1> held;
  held.at = nullptr;
  for (int j = 0; j < WH_STAGES - 1; ++j) {
    if (j < stages) {
      const int rs = ra + j * WH_BR;
      wgrad_bf16_stage<BO, BI>(smem + j * slot, staged, dm, dvec, hm, ha, hvec, g, rs,
                               min(WH_BR, rb - rs), o0, i0, held);
      held.store();
    }
    cp_async_commit();
  }
  float acc[2][2][TAPS][4], dacc[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int c = 0; c < 4; ++c) dacc[mi][c] = 0.f;
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int k = 0; k < TAPS; ++k)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mi][ni][k][c] = 0.f;
  }
  const int m = lane >> 3;

  for (int j = 0; j < stages; ++j) {
    cp_async_wait<WH_STAGES - 2>();
    __syncthreads();
    // stage jn goes into the slot stage j - 1 left, which every warp has
    // passed the barrier after
    const int jn = j + WH_STAGES - 1;
    if (jn < stages) {
      const int rs = ra + jn * WH_BR;
      wgrad_bf16_stage<BO, BI>(smem + (jn % WH_STAGES) * slot, staged, dm, dvec, hm, ha,
                               hvec, g, rs, min(WH_BR, rb - rs), o0, i0, held);
    } else {
      held.at = nullptr;
    }
    cp_async_commit();
    const int n = min(WH_BR, rb - ra - j * WH_BR);
    const unsigned char* sl = smem + (j % WH_STAGES) * slot;
    const uint32_t dys_u32 = smem_u32(sl), xs_u32 = dys_u32 + WH_BR * DROW * 2;
    const int* srow = reinterpret_cast<const int*>(sl + WH_BR * DROW * 2 +
                                                   (staged + TAPS) * XROW * 2);
    for (int ks = kslice; ks < (n + 15) / 16; ks += KS) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = ks * 16 + (lane & 7) + (m >> 1) * 8;
        const int o = wo * 32 + mi * 16 + (m & 1) * 8;
        ldsm_x4_trans(a[mi], dys_u32 + (r * DROW + o) * 2);
      }
      const int r = ks * 16 + (lane & 7) + (m & 1) * 8;
      const uint32_t xb = xs_u32 + srow[r] + (wi * 16 + (m >> 1) * 8) * 2;
#pragma unroll
      for (int k = 0; k < TAPS; ++k) {
        uint32_t b[4];
        ldsm_x4_trans(b, xb + k * XROW * 2);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][0][k], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][1][k], a[mi], b[2], b[3]);
        }
      }
      if (with_db) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_bf16(dacc[mi], a[mi], BF16_ONES, BF16_ONES);
      }
    }
    held.store();
  }

  // the block's sums where the ring lay, once every warp is done with it:
  // red[o][i * TAPS + k] and, from the first input-channel tile, rdb[o]
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  float* rdb = red + BO * RROW;
  const int gq = lane >> 2, q = lane & 3;
  // k-slice 0 writes its sums, then each k-slice adds its own in turn
#pragma unroll
  for (int ksl = 0; ksl < KS; ++ksl) {
    if (ksl > 0) __syncthreads();
    if (kslice != ksl) continue;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int o = wo * 32 + mi * 16 + gq + 8 * (c >> 1);
          const int i = wi * 16 + ni * 8 + 2 * q + (c & 1);
#pragma unroll
          for (int k = 0; k < TAPS; ++k) {
            float& r = red[o * RROW + i * TAPS + k];
            r = ksl == 0 ? acc[mi][ni][k][c] : r + acc[mi][ni][k][c];
          }
        }
    if (with_db && q == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float& r = rdb[wo * 32 + mi * 16 + gq + 8 * half];
          r = ksl == 0 ? dacc[mi][2 * half] : r + dacc[mi][2 * half];
        }
    }
  }
  cluster.sync();

  // this block's share of the tile's outputs, in the leaf's order: each the
  // cluster's sums added in split order
  const int no = min(BO, g.Cout - o0), ni = min(BI, g.Cin - i0), E = no * ni * TAPS;
  const int e0 = E * sp / splits, e1 = E * (sp + 1) / splits;
  for (int e = e0 + threadIdx.x; e < e1; e += BF16_THREADS) {
    int o, i, k;
    long long out;
    if (transposed) {   // (T, in, out, 5), reversed along k
      i = e / (no * TAPS);
      const int rest = e - i * no * TAPS;
      o = rest / TAPS;
      const int kk = rest - o * TAPS;
      k = TAPS - 1 - kk;
      out = ((static_cast<long long>(t) * g.Cin + i0 + i) * g.Cout + o0 + o) * TAPS + kk;
    } else {            // (T, out, in, 5)
      o = e / (ni * TAPS);
      const int rest = e - o * ni * TAPS;
      i = rest / TAPS;
      k = rest - i * TAPS;
      out = ((static_cast<long long>(t) * g.Cout + o0 + o) * g.Cin + i0 + i) * TAPS + k;
    }
    const int at = o * RROW + i * TAPS + k;
    float v[WH_MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < WH_MAX_SPLITS; ++r) {
      if (r < splits) v[r] = cluster.map_shared_rank(red, r)[at];
    }
    float sum = v[0];
#pragma unroll
    for (int r = 1; r < WH_MAX_SPLITS; ++r) {
      if (r < splits) sum += v[r];
    }
    dw[out] = __float2bfloat16_rn(sum);
  }
  if (blockIdx.x == 0 && sp == 0 && threadIdx.x < no) {
    float sum = rdb[threadIdx.x];
    for (int r = 1; r < splits; ++r) sum += cluster.map_shared_rank(rdb, r)[threadIdx.x];
    db[static_cast<long long>(t) * g.Cout + o0 + threadIdx.x] = __float2bfloat16_rn(sum);
  }
  // no block leaves while another still reads its sums
  cluster.sync();
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
  return static_cast<size_t>(FWD_STAGES) * fwd_slot_bytes(bn, L) + staged_rows(BF16_ROWS, L) * 4;
}

size_t wgrad_shared(int bo, int L) {
  const int staged = staged_rows(WG_BR, L);
  return static_cast<size_t>(WG_BR) * (bo + 4) * 4 + staged * (F32_ROW * 4 + 4) + WG_BR * 4;
}

// the bf16 wgrad tile by the layer's channels: output channels 32 or 64,
// input channels 16 or 32; the kernel's ring, or the block's sums for the
// cluster where they take more
int wh_bo(int cout) { return cout <= 32 ? 32 : WH_BO; }
int wh_bi(int cin) { return cin <= 16 ? 16 : WH_BI; }

size_t wgrad_bf16_shared(int bo, int bi, int L) {
  return std::max(static_cast<size_t>(WH_STAGES) * wh_slot_bytes(bo, bi, L),
                  static_cast<size_t>(bo * (bi * TAPS + 1) + bo) * 4);
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
     [](int L) { return wgrad_shared(16, L); }},
    {reinterpret_cast<const void*>(conv_wgrad_f32<32>), 32 / WG_TO * WG_BI,
     [](int L) { return wgrad_shared(32, L); }},
    {reinterpret_cast<const void*>(conv_wgrad_f32<64>), 64 / WG_TO * WG_BI,
     [](int L) { return wgrad_shared(64, L); }},
    {reinterpret_cast<const void*>(conv_wgrad_bf16<64, 32>), BF16_THREADS,
     [](int L) { return wgrad_bf16_shared(64, 32, L); }},
    {reinterpret_cast<const void*>(conv_wgrad_bf16<64, 16>), BF16_THREADS,
     [](int L) { return wgrad_bf16_shared(64, 16, L); }},
    {reinterpret_cast<const void*>(conv_wgrad_bf16<32, 32>), BF16_THREADS,
     [](int L) { return wgrad_bf16_shared(32, 32, L); }},
    {reinterpret_cast<const void*>(conv_wgrad_bf16<32, 16>), BF16_THREADS,
     [](int L) { return wgrad_bf16_shared(32, 16, L); }},
    {reinterpret_cast<const void*>(conv_wgrad_finish<float>), FINISH_THREADS,
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
// (contiguous (T, N, L, C_out); dvec: C_out whole 16-byte vectors) into dw
// (contiguous, (T, out, in, 5), or (T, in, out, 5) when transposed) and db
// (contiguous (T, C_out)), in h's dtype.  float32: the partials launch into
// part (float32 (T, splits, C_out, C_in * 5)) and dbpart (float64 (T,
// splits, C_out)), then the finishing launch; bf16: one launch of clusters
// of `splits` <= WH_MAX_SPLITS blocks, part and dbpart unused.
extern "C" int lesionvae_conv_wgrad(const void* h, int bf, long long h_member, int h_n, int h_l,
                                    int h_c, int hvec, const void* dy, int dvec, void* part,
                                    void* dbpart, void* dw, void* db, int T, int N, int L, int cin,
                                    int cout, int splits, int transposed, void* stream) {
  if (bad_geometry(T, N, L, cin, cout) || splits <= 0 || splits > N * L ||
      static_cast<long long>(T) * splits > 65535 || (bf && splits > WH_MAX_SPLITS) ||
      static_cast<long long>(splits) * cout * cin * TAPS >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g{N, L, N * L, cin, cout};
  const Act ha{h_member, h_n, h_l, h_c};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf) {
    // one cluster of the member's `splits` blocks a channel tile
    cudaLaunchConfig_t cfg = {};
    const int bo = wh_bo(cout), bi = wh_bi(cin);
    cfg.gridDim = dim3((cin + bi - 1) / bi, (cout + bo - 1) / bo, T * splits);
    cfg.blockDim = dim3(BF16_THREADS);
    cfg.dynamicSmemBytes = wgrad_bf16_shared(bo, bi, L);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = splits;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    void (*kernel)(const bf16*, Act, int, const bf16*, int, bf16*, bf16*, Geometry, int, int) =
        bo == 64 ? (bi == 32 ? conv_wgrad_bf16<64, 32> : conv_wgrad_bf16<64, 16>)
                 : (bi == 32 ? conv_wgrad_bf16<32, 32> : conv_wgrad_bf16<32, 16>);
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const bf16*>(h), ha, hvec,
        static_cast<const bf16*>(dy), dvec, static_cast<bf16*>(dw), static_cast<bf16*>(db), g,
        splits, transposed);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
  float* pp = static_cast<float*>(part);
  double* dp = static_cast<double*>(dbpart);
  const int bo = fwd_bn(cout);
  const dim3 grid((cin + WG_BI - 1) / WG_BI, (cout + bo - 1) / bo, T * splits);
  const size_t shared = wgrad_shared(bo, L);
  const float *hp = static_cast<const float*>(h), *yp = static_cast<const float*>(dy);
  switch (bo) {
    case 16: conv_wgrad_f32<16><<<grid, 16 / WG_TO * WG_BI, shared, s>>>(hp, ha, hvec, yp, dvec, pp, dp, g, splits); break;
    case 32: conv_wgrad_f32<32><<<grid, 32 / WG_TO * WG_BI, shared, s>>>(hp, ha, hvec, yp, dvec, pp, dp, g, splits); break;
    default: conv_wgrad_f32<64><<<grid, 64 / WG_TO * WG_BI, shared, s>>>(hp, ha, hvec, yp, dvec, pp, dp, g, splits);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_member = cin * cout * TAPS + cout;
  const dim3 fgrid((per_member + FINISH_THREADS - 1) / FINISH_THREADS, T);
  conv_wgrad_finish<float><<<fgrid, FINISH_THREADS, 0, s>>>(
      pp, dp, static_cast<float*>(dw), static_cast<float*>(db), cin, cout, splits, transposed);
  return static_cast<int>(cudaGetLastError());
}

// out: 3 ints a kernel function, in the order of KERNELS (conv_fwd_f32's
// full tiles <16, 32, 64>, conv_fwd_bf16 <16, 32, 64>, conv_wgrad_f32
// <16, 32, 64>, conv_wgrad_bf16 <64, 32>, <64, 16>, <32, 32>, <32, 16>,
// conv_wgrad_finish<float>, then
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
