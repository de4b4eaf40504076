// One clip -> decay -> Adam step on bf16-stored weights and moments of a whole
// fleet of models, written back with stochastic rounding, by hand for Hopper
// (sm_90a).  In place, one launch for all members.
//
// For member t and element j of its row (all arithmetic in float32, one
// rounding per operation, IEEE quotient and root, in this order):
//
//   g  = g_norm[t] < clip ? g : (g / g_norm[t]) * clip
//   g  = g + wd*p
//   m' = (1-b1)*g + b1*m
//   v' = (1-b2)*(g*g) + b2*v
//   u  = -lr * ((m' / bc1[t]) / (sqrt(v' / bc2[t]) + eps))
//   h  = mix(base[j] + salt[t])            murmur finalizer, uint32, wrapping
//   p  <- sr(p + u, h);  m <- sr(m', h ^ 0x55555555);  v <- sr(v', h + 0x33333333)
//
// sr(x, h): add the low 16 bits of h to the float's bit pattern and clear the
// low 16 bits, which leaves a bf16; a finite x that carried into the infinity
// pattern saturates at +-bf16-max, and a NaN stays a NaN whatever its payload
// (the card's own NaN, 0x7fffffff, would otherwise carry into -0).  A member
// whose finite[t] is 0 is not written.
//
// Replaces lesionvae_tpu/train/lowmem.py::_fused_update (with _hash_bits and
// _store_round), which is no Pallas kernel: XLA fuses it into one loop on the
// TPU.  Plain PyTorch runs it as some forty elementwise kernels over int64
// and float32 temporaries of T*n elements each, every training step.
//
// What bounds it.  Device memory moves 14 bytes an element (p, m, v read and
// written, g read; the index table's 4 bytes are not among them: all members
// share the table, which stays in L2).  The formula can be written in about
// 65 instructions an element, half the time of those bytes at 128 lanes a
// clock and SM; as built here, with nvcc's __fdiv_rn and __fsqrt_rn and their
// range tests and slow paths, the loop holds 141.6 instructions an element
// and 87 registers a thread (cuobjdump -sass, -Xptxas -v), whose issue takes
// as long as the bytes.  So neither alone bounds this version; it is the
// simple design, not yet the fast one: blockIdx.y is the member, a grid-stride loop over the row, each
// thread takes 8 consecutive bf16 of p, m, v and g with one 16-byte load each
// and 8 table words with two, and stores three 16-byte words.  Rows start on
// 16-byte boundaries (the caller pads the row stride to a multiple of 8); the
// last n % 8 elements of a row go one a thread.  The per-member scalars are
// read once a thread.  The clip branch is uniform over a block.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;    // bf16 per 16-byte load
constexpr int PAIRS = 4;  // packed bf16 pairs per 16-byte load

struct Consts {
  float clip, wd, b1, one_minus_b1, b2, one_minus_b2, neg_lr, eps;
};

struct Member {
  float g_norm, bc1, bc2;
  uint32_t salt;
  bool scale;  // the gradient is over the clip: scale it to the clip
};

__device__ __forceinline__ uint32_t mix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// x rounded stochastically to bf16 with the low 16 bits of `bits`; returns
// the bf16 pattern in the low half
__device__ __forceinline__ uint32_t sr_bf16(float x, uint32_t bits) {
  const uint32_t u = __float_as_uint(x);
  uint32_t r = (u + (bits & 0xffffu)) & 0xffff0000u;
  const bool x_finite = (u & 0x7f800000u) != 0x7f800000u;
  const bool r_finite = (r & 0x7f800000u) != 0x7f800000u;
  if (x_finite && !r_finite) r = (u & 0x80000000u) | 0x7f7f0000u;
  if ((u & 0x7fffffffu) > 0x7f800000u) r = 0x7fc00000u;  // NaN stays NaN
  return r >> 16;
}

// one element: bf16 patterns of the new p, m, v
__device__ __forceinline__ void update1(float p, float m, float v, float g,
                                        uint32_t base, const Consts& q,
                                        const Member& w, uint32_t& p_out,
                                        uint32_t& m_out, uint32_t& v_out) {
  if (w.scale) g = __fmul_rn(__fdiv_rn(g, w.g_norm), q.clip);
  g = __fadd_rn(g, __fmul_rn(q.wd, p));
  const float m2 = __fadd_rn(__fmul_rn(q.one_minus_b1, g), __fmul_rn(q.b1, m));
  const float v2 =
      __fadd_rn(__fmul_rn(q.one_minus_b2, __fmul_rn(g, g)), __fmul_rn(q.b2, v));
  const float d = __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, w.bc2)), q.eps);
  const float u = __fmul_rn(q.neg_lr, __fdiv_rn(__fdiv_rn(m2, w.bc1), d));
  const uint32_t h = mix(base + w.salt);
  p_out = sr_bf16(__fadd_rn(p, u), h);
  m_out = sr_bf16(m2, h ^ 0x55555555u);
  v_out = sr_bf16(v2, h + 0x33333333u);
}

__device__ __forceinline__ float lo_f32(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f32(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

struct Packed8 {
  uint32_t w[PAIRS];
};

__device__ __forceinline__ Packed8 load8(const uint16_t* row, int64_t i) {
  const uint4 u = reinterpret_cast<const uint4*>(row)[i];
  return Packed8{{u.x, u.y, u.z, u.w}};
}

__device__ __forceinline__ void store8(uint16_t* row, int64_t i, const Packed8& x) {
  reinterpret_cast<uint4*>(row)[i] = make_uint4(x.w[0], x.w[1], x.w[2], x.w[3]);
}

__global__ void __launch_bounds__(THREADS)
sr_adam_kernel(uint16_t* __restrict__ p, uint16_t* __restrict__ m,
               uint16_t* __restrict__ v, const uint16_t* __restrict__ g,
               const uint32_t* __restrict__ base,
               const float* __restrict__ g_norm, const float* __restrict__ bc1,
               const float* __restrict__ bc2, const int64_t* __restrict__ salt,
               const uint8_t* __restrict__ finite, int64_t n, int64_t stride,
               Consts q) {
  const int t = blockIdx.y;
  if (!finite[t]) return;
  Member w;
  w.g_norm = g_norm[t];
  w.bc1 = bc1[t];
  w.bc2 = bc2[t];
  w.salt = static_cast<uint32_t>(salt[t]);
  w.scale = !(w.g_norm < q.clip);

  uint16_t* p_row = p + t * stride;
  uint16_t* m_row = m + t * stride;
  uint16_t* v_row = v + t * stride;
  const uint16_t* g_row = g + t * stride;

  const int64_t n_vec = n / VEC;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t step = static_cast<int64_t>(gridDim.x) * THREADS;

  for (int64_t i = first; i < n_vec; i += step) {
    Packed8 pp = load8(p_row, i), mm = load8(m_row, i), vv = load8(v_row, i);
    const Packed8 gg = load8(g_row, i);
    const uint4 b0 = reinterpret_cast<const uint4*>(base)[2 * i];
    const uint4 b1 = reinterpret_cast<const uint4*>(base)[2 * i + 1];
    const uint32_t b[VEC] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int j = 0; j < PAIRS; ++j) {
      uint32_t p0, m0, v0, p1, m1, v1;
      update1(lo_f32(pp.w[j]), lo_f32(mm.w[j]), lo_f32(vv.w[j]), lo_f32(gg.w[j]),
              b[2 * j], q, w, p0, m0, v0);
      update1(hi_f32(pp.w[j]), hi_f32(mm.w[j]), hi_f32(vv.w[j]), hi_f32(gg.w[j]),
              b[2 * j + 1], q, w, p1, m1, v1);
      pp.w[j] = p0 | (p1 << 16);
      mm.w[j] = m0 | (m1 << 16);
      vv.w[j] = v0 | (v1 << 16);
    }
    store8(p_row, i, pp);
    store8(m_row, i, mm);
    store8(v_row, i, vv);
  }

  // the last n % 8 elements of the row, one a thread of the first block
  const int64_t e = n_vec * VEC + first;
  if (e < n) {
    uint32_t p0, m0, v0;
    update1(__uint_as_float(static_cast<uint32_t>(p_row[e]) << 16),
            __uint_as_float(static_cast<uint32_t>(m_row[e]) << 16),
            __uint_as_float(static_cast<uint32_t>(v_row[e]) << 16),
            __uint_as_float(static_cast<uint32_t>(g_row[e]) << 16), base[e], q, w,
            p0, m0, v0);
    p_row[e] = static_cast<uint16_t>(p0);
    m_row[e] = static_cast<uint16_t>(m0);
    v_row[e] = static_cast<uint16_t>(v0);
  }
}

}  // namespace

// p, m, v, g: bf16 (members, n) with `stride` elements between rows (a
// multiple of 8, rows on 16-byte boundaries); base: uint32 (n); g_norm, bc1,
// bc2: float32 (members); salt: int64 (members), taken modulo 2^32; finite:
// one byte a member.
extern "C" int lesionvae_sr_adam(void* p, void* m, void* v, const void* g,
                                 const void* base, const void* g_norm,
                                 const void* bc1, const void* bc2,
                                 const void* salt, const void* finite,
                                 int members, long long n, long long stride,
                                 float clip, float wd, float b1,
                                 float one_minus_b1, float b2, float one_minus_b2,
                                 float neg_lr, float eps, void* stream) {
  if (members <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (members > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_vec = n / VEC;
  long long blocks = (n_vec + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;  // the scalar tail still needs threads
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;  // grid-stride covers the rest
  const Consts q{clip, wd, b1, one_minus_b1, b2, one_minus_b2, neg_lr, eps};
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(members));
  sr_adam_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint16_t*>(p), static_cast<uint16_t*>(m),
      static_cast<uint16_t*>(v), static_cast<const uint16_t*>(g),
      static_cast<const uint32_t*>(base), static_cast<const float*>(g_norm),
      static_cast<const float*>(bc1), static_cast<const float*>(bc2),
      static_cast<const int64_t*>(salt), static_cast<const uint8_t*>(finite),
      static_cast<int64_t>(n), static_cast<int64_t>(stride), q);
  return static_cast<int>(cudaGetLastError());
}
