// The fleet's initial weights in one host pass: torch's CPU generator stream
// (ATen's mt19937, seeded as torch.manual_seed seeds it) read through the
// float32 transform of Tensor.uniform_, one 32-bit output an element, into
// segments of (members, stride) float32 rows, member after member.
//
// Bit for bit torch's (ATen/native/cpu/DistributionTemplates.h uniform_kernel,
// ATen/core/TransformationHelper.h uniform_real): an output v gives the float
// x = (v & 0xFFFFFF) * 2^-24, exact, and the element fma(x, hi - lo, lo) in
// float32, rounded once, as torch's CPU build contracts x * (hi - lo) + lo;
// an element that rounds to hi is lo instead.  Built with -ffp-contract=off:
// the one FMA is the explicit one.
//
// Build: c++ -std=c++17 -O3 -shared -fPIC -ffp-contract=off (ops/cuda_build.py).

#include <cstdint>

// one copy of the pass a level of the x86-64 vector ISA (v4: AVX-512, v3:
// AVX2 with FMA), the highest the host has chosen at load; the default copy
// takes fmaf from the C library, as exact and slower
#if defined(__x86_64__)
#define WIDEST __attribute__((target_clones("arch=x86-64-v4", "arch=x86-64-v3", "default")))
#else
#define WIDEST
#endif

namespace {

constexpr int N = 624;
constexpr int M = 397;
constexpr uint32_t MATRIX_A = 0x9908b0dfu;
constexpr uint32_t UPPER = 0x80000000u;
constexpr uint32_t LOWER = 0x7fffffffu;

inline uint32_t twist(uint32_t u, uint32_t v) {
  return (((u & UPPER) | (v & LOWER)) >> 1) ^ ((v & 1u) ? MATRIX_A : 0u);
}

struct Stream {
  uint32_t state[N];
  int next = N;  // the next unread word of state; N: twist first

  explicit Stream(uint32_t seed) {
    state[0] = seed;
    for (int j = 1; j < N; ++j)
      state[j] = 1812433253u * (state[j - 1] ^ (state[j - 1] >> 30)) + uint32_t(j);
  }

  // the next 624 words, as at::mt19937::next_state makes them
  void refill() {
    uint32_t* s = state;
    for (int j = 0; j < N - M; ++j) s[j] = s[j + M] ^ twist(s[j], s[j + 1]);
    for (int j = N - M; j < N - 1; ++j) s[j] = s[j + M - N] ^ twist(s[j], s[j + 1]);
    s[N - 1] = s[M - 1] ^ twist(s[N - 1], s[0]);
    next = 0;
  }

  // n elements of uniform_(lo, hi) into dst, in order
  void fill(float* dst, int64_t n, float lo, float hi) {
    const float range = hi - lo;
    while (n > 0) {
      if (next == N) refill();
      const int k = n < N - next ? int(n) : N - next;
      const uint32_t* src = state + next;
      for (int j = 0; j < k; ++j) {
        uint32_t y = src[j];
        y ^= y >> 11;
        y ^= (y << 7) & 0x9d2c5680u;
        y ^= (y << 15) & 0xefc60000u;
        y ^= y >> 18;
        const float x = float(int32_t(y & 0xFFFFFFu)) * 0x1p-24f;
        const float v = __builtin_fmaf(x, range, lo);
        dst[j] = v == hi ? lo : v;
      }
      next += k;
      dst += k;
      n -= k;
    }
  }
};

}  // namespace

extern "C" {

// Members' rows rows[i * stride + offset[s] .. + count[s]) for i < members
// and each segment s in turn, drawn from one stream seeded with seed (the
// low 32 bits of torch's seed).  Returns the elements drawn.
WIDEST
int64_t draw_segments(uint32_t seed, float* rows, int64_t members, int64_t stride,
                      const int64_t* offset, const int64_t* count, const float* lo,
                      const float* hi, int64_t segments) {
  Stream stream(seed);
  int64_t drawn = 0;
  for (int64_t i = 0; i < members; ++i) {
    float* row = rows + i * stride;
    for (int64_t s = 0; s < segments; ++s) {
      stream.fill(row + offset[s], count[s], lo[s], hi[s]);
      drawn += count[s];
    }
  }
  return drawn;
}

}  // extern "C"
