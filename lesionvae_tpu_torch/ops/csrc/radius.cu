// Star-convex radius sampling for a batch of lesions, by hand for Hopper (sm_90a).
//
//   r[b, d] = max_{j < count_b} <dir_d, surface[b, j] - centroid_b>,   r = 0 when count_b == 0
//
// Replaces lesionvae_tpu/ops/pallas_radius.py::_radius_kernel (the TPU kernel,
// driven by sample_radii_pallas / sample_radii_padded).  It computes the same
// function; it does not copy the TPU's (8 lesions x 256 directions) VMEM tiling.
//
// What bounds it: the SM's issue slots, not bytes.  The depth is 3, so a
// point-direction pair is one multiply, two FMAs and one max and a tensor core
// has nothing to chew on (and TF32 would not hold 1e-5 on coordinates of tens
// of voxels).  An SM issues 128 lanes a clock; at 4 instructions a pair plus
// one shared load shared by RD = 8 pairs that is at best 31 pairs a clock an
// SM.  The inputs and outputs are a few MB, ~1 us at 3.35 TB/s.  At tens of
// microseconds a call, what does not scale with the pairs counts as well:
// two launches, the first wave's loads, the atomics, uneven SMs.
//
// Design.
// - Equal work a block: grid (ceil(D / (TD*RD)), ceil(N / CHUNK), B).  A block
//   takes CHUNK of its lesion's points and TD*RD directions, whatever count_b
//   is; a block whose chunk starts at or beyond count_b returns at once (pad
//   rows are never read, so no mask).  Large lesions become many blocks and no
//   block finishes long after the others.
// - Few slots a pair: a thread keeps RD directions in registers and reads a
//   staged point once for all of them (one 16-byte shared load, the same
//   address in every thread: a broadcast), two points an iteration into
//   independent running maxima.  The (D, N) projection never exists anywhere.
// - Staging: the chunk's 3*m floats are contiguous.  They are read with
//   16-byte loads from the first 16-byte boundary on (a lesion's rows start at
//   b*N*3 floats, aligned only for some N) and with scalar loads before it and
//   in the tail, and written to shared memory as float4 (x, y, z, -) with the
//   centroid subtracted (fusing the centring pallas_radius.py:71 does outside
//   its kernel).  An odd count is made even by repeating the last point, which
//   changes no maximum.
// - Merging the chunks' partial maxima: the output row is the running maximum
//   itself.  The C call first sets every output word to 0xffffffff with a
//   small kernel of its own, then each block merges with an atomic on the float's
//   bits: a value with the sign bit clear by atomicMax as a signed integer, a
//   value with it set by atomicMin as an unsigned one.  Under that pair the
//   bit patterns are totally ordered, 0xffffffff at the bottom, then -inf up
//   to -0, then +0 up to +inf, then the NaN 0x7fffffff at the top, and the
//   merge is the maximum in that order: it does not depend on the order of
//   arrival, so every call gives the same bits.  No scratch, no second pass.
//   The block of chunk 0 of an empty lesion writes the 0.
// - The two kernels overlap (programmatic dependent launch, sm_90): the first
//   lets its dependent start at once, and the radius kernel waits for it
//   (griddepcontrol.wait) only where it first touches the output, after its
//   arithmetic.  At tens of microseconds a call, a launch gap counts.
//
// NaN: the running max propagates a NaN projection of a counted point, as
// jnp.max and torch.amax do (fmaxf would skip it): PTX max.NaN (sm_80+) is
// one instruction, as fmaxf is; a NaN partial maximum is merged as 0x7fffffff.
// Pad rows are never read, so a NaN there changes nothing.
//
// C interface (loaded with ctypes): returns the first error of the two
// launches.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// Measured on an H100 (main path of the lesion stage: 78 lesions, 53,776
// points, 2000 directions): RD 4 -> 8 took 27.7 -> 25.4 us at CHUNK 128, RD 16
// 35 us; CHUNK 256 / 128 / 64 / 32 at RD 8: 31 (RD 4) / 25.4 / 24.2 / 25.9 us.
constexpr int TD = 128;    // threads per block
constexpr int RD = 8;      // directions per thread
constexpr int CHUNK = 64;  // points per block (1 KB of shared memory); even

// max(a, b), NaN if either is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// *addr = max(*addr, x) in the order described above
__device__ __forceinline__ void merge_max(float* addr, float x) {
  if (x != x) x = __int_as_float(0x7fffffff);
  if (__float_as_int(x) >= 0)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(x));
  else
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(x));
}

// every word of out = 0xffffffff, below every value in merge_max's order
__global__ void __launch_bounds__(256)
preset_kernel(uint32_t* __restrict__ out, size_t n) {
  asm volatile("griddepcontrol.launch_dependents;");
  const size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x;
  const size_t n4 = n / 4;  // out comes from the allocator: 16-byte aligned
  if (i < n4)
    reinterpret_cast<uint4*>(out)[i] =
        make_uint4(0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu);
  if (i < n - 4 * n4) out[4 * n4 + i] = 0xffffffffu;
}

__global__ void __launch_bounds__(TD)
radius_kernel(const float* __restrict__ surface,     // (B, N, 3)
              const int* __restrict__ counts,        // (B,)
              const float* __restrict__ centroids,   // (B, 3)
              const float* __restrict__ directions,  // (D, 3)
              float* __restrict__ out,               // (B, D), preset to 0xffffffff
              int N, int D) {
  __shared__ float4 pts[CHUNK];

  const int b = blockIdx.z;
  const int c0 = blockIdx.y * CHUNK;
  const int d0 = blockIdx.x * (TD * RD) + threadIdx.x;
  const int n = min(counts[b], N);
  float* row = out + static_cast<size_t>(b) * D;

  // the directions: loads that wait for nothing, issued first
  float dx[RD], dy[RD], dz[RD];
#pragma unroll
  for (int r = 0; r < RD; ++r) {
    const int d = min(d0 + r * TD, D - 1);
    dx[r] = directions[3 * d + 0];
    dy[r] = directions[3 * d + 1];
    dz[r] = directions[3 * d + 2];
  }

  if (n <= 0) {  // an empty lesion: r = 0, written by its chunk-0 blocks
    if (c0 == 0) {
      asm volatile("griddepcontrol.wait;" ::: "memory");
#pragma unroll
      for (int r = 0; r < RD; ++r)
        if (d0 + r * TD < D) row[d0 + r * TD] = 0.f;
    }
    return;
  }
  if (c0 >= n) return;
  const int m = min(CHUNK, n - c0);

  // stage the chunk: float f of it is coordinate f % 3 of point f / 3
  const float cx = centroids[3 * b + 0];
  const float cy = centroids[3 * b + 1];
  const float cz = centroids[3 * b + 2];
  const float* src = surface + (static_cast<size_t>(b) * N + c0) * 3;
  float* dst = reinterpret_cast<float*>(pts);
  const int total = 3 * m;
  const int head = min(total, static_cast<int>((4 - ((reinterpret_cast<uintptr_t>(src) >> 2) & 3)) & 3));
  const int n_vec = (total - head) / 4;
  auto put = [&](int f, float x) {
    const int j = f / 3, k = f - 3 * j;
    dst[4 * j + k] = x - (k == 0 ? cx : k == 1 ? cy : cz);
  };
  for (int i = threadIdx.x; i < n_vec; i += TD) {
    const float4 x = reinterpret_cast<const float4*>(src + head)[i];
    const int f = head + 4 * i;
    put(f, x.x);
    put(f + 1, x.y);
    put(f + 2, x.z);
    put(f + 3, x.w);
  }
  const int rest = total - 4 * n_vec;  // the head and the tail, scalar
  for (int i = threadIdx.x; i < rest; i += TD) {
    const int f = i < head ? i : 4 * n_vec + i;
    put(f, src[f]);
  }

  __syncthreads();
  if (m & 1) {  // an even count: the last point once more
    if (threadIdx.x == 0) pts[m] = pts[m - 1];
    __syncthreads();
  }

  float r0[RD], r1[RD];
#pragma unroll
  for (int r = 0; r < RD; ++r) r0[r] = r1[r] = -CUDART_INF_F;
#pragma unroll 4
  for (int j = 0; j < m; j += 2) {
    const float4 q0 = pts[j];
    const float4 q1 = pts[j + 1];
#pragma unroll
    for (int r = 0; r < RD; ++r) {
      r0[r] = max_nan(r0[r], fmaf(dz[r], q0.z, fmaf(dy[r], q0.y, dx[r] * q0.x)));
      r1[r] = max_nan(r1[r], fmaf(dz[r], q1.z, fmaf(dy[r], q1.y, dx[r] * q1.x)));
    }
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the output is preset
#pragma unroll
  for (int r = 0; r < RD; ++r)
    if (d0 + r * TD < D) merge_max(row + d0 + r * TD, max_nan(r0[r], r1[r]));
}

}  // namespace

extern "C" int lesionvae_radius(const float* surface, const int* counts,
                                const float* centroids, const float* directions,
                                float* out, int B, int N, int D, void* stream) {
  if (B == 0 || D == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t words = static_cast<size_t>(B) * D;
  preset_kernel<<<static_cast<unsigned>((words / 4 + 256) / 256), 256, 0, s>>>(
      reinterpret_cast<uint32_t*>(out), words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // N = 0 still needs the blocks that write the zeros
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((D + TD * RD - 1) / (TD * RD),
                        ((N > 0 ? N : 1) + CHUNK - 1) / CHUNK, B);
  config.blockDim = dim3(TD);
  config.stream = s;
  cudaLaunchAttribute overlap = {};
  overlap.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  overlap.val.programmaticStreamSerializationAllowed = 1;
  config.attrs = &overlap;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, radius_kernel, surface, counts, centroids,
                           directions, out, N, D);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
