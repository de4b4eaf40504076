// Star-convex radius sampling for a batch of lesions, by hand for Hopper (sm_90a).
//
//   r[b, d] = max_{j < count_b} <dir_d, surface[b, j] - centroid_b>,   r = 0 when count_b == 0
//
// Replaces lesionvae_tpu/ops/pallas_radius.py::_radius_kernel (the TPU kernel,
// driven by sample_radii_pallas / sample_radii_padded).  It computes the same
// function; it does not copy the TPU's (8 lesions x 256 directions) VMEM tiling.
//
// What bounds it: CUDA-core FP32 work, not bytes.  K = 3, so each
// point-direction pair is 3 FMA + 1 max and a tensor-core GEMM has nothing to
// chew on.  At full scale (104 lesions x 2000 directions x <= 2000 points)
// that is <= 4.2e8 pairs, ~1.25e9 FMA: tens of microseconds on the card's
// FP32 pipes, against ~3.3 MB of inputs and outputs (~1 us at 3.35 TB/s).
//
// Design: grid (ceil(D / TD), B), one thread per direction, TD = 128.  A block
// walks only its lesion's first count_b points (pad rows are never read, so no
// mask), staging CHUNK of them at a time in shared memory with the centroid
// already subtracted (fusing the centring pallas_radius.py:71 does outside its
// kernel).  Points are staged as float4 (x, y, z, 0) so that each thread reads
// a point with one 16-byte broadcast load, then keeps a running max in a
// register.  The (D, N) projection never exists anywhere.
//
// NaN: the running max propagates a NaN projection of a counted point, as
// jnp.max and torch.amax do (fmaxf would skip it): PTX max.NaN (sm_80+) is
// one instruction, as fmaxf is.  Pad rows are never read, so a NaN there
// changes nothing.
//
// C interface (loaded with ctypes): returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TD = 128;      // directions (threads) per block
constexpr int CHUNK = 1024;  // points staged in shared memory at a time (16 KB)

// max(a, b), NaN if either is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__global__ void __launch_bounds__(TD)
radius_kernel(const float* __restrict__ surface,     // (B, N, 3)
              const int* __restrict__ counts,        // (B,)
              const float* __restrict__ centroids,   // (B, 3)
              const float* __restrict__ directions,  // (D, 3)
              float* __restrict__ out,               // (B, D)
              int N, int D) {
  __shared__ float4 pts[CHUNK];

  const int b = blockIdx.y;
  const int d = blockIdx.x * TD + threadIdx.x;
  const int n = min(counts[b], N);  // counts <= 0 give r = 0 below

  float dx = 0.f, dy = 0.f, dz = 0.f;
  if (d < D) {
    dx = directions[3 * d + 0];
    dy = directions[3 * d + 1];
    dz = directions[3 * d + 2];
  }
  const float cx = centroids[3 * b + 0];
  const float cy = centroids[3 * b + 1];
  const float cz = centroids[3 * b + 2];
  const float* lesion = surface + static_cast<size_t>(b) * N * 3;

  float r = -CUDART_INF_F;
  for (int c0 = 0; c0 < n; c0 += CHUNK) {
    const int m = min(CHUNK, n - c0);
    __syncthreads();  // the previous chunk has been read by every thread
    for (int j = threadIdx.x; j < m; j += TD) {
      const float* p = lesion + 3 * static_cast<size_t>(c0 + j);
      pts[j] = make_float4(p[0] - cx, p[1] - cy, p[2] - cz, 0.f);
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < m; ++j) {
      const float4 q = pts[j];
      r = max_nan(r, fmaf(dz, q.z, fmaf(dy, q.y, dx * q.x)));
    }
  }
  if (d < D) out[static_cast<size_t>(b) * D + d] = n > 0 ? r : 0.f;
}

}  // namespace

extern "C" int lesionvae_radius(const float* surface, const int* counts,
                                const float* centroids, const float* directions,
                                float* out, int B, int N, int D, void* stream) {
  if (B == 0 || D == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((D + TD - 1) / TD, B);
  radius_kernel<<<grid, TD, 0, static_cast<cudaStream_t>(stream)>>>(
      surface, counts, centroids, directions, out, N, D);
  return static_cast<int>(cudaGetLastError());
}
