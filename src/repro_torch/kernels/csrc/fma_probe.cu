// fma_probe.cu — how fast the 4 x 4 register tiles of fused_mp's products
// (csrc/fused_mp.cu: gemm_f32) can run FMAs on one SM, with their operands
// read from shared memory as the products read them, or held in registers.
//
// A diagnostic, not a kernel of the port (kernels/fused_mp_phases.py runs
// it).  Each block has 256 threads, as fused_mp's; thread t owns rows 4 (t %
// 8) .. + 3 and, per group g < G, columns 128 g + 4 (t / 8) .. + 3 of a
// 32-row tile, and per k reads one float4 of the k-major operand (32 + 4
// words a k) and G float4 of the staged weight slice (128 G columns a k),
// loading the next k's while this k's 16 G FMAs run (fused_mp's order).
// With SMEM false the same FMAs take operands that stay in registers.  The
// caller sizes the grid (one or two blocks per SM); thread 0 of each block
// records the clock64() cycles of its loop.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int KS = 32;       // k of one staged slice
constexpr int PA = 36;       // words a k of the row operand

template <int G, bool SMEM>
__global__ void __launch_bounds__(THREADS, 2) fma_probe_kernel(int reps, float* out,
                                                            long long* cycles) {
  __shared__ __align__(16) float a_s[KS * PA];
  __shared__ __align__(16) float w_s[KS * 128 * G];
  const int tid = threadIdx.x;
  for (int i = tid; i < KS * PA; i += THREADS) a_s[i] = 1e-3f * (i % 97);
  for (int i = tid; i < KS * 128 * G; i += THREADS) w_s[i] = 1e-3f * (i % 89);
  __syncthreads();
  const int row0 = 4 * (tid % 8), col = 4 * (tid / 8);
  float acc[G][4][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[g][i][j] = 0.f;
  float4 a0, b0[G], a1, b1[G];
  auto load = [&](float4& av, float4 (&bv)[G], int k) {
    av = *reinterpret_cast<const float4*>(a_s + k * PA + row0);
#pragma unroll
    for (int g = 0; g < G; ++g)
      bv[g] = *reinterpret_cast<const float4*>(w_s + k * 128 * G + 128 * g + col);
  };
  auto fma_k = [&](const float4& av, const float4 (&bv)[G]) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float x[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[g][i][0] = fmaf(x[i], bv[g].x, acc[g][i][0]);
        acc[g][i][1] = fmaf(x[i], bv[g].y, acc[g][i][1]);
        acc[g][i][2] = fmaf(x[i], bv[g].z, acc[g][i][2]);
        acc[g][i][3] = fmaf(x[i], bv[g].w, acc[g][i][3]);
      }
    }
  };
  load(a0, b0, 0);
  load(a1, b1, 1);
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
#pragma unroll 1
    for (int kk = 0; kk < KS; kk += 2) {
      if (SMEM) load(a1, b1, kk + 1);
      fma_k(a0, b0);
      if (SMEM) load(a0, b0, (kk + 2) % KS);
      fma_k(a1, b1);
    }
  }
  const long long t1 = clock64();
  float s = 0.f;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s += acc[g][i][j];
  out[blockIdx.x * THREADS + tid] = s;
  if (tid == 0) cycles[blockIdx.x] = t1 - t0;
}

template <int G, bool SMEM>
int launch(int blocks, int reps, float* out, long long* cycles) {
  fma_probe_kernel<G, SMEM><<<blocks, THREADS>>>(reps, out, cycles);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch the probe on the default stream: g (1 or 2 column groups), smem (1:
// operands from shared memory, 0: from registers), `blocks` blocks of 256
// threads, `reps` passes over a 32-deep slice.  out: blocks x 256 floats;
// cycles: blocks values.  Returns the launch's cudaError_t.
extern "C" int fma_probe_launch(int g, int smem, int blocks, int reps, float* out,
                                long long* cycles) {
  if (g == 1) return smem ? launch<1, true>(blocks, reps, out, cycles)
                          : launch<1, false>(blocks, reps, out, cycles);
  if (g == 2) return smem ? launch<2, true>(blocks, reps, out, cycles)
                          : launch<2, false>(blocks, reps, out, cycles);
  return (int)cudaErrorInvalidValue;
}
