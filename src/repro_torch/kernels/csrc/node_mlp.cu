// node_mlp.cu — y = act(x @ w + b), IEEE fp32 on CUDA cores.
//
// Replaces: src/repro/kernels/node_mlp.py:node_mlp (Pallas body _mlp_kernel),
// the Node-Embedding PE that runs every dense linear of the GNN models.
//
// Bound on the H100: the GNN linears are thin (K, N <= 200), so at the
// serving shapes the kernel moves x once and writes y once; a (4096, 100)
// x (100, 200) product is ~164 MFLOP over ~5 MB, about 2.4 us of fp32
// CUDA-core time against ~1.5 us of HBM time.  At these sizes the launch
// (a few microseconds) is the real floor.
//
// Design: a classic shared-memory tiled SGEMM.  Each 256-thread block owns a
// 64x64 output tile, streams 16-deep slices of x and w through shared memory
// and keeps a 4x4 register accumulator per thread.  Ragged M/K/N edges are
// masked in the loads and the store, so the wrapper never pads.  The bias and
// the activation are applied in the epilogue and y is written exactly once.
// No TF32 and no tensor cores: the JAX kernel and its oracle are IEEE fp32,
// and fp32 operands cannot reach the tensor cores without TF32.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;       // output rows per block
constexpr int BN = 64;       // output columns per block
constexpr int BK = 16;       // reduction depth per shared-memory slice
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

enum Activation { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2 };

__device__ __forceinline__ float activate(float y, int act) {
  if (act == ACT_RELU) return fmaxf(y, 0.f);
  if (act == ACT_GELU) {
    // tanh approximation, the default of jax.nn.gelu
    const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
    const float kKappa = 0.044715f;
    const float inner = kBeta * (y + kKappa * y * y * y);
    return 0.5f * y * (1.f + tanhf(inner));
  }
  return y;
}

__global__ void __launch_bounds__(THREADS)
node_mlp_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ b, float* __restrict__ y,
                int M, int K, int N, int act) {
  // x tile stored transposed, padded by one column against bank conflicts
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output column lane
  const int ty = tid / 16;  // output row lane
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x slice: BM x BK, consecutive threads on consecutive k (coalesced)
#pragma unroll
    for (int l = 0; l < (BM * BK) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int r = idx / BK, c = idx % BK;
      const int m = m0 + r, k = k0 + c;
      xs[c][r] = (m < M && k < K) ? x[(size_t)m * K + k] : 0.f;
    }
    // w slice: BK x BN, consecutive threads on consecutive n (coalesced)
#pragma unroll
    for (int l = 0; l < (BK * BN) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int r = idx / BN, c = idx % BN;
      const int k = k0 + r, n = n0 + c;
      ws[r][c] = (k < K && n < N) ? w[(size_t)k * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) y[(size_t)m * N + n] = activate(acc[i][j] + b[n], act);
    }
  }
}

}  // namespace

// Plain C entry point (loaded through ctypes).  Launches on `stream`, does
// not synchronise, and returns the launch's cudaError_t (0 on success).
extern "C" int node_mlp_f32(const float* x, const float* w, const float* b,
                            float* y, int m, int k, int n, int act,
                            cudaStream_t stream) {
  if (m <= 0 || n <= 0) return (int)cudaSuccess;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  node_mlp_kernel<<<grid, THREADS, 0, stream>>>(x, w, b, y, m, k, n, act);
  return (int)cudaGetLastError();
}
