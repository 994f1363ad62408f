// quant_mlp.cu — y = act((x_q @ w_q) * scale * row_scale + b), int8 x int8
// with exact int32 accumulation.
//
// Replaces: src/repro/kernels/quant_mlp.py:quant_node_mlp (Pallas body
// _qmlp_kernel), the quantized Node-Embedding PE that runs every int8 linear
// of the six GNN models (encoder, GCN's lin, GIN's edge embedding and MLP
// unfused, GAT's projection, PNA's pre linear, the virtual node's MLPs).
//
// Bound on the H100: the GNN linears are thin (K, N <= 200), so a call moves
// x_q (M*K bytes) and writes y (4*M*N bytes) once; (4096, 100) x (100, 200)
// is ~3.7 MB, ~1.1 us of HBM time, against ~0.08 us of int8 tensor-core time
// for its 164 M operations.  The output dominates the bytes, and at these
// sizes the launch (a few microseconds) is the real floor.
//
// Design: a shared-memory tiled GEMM on CUDA cores.  Each 256-thread block
// owns a 64x64 output tile and streams 32-deep slices of x_q and w_q through
// shared memory, packed four int8 values of K to a 32-bit word (w_q is
// transposed while it is packed), and each thread keeps a 4x4 block of int32
// accumulators fed by __dp4a.  Ragged M/K/N are masked in the loads: an int8
// zero adds nothing, so nothing is padded on the host.  The epilogue keeps the
// JAX order, ((float)acc * scale[c]) * row_scale[r] + b[c], with __fmul_rn /
// __fadd_rn so that nvcc cannot contract it into an FMA, then the activation;
// y is written once.  No tensor cores yet (mma.sync s8 / wgmma are for a later
// PR): the first version is simple and exact.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output columns per block
constexpr int BK = 32;        // reduction depth per shared-memory slice
constexpr int KW = BK / 4;    // packed 32-bit words per slice row
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

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

// Four int8 values as the bytes of one word, lowest k in the lowest byte
// (the operand layout of __dp4a).
__device__ __forceinline__ int pack4(const signed char v[4]) {
  return (int)((unsigned)(unsigned char)v[0] |
               ((unsigned)(unsigned char)v[1] << 8) |
               ((unsigned)(unsigned char)v[2] << 16) |
               ((unsigned)(unsigned char)v[3] << 24));
}

__global__ void __launch_bounds__(THREADS)
quant_mlp_kernel(const signed char* __restrict__ x,
                 const signed char* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ row_scale,
                 const float* __restrict__ b, float* __restrict__ y,
                 int M, int K, int N, int act) {
  // padded by one word against bank conflicts on the column reads
  __shared__ int xs[BM][KW + 1];  // xs[r][j]: x[m0 + r][k0 + 4j .. 4j + 3]
  __shared__ int ws[BN][KW + 1];  // ws[c][j]: w[k0 + 4j .. 4j + 3][n0 + c]

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output column lane
  const int ty = tid / 16;  // output row lane
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x slice: BM rows x KW words; consecutive threads on consecutive k
#pragma unroll
    for (int l = 0; l < (BM * KW) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int r = idx / KW, j = idx % KW;
      const int m = m0 + r;
      signed char v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int k = k0 + 4 * j + t;
        v[t] = (m < M && k < K) ? x[(size_t)m * K + k] : (signed char)0;
      }
      xs[r][j] = pack4(v);
    }
    // w slice: KW words x BN columns; consecutive threads on consecutive n
#pragma unroll
    for (int l = 0; l < (BN * KW) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int c = idx % BN, j = idx / BN;
      const int n = n0 + c;
      signed char v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int k = k0 + 4 * j + t;
        v[t] = (k < K && n < N) ? w[(size_t)k * N + n] : (signed char)0;
      }
      ws[c][j] = pack4(v);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < KW; ++j) {
      int a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty + 16 * i][j];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = ws[tx + 16 * q][j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = __dp4a(a[i], bv[q], acc[i][q]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const float rs = row_scale ? row_scale[m] : 1.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tx + 16 * q;
      if (n >= N) continue;
      float v = __fmul_rn(__int2float_rn(acc[i][q]), scale[n]);
      if (row_scale) v = __fmul_rn(v, rs);
      y[(size_t)m * N + n] = activate(__fadd_rn(v, b[n]), act);
    }
  }
}

}  // namespace

// Plain C entry point (loaded through ctypes).  `row_scale` may be null (all
// rows scale 1).  Launches on `stream`, does not synchronise, and returns the
// launch's cudaError_t (0 on success).
extern "C" int quant_mlp_i8(const signed char* x, const signed char* w,
                            const float* scale, const float* row_scale,
                            const float* b, float* y, int m, int k, int n,
                            int act, cudaStream_t stream) {
  if (m <= 0 || n <= 0) return (int)cudaSuccess;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  quant_mlp_kernel<<<grid, THREADS, 0, stream>>>(x, w, scale, row_scale, b, y,
                                                 m, k, n, act);
  return (int)cudaGetLastError();
}
