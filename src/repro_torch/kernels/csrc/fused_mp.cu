// fused_mp.cu — one fused (phi, A, gamma) message-passing layer, fp32 or
// with the int8 (W8A8) first linear of gamma.
//
// Replaces: src/repro/kernels/fused_mp.py:fused_mp (Pallas body _fused_kernel)
// with precision="fp32", and its int8 gamma, _gamma_linear (fused_mp.py:50)
// under precision="int8": the paper's single-pass dataflow — gather the
// source rows, transform them (phi), reduce them per destination (A) and
// update the node (gamma) without writing messages or aggregates to memory.
//
// Bound on the H100: per layer the pass must read the (N, F) source and
// residual tables, the edge plan and (for GIN) the (E, F) edge operand, and
// write (N, F_out) once; gamma's matmuls add 2 * N * (K * H + H * F_out)
// fp32 operations.  GIN at N = 4096, E = 12288, F = 100, H = 200 is ~330
// MFLOP over ~10 MB: ~4.9 us of fp32 CUDA-core time against ~3 us of HBM
// time, so the ideal kernel is compute-bound and launch overhead dominates
// at serving sizes.  The gather is irregular (msrc[src[e]]), but each row is
// read whole, so loads stay coalesced along F and hit L2 for repeated
// sources.
//
// Design: the TPU kernel streams edge blocks past resident node blocks and
// reduces with a one-hot MXU matmul; on Hopper that matmul is wasted work.
// Here each block owns a tile of TILE destination nodes and walks the CSR
// ranges offsets[d]..offsets[d+1] of the shared GraphLayout plan: one warp
// per destination, lanes along F, accumulators in registers.  No two blocks
// share a destination, so there are no atomics, and each destination's sum
// runs in sorted-edge order (deterministic).  Padding edges sit past
// offsets[N] and are never read.  The accumulators land in shared memory,
// where gamma runs on the whole tile: GCN's scale, GIN's F -> H -> F MLP,
// PNA's 12F scaler tower, DGN's 3F tower.  The weights are read through
// L1/L2 by one thread per output column, each thread holding TILE row
// accumulators, so a block reads every weight once.  Padded node rows and
// empty max/min rows come out 0.  Products that the plain version rounds
// before a sum are kept separate (__fmul_rn / __fadd_rn) so that nvcc cannot
// contract them into an FMA.
//
// int8 gamma (gin / pna / dgn): after the tower is built, one warp per tile
// row reduces max|t| over K1 with a shuffle max, takes the row scale
// rs = max(m, 1e-8) / 127 (1e-8 is quant/qconfig._EPS), and stores
// q = clamp(rint(t / rs), -128, 127) as an int8 TILE x K1 tile in shared
// memory: IEEE division (no fast math) and round-half-to-even, as torch.round
// and jnp.round do (roundf would round half away from zero).  Each column
// thread then accumulates q x w1 (int8) in int32, exact, and applies
// relu((float)acc * (rs * s1[c]) + b1[c]), the order of the JAX kernel's
// tail.  |acc| <= 127 * 128 * K1 stays below 2^24 for K1 <= 1032 (PNA: 960),
// so the conversion to float is exact.  GIN's second linear stays fp32 over
// the dequantized w2; PNA and DGN add the residual.  GCN's gamma has no
// linear, so the precision changes nothing there.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 16;      // destination nodes per block
constexpr int THREADS = 256;  // 8 warps; one destination per warp at a time
constexpr int WARPS = THREADS / 32;
constexpr int MAXV = 8;       // features per lane: F <= 32 * MAXV = 256

enum { OP_SUM = 1, OP_SQSUM = 2, OP_MAX = 4, OP_MIN = 8, OP_WSUM = 16 };
enum { PHI_COPY = 0, PHI_ADD_RELU = 1 };
enum { GAMMA_GCN = 0, GAMMA_GIN = 1, GAMMA_PNA = 2, GAMMA_DGN = 3 };

struct Args {
  const int* offsets;          // (N + 1,) CSR offsets of the plan
  const int* src;              // (E,) source ids in plan order
  const float* msrc;           // (N, F) message operand
  const float* x_res;          // (N, Fr) residual / self operand
  const float* nop;            // (N, P) per-node operand or null
  const float* eop;            // (E, F) phi edge operand or null
  const float* ew;             // (E,) wsum edge weights or null
  const int* deg;              // (N,) real in-degree
  const unsigned char* mask;   // (N,) node mask
  const void* w1;              // (K1, H1) gamma's first linear, f32 or int8
  const float* b1;             // (H1,)
  const float* s1;             // (H1,) int8 weight scales or null
  const float* w2;             // (H1, F_out) GIN's second linear or null
  const float* b2;             // (F_out,)
  float* out;                  // (N, F_out)
  int n, f, fr, p, k1, h1, f_out;
  int phi, ops, gamma, int8;
};

__device__ __forceinline__ int slot_of(int ops, int bit) {
  return __popc(ops & (bit - 1));
}

// acc[r] = sum_k T[r][k] * W[k][c] for the TILE rows of the tile; every
// thread of a warp reads the same T element (a shared-memory broadcast).
__device__ __forceinline__ void tile_column(const float* T, int k,
                                            const float* __restrict__ W,
                                            int h, int c, float acc[TILE]) {
#pragma unroll
  for (int r = 0; r < TILE; ++r) acc[r] = 0.f;
  for (int kk = 0; kk < k; ++kk) {
    const float wv = __ldg(W + (size_t)kk * h + c);
#pragma unroll
    for (int r = 0; r < TILE; ++r) acc[r] = fmaf(T[r * k + kk], wv, acc[r]);
  }
}

// relu(T @ w1 + b1) at column c of w1 (h columns) for the TILE rows of the
// tile: fp32 over the tower T, or int8 over its quantized copy Q with the row
// scales rs.
__device__ __forceinline__ void gamma_linear(const Args& a, const float* T,
                                             const signed char* Q,
                                             const float* rs, int h, int c,
                                             float y[TILE]) {
  if (a.int8) {
    const signed char* __restrict__ W = static_cast<const signed char*>(a.w1);
    int acc[TILE];
#pragma unroll
    for (int r = 0; r < TILE; ++r) acc[r] = 0;
    for (int kk = 0; kk < a.k1; ++kk) {
      const int wv = __ldg(W + (size_t)kk * h + c);
#pragma unroll
      for (int r = 0; r < TILE; ++r) acc[r] += (int)Q[r * a.k1 + kk] * wv;
    }
    const float s = a.s1[c], bias = a.b1[c];
#pragma unroll
    for (int r = 0; r < TILE; ++r)
      y[r] = fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc[r]), __fmul_rn(rs[r], s)),
                             bias), 0.f);
    return;
  }
  tile_column(T, a.k1, static_cast<const float*>(a.w1), h, c, y);
  const float bias = a.b1[c];
#pragma unroll
  for (int r = 0; r < TILE; ++r) y[r] = fmaxf(y[r] + bias, 0.f);
}

__global__ void __launch_bounds__(THREADS) fused_mp_kernel(const Args a) {
  extern __shared__ float smem[];
  const int F = a.f;
  const int nops = __popc(a.ops);
  float* acc_base = smem;                       // nops x TILE x F
  float* tower = acc_base + nops * TILE * F;    // TILE x K1
  float* hidden = tower + TILE * a.k1;          // TILE x H1 (gin)
  float* rs = hidden + TILE * a.h1;             // TILE row scales (int8)
  signed char* qtile = reinterpret_cast<signed char*>(rs + TILE);  // TILE x K1
  const int lo = blockIdx.x * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // ---- phase 1: walk each destination's CSR range, phi + accumulate ----
  for (int r = warp; r < TILE; r += WARPS) {
    const int d = lo + r;
    float s_sum[MAXV], s_sq[MAXV], s_mx[MAXV], s_mn[MAXV], s_w[MAXV];
#pragma unroll
    for (int v = 0; v < MAXV; ++v) {
      s_sum[v] = 0.f; s_sq[v] = 0.f; s_w[v] = 0.f;
      s_mx[v] = -INFINITY; s_mn[v] = INFINITY;
    }
    int deg = 0;
    if (d < a.n) {
      deg = a.deg[d];
      const int e1 = a.offsets[d + 1];
      for (int e = a.offsets[d]; e < e1; ++e) {
        const float* row = a.msrc + (size_t)a.src[e] * F;
        const float* erow = a.phi == PHI_ADD_RELU ? a.eop + (size_t)e * F : nullptr;
        const float we = (a.ops & OP_WSUM) ? a.ew[e] : 0.f;
#pragma unroll
        for (int v = 0; v < MAXV; ++v) {
          const int j = lane + 32 * v;
          if (j < F) {
            float m = row[j];
            if (a.phi == PHI_ADD_RELU) m = fmaxf(m + erow[j], 0.f);
            s_sum[v] += m;
            s_sq[v] = __fadd_rn(s_sq[v], __fmul_rn(m, m));
            s_w[v] = __fadd_rn(s_w[v], __fmul_rn(m, we));
            s_mx[v] = fmaxf(s_mx[v], m);
            s_mn[v] = fminf(s_mn[v], m);
          }
        }
      }
    }
#pragma unroll
    for (int v = 0; v < MAXV; ++v) {
      const int j = lane + 32 * v;
      if (j >= F) continue;
      const int at = r * F + j;
      if (a.ops & OP_SUM) acc_base[slot_of(a.ops, OP_SUM) * TILE * F + at] = s_sum[v];
      if (a.ops & OP_SQSUM) acc_base[slot_of(a.ops, OP_SQSUM) * TILE * F + at] = s_sq[v];
      if (a.ops & OP_MAX)
        acc_base[slot_of(a.ops, OP_MAX) * TILE * F + at] = deg > 0 ? s_mx[v] : 0.f;
      if (a.ops & OP_MIN)
        acc_base[slot_of(a.ops, OP_MIN) * TILE * F + at] = deg > 0 ? s_mn[v] : 0.f;
      if (a.ops & OP_WSUM) acc_base[slot_of(a.ops, OP_WSUM) * TILE * F + at] = s_w[v];
    }
  }
  __syncthreads();

  const float* sum = acc_base + slot_of(a.ops, OP_SUM) * TILE * F;
  const int rows = min(TILE, a.n - lo);

  // ---- phase 2: gamma on the tile ----
  if (a.gamma == GAMMA_GCN) {
    for (int idx = threadIdx.x; idx < rows * a.fr; idx += THREADS) {
      const int r = idx / a.fr, j = idx % a.fr, d = lo + r;
      const float v = (sum[r * F + j] + a.x_res[(size_t)d * a.fr + j]) * a.nop[(size_t)d * a.p];
      a.out[(size_t)d * a.f_out + j] = a.mask[d] ? v : 0.f;
    }
    return;
  }

  // assemble gamma's input tower (TILE x K1); rows past N are zero
  for (int idx = threadIdx.x; idx < TILE * F; idx += THREADS) {
    const int r = idx / F, j = idx % F, d = lo + r;
    const bool live = r < rows;
    if (a.gamma == GAMMA_GIN) {
      tower[r * a.k1 + j] = live ? a.x_res[(size_t)d * a.fr + j] + sum[r * F + j] : 0.f;
    } else if (a.gamma == GAMMA_PNA) {
      float q[4] = {0.f, 0.f, 0.f, 0.f};
      float sc[3] = {0.f, 0.f, 0.f};
      if (live) {
        const float c = fmaxf((float)a.deg[d], 1.f);
        const float sq = acc_base[slot_of(a.ops, OP_SQSUM) * TILE * F + r * F + j];
        const float mean = sum[r * F + j] / c;
        q[0] = mean;
        q[1] = sqrtf(fmaxf(__fsub_rn(sq / c, __fmul_rn(mean, mean)), 0.f));
        q[2] = acc_base[slot_of(a.ops, OP_MAX) * TILE * F + r * F + j];
        q[3] = acc_base[slot_of(a.ops, OP_MIN) * TILE * F + r * F + j];
#pragma unroll
        for (int s = 0; s < 3; ++s) sc[s] = a.nop[(size_t)d * a.p + s];
      }
#pragma unroll
      for (int s = 0; s < 3; ++s)
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4)
          tower[r * a.k1 + s * 4 * F + q4 * F + j] = q[q4] * sc[s];
    } else {  // GAMMA_DGN: [x_res, mean, |wsum - x_res * nop|]
      float xv = 0.f, mean = 0.f, dx = 0.f;
      if (live) {
        const float c = fmaxf((float)a.deg[d], 1.f);
        const float ws = acc_base[slot_of(a.ops, OP_WSUM) * TILE * F + r * F + j];
        xv = a.x_res[(size_t)d * a.fr + j];
        mean = sum[r * F + j] / c;
        dx = fabsf(__fsub_rn(ws, __fmul_rn(xv, a.nop[(size_t)d * a.p])));
      }
      tower[r * a.k1 + j] = xv;
      tower[r * a.k1 + F + j] = mean;
      tower[r * a.k1 + 2 * F + j] = dx;
    }
  }
  __syncthreads();

  if (a.int8) {
    // per-row exact-range quantization of the tower, one warp per row
    for (int r = warp; r < TILE; r += WARPS) {
      const float* t = tower + r * a.k1;
      float m = 0.f;
      for (int k = lane; k < a.k1; k += 32) m = fmaxf(m, fabsf(t[k]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float scale = fmaxf(m, 1e-8f) / 127.0f;
      for (int k = lane; k < a.k1; k += 32) {
        const float q = fminf(fmaxf(rintf(t[k] / scale), -128.f), 127.f);
        qtile[r * a.k1 + k] = (signed char)(int)q;
      }
      if (lane == 0) rs[r] = scale;
    }
    __syncthreads();
  }

  float acc[TILE];
  if (a.gamma == GAMMA_GIN) {
    // hidden = relu(tower @ w1 + b1), kept in shared memory
    for (int c = threadIdx.x; c < a.h1; c += THREADS) {
      gamma_linear(a, tower, qtile, rs, a.h1, c, acc);
#pragma unroll
      for (int r = 0; r < TILE; ++r) hidden[r * a.h1 + c] = acc[r];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < a.f_out; c += THREADS) {
      tile_column(hidden, a.h1, a.w2, a.f_out, c, acc);
      const float bias = a.b2[c];
#pragma unroll
      for (int r = 0; r < TILE; ++r) {
        const int d = lo + r;
        if (r < rows) a.out[(size_t)d * a.f_out + c] = a.mask[d] ? acc[r] + bias : 0.f;
      }
    }
    return;
  }
  // pna / dgn: out = relu(tower @ w1 + b1) + x_res
  for (int c = threadIdx.x; c < a.f_out; c += THREADS) {
    gamma_linear(a, tower, qtile, rs, a.f_out, c, acc);
#pragma unroll
    for (int r = 0; r < TILE; ++r) {
      const int d = lo + r;
      if (r >= rows) continue;
      const float v = acc[r] + a.x_res[(size_t)d * a.fr + c];
      a.out[(size_t)d * a.f_out + c] = a.mask[d] ? v : 0.f;
    }
  }
}

// Dynamic shared memory the kernel needs for one block, in bytes (the
// wrapper, kernels/fused_mp.py:smem_bytes, checks the same size against the
// 227 KB limit before it launches): fp32 accumulators, tower and hidden
// layer, and for int8 the row scales and the int8 tile.
long long smem_bytes(int f, int ops, int k1, int h1, int int8) {
  const long long f32 = (long long)sizeof(float) * TILE *
                        ((long long)__builtin_popcount(ops) * f + k1 + h1);
  return int8 ? f32 + (long long)sizeof(float) * TILE + (long long)TILE * k1 : f32;
}

// Largest dynamic shared memory opted into so far, per device: the opt-in
// (cudaFuncSetAttribute) is made only when a launch needs more, so the
// common call pays for no attribute call.
constexpr int MAX_DEVICES = 64;
long long smem_opted[MAX_DEVICES] = {};

}  // namespace

// Plain C entry point (loaded through ctypes).  Launches on `stream`, does
// not synchronise, and returns the launch's cudaError_t (0 on success).
// `int8` selects gamma's int8 first linear (gin / pna / dgn): w1 is then
// int8 with the per-column scales s1; otherwise w1 is f32 and s1 is not read.
extern "C" int fused_mp_launch(
    const int* offsets, const int* src, const float* msrc, const float* x_res,
    const float* nop, const float* eop, const float* ew, const int* deg,
    const unsigned char* mask, const void* w1, const float* b1,
    const float* s1, const float* w2, const float* b2, float* out,
    int n, int f, int fr, int p, int k1, int h1, int f_out,
    int phi, int ops, int gamma, int int8, cudaStream_t stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (f > 32 * MAXV || f <= 0) return (int)cudaErrorInvalidValue;
  const Args a{offsets, src, msrc, x_res, nop, eop, ew, deg, mask,
               w1, b1, s1, w2, b2, out, n, f, fr, p, k1, h1, f_out,
               phi, ops, gamma, int8};
  const long long smem = smem_bytes(f, ops, k1, h1, int8);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem > smem_opted[dev]) {
    err = cudaFuncSetAttribute(
        fused_mp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_opted[dev] = smem;
  }
  const int blocks = (n + TILE - 1) / TILE;
  fused_mp_kernel<<<blocks, THREADS, (size_t)smem, stream>>>(a);
  return (int)cudaGetLastError();
}
