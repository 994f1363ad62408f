// node_mlp.cu — y = act(x @ w + b), IEEE fp32 on the CUDA cores.
//
// Replaces: src/repro/kernels/node_mlp.py:node_mlp (Pallas body _mlp_kernel),
// the Node-Embedding PE that runs every dense linear of the GNN models.
//
// Bound on the H100: the GNN linears are thin (M 1 - 12288, K 3 - ~1040,
// N 1 - 200), so at the serving shapes the kernel moves x once and writes y
// once; a (4096, 100) x (100, 200) product is ~164 MFLOP over ~5 MB, about
// 2.4 us of fp32 CUDA-core time against ~1.5 us of HBM time, and the head
// (128, 100 -> 1) is a few hundred bytes of work.  At these sizes the latency
// of a load and the launch are the real floor, so the design avoids waiting
// for one load after another and idle output lanes.
//
// No TF32 and no tensor cores: the JAX kernel and its oracle are IEEE fp32,
// and fp32 operands cannot reach the tensor cores without TF32.  Three
// variants, picked up front by the wrapper (kernels/node_mlp.py:variant):
//
// "narrow" (N <= 8, the head's N = 1): one warp per output row.  The lanes
// stride over K (16-byte loads of x when K % 4 == 0), each keeping N partial
// sums, which a shuffle tree reduces; lane n applies the bias and the
// activation to output n.  No output tile is padded.
//
// "shallow" (K <= 16, the encoder's K = 9 and the edge embedding's K = 3):
// one 16-deep slice, so no K loop to overlap.  Each 256-thread block owns a
// 64 x 64 output tile; x (transposed, padded by one column) and w reach
// shared memory by plain loads, four of each per thread in one round, and
// each thread keeps 4 x 4 outputs strided by 16.  (The first 64 x 64
// design of this file at one slice: on the H100 every cp.async design
// measured slower at (4096, 9 -> 100).)
//
// "tiled" (otherwise): 256 threads own a 64 x 64 output tile, 4 x 4
// consecutive outputs each.  x and w reach shared memory by cp.async in
// 32-deep K slices, one commit group per slice, through a ring of up to 8
// stages: a K <= 256 extent is staged in one go, and each slice's FMAs start
// as soon as it lands while the later slices are still in flight (a longer K
// refills the ring behind the FMAs).  The copies are 16-byte vectors when the
// row pitch allows (K % 4 == 0 for x, N % 4 == 0 for w and y) and 4-byte ones
// otherwise; the FMAs read only the slice's real depth rounded up to 4,
// zero-filled.  The bias is loaded while the slices are in flight.
//
// All: ragged M/K/N edges are masked in the loads and the store, so the
// wrapper never pads; the bias and the activation are applied in the
// epilogue and y is written exactly once.
#include <cuda_runtime.h>
#include <math.h>

namespace {

enum Activation { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2 };
enum Variant { NARROW = 0, SHALLOW = 1, TILED = 2 };

constexpr unsigned FULL = 0xffffffffu;
constexpr int NARROW_MAX_N = 8;     // widest output the narrow variant takes
constexpr int NARROW_WARPS = 8;     // rows per narrow block
constexpr int SHALLOW_MAX_K = 16;   // deepest product the shallow variant takes
constexpr int TM = 64;              // shallow and tiled: output rows per block
constexpr int TN = 64;              // shallow and tiled: output columns per block
constexpr int TILE_THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int TK = 32;              // tiled: K depth per shared-memory slice
constexpr int MAX_STAGES = 8;       // tiled: K slices in flight (K <= 256 in one go)
constexpr int XP = TK + 4;          // tiled: padded x row (a 16-byte multiple)
constexpr int STAGE_FLOATS = TM * XP + TK * TN;

bool aligned16(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// global -> shared copies of 16 or 4 bytes; `in` false zero-fills
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `pending` committed groups are still in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

__global__ void __launch_bounds__(NARROW_WARPS * 32)
node_mlp_narrow(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ b, float* __restrict__ y, int M, int K,
                int N, int act, int x_vec) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * NARROW_WARPS + (threadIdx.x >> 5);
  if (m >= M) return;  // the whole warp
  const float* xr = x + (size_t)m * K;
  const float bias = lane < N ? __ldg(b + lane) : 0.f;
  float acc[NARROW_MAX_N];
#pragma unroll
  for (int n = 0; n < NARROW_MAX_N; ++n) acc[n] = 0.f;
  if (x_vec) {
    for (int k = 4 * lane; k < K; k += 128) {
      const float4 xv = __ldg(reinterpret_cast<const float4*>(xr + k));
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int n = 0; n < NARROW_MAX_N; ++n)
          if (n < N) acc[n] = fmaf(xs[u], __ldg(w + (size_t)(k + u) * N + n), acc[n]);
    }
  } else {
    for (int k = lane; k < K; k += 32) {
      const float xv = __ldg(xr + k);
#pragma unroll
      for (int n = 0; n < NARROW_MAX_N; ++n)
        if (n < N) acc[n] = fmaf(xv, __ldg(w + (size_t)k * N + n), acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < NARROW_MAX_N; ++n) {
    if (n < N) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[n] += __shfl_xor_sync(FULL, acc[n], off);
      if (lane == n) y[(size_t)m * N + n] = activate(acc[n] + bias, act);
    }
  }
}

__global__ void __launch_bounds__(TILE_THREADS)
node_mlp_shallow(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, float* __restrict__ y, int M, int K, int N,
                 int act) {
  __shared__ float xs[SHALLOW_MAX_K][TM + 1];  // transposed, padded against bank conflicts
  __shared__ float ws[SHALLOW_MAX_K][TN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx + 16 j
  const int ty = tid / 16;  // output rows ty + 16 i
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
#pragma unroll
  for (int l = 0; l < TM * SHALLOW_MAX_K / TILE_THREADS; ++l) {
    const int idx = tid + l * TILE_THREADS, r = idx / SHALLOW_MAX_K, c = idx % SHALLOW_MAX_K;
    const int m = m0 + r;
    xs[c][r] = m < M && c < K ? x[(size_t)m * K + c] : 0.f;
  }
#pragma unroll
  for (int l = 0; l < SHALLOW_MAX_K * TN / TILE_THREADS; ++l) {
    const int idx = tid + l * TILE_THREADS, r = idx / TN, c = idx % TN, n = n0 + c;
    ws[r][c] = r < K && n < N ? w[(size_t)r * N + n] : 0.f;
  }
  __syncthreads();
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int kk = 0; kk < SHALLOW_MAX_K; ++kk) {
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

__global__ void __launch_bounds__(TILE_THREADS)
node_mlp_tiled(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ b, float* __restrict__ y, int M, int K, int N,
               int act, int stages, int x_vec, int w_vec, int y_vec) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int tx = tid % (TN / 4);  // output columns tx * 4 .. + 3
  const int ty = tid / (TN / 4);  // output rows ty * 4 .. + 3
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int T = (K + TK - 1) / TK;

  // slice t (K rows k0 .. k0 + 31) into stage t % stages; only its real
  // depth kd (rounded up to 4) is copied, zero-filled past K
  auto issue = [&](int t) {
    float* xs = smem + (t % stages) * STAGE_FLOATS;
    float* ws = xs + TM * XP;
    const int k0 = t * TK;
    const int kd = (min(TK, K - k0) + 3) & ~3;
    if (x_vec) {
#pragma unroll
      for (int l = 0; l < TM * (TK / 4) / TILE_THREADS; ++l) {
        const int i = tid + l * TILE_THREADS, r = i / (TK / 4), c = 4 * (i % (TK / 4));
        const int m = m0 + r, k = k0 + c;
        const bool in = m < M && k < K;
        if (c < kd) cp_async16(xs + r * XP + c, in ? x + (size_t)m * K + k : x, in);
      }
    } else {
      for (int i = tid; i < TM * kd; i += TILE_THREADS) {
        const int r = i / kd, c = i - r * kd, m = m0 + r, k = k0 + c;
        const bool in = m < M && k < K;
        cp_async4(xs + r * XP + c, in ? x + (size_t)m * K + k : x, in);
      }
    }
    if (w_vec) {
#pragma unroll
      for (int l = 0; l < TK * (TN / 4) / TILE_THREADS; ++l) {
        const int i = tid + l * TILE_THREADS, r = i / (TN / 4), c = 4 * (i % (TN / 4));
        const int k = k0 + r, n = n0 + c;
        const bool in = k < K && n < N;
        if (r < kd) cp_async16(ws + r * TN + c, in ? w + (size_t)k * N + n : w, in);
      }
    } else {
      for (int i = tid; i < kd * TN; i += TILE_THREADS) {
        const int r = i / TN, c = i % TN, k = k0 + r, n = n0 + c;
        const bool in = k < K && n < N;
        cp_async4(ws + r * TN + c, in ? w + (size_t)k * N + n : w, in);
      }
    }
  };

  const int first = min(T, stages);
  for (int t = 0; t < first; ++t) {
    issue(t);
    cp_async_commit();
  }
  // the bias, loaded while the slices are in flight
  const int nc = n0 + tx * 4;
  float bias[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) bias[j] = nc + j < N ? __ldg(b + nc + j) : 0.f;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < T; ++t) {
    // slices t + 1 .. min(T, t + stages) - 1 may still be in flight
    cp_async_wait(min(stages - 1, T - t - 1));
    __syncthreads();
    const float* xs = smem + (t % stages) * STAGE_FLOATS + ty * 4 * XP;  // this thread's rows
    const float* ws = smem + (t % stages) * STAGE_FLOATS + TM * XP + tx * 4;  // and columns
    const int kd = (min(TK, K - t * TK) + 3) & ~3;
    for (int kk = 0; kk < kd; kk += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(xs + i * XP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 bv = *reinterpret_cast<const float4*>(ws + (kk + u) * TN);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = u == 0 ? a[i].x : u == 1 ? a[i].y : u == 2 ? a[i].z : a[i].w;
          acc[i][0] = fmaf(av, bv.x, acc[i][0]);
          acc[i][1] = fmaf(av, bv.y, acc[i][1]);
          acc[i][2] = fmaf(av, bv.z, acc[i][2]);
          acc[i][3] = fmaf(av, bv.w, acc[i][3]);
        }
      }
    }
    if (t + stages < T) {
      __syncthreads();  // every thread is done with this stage
      issue(t + stages);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M || nc >= N) continue;
    float* yr = y + (size_t)m * N + nc;
    if (y_vec) {  // N % 4 == 0: all four columns are real
      *reinterpret_cast<float4*>(yr) =
          make_float4(activate(acc[i][0] + bias[0], act), activate(acc[i][1] + bias[1], act),
                      activate(acc[i][2] + bias[2], act), activate(acc[i][3] + bias[3], act));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (nc + j < N) yr[j] = activate(acc[i][j] + bias[j], act);
    }
  }
}

}  // namespace

// Plain C entry point (loaded through ctypes).  variant 0 = "narrow" (N <=
// 8 only), 1 = "shallow" (K <= 16 only), 2 = "tiled"; a variant that cannot
// take the shape is refused.  Launches on `stream`, does not synchronise,
// and returns the launch's cudaError_t (0 on success).
extern "C" int node_mlp_f32(const float* x, const float* w, const float* b,
                            float* y, int m, int k, int n, int act, int variant,
                            cudaStream_t stream) {
  if (m <= 0 || n <= 0) return (int)cudaSuccess;
  if (k < 0) return (int)cudaErrorInvalidValue;
  if (variant == NARROW) {
    if (n > NARROW_MAX_N) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((m + NARROW_WARPS - 1) / NARROW_WARPS);
    const int x_vec = k % 4 == 0 && aligned16(x);
    node_mlp_narrow<<<grid, NARROW_WARPS * 32, 0, stream>>>(x, w, b, y, m, k, n, act, x_vec);
    return (int)cudaGetLastError();
  }
  const dim3 grid((unsigned)((n + TN - 1) / TN), (unsigned)((m + TM - 1) / TM));
  if (variant == SHALLOW) {
    if (k > SHALLOW_MAX_K) return (int)cudaErrorInvalidValue;
    node_mlp_shallow<<<grid, TILE_THREADS, 0, stream>>>(x, w, b, y, m, k, n, act);
    return (int)cudaGetLastError();
  }
  if (variant != TILED) return (int)cudaErrorInvalidValue;
  const int slices = (k + TK - 1) / TK;
  const int stages = slices < 1 ? 1 : slices < MAX_STAGES ? slices : MAX_STAGES;
  const size_t smem = (size_t)stages * STAGE_FLOATS * sizeof(float);
  if (smem > 48 * 1024) {  // above 48 KB only after opting in (per device: every call)
    const cudaError_t err = cudaFuncSetAttribute(
        node_mlp_tiled, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  node_mlp_tiled<<<grid, TILE_THREADS, smem, stream>>>(
      x, w, b, y, m, k, n, act, stages, k % 4 == 0 && aligned16(x),
      n % 4 == 0 && aligned16(w), n % 4 == 0 && aligned16(y));
  return (int)cudaGetLastError();
}
