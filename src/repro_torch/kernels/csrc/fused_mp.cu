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
// Here each block owns a tile of ROWS destination nodes (rows_for: 32 where
// gamma has a linear and 32 rows fit 227 KB of shared memory, else 16) and
// walks the CSR ranges
// offsets[d]..offsets[d+1] of the shared GraphLayout plan: one warp per
// destination, lanes along F, accumulators in registers.  No two blocks
// share a destination, so there are no atomics, and each destination's sum
// runs in sorted-edge order (deterministic).  Padding edges sit past
// offsets[N] and are never read.  A tile whose rows are all padding (no
// live mask bit, __syncthreads_or) writes its zeros and returns first.  The
// accumulators land in shared memory, where gamma runs on the whole tile:
// GCN's scale, GIN's F -> H -> F MLP, PNA's 12F scaler tower, DGN's 3F
// tower.  Padded node rows and empty max/min rows come out 0.  Products
// that the plain version rounds before a sum are kept separate (__fmul_rn /
// __fadd_rn) so that nvcc cannot contract them into an FMA.
//
// Gamma's matrix products (gemm_f32 / gemm_i8: every linear of every gamma
// in both precisions) are register-tiled over weights staged in shared
// memory.  Their operands are stored k-major: the tower, GIN's hidden layer
// and the int8 tile hold ROWS (+ 4 pad) values per k.  A pass computes 32 *
// RN output columns (RN = 8 for N > 128, GIN's hidden layer; else 4) on
// ROWS / 4 warps: thread t owns the 4 rows from 4 (t % (ROWS / 4)) and, per
// group g < RN / 4, the columns 128 g + 4 (t / (ROWS / 4)) .. + 3.  Per k it
// reads its rows' values and its columns' weights as 16-byte vectors (one
// shared-memory wavefront a warp, no bank conflict) while the products of
// the previous k run, and keeps 4 x RN independent accumulators.  K is
// walked in slices that all 256 threads load together, coalesced along N,
// into a double buffer: slice s + 1 is fetched into registers while slice s
// feeds the products, then stored, one barrier per slice, so no weight is
// read from device memory inside the product loop.  fp32 accumulates with
// fmaf in K order per output (the order of the plain kernel this
// replaces), IEEE, no TF32.
//
// int8 gamma (gin / pna / dgn): after the tower is built, the threads
// reduce max|t| per row over K1, take the row scale rs = max(m, 1e-8) / 127
// (1e-8 is quant/qconfig._EPS), and store q = clamp(rint(t / rs), -128,
// 127) into an int8 tile packed four consecutive k to a 32-bit word: IEEE
// division (no fast math; 0 / rs is 0 and is not divided) and
// round-half-to-even, as torch.round and jnp.round do (roundf would round
// half away from zero).  The staged w1 slice is packed the same way per
// column (four k rows read as words and transposed with __byte_perm), and
// __dp4a accumulates q x w1 in int32, exact in any order; the epilogue is
// relu((float)acc * (rs * s1[c]) + b1[c]), the order of the JAX kernel's
// tail.  |acc| <= 127 * 128 * K1 stays below 2^24 for K1 <= 1032 (PNA: 960),
// so the conversion to float is exact; deeper, __int2float_rn rounds it to
// nearest even, as the plain version's exact sum does when it is converted
// to float.  Depth past K1 is zero in both
// operands.  GIN's second linear stays fp32 over the dequantized w2, through
// gemm_f32; PNA and DGN add the residual.  GCN's gamma has no linear, so the
// precision changes nothing there.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps; one destination per warp in phase 1
constexpr int WARPS = THREADS / 32;
constexpr int MAXV = 8;       // features per lane: F <= 32 * MAXV = 256
constexpr int STAGE_WORDS = 4096;  // 32-bit words of one staged fp32 weight slice
                                   // (an int8 slice takes half)
constexpr long long MAX_SMEM = 232448;  // 227 KB of dynamic shared memory

enum { OP_SUM = 1, OP_SQSUM = 2, OP_MAX = 4, OP_MIN = 8, OP_WSUM = 16 };
enum { PHI_COPY = 0, PHI_ADD_RELU = 1 };
enum { GAMMA_GCN = 0, GAMMA_GIN = 1, GAMMA_PNA = 2, GAMMA_DGN = 3 };

struct Args {
  const int* offsets;          // (N + 1,) CSR offsets of the plan
  const int* src;              // (E,) source ids in plan order
  const float* msrc;           // (N_src, F) message operand (source table)
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

// Phase marks, built only with -DFUSED_MP_PHASES (kernels/fused_mp_phases.py):
// thread 0 of each of the first MARK_BLOCKS blocks records %globaltimer at
// the block's start (0), after the dead-tile check (1), the CSR walk (2),
// the tower (3) and the int8 tile (4), before gamma's last product (5) and
// at the end (6).  Without the define they compile to nothing.
#ifdef FUSED_MP_PHASES
constexpr int MARK_BLOCKS = 1024;
__device__ unsigned long long phase_marks[MARK_BLOCKS][8];
__device__ __forceinline__ void phase_mark(int i) {
  if (threadIdx.x == 0 && blockIdx.x < MARK_BLOCKS) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    phase_marks[blockIdx.x][i] = t;
  }
}
__device__ __forceinline__ void phase_end() {
  __syncthreads();
  phase_mark(6);
}
#else
__device__ __forceinline__ void phase_mark(int) {}
__device__ __forceinline__ void phase_end() {}
#endif

__device__ __forceinline__ int slot_of(int ops, int bit) {
  return __popc(ops & (bit - 1));
}

__device__ __forceinline__ float lane4(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// Columns a pass of a product N wide computes: 256 (RN = 8) or 128.
__device__ __forceinline__ int span_for(int n) { return n > 128 ? 256 : 128; }

// The products' register tiles: thread t < 32 RG of a pass owns the 4 rows
// from row0 = 4 (t % RG) and, per group g < G, columns 128 g + col .. + 3,
// col = 4 (t / RG).
template <int ROWS, int RN>
struct Tile {
  static constexpr int RG = ROWS / 4;  // row groups: a pass runs on RG warps
  static constexpr int G = RN / 4, SPAN = 32 * RN;
  static constexpr int KS = STAGE_WORDS / SPAN;      // fp32 W rows per slice
  static constexpr int KW = STAGE_WORDS / 2 / SPAN;  // int8 W words (4 rows) per slice
};

// ep(row0, col, acc) for C = A @ W over the tile's ROWS rows, fp32: A in
// shared memory k-major (A[k * pa + r], pa >= ROWS, a multiple of 4), W (K,
// N) in device memory, staged through ws (2 x STAGE_WORDS floats).
// acc[i][j] is C at row row0 + i and column col + j (past N when col + j >=
// N), one call per column group of the thread: the epilogue gets the whole
// group, so it can issue all its loads first.
template <int ROWS, int RN, typename Ep>
__device__ void gemm_f32(const float* A, int pa, int K, const float* __restrict__ W,
                         int N, float* ws, Ep ep) {
  using T = Tile<ROWS, RN>;
  constexpr int RG = T::RG, G = T::G, SPAN = T::SPAN, KS = T::KS;
  constexpr int PF = KS * SPAN / THREADS;  // staged floats per thread (16)
  const int tid = threadIdx.x;
  const int row0 = 4 * (tid % RG), col = 4 * (tid / RG);  // compute role, tid < 32 RG
  const int S = (K + KS - 1) / KS;
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(W) % 16 == 0;
  for (int c0 = 0; c0 < N; c0 += SPAN) {
    const bool busy = tid < 32 * RG && c0 + col < N;
    float pf[PF];
    // slice s of the pass: thread tid holds W rows (tid + l * THREADS) /
    // (SPAN / 4), columns 4 * (tid % (SPAN / 4)) .. + 3; zero past K and N
    auto fetch = [&](int s) {
#pragma unroll
      for (int l = 0; l < PF / 4; ++l) {
        const int i = tid + l * THREADS;
        const int k = s * KS + i / (SPAN / 4), c = c0 + 4 * (i % (SPAN / 4));
        if (vec) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (k < K && c < N) v = __ldg(reinterpret_cast<const float4*>(W + (size_t)k * N + c));
          pf[4 * l] = v.x; pf[4 * l + 1] = v.y; pf[4 * l + 2] = v.z; pf[4 * l + 3] = v.w;
        } else {
#pragma unroll
          for (int t = 0; t < 4; ++t)
            pf[4 * l + t] = k < K && c + t < N ? __ldg(W + (size_t)k * N + c + t) : 0.f;
        }
      }
    };
    auto put = [&](float* buf) {
#pragma unroll
      for (int l = 0; l < PF / 4; ++l) {
        const int i = tid + l * THREADS;
        *reinterpret_cast<float4*>(buf + (i / (SPAN / 4)) * SPAN + 4 * (i % (SPAN / 4))) =
            make_float4(pf[4 * l], pf[4 * l + 1], pf[4 * l + 2], pf[4 * l + 3]);
      }
    };
    float acc[G][4][4];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[g][i][j] = 0.f;
    // one k of the products: this thread's 4 values of A and columns of W
    float4 a0, b0[G], a1, b1[G];
    auto load = [&](float4& av, float4 (&bv)[G], const float* ak, const float* wk) {
      av = *reinterpret_cast<const float4*>(ak);
#pragma unroll
      for (int g = 0; g < G; ++g) bv[g] = *reinterpret_cast<const float4*>(wk + 128 * g);
    };
    auto fma_k = [&](const float4& av, const float4 (&bv)[G]) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = lane4(av, i);
          acc[g][i][0] = fmaf(x, bv[g].x, acc[g][i][0]);
          acc[g][i][1] = fmaf(x, bv[g].y, acc[g][i][1]);
          acc[g][i][2] = fmaf(x, bv[g].z, acc[g][i][2]);
          acc[g][i][3] = fmaf(x, bv[g].w, acc[g][i][3]);
        }
    };
    fetch(0);
    put(ws);
    __syncthreads();
    for (int s = 0; s < S; ++s) {
      if (s + 1 < S) fetch(s + 1);
      if (busy) {
        // k = s * KS + kk; the next k's operands load while this k's
        // products run
        const float* ab = A + (size_t)s * KS * pa + row0;
        const float* wb = ws + (s & 1) * STAGE_WORDS + col;
        const int kd = min(KS, K - s * KS);
        load(a0, b0, ab, wb);
        int kk = 0;
#pragma unroll 1
        for (; kk + 1 < kd; kk += 2) {
          load(a1, b1, ab + (kk + 1) * pa, wb + (kk + 1) * SPAN);
          fma_k(a0, b0);
          if (kk + 2 < kd) load(a0, b0, ab + (kk + 2) * pa, wb + (kk + 2) * SPAN);
          fma_k(a1, b1);
        }
        if (kk < kd) fma_k(a0, b0);
      }
      if (s + 1 < S) put(ws + ((s + 1) & 1) * STAGE_WORDS);
      __syncthreads();
    }
    if (tid < 32 * RG) {
#pragma unroll
      for (int g = 0; g < G; ++g) ep(row0, c0 + 128 * g + col, acc[g]);
    }
  }
}

// Four int8 words (rows k .. k + 3, columns c .. c + 3 as bytes) transposed
// into four words of four k each, one per column: the operand layout of
// __dp4a, lowest k in the lowest byte.
__device__ __forceinline__ int4 transpose4(unsigned r0, unsigned r1, unsigned r2,
                                           unsigned r3) {
  const unsigned lo01 = __byte_perm(r0, r1, 0x5140), hi01 = __byte_perm(r0, r1, 0x7362);
  const unsigned lo23 = __byte_perm(r2, r3, 0x5140), hi23 = __byte_perm(r2, r3, 0x7362);
  return make_int4((int)__byte_perm(lo01, lo23, 0x5410), (int)__byte_perm(lo01, lo23, 0x7632),
                   (int)__byte_perm(hi01, hi23, 0x5410), (int)__byte_perm(hi01, hi23, 0x7632));
}

__device__ __forceinline__ int lane4(const int4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// ep(row0, col, acc) as for gemm_f32, of the exact int32 product Q @ W over
// the tile's ROWS rows: Q in shared memory k-major, one word of four k per
// row (Q[w * pq + r], ceil(K / 4) words deep, zero past K), W (K, N) int8 in
// device memory, staged K-packed through ws (2 x STAGE_WORDS / 2 words).
template <int ROWS, int RN, typename Ep>
__device__ void gemm_i8(const int* Q, int pq, int K, const signed char* __restrict__ W,
                        int N, int* ws, Ep ep) {
  using T = Tile<ROWS, RN>;
  constexpr int RG = T::RG, G = T::G, SPAN = T::SPAN, KW = T::KW, KS = 4 * KW;
  constexpr int PF = KW * SPAN / THREADS;  // staged words per thread (8)
  constexpr int BUF = STAGE_WORDS / 2;
  const int tid = threadIdx.x;
  const int row0 = 4 * (tid % RG), col = 4 * (tid / RG);
  const int S = (K + KS - 1) / KS;
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(W) % 4 == 0;
  for (int c0 = 0; c0 < N; c0 += SPAN) {
    const bool busy = tid < 32 * RG && c0 + col < N;
    unsigned pf[PF / 4][4];
    // slice s of the pass: thread tid holds word row (tid + l * THREADS) /
    // (SPAN / 4) (four k rows), columns 4 * (tid % (SPAN / 4)) .. + 3, as
    // loaded (put transposes them, so that the loads stay in flight over
    // the products); zero past K and N
    auto fetch = [&](int s) {
#pragma unroll
      for (int l = 0; l < PF / 4; ++l) {
        const int i = tid + l * THREADS;
        const int k = s * KS + 4 * (i / (SPAN / 4)), c = c0 + 4 * (i % (SPAN / 4));
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const signed char* row = W + (size_t)(k + t) * N + c;
          if (vec) {
            pf[l][t] = k + t < K && c < N ? __ldg(reinterpret_cast<const unsigned*>(row)) : 0u;
          } else {
            pf[l][t] = 0u;
            for (int j = 0; j < 4; ++j)
              if (k + t < K && c + j < N)
                pf[l][t] |= (unsigned)(unsigned char)__ldg(row + j) << (8 * j);
          }
        }
      }
    };
    auto put = [&](int* buf) {
#pragma unroll
      for (int l = 0; l < PF / 4; ++l) {
        const int i = tid + l * THREADS;
        *reinterpret_cast<int4*>(buf + (i / (SPAN / 4)) * SPAN + 4 * (i % (SPAN / 4))) =
            transpose4(pf[l][0], pf[l][1], pf[l][2], pf[l][3]);
      }
    };
    int acc[G][4][4];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[g][i][j] = 0;
    int4 a0, b0[G], a1, b1[G];
    auto load = [&](int4& qv, int4 (&bv)[G], const int* qw, const int* ww) {
      qv = *reinterpret_cast<const int4*>(qw);
#pragma unroll
      for (int g = 0; g < G; ++g) bv[g] = *reinterpret_cast<const int4*>(ww + 128 * g);
    };
    auto dp4a_w = [&](const int4& qv, const int4 (&bv)[G]) {
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int x = lane4(qv, i);
          acc[g][i][0] = __dp4a(x, bv[g].x, acc[g][i][0]);
          acc[g][i][1] = __dp4a(x, bv[g].y, acc[g][i][1]);
          acc[g][i][2] = __dp4a(x, bv[g].z, acc[g][i][2]);
          acc[g][i][3] = __dp4a(x, bv[g].w, acc[g][i][3]);
        }
    };
    fetch(0);
    put(ws);
    __syncthreads();
    for (int s = 0; s < S; ++s) {
      if (s + 1 < S) fetch(s + 1);
      if (busy) {
        const int* qb = Q + (size_t)s * KW * pq + row0;
        const int* wb = ws + (s & 1) * BUF + col;
        const int kd = (min(KS, K - s * KS) + 3) / 4;  // words
        load(a0, b0, qb, wb);
        int kk = 0;
#pragma unroll 1
        for (; kk + 1 < kd; kk += 2) {
          load(a1, b1, qb + (kk + 1) * pq, wb + (kk + 1) * SPAN);
          dp4a_w(a0, b0);
          if (kk + 2 < kd) load(a0, b0, qb + (kk + 2) * pq, wb + (kk + 2) * SPAN);
          dp4a_w(a1, b1);
        }
        if (kk < kd) dp4a_w(a0, b0);
      }
      if (s + 1 < S) put(ws + ((s + 1) & 1) * BUF);
      __syncthreads();
    }
    if (tid < 32 * RG) {
#pragma unroll
      for (int g = 0; g < G; ++g) ep(row0, c0 + 128 * g + col, acc[g]);
    }
  }
}

// One of gamma's fp32 / int8 products, RN picked from N (span_for).
template <int ROWS, typename Ep>
__device__ __forceinline__ void product_f32(const float* A, int pa, int K, const float* W,
                                            int N, float* ws, Ep ep) {
  if (span_for(N) == 256) gemm_f32<ROWS, 8>(A, pa, K, W, N, ws, ep);
  else gemm_f32<ROWS, 4>(A, pa, K, W, N, ws, ep);
}

template <int ROWS, typename Ep>
__device__ __forceinline__ void product_i8(const int* Q, int pq, int K, const signed char* W,
                                           int N, int* ws, Ep ep) {
  if (span_for(N) == 256) gemm_i8<ROWS, 8>(Q, pq, K, W, N, ws, ep);
  else gemm_i8<ROWS, 4>(Q, pq, K, W, N, ws, ep);
}

// relu(acc * (rs * s1) + b1), the int8 first linear's epilogue in the JAX
// kernel's order
__device__ __forceinline__ float dequant_relu(int acc, float rs, float s, float bias) {
  return fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc), __fmul_rn(rs, s)), bias), 0.f);
}

// LINEAR false is GCN's instance: gamma has no product, so none of the
// products' registers are held and more blocks share an SM.
template <int ROWS, bool LINEAR>
__global__ void __launch_bounds__(THREADS) fused_mp_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int F = a.f;
  const int nops = __popc(a.ops);
  const int lo = blockIdx.x * ROWS;
  const int rows = min(ROWS, a.n - lo);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  phase_mark(0);

  // ---- a tile with no live row: its zeros, and nothing else ----
  const bool live_row = threadIdx.x < rows && a.mask[lo + threadIdx.x];
  if (!__syncthreads_or(live_row)) {
    for (int idx = threadIdx.x; idx < rows * a.f_out; idx += THREADS)
      a.out[(size_t)lo * a.f_out + idx] = 0.f;
    return;
  }

  // gamma's operands are k-major, ROWS + 4 words a k (16-byte aligned)
  constexpr int PR = ROWS + 4;
  const int kq = (a.k1 + 3) / 4;                // words of four k of the int8 tile
  float* acc_base = smem;                       // nops x ROWS x F
  float* tower = acc_base + nops * ROWS * F;    // K1 x PR
  float* hidden = tower + a.k1 * PR;            // H1 x PR (gin)
  float* rs = hidden + a.h1 * PR;               // ROWS row scales (int8)
  int* qtile = reinterpret_cast<int*>(rs + (a.int8 ? ROWS : 0));  // kq x PR (int8)
  float* stage = reinterpret_cast<float*>(qtile + (a.int8 ? kq * PR : 0));  // weight slices
  phase_mark(1);

  // ---- phase 1: walk each destination's CSR range, phi + accumulate ----
  for (int r = warp; r < ROWS; r += WARPS) {
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
      if (a.ops & OP_SUM) acc_base[slot_of(a.ops, OP_SUM) * ROWS * F + at] = s_sum[v];
      if (a.ops & OP_SQSUM) acc_base[slot_of(a.ops, OP_SQSUM) * ROWS * F + at] = s_sq[v];
      if (a.ops & OP_MAX)
        acc_base[slot_of(a.ops, OP_MAX) * ROWS * F + at] = deg > 0 ? s_mx[v] : 0.f;
      if (a.ops & OP_MIN)
        acc_base[slot_of(a.ops, OP_MIN) * ROWS * F + at] = deg > 0 ? s_mn[v] : 0.f;
      if (a.ops & OP_WSUM) acc_base[slot_of(a.ops, OP_WSUM) * ROWS * F + at] = s_w[v];
    }
  }
  __syncthreads();

  phase_mark(2);
  const float* sum = acc_base + slot_of(a.ops, OP_SUM) * ROWS * F;

  // ---- phase 2: gamma on the tile ----
  if (!LINEAR || a.gamma == GAMMA_GCN) {
    for (int idx = threadIdx.x; idx < rows * a.fr; idx += THREADS) {
      const int r = idx / a.fr, j = idx % a.fr, d = lo + r;
      const float v = (sum[r * F + j] + a.x_res[(size_t)d * a.fr + j]) * a.nop[(size_t)d * a.p];
      a.out[(size_t)d * a.f_out + j] = a.mask[d] ? v : 0.f;
    }
    return;
  }

  // assemble gamma's input tower (K1 x ROWS, k-major); rows past N are zero.
  // GIN: one warp per row and lanes along F as in phase 1, each thread's
  // rows unrolled so that their device loads are in flight together
  constexpr int RPW = ROWS / WARPS;  // tile rows per warp
  if (a.gamma == GAMMA_GIN) {
    float xv[RPW][MAXV];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int v = 0; v < MAXV; ++v) {
        const int r = warp + WARPS * i, j = lane + 32 * v;
        xv[i][v] = r < rows && j < F ? a.x_res[(size_t)(lo + r) * a.fr + j] : 0.f;
      }
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int v = 0; v < MAXV; ++v) {
        const int r = warp + WARPS * i, j = lane + 32 * v;
        if (j < F) tower[j * PR + r] = r < rows ? xv[i][v] + sum[r * F + j] : 0.f;
      }
  } else {
    // PNA / DGN: the per-row operands (degree count c, the scalers / nop)
    // and DGN's residual land in shared memory first, loads in flight
    // together; then one loop over cells of 4 rows x 8 features, a cell a
    // warp (2-way bank conflicts at most on the accumulators, none on the
    // k-major tower), shared memory and arithmetic only, its IEEE
    // divisions and square roots kept out of unrolled code
    float* rowop = stage;  // ROWS x 4: c, nop[0..2]; the weight stage is free
    if (threadIdx.x < ROWS) {
      const int r = threadIdx.x, d = lo + r;
      const bool live = r < rows;
      rowop[4 * r] = live ? fmaxf((float)a.deg[d], 1.f) : 1.f;
      for (int s = 0; s < (a.gamma == GAMMA_PNA ? 3 : 1); ++s)
        rowop[4 * r + 1 + s] = live ? a.nop[(size_t)d * a.p + s] : 0.f;
    }
    if (a.gamma == GAMMA_DGN) {
      float xv[RPW][MAXV];
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int v = 0; v < MAXV; ++v) {
          const int r = warp + WARPS * i, j = lane + 32 * v;
          xv[i][v] = r < rows && j < F ? a.x_res[(size_t)(lo + r) * a.fr + j] : 0.f;
        }
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int v = 0; v < MAXV; ++v) {
          const int j = lane + 32 * v;
          if (j < F) tower[j * PR + warp + WARPS * i] = xv[i][v];
        }
    }
    __syncthreads();
    const int cells = ROWS / 4 * ((F + 7) / 8);
#pragma unroll 1
    for (int cell = warp; cell < cells; cell += WARPS) {
      const int r = 4 * (cell % (ROWS / 4)) + lane / 8, j = 8 * (cell / (ROWS / 4)) + lane % 8;
      if (j >= F) continue;
      const bool live = r < rows;
      const float c = rowop[4 * r];
      const float* acc_rj = acc_base + r * F + j;
      if (a.gamma == GAMMA_PNA) {
        float q[4] = {0.f, 0.f, 0.f, 0.f};
        if (live) {
          const float sq = acc_rj[slot_of(a.ops, OP_SQSUM) * ROWS * F];
          const float mean = sum[r * F + j] / c;
          q[0] = mean;
          q[1] = sqrtf(fmaxf(__fsub_rn(sq / c, __fmul_rn(mean, mean)), 0.f));
          q[2] = acc_rj[slot_of(a.ops, OP_MAX) * ROWS * F];
          q[3] = acc_rj[slot_of(a.ops, OP_MIN) * ROWS * F];
        }
#pragma unroll
        for (int s = 0; s < 3; ++s)
#pragma unroll
          for (int q4 = 0; q4 < 4; ++q4)
            tower[(s * 4 * F + q4 * F + j) * PR + r] = q[q4] * rowop[4 * r + 1 + s];
      } else {  // DGN: [x_res, mean, |wsum - x_res * nop|]
        float mean = 0.f, dx = 0.f;
        if (live) {
          const float ws = acc_rj[slot_of(a.ops, OP_WSUM) * ROWS * F];
          mean = sum[r * F + j] / c;
          dx = fabsf(__fsub_rn(ws, __fmul_rn(tower[j * PR + r], rowop[4 * r + 1])));
        }
        tower[(F + j) * PR + r] = mean;
        tower[(2 * F + j) * PR + r] = dx;
      }
    }
  }
  __syncthreads();
  phase_mark(3);

  if (a.int8) {
    // per-row exact-range quantization of the tower: thread t takes row
    // t % ROWS and every (THREADS / ROWS)-th k for the row maxima, combined
    // through the (still free) weight stage; then the threads quantize the
    // tile word by word, consecutive threads on consecutive rows
    constexpr int PARTS = THREADS / ROWS;
    float* part = stage;
    {
      const int r = threadIdx.x % ROWS;
      float m = 0.f;
      for (int k = threadIdx.x / ROWS; k < a.k1; k += PARTS) m = fmaxf(m, fabsf(tower[k * PR + r]));
      part[threadIdx.x] = m;
    }
    __syncthreads();
    if (threadIdx.x < ROWS) {
      float m = 0.f;
#pragma unroll
      for (int q = 0; q < PARTS; ++q) m = fmaxf(m, part[q * ROWS + threadIdx.x]);
      rs[threadIdx.x] = fmaxf(m, 1e-8f) / 127.0f;
    }
    __syncthreads();
#pragma unroll 2
    for (int idx = threadIdx.x; idx < ROWS * kq; idx += THREADS) {
      const int r = idx % ROWS, w = idx / ROWS;
      const float scale = rs[r];
      unsigned word = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int k = 4 * w + b;
        const float t = k < a.k1 ? tower[k * PR + r] : 0.f;
        const float q = t == 0.f ? 0.f : fminf(fmaxf(rintf(t / scale), -128.f), 127.f);
        word |= (unsigned)(unsigned char)(signed char)(int)q << (8 * b);
      }
      qtile[w * PR + r] = (int)word;
    }
    __syncthreads();
  }

  phase_mark(4);
  // the epilogues get a thread's block of rows row0 .. row0 + RM - 1 and
  // columns col .. col + 3 (gemm_f32 / gemm_i8); each loads what it reads
  // first
  constexpr int RM = 4;  // rows per thread of a product pass (Tile)
  int* istage = reinterpret_cast<int*>(stage);
  if (a.gamma == GAMMA_GIN) {
    // hidden = relu(tower @ w1 + b1), kept in shared memory (H1 x ROWS)
    if (a.int8) {
      product_i8<ROWS>(qtile, PR, a.k1, static_cast<const signed char*>(a.w1), a.h1, istage,
                       [&](int row0, int col, const int (&acc)[RM][4]) {
                         float s[4], bias[4];
#pragma unroll
                         for (int j = 0; j < 4; ++j) {
                           s[j] = col + j < a.h1 ? a.s1[col + j] : 0.f;
                           bias[j] = col + j < a.h1 ? a.b1[col + j] : 0.f;
                         }
#pragma unroll
                         for (int i = 0; i < RM; ++i)
#pragma unroll
                           for (int j = 0; j < 4; ++j)
                             if (col + j < a.h1)
                               hidden[(col + j) * PR + row0 + i] =
                                   dequant_relu(acc[i][j], rs[row0 + i], s[j], bias[j]);
                       });
    } else {
      product_f32<ROWS>(tower, PR, a.k1, static_cast<const float*>(a.w1), a.h1, stage,
                        [&](int row0, int col, const float (&acc)[RM][4]) {
                          float bias[4];
#pragma unroll
                          for (int j = 0; j < 4; ++j) bias[j] = col + j < a.h1 ? a.b1[col + j] : 0.f;
#pragma unroll
                          for (int i = 0; i < RM; ++i)
#pragma unroll
                            for (int j = 0; j < 4; ++j)
                              if (col + j < a.h1)
                                hidden[(col + j) * PR + row0 + i] = fmaxf(acc[i][j] + bias[j], 0.f);
                        });
    }
    __syncthreads();
    phase_mark(5);
    product_f32<ROWS>(hidden, PR, a.h1, a.w2, a.f_out, stage,
                      [&](int row0, int col, const float (&acc)[RM][4]) {
                        float bias[4];
                        bool keep[RM];
#pragma unroll
                        for (int j = 0; j < 4; ++j) bias[j] = col + j < a.f_out ? a.b2[col + j] : 0.f;
#pragma unroll
                        for (int i = 0; i < RM; ++i) keep[i] = row0 + i < rows && a.mask[lo + row0 + i];
#pragma unroll
                        for (int i = 0; i < RM; ++i)
#pragma unroll
                          for (int j = 0; j < 4; ++j) {
                            const int r = row0 + i, c = col + j;
                            if (r < rows && c < a.f_out)
                              a.out[(size_t)(lo + r) * a.f_out + c] = keep[i] ? acc[i][j] + bias[j] : 0.f;
                          }
                      });
    phase_end();
    return;
  }
  // pna / dgn: out = relu(tower @ w1 + b1) + x_res
  phase_mark(5);
  auto residual = [&](int row0, int col, const float (&y)[RM][4]) {
    float xr[RM][4];
    bool keep[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = row0 + i;
      keep[i] = r < rows && a.mask[lo + r];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        xr[i][j] = r < rows && col + j < a.f_out ? a.x_res[(size_t)(lo + r) * a.fr + col + j] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = row0 + i, c = col + j;
        if (r < rows && c < a.f_out)
          a.out[(size_t)(lo + r) * a.f_out + c] = keep[i] ? y[i][j] + xr[i][j] : 0.f;
      }
  };
  if (a.int8) {
    product_i8<ROWS>(qtile, PR, a.k1, static_cast<const signed char*>(a.w1), a.f_out, istage,
                     [&](int row0, int col, const int (&acc)[RM][4]) {
                       float s[4], bias[4], y[RM][4];
#pragma unroll
                       for (int j = 0; j < 4; ++j) {
                         s[j] = col + j < a.f_out ? a.s1[col + j] : 0.f;
                         bias[j] = col + j < a.f_out ? a.b1[col + j] : 0.f;
                       }
#pragma unroll
                       for (int i = 0; i < RM; ++i)
#pragma unroll
                         for (int j = 0; j < 4; ++j)
                           y[i][j] = dequant_relu(acc[i][j], rs[row0 + i], s[j], bias[j]);
                       residual(row0, col, y);
                     });
  } else {
    product_f32<ROWS>(tower, PR, a.k1, static_cast<const float*>(a.w1), a.f_out, stage,
                      [&](int row0, int col, const float (&acc)[RM][4]) {
                        float bias[4], y[RM][4];
#pragma unroll
                        for (int j = 0; j < 4; ++j) bias[j] = col + j < a.f_out ? a.b1[col + j] : 0.f;
#pragma unroll
                        for (int i = 0; i < RM; ++i)
#pragma unroll
                          for (int j = 0; j < 4; ++j) y[i][j] = fmaxf(acc[i][j] + bias[j], 0.f);
                        residual(row0, col, y);
                      });
  }
  phase_end();
}

// Dynamic shared memory one block of `rows` destinations needs, in bytes
// (the wrapper, kernels/fused_mp.py:smem_bytes, mirrors it): fp32
// accumulators; the tower and GIN's hidden layer, k-major at rows + 4 words
// a k; for int8 the row scales and the int8 tile (four k to a word, rows + 4
// words a word); and two staged weight slices (fp32, or int8 when every
// product of gamma is int8).
long long smem_bytes(int f, int ops, int k1, int h1, int int8, int rows) {
  const long long pr = rows + 4;
  long long words = (long long)rows * __builtin_popcount(ops) * f + pr * (k1 + h1);
  if (int8) words += rows + pr * ((k1 + 3) / 4);
  if (k1 > 0) words += (int8 && h1 == 0) ? STAGE_WORDS : 2 * STAGE_WORDS;
  return 4 * words;
}

// Destinations per block (kernels/fused_mp.py:rows_for mirrors it): 16 for a
// gamma with no linear (GCN), which gains nothing from a wider tile while
// each warp would walk twice as many destinations; else 32, or 16 where 32
// rows' shared memory would pass the limit.
int rows_for(int f, int ops, int k1, int h1, int int8) {
  if (k1 == 0) return 16;
  return smem_bytes(f, ops, k1, h1, int8, 32) <= MAX_SMEM ? 32 : 16;
}

// Largest dynamic shared memory opted into so far, per instance and device:
// the opt-in (cudaFuncSetAttribute) is made only when a launch needs more,
// so the common call pays for no attribute call.
constexpr int MAX_DEVICES = 64;
long long smem_opted[3][MAX_DEVICES] = {};

template <int ROWS, bool LINEAR>
int launch(const Args& a, long long smem, int dev, cudaStream_t stream) {
  long long& opted = smem_opted[LINEAR ? 1 + (ROWS == 32) : 0][dev];
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_mp_kernel<ROWS, LINEAR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  fused_mp_kernel<ROWS, LINEAR><<<(a.n + ROWS - 1) / ROWS, THREADS, (size_t)smem, stream>>>(a);
  return (int)cudaGetLastError();
}

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
  const int rows = rows_for(f, ops, k1, h1, int8);
  const long long smem = smem_bytes(f, ops, k1, h1, int8, rows);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (gamma == GAMMA_GCN) return launch<16, false>(a, smem, dev, stream);
  return rows == 32 ? launch<32, true>(a, smem, dev, stream)
                    : launch<16, true>(a, smem, dev, stream);
}

#ifdef FUSED_MP_PHASES
// The phase marks of the last launches (MARK_BLOCKS x 8 nanosecond stamps).
extern "C" int fused_mp_read_marks(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, phase_marks, sizeof(phase_marks));
}
#endif
