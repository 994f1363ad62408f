// flash_attention.cu — causal / sliding-window GQA attention with an online
// softmax (flash attention, forward), fp32 or bf16 in, fp32 accumulation.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention (the Pallas
// _flash_kernel), which is also the deployment form of the LM substrate's
// models/layers.py:blocked_attention.  For q (B, Hq, S, D), k (B, Hkv, S, D),
// v (B, Hkv, S, DV), Hq % Hkv == 0, query head h reads KV head h / (Hq / Hkv):
//
//     s[i, j] = (q_i . k_j) * scale            scale = 1 / sqrt(D)
//     s       = tanh(s / softcap) * softcap    when softcap > 0
//     s[i, j] masked unless j <= i (causal) and j > i - window (window > 0)
//     o_i     = sum_j softmax_j(s[i, :]) v_j   accumulated in fp32
//
// written in the input dtype, o (B, Hq, S, DV).  Beyond the Pallas kernel: S of
// any length (the tail rows and columns are masked), DV = D in {8, 16, 32, 64,
// 128, 256} and MLA's (D, DV) = (96, 64) (MiniCPM3's prefill: nope 64 + rope 32
// against a value head of 64, as JAX's blocked_attention takes dv != d),
// explicit strides for q, k, v and o (so (B, S, H, D) tensors go in as
// transposed views, no copy), and an optional softcap.
//
// Bound on the H100: per (query, key) pair in the causal band the kernel does
// 2 (D + DV) operations (a D-long and a DV-long dot product); q, k, v and o
// are read or written once.  At ChatGLM3's prefill (B 8, Hq 32, Hkv 16, S 512, D 128, bf16) that
// is 17.2 GFLOP against 100.7 MB (q and o 33.6 MB each, k and v 16.8 MB each):
// 17.4 us on the bf16 tensor cores, 30.0 us on bytes (chip_smoke.py's
// time_flash_attention counts the same).  At Gemma-3's global layer (B 2,
// Hq = Hkv = 16, S 2048, D 256) it is 68.8 GFLOP against 134 MB: 69.5 us on
// the tensor cores, 40.1 us on bytes.  At MiniCPM3's prefill (B 8, H 40,
// S 1024, D 96, DV 64) it is 53.7 GFLOP against 210 MB: 54.3 us on the tensor
// cores, 62.6 us on bytes.
//
// Two designs ("routes"), chosen by the caller from (dtype, D, DV) up front
// (kernels/flash_attention.py:route) and never swapped after a failure:
//
// "mma" — bf16 at (D, DV) in {(64, 64), (128, 128), (256, 256), (96, 64)}: the
// FlashAttention-2 shape on the tensor cores.  One CTA of 4 warps per (64-row query tile, batch x query
// head), each warp owning 16 query rows; the Pallas kernel's sequential k grid
// axis becomes a loop over KV tiles of 64 rows (32 at D = 256, 16 with a
// softcap there, to fit the registers) inside the CTA, visiting only the
// tiles that meet the causal / window band, and applying the per-element mask
// only on the tiles that cut the band's edge or the ragged tail.  S = Q K^T and O += P V run as
// mma.sync.m16n8k16 bf16 x bf16 -> fp32 (bf16 products are exact in fp32, so
// the scores are what the Pallas kernel computes), with fragments loaded by
// ldmatrix (ldmatrix.trans for V as PV's B operand).  The online softmax stays
// in registers: each thread holds two rows' scores, their max and sum reduced
// over the row's quad by shuffles, scale * log2(e) folded into one FMA before
// exp2f (accurate libdevice tanhf / exp2f, no --use_fast_math; the softcap is
// a template switch, so the uncapped instance carries no tanh path).  P is
// rounded to bf16 once to feed the PV mma, as every tensor-core flash kernel
// does.  Q, K and V are copied as bf16 with 16-byte cp.async (zero-filled
// past S) into shared memory whose rows are XOR-swizzled in 16-byte chunks (at
// 96 columns padded by one chunk instead: mma::Tile), so ldmatrix is free of
// bank conflicts; K and V ride a ring of stages (three at
// D <= 128, two at 256), the next tile's copy overlapping this tile's mma.  Q sits in registers at D <= 128
// and is re-read from shared memory per k step at D = 256; each lane's
// ldmatrix addresses are four precomputed offsets per operand plus
// immediates, which keeps the D = 256 instances free of spills.  Shared
// memory: Q 8 / 16 / 32 KB plus the stages of K and V, 56 / 112 / 96 KB in
// all at D = 64 / 128 / 256 (64 KB with a softcap at 256; 76 KB at (96, 64):
// the Q and K rows 96 wide plus their pad, V's 64), two CTAs per SM.  Q, K and
// the QK^T k-loop are sized by D, V, the O registers and the output by DV.  The
// output is staged through the warp's own Q rows and written as 16-byte rows.
// This route needs 16-byte-aligned data and (batch, head, row) strides that are
// multiples of 8 elements (the wrapper checks; this entry refuses otherwise).
//
// "simt" — fp32 at every (D, DV), bf16 at D in {8, 16, 32}: fp32 FMAs on the CUDA
// cores (fp32 cannot reach the tensor cores without TF32, which the port
// forbids: the JAX kernel and its oracle are IEEE fp32).  One CTA of 256
// threads per (batch, query head, 64-row query tile); each KV tile is staged
// through shared memory as fp32 (the Q and K rows padded by one float so the
// column reads hit distinct banks).  A 16 x 16 thread grid computes the 64 x
// 64 score tile, 4 x 4 scores per thread; each query row's running max and sum
// are reduced across its 16 threads with shuffles and kept in registers,
// beside the thread's 4 rows x DV/16 columns of the fp32 accumulator.  The
// probabilities pass through shared memory (over the K tile) to the P.V
// product.  expf and tanhf are the accurate libdevice ones.
//
// Both: heavier query tiles (later rows see more keys) launch first; masked
// scores take the Pallas kernel's -1e30 (the mma route uses -inf inside a
// tile and -1e30 as the running max's start, which gives the same weights);
// rows are divided by max(l, 1e-30).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 64;            // query rows per CTA
constexpr int BK = 64;            // key rows per KV tile
constexpr int TX = 16;            // threads along the key / feature columns
constexpr int TY = THREADS / TX;  // threads along the query rows
constexpr int RM = BQ / TY;       // query rows per thread
constexpr int RN = BK / TX;       // key columns per thread
constexpr int PP = BK + 4;        // padded row of the probability tile
constexpr float NEG = -1e30f;     // the Pallas kernel's fill
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

struct Strides {  // in elements; the last (feature) stride is 1
  long long b, h, s;
};

template <int D, int DV>
__host__ __device__ constexpr size_t smem_floats() {
  // Q tile, K tile (reused for P), V tile
  return (size_t)BQ * (D + 1)
         + ((size_t)BK * (D + 1) > (size_t)BQ * PP ? (size_t)BK * (D + 1) : (size_t)BQ * PP)
         + (size_t)BK * DV;
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, Strides qs, Strides ks, Strides vs, Strides os, int hq,
    int group, int s, int causal, int window, float scale, float softcap) {
  constexpr int DP = D + 1;               // padded row of the Q and K tiles
  constexpr int CN = (DV + TX - 1) / TX;  // output columns per thread
  constexpr size_t KP = smem_floats<D, DV>() - (size_t)BQ * DP - (size_t)BK * DV;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;
  float* Ps = Ks;  // the probabilities overwrite the K tile after the scores
  float* Vs = Ks + KP;

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int bh = blockIdx.x;
  const int b = bh / hq, h = bh % hq, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heavier tiles first
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D, qpos = q0 + r;
    Qs[r * DP + c] = qpos < s ? to_f(qb[qpos * qs.s + c]) : 0.f;
  }

  float m[RM], l[RM], acc[RM][CN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CN; ++c) acc[i][c] = 0.f;
  }

  // KV tiles that meet the band: keys k_begin .. k_end - 1
  const int q_last = min(q0 + BQ, s) - 1;
  const int k_end = causal ? q_last + 1 : s;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int kt = k_begin / BK; kt * BK < k_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's P and V reads are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D, kpos = k0 + r;
      const bool in = kpos < s;
      Ks[r * DP + c] = in ? to_f(kb[kpos * ks.s + c]) : 0.f;
      if (c < DV) Vs[r * DV + c] = in ? to_f(vb[kpos * vs.s + c]) : 0.f;
    }
    __syncthreads();

    float sc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RM], kv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = Qs[(ty * RM + i) * DP + d];
#pragma unroll
      for (int j = 0; j < RN; ++j) kv[j] = Ks[(tx + TX * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

    // scale, softcap, mask; the online softmax of each row over its 16 threads
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qpos = q0 + ty * RM + i;
      bool ok[RN];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int kpos = k0 + tx + TX * j;
        float x = sc[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        ok[j] = kpos < s && (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
        sc[i][j] = ok[j] ? x : NEG;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        sc[i][j] = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        rs += sc[i][j];
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1) rs += __shfl_xor_sync(FULL, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CN; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread is done reading the K tile
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) Ps[(ty * RM + i) * PP + tx + TX * j] = sc[i][j];
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = Ps[(ty * RM + i) * PP + j];
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int d = tx + TX * c;
        if (DV % TX == 0 || d < DV) {
          const float vv = Vs[j * DV + d];
#pragma unroll
          for (int i = 0; i < RM; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qpos = q0 + ty * RM + i;
    if (qpos >= s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CN; ++c) {
      const int d = tx + TX * c;
      if (DV % TX == 0 || d < DV) store(ob + qpos * os.s + d, acc[i][c] / denom);
    }
  }
}

template <typename T, int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, Strides qs,
           Strides ks, Strides vs, Strides os, int b, int hq, int hkv, int s,
           int causal, int window, float scale, float softcap, cudaStream_t stream) {
  const size_t smem = smem_floats<D, DV>() * sizeof(float);
  auto kernel = flash_fwd_kernel<T, D, DV>;
  // above 48 KB of shared memory only after opting in (per device: every call)
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_qt = (s + BQ - 1) / BQ;
  if ((long long)b * hq > 2147483647LL || n_qt > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)(b * hq), (unsigned)n_qt);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), qs, ks, vs, os, hq, hq / hkv, s, causal, window, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, int dv, const void* q, const void* k, const void* v, void* o,
               Strides qs, Strides ks, Strides vs, Strides os, int b, int hq, int hkv,
               int s, int causal, int window, float scale, float softcap,
               cudaStream_t stream) {
  if (d == 96 && dv == 64)  // MLA (MiniCPM3): nope 64 + rope 32 against v 64
    return launch<T, 96, 64>(q, k, v, o, qs, ks, vs, os, b, hq, hkv, s, causal, window,
                             scale, softcap, stream);
  if (dv != d) return (int)cudaErrorInvalidValue;
#define FA_CASE(DIM)                                                                        \
  case DIM:                                                                                 \
    return launch<T, DIM, DIM>(q, k, v, o, qs, ks, vs, os, b, hq, hkv, s, causal, window, \
                               scale, softcap, stream);
  switch (d) {
    FA_CASE(8)
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    FA_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FA_CASE
}


// ------------------------------------------------------------ the mma route

namespace mma {

constexpr float LOG2E = 1.4426950408889634f;
using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BQ = WARPS * 16;  // query rows per CTA, 16 per warp

// A bf16 tile of D columns in shared memory.  At D % 64 == 0 its rows are
// D long and XOR-swizzled: chunk c (16 bytes) of row r sits at chunk
// c ^ (r % 8), so the 8 rows an ldmatrix reads at one chunk column land in 8
// distinct bank groups.  Other widths (MLA's 96: 12 chunks, which an 8-chunk
// swizzle would carry past the row) pad each row by one chunk instead: a
// pitch of 13 chunks (208 bytes) puts 8 consecutive rows at 8 distinct bank
// groups too.
template <int D>
struct Tile {
  static_assert(D % 16 == 0, "whole 16-element mma steps");
  static constexpr bool SWIZZLED = D % 64 == 0;
  static constexpr int PITCH = SWIZZLED ? D : D + 8;  // elements per row
  // element offset of (row, 16-byte chunk c)
  static __device__ __forceinline__ int at(int row, int c) {
    return SWIZZLED ? row * D + ((c ^ (row & 7)) << 3) : row * PITCH + (c << 3);
  }
};

// D: the query / key head dim (Q and K tiles, the QK^T k-loop); DV <= D: the
// value head dim (V tiles, the O accumulator, the output)
template <int D, int DV, bool CAPPED>
struct Cfg {
  static_assert(DV <= D, "the output is staged in the Q tile's rows");
  // key rows per KV tile: fewer at D = 256 to fit the registers (the
  // softcap's tanh needs more of them)
  static constexpr int BK = D < 256 ? 64 : CAPPED ? 16 : 32;
  // K / V ring stages: three drop the barrier before a stage is refilled
  // (a warp is at most one tile ahead of another); two at D = 256, where
  // three would leave one CTA per SM
  static constexpr int STAGES = D < 256 ? 3 : 2;
  static constexpr int PQ = Tile<D>::PITCH, PV = Tile<DV>::PITCH;
  static constexpr bool Q_IN_REGS = D <= 128;
  // Q tile, then the stages of (K tile, V tile), all bf16
  static constexpr size_t SMEM = (size_t)(BQ * PQ + STAGES * BK * (PQ + PV)) * sizeof(bf16);
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Byte offsets of one lane's ldmatrix row in a tile: row `row` at chunk
// 2 kk + lo sits at at(kk), and row + 8 i at at(kk) + 16 i PITCH.  Swizzled,
// (2 kk + lo) ^ (row % 8) only depends on kk % 4 below its multiple of 8: four
// registers per operand, the rest immediates; padded, one register.
template <int D>
struct FragAddr {
  unsigned off[Tile<D>::SWIZZLED ? 4 : 1];
  __device__ __forceinline__ FragAddr(int row, int lo) {
#pragma unroll
    for (int j = 0; j < (Tile<D>::SWIZZLED ? 4 : 1); ++j) off[j] = 2 * Tile<D>::at(row, 2 * j + lo);
  }
  __device__ __forceinline__ unsigned at(int kk) const {
    if constexpr (Tile<D>::SWIZZLED) return off[kk & 3] + (kk >> 2) * 128;
    else return off[0] + kk * 32;
  }
};

// 16-byte global -> shared copy; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<unsigned*>(&v);
}

// Copy rows r0 .. r0 + R - 1 (those below s; the rest zero-filled) of a
// (rows, D) bf16 matrix with row stride `stride` into a tile.
template <int D, int R>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, long long stride,
                                          int r0, int s, int tid) {
  constexpr int CH = D / 8;
  static_assert((R * CH) % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < R * CH / THREADS; ++i) {
    const int idx = tid + i * THREADS, r = idx / CH, c = idx % CH, pos = r0 + r;
    const bool in = pos < s;
    cp_async16(smem_u32(dst + Tile<D>::at(r, c)), src + (long long)(in ? pos : 0) * stride + c * 8,
               in ? 16 : 0);
  }
}

template <int D, int DV, bool CAPPED>
__global__ void __launch_bounds__(THREADS, 2) flash_fwd_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, Strides qs, Strides ks, Strides vs, Strides os, int hq, int group,
    int s, int causal, int window, float scale, float softcap) {
  using C = Cfg<D, DV, CAPPED>;
  constexpr int BK = C::BK, PQ = C::PQ, PV = C::PV;
  constexpr int NT = BK / 8;  // score n-tiles (8 keys) per KV tile
  constexpr int DT = DV / 8;  // output n-tiles (8 features)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* KV = Qs + BQ * PQ;  // stage st: K at KV + st * BK * (PQ + PV), V BK * PQ after

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // the mma fragments' row and column pair
  const int bh = blockIdx.x;
  const int b = bh / hq, h = bh % hq, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heavier tiles first
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  bf16* ob = o + b * os.b + h * os.h;

  // KV tiles that meet the band: keys k_begin .. k_end - 1
  const int q_last = min(q0 + BQ, s) - 1;
  const int k_end = causal ? q_last + 1 : s;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt0 = k_begin / BK, n_tiles = (k_end + BK - 1) / BK - kt0;

  auto load_kv = [&](int stage, int kt) {
    bf16* Ks = KV + stage * BK * (PQ + PV);
    load_rows<D, BK>(Ks, kb, ks.s, kt * BK, s, tid);
    load_rows<DV, BK>(Ks + BK * PQ, vb, vs.s, kt * BK, s, tid);
  };
  load_rows<D, BQ>(Qs, qb, qs.s, q0, s, tid);
  cp_async_commit();
  load_kv(0, kt0);
  cp_async_commit();

  // ldmatrix rows of this lane: Q's A fragments (rows warp * 16 + lane % 16,
  // chunk 2 kk + lane / 16), K's B fragments (two 8-key n-tiles per x4) and
  // V's transposed B fragments (two 8-feature n-tiles per x4)
  const FragAddr<D> qa(warp * 16 + (lane & 15), lane >> 4);
  const FragAddr<D> ka((lane & 7) + ((lane >> 4) << 3), (lane >> 3) & 1);
  const FragAddr<DV> va((lane & 7) + (((lane >> 3) & 1) << 3), lane >> 4);
  const unsigned q_base = smem_u32(Qs), kv_base = smem_u32(KV);
  unsigned qf[C::Q_IN_REGS ? D / 16 : 1][4];
  if constexpr (C::Q_IN_REGS) {
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qf[kk], q_base + qa.at(kk));
  }

  float oacc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // rows g and g + 8 of the warp
  // scores reach the log2 domain as x * s2: uncapped x is the raw score and
  // s2 = scale * log2(e) (folded into the exp2's FMA); capped x is
  // tanh(raw * scale / softcap) * softcap * log2(e) and s2 = 1
  const float pre = CAPPED ? scale / softcap : scale * LOG2E;
  const float post = softcap * LOG2E;
  const float s2 = CAPPED ? 1.f : pre;
  const int row0 = q0 + warp * 16 + g;  // this thread's first query row

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_kv((it + 1) % C::STAGES, kt0 + it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned k_base = kv_base + (it % C::STAGES) * 2 * BK * (PQ + PV);  // bytes
    const unsigned v_base = k_base + 2 * BK * PQ;
    const int k0 = (kt0 + it) * BK;

    // S = Q K^T: B fragments of two 8-key n-tiles per ldmatrix.x4
    float sacc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned a[4];
      if constexpr (C::Q_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldmatrix_x4(a, q_base + qa.at(kk));
      }
#pragma unroll
      for (int nn = 0; nn < BK / 16; ++nn) {
        unsigned bk[4];
        ldmatrix_x4(bk, k_base + ka.at(kk) + nn * 32 * PQ);
        mma_bf16(sacc[2 * nn], a, bk[0], bk[1]);
        mma_bf16(sacc[2 * nn + 1], a, bk[2], bk[3]);
      }
    }

    // the per-element mask only where the tile cuts the band's edge or the
    // ragged tail
    const bool edge = (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && k0 <= q0 + BQ - 1 - window) || k0 + BK > s;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = CAPPED ? tanhf(sacc[j][e] * pre) * post : sacc[j][e];
        if (edge) {
          const int qpos = row0 + ((e >> 1) << 3), kpos = k0 + j * 8 + 2 * t4 + (e & 1);
          const bool ok = kpos < s && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          x = ok ? x : -INFINITY;
        }
        sacc[j][e] = x;
      }

    // online softmax of rows g (elements 0, 1) and g + 8 (elements 2, 3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(sacc[j][2 * r], sacc[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m[r], mx);  // finite: m starts at -1e30
      const float alpha = exp2f((m[r] - m_new) * s2);
      const float m_s2 = m_new * s2;
      m[r] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          sacc[j][e] = exp2f(fmaf(sacc[j][e], s2, -m_s2));  // masked: exp2(-inf) = 0
          rs += sacc[j][e];
        }
      l[r] = l[r] * alpha + rs;  // this thread's share; the quad sums at the end
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        oacc[j][2 * r] *= alpha;
        oacc[j][2 * r + 1] *= alpha;
      }
    }

    // O += P V: the score accumulators of n-tiles 2 kk, 2 kk + 1 are the A
    // fragment of the 16-key step kk; V's B fragments come transposed
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const unsigned a[4] = {pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
                             pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
                             pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
                             pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DV / 16; ++dn) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, v_base + va.at(dn) + kk * 32 * PV);
        mma_bf16(oacc[2 * dn], a, bv[0], bv[1]);
        mma_bf16(oacc[2 * dn + 1], a, bv[2], bv[3]);
      }
    }
    if constexpr (C::STAGES == 2) __syncthreads();  // done with this stage before its refill
  }

  // normalise, stage the warp's 16 rows in its own Q rows, write 16-byte rows
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float t = l[r];
    t += __shfl_xor_sync(FULL, t, 1);
    t += __shfl_xor_sync(FULL, t, 2);
    den[r] = fmaxf(t, 1e-30f);
  }
  const int srow = warp * 16 + g;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(Qs + Tile<D>::at(srow, j) + 2 * t4) =
        __floats2bfloat162_rn(oacc[j][0] / den[0], oacc[j][1] / den[0]);
    *reinterpret_cast<__nv_bfloat162*>(Qs + Tile<D>::at(srow + 8, j) + 2 * t4) =
        __floats2bfloat162_rn(oacc[j][2] / den[1], oacc[j][3] / den[1]);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * DT; i += 32) {
    const int r = warp * 16 + i / DT, c = i % DT, qpos = q0 + r;
    if (qpos < s)
      *reinterpret_cast<uint4*>(ob + qpos * os.s + c * 8) =
          *reinterpret_cast<const uint4*>(Qs + Tile<D>::at(r, c));
  }
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, Strides qs, Strides ks,
           Strides vs, Strides os, int b, int hq, int hkv, int s, int causal, int window,
           float scale, float softcap, cudaStream_t stream) {
  const bool capped = softcap > 0.f;
  const size_t smem = capped ? Cfg<D, DV, true>::SMEM : Cfg<D, DV, false>::SMEM;
  auto kernel = capped ? flash_fwd_mma<D, DV, true> : flash_fwd_mma<D, DV, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_qt = (s + BQ - 1) / BQ;
  if ((long long)b * hq > 2147483647LL || n_qt > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)(b * hq), (unsigned)n_qt);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), qs, ks, vs, os, hq, hq / hkv, s, causal, window, scale, softcap);
  return (int)cudaGetLastError();
}

// 16-byte cp.async needs a 16-byte-aligned base and strides of whole
// 8-element chunks (a stride along an axis of extent 1 is never used)
bool aligned(const void* p, const Strides& st, int b, int h, int s) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0 && (b == 1 || st.b % 8 == 0) &&
         (h == 1 || st.h % 8 == 0) && (s == 1 || st.s % 8 == 0);
}

}  // namespace mma

}  // namespace

// Plain C entry point (loaded through ctypes).  q and k (B, Hq / Hkv, S, D),
// v (B, Hkv, S, DV), o (B, Hq, S, DV), each addressed through its (batch,
// head, row) strides in elements with a unit feature stride; dtype 0 = fp32,
// 1 = bf16 (all four tensors).  window 0 = no window.  (D, DV) is (d, d) at d
// in {8, 16, 32, 64, 128, 256} or (96, 64).  route 0 = "simt", 1 = "mma"
// (bf16 at (64, 64), (128, 128), (256, 256) or (96, 64), aligned as
// mma::aligned says); a route with no instance for (dtype, D, DV) is refused.
// Launches on `stream`, does not synchronise, and returns the launch's
// cudaError_t (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, int b, int hq, int hkv, int s, int d, int dv, int causal, int window,
    int dtype, int route, float scale, float softcap, cudaStream_t stream) {
  if (b <= 0 || hq <= 0 || s <= 0) return (int)cudaSuccess;
  if (hkv <= 0 || hq % hkv != 0 || window < 0) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  if (route == 1) {
    if (dtype != 1 || !mma::aligned(q, qs, b, hq, s) || !mma::aligned(k, ks, b, hkv, s) ||
        !mma::aligned(v, vs, b, hkv, s) || !mma::aligned(o, os, b, hq, s))
      return (int)cudaErrorInvalidValue;
    if (d == 96 && dv == 64)
      return mma::launch<96, 64>(q, k, v, o, qs, ks, vs, os, b, hq, hkv, s, causal, window,
                                 scale, softcap, stream);
    if (dv != d) return (int)cudaErrorInvalidValue;
    switch (d) {
      case 64:
        return mma::launch<64, 64>(q, k, v, o, qs, ks, vs, os, b, hq, hkv, s, causal, window,
                                   scale, softcap, stream);
      case 128:
        return mma::launch<128, 128>(q, k, v, o, qs, ks, vs, os, b, hq, hkv, s, causal,
                                     window, scale, softcap, stream);
      case 256:
        return mma::launch<256, 256>(q, k, v, o, qs, ks, vs, os, b, hq, hkv, s, causal,
                                     window, scale, softcap, stream);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_d<float>(d, dv, q, k, v, o, qs, ks, vs, os, b, hq, hkv, s, causal,
                             window, scale, softcap, stream);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, dv, q, k, v, o, qs, ks, vs, os, b, hq, hkv, s,
                                     causal, window, scale, softcap, stream);
  return (int)cudaErrorInvalidValue;
}
