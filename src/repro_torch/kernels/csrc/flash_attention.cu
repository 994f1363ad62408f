// flash_attention.cu — causal / sliding-window GQA attention with an online
// softmax (flash attention, forward), fp32 or bf16 in, fp32 arithmetic.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention (the Pallas
// _flash_kernel), which is also the deployment form of the LM substrate's
// models/layers.py:blocked_attention.  For q (B, Hq, S, D), k, v
// (B, Hkv, S, D), Hq % Hkv == 0, query head h reads KV head h / (Hq / Hkv):
//
//     s[i, j] = (q_i . k_j) * scale            scale = 1 / sqrt(D)
//     s       = tanh(s / softcap) * softcap    when softcap > 0
//     s[i, j] masked unless j <= i (causal) and j > i - window (window > 0)
//     o_i     = sum_j softmax_j(s[i, :]) v_j   accumulated in fp32
//
// written in the input dtype.  Beyond the Pallas kernel: S of any length (the
// tail rows and columns are masked), D in {8, 16, 32, 64, 128, 256}, explicit
// strides for q, k, v and o (so (B, S, H, D) tensors go in as transposed views,
// no copy), and an optional softcap.
//
// Bound on the H100: per (query, key) pair in the causal band the kernel does
// 4 D operations (two D-long dot products); q, k, v and o are read or written
// once.  At ChatGLM3's prefill (B 8, Hq 32, Hkv 16, S 512, D 128, bf16) that is
// ~17 GFLOP against ~67 MB: ~17 us on the bf16 tensor cores, ~20 us on bytes.
// This first kernel runs on the CUDA cores in fp32 (67 TFLOP/s at most), so
// its floor is ~0.3 ms, and its inner loops read shared memory once per two
// FMAs, which bounds it further.  wgmma, TMA and bf16 tensor cores are later
// work.
//
// Design: one CTA of 256 threads per (batch, query head, 64-row query tile),
// as the Pallas grid's (batch * heads, q blocks); the Pallas kernel's
// sequential k grid axis becomes a loop over 64-row KV tiles inside the CTA.
// Only tiles that meet the causal / window band are visited (pl.when's
// pruning).  Each KV tile is staged through shared memory as fp32 (the Q and K
// rows padded by one float so the column reads hit distinct banks).  A 16 x 16
// thread grid computes the 64 x 64 score tile, 4 x 4 scores per thread; each
// query row's running max and sum are reduced across its 16 threads with
// shuffles and kept in registers, beside the thread's 4 rows x D/16 columns of
// the fp32 accumulator.  The probabilities pass through shared memory (over
// the K tile, which is no longer needed) to the P.V product.  Heavier query
// tiles (later rows see more keys) launch first.  expf and tanhf are the
// accurate libdevice ones (no --use_fast_math); FMAs are fp32, no TF32.
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

template <int D>
__host__ __device__ constexpr size_t smem_floats() {
  // Q tile, K tile (reused for P), V tile
  return (size_t)BQ * (D + 1)
         + ((size_t)BK * (D + 1) > (size_t)BQ * PP ? (size_t)BK * (D + 1) : (size_t)BQ * PP)
         + (size_t)BK * D;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, Strides qs, Strides ks, Strides vs, Strides os, int hq,
    int group, int s, int causal, int window, float scale, float softcap) {
  constexpr int DP = D + 1;               // padded row of the Q and K tiles
  constexpr int CN = (D + TX - 1) / TX;   // output columns per thread
  constexpr size_t KP = smem_floats<D>() - (size_t)BQ * DP - (size_t)BK * D;
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
      Vs[r * D + c] = in ? to_f(vb[kpos * vs.s + c]) : 0.f;
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
        if (D % TX == 0 || d < D) {
          const float vv = Vs[j * D + d];
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
      if (D % TX == 0 || d < D) store(ob + qpos * os.s + d, acc[i][c] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, Strides qs,
           Strides ks, Strides vs, Strides os, int b, int hq, int hkv, int s,
           int causal, int window, float scale, float softcap, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kernel = flash_fwd_kernel<T, D>;
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
int dispatch_d(int d, const void* q, const void* k, const void* v, void* o, Strides qs,
               Strides ks, Strides vs, Strides os, int b, int hq, int hkv, int s,
               int causal, int window, float scale, float softcap, cudaStream_t stream) {
#define FA_CASE(DIM)                                                                   \
  case DIM:                                                                            \
    return launch<T, DIM>(q, k, v, o, qs, ks, vs, os, b, hq, hkv, s, causal, window, \
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

}  // namespace

// Plain C entry point (loaded through ctypes).  q (B, Hq, S, D), k and v
// (B, Hkv, S, D), o (B, Hq, S, D), each addressed through its (batch, head,
// row) strides in elements with a unit feature stride; dtype 0 = fp32, 1 =
// bf16 (all four tensors).  window 0 = no window.  Launches on `stream`, does
// not synchronise, and returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss, long long o_sb, long long o_sh,
    long long o_ss, int b, int hq, int hkv, int s, int d, int causal, int window,
    int dtype, float scale, float softcap, cudaStream_t stream) {
  if (b <= 0 || hq <= 0 || s <= 0) return (int)cudaSuccess;
  if (hkv <= 0 || hq % hkv != 0 || window < 0) return (int)cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, o, qs, ks, vs, os, b, hq, hkv, s, causal, window,
                             scale, softcap, stream);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, o, qs, ks, vs, os, b, hq, hkv, s, causal,
                                     window, scale, softcap, stream);
  return (int)cudaErrorInvalidValue;
}
