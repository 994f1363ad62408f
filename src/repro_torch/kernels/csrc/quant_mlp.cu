// quant_mlp.cu — y = act((x_q @ w_q) * scale * row_scale + b), int8 x int8
// with exact int32 accumulation on the tensor cores; and the same product of
// an fp32 x that the kernel quantizes per row itself (the int8-dynamic
// linear in one launch).
//
// Replaces: src/repro/kernels/quant_mlp.py:quant_node_mlp (Pallas body
// _qmlp_kernel), the quantized Node-Embedding PE that runs every int8 linear
// of the six GNN models (encoder, GCN's lin, GIN's edge embedding and MLP
// unfused, GAT's projection, PNA's pre linear, the virtual node's MLPs); and,
// in quant_mlp_dyn_f32, the per-row quantization that src/repro/quant/
// qconfig.py:quantized_linear hands to XLA before that kernel.
//
// Bound on the H100: the GNN linears are thin (K <= 960, N <= 200), so a
// call moves x (M*K bytes, or 4*M*K for fp32 x) and writes y (4*M*N bytes)
// once; (4096, 100) x (100, 200) is ~3.7 MB, ~1.1 us of HBM time, against
// ~0.08 us of int8 tensor-core time.  The output dominates the bytes, and at
// these sizes a launch's latency chain (load, wait, compute, store) is the
// real floor: the design shortens that chain.
//
// Design (sm_90a).  A launch is a short chain of dependent steps, each paid
// once per block (phase marks: kernels/quant_mlp_phases.py), so the design
// has few steps, little code per step and no runtime branch inside one.
//   * Blocks of 32 rows x up to 256 columns (every path's N in one block, so
//     x and w are read once a block), 512 threads: warp w computes the 16 x
//     32 output tile (w & 1, column group w >> 1).  A (4096, .) product is 128
//     blocks for the 132 SMs.  The activation and the vector path (N % 4 ==
//     0 and w_q on a word) are template parameters.
//   * Products on the tensor cores: mma.sync.m16n8k32 s8 x s8 -> s32, one
//     32-deep slice of K per mma.  The int32 sums are exact, so any order
//     gives the same bits.
//   * One commit group brings the tail's vectors (scale, bias, row scales:
//     4-byte cp.async into static shared memory, where the compiler cannot
//     sink them past the products) and x: the block's rows are rows * K
//     contiguous bytes whatever K is, copied by 16-byte cp.async from their
//     16-byte-aligned floor.  A second brings all of w (its K x N bytes are
//     contiguous where one block covers N) where it fits, else a ring of 8
//     32-row slices refilled behind the products.
//   * The int8 entry at K <= 32 (one slice: the encoder, the edge embedding)
//     reads its A fragments straight from the raw rows; at larger K it
//     unpacks them (whole words where K % 4 == 0) into a tile of K rounded up
//     to 32 (zero-filled) plus 16 bytes a row, which ldmatrix.x4 reads without
//     bank conflicts.
//   * The dynamic entry: 16 threads a row (8 at K <= 32) reduce max|x| over the staged fp32
//     rows by shuffles and quantize them into that tile by quant/qconfig.py's
//     recipe, bit for bit: rs = max(rowmax, 1e-8f) / 127 (IEEE division) and
//     q = clamp(rint(x / rs), -128, 127) with the IEEE quotient, ties to even
//     (quantize4 computes x * RN(1/rs) and divides only near a half-integer).
//     rs stays per row for the tail.  Rows come in batches where 32 rows of
//     fp32 would pass 64 KB.
//   * w keeps its row-major layout in shared memory; the transpose to the
//     k-major B fragments happens in registers: a group's four n-tiles take
//     the columns 4g + j (j = 0..3) for mma row g, so a lane's four
//     consecutive k of four n-tiles are four 32-bit words that eight
//     byte_perms transpose.  The loads of slice s + 1 are issued before slice
//     s's products.
//   * Tail: ((float)acc * scale[n]) * row_scale[m] + b[n], the JAX order, with
//     __fmul_rn / __fadd_rn so that nvcc cannot contract it into an FMA, then
//     the activation.  Each warp stages its 16 x 32 tile in shared memory and
//     writes it as 4 rows of 128 bytes a store; y is written once.
//   * Ragged M, K and N are masked (zero-filled tiles, masked stores); nothing
//     is padded on the host.  N > 256 runs several column blocks whose w rows
//     are gathered by plain byte loads (no path has such a width).  K and N
//     are bounded by one block's shared memory (227 KB): past it the entry
//     refuses the launch (cudaErrorInvalidValue).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;            // output rows per block: two 16-row mma tiles
constexpr int BN = 256;           // output columns per block: up to 8 groups
constexpr int GROUP = 32;         // columns of a group: four interleaved 8-column n-tiles
constexpr int KS = 32;            // reduction depth of a slice: one mma k-step
constexpr int THREADS = 512;      // 16 warps: warp w computes tile (w & 1, group w >> 1)
constexpr int WARPS = THREADS / 32;
constexpr int MAX_STAGES = 8;     // ring of w slices, where w does not fit whole
constexpr int OUT_PITCH = GROUP + 4;  // a warp's output tile: 16 rows x 32 columns, padded
constexpr long long FBUF_MAX = 65536;  // dynamic entry: bytes of fp32 rows staged at once
constexpr long long MAX_SMEM = 232448;  // a block's shared memory on the H100 (227 KB)
constexpr long long VEC_SMEM = 4 * (2 * BN + BM);  // the static scale, bias, row-scale vectors
constexpr unsigned FULL = 0xffffffffu;

enum Activation { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2 };

template <int ACT>
__device__ __forceinline__ float activate(float y) {
  if constexpr (ACT == ACT_RELU) return fmaxf(y, 0.f);
  if constexpr (ACT == ACT_GELU) {
    // tanh approximation, the default of jax.nn.gelu
    const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
    const float kKappa = 0.044715f;
    const float inner = kBeta * (y + kKappa * y * y * y);
    return 0.5f * y * (1.f + tanhf(inner));
  }
  return y;
}

// A block's dynamic shared memory, in bytes, planned on the host: the int8
// x tile (BM rows of `kp` bytes); the raw x rows (int8, or `batch` fp32 rows
// at a time); the warps' output tiles, which take the raw rows' space once x
// is in the tile (not where the int8 entry reads A from its raw rows at K <=
// 32); then w, whole (one stage of all K rows) where it fits, else a ring
// of MAX_STAGES slices of KS rows.  A w row is `ldw` bytes, and each stage
// has room for the reads past a ragged last column group.
struct Plan {
  int slices, kp, ldw, batch, resident, wstage, raw, out, ring;
  long long total;
};

Plan plan(long long k, long long n, bool dyn) {
  Plan p{};
  const long long slices = (k + KS - 1) / KS, kp = slices * KS + 16, ldw = n <= BN ? n : BN;
  long long batch = BM;
  while (dyn && batch > 1 && batch * k * 4 > FBUF_MAX) batch /= 2;
  const long long raw = BM * kp;
  const long long raw_bytes = ((dyn ? batch * k * 4 : BM * k) + 32 + 15) / 16 * 16;
  const long long out_bytes = WARPS * 16 * OUT_PITCH * 4;
  const bool alias = dyn || slices > 1;
  const long long out = alias ? raw : raw + raw_bytes;
  const long long ring = alias ? raw + (raw_bytes > out_bytes ? raw_bytes : out_bytes)
                               : out + out_bytes;
  const long long whole = (slices * KS * ldw + 48 + 15) / 16 * 16;
  const bool resident = ring + whole + VEC_SMEM <= MAX_SMEM;
  const long long wstage = resident ? whole : (KS * ldw + 48 + 15) / 16 * 16;
  p.total = ring + (resident ? 1 : MAX_STAGES) * wstage;
  if (p.total + VEC_SMEM > MAX_SMEM) return p;  // refused by the caller
  p.slices = (int)slices, p.kp = (int)kp, p.ldw = (int)ldw, p.batch = (int)batch;
  p.resident = resident, p.wstage = (int)wstage;
  p.raw = (int)raw, p.out = (int)out, p.ring = (int)ring;
  return p;
}

struct Args {
  const void* x;             // int8 (M, K) x_q; fp32 (M, K) x for the dynamic entry
  const signed char* w;      // int8 (K, N)
  const float* scale;        // (N,)
  const float* row_scale;    // (M, 1) or null (all rows 1); not read by the dynamic entry
  const float* b;            // (N,)
  float* y;                  // (M, N)
  int m, k, n;
  Plan p;
};

// Phase marks, built only with -DQUANT_MLP_PHASES (kernels/quant_mlp_phases.py):
// thread 0 of each of the first MARK_BLOCKS blocks records %globaltimer at
// the block's start (0), once its copies are issued (1), once x is in the
// tile (2: the int8 entry at K <= 32 has nothing to do here), once w and x
// have landed (3; with a ring of slices, before its first wait), after its
// products (4) and after its tail's stores (5).  Without the define they
// compile to nothing.
#ifdef QUANT_MLP_PHASES
constexpr int MARK_BLOCKS = 4096;
__device__ unsigned long long phase_marks[MARK_BLOCKS][8];
__device__ __forceinline__ void phase_mark(int i) {
  if (threadIdx.x == 0 && blockIdx.x < MARK_BLOCKS && blockIdx.y == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    phase_marks[blockIdx.x][i] = t;
  }
}
#else
__device__ __forceinline__ void phase_mark(int) {}
#endif

// ---- PTX wrappers

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy of `src_bytes` (0..16) bytes, the rest zero-filled
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// 4-byte copy (cp.async.ca: 4 bytes is below .cg's 16); src_bytes 0 zero-fills
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `n` (0..7) of this thread's commit groups are pending
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
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

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c (16 x 8, s32) += a (16 x 32, s8, row) . b (32 x 8, s8, col)
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- end of PTX wrappers

// r[i] holds bytes (k_i, c .. c + 3) of four rows k_0..k_3; out[j] gets
// (k_0 .. k_3, c + j), the lowest k in the lowest byte (an mma operand word)
__device__ __forceinline__ void transpose4(const unsigned (&r)[4], unsigned (&out)[4]) {
  const unsigned lo01 = __byte_perm(r[0], r[1], 0x5140), hi01 = __byte_perm(r[0], r[1], 0x7362);
  const unsigned lo23 = __byte_perm(r[2], r[3], 0x5140), hi23 = __byte_perm(r[2], r[3], 0x7362);
  out[0] = __byte_perm(lo01, lo23, 0x5410);
  out[1] = __byte_perm(lo01, lo23, 0x7632);
  out[2] = __byte_perm(hi01, hi23, 0x5410);
  out[3] = __byte_perm(hi01, hi23, 0x7632);
}

__device__ __forceinline__ unsigned bytes4(const unsigned char* p) {
  return (unsigned)p[0] | ((unsigned)p[1] << 8) | ((unsigned)p[2] << 16) |
         ((unsigned)p[3] << 24);
}

// qconfig.quantize_int8 at scale rs: clamp(rint(x / rs), -128, 127) with the
// IEEE quotient Q = RN(x / rs), four values packed into one word.  rcp =
// RN(1 / rs).  q0 = RN(x * rcp) lies within 1.5 ulp of x / rs and Q within
// half an ulp, so |Q - q0| < 2^-22 |q0|: unless a half-integer lies within
// 2^-20 |q0| of q0, Q and q0 round to the same integer (no tie, same side of
// every half-integer), and only then is the division itself computed.
__device__ __forceinline__ unsigned quantize4(float4 v, float rs, float rcp) {
  const float f[4] = {v.x, v.y, v.z, v.w};
  unsigned word = 0u;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float q = f[e] * rcp;
    const float half = floorf(q) + 0.5f;
    if (fabsf(q - half) <= fabsf(q) * 0x1p-20f) q = f[e] / rs;
    q = fminf(fmaxf(rintf(q), -128.f), 127.f);
    word |= (unsigned)(unsigned char)(signed char)(int)q << (8 * e);
  }
  return word;
}

// Copy global bytes [start, start + len) into shared `dst` (16-byte aligned)
// by 16-byte cp.async from start's 16-byte-aligned floor (a partial last
// chunk zero-filled); returns start's offset in dst.  A floor below a tensor's
// first byte stays inside its allocation, which is 256-byte aligned.
__device__ __forceinline__ int copy_flat(unsigned char* dst, uintptr_t start, size_t len) {
  const uintptr_t lo = start & ~(uintptr_t)15, end = start + len;
  const int chunks = (int)((end - lo + 15) >> 4);
  for (int c = threadIdx.x; c < chunks; c += THREADS) {
    const uintptr_t src = lo + 16 * (uintptr_t)c;
    cp_async16(smem_u32(dst + 16 * c), reinterpret_cast<const void*>(src),
               end - src < 16 ? (int)(end - src) : 16);
  }
  return (int)(start - lo);
}

// DYN: the dynamic entry (fp32 x quantized in the kernel).  VEC: N % 4 == 0
// and w_q 4-byte aligned, so w's rows are read as words and y written as
// float4; else bytes and floats.
template <bool DYN, int ACT, bool VEC>
__global__ void __launch_bounds__(THREADS) quant_mlp_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float sc_s[BN], b_s[BN], rs_s[BM];
  const Plan& P = a.p;
  const int kp = P.kp, ldw = P.ldw, slices = P.slices;
  unsigned char* xs = smem;
  unsigned char* raw = smem + P.raw;
  unsigned char* ring = smem + P.ring;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // the mma fragments' row and column quad
  const int mt = warp & 1, c = warp >> 1;  // this warp's 16-row tile and column group
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int rows = min(BM, a.m - m0), ncols = min(BN, a.n - n0);
  const bool computes = GROUP * c < ncols;
  phase_mark(0);

  // group 0: the tail's vectors (zero past the block's columns) and x: the
  // int8 rows, or the first batch of fp32 rows
  if (tid < BN) {
    const bool in = tid < ncols;
    cp_async4(smem_u32(sc_s + tid), in ? a.scale + n0 + tid : a.scale, in ? 4 : 0);
    cp_async4(smem_u32(b_s + tid), in ? a.b + n0 + tid : a.b, in ? 4 : 0);
  } else if (!DYN && tid < BN + BM && a.row_scale != nullptr) {
    const int r = tid - BN;
    cp_async4(smem_u32(rs_s + r), a.row_scale + m0 + (r < rows ? r : 0), r < rows ? 4 : 0);
  }
  const size_t row_bytes = DYN ? 4 * (size_t)a.k : (size_t)a.k;
  int xoff = copy_flat(raw, reinterpret_cast<uintptr_t>(a.x) + m0 * row_bytes,
                       min(rows, P.batch) * row_bytes);
  cp_async_commit();

  // w slice s (KS rows) lands at slice_at(s).  One column block: the bytes of
  // its rows from their 16-byte-aligned floor, woff bytes before the first
  // (KS * N is a multiple of 16).  Several (N > BN): the block's BN columns of
  // each row by plain byte loads.
  const bool flat = gridDim.y == 1;
  const int woff = flat ? (int)(reinterpret_cast<uintptr_t>(a.w) & 15) : 0;
  auto slice_at = [&](int s) {
    return ring + (P.resident ? s * KS * ldw : (s % MAX_STAGES) * P.wstage);
  };
  auto load_w = [&](int s0, int s1) {  // slices s0 .. s1 - 1 (one slice in the ring)
    const int k0 = s0 * KS, kn = min(s1 * KS, a.k) - k0;
    if (flat) {
      copy_flat(slice_at(s0), reinterpret_cast<uintptr_t>(a.w) + (size_t)k0 * a.n,
                (size_t)kn * a.n);
    } else {
      for (int i = tid; i < kn * BN; i += THREADS) {
        const int r = i / BN, col = i % BN;
        slice_at(s0 + r / KS)[(r % KS) * BN + col] =
            col < ncols ? (unsigned char)a.w[(size_t)(k0 + r) * a.n + n0 + col] : 0;
      }
    }
  };
  // then w: whole in group 1, or the ring's first MAX_STAGES - 1 slices
  const int depth = P.resident ? 1 : min(slices, MAX_STAGES - 1);
  if (P.resident) {
    load_w(0, slices);
    cp_async_commit();
  } else {
    for (int s = 0; s < depth; ++s) {
      load_w(s, s + 1);
      cp_async_commit();
    }
  }

  phase_mark(1);
  const bool direct = !DYN && slices == 1;  // the int8 entry's A from the raw rows
  if (DYN) {
    // batches of P.batch fp32 rows: thread (r, part) of `lanes` threads a
    // row reduces max|x| over its row's k = part, part + lanes, ..., then
    // quantizes words part, part + lanes, ... into the tile
    // (8 a row where K <= 32, so that half the warps sit this pass out)
    const int lanes = P.batch < BM ? (THREADS / P.batch < 32 ? THREADS / P.batch : 32)
                                   : (slices > 1 ? 16 : 8);
    const int r = tid / lanes, part = tid % lanes;
    const int k4 = (a.k + 3) / 4, kw = slices * KS / 4;  // words of x, of a tile row
    for (int b0 = 0; b0 < rows; b0 += P.batch) {
      if (b0 > 0) {
        __syncthreads();  // the previous batch is quantized
        xoff = copy_flat(raw, reinterpret_cast<uintptr_t>(a.x) + (m0 + b0) * row_bytes,
                         min(rows - b0, P.batch) * row_bytes);
        cp_async_commit();
      }
      cp_async_wait_pending(b0 > 0 ? 0 : depth);
      __syncthreads();
      if (r < P.batch) {  // whole warps
        const float* xr = reinterpret_cast<const float*>(raw + xoff) + (size_t)r * a.k;
        const bool live = b0 + r < rows;
        float mx = 0.f;
        if (live) {
#pragma unroll 4
          for (int k = part; k < a.k; k += lanes) mx = fmaxf(mx, fabsf(xr[k]));
        }
        for (int o = 1; o < lanes; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
        const float rs = fmaxf(mx, 1e-8f) / 127.0f, rcp = __frcp_rn(rs);
        if (part == 0 && live) rs_s[b0 + r] = rs;
        unsigned* row = reinterpret_cast<unsigned*>(xs + (b0 + r) * kp);
        for (int w = part; w < kw; w += lanes) {
          unsigned word = 0u;
          if (live && w < k4) {
            const int k = 4 * w;
            const float4 v = make_float4(xr[k], k + 1 < a.k ? xr[k + 1] : 0.f,
                                         k + 2 < a.k ? xr[k + 2] : 0.f,
                                         k + 3 < a.k ? xr[k + 3] : 0.f);
            word = quantize4(v, rs, rcp);
          }
          row[w] = word;
        }
      }
    }
  } else if (!direct) {
    // the int8 rows have landed (group 0 is older than w's): warps take rows,
    // lanes words
    cp_async_wait_pending(depth);
    __syncthreads();
    const unsigned char* rx = raw + xoff;
    const bool words = xoff % 4 == 0 && a.k % 4 == 0;
    const int kw = slices * KS / 4;
    for (int r = warp; r < BM; r += WARPS)
      for (int w = lane; w < kw; w += 32) {
        const int k = 4 * w;
        unsigned v = 0u;
        if (r < rows) {
          const unsigned char* p = rx + r * a.k + k;
          if (words) {
            if (k < a.k) v = *reinterpret_cast<const unsigned*>(p);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (k + e < a.k) v |= (unsigned)p[e] << (8 * e);
          }
        }
        reinterpret_cast<unsigned*>(xs + r * kp)[w] = v;
      }
  }

  phase_mark(2);
  int acc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0;
  // the A fragments: this lane's ldmatrix row of the tile (rows 0-7 / 8-15,
  // bytes 0-15 / 16-31); or, for the int8 entry at K <= 32, straight from
  // its raw rows g and g + 8, as words where rows start on words.
  // B: the first byte of this lane's words (row 4t of a slice, column 4g of
  // the group).
  const unsigned a_row = smem_u32(xs) +
                         (16 * mt + (lane & 7) + ((lane >> 3) & 1) * 8) * kp + (lane >> 4) * 16;
  const unsigned char* xrow = raw + xoff + (16 * mt + g) * a.k + 4 * t;
  const bool xwords = xoff % 4 == 0 && a.k % 4 == 0;
  const int b_off = woff + 4 * t * ldw + GROUP * c + 4 * g;
  // the fragments of slice s: B as rows 4t + i (+ 16) of 4 bytes, transposed
  // in registers
  auto fragments = [&](int s, unsigned (&af)[4], unsigned (&bf)[2][4]) {
    if (!direct) {
      ldmatrix_x4(af, a_row + s * KS);
    } else {
      // af[q] holds row g + 8 (q & 1), k = 32s + 16 (q >> 1) + 4t .. + 3;
      // zero past K
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = KS * s + 16 * (q >> 1) + 4 * t;
        const unsigned char* p = xrow + 8 * (q & 1) * a.k + KS * s + 16 * (q >> 1);
        if (xwords) {
          af[q] = k < a.k ? *reinterpret_cast<const unsigned*>(p) : 0u;
        } else {
          unsigned v = 0u;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k + e < a.k) v |= (unsigned)p[e] << (8 * e);
          af[q] = v;
        }
      }
    }
    const unsigned char* p = slice_at(s) + b_off;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      unsigned r4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned char* pi = p + (16 * q + i) * ldw;
        r4[i] = VEC ? *reinterpret_cast<const unsigned*>(pi) : bytes4(pi);
      }
      transpose4(r4, bf[q]);
    }
  };
  if (P.resident) {
    cp_async_wait_pending(0);
    __syncthreads();  // w, the tile and the vectors are in place
    phase_mark(3);
    if (computes && slices > 0) {
      // slice s + 1's fragments load while slice s's products run
      unsigned af[4], bf[2][4];
      fragments(0, af, bf);
      for (int s = 0; s < slices; ++s) {
        unsigned an[4], bn[2][4];
        if (s + 1 < slices) fragments(s + 1, an, bn);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[nt], af, bf[0][nt], bf[1][nt]);
#pragma unroll
        for (int i = 0; i < 4; ++i) af[i] = an[i], bf[0][i] = bn[0][i], bf[1][i] = bn[1][i];
      }
    }
  } else {
    phase_mark(3);
    for (int s = 0; s < slices; ++s) {
      // slice s has landed when at most (issued - s - 1) groups are pending
      cp_async_wait_pending(min(slices, MAX_STAGES - 1 + s) - s - 1);
      __syncthreads();  // and every thread is done with the stage refilled next
      if (s + MAX_STAGES - 1 < slices) {
        load_w(s + MAX_STAGES - 1, s + MAX_STAGES);
        cp_async_commit();
      }
      if (computes) {
        unsigned af[4], bf[2][4];
        fragments(s, af, bf);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(acc[nt], af, bf[0][nt], bf[1][nt]);
      }
    }
    __syncthreads();  // (K = 0: the vectors)
  }
  phase_mark(4);
  if (!computes) return;

  // acc[nt][2h + i] is row 16 mt + g + 8h, column 32c + 8t + 4i + nt
  float rsv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    rsv[h] = (DYN || a.row_scale != nullptr) ? rs_s[16 * mt + g + 8 * h] : 1.f;
  float v[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = GROUP * c + 8 * t + 4 * i;
    const float4 s4 = *reinterpret_cast<const float4*>(sc_s + n);
    const float4 b4 = *reinterpret_cast<const float4*>(b_s + n);
    const float sv[4] = {s4.x, s4.y, s4.z, s4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[h][i][e] = activate<ACT>(__fadd_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[e][2 * h + i]), sv[e]), rsv[h]), bv[e]));
  }
  if constexpr (VEC) {
    // through this warp's 16 x 32 tile: a store writes 4 rows of 128 bytes
    float* tile = reinterpret_cast<float*>(smem + P.out) + warp * 16 * OUT_PITCH;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float4*>(tile + (g + 8 * h) * OUT_PITCH + 8 * t + 4 * i) =
            make_float4(v[h][i][0], v[h][i][1], v[h][i][2], v[h][i][3]);
    __syncwarp();
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int rr = 4 * it + (lane >> 3), cc = 4 * (lane & 7);
      const int r = 16 * mt + rr, n = GROUP * c + cc;
      if (r < rows && n < ncols)
        *reinterpret_cast<float4*>(a.y + (size_t)(m0 + r) * a.n + n0 + n) =
            *reinterpret_cast<const float4*>(tile + rr * OUT_PITCH + cc);
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * mt + g + 8 * h;
      if (r >= rows) continue;
      float* yr = a.y + (size_t)(m0 + r) * a.n + n0;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = GROUP * c + 8 * t + 4 * i + e;
          if (n < ncols) yr[n] = v[h][i][e];
        }
    }
  }
  phase_mark(5);
}

// Largest dynamic shared memory opted into so far, per instance and device:
// the opt-in (cudaFuncSetAttribute) is made only when a launch needs more.
constexpr int MAX_DEVICES = 64;
long long smem_opted[12][MAX_DEVICES] = {};

template <bool DYN, int ACT, bool VEC>
int launch_as(const Args& a, dim3 grid, int dev, cudaStream_t stream) {
  long long& opted = smem_opted[(DYN * 3 + ACT) * 2 + VEC][dev];
  if (a.p.total > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        quant_mlp_kernel<DYN, ACT, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)a.p.total);
    if (err != cudaSuccess) return (int)err;
    opted = a.p.total;
  }
  quant_mlp_kernel<DYN, ACT, VEC><<<grid, THREADS, (size_t)a.p.total, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool DYN, int ACT>
int launch_act(const Args& a, dim3 grid, int dev, cudaStream_t stream) {
  const bool vec = a.n % 4 == 0 && reinterpret_cast<uintptr_t>(a.w) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a.y) % 16 == 0;
  return vec ? launch_as<DYN, ACT, true>(a, grid, dev, stream)
             : launch_as<DYN, ACT, false>(a, grid, dev, stream);
}

template <bool DYN>
int launch(Args a, int act, cudaStream_t stream) {
  if (a.m <= 0 || a.n <= 0) return (int)cudaSuccess;
  if (a.k < 0 || act < ACT_NONE || act > ACT_GELU) return (int)cudaErrorInvalidValue;
  a.p = plan(a.k, a.n, DYN);
  const long long col_blocks = ((long long)a.n + BN - 1) / BN;
  if (a.p.total + VEC_SMEM > MAX_SMEM || col_blocks > 65535) return (int)cudaErrorInvalidValue;
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  const dim3 grid((unsigned)(((long long)a.m + BM - 1) / BM), (unsigned)col_blocks);
  if (act == ACT_RELU) return launch_act<DYN, ACT_RELU>(a, grid, dev, stream);
  if (act == ACT_GELU) return launch_act<DYN, ACT_GELU>(a, grid, dev, stream);
  return launch_act<DYN, ACT_NONE>(a, grid, dev, stream);
}

}  // namespace

// Plain C entry points (loaded through ctypes).  Each launches on `stream`,
// does not synchronise, and returns the launch's cudaError_t (0 on success;
// cudaErrorInvalidValue where K or N pass one block's shared memory).
//
// x (M, K) int8 -> y (M, N) f32.  `row_scale` (M, 1) may be null (all rows
// scale 1).
extern "C" int quant_mlp_i8(const signed char* x, const signed char* w,
                            const float* scale, const float* row_scale,
                            const float* b, float* y, int m, int k, int n,
                            int act, cudaStream_t stream) {
  return launch<false>(Args{x, w, scale, row_scale, b, y, m, k, n, Plan{}}, act, stream);
}

// x (M, K) f32, quantized per row in the kernel (qconfig's int8-dynamic
// recipe) -> y = act(((acc * w_scale) * rs) + b) (M, N) f32.
extern "C" int quant_mlp_dyn_f32(const float* x, const signed char* w,
                                 const float* w_scale, const float* b, float* y,
                                 int m, int k, int n, int act, cudaStream_t stream) {
  return launch<true>(Args{x, w, w_scale, nullptr, b, y, m, k, n, Plan{}}, act, stream);
}

#ifdef QUANT_MLP_PHASES
// The phase marks of the last launches (MARK_BLOCKS x 8 nanosecond stamps).
extern "C" int quant_mlp_read_marks(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, phase_marks, sizeof(phase_marks));
}
#endif
