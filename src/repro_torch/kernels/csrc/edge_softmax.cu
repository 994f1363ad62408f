// edge_softmax.cu — GAT's per-destination, per-head softmax over the plan, fp32.
//
// Replaces: src/repro/kernels/edge_softmax.py:edge_softmax, which on the TPU
// is two passes of the Pallas segment_reduce_sorted kernel (max, then the
// sum of shifted exponentials) plus an elementwise tail:
//
//     w[e, h] = exp(l[e, h] - max_seg l) / max(sum_seg exp(l - max_seg l), 1e-30)
//
// with 0 for every padding edge (rows offsets[N] .. E_pad - 1).
//
// Bound on the H100: the real edges' (E, H) logits are read once and the
// whole (E_pad, H) output written once.  GAT's packed batch (5968 real of
// 12288 edge rows, H = 4) moves ~0.3 MB: ~0.1 us at 3.35 TB/s, against a few
// hundred thousand fp32 operations (~0.005 us).  What a launch of that size
// costs is scheduling its blocks and a chain of dependent loads (offsets,
// then logits, then the store); `csrc/latency_probe.cu` measures that floor.
//
// Design, for many segments of 0-10 edges: one thread owns one
// (destination, head) pair, head the fastest index, so the H threads of a
// destination read each edge row's H contiguous logits together.  A thread
// whose segment has at most THREAD_EDGES edges issues all its loads before
// it uses one (an unrolled register array), takes the max, the exponentials
// and their sum in edge order, and writes exp(l - max) / sum from registers:
// each logit is read once; every loop stops at the segment's end, so a warp
// runs as many rounds as its longest segment.  Longer segments (a hub) go on
// a list in shared memory that the block's warps share out once the short
// ones are done: a warp serves one (destination, head) at a time with lanes
// along the edges and shuffle butterflies; up to WARP_EDGES edges stay in
// registers (read once), a longer segment is read in three passes (max, sum,
// write) with UNROLL loads in flight a lane.  A segment's max that is not finite is taken as 0, as
// in the plain version.  No two threads share an output element: no atomics,
// and the same inputs give the same bits.  Padding rows are never read; the
// output comes from torch.empty, so a short range of blocks at the end of
// the same grid writes them 0 (float4 stores on the aligned middle).  expf
// is the accurate libdevice exp (no --use_fast_math), as the plain version's
// exp is.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int THREAD_EDGES = 16;  // a thread serves a segment of up to this many edges
constexpr int LANE_EDGES = 16;    // a lane holds this many of a long segment's edges
constexpr int WARP_EDGES = 32 * LANE_EDGES;
constexpr int UNROLL = 4;         // loads in flight a lane on the three-pass walk
constexpr int PAD_BLOCKS = 32;    // most blocks that zero the padding rows
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
  for (int s = 16; s > 0; s >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, s));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(FULL, v, s);
  return v;
}

// The whole warp's softmax of one segment longer than THREAD_EDGES, lanes
// along the edges; every lane of the warp calls it with the same arguments.
__device__ __forceinline__ void warp_segment(const float* __restrict__ logits, float* __restrict__ out,
                                             int e0, int e1, int head, int h, int lane) {
  const int deg = e1 - e0;
  if (deg <= WARP_EDGES) {
    // the unrolled loops stop after the ceil(deg / 32) rounds the segment
    // needs (deg is the same on every lane): a warp's time is its longest
    // dependent chain, and the launch's time its slowest warp
    float v[LANE_EDGES];
#pragma unroll
    for (int i = 0; i < LANE_EDGES; ++i) {
      if (32 * i >= deg) break;
      const int e = e0 + lane + 32 * i;
      v[i] = e < e1 ? logits[(size_t)e * h + head] : -INFINITY;
    }
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < LANE_EDGES; ++i) {
      if (32 * i >= deg) break;
      m = fmaxf(m, v[i]);
    }
    m = warp_max(m);
    if (!isfinite(m)) m = 0.f;
    float z = 0.f;
#pragma unroll
    for (int i = 0; i < LANE_EDGES; ++i) {
      if (32 * i >= deg) break;
      v[i] = e0 + lane + 32 * i < e1 ? expf(v[i] - m) : 0.f;
      z += v[i];
    }
    const float denom = fmaxf(warp_sum(z), 1e-30f);
#pragma unroll
    for (int i = 0; i < LANE_EDGES; ++i) {
      if (32 * i >= deg) break;
      const int e = e0 + lane + 32 * i;
      if (e < e1) out[(size_t)e * h + head] = v[i] / denom;
    }
    return;
  }
  // longer: three passes (max, sum, write), UNROLL loads in flight a lane
  float m = -INFINITY;
  for (int e = e0 + lane; e < e1; e += 32 * UNROLL) {
    float x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      x[u] = e + 32 * u < e1 ? logits[(size_t)(e + 32 * u) * h + head] : -INFINITY;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) m = fmaxf(m, x[u]);
  }
  m = warp_max(m);
  if (!isfinite(m)) m = 0.f;
  float z = 0.f;
  for (int e = e0 + lane; e < e1; e += 32 * UNROLL) {
    float x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      x[u] = e + 32 * u < e1 ? logits[(size_t)(e + 32 * u) * h + head] : -INFINITY;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (e + 32 * u < e1) z += expf(x[u] - m);
    }
  }
  const float denom = fmaxf(warp_sum(z), 1e-30f);
  for (int e = e0 + lane; e < e1; e += 32 * UNROLL) {
    float x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      x[u] = e + 32 * u < e1 ? logits[(size_t)(e + 32 * u) * h + head] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (e + 32 * u < e1) out[(size_t)(e + 32 * u) * h + head] = expf(x[u] - m) / denom;
    }
  }
}

// Padding rows offsets[N] * H .. E_pad * H are written 0 by the last
// `pad_blocks` blocks: scalar stores up to a 16-byte boundary, float4 stores
// on the middle, scalar stores on the tail (`out` is 16-byte aligned).
__device__ __forceinline__ void zero_padding(const int* __restrict__ offsets, float* __restrict__ out,
                                             int n, int h, int e_pad, int block, int pad_blocks) {
  const long long p0 = (long long)offsets[n] * h, p1 = (long long)e_pad * h;
  if (p0 >= p1) return;
  const long long up = (p0 + 3) & ~3LL, down = p1 & ~3LL;
  const long long a0 = up < p1 ? up : p1;
  const long long a1 = down > a0 ? down : a0;
  const long long tid = (long long)block * THREADS + threadIdx.x;
  if (tid < a0 - p0) out[p0 + tid] = 0.f;
  if (tid < p1 - a1) out[a1 + tid] = 0.f;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long i = a0 / 4 + tid; i < a1 / 4; i += (long long)pad_blocks * THREADS) {
    reinterpret_cast<float4*>(out)[i] = zero;
  }
}

__global__ void __launch_bounds__(THREADS) edge_softmax_kernel(
    const int* __restrict__ offsets, const float* __restrict__ logits,
    float* __restrict__ out, int n, int h, int e_pad, int main_blocks, int pad_blocks) {
  if ((int)blockIdx.x >= main_blocks) {  // uniform across the block
    zero_padding(offsets, out, n, h, e_pad, (int)blockIdx.x - main_blocks, pad_blocks);
    return;
  }
  // segments longer than a thread holds go on the block's list, which its
  // warps share out after the short ones
  __shared__ int2 long_range[THREADS];
  __shared__ int long_head[THREADS];
  __shared__ int long_count;
  if (threadIdx.x == 0) long_count = 0;
  const int t = (int)blockIdx.x * THREADS + (int)threadIdx.x;  // N * H < INT_MAX
  int e0 = 0, e1 = 0, head = 0;
  if (t < n * h) {
    const int d = t / h;
    head = t % h;
    e0 = offsets[d];
    e1 = offsets[d + 1];
  }
  const int deg = e1 - e0;
  __syncthreads();
  if (deg > THREAD_EDGES) {
    const int k = atomicAdd(&long_count, 1);
    long_range[k] = make_int2(e0, e1);
    long_head[k] = head;
  }
  __syncthreads();
  if (deg <= THREAD_EDGES) {
    // every loop stops at the segment's end: all loads issue before the
    // first use, and a warp runs as many rounds as its longest segment
    float v[THREAD_EDGES];
#pragma unroll
    for (int i = 0; i < THREAD_EDGES; ++i) {
      if (i >= deg) break;
      v[i] = logits[(size_t)(e0 + i) * h + head];
    }
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < THREAD_EDGES; ++i) {
      if (i >= deg) break;
      m = fmaxf(m, v[i]);
    }
    if (!isfinite(m)) m = 0.f;
    float z = 0.f;
#pragma unroll
    for (int i = 0; i < THREAD_EDGES; ++i) {
      if (i >= deg) break;
      v[i] = expf(v[i] - m);
      z += v[i];
    }
    const float denom = fmaxf(z, 1e-30f);
#pragma unroll
    for (int i = 0; i < THREAD_EDGES; ++i) {
      if (i >= deg) break;
      out[(size_t)(e0 + i) * h + head] = v[i] / denom;
    }
  }
  // the long segments: warp w serves entries w, w + WARPS, ... of the list
  // (which warp serves one does not change its result)
  const int lane = threadIdx.x % 32;
  for (int k = threadIdx.x / 32; k < long_count; k += WARPS) {
    warp_segment(logits, out, long_range[k].x, long_range[k].y, long_head[k], h, lane);
  }
}

// The grid: ceil(N * H / THREADS) blocks of (destination, head) threads,
// then ceil(E_pad * H / (4 * THREADS)) blocks, at most PAD_BLOCKS and at
// least 1, that zero the padding rows.
void grid(int n, int h, int e_pad, long long* main_blocks, long long* pad_blocks) {
  *main_blocks = ((long long)n * h + THREADS - 1) / THREADS;
  const long long pad = ((long long)e_pad * h + 4 * THREADS - 1) / (4 * THREADS);
  *pad_blocks = pad < 1 ? 1 : (pad > PAD_BLOCKS ? PAD_BLOCKS : pad);
}

}  // namespace

// Plain C entry points (loaded through ctypes).  logits (E_pad, H) in plan
// order, offsets (N + 1,), out (E_pad, H), 16-byte aligned.  Launches on
// `stream`, does not synchronise, and returns the launch's cudaError_t (0 on
// success).
extern "C" int edge_softmax_f32(const int* offsets, const float* logits,
                                float* out, int n, int h, int e_pad,
                                cudaStream_t stream) {
  if (e_pad <= 0 || h <= 0) return (int)cudaSuccess;
  if (n < 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  long long main_blocks, pad_blocks;
  grid(n, h, e_pad, &main_blocks, &pad_blocks);
  // the kernel indexes its (destination, head) threads in 32-bit ints
  if (main_blocks * THREADS > INT_MAX) return (int)cudaErrorInvalidValue;
  edge_softmax_kernel<<<(unsigned)(main_blocks + pad_blocks), THREADS, 0, stream>>>(
      offsets, logits, out, n, h, e_pad, (int)main_blocks, (int)pad_blocks);
  return (int)cudaGetLastError();
}

// The launch's blocks, and in *group the threads a destination takes (H):
// the shape `csrc/latency_probe.cu` is timed at.
extern "C" long long edge_softmax_blocks(int n, int h, int e_pad, int* group) {
  long long main_blocks, pad_blocks;
  grid(n, h, e_pad, &main_blocks, &pad_blocks);
  *group = h;
  return main_blocks + pad_blocks;
}
