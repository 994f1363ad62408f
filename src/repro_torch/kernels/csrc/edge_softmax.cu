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
// hundred thousand fp32 operations (~0.005 us), so the kernel is bytes-bound
// and at serving sizes launch overhead dominates.
//
// Design: one kernel instead of two reductions and a tail.  One warp owns
// one (destination, head) pair and walks its CSR range
// offsets[d]..offsets[d+1] with lanes along the edges: pass 1 takes the
// lane-local maxima and combines them with a butterfly of shuffles, pass 2
// does the same for sum(exp(l - max)), pass 3 writes exp(l - max) / sum.  A
// segment's max that is not finite is taken as 0, as in the plain version.
// No two warps share an output element: no atomics.  Padding rows are never
// read, but the output comes from torch.empty, so a grid-stride tail loop
// writes them 0 (an all-padding edge list comes out all 0).  expf is the
// accurate libdevice exp (no --use_fast_math), as the plain version's exp is.
#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS) edge_softmax_kernel(
    const int* __restrict__ offsets, const float* __restrict__ logits,
    float* __restrict__ out, int n, int h, int e_pad) {
  const int lane = threadIdx.x % 32;
  const long long task = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (task < (long long)n * h) {  // uniform across the warp
    const int d = (int)(task / h), head = (int)(task % h);
    const int e0 = offsets[d], e1 = offsets[d + 1];
    float m = -INFINITY;
    for (int e = e0 + lane; e < e1; e += 32) m = fmaxf(m, logits[(size_t)e * h + head]);
    for (int s = 16; s > 0; s >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, s));
    if (!isfinite(m)) m = 0.f;
    float z = 0.f;
    for (int e = e0 + lane; e < e1; e += 32) z += expf(logits[(size_t)e * h + head] - m);
    for (int s = 16; s > 0; s >>= 1) z += __shfl_xor_sync(FULL, z, s);
    const float denom = fmaxf(z, 1e-30f);
    for (int e = e0 + lane; e < e1; e += 32) {
      const size_t at = (size_t)e * h + head;
      out[at] = expf(logits[at] - m) / denom;
    }
  }
  // padding rows offsets[N] .. E_pad - 1 are written 0
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)offsets[n] * h + (long long)blockIdx.x * THREADS + threadIdx.x;
       i < (long long)e_pad * h; i += stride) {
    out[i] = 0.f;
  }
}

}  // namespace

// Plain C entry point (loaded through ctypes).  logits (E_pad, H) in plan
// order, offsets (N + 1,), out (E_pad, H).  Launches on `stream`, does not
// synchronise, and returns the launch's cudaError_t (0 on success).
extern "C" int edge_softmax_f32(const int* offsets, const float* logits,
                                float* out, int n, int h, int e_pad,
                                cudaStream_t stream) {
  if (e_pad <= 0 || h <= 0) return (int)cudaSuccess;
  if (n < 0) return (int)cudaErrorInvalidValue;
  long long blocks = ((long long)n * h + WARPS - 1) / WARPS;
  if (blocks < 1) blocks = 1;  // the tail loop still zeroes the padding rows
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  edge_softmax_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      offsets, logits, out, n, h, e_pad);
  return (int)cudaGetLastError();
}
