// segment_reduce.cu — sorted-segment reduction over the plan's CSR ranges, fp32.
//
// Replaces: src/repro/kernels/segment_reduce.py:segment_reduce_sorted (Pallas
// bodies _kernel_matmul and _kernel_extremum) together with the finalisation
// that src/repro/kernels/ops.py:segment_reduce wraps around it: mean's
// division by the segment's edge count, and 0 for the empty rows of max/min
// (the TPU kernel writes its +-1e30 fill there).  Ops: sum, mean, sqsum, max,
// min over (E, F) values already in plan order; every empty row comes out 0.
//
// Bound on the H100: each real edge's F values are read once and the (N, F)
// result written once, with one add (sqsum: a multiply too) per value read.
// GAT's weighted sum at N = 4096, 5968 real edges, F = 64 reads 1.5 MB and
// writes 1.0 MB: ~0.8 us at 3.35 TB/s against ~0.006 us of fp32 arithmetic,
// so the kernel is bytes-bound, and at serving sizes launch overhead
// dominates both.
//
// Design: the TPU kernel streams edge blocks past resident node blocks,
// reducing sums with a one-hot MXU matmul and extrema with a per-edge loop,
// carrying state across a sequential grid.  None of that carries over: here
// one warp owns one destination d and one 32-wide chunk of F, walks the CSR
// range offsets[d]..offsets[d+1] in sorted-edge order with lanes along F
// (each edge row is a coalesced load) and keeps its accumulator in a
// register.  No two warps share an output element, so there are no atomics
// and the result is deterministic.  Edges past offsets[N] are padding and
// are never read.  sqsum keeps v * v rounded before the add (__fmul_rn /
// __fadd_rn), as the plain version does, so nvcc cannot contract it.
#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

enum { OP_SUM = 0, OP_MEAN = 1, OP_SQSUM = 2, OP_MAX = 3, OP_MIN = 4 };

__global__ void __launch_bounds__(THREADS) segment_reduce_kernel(
    const int* __restrict__ offsets, const float* __restrict__ values,
    float* __restrict__ out, int n, int f, int chunks, int op) {
  const long long task = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (task >= (long long)n * chunks) return;
  const int d = (int)(task / chunks);
  const int j = (int)(task % chunks) * 32 + threadIdx.x % 32;
  if (j >= f) return;
  const int e0 = offsets[d], e1 = offsets[d + 1];
  float acc = op == OP_MAX ? -INFINITY : (op == OP_MIN ? INFINITY : 0.f);
  for (int e = e0; e < e1; ++e) {
    const float v = values[(size_t)e * f + j];
    if (op == OP_SQSUM) {
      acc = __fadd_rn(acc, __fmul_rn(v, v));
    } else if (op == OP_MAX) {
      acc = fmaxf(acc, v);
    } else if (op == OP_MIN) {
      acc = fminf(acc, v);
    } else {
      acc += v;
    }
  }
  const int count = e1 - e0;
  if (op == OP_MEAN) {
    acc = acc / fmaxf((float)count, 1.f);
  } else if ((op == OP_MAX || op == OP_MIN) && count == 0) {
    acc = 0.f;
  }
  out[(size_t)d * f + j] = acc;
}

}  // namespace

// Plain C entry point (loaded through ctypes).  values (E, F) in plan order,
// offsets (N + 1,), out (N, F).  Launches on `stream`, does not synchronise,
// and returns the launch's cudaError_t (0 on success).
extern "C" int segment_reduce_f32(const int* offsets, const float* values,
                                  float* out, int n, int f, int op,
                                  cudaStream_t stream) {
  if (n <= 0 || f <= 0) return (int)cudaSuccess;
  if (op < OP_SUM || op > OP_MIN) return (int)cudaErrorInvalidValue;
  const int chunks = (f + 31) / 32;
  const long long blocks = ((long long)n * chunks + WARPS - 1) / WARPS;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  segment_reduce_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      offsets, values, out, n, f, chunks, op);
  return (int)cudaGetLastError();
}
