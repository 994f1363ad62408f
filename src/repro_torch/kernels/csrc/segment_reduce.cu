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
// writes 1.0 MB: ~0.8 us at 3.35 TB/s against ~0.006 us of fp32 arithmetic.
// What a launch of that size costs is scheduling its blocks and the chain
// offsets -> values -> store; `csrc/latency_probe.cu` measures that floor.
//
// Design: the TPU kernel streams edge blocks past resident node blocks,
// reducing sums with a one-hot MXU matmul and extrema with a per-edge loop,
// carrying state across a sequential grid.  None of that carries over.  Here
// one thread owns one destination d and VEC consecutive features, VEC = 4
// (float4 loads and stores) where F is a multiple of 4 and every pointer is
// 16-byte aligned, 2 (float2) where F is even and they are 8-byte aligned,
// else 1: F / VEC neighbouring threads cover a row (F = 64: 16 threads, so a
// warp serves two destinations).  The thread walks offsets[d]..offsets[d+1]
// four edges at a time, loading the four rows before the first add, and adds
// in edge order, so the result is the sequential fp32 reduction of the
// segment whatever VEC is: deterministic, no atomics.  Edges past offsets[N]
// are padding and are never read.  sqsum keeps v * v rounded before the add
// (__fmul_rn / __fadd_rn), as the plain version does, so nvcc cannot
// contract it.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // edge rows loaded before the first add

enum { OP_SUM = 0, OP_MEAN = 1, OP_SQSUM = 2, OP_MAX = 3, OP_MIN = 4 };

template <int VEC>
struct alignas(4 * VEC) Vec {
  float v[VEC];
};

template <int OP>
__device__ __forceinline__ float step(float acc, float v) {
  if (OP == OP_SQSUM) return __fadd_rn(acc, __fmul_rn(v, v));
  if (OP == OP_MAX) return fmaxf(acc, v);
  if (OP == OP_MIN) return fminf(acc, v);
  return acc + v;
}

template <int OP, int VEC>
__device__ __forceinline__ void fold(Vec<VEC>& acc, const Vec<VEC>& x) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc.v[k] = step<OP>(acc.v[k], x.v[k]);
}

template <int OP, int VEC>
__global__ void __launch_bounds__(THREADS) segment_reduce_kernel(
    const int* __restrict__ offsets, const Vec<VEC>* __restrict__ values,
    Vec<VEC>* __restrict__ out, int n, int group) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= (long long)n * group) return;
  const int d = (int)(t / group), j = (int)(t % group);
  const int e0 = offsets[d], e1 = offsets[d + 1];
  const Vec<VEC>* col = values + j;  // row e's vector j is col[e * group]
  Vec<VEC> acc;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    acc.v[k] = OP == OP_MAX ? -INFINITY : (OP == OP_MIN ? INFINITY : 0.f);
  }
  int e = e0;
  for (; e + UNROLL <= e1; e += UNROLL) {
    Vec<VEC> x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) x[u] = col[(size_t)(e + u) * group];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) fold<OP>(acc, x[u]);
  }
  const int rest = e1 - e;  // 0 .. UNROLL - 1
  if (rest > 0) {
    Vec<VEC> x[UNROLL - 1];
#pragma unroll
    for (int u = 0; u < UNROLL - 1; ++u) {
      if (u < rest) x[u] = col[(size_t)(e + u) * group];
    }
#pragma unroll
    for (int u = 0; u < UNROLL - 1; ++u) {
      if (u < rest) fold<OP>(acc, x[u]);
    }
  }
  const int count = e1 - e0;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    if (OP == OP_MEAN) {
      acc.v[k] = acc.v[k] / fmaxf((float)count, 1.f);
    } else if ((OP == OP_MAX || OP == OP_MIN) && count == 0) {
      acc.v[k] = 0.f;
    }
  }
  out[(size_t)d * group + j] = acc;
}

template <int VEC>
cudaError_t launch(const int* offsets, const float* values, float* out, int n,
                   int group, int op, unsigned blocks, cudaStream_t stream) {
  const auto* v = reinterpret_cast<const Vec<VEC>*>(values);
  auto* o = reinterpret_cast<Vec<VEC>*>(out);
  switch (op) {
    case OP_SUM:
      segment_reduce_kernel<OP_SUM, VEC><<<blocks, THREADS, 0, stream>>>(offsets, v, o, n, group);
      break;
    case OP_MEAN:
      segment_reduce_kernel<OP_MEAN, VEC><<<blocks, THREADS, 0, stream>>>(offsets, v, o, n, group);
      break;
    case OP_SQSUM:
      segment_reduce_kernel<OP_SQSUM, VEC><<<blocks, THREADS, 0, stream>>>(offsets, v, o, n, group);
      break;
    case OP_MAX:
      segment_reduce_kernel<OP_MAX, VEC><<<blocks, THREADS, 0, stream>>>(offsets, v, o, n, group);
      break;
    default:
      segment_reduce_kernel<OP_MIN, VEC><<<blocks, THREADS, 0, stream>>>(offsets, v, o, n, group);
  }
  return cudaGetLastError();
}

}  // namespace

// The launch's blocks for N destinations of F features read VEC at a time,
// and in *group the threads a destination takes (F / VEC): the shape
// `csrc/latency_probe.cu` is timed at.
extern "C" long long segment_reduce_blocks(int n, int f, int vec, int* group) {
  *group = f / vec;
  return ((long long)n * *group + THREADS - 1) / THREADS;
}

// Plain C entry point (loaded through ctypes).  values (E, F) in plan order,
// offsets (N + 1,), out (N, F); vec is 4, 2 or 1, divides F, and both
// pointers are aligned to 4 * vec bytes.  Launches on `stream`, does not
// synchronise, and returns the launch's cudaError_t (0 on success).
extern "C" int segment_reduce_f32(const int* offsets, const float* values,
                                  float* out, int n, int f, int op, int vec,
                                  cudaStream_t stream) {
  if (n <= 0 || f <= 0) return (int)cudaSuccess;
  if (op < OP_SUM || op > OP_MIN) return (int)cudaErrorInvalidValue;
  if ((vec != 1 && vec != 2 && vec != 4) || f % vec != 0 ||
      reinterpret_cast<uintptr_t>(values) % (4 * vec) != 0 ||
      reinterpret_cast<uintptr_t>(out) % (4 * vec) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  int group;
  const long long blocks = segment_reduce_blocks(n, f, vec, &group);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (vec == 4) {
    err = launch<4>(offsets, values, out, n, group, op, (unsigned)blocks, stream);
  } else if (vec == 2) {
    err = launch<2>(offsets, values, out, n, group, op, (unsigned)blocks, stream);
  } else {
    err = launch<1>(offsets, values, out, n, group, op, (unsigned)blocks, stream);
  }
  return (int)err;
}
