// latency_probe.cu — the least time a launch of a segment kernel's shape takes.
//
// Not a port of a TPU kernel: a yardstick for edge_softmax.cu and
// segment_reduce.cu.  Their inputs are a few hundred kilobytes, so their
// bytes over the memory rate (well under a microsecond) is not what a
// launch of theirs can reach: the launch schedules its blocks and each
// thread waits on a chain of dependent loads.  This kernel keeps only the
// first link of that chain: on the same grid (`blocks` blocks of 256
// threads, `group` threads a destination, as the kernel's `*_blocks` entry
// point gives them), each thread loads offsets[d] and offsets[d + 1] and
// writes one float, the degree of d.  chip_smoke.py's phase 8 times it
// beside each kernel as `floor_ms`.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) latency_probe_kernel(
    const int* __restrict__ offsets, float* __restrict__ out, int n, int group) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long d = t / group;
  const int dc = (int)(d < n ? d : n - 1);  // threads past the last destination read it too
  out[t] = (float)(offsets[dc + 1] - offsets[dc]);
}

}  // namespace

// offsets (N + 1,) with N >= 1, out (blocks * 256,).  Launches on `stream`,
// does not synchronise, and returns the launch's cudaError_t.
extern "C" int latency_probe_launch(const int* offsets, float* out, int n, int group,
                                    int blocks, cudaStream_t stream) {
  if (n < 1 || group < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  latency_probe_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(offsets, out, n, group);
  return (int)cudaGetLastError();
}
