// T1: the build-cache probe's kernel, o = x * 2 + 1 elementwise.
//
// Replaces the Pallas kernel of tools/loc_experiment.py (build_kernel().f,
// one (8, 128) f32 block in VMEM).  The probe's subject is the port's nvcc
// build cache (ops/cuda_build.py), so this kernel is built and loaded with
// the other sources, through that cache.
//
// Bound: memory (8 bytes a float, no reuse); at the probe's (8, 128) shape,
// the launch, whose time is on the host (the wrapper's ctypes path, timed
// piece by piece in PERF.md).  Design: a grid-stride loop over a contiguous
// f32 buffer of any size, so one launch covers any shape, with 16-byte
// accesses over the float4s when both buffers are 16-byte aligned and one
// float at a time over the tail (or everything, when they are not); 2x is
// exact in f32, so the contracted fma(x, 2, 1) rounds as the twin's
// x * 2.0 + 1.0 does and the two agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;   // 16 blocks on each H100 SM

__global__ void loc_probe_kernel(const float* __restrict__ x,
                                 float* __restrict__ o, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(o)) & 15)
          ? 0 : n / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(o);
  for (long long i = t; i < n4; i += stride) {
    float4 v = x4[i];
    v.x = v.x * 2.0f + 1.0f;
    v.y = v.y * 2.0f + 1.0f;
    v.z = v.z * 2.0f + 1.0f;
    v.w = v.w * 2.0f + 1.0f;
    o4[i] = v;
  }
  for (long long i = 4 * n4 + t; i < n; i += stride) o[i] = x[i] * 2.0f + 1.0f;
}

}  // namespace

extern "C" {

// o = x * 2 + 1 on n contiguous floats, on `stream`; returns the launch's
// cudaError_t (0 on success).
int loc_probe_launch(const float* x, float* o, long long n, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n / 4 + n % 4 + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  loc_probe_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(x, o,
                                                                       n);
  return (int)cudaGetLastError();
}

}  // extern "C"
