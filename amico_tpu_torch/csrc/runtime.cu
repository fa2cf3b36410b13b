// Device queries the kernels' Python wrappers make before a launch.
#include <cuda_runtime.h>

extern "C" {

// largest dynamic shared memory a block may opt into on `device`
int cuda_max_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return v;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
