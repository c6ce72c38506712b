// host_register.cu — page-lock a host mapping for DMA to the card.
//
// No kernel: three CUDA runtime calls behind a plain C interface, built by
// ops/_build.py like the kernels and loaded with ctypes
// (ddl_tpu_torch/ops/host_register.py).  The JAX package has no
// counterpart: there the PJRT client copies a host window to HBM itself.
// Here the consumer page-locks each shared-memory ring it attaches, once,
// with cudaHostRegister, so a non_blocking copy out of a slot is a DMA
// straight from the memory the producer process wrote (a copy from
// pageable memory would give the same bytes but block the host).
//
// The mapping is MAP_SHARED over /dev/shm (as NCCL registers its shm
// buffers); mmap gives a page-aligned base.  cudaHostRegisterPortable
// makes the registration visible to every CUDA context in the process,
// PyTorch's included: this library links its own (static) runtime.

#include <cstddef>
#include <cuda_runtime.h>

extern "C" {

// Page-lock [ptr, ptr + bytes).  Returns the cudaError_t (0 = success).
int ddl_host_register(void* ptr, size_t bytes, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaHostRegister(ptr, bytes, cudaHostRegisterPortable));
}

// Undo ddl_host_register.  Returns the cudaError_t.
int ddl_host_unregister(void* ptr) {
  return static_cast<int>(cudaHostUnregister(ptr));
}

// 1 when the CUDA runtime reports ptr as page-locked host memory
// (cudaMemoryTypeHost), 0 when it does not, -err on a failed query.
int ddl_host_is_registered(const void* ptr) {
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, ptr);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the sticky-free error state
    return -static_cast<int>(err);
  }
  return attr.type == cudaMemoryTypeHost ? 1 : 0;
}

const char* ddl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
