// The ICI ingest tier's fan-out kernels for NVIDIA Hopper (sm_90a).  Plain C
// interface, loaded from Python with ctypes (ddl_tpu_torch/ops/ici_fanout.py
// builds and binds it).
//
// Replace the Pallas TPU kernels of ddl_tpu/ops/ici_fanout.py:
//   K7 ddl_fanout_replicate <- _bcast_kernel   (chunk-pipelined ring
//                              broadcast: the source's (rows, cols) block
//                              lands on every ring position)
//   K8 ddl_fanout_shard     <- _scatter_kernel (ring scatter: row-block i of
//                              the source lands on ring position i)
//
// What they keep of the TPU kernels is the landed bytes, not the ring.  The
// clamped repeat sends, the sink chunk, the parity DMA semaphores, the
// (2, block) VMEM ping-pong and the farthest-first order exist for ICI DMA
// rings and for the Pallas interpreter.  Here every ring position is a
// region of one card, so one launch copies straight from the anchor tensor
// into the positions' tensors:
// - Addressing.  Up to MAX_RING source and destination pointers travel by
//   value in one __grid_constant__ parameter struct, as K9's do.  The one
//   kernel body serves both: blockIdx.y selects a group, which copies its
//   source src[g] to its `per` destinations dst[g * per .. (g + 1) * per).
//   K7 is one group with the n - 1 positions other than the source as its
//   destinations (the source position keeps the anchor tensor itself, zero
//   copy); K8 is n groups of one destination, group i's source the anchor's
//   row-block i.
// - Byte-exact whatever the dtype, with the widest access all ends allow
//   (copy.cuh's copy_any).  K7 loads each vector of the source once and
//   stores it to every destination.
// - No landing buffers: the Pallas kernels need one per non-source device
//   only because shard_map wants an equal-shaped input block everywhere.
//
// What bounds them on this card: bytes.  K8 reads the window once and writes
// it once (64 MiB each way at the path's geometry: 0.0401 ms at 3.35 TB/s);
// K7 reads it once and writes it n - 1 times (n = 4: 64 MiB in, 192 MiB out,
// 0.0801 ms).  The grid covers the SMs with up to MAX_CHUNKS blocks per
// group.  Ring relaying over NVLink with flag semaphores belongs to a ring of
// several cards.

#include <cuda_runtime.h>
#include <stdint.h>

#include "copy.cuh"

namespace {

constexpr int MAX_RING = 64;      // ring positions a launch can address
constexpr int MAX_CHUNKS = 1024;  // blocks per group

struct FanoutArgs {
  const unsigned char* src[MAX_RING];  // source of group g
  unsigned char* dst[MAX_RING];        // destinations, `per` per group
  long long bytes;                     // bytes each destination receives
  int per;                             // destinations per group
};

__global__ void __launch_bounds__(ddl::COPY_THREADS)
    fanout_kernel(const __grid_constant__ FanoutArgs a) {
  const int g = blockIdx.y;
  ddl::copy_any(a.src[g], a.dst + g * a.per, a.per, a.bytes);
}

int launch(const FanoutArgs& a, int groups, void* stream) {
  const dim3 grid((unsigned)ddl::copy_chunks(a.bytes, MAX_CHUNKS),
                  (unsigned)groups);
  fanout_kernel<<<grid, ddl::COPY_THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// K7 on `stream`: `bytes` from src to each of the n_dst device pointers in
// dst (a host array).  Returns 0, -1 for arguments the kernel does not take,
// or the CUDA error of the launch.
extern "C" int ddl_fanout_replicate(const void* src, void* const* dst,
                                    int n_dst, long long bytes,
                                    void* stream) {
  if (n_dst < 1 || n_dst > MAX_RING || bytes < 0) return -1;
  FanoutArgs a = {};
  a.src[0] = static_cast<const unsigned char*>(src);
  for (int i = 0; i < n_dst; ++i) a.dst[i] = static_cast<unsigned char*>(dst[i]);
  a.bytes = bytes;
  a.per = n_dst;
  return launch(a, 1, stream);
}

// K8 on `stream`: row-block i of src (block_bytes from src + i * block_bytes)
// to the device pointer dst[i], for i < n.  Returns as ddl_fanout_replicate.
extern "C" int ddl_fanout_shard(const void* src, void* const* dst, int n,
                                long long block_bytes, void* stream) {
  if (n < 1 || n > MAX_RING || block_bytes < 0) return -1;
  FanoutArgs a = {};
  for (int i = 0; i < n; ++i) {
    a.src[i] = static_cast<const unsigned char*>(src) + (long long)i * block_bytes;
    a.dst[i] = static_cast<unsigned char*>(dst[i]);
  }
  a.bytes = block_bytes;
  a.per = 1;
  return launch(a, n, stream);
}
