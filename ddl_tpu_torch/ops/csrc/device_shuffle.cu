// One global-shuffle exchange round for NVIDIA Hopper (sm_90a).  Plain C
// interface, loaded from Python with ctypes
// (ddl_tpu_torch/ops/device_shuffle.py builds and binds it).
//
// Replaces the Pallas TPU kernel of ddl_tpu/ops/device_shuffle.py:
//   K9 exchange_kernel  <- _exchange_kernel (two permutation-shaped remote
//                          copies per round)
//
// Ring position i holds one (2*half, cols) lane block.  Lane A (rows
// [0, half)) of position i lands at position route[0][i] = p[i], same rows;
// lane B (rows [half, 2*half)) lands at route[1][i] = pinv[i].  The output
// is a separate buffer, as out_ref is.  A lane is `half` whole rows of a
// row-major block, so each lane is one contiguous range of
// lane_bytes = half * row_bytes, and a round is 2n independent copies.
//
// What it keeps of the TPU kernel is the function, not the structure:
// - One launch per round.  The grid is (chunk of the lane, lane, source
//   position).  The TPU grid's two sequential lane steps and their parity
//   DMA semaphores double-buffer ICI sends; on one card the launch boundary
//   is the barrier.
// - Addressing.  n source and n destination base pointers and the (2, n)
//   int32 routes travel by value in one kernel-parameter struct, read in
//   place (__grid_constant__): n <= MAX_RING = 64, 1.5 KB of the 4 KB
//   parameter space.  The routes are data, never template parameters, so
//   one build serves every round and geometry, as scalar prefetch lets one
//   Pallas program serve every round.  Here every pointer points into one
//   allocation on one card; a multi-card ring passes peer-mapped pointers
//   to the same kernel.
// - Byte-exact whatever the dtype: lanes move as bytes (fp32 pools, int32
//   token rows, uint8 images, bf16 all alike).  Each (lane, position) copy
//   is copy.cuh's copy_any: the widest access both of its ends allow
//   (16-byte vectors, else 4-byte words, else bytes) and a byte tail.
//
// What bounds it on this card: bytes.  It does no arithmetic, and each byte
// is read once and written once, so the least time of a round is
// 2 * n * 2*half * row_bytes / 3.35 TB/s.  The design answers that with
// coalesced 16-byte accesses, COPY_UNROLL loads in flight per thread before its
// stores, and enough blocks (up to MAX_CHUNKS per lane copy) to cover the
// 132 SMs; the lane copies of one round are independent, so they all run
// in the one launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "copy.cuh"

namespace {

constexpr int MAX_RING = 64;     // ring positions a launch can address
constexpr int MAX_CHUNKS = 1024; // blocks per (lane, position) copy

struct ExchangeArgs {
  const unsigned char* src[MAX_RING];  // block base of ring position i
  unsigned char* dst[MAX_RING];        // output block base of position i
  int route[2][MAX_RING];              // [p, pinv]: lane t of i -> route[t][i]
  long long lane_bytes;                // half * row_bytes
};

__global__ void __launch_bounds__(ddl::COPY_THREADS)
    exchange_kernel(const __grid_constant__ ExchangeArgs a) {
  const int lane = blockIdx.y;
  const int pos = blockIdx.z;
  const long long off = (long long)lane * a.lane_bytes;
  const unsigned char* s = a.src[pos] + off;
  unsigned char* d = a.dst[a.route[lane][pos]] + off;
  ddl::copy_any(s, &d, 1, a.lane_bytes);
}

}  // namespace

// One exchange round on `stream`.  src/dst: host arrays of n device
// pointers (block bases); routes: host int32 array [p (n), pinv (n)].
// Returns 0, -1 for arguments the kernel does not take, or the CUDA error
// of the launch.
extern "C" int ddl_exchange_round(const void* const* src, void* const* dst,
                                  const int* routes, int n,
                                  long long lane_bytes, void* stream) {
  if (n < 1 || n > MAX_RING || lane_bytes < 0) return -1;
  ExchangeArgs a = {};
  for (int i = 0; i < n; ++i) {
    const int fwd = routes[i], bwd = routes[n + i];
    if (fwd < 0 || fwd >= n || bwd < 0 || bwd >= n) return -1;
    a.src[i] = static_cast<const unsigned char*>(src[i]);
    a.dst[i] = static_cast<unsigned char*>(dst[i]);
    a.route[0][i] = fwd;
    a.route[1][i] = bwd;
  }
  a.lane_bytes = lane_bytes;
  const dim3 grid((unsigned)ddl::copy_chunks(lane_bytes, MAX_CHUNKS), 2,
                  (unsigned)n);
  exchange_kernel<<<grid, ddl::COPY_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
