// Byte-exact device copies shared by the port's data-movement kernels for
// NVIDIA Hopper (sm_90a): the exchange kernel K9 (device_shuffle.cu) and the
// fan-out kernels K7 and K8 (ici_fanout.cu).
//
// copy_any(s, d, nd, n) copies n bytes from s to each of the nd destinations
// d[0..nd), over the blocks of gridDim.x (the caller's grid runs its other
// dimensions over independent copies).  It takes the widest access that the
// source and every destination allow: 16-byte vectors when all of them agree
// in their address mod 16 (after a byte head up to the boundary), else 4-byte
// words when they agree mod 4, else bytes; a byte tail finishes the copy.
// Each vector is loaded once and stored to every destination, so a copy to
// nd destinations reads its source once.
//
// What bounds them: bytes.  They do no arithmetic; the design answers that
// with coalesced 16-byte accesses, COPY_UNROLL loads in flight per thread
// before its stores, and grids sized to cover the 132 SMs.

#pragma once

#include <stdint.h>

namespace ddl {

constexpr int COPY_THREADS = 256;  // threads per block
constexpr int COPY_UNROLL = 4;     // accesses in flight per thread

// Grid-strided copy of nv elements of V from s to d[j] + off, j < nd.
template <typename V>
__device__ __forceinline__ void copy_body(const unsigned char* s,
                                          unsigned char* const* d,
                                          long long off, int nd,
                                          long long nv) {
  const V* sv = reinterpret_cast<const V*>(s);
  const long long step = (long long)gridDim.x * COPY_THREADS * COPY_UNROLL;
  for (long long base =
           (long long)blockIdx.x * COPY_THREADS * COPY_UNROLL + threadIdx.x;
       base < nv; base += step) {
    V r[COPY_UNROLL];
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u) {
      const long long v = base + (long long)u * COPY_THREADS;
      if (v < nv) r[u] = sv[v];
    }
    for (int j = 0; j < nd; ++j) {
      V* dv = reinterpret_cast<V*>(d[j] + off);
#pragma unroll
      for (int u = 0; u < COPY_UNROLL; ++u) {
        const long long v = base + (long long)u * COPY_THREADS;
        if (v < nv) dv[v] = r[u];
      }
    }
  }
}

// Copy n bytes from s to every d[j], where s and each d[j] agree in their
// address mod W: a byte head up to the first W-aligned source address,
// W-byte accesses, a byte tail.  Block 0 moves the head and the tail.
template <int W, typename V>
__device__ __forceinline__ void copy_fanout(const unsigned char* s,
                                            unsigned char* const* d, int nd,
                                            long long n) {
  long long head = (W - (long long)((uintptr_t)s & (W - 1))) & (W - 1);
  if (head > n) head = n;
  const long long nv = (n - head) / W;
  const long long tail = head + nv * W;
  if (blockIdx.x == 0) {
    for (int j = 0; j < nd; ++j) {
      for (long long b = threadIdx.x; b < head; b += COPY_THREADS)
        d[j][b] = s[b];
      for (long long b = tail + threadIdx.x; b < n; b += COPY_THREADS)
        d[j][b] = s[b];
    }
  }
  copy_body<V>(s + head, d, head, nd, nv);
}

__device__ __forceinline__ void copy_any(const unsigned char* s,
                                         unsigned char* const* d, int nd,
                                         long long n) {
  uintptr_t mis = 0;
  for (int j = 0; j < nd; ++j) mis |= (uintptr_t)s ^ (uintptr_t)d[j];
  if ((mis & 15) == 0) {
    copy_fanout<16, uint4>(s, d, nd, n);
  } else if ((mis & 3) == 0) {
    copy_fanout<4, unsigned int>(s, d, nd, n);
  } else {
    copy_fanout<1, unsigned char>(s, d, nd, n);
  }
}

// Blocks along gridDim.x for a copy of `bytes`: one per 16 KiB (a block's
// 16-byte accesses in one pass), at least 1, at most max_chunks.
inline long long copy_chunks(long long bytes, long long max_chunks) {
  const long long per_block = (long long)COPY_THREADS * COPY_UNROLL * 16;
  long long chunks = (bytes + per_block - 1) / per_block;
  if (chunks < 1) chunks = 1;
  if (chunks > max_chunks) chunks = max_chunks;
  return chunks;
}

}  // namespace ddl
