// Causal GQA flash attention, forward and backward, in fp32 for NVIDIA
// Hopper (sm_90a); bf16 inputs take the wgmma kernels of flash_fwd_sm90.cu
// and flash_bwd_sm90.cu.  Plain C interface, loaded from Python with ctypes
// (ddl_tpu_torch/ops/flash_attention.py builds and binds it).
//
// Replaces the Pallas TPU kernels of ddl_tpu/ops/flash_attention.py:
//   K1 flash_fwd_kernel    <- _fwd_kernel  (online-softmax forward, out + lse)
//   K2 flash_dq_kernel     <- _dq_kernel   (dQ = sum_kv dS K * scale)
//   K3 flash_dkv_kernel    <- _dkv_kernel  (dV = sum_q P^T dO, dK = sum_q dS^T Q)
// and, instantiated with PACKED = true, the packed-segment kernels
//   K4 flash_fwd_kernel<.., true>  <- _fwd_kernel_seg
//   K5 flash_dq_kernel<.., true>   <- _dq_kernel_seg
//   K6 flash_dkv_kernel<.., true>  <- _dkv_kernel_seg
// which take (B, Tq) / (B, Tk) int32 segment ids and also mask
// seg_q[q] != seg_k[k].  Each tile stages its BQ query ids and BK key ids in
// shared memory.  The causal block limits are unchanged (a packed tile is
// visited whenever the causal mask alone would visit it), and a query whose
// segment has no key gets out = 0, lse = -1e30 and zero gradients through
// the same finite-mask and safe-max rules.  The PACKED = false
// instantiations run the same instructions as before the flag existed: the
// id loads and the extra mask term are `if constexpr` code, and the two id
// pointers are trailing kernel arguments they never read.
//
// What it computes is the TPU kernels' math, not their block structure:
// - The TPU grid's sequential KV axis (K1/K2) is a loop inside the thread
//   block that stops at the global causal diagonal; K3's sequential Q axis
//   is a loop that starts at it.  Blocks above the diagonal cost nothing.
// - Each thread block computes its own offsets from blockIdx and the
//   (B, T, H, D) strides; query head h reads KV head h / rep.  The ragged
//   sequence tail is masked here instead of padded.
// - (q_off, k_off) are global token offsets, so the with-lse form and a
//   later ring attention reuse the same kernels.
// - Masked scores take the finite -1e30 and the safe-max rule of the TPU
//   kernel, so a fully masked row gives out = 0, lse = -1e30 and zero
//   gradients (a -inf would turn the backward into NaNs).
// - The TPU kernels round p and ds to the input type before their
//   products, which in fp32 changes nothing.  K3 loops over the rep query
//   heads of its KV head and accumulates dK/dV over the group (the TPU
//   version writes per-head dK/dV and sums the group outside the kernel).
//
// Every kernel is instantiated for head dims 16, 32, 64 and 128 (the FMA
// tiles take any multiple of 16).
//
// What bounds it on this card: as written, the FP32 FMA pipes fed from
// shared memory.  Causal attention at the slice's shapes (T = 2048, D = 128)
// does ~4*T*D flops per key-value row it reads, far above the H100's
// ~295 flops/byte ridge, so it is bound by operations, and the fast form of
// this kernel runs its products on the tensor cores (mma.sync / wgmma).
// This first version keeps every product in fp32 FMAs over shared-memory
// tiles (64 x 64 tiles, 256 threads, each thread owning a 4 x 4 score tile
// and 4 output rows): simple, exact in fp32, and the reference point for
// the tensor-core version a later change brings.  The design answers the
// bound only by skipping dead blocks and by never writing the (T, T)
// score matrix to device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int NT = 256;       // threads per block (16 x 16)
constexpr int LDP = BK + 1;   // padded row stride of the score tiles
constexpr float NEG = -1e30f; // the TPU kernel's finite mask value

// Reductions over the 16 lanes that share a score row (tx = lane % 16).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Load `rows` rows of D values (row r at src + r * stride) into a float tile
// with leading dimension `ld`; rows at or past `valid` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          long stride, int rows, int valid) {
  for (int idx = threadIdx.x; idx < rows * D; idx += NT) {
    const int r = idx / D, c = idx - r * D;
    dst[r * ld + c] = r < valid ? src[(long)r * stride + c] : 0.f;
  }
}

// Number of key blocks a query tile [q0, q0 + BQ) must visit.
__device__ __forceinline__ int kv_blocks(int Tk, int q0, int q_off, int k_off,
                                         int causal) {
  int n = (Tk + BK - 1) / BK;
  if (causal) {
    const int lim = q_off + q0 + BQ - 1 - k_off;  // last key position seen
    n = lim < 0 ? 0 : min(n, lim / BK + 1);
  }
  return n;
}

__device__ __forceinline__ bool masked(int ql, int kl, int Tq, int Tk,
                                       int q_off, int k_off, int causal) {
  return kl >= Tk || ql >= Tq || (causal && k_off + kl > q_off + ql);
}

// Stage `n` segment ids (src[0..valid)) in shared memory; rows at or past
// `valid` get -1 (they are masked by position already).
__device__ __forceinline__ void load_ids(int* dst, const int32_t* src, int n,
                                         int valid) {
  for (int r = threadIdx.x; r < n; r += NT) dst[r] = r < valid ? src[r] : -1;
}

// The packed-segment term of the mask: query tile row r and key tile row c
// lie in different documents.
template <bool PACKED>
__device__ __forceinline__ bool seg_differs(const int* sq, const int* sk,
                                            int r, int c) {
  if constexpr (PACKED) {
    return sq[r] != sk[c];
  } else {
    return false;
  }
}

// ---------------------------------------------------------------- K1 ----
// grid (ceil(Tq / BQ), H, B).  out (B, Tq, H, D), lse (B, H, Tq) fp32.
// PACKED (K4): seg_q (B, Tq), seg_k (B, Tk) int32.
template <int D, bool PACKED>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int Tq, int Tk, int H, int Hkv,
                 int q_off, int k_off, int causal, float scale,
                 const int32_t* __restrict__ seg_q,
                 const int32_t* __restrict__ seg_k) {
  constexpr int LDK = D + 1;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;            // BQ x LDK
  float* Ks = Qs + BQ * LDK;   // BK x LDK
  float* Vs = Ks + BK * LDK;   // BK x D
  float* Ps = Vs + BK * D;     // BQ x LDP
  int* sq_s = reinterpret_cast<int*>(Ps + BQ * LDP);  // BQ ids (PACKED)
  int* sk_s = sq_s + BQ;                              // BK ids (PACKED)

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long qs = (long)H * D, ks = (long)Hkv * D;

  load_tile<D>(Qs, LDK, q + ((long)b * Tq + q0) * qs + (long)h * D, qs, BQ,
                  Tq - q0);
  if constexpr (PACKED) load_ids(sq_s, seg_q + (long)b * Tq + q0, BQ, Tq - q0);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int nkb = kv_blocks(Tk, q0, q_off, k_off, causal);
  for (int j = 0; j < nkb; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous block is done with Ks / Vs / Ps
    const long kbase = ((long)b * Tk + k0) * ks + (long)hk * D;
    load_tile<D>(Ks, LDK, k + kbase, ks, BK, Tk - k0);
    load_tile<D>(Vs, D, v + kbase, ks, BK, Tk - k0);
    if constexpr (PACKED) load_ids(sk_s, seg_k + (long)b * Tk + k0, BK, Tk - k0);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * LDK + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * LDK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ql = q0 + ty * 4 + i;
      float mc = NEG;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kl = k0 + tx + 16 * c;
        s[i][c] = (masked(ql, kl, Tq, Tk, q_off, k_off, causal) ||
                   seg_differs<PACKED>(sq_s, sk_s, ty * 4 + i, tx + 16 * c))
                      ? NEG
                      : s[i][c] * scale;
        mc = fmaxf(mc, s[i][c]);
      }
      const float m_next = fmaxf(m[i], row_max(mc));
      // Fully-masked-so-far rows keep m at -1e30: shift by 0 instead, so
      // exp() sees finite arguments and masked scores underflow to 0.
      const float safe = m_next <= NEG / 2 ? 0.f : m_next;
      const float alpha = expf(m[i] <= NEG / 2 ? NEG : m[i] - safe);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[i][c] - safe);
        psum += p;
        Ps[(ty * 4 + i) * LDP + tx + 16 * c] = p;
      }
      l[i] = alpha * l[i] + row_sum(psum);
      m[i] = m_next;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = Vs[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ql = q0 + ty * 4 + i;
    if (ql >= Tq) continue;
    const float lse_v =
        l[i] > 0.f ? (m[i] <= NEG / 2 ? 0.f : m[i]) + logf(l[i]) : NEG;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    if (tx == 0) lse[((long)b * H + h) * Tq + ql] = lse_v;
    float* o = out + ((long)b * Tq + ql) * qs + (long)h * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[tx + 16 * c] = acc[i][c] * inv;
  }
}

// ---------------------------------------------------------------- K2 ----
// grid (ceil(Tq / BQ), H, B).  dq (B, Tq, H, D) fp32.
// lse / delta / dlse: (B, H, Tq) fp32; delta = rowsum(dO * O).
// PACKED (K5): seg_q (B, Tq), seg_k (B, Tk) int32.
template <int D, bool PACKED>
__global__ void __launch_bounds__(NT, 1)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const float* __restrict__ dlse, float* __restrict__ dq, int Tq,
                int Tk, int H, int Hkv, int q_off, int k_off, int causal,
                float scale, const int32_t* __restrict__ seg_q,
                const int32_t* __restrict__ seg_k) {
  constexpr int LDK = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x LDK
  float* dOs = Qs + BQ * LDK;   // BQ x LDK
  float* Ks = dOs + BQ * LDK;   // BK x LDK
  float* Vs = Ks + BK * LDK;    // BK x LDK
  float* dSs = Vs + BK * LDK;   // BQ x LDP
  int* sq_s = reinterpret_cast<int*>(dSs + BQ * LDP);  // BQ ids (PACKED)
  int* sk_s = sq_s + BQ;                               // BK ids (PACKED)

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long qs = (long)H * D, ks = (long)Hkv * D;
  const long qbase = ((long)b * Tq + q0) * qs + (long)h * D;

  load_tile<D>(Qs, LDK, q + qbase, qs, BQ, Tq - q0);
  load_tile<D>(dOs, LDK, dout + qbase, qs, BQ, Tq - q0);
  if constexpr (PACKED) load_ids(sq_s, seg_q + (long)b * Tq + q0, BQ, Tq - q0);

  float row_lse[4], row_c[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ql = q0 + ty * 4 + i;
    const long r = ((long)b * H + h) * Tq + ql;
    row_lse[i] = ql < Tq ? lse[r] : NEG;
    row_c[i] = ql < Tq ? dlse[r] - delta[r] : 0.f;  // (dp - delta + dlse)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int nkb = kv_blocks(Tk, q0, q_off, k_off, causal);
  for (int j = 0; j < nkb; ++j) {
    const int k0 = j * BK;
    __syncthreads();
    const long kbase = ((long)b * Tk + k0) * ks + (long)hk * D;
    load_tile<D>(Ks, LDK, k + kbase, ks, BK, Tk - k0);
    load_tile<D>(Vs, LDK, v + kbase, ks, BK, Tk - k0);
    if constexpr (PACKED) load_ids(sk_s, seg_k + (long)b * Tk + k0, BK, Tk - k0);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty * 4 + i) * LDK + d];
        ov[i] = dOs[(ty * 4 + i) * LDK + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kv[c] = Ks[(tx + 16 * c) * LDK + d];
        vv[c] = Vs[(tx + 16 * c) * LDK + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
          dp[i][c] = fmaf(ov[i], vv[c], dp[i][c]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ql = q0 + ty * 4 + i;
      const bool empty = row_lse[i] <= NEG / 2;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kl = k0 + tx + 16 * c;
        const float p =
            (empty || masked(ql, kl, Tq, Tk, q_off, k_off, causal) ||
             seg_differs<PACKED>(sq_s, sk_s, ty * 4 + i, tx + 16 * c))
                ? 0.f
                : expf(s[i][c] * scale - row_lse[i]);
        dSs[(ty * 4 + i) * LDP + tx + 16 * c] =
            p * (dp[i][c] + row_c[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty * 4 + i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kv = Ks[kk * LDK + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ql = q0 + ty * 4 + i;
    if (ql >= Tq) continue;
    float* o = dq + ((long)b * Tq + ql) * qs + (long)h * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[tx + 16 * c] = acc[i][c];
  }
}

// ---------------------------------------------------------------- K3 ----
// grid (ceil(Tk / BK), Hkv, B).  dk, dv (B, Tk, Hkv, D) fp32, summed over
// the rep query heads of the KV head in fp32.
// PACKED (K6): seg_q (B, Tq), seg_k (B, Tk) int32.
template <int D, bool PACKED>
__global__ void __launch_bounds__(NT, 1)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const float* __restrict__ dlse, float* __restrict__ dk,
                 float* __restrict__ dv, int Tq, int Tk, int H, int Hkv,
                 int q_off, int k_off, int causal, float scale,
                 const int32_t* __restrict__ seg_q,
                 const int32_t* __restrict__ seg_k) {
  constexpr int LDK = D + 1;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;              // BK x LDK
  float* Vs = Ks + BK * LDK;     // BK x LDK
  float* Qs = Vs + BK * LDK;     // BQ x LDK
  float* dOs = Qs + BQ * LDK;    // BQ x LDK
  float* Pt = dOs + BQ * LDK;    // BK x LDP  (P transposed)
  float* dSt = Pt + BK * LDP;    // BK x LDP  (dS transposed)
  float* lse_s = dSt + BK * LDP; // BQ
  float* c_s = lse_s + BQ;       // BQ: dlse - delta
  int* sq_s = reinterpret_cast<int*>(c_s + BQ);  // BQ ids (PACKED)
  int* sk_s = sq_s + BQ;                         // BK ids (PACKED)

  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int rep = H / Hkv;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long qs = (long)H * D, ks = (long)Hkv * D;
  const long kbase = ((long)b * Tk + k0) * ks + (long)hk * D;

  load_tile<D>(Ks, LDK, k + kbase, ks, BK, Tk - k0);
  load_tile<D>(Vs, LDK, v + kbase, ks, BK, Tk - k0);
  if constexpr (PACKED) load_ids(sk_s, seg_k + (long)b * Tk + k0, BK, Tk - k0);

  float dka[4][DC], dva[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[i][c] = dva[i][c] = 0.f;

  // First query tile whose rows can see this key tile (the diagonal).
  int i0 = 0;
  if (causal) {
    const int need = k_off + k0 - q_off - BQ + 1;  // q0 >= need
    i0 = need <= 0 ? 0 : (need + BQ - 1) / BQ;
  }
  const int nqb = (Tq + BQ - 1) / BQ;

  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    for (int it = i0; it < nqb; ++it) {
      const int q0 = it * BQ;
      __syncthreads();  // the previous tile is done with Qs / dOs / Pt / dSt
      const long qbase = ((long)b * Tq + q0) * qs + (long)h * D;
      load_tile<D>(Qs, LDK, q + qbase, qs, BQ, Tq - q0);
      load_tile<D>(dOs, LDK, dout + qbase, qs, BQ, Tq - q0);
      for (int r = threadIdx.x; r < BQ; r += NT) {
        const int ql = q0 + r;
        const long ri = ((long)b * H + h) * Tq + ql;
        lse_s[r] = ql < Tq ? lse[ri] : NEG;
        c_s[r] = ql < Tq ? dlse[ri] - delta[ri] : 0.f;
        if constexpr (PACKED) sq_s[r] = ql < Tq ? seg_q[(long)b * Tq + ql] : -1;
      }
      __syncthreads();

      // Transposed tiles: thread rows are keys (ty), columns queries (tx).
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) st[i][c] = dpt[i][c] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(ty * 4 + i) * LDK + d];
          vv[i] = Vs[(ty * 4 + i) * LDK + d];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          qv[c] = Qs[(tx + 16 * c) * LDK + d];
          ov[c] = dOs[(tx + 16 * c) * LDK + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            st[i][c] = fmaf(kv[i], qv[c], st[i][c]);
            dpt[i][c] = fmaf(vv[i], ov[c], dpt[i][c]);
          }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kl = k0 + ty * 4 + i;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = tx + 16 * c;
          const int ql = q0 + r;
          const float lr = lse_s[r];
          const float p =
              (lr <= NEG / 2 || masked(ql, kl, Tq, Tk, q_off, k_off, causal) ||
               seg_differs<PACKED>(sq_s, sk_s, r, ty * 4 + i))
                  ? 0.f
                  : expf(st[i][c] * scale - lr);
          Pt[(ty * 4 + i) * LDP + r] = p;
          dSt[(ty * 4 + i) * LDP + r] =
              p * (dpt[i][c] + c_s[r]) * scale;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int kk = 0; kk < BQ; ++kk) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Pt[(ty * 4 + i) * LDP + kk];
          dsv[i] = dSt[(ty * 4 + i) * LDP + kk];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float ov = dOs[kk * LDK + tx + 16 * c];
          const float qv = Qs[kk * LDK + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dva[i][c] = fmaf(pv[i], ov, dva[i][c]);
            dka[i][c] = fmaf(dsv[i], qv, dka[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kl = k0 + ty * 4 + i;
    if (kl >= Tk) continue;
    const long o = ((long)b * Tk + kl) * ks + (long)hk * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[o + tx + 16 * c] = dka[i][c];
      dv[o + tx + 16 * c] = dva[i][c];
    }
  }
}

// Shared memory of each kernel; a packed one adds its BQ + BK staged ids.
constexpr size_t ids_smem(bool packed) {
  return packed ? sizeof(int) * (size_t)(BQ + BK) : 0;
}
constexpr size_t fwd_smem(int D, bool packed) {
  return sizeof(float) * ((size_t)BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * LDP) +
         ids_smem(packed);
}
constexpr size_t dq_smem(int D, bool packed) {
  return sizeof(float) * (2 * (size_t)BQ * (D + 1) + 2 * BK * (D + 1) + BQ * LDP) +
         ids_smem(packed);
}
constexpr size_t dkv_smem(int D, bool packed) {
  return sizeof(float) *
             (2 * (size_t)BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BK * LDP + 2 * BQ) +
         ids_smem(packed);
}

struct Geom {
  int B, Tq, Tk, H, Hkv, D, q_off, k_off, causal;
  float scale;
};

template <int D, bool PACKED>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               float* lse, const int32_t* sq, const int32_t* sk,
               const Geom& g, cudaStream_t st) {
  const size_t sm = fwd_smem(D, PACKED);
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<D, PACKED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)sm);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((g.Tq + BQ - 1) / BQ, g.H, g.B);
  flash_fwd_kernel<D, PACKED><<<grid, NT, sm, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, lse,
      g.Tq, g.Tk, g.H, g.Hkv, g.q_off, g.k_off, g.causal, g.scale, sq, sk);
  return (int)cudaGetLastError();
}

template <int D, bool PACKED>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const float* dlse,
              void* dq, const int32_t* sq, const int32_t* sk, const Geom& g,
              cudaStream_t st) {
  const size_t sm = dq_smem(D, PACKED);
  cudaError_t e = cudaFuncSetAttribute(flash_dq_kernel<D, PACKED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)sm);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((g.Tq + BQ - 1) / BQ, g.H, g.B);
  flash_dq_kernel<D, PACKED><<<grid, NT, sm, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, dlse, (float*)dq, g.Tq, g.Tk, g.H, g.Hkv, g.q_off, g.k_off,
      g.causal, g.scale, sq, sk);
  return (int)cudaGetLastError();
}

template <int D, bool PACKED>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const float* dlse,
               void* dk, void* dv, const int32_t* sq, const int32_t* sk,
               const Geom& g, cudaStream_t st) {
  const size_t sm = dkv_smem(D, PACKED);
  cudaError_t e = cudaFuncSetAttribute(flash_dkv_kernel<D, PACKED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)sm);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((g.Tk + BK - 1) / BK, g.Hkv, g.B);
  flash_dkv_kernel<D, PACKED><<<grid, NT, sm, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, dlse, (float*)dk, (float*)dv, g.Tq, g.Tk, g.H, g.Hkv,
      g.q_off, g.k_off, g.causal, g.scale, sq, sk);
  return (int)cudaGetLastError();
}

constexpr int ERR_BAD_ARGS = -1;

// The head dims every kernel is instantiated for.
#define DISPATCH_D(FN, P, ...)                                                \
  if (g.D == 16) return FN<16, P>(__VA_ARGS__);                               \
  if (g.D == 32) return FN<32, P>(__VA_ARGS__);                               \
  if (g.D == 64) return FN<64, P>(__VA_ARGS__);                               \
  if (g.D == 128) return FN<128, P>(__VA_ARGS__)

Geom geom(int B, int Tq, int Tk, int H, int Hkv, int D, int q_off, int k_off,
          int causal, float scale) {
  return Geom{B, Tq, Tk, H, Hkv, D, q_off, k_off, causal, scale};
}

bool bad(const Geom& g) {
  return g.B < 1 || g.Tq < 1 || g.Tk < 1 || g.Hkv < 1 || g.H % g.Hkv != 0 ||
         g.B > 65535 || g.H > 65535;
}

template <bool PACKED>
int fwd_entry(const void* q, const void* k, const void* v,
              void* out, float* lse, const int32_t* sq, const int32_t* sk,
              int B, int Tq, int Tk, int H, int Hkv, int D, int q_off,
              int k_off, int causal, float scale, void* stream) {
  const Geom g = geom(B, Tq, Tk, H, Hkv, D, q_off, k_off, causal, scale);
  if (bad(g)) return ERR_BAD_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  DISPATCH_D(launch_fwd, PACKED, q, k, v, out, lse, sq, sk, g, st);
  return ERR_BAD_ARGS;
}

template <bool PACKED>
int dq_entry(const void* q, const void* k, const void* v,
             const void* dout, const float* lse, const float* delta,
             const float* dlse, void* dq, const int32_t* sq, const int32_t* sk,
             int B, int Tq, int Tk, int H, int Hkv, int D, int q_off, int k_off,
             int causal, float scale, void* stream) {
  const Geom g = geom(B, Tq, Tk, H, Hkv, D, q_off, k_off, causal, scale);
  if (bad(g)) return ERR_BAD_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  DISPATCH_D(launch_dq, PACKED, q, k, v, dout, lse, delta, dlse, dq, sq,
             sk, g, st);
  return ERR_BAD_ARGS;
}

template <bool PACKED>
int dkv_entry(const void* q, const void* k, const void* v,
              const void* dout, const float* lse, const float* delta,
              const float* dlse, void* dk, void* dv, const int32_t* sq,
              const int32_t* sk, int B, int Tq, int Tk, int H, int Hkv, int D,
              int q_off, int k_off, int causal, float scale, void* stream) {
  const Geom g = geom(B, Tq, Tk, H, Hkv, D, q_off, k_off, causal, scale);
  if (bad(g)) return ERR_BAD_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  DISPATCH_D(launch_dkv, PACKED, q, k, v, dout, lse, delta, dlse, dk,
             dv, sq, sk, g, st);
  return ERR_BAD_ARGS;
}

}  // namespace

// Each entry point launches one kernel over fp32 tensors on `stream` (bf16
// takes the wgmma kernels of flash_fwd_sm90.cu and flash_bwd_sm90.cu) and
// returns cudaGetLastError() (0 on success), or -1 for arguments it does
// not take.
// The _seg entry points take the (B, Tq) / (B, Tk) int32 segment ids after
// the tensors (K4-K6).
extern "C" int ddl_flash_fwd(const void* q, const void* k,
                             const void* v, void* out, float* lse, int B,
                             int Tq, int Tk, int H, int Hkv, int D, int q_off,
                             int k_off, int causal, float scale, void* stream) {
  return fwd_entry<false>(q, k, v, out, lse, nullptr, nullptr, B, Tq,
                          Tk, H, Hkv, D, q_off, k_off, causal, scale, stream);
}

extern "C" int ddl_flash_bwd_dq(const void* q, const void* k,
                                const void* v, const void* dout,
                                const float* lse, const float* delta,
                                const float* dlse, void* dq, int B, int Tq,
                                int Tk, int H, int Hkv, int D, int q_off,
                                int k_off, int causal, float scale,
                                void* stream) {
  return dq_entry<false>(q, k, v, dout, lse, delta, dlse, dq, nullptr,
                         nullptr, B, Tq, Tk, H, Hkv, D, q_off, k_off, causal,
                         scale, stream);
}

extern "C" int ddl_flash_bwd_dkv(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const float* lse, const float* delta,
                                 const float* dlse, void* dk, void* dv, int B,
                                 int Tq, int Tk, int H, int Hkv, int D,
                                 int q_off, int k_off, int causal, float scale,
                                 void* stream) {
  return dkv_entry<false>(q, k, v, dout, lse, delta, dlse, dk, dv,
                          nullptr, nullptr, B, Tq, Tk, H, Hkv, D, q_off, k_off,
                          causal, scale, stream);
}

extern "C" int ddl_flash_fwd_seg(const void* q, const void* k,
                                 const void* v, void* out, float* lse,
                                 const int32_t* seg_q, const int32_t* seg_k,
                                 int B, int Tq, int Tk, int H, int Hkv, int D,
                                 int q_off, int k_off, int causal, float scale,
                                 void* stream) {
  return fwd_entry<true>(q, k, v, out, lse, seg_q, seg_k, B, Tq, Tk, H,
                         Hkv, D, q_off, k_off, causal, scale, stream);
}

extern "C" int ddl_flash_bwd_dq_seg(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    const float* dlse, void* dq,
                                    const int32_t* seg_q, const int32_t* seg_k,
                                    int B, int Tq, int Tk, int H, int Hkv,
                                    int D, int q_off, int k_off, int causal,
                                    float scale, void* stream) {
  return dq_entry<true>(q, k, v, dout, lse, delta, dlse, dq, seg_q,
                        seg_k, B, Tq, Tk, H, Hkv, D, q_off, k_off, causal,
                        scale, stream);
}

extern "C" int ddl_flash_bwd_dkv_seg(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const float* lse, const float* delta,
                                     const float* dlse, void* dk, void* dv,
                                     const int32_t* seg_q,
                                     const int32_t* seg_k, int B, int Tq,
                                     int Tk, int H, int Hkv, int D, int q_off,
                                     int k_off, int causal, float scale,
                                     void* stream) {
  return dkv_entry<true>(q, k, v, dout, lse, delta, dlse, dk, dv, seg_q,
                         seg_k, B, Tq, Tk, H, Hkv, D, q_off, k_off, causal,
                         scale, stream);
}
