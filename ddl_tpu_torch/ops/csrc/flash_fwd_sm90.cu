// The bf16 flash-attention forward for NVIDIA Hopper (sm_90a): TMA copies
// into a shared-memory ring, wgmma on the tensor cores, and, for packed
// documents, no work on key tiles whose document ids cannot meet the query
// tile's.  Plain C interface, loaded from Python with ctypes
// (ddl_tpu_torch/ops/flash_attention.py builds and binds it); the Hopper
// helpers come from sm90.cuh, shared with the dK/dV backward.
//
// Replaces, for bf16 inputs, the Pallas TPU kernels
//   K1 <- ddl_tpu/ops/flash_attention.py:97  _fwd_kernel      (PACKED = false)
//   K4 <- ddl_tpu/ops/flash_attention.py:334 _fwd_kernel_seg  (PACKED = true)
// (both launched by the pallas_call at :471).  fp32 inputs keep the exact
// FMA template of flash_attention.cu: TF32 would not hold the reference's
// fp32 precision.  Outputs are those of K1/K4 there: out (B, Tq, H, D) bf16
// and lse (B, H, Tq) fp32, which the backward kernels K2/K3/K5/K6 read.
//
// What bounds it on this card.  At the main path's shape (B = 4, T = 2048,
// H = 32, Hkv = 8, D = 128, causal) the forward does 4 * D flops on each of
// the B * H * T * (T + 1) / 2 causal pairs, 137.5 GFLOP, while it must move
// only ~168 MB (q, k, v in, out and lse out): 0.139 ms at 989 TFLOP/s
// against 0.050 ms at 3.35 TB/s, so it is bound by operations, and only the
// tensor cores reach that rate.  On packed documents (~19 % of causal pairs
// in-segment at the slice's document lengths) the in-segment work falls
// under the byte time, so K4 is bound by bytes (0.050 ms) and what it can
// gain is work skipped, not work done faster.
//
// What the design does about it:
// - One block covers BQ = 128 query rows of one (b, h): two consumer
//   warpgroups of 64 rows each and one producer warp.  The producer issues
//   TMA loads: the Q tile once, then K and V tiles of BK = 128 rows into a
//   ring of STAGES = 2 buffers, K and V each with their own full/empty
//   mbarriers (a K tile goes back as soon as S is done).  K and V are
//   read at KV head h / rep straight from the compact GQA layout, through
//   3-D tensor maps over (heads * D, T, B), whose bounds zero-fill rows past
//   T inside each batch.
// - S = Q K^T is one wgmma.m64n128k16 per 16 columns of D (bf16 in, fp32
//   accumulators in registers).  Masks and the online softmax (exp2 with
//   the scale folded into one FMA) run on that accumulator fragment; P is
//   rounded to bf16 (the reference's
//   p.astype(v.dtype)) and fed to O += P V as the register A operand of a
//   second wgmma, with V as the transposed shared-memory B operand.  O stays
//   in registers until the epilogue scales it by 1 / l.
// - Shared-memory tiles use the TMA swizzle that matches a row of the tile
//   (128 B for D >= 64, split into 64-column atoms; 64 B for D = 32; 32 B
//   for D = 16), and the wgmma descriptors name the same layout.
// - As the reference splits _attend_fast from _attend_masked, a tile builds
//   a mask only where it crosses the causal diagonal, holds keys past Tk, or
//   (K4) holds more than one document id; every other tile scales and
//   exponentiates its scores unmasked.  The key loop stops at the causal
//   diagonal, a warpgroup skips a tile that is dead for all its rows, and
//   (q_off, k_off) stay global offsets.  Masked scores take the finite
//   -1e30 with the reference's safe-max rule, so a row with no key gives
//   out = 0 and lse = -1e30.
// - K4's tile skip: a pre-pass kernel writes the [min, max] of the ids over
//   each 64-row query granule (one per consumer warpgroup) and each BK-row
//   key tile.  A key tile whose id range is disjoint from the query tile's
//   cannot hold a same-document pair, so neither the producer loads it nor
//   the consumers multiply it.  The test is exact for any ids, sorted or
//   not (live_tiles() in the Python module states the same rule).  The
//   producer warp copies each visited tile's key ids into shared memory
//   beside its V, so the mask reads them there.  Given a device counter,
//   the producer adds the number of key tiles it loaded: the skip measured.
// - Blocks run the longest causal rows first.

#include "sm90.cuh"

namespace {

constexpr int BQ = 128;                // query rows per block
constexpr int BK = 128;                // key rows per tile
constexpr int STAGES = 2;              // K/V ring depth
constexpr int G = 64;                  // query id-range granule (rows)
constexpr int NCONS = 256;             // two consumer warpgroups
constexpr int NT = NCONS + 32;         // + one producer warp
constexpr float LN2 = 0.69314718055994531f;

// Tile geometry of head dim D: the Q tile (BQ rows) and the K/V tiles (BK
// rows), which share one row layout.
template <int D>
struct Geo {
  using QT = Tile<D, BQ>;
  using KVT = Tile<D, BK>;
  static constexpr int ROWB = KVT::ROWB, NATOM = KVT::NATOM, COLS = KVT::COLS;
  static constexpr int Q_ATOM = QT::ATOM, KV_ATOM = KVT::ATOM;
  static constexpr int Q_BYTES = QT::BYTES, KV_BYTES = KVT::BYTES;
  // Q, the K and V rings, 4 * STAGES + 1 mbarriers, each stage's key ids
  // (K4), and slack to align the base to the 1024 B the swizzle patterns
  // repeat at.
  static constexpr int SMEM =
      Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (4 * STAGES + 1) + 4 * STAGES * BK + 1024;
};

// -------------------------------------------------------------- tiling ---

// Number of key tiles a query tile [q0, q0 + BQ) visits (the causal
// diagonal stops the loop).
__device__ __forceinline__ int kv_tiles(int Tk, int q0, int q_off, int k_off, int causal) {
  int n = (Tk + BK - 1) / BK;
  if (causal) {
    const int lim = q_off + q0 + BQ - 1 - k_off;  // last key position seen
    n = lim < 0 ? 0 : min(n, lim / BK + 1);
  }
  return n;
}

// ---------------------------------------------------------------- K1/K4 ---

// O += P V over BK / 16 steps of 16 keys, committed as one group; V at
// shared address `va` is MN-major (D contiguous), in atoms of COLS columns.
template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2], const uint32_t (&pa)[BK / 16][4],
                                           uint32_t va) {
  using Gm = Geo<D>;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    mma_rs<D>(o, pa[kk], Gm::KVT::mnmajor(va, kk));
  }
  wg_commit();
}

// grid (ceil(Tq / BQ), H, B), NT threads.  out (B, Tq, H, D) bf16, lse
// (B, H, Tq) fp32.  PACKED (K4): seg_q (B, Tq), seg_k (B, Tk) int32 and
// their id ranges from id_range_kernel.  `visited`, when not null, gains
// the number of key tiles the block loaded.
//
// Per key tile a consumer warpgroup runs S = Q K^T, the mask and online
// softmax on the accumulator fragment, then O += P V.  K and V have their
// own full/empty barriers, so a K tile goes back to the producer as soon as
// S is done, while the next tile's K and V are already landing; the two
// warpgroups' products and softmaxes interleave on the SM.  (Running P V
// one tile behind, to overlap a warpgroup's own softmax with its products,
// needs more than the 168 registers a thread gets at 288 threads: ptxas
// then serializes every wgmma, and the kernel runs slower.)
template <int D, bool PACKED>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                      const int32_t* __restrict__ seg_q, const int32_t* __restrict__ seg_k,
                      const int32_t* __restrict__ q_rng, const int32_t* __restrict__ k_rng,
                      unsigned long long* __restrict__ visited, int Tq, int Tk, int H,
                      int Hkv, int q_off, int k_off, int causal, float scale_log2) {
  using Gm = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + Gm::Q_BYTES;               // STAGES tiles
  const uint32_t sV = sK + STAGES * Gm::KV_BYTES;     // STAGES tiles
  const uint32_t bar_q = sV + STAGES * Gm::KV_BYTES;  // Q landed
  const uint32_t full_k = bar_q + 8;                  // K of a stage landed
  const uint32_t full_v = full_k + 8 * STAGES;        // V (and K4's key ids) landed
  const uint32_t empty_k = full_v + 8 * STAGES;       // K of a stage consumed
  const uint32_t empty_v = empty_k + 8 * STAGES;      // V (and ids) consumed
  // K4: each stage's BK key ids.
  int* const key_ids =
      reinterpret_cast<int*>(smem_raw + (empty_v + 8 * STAGES - smem_addr(smem_raw)));

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int nkb = kv_tiles(Tk, q0, q_off, k_off, causal);
  const int nq_g = (Tq + G - 1) / G, nk_t = (Tk + BK - 1) / BK;

  // The block's query-id range (its BQ / G granules that exist): a key
  // tile outside it is skipped (K4).
  int bq_lo = INT_MAX, bq_hi = INT_MIN;
  if constexpr (PACKED) {
    for (int g = q0 / G; g < q0 / G + BQ / G && g < nq_g; ++g) {
      const int2 r = id_range(q_rng, b, nq_g, g);
      bq_lo = min(bq_lo, r.x);
      bq_hi = max(bq_hi, r.y);
    }
  }
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, PACKED ? 32 : 1);  // K4: each producer lane's ids
      mbar_init(empty_k + 8 * s, NCONS);
      mbar_init(empty_v + 8 * s, NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= NCONS / 32) {
    // ------------------------------------------------------ producer ---

    // Lane 0 issues the TMA loads; for K4 every lane also copies a quarter
    // of the tile's key ids and arrives on the V barrier after them.
    if (lane == 0) {
      mbar_expect_tx(bar_q, Gm::Q_BYTES);
#pragma unroll
      for (int c = 0; c < Gm::NATOM; ++c)
        tma_load(sQ + c * Gm::Q_ATOM, &tm_q, bar_q, h * D + c * Gm::COLS, q0, b);
    }
    if (!PACKED && lane != 0) return;
    int it = 0;
    for (int j = 0; j < nkb; ++j) {
      if constexpr (PACKED) {
        const int2 r = id_range(k_rng, b, nk_t, j);
        if (r.x > bq_hi || bq_lo > r.y) continue;
      }
      const int s = it % STAGES;
      const uint32_t par = (it / STAGES - 1) & 1;
      if (lane == 0) {
        if (it >= STAGES) mbar_wait(empty_k + 8 * s, par);
        mbar_expect_tx(full_k + 8 * s, Gm::KV_BYTES);
#pragma unroll
        for (int c = 0; c < Gm::NATOM; ++c)
          tma_load(sK + s * Gm::KV_BYTES + c * Gm::KV_ATOM, &tm_k, full_k + 8 * s,
                   hk * D + c * Gm::COLS, j * BK, b);
      }
      if (it >= STAGES) mbar_wait(empty_v + 8 * s, par);
      if constexpr (PACKED) {
        for (int t = lane; t < BK; t += 32) {
          const int kl = j * BK + t;
          key_ids[s * BK + t] = kl < Tk ? seg_k[(long)b * Tk + kl] : INT_MIN;
        }
      }
      if (lane == 0) {
        mbar_expect_tx(full_v + 8 * s, Gm::KV_BYTES);
#pragma unroll
        for (int c = 0; c < Gm::NATOM; ++c)
          tma_load(sV + s * Gm::KV_BYTES + c * Gm::KV_ATOM, &tm_v, full_v + 8 * s,
                   hk * D + c * Gm::COLS, j * BK, b);
      } else {
        mbar_arrive(full_v + 8 * s);
      }
      ++it;
    }
    if (visited != nullptr && lane == 0) atomicAdd(visited, (unsigned long long)it);
    return;
  }

  // -------------------------------------------------------- consumers ---
  const int wg = warp / 4;                     // consumer warpgroup
  const int row = (warp % 4) * 16 + lane / 4;  // rows row and row + 8 of its tile
  const int cq = 2 * (lane % 4);               // first of this thread's columns
  const int qr0 = q0 + 64 * wg;                // the warpgroup's first query row
  const uint32_t qa = sQ + 64 * wg * Gm::ROWB; // its 64 rows of Q
  // A masked score in the accumulator's raw units: -1e30 once scaled.
  const float neg_raw = NEG / scale_log2;

  int wq_lo = 0, wq_hi = 0, sq[2] = {0, 0};
  if constexpr (PACKED) {
    if (qr0 < Tq) {
      const int2 r = id_range(q_rng, b, nq_g, qr0 / G);
      wq_lo = r.x;
      wq_hi = r.y;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int ql = qr0 + row + 8 * hh;
      sq[hh] = ql < Tq ? seg_q[(long)b * Tq + ql] : 0;
    }
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // m in scaled (log2) units
  float sc[BK / 2];                             // S of the current tile
  uint32_t pa[BK / 16][4];                      // P in bf16, wgmma's A fragment

  mbar_wait(bar_q, 0);
  int it = 0;
  for (int j = 0; j < nkb; ++j) {
    const int k0 = j * BK;
    bool dead = qr0 >= Tq || (causal && k_off + k0 > q_off + qr0 + 63);
    bool ids_differ = false;
    if constexpr (PACKED) {
      const int2 r = id_range(k_rng, b, nk_t, j);
      if (r.x > bq_hi || bq_lo > r.y) continue;  // the producer skipped it too
      dead |= r.x > wq_hi || wq_lo > r.y;
      ids_differ = !(r.x == r.y && wq_lo == wq_hi && r.x == wq_lo);
    }
    const int s = it % STAGES;
    const uint32_t par = (it / STAGES) & 1;
    ++it;
    mbar_wait(full_k + 8 * s, par);
    if (dead) {  // no row of this warpgroup sees a key of the tile
      mbar_arrive(empty_k + 8 * s);
      mbar_wait(full_v + 8 * s, par);
      mbar_arrive(empty_v + 8 * s);
      continue;
    }
    // S = Q K^T over D / 16 steps of 16 columns.
    const uint32_t ka = sK + s * Gm::KV_BYTES;
    reg_fence(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss_n128(sc, Gm::QT::kmajor(qa, kk), Gm::KVT::kmajor(ka, kk), kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    reg_fence(sc);
    mbar_arrive(empty_k + 8 * s);

    // Mask only where the tile needs it.  Element i = 4 * j8 + 2 * hh + e
    // of the fragment is row `row + 8 * hh`, column 8 * j8 + cq + e; K4's
    // key ids come with the tile's V.
    if (ids_differ || k0 + BK > Tk || (causal && k_off + k0 + BK - 1 > q_off + qr0)) {
      if constexpr (PACKED) mbar_wait(full_v + 8 * s, par);
#pragma unroll
      for (int j8 = 0; j8 < BK / 8; ++j8) {
        int2 sk = make_int2(0, 0);
        if constexpr (PACKED) {
          if (ids_differ) sk = *reinterpret_cast<const int2*>(key_ids + s * BK + 8 * j8 + cq);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kl = k0 + 8 * j8 + cq + e;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int ql = qr0 + row + 8 * hh;
            const bool masked = kl >= Tk || (causal && k_off + kl > q_off + ql) ||
                                (PACKED && ids_differ && (e ? sk.y : sk.x) != sq[hh]);
            if (masked) sc[4 * j8 + 2 * hh + e] = neg_raw;
          }
        }
      }
    }

    // Online softmax over the two rows (the four lanes of a row hold its
    // columns), in log2 units: p = 2^(s * scale_log2 - m).  A row still
    // fully masked shifts by 0, so its masked scores underflow to 0 (the
    // reference's safe-max rule).
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = neg_raw;
#pragma unroll
      for (int j8 = 0; j8 < BK / 8; ++j8)
        mx = fmaxf(mx, fmaxf(sc[4 * j8 + 2 * hh], sc[4 * j8 + 2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_next = fmaxf(m[hh], mx * scale_log2);
      const float safe = m_next <= NEG / 2 ? 0.f : m_next;
      alpha[hh] = m[hh] <= NEG / 2 ? 0.f : ex2(m[hh] - safe);
      float sum = 0.f;
#pragma unroll
      for (int j8 = 0; j8 < BK / 8; ++j8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j8 + 2 * hh + e;
          sc[i] = ex2(fmaf(sc[i], scale_log2, -safe));
          sum += sc[i];
        }
      }
      l[hh] = alpha[hh] * l[hh] + sum;
      m[hh] = m_next;
    }

    // O moves to the new max; P, rounded to bf16 (the reference's
    // p.astype(v.dtype)), becomes wgmma's A fragment: chunk kk of 16 keys
    // is elements 8 kk .. 8 kk + 7; then O += P V.
#pragma unroll
    for (int j8 = 0; j8 < D / 8; ++j8) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        o[4 * j8 + 2 * hh] *= alpha[hh];
        o[4 * j8 + 2 * hh + 1] *= alpha[hh];
      }
    }
    to_a_fragments(pa, sc);
    mbar_wait(full_v + 8 * s, par);
    reg_fence(o);
    reg_fence(pa);
    wg_fence();
    pv_product<D>(o, pa, sV + s * Gm::KV_BYTES);
    wg_wait<0>();
    reg_fence(o);
    mbar_arrive(empty_v + 8 * s);
  }

  // Epilogue: out = O / l in bf16, lse in natural-log units.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int ql = qr0 + row + 8 * hh;
    if (ql >= Tq) continue;
    const float lse_v = lt > 0.f ? ((m[hh] <= NEG / 2 ? 0.f : m[hh]) + log2f(lt)) * LN2 : NEG;
    const float inv = 1.f / (lt == 0.f ? 1.f : lt);
    if (lane % 4 == 0) lse[((long)b * H + h) * Tq + ql] = lse_v;
    __nv_bfloat16* orow = out + (((long)b * Tq + ql) * H + h) * D;
#pragma unroll
    for (int j8 = 0; j8 < D / 8; ++j8) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j8 + cq) = __floats2bfloat162_rn(
          o[4 * j8 + 2 * hh] * inv, o[4 * j8 + 2 * hh + 1] * inv);
    }
  }
}

// ------------------------------------------------------------------ host ---

template <int D, bool PACKED>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           const int32_t* seg_q, const int32_t* seg_k, int32_t* ranges,
           unsigned long long* visited, int B, int Tq, int Tk, int H, int Hkv, int q_off,
           int k_off, int causal, float scale, cudaStream_t st) {
  using Gm = Geo<D>;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_TENSOR_MAP;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, enc, q, H, D, Tq, B, Gm::COLS, BQ) ||
      !make_map(&tm_k, enc, k, Hkv, D, Tk, B, Gm::COLS, BK) ||
      !make_map(&tm_v, enc, v, Hkv, D, Tk, B, Gm::COLS, BK))
    return ERR_TENSOR_MAP;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_sm90_kernel<D, PACKED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, Gm::SMEM);
  if (e != cudaSuccess) return (int)e;
  int32_t *q_rng = nullptr, *k_rng = nullptr;
  if constexpr (PACKED) {
    const int nq_g = (Tq + G - 1) / G;
    q_rng = ranges;
    k_rng = ranges + 2 * (long)B * nq_g;
    const int rc = id_ranges(seg_q, seg_k, B, Tq, Tk, G, BK, q_rng, k_rng, st);
    if (rc != 0) return rc;
  }
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_sm90_kernel<D, PACKED><<<grid, NT, Gm::SMEM, st>>>(
      tm_q, tm_k, tm_v, (__nv_bfloat16*)out, lse, seg_q, seg_k, q_rng, k_rng, visited, Tq, Tk,
      H, Hkv, q_off, k_off, causal, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <bool PACKED>
int dispatch(const void* q, const void* k, const void* v, void* out, float* lse,
             const int32_t* seg_q, const int32_t* seg_k, int32_t* ranges,
             unsigned long long* visited, int B, int Tq, int Tk, int H, int Hkv, int D,
             int q_off, int k_off, int causal, float scale, cudaStream_t st) {
#define DDL_SM90_CASE(DIM)                                                                \
  if (D == DIM)                                                                         \
    return launch<DIM, PACKED>(q, k, v, out, lse, seg_q, seg_k, ranges, visited, B, Tq, \
                               Tk, H, Hkv, q_off, k_off, causal, scale, st);
  DDL_SM90_CASE(16)
  DDL_SM90_CASE(32)
  DDL_SM90_CASE(64)
  DDL_SM90_CASE(128)
#undef DDL_SM90_CASE
  return ERR_BAD_ARGS;
}

}  // namespace

// Launches K1 (seg_q == NULL) or K4 (seg_q, seg_k (B, Tq) / (B, Tk) int32,
// with `ranges` an int32 scratch of 2 * B * (ceil(Tq / 64) + ceil(Tk / 128))
// values for the pre-pass) on `stream`, over bf16 q (B, Tq, H, D) and k, v
// (B, Tk, Hkv, D), all contiguous and 16-byte aligned.  `visited`, when not
// NULL, gains the number of key tiles loaded over every (b, h, query tile).
// Returns cudaGetLastError() (0 on success), -1 for arguments it does not
// take, or -2 if the CUDA driver's tensor-map encoder is missing or refuses
// a map.
extern "C" int ddl_flash_fwd_sm90(const void* q, const void* k, const void* v, void* out,
                                  float* lse, const int32_t* seg_q, const int32_t* seg_k,
                                  int32_t* ranges, unsigned long long* visited, int B, int Tq,
                                  int Tk, int H, int Hkv, int D, int q_off, int k_off,
                                  int causal, float scale, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || Hkv < 1 || H % Hkv != 0 || B > 65535 || H > 65535 ||
      misaligned(q) || misaligned(k) || misaligned(v) || misaligned(out) ||
      (seg_q == nullptr) != (seg_k == nullptr) || (seg_q != nullptr && ranges == nullptr))
    return ERR_BAD_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  if (seg_q != nullptr)
    return dispatch<true>(q, k, v, out, lse, seg_q, seg_k, ranges, visited, B, Tq, Tk, H,
                          Hkv, D, q_off, k_off, causal, scale, st);
  return dispatch<false>(q, k, v, out, lse, nullptr, nullptr, nullptr, visited, B, Tq, Tk,
                         H, Hkv, D, q_off, k_off, causal, scale, st);
}
