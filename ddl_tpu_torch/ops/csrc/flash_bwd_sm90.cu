// The bf16 flash-attention backward for NVIDIA Hopper (sm_90a): the dK/dV
// kernel and, further down, the dQ kernel.  TMA copies into a
// shared-memory ring, wgmma on the tensor cores with the accumulators in
// registers (dK and dV of a whole GQA group; dQ of a query tile), and, for
// packed documents, no work on tiles whose document ids cannot meet. Plain
// C interface, loaded from Python with ctypes
// (ddl_tpu_torch/ops/flash_attention.py builds and binds it); the Hopper
// helpers come from sm90.cuh, shared with the forward.
//
// The dK/dV kernel.
// Replaces, for bf16 inputs, the Pallas TPU kernels
//   K3 <- ddl_tpu/ops/flash_attention.py:287 _dkv_kernel      (PACKED = false)
//   K6 <- ddl_tpu/ops/flash_attention.py:347 _dkv_kernel_seg  (PACKED = true)
// (both launched by the pallas_call at :571).  fp32 inputs keep the exact
// FMA template of flash_attention.cu: TF32 would not hold the reference's
// fp32 precision.  For each key row k of KV head hk:
//   dV[k] = sum_{h in group(hk)} sum_q P[q, k] dO[q],
//   dK[k] = sum_h sum_q dS[q, k] Q[q],
// with P = exp(S scale - lse), dS = P (dP - delta + dlse) scale, dP = dO V^T;
// the reference's masks (causal on global positions, K6's seg_q != seg_k,
// rows with lse <= -5e29 dead) and rounding points (P rounded to bf16
// before the dV product, dS before the dK product, fp32 accumulation).  The
// group sum runs in fp32 inside the kernel and rounds once (the port's
// deliberate difference: the reference rounds each head's dK/dV to bf16 and
// sums the group outside).
//
// What bounds it on this card.  At the main path's shape (B = 4, T = 2048,
// H = 32, Hkv = 8, D = 128, causal) it does 8 * D flops on each of the
// B * H * T * (T + 1) / 2 causal pairs (four products: S, dP, dV, dK),
// 275 GFLOP, while it must move only ~205 MB (q, dO, k, v and three row
// statistics in, dk and dv out): 0.278 ms at 989 TFLOP/s against 0.061 ms at
// 3.35 TB/s, so it is bound by operations, and only the tensor cores reach
// that rate.  On packed documents (~19 % of causal pairs in-segment at the
// slice's document lengths) the in-segment work falls under the byte time:
// K6 is bound by bytes, and what it can gain is work skipped.
//
// What the design does about it:
// - One block owns one (b, KV head hk, key tile of BK = 128 rows); blocks
//   with the most query tiles (the first key tiles) are scheduled first.
//   Two consumer warpgroups each own 64 of the 128 key rows; thread 0 also
//   issues the copies, one tile ahead of its warpgroup (no producer
//   warpgroup: see Registers).  K and V load once per block.  The block then loops over the rep query
//   heads of hk and, for each, over the query tiles of BQ = 64 rows from the
//   causal diagonal on: (Q, dO) tiles with their 64 row terms (lse in log2
//   units, dlse - delta) and, for K6, their 64 query ids go into a ring of
//   STAGES buffers with full/empty mbarriers.  K, V, Q and dO are read
//   straight from the (B, T, heads, D) layouts through 3-D tensor maps,
//   whose bounds zero-fill rows past T; the row terms and ids are 1-D bulk
//   copies from a padded table a pre-pass writes.
// - Keys are wgmma's M dimension, so every operand lands where the next
//   product wants it: S^T = K Q^T and dP^T = V dO^T (wgmma.m64n64k16, K / V
//   and Q / dO K-major in shared memory), then P^T and dS^T on the
//   accumulator fragments, repacked to bf16 A fragments in registers, and
//   dV += P^T dO, dK += dS^T Q with the same dO / Q tiles read MN-major.
//   P and dS never touch shared memory; dK and dV stay in fp32 registers
//   across all rep heads, and each block stores them once (no atomics, so
//   the result is deterministic).
// - Registers: a consumer thread holds dK and dV (D / 2 each), S^T and dP^T
//   (32 each) and two A fragments, ~224 at D = 128, over the 168 a thread
//   of 384 gets.  A producer warpgroup with setmaxnreg (40 / 232 or
//   24 / 240, the role branch warp-uniform) did not lift ptxas's cap: it
//   reported C7512 (every wgmma serialized) and spills at D = 128.  At
//   256 threads a thread gets 255 registers, and ptxas keeps the wgmma
//   pipeline with no spill at any head dim; K6's loop-invariant key ids and
//   ranges sit in shared memory, not in registers.
// - Rows with no key (lse <= -5e29) and query rows past Tq carry lse = +inf
//   in the row table, so their P is exp2(-inf) = 0 with no mask; key rows
//   past Tk only feed accumulator rows that are never stored.  Only tiles
//   that cross the causal diagonal, or (K6) whose ids are not all one
//   document, build a mask; the rest exponentiate unmasked.  A consumer
//   warpgroup skips a tile that is dead for all its keys.
// - K6's tile skip: a pre-pass writes the [min, max] of the ids over each
//   64-row query tile and each 64-row key granule.  A query tile whose id
//   range misses the key tile's cannot hold a same-document pair, so
//   neither the producer loads it nor the consumers multiply it: the
//   forward's rule transposed (live_tiles_dkv() in the Python module states
//   it).  Given a device counter, the producer adds the number of query
//   tiles it loaded: the skip measured.

#include "sm90.cuh"

namespace {

constexpr int BQ = 64;                 // query rows per tile
constexpr int BK = 128;                // key rows per block
constexpr int KG = 64;                 // key rows per consumer warpgroup
constexpr int STAGES = 2;              // ring depth: (Q, dO) of dK/dV, (K, V) of dQ
constexpr int NT = 256;                // two consumer warpgroups
constexpr int ROW_BYTES = BQ * 8;      // a tile's row terms (float2)
constexpr int ID_BYTES = BQ * 4;       // a tile's query ids

template <int D>
struct Geo {
  using QT = Tile<D, BQ>;   // Q and dO tiles
  using KT = Tile<D, BK>;   // K and V tiles
  // K, V, the (Q, dO) ring, each stage's row terms and ids, 1 + 2 * STAGES
  // mbarriers, K6's key-id ranges of the two warpgroups and the block's key
  // ids, and slack to align the base to the 1024 B the swizzle patterns
  // repeat at.
  static constexpr int SMEM = 2 * KT::BYTES + STAGES * (2 * QT::BYTES + ROW_BYTES + ID_BYTES) +
                              8 * (1 + 2 * STAGES) + 8 * (BK / KG) + 4 * BK + 1024;
};

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// The row terms of query row t (of Tq) at row r of the (B, H, Tq)
// statistics: (lse * log2 e, dlse - delta), or (+inf, 0) for a row with no
// key or past Tq, whose P is then exp2(-inf) = 0 with no mask.
__device__ __forceinline__ float2 row_term(const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           const float* __restrict__ dlse, long r, int t,
                                           int Tq) {
  const float l = t < Tq ? lse[r] : NEG;
  return l > NEG / 2 ? make_float2(l * LOG2E, dlse[r] - delta[r]) : make_float2(pos_inf(), 0.f);
}

// Pre-pass of the dK/dV kernel: the row terms of every (b, h, query row),
// padded to Tqp = BQ * ceil(Tq / BQ) rows per (b, h).  K6 also gets the
// query ids padded the same way.  grid (ceil(Tq / BQ), H, B), BQ threads.
__global__ void __launch_bounds__(BQ)
row_terms_kernel(const float* __restrict__ lse, const float* __restrict__ delta,
                 const float* __restrict__ dlse, const int32_t* __restrict__ seg_q,
                 float2* __restrict__ rows, int32_t* __restrict__ qids, int Tq, int H,
                 int Tqp) {
  const int t = blockIdx.x * BQ + threadIdx.x, h = blockIdx.y, b = blockIdx.z;
  rows[((long)b * H + h) * Tqp + t] =
      row_term(lse, delta, dlse, ((long)b * H + h) * Tq + t, t, Tq);
  if (qids != nullptr && h == 0) qids[(long)b * Tqp + t] = t < Tq ? seg_q[(long)b * Tq + t] : 0;
}

// grid (ceil(Tk / BK) * Hkv * B), NT threads; block x is key tile x / (Hkv *
// B), so the tiles with the most query tiles run first.  dk, dv (B, Tk,
// Hkv, D) bf16.  rows / qids: the pre-pass's tables; PACKED (K6): q_rng
// (B, ceil(Tq / BQ), 2), k_rng (B, ceil(Tk / KG), 2) from id_range_kernel
// and seg_k (B, Tk).  `visited`, when not null, gains the number of query
// tiles the block loaded.
template <int D, bool PACKED>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float2* __restrict__ rows, const int32_t* __restrict__ qids,
                          const int32_t* __restrict__ q_rng, const int32_t* __restrict__ k_rng,
                          const int32_t* __restrict__ seg_k, __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, unsigned long long* __restrict__ visited,
                          int B, int Tq, int Tk, int H, int Hkv, int q_off, int k_off,
                          int causal, float scale, float scale_log2) {
  using QT = typename Geo<D>::QT;
  using KT = typename Geo<D>::KT;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u;
  const uint32_t sV = sK + KT::BYTES;
  const uint32_t sQ = sV + KT::BYTES;               // STAGES Q tiles
  const uint32_t sO = sQ + STAGES * QT::BYTES;      // STAGES dO tiles
  const uint32_t sR = sO + STAGES * QT::BYTES;      // STAGES x BQ row terms
  const uint32_t sI = sR + STAGES * ROW_BYTES;      // STAGES x BQ query ids (K6)
  const uint32_t bar_kv = sI + STAGES * ID_BYTES;   // K and V landed
  const uint32_t full = bar_kv + 8;                 // a stage landed
  const uint32_t empty = full + 8 * STAGES;         // a stage consumed
  // K6: each warpgroup's key-id range and the block's key ids, kept in
  // shared memory rather than in registers through the loop.
  int2* const key_rng = reinterpret_cast<int2*>(smem_raw + (empty + 8 * STAGES - raw));
  int* const key_ids = reinterpret_cast<int*>(key_rng + BK / KG);

  const int j = blockIdx.x / (Hkv * B), hk = blockIdx.x % Hkv, b = blockIdx.x / Hkv % B;
  const int k0 = j * BK, rep = H / Hkv;
  const int nqb = (Tq + BQ - 1) / BQ, nkg = (Tk + KG - 1) / KG;
  // First query tile whose rows can see this key tile (the diagonal).
  int i0 = 0;
  if (causal) {
    const int need = k_off + k0 - q_off - BQ + 1;  // q0 >= need
    i0 = need <= 0 ? 0 : (need + BQ - 1) / BQ;
  }
  const int nq = nqb > i0 ? nqb - i0 : 0;

  if constexpr (PACKED) {
    if (threadIdx.x < BK / KG) {  // a warpgroup's granule, empty past Tk
      const int g = k0 / KG + threadIdx.x;
      key_rng[threadIdx.x] = g < nkg ? id_range(k_rng, b, nkg, g) : make_int2(INT_MAX, INT_MIN);
    }
    if (threadIdx.x < BK) {
      const int kl = k0 + threadIdx.x;
      key_ids[threadIdx.x] = kl < Tk ? seg_k[(long)b * Tk + kl] : 0;
    }
  }
  // Whether query tile i's id range misses the key tile's (the union of its
  // warpgroups' ranges): K6 skips it.
  auto skipped = [&](int i) {
    if constexpr (PACKED) {
      const int2 r = id_range(q_rng, b, nqb, i), g0 = key_rng[0], g1 = key_rng[1];
      return r.x > max(g0.y, g1.y) || min(g0.x, g1.x) > r.y;
    } else {
      return false;
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NT);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 issues the copies: K and V once, then each live (head, query
  // tile) of the loop into the ring, up to `upto` tiles loaded.  A stage is
  // refilled once both warpgroups have released it.
  const int Tqp = nqb * BQ;
  int pt = 0, loaded = 0;  // thread 0's cursor over the loop, tiles loaded
  auto produce = [&](int upto) {
    while (loaded < upto && pt < rep * nq) {
      const int h = hk * rep + pt / nq, i = i0 + pt % nq;
      ++pt;
      if (skipped(i)) continue;
      const int s = loaded % STAGES;
      if (loaded >= STAGES) mbar_wait(empty + 8 * s, (loaded / STAGES - 1) & 1);
      const uint32_t bar = full + 8 * s;
      mbar_expect_tx(bar, 2 * QT::BYTES + ROW_BYTES + (PACKED ? ID_BYTES : 0));
#pragma unroll
      for (int c = 0; c < QT::NATOM; ++c) {
        tma_load(sQ + s * QT::BYTES + c * QT::ATOM, &tm_q, bar, h * D + c * QT::COLS, i * BQ,
                 b);
        tma_load(sO + s * QT::BYTES + c * QT::ATOM, &tm_do, bar, h * D + c * QT::COLS, i * BQ,
                 b);
      }
      bulk_load(sR + s * ROW_BYTES, rows + ((long)b * H + h) * Tqp + i * BQ, ROW_BYTES, bar);
      if constexpr (PACKED)
        bulk_load(sI + s * ID_BYTES, qids + (long)b * Tqp + i * BQ, ID_BYTES, bar);
      ++loaded;
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_kv, 2 * KT::BYTES);
#pragma unroll
    for (int c = 0; c < KT::NATOM; ++c) {
      tma_load(sK + c * KT::ATOM, &tm_k, bar_kv, hk * D + c * KT::COLS, k0, b);
      tma_load(sV + c * KT::ATOM, &tm_v, bar_kv, hk * D + c * KT::COLS, k0, b);
    }
    produce(STAGES);
  }

  const int wg = threadIdx.x / 128;             // consumer warpgroup
  const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + lane / 4;         // keys row and row + 8 of its 64
  const int cq = 2 * (lane % 4);                // first of this thread's columns
  const int kw = k0 + KG * wg;                  // the warpgroup's first key
  const uint32_t ka = sK + KG * wg * KT::ROWB;  // its 64 rows of K
  const uint32_t va = sV + KG * wg * KT::ROWB;  // and of V
  const float2* row_terms = reinterpret_cast<const float2*>(smem_raw + (sR - raw));
  const int* q_ids = reinterpret_cast<const int*>(smem_raw + (sI - raw));

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dka[x] = dva[x] = 0.f;

  mbar_wait(bar_kv, 0);
  int it = 0;
  for (int t = 0; t < rep * nq; ++t) {
    const int q0 = (i0 + t % nq) * BQ;
    if (skipped(q0 / BQ)) continue;  // thread 0 skipped it too
    bool dead = kw >= Tk || (causal && k_off + kw > q_off + q0 + BQ - 1);
    bool ids_differ = false;
    if constexpr (PACKED) {
      const int2 r = id_range(q_rng, b, nqb, q0 / BQ), w = key_rng[wg];
      dead |= r.x > w.y || w.x > r.y;
      ids_differ = !(r.x == r.y && w.x == w.y && r.x == w.x);
    }
    const int s = it % STAGES;
    const uint32_t par = (it / STAGES) & 1;
    if (threadIdx.x == 0) produce(it + STAGES);  // tile it + 1 into the stage of it - 1
    ++it;
    mbar_wait(full + 8 * s, par);
    if (dead) {  // no key of this warpgroup meets a query of the tile
      mbar_arrive(empty + 8 * s);
      continue;
    }
    const uint32_t qs = sQ + s * QT::BYTES, os = sO + s * QT::BYTES;

    // S^T = K Q^T and dP^T = V dO^T over D / 16 steps of 16 columns.
    float st[32], dpt[32];
    reg_fence(st);
    reg_fence(dpt);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(st, KT::kmajor(ka, kk), QT::kmajor(qs, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dpt, KT::kmajor(va, kk), QT::kmajor(os, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    reg_fence(st);
    reg_fence(dpt);

    // P^T and dS^T on the fragments.  Element x = 4 * j8 + 2 * hh + e is
    // key row `row + 8 * hh`, query column 8 * j8 + cq + e.  Only tiles
    // that cross the diagonal or hold more than one id build a mask.
    const bool masked = (causal && k_off + kw + KG - 1 > q_off + q0) || ids_differ;
    const float2* rt_s = row_terms + s * BQ;
    int sk[2] = {0, 0};  // K6: this thread's two key ids
    if constexpr (PACKED) {
      if (ids_differ) {
        sk[0] = key_ids[KG * wg + row];
        sk[1] = key_ids[KG * wg + row + 8];
      }
    }
#pragma unroll
    for (int j8 = 0; j8 < BQ / 8; ++j8) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j8 + cq + e;
        const float2 rt = rt_s[col];
        int qid = 0;
        if constexpr (PACKED) {
          if (ids_differ) qid = q_ids[s * BQ + col];
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int x = 4 * j8 + 2 * hh + e;
          float p = ex2(fmaf(st[x], scale_log2, -rt.x));
          if (masked) {
            const int kl = kw + row + 8 * hh;
            if ((causal && k_off + kl > q_off + q0 + col) ||
                (PACKED && ids_differ && sk[hh] != qid))
              p = 0.f;
          }
          st[x] = p;
          dpt[x] = p * (dpt[x] + rt.y) * scale;
        }
      }
    }

    // P and dS rounded to bf16 (the reference's astype), as wgmma's A
    // fragments; dV += P^T dO and dK += dS^T Q, dO and Q MN-major.
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    to_a_fragments(pa, st);
    to_a_fragments(da, dpt);
    reg_fence(pa);
    reg_fence(da);
    reg_fence(dva);
    reg_fence(dka);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) mma_rs<D>(dva, pa[kk], QT::mnmajor(os, kk));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) mma_rs<D>(dka, da[kk], QT::mnmajor(qs, kk));
    wg_commit();
    wg_wait<0>();
    reg_fence(dva);
    reg_fence(dka);
    mbar_arrive(empty + 8 * s);
  }

  // Epilogue: the group's dK and dV, rounded once to bf16.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kl = kw + row + 8 * hh;
    if (kl >= Tk) continue;
    const long o = (((long)b * Tk + kl) * Hkv + hk) * D;
#pragma unroll
    for (int j8 = 0; j8 < D / 8; ++j8) {
      const int x = 4 * j8 + 2 * hh;
      *reinterpret_cast<__nv_bfloat162*>(dk + o + 8 * j8 + cq) =
          __floats2bfloat162_rn(dka[x], dka[x + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + o + 8 * j8 + cq) =
          __floats2bfloat162_rn(dva[x], dva[x + 1]);
    }
  }
  if (threadIdx.x == 0 && visited != nullptr) atomicAdd(visited, (unsigned long long)loaded);
}

// ------------------------------------------------------------------- dQ ---
//
// Replaces, for bf16 inputs, the Pallas TPU kernels
//   K2 <- ddl_tpu/ops/flash_attention.py:251 _dq_kernel      (PACKED = false)
//   K5 <- ddl_tpu/ops/flash_attention.py:340 _dq_kernel_seg  (PACKED = true)
// (both launched by the pallas_call at :536).  For each query row q of head h:
//   dQ[q] = sum_k dS[q, k] K[k],
// dS, P and dP as above, under the same masks, with dS rounded to bf16
// before the dS K product, fp32 accumulation, and dQ rounded once at the
// store.
//
// What bounds it: 6 * D flops on each causal pair (S, dP, dQ), 206 GFLOP at
// the main path's shape against ~238 MB to move (q, dO, k, v and three row
// statistics in, dq out): 0.209 ms at 989 TFLOP/s against 0.071 ms at
// 3.35 TB/s, bound by operations; on packed documents
// the in-segment work falls under the byte time, as for K6.
//
// What the design does about it:
// - One block owns one (b, query head h, query tile of DQ_BQ = 128 rows);
//   two consumer warpgroups each own 64 of the rows, and thread 0 also
//   issues the copies (no producer warpgroup, as in the dK/dV kernel).  Q
//   and dO load once per block; the key tiles of KV head h / rep (DQ_BK =
//   128 rows of K and V, and K5's 128 key ids) come through a ring of
//   STAGES buffers with full/empty mbarriers.  Blocks with the most key
//   tiles (the last query tiles) run first, and the heads of one KV group
//   are neighbouring blocks, so they read the same K/V tiles out of L2.
// - Queries are wgmma's M dimension: S = Q K^T and dP = dO V^T
//   (wgmma.m64n128k16, Q / dO and K / V K-major), dS on the accumulator
//   fragments, repacked to bf16 A fragments in registers, and dQ += dS K
//   with the same K tile read MN-major.  dQ stays in fp32 registers over
//   the whole key loop and is stored once: no atomics, so the result is
//   deterministic.
// - Registers: dQ (D / 2), S and dP (64 each) and the dS fragments, ~220 a
//   thread at D = 128; 256 threads give 255.
// - A thread's two query rows are fixed for the whole loop, so it reads
//   their lse, delta and dlse once (no row-terms pre-pass): lse in log2
//   units and dlse - delta, or lse = +inf for a row with no key or past
//   Tq, whose P is then exp2(-inf) = 0 with no mask (dq = 0 exactly).
//   Only tiles that cross the causal diagonal, hold keys past Tk, or (K5)
//   whose ids are not all one document build a mask; the rest
//   exponentiate unmasked.  A warpgroup skips a tile dead for all its rows.
// - K5's tile skip: a key tile whose id range misses the query tile's
//   cannot hold a same-document pair, so it is neither loaded nor
//   multiplied: the forward's rule at the forward's 128 x 128 tiles
//   (live_tiles() in the Python module).  Its key ids come padded by a
//   pre-pass, one aligned bulk copy beside K and V.  Given a device
//   counter, thread 0 adds the number of key tiles the block loaded.

constexpr int DQ_BQ = 128;            // query rows per dQ block
constexpr int DQ_BK = 128;            // key rows per tile
constexpr int DQ_G = 64;              // query rows per consumer warpgroup
constexpr int KID_BYTES = DQ_BK * 4;  // a tile's key ids (K5)

template <int D>
struct DqGeo {
  using QT = Tile<D, DQ_BQ>;  // Q and dO tiles
  using KT = Tile<D, DQ_BK>;  // K and V tiles
  // Q, dO, the (K, V) ring with each stage's key ids, 1 + 2 * STAGES
  // mbarriers, and slack to align the base to 1024 B.
  static constexpr int SMEM =
      2 * QT::BYTES + STAGES * (2 * KT::BYTES + KID_BYTES) + 8 * (1 + 2 * STAGES) + 1024;
};

// Pre-pass of K5: the key ids padded to Tp = DQ_BK * ceil(T / DQ_BK) per
// batch row, so that a tile's ids are one aligned bulk copy.  grid (Tp /
// DQ_BK, B), DQ_BK threads.
__global__ void __launch_bounds__(DQ_BK)
pad_ids_kernel(const int32_t* __restrict__ seg, int T, int Tp, int32_t* __restrict__ out) {
  const int t = blockIdx.x * DQ_BK + threadIdx.x, b = blockIdx.y;
  out[(long)b * Tp + t] = t < T ? seg[(long)b * T + t] : 0;
}

// grid (ceil(Tq / DQ_BQ) * H * B), NT threads; block x is query tile
// nqb - 1 - x / (H * B) of head x % H in batch row x / H % B.  dq (B, Tq,
// H, D) bf16; lse, delta, dlse (B, H, Tq) fp32.  PACKED (K5): seg_q (B,
// Tq), q_rng (B, ceil(Tq / DQ_G), 2) and k_rng (B, ceil(Tk / DQ_BK), 2)
// from id_range_kernel, kids (B, Tkp) from pad_ids_kernel.  `visited`,
// when not null, gains the number of key tiles the block loaded.
template <int D, bool PACKED>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const float* __restrict__ dlse, const int32_t* __restrict__ seg_q,
                         const int32_t* __restrict__ q_rng, const int32_t* __restrict__ k_rng,
                         const int32_t* __restrict__ kids, __nv_bfloat16* __restrict__ dq,
                         unsigned long long* __restrict__ visited, int B, int Tq, int Tk,
                         int H, int Hkv, int q_off, int k_off, int causal, float scale,
                         float scale_log2) {
  using QT = typename DqGeo<D>::QT;
  using KT = typename DqGeo<D>::KT;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;
  const uint32_t sO = sQ + QT::BYTES;
  const uint32_t sK = sO + QT::BYTES;              // STAGES K tiles
  const uint32_t sV = sK + STAGES * KT::BYTES;     // STAGES V tiles
  const uint32_t sI = sV + STAGES * KT::BYTES;     // STAGES x DQ_BK key ids (K5)
  const uint32_t bar_q = sI + STAGES * KID_BYTES;  // Q and dO landed
  const uint32_t full = bar_q + 8;                 // a stage landed
  const uint32_t empty = full + 8 * STAGES;        // a stage consumed

  const int nqb = (Tq + DQ_BQ - 1) / DQ_BQ;
  const int q0 = (nqb - 1 - (int)(blockIdx.x / (H * B))) * DQ_BQ;  // most keys first
  const int h = blockIdx.x % H, b = blockIdx.x / H % B;
  const int hk = h / (H / Hkv);
  const int nkt = (Tk + DQ_BK - 1) / DQ_BK, nqg = (Tq + DQ_G - 1) / DQ_G;
  int nkb = nkt;  // key tiles of the causal loop
  if (causal) {
    const int lim = q_off + q0 + DQ_BQ - 1 - k_off;  // last key position seen
    nkb = lim < 0 ? 0 : min(nkt, lim / DQ_BK + 1);
  }

  // The block's query-id range (its granules that exist): K5 skips a key
  // tile outside it.
  int bq_lo = INT_MAX, bq_hi = INT_MIN;
  if constexpr (PACKED) {
    for (int g = q0 / DQ_G; g < q0 / DQ_G + DQ_BQ / DQ_G && g < nqg; ++g) {
      const int2 r = id_range(q_rng, b, nqg, g);
      bq_lo = min(bq_lo, r.x);
      bq_hi = max(bq_hi, r.y);
    }
  }
  auto skipped = [&](int j) {
    if constexpr (PACKED) {
      const int2 r = id_range(k_rng, b, nkt, j);
      return r.x > bq_hi || bq_lo > r.y;
    } else {
      return false;
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, NT);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 issues the copies: Q and dO once, then each live key tile of
  // the loop into the ring, up to `upto` tiles loaded.  A stage is refilled
  // once both warpgroups have released it.
  int pj = 0, loaded = 0;  // thread 0's cursor over the key tiles, tiles loaded
  auto produce = [&](int upto) {
    while (loaded < upto && pj < nkb) {
      const int j = pj++;
      if (skipped(j)) continue;
      const int s = loaded % STAGES;
      if (loaded >= STAGES) mbar_wait(empty + 8 * s, (loaded / STAGES - 1) & 1);
      const uint32_t bar = full + 8 * s;
      mbar_expect_tx(bar, 2 * KT::BYTES + (PACKED ? KID_BYTES : 0));
#pragma unroll
      for (int c = 0; c < KT::NATOM; ++c) {
        tma_load(sK + s * KT::BYTES + c * KT::ATOM, &tm_k, bar, hk * D + c * KT::COLS,
                 j * DQ_BK, b);
        tma_load(sV + s * KT::BYTES + c * KT::ATOM, &tm_v, bar, hk * D + c * KT::COLS,
                 j * DQ_BK, b);
      }
      if constexpr (PACKED)
        bulk_load(sI + s * KID_BYTES, kids + ((long)b * nkt + j) * DQ_BK, KID_BYTES, bar);
      ++loaded;
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_q, 2 * QT::BYTES);
#pragma unroll
    for (int c = 0; c < QT::NATOM; ++c) {
      tma_load(sQ + c * QT::ATOM, &tm_q, bar_q, h * D + c * QT::COLS, q0, b);
      tma_load(sO + c * QT::ATOM, &tm_do, bar_q, h * D + c * QT::COLS, q0, b);
    }
    produce(STAGES);
  }

  const int wg = threadIdx.x / 128;               // consumer warpgroup
  const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + lane / 4;           // rows row and row + 8 of its 64
  const int cq = 2 * (lane % 4);                  // first of this thread's columns
  const int qr0 = q0 + DQ_G * wg;                 // the warpgroup's first query row
  const uint32_t qa = sQ + DQ_G * wg * QT::ROWB;  // its 64 rows of Q
  const uint32_t oa = sO + DQ_G * wg * QT::ROWB;  // and of dO
  const int* key_ids = reinterpret_cast<const int*>(smem_raw + (sI - raw));

  // This thread's two rows' terms; K5 also needs their ids and the
  // warpgroup's id range.
  float2 rt[2];
  int sq[2] = {0, 0}, wq_lo = 0, wq_hi = 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int ql = qr0 + row + 8 * hh;
    rt[hh] = row_term(lse, delta, dlse, ((long)b * H + h) * Tq + ql, ql, Tq);
    if constexpr (PACKED) sq[hh] = ql < Tq ? seg_q[(long)b * Tq + ql] : 0;
  }
  if constexpr (PACKED) {
    if (qr0 < Tq) {
      const int2 r = id_range(q_rng, b, nqg, qr0 / DQ_G);
      wq_lo = r.x;
      wq_hi = r.y;
    }
  }

  float dqa[D / 2];
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dqa[x] = 0.f;

  mbar_wait(bar_q, 0);
  int it = 0;
  for (int j = 0; j < nkb; ++j) {
    if (skipped(j)) continue;  // thread 0 skipped it too
    const int k0 = j * DQ_BK;
    bool dead = qr0 >= Tq || (causal && k_off + k0 > q_off + qr0 + DQ_G - 1);
    bool ids_differ = false;
    if constexpr (PACKED) {
      const int2 r = id_range(k_rng, b, nkt, j);
      dead |= r.x > wq_hi || wq_lo > r.y;
      ids_differ = !(r.x == r.y && wq_lo == wq_hi && r.x == wq_lo);
    }
    const int s = it % STAGES;
    const uint32_t par = (it / STAGES) & 1;
    if (threadIdx.x == 0) produce(it + STAGES);  // tile it + 1 into the stage of it - 1
    ++it;
    mbar_wait(full + 8 * s, par);
    if (dead) {  // no row of this warpgroup sees a key of the tile
      mbar_arrive(empty + 8 * s);
      continue;
    }
    const uint32_t ka = sK + s * KT::BYTES, va = sV + s * KT::BYTES;

    // S = Q K^T and dP = dO V^T over D / 16 steps of 16 columns.
    float st[DQ_BK / 2], dpt[DQ_BK / 2];
    reg_fence(st);
    reg_fence(dpt);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n128(st, QT::kmajor(qa, kk), KT::kmajor(ka, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n128(dpt, QT::kmajor(oa, kk), KT::kmajor(va, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    reg_fence(st);
    reg_fence(dpt);

    // dS on the fragments.  Element x = 4 * j8 + 2 * hh + e is query row
    // `row + 8 * hh`, key column 8 * j8 + cq + e.  Only tiles that cross
    // the diagonal, hold keys past Tk or more than one id build a mask.
    const bool masked =
        (causal && k_off + k0 + DQ_BK - 1 > q_off + qr0) || k0 + DQ_BK > Tk || ids_differ;
    const int* kid_s = key_ids + s * DQ_BK;
#pragma unroll
    for (int j8 = 0; j8 < DQ_BK / 8; ++j8) {
      int2 sk = make_int2(0, 0);
      if constexpr (PACKED) {
        if (ids_differ) sk = *reinterpret_cast<const int2*>(kid_s + 8 * j8 + cq);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kl = k0 + 8 * j8 + cq + e;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int x = 4 * j8 + 2 * hh + e;
          float p = ex2(fmaf(st[x], scale_log2, -rt[hh].x));
          if (masked) {
            const int ql = qr0 + row + 8 * hh;
            if (kl >= Tk || (causal && k_off + kl > q_off + ql) ||
                (PACKED && ids_differ && (e ? sk.y : sk.x) != sq[hh]))
              p = 0.f;
          }
          dpt[x] = p * (dpt[x] + rt[hh].y) * scale;
        }
      }
    }

    // dS rounded to bf16 (the reference's astype), as wgmma's A fragments;
    // dQ += dS K, K MN-major.
    uint32_t da[DQ_BK / 16][4];
    to_a_fragments(da, dpt);
    reg_fence(da);
    reg_fence(dqa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DQ_BK / 16; ++kk) mma_rs<D>(dqa, da[kk], KT::mnmajor(ka, kk));
    wg_commit();
    wg_wait<0>();
    reg_fence(dqa);
    mbar_arrive(empty + 8 * s);
  }

  // Epilogue: dQ rounded once to bf16.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int ql = qr0 + row + 8 * hh;
    if (ql >= Tq) continue;
    __nv_bfloat16* drow = dq + (((long)b * Tq + ql) * H + h) * D;
#pragma unroll
    for (int j8 = 0; j8 < D / 8; ++j8) {
      const int x = 4 * j8 + 2 * hh;
      *reinterpret_cast<__nv_bfloat162*>(drow + 8 * j8 + cq) =
          __floats2bfloat162_rn(dqa[x], dqa[x + 1]);
    }
  }
  if (threadIdx.x == 0 && visited != nullptr) atomicAdd(visited, (unsigned long long)loaded);
}

// ------------------------------------------------------------------ host ---

// Scratch of one launch: the row table (B * H * Tqp float2) and, for K6,
// the padded query ids (B * Tqp int32) and the id ranges (B * (ceil(Tq /
// BQ) + ceil(Tk / KG)) int2).
long long scratch_bytes(int B, int Tq, int Tk, int H, bool packed) {
  const long long nqb = (Tq + BQ - 1) / BQ, Tqp = nqb * BQ, nkg = (Tk + KG - 1) / KG;
  long long n = 8ll * B * H * Tqp;
  if (packed) n += 4ll * B * Tqp + 8ll * B * (nqb + nkg);
  return n;
}

template <int D, bool PACKED>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, const float* dlse, void* dk, void* dv, const int32_t* seg_q,
           const int32_t* seg_k, void* scratch, unsigned long long* visited, int B, int Tq,
           int Tk, int H, int Hkv, int q_off, int k_off, int causal, float scale,
           cudaStream_t st) {
  using QT = typename Geo<D>::QT;
  using KT = typename Geo<D>::KT;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_TENSOR_MAP;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!make_map(&tm_q, enc, q, H, D, Tq, B, QT::COLS, BQ) ||
      !make_map(&tm_do, enc, dout, H, D, Tq, B, QT::COLS, BQ) ||
      !make_map(&tm_k, enc, k, Hkv, D, Tk, B, KT::COLS, BK) ||
      !make_map(&tm_v, enc, v, Hkv, D, Tk, B, KT::COLS, BK))
    return ERR_TENSOR_MAP;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_sm90_kernel<D, PACKED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       Geo<D>::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int nqb = (Tq + BQ - 1) / BQ, Tqp = nqb * BQ;
  float2* rows = static_cast<float2*>(scratch);
  int32_t *qids = nullptr, *q_rng = nullptr, *k_rng = nullptr;
  if constexpr (PACKED) {
    qids = reinterpret_cast<int32_t*>(rows + (long)B * H * Tqp);
    q_rng = qids + (long)B * Tqp;
    k_rng = q_rng + 2l * B * nqb;
  }
  row_terms_kernel<<<dim3(nqb, H, B), BQ, 0, st>>>(lse, delta, dlse, seg_q, rows, qids, Tq, H,
                                                    Tqp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if constexpr (PACKED) {
    const int rc = id_ranges(seg_q, seg_k, B, Tq, Tk, BQ, KG, q_rng, k_rng, st);
    if (rc != 0) return rc;
  }
  const long blocks = (long)((Tk + BK - 1) / BK) * Hkv * B;
  if (blocks > INT_MAX) return ERR_BAD_ARGS;
  flash_bwd_dkv_sm90_kernel<D, PACKED><<<(unsigned)blocks, NT, Geo<D>::SMEM, st>>>(
      tm_q, tm_k, tm_v, tm_do, rows, qids, q_rng, k_rng, seg_k, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, visited, B, Tq, Tk, H, Hkv, q_off, k_off, causal, scale,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

template <bool PACKED>
int dispatch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
             const float* delta, const float* dlse, void* dk, void* dv, const int32_t* seg_q,
             const int32_t* seg_k, void* scratch, unsigned long long* visited, int B, int Tq,
             int Tk, int H, int Hkv, int D, int q_off, int k_off, int causal, float scale,
             cudaStream_t st) {
#define DDL_SM90_CASE(DIM)                                                                  \
  if (D == DIM)                                                                           \
    return launch<DIM, PACKED>(q, k, v, dout, lse, delta, dlse, dk, dv, seg_q, seg_k,     \
                               scratch, visited, B, Tq, Tk, H, Hkv, q_off, k_off, causal, \
                               scale, st);
  DDL_SM90_CASE(16)
  DDL_SM90_CASE(32)
  DDL_SM90_CASE(64)
  DDL_SM90_CASE(128)
#undef DDL_SM90_CASE
  return ERR_BAD_ARGS;
}

// Scratch of one dQ launch: none for K2; for K5 the padded key ids (B *
// Tkp int32, first, for the bulk copies' alignment) and the id ranges (B *
// (ceil(Tq / DQ_G) + ceil(Tk / DQ_BK)) int2).
long long dq_scratch_bytes(int B, int Tq, int Tk, bool packed) {
  if (!packed) return 0;
  const long long nqg = (Tq + DQ_G - 1) / DQ_G, nkt = (Tk + DQ_BK - 1) / DQ_BK;
  return 4ll * B * nkt * DQ_BK + 8ll * B * (nqg + nkt);
}

template <int D, bool PACKED>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, const float* dlse, void* dq, const int32_t* seg_q,
              const int32_t* seg_k, void* scratch, unsigned long long* visited, int B, int Tq,
              int Tk, int H, int Hkv, int q_off, int k_off, int causal, float scale,
              cudaStream_t st) {
  using QT = typename DqGeo<D>::QT;
  using KT = typename DqGeo<D>::KT;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return ERR_TENSOR_MAP;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!make_map(&tm_q, enc, q, H, D, Tq, B, QT::COLS, DQ_BQ) ||
      !make_map(&tm_do, enc, dout, H, D, Tq, B, QT::COLS, DQ_BQ) ||
      !make_map(&tm_k, enc, k, Hkv, D, Tk, B, KT::COLS, DQ_BK) ||
      !make_map(&tm_v, enc, v, Hkv, D, Tk, B, KT::COLS, DQ_BK))
    return ERR_TENSOR_MAP;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_sm90_kernel<D, PACKED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       DqGeo<D>::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int nkt = (Tk + DQ_BK - 1) / DQ_BK;
  int32_t *kids = nullptr, *q_rng = nullptr, *k_rng = nullptr;
  if constexpr (PACKED) {
    kids = static_cast<int32_t*>(scratch);
    q_rng = kids + (long)B * nkt * DQ_BK;
    k_rng = q_rng + 2l * B * ((Tq + DQ_G - 1) / DQ_G);
    pad_ids_kernel<<<dim3(nkt, B), DQ_BK, 0, st>>>(seg_k, Tk, nkt * DQ_BK, kids);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int rc = id_ranges(seg_q, seg_k, B, Tq, Tk, DQ_G, DQ_BK, q_rng, k_rng, st);
    if (rc != 0) return rc;
  }
  const long blocks = (long)((Tq + DQ_BQ - 1) / DQ_BQ) * H * B;
  if (blocks > INT_MAX) return ERR_BAD_ARGS;
  flash_bwd_dq_sm90_kernel<D, PACKED><<<(unsigned)blocks, NT, DqGeo<D>::SMEM, st>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, dlse, seg_q, q_rng, k_rng, kids,
      (__nv_bfloat16*)dq, visited, B, Tq, Tk, H, Hkv, q_off, k_off, causal, scale,
      scale * LOG2E);
  return (int)cudaGetLastError();
}

template <bool PACKED>
int dispatch_dq(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, const float* dlse, void* dq,
                const int32_t* seg_q, const int32_t* seg_k, void* scratch,
                unsigned long long* visited, int B, int Tq, int Tk, int H, int Hkv, int D,
                int q_off, int k_off, int causal, float scale, cudaStream_t st) {
#define DDL_SM90_CASE(DIM)                                                                   \
  if (D == DIM)                                                                            \
    return launch_dq<DIM, PACKED>(q, k, v, dout, lse, delta, dlse, dq, seg_q, seg_k,       \
                                  scratch, visited, B, Tq, Tk, H, Hkv, q_off, k_off, causal, \
                                  scale, st);
  DDL_SM90_CASE(16)
  DDL_SM90_CASE(32)
  DDL_SM90_CASE(64)
  DDL_SM90_CASE(128)
#undef DDL_SM90_CASE
  return ERR_BAD_ARGS;
}

}  // namespace

// Bytes of the scratch ddl_flash_bwd_dkv_sm90 needs for these shapes
// (packed != 0: K6).
extern "C" long long ddl_flash_bwd_dkv_sm90_scratch(int B, int Tq, int Tk, int H, int packed) {
  return scratch_bytes(B, Tq, Tk, H, packed != 0);
}

// Launches K3 (seg_q == NULL) or K6 (seg_q, seg_k (B, Tq) / (B, Tk) int32)
// on `stream`, with their pre-passes, over bf16 q, dout (B, Tq, H, D) and k,
// v (B, Tk, Hkv, D), all contiguous and 16-byte aligned; lse, delta, dlse
// (B, H, Tq) fp32; dk, dv (B, Tk, Hkv, D) bf16 out; `scratch` 16-byte
// aligned, of ddl_flash_bwd_dkv_sm90_scratch bytes.  `visited`, when not
// NULL, gains the number of query tiles loaded over every (b, KV head, key
// tile).  Returns cudaGetLastError() (0 on success), -1 for arguments it
// does not take, or -2 if the CUDA driver's tensor-map encoder is missing
// or refuses a map.
extern "C" int ddl_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                                      const void* dout, const float* lse, const float* delta,
                                      const float* dlse, void* dk, void* dv,
                                      const int32_t* seg_q, const int32_t* seg_k, void* scratch,
                                      unsigned long long* visited, int B, int Tq, int Tk, int H,
                                      int Hkv, int D, int q_off, int k_off, int causal,
                                      float scale, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || Hkv < 1 || H % Hkv != 0 || B > 65535 || H > 65535 ||
      misaligned(q) || misaligned(k) || misaligned(v) || misaligned(dout) || misaligned(dk) ||
      misaligned(dv) || scratch == nullptr || misaligned(scratch) ||
      (seg_q == nullptr) != (seg_k == nullptr))
    return ERR_BAD_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  if (seg_q != nullptr)
    return dispatch<true>(q, k, v, dout, lse, delta, dlse, dk, dv, seg_q, seg_k, scratch,
                          visited, B, Tq, Tk, H, Hkv, D, q_off, k_off, causal, scale, st);
  return dispatch<false>(q, k, v, dout, lse, delta, dlse, dk, dv, nullptr, nullptr, scratch,
                         visited, B, Tq, Tk, H, Hkv, D, q_off, k_off, causal, scale, st);
}

// Bytes of the scratch ddl_flash_bwd_dq_sm90 needs for these shapes
// (packed != 0: K5; 0 for K2, which takes a NULL scratch).
extern "C" long long ddl_flash_bwd_dq_sm90_scratch(int B, int Tq, int Tk, int packed) {
  return dq_scratch_bytes(B, Tq, Tk, packed != 0);
}

// Launches K2 (seg_q == NULL) or K5 (seg_q, seg_k (B, Tq) / (B, Tk) int32,
// with their pre-passes into `scratch`, 16-byte aligned, of
// ddl_flash_bwd_dq_sm90_scratch bytes) on `stream`, over bf16 q, dout (B,
// Tq, H, D) and k, v (B, Tk, Hkv, D), all contiguous and 16-byte aligned;
// lse, delta, dlse (B, H, Tq) fp32; dq (B, Tq, H, D) bf16 out.  `visited`,
// when not NULL, gains the number of key tiles loaded over every (b, head,
// query tile).  Returns as ddl_flash_bwd_dkv_sm90 does.
extern "C" int ddl_flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                                     const void* dout, const float* lse, const float* delta,
                                     const float* dlse, void* dq, const int32_t* seg_q,
                                     const int32_t* seg_k, void* scratch,
                                     unsigned long long* visited, int B, int Tq, int Tk, int H,
                                     int Hkv, int D, int q_off, int k_off, int causal,
                                     float scale, void* stream) {
  if (B < 1 || Tq < 1 || Tk < 1 || Hkv < 1 || H % Hkv != 0 || B > 65535 || H > 65535 ||
      misaligned(q) || misaligned(k) || misaligned(v) || misaligned(dout) || misaligned(dq) ||
      (seg_q == nullptr) != (seg_k == nullptr) ||
      (seg_q != nullptr && (scratch == nullptr || misaligned(scratch))))
    return ERR_BAD_ARGS;
  cudaStream_t st = (cudaStream_t)stream;
  if (seg_q != nullptr)
    return dispatch_dq<true>(q, k, v, dout, lse, delta, dlse, dq, seg_q, seg_k, scratch,
                             visited, B, Tq, Tk, H, Hkv, D, q_off, k_off, causal, scale, st);
  return dispatch_dq<false>(q, k, v, dout, lse, delta, dlse, dq, nullptr, nullptr, nullptr,
                            visited, B, Tq, Tk, H, Hkv, D, q_off, k_off, causal, scale, st);
}
