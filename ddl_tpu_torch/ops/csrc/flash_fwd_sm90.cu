// The bf16 flash-attention forward for NVIDIA Hopper (sm_90a): TMA copies
// into a shared-memory ring, wgmma on the tensor cores, and, for packed
// documents, no work on key tiles whose document ids cannot meet the query
// tile's.  Plain C interface, loaded from Python with ctypes
// (ddl_tpu_torch/ops/flash_attention.py builds and binds it).
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

#include <cuda.h>  // CUtensorMap and its enums; no -lcuda (see encoder())
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int BQ = 128;                // query rows per block
constexpr int BK = 128;                // key rows per tile
constexpr int STAGES = 2;              // K/V ring depth
constexpr int G = 64;                  // query id-range granule (rows)
constexpr int NCONS = 256;             // two consumer warpgroups
constexpr int NT = NCONS + 32;         // + one producer warp
constexpr float NEG = -1e30f;          // the TPU kernel's finite mask value
constexpr float LN2 = 0.69314718055994531f;

// Tile geometry of head dim D.  A tile row of D bf16 values is split into
// atoms of at most 64 columns (128 B, the widest swizzle); the atoms of a
// tile lie one after the other.
template <int D>
struct Geo {
  static constexpr int ROWB = D * 2 < 128 ? D * 2 : 128;  // bytes per atom row
  static constexpr int NATOM = D * 2 / ROWB;
  static constexpr int COLS = ROWB / 2;                   // columns per atom
  static constexpr int Q_ATOM = BQ * ROWB;
  static constexpr int KV_ATOM = BK * ROWB;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  // wgmma descriptor layout: 1 = 128 B swizzle, 2 = 64 B, 3 = 32 B.
  static constexpr uint64_t LAYOUT = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
  // Q, the K and V rings, 4 * STAGES + 1 mbarriers, each stage's key ids
  // (K4), and slack to align the base to the 1024 B the swizzle patterns
  // repeat at.
  static constexpr int SMEM =
      Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (4 * STAGES + 1) + 4 * STAGES * BK + 1024;
  static_assert(D % 16 == 0 && D <= 128, "head dim");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarriers ---

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed.  A wait that
// outlasts ~2^35 cycles (tens of seconds) can only be a broken pipeline:
// trap, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1ll << 35)) asm volatile("trap;");
  }
}

// ------------------------------------------------------------------ TMA ---

// One box of `map` at coordinates (c0, c1, c2) into shared memory at `dst`,
// completing `bytes` of the transaction count of `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------- wgmma ---

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16 B units) and the swizzle layout.  K-major swizzled operands
// ignore the leading offset; the stride offset steps 8 rows.  A MN-major
// operand's leading offset steps to the next atom of columns.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint64_t layout) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Keep the compiler from moving accesses of wgmma's registers across the
// asynchronous instructions that read or write them.
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory;
// `accumulate` = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 16] += A[64 x 16] B[16 x 16], A from registers, B MN-major
// (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                              const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}"
      ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 32] += A[64 x 16] B[16 x 32], A from registers, B MN-major
// (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A from registers, B MN-major
// (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A from registers, B MN-major
// (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                       uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

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

// Entry i of batch row b of a (B, n, 2) range table of [min, max] ids.
__device__ __forceinline__ int2 id_range(const int32_t* __restrict__ rng, int b, int n, int i) {
  return __ldg(reinterpret_cast<const int2*>(rng) + (long)b * n + i);
}

// Pre-pass of K4: [min, max] of the ids over each G-row query granule
// (q_rng (B, ceil(Tq / G), 2)) and each BK-row key tile (k_rng (B,
// ceil(Tk / BK), 2)).  grid (max(nq_g, nk_t), B, 2): z = 0 the query ids,
// z = 1 the key ids; BK threads.
__global__ void __launch_bounds__(BK)
id_range_kernel(const int32_t* __restrict__ seg_q, const int32_t* __restrict__ seg_k,
                int Tq, int Tk, int32_t* __restrict__ q_rng, int32_t* __restrict__ k_rng) {
  const bool keys = blockIdx.z == 1;
  const int T = keys ? Tk : Tq, span = keys ? BK : G;
  const int n = (T + span - 1) / span;
  const int g = blockIdx.x, b = blockIdx.y;
  if (g >= n) return;
  const int32_t* seg = keys ? seg_k : seg_q;
  const int t = g * span + threadIdx.x;
  int lo = INT_MAX, hi = INT_MIN;
  if (threadIdx.x < span && t < T) lo = hi = seg[(long)b * T + t];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  __shared__ int2 part[BK / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x / 32] = make_int2(lo, hi);
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < BK / 32; ++w) {
      lo = min(lo, part[w].x);
      hi = max(hi, part[w].y);
    }
    reinterpret_cast<int2*>(keys ? k_rng : q_rng)[(long)b * n + g] = make_int2(lo, hi);
  }
}

// ---------------------------------------------------------------- K1/K4 ---

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// O += P V over BK / 16 steps of 16 keys, committed as one group; V at
// shared address `va` is MN-major (D contiguous), in atoms of COLS columns.
template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2], const uint32_t (&pa)[BK / 16][4],
                                           uint32_t va) {
  using Gm = Geo<D>;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t db = desc(va + kk * 16 * Gm::ROWB, Gm::KV_ATOM, 8 * Gm::ROWB, Gm::LAYOUT);
    mma_rs<D>(o, pa[kk], db);
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
      const int atom = kk * 32 / Gm::ROWB, off = kk * 32 % Gm::ROWB;
      const uint64_t da = desc(qa + atom * Gm::Q_ATOM + off, 16, 8 * Gm::ROWB, Gm::LAYOUT);
      const uint64_t db = desc(ka + atom * Gm::KV_ATOM + off, 16, 8 * Gm::ROWB, Gm::LAYOUT);
      wgmma_ss_n128(sc, da, db, kk > 0);
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
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    }
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver, reached through the runtime so
// that the library needs no -lcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &res);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &res);
#endif
    if (e != cudaSuccess || res != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 (B, T, heads, D) tensor as a 3-D map over (heads * D, T, B), in
// boxes of (cols, rows, 1) with the swizzle of a `cols`-wide row.
bool make_map(CUtensorMap* map, EncodeTiled enc, const void* ptr, int heads, int D, int T,
              int B, int cols, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)heads * D, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)heads * D * 2, (cuuint64_t)heads * D * 2 * T};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz = cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
             box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int ERR_BAD_ARGS = -1;
constexpr int ERR_TENSOR_MAP = -2;

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
    const int nq_g = (Tq + G - 1) / G, nk_t = (Tk + BK - 1) / BK;
    q_rng = ranges;
    k_rng = ranges + 2 * (long)B * nq_g;
    id_range_kernel<<<dim3(max(nq_g, nk_t), B, 2), BK, 0, st>>>(seg_q, seg_k, Tq, Tk, q_rng,
                                                                 k_rng);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_sm90_kernel<D, PACKED><<<grid, NT, Gm::SMEM, st>>>(
      tm_q, tm_k, tm_v, (__nv_bfloat16*)out, lse, seg_q, seg_k, q_rng, k_rng, visited, Tq, Tk,
      H, Hkv, q_off, k_off, causal, scale * 1.4426950408889634f);
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

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

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
