// Flash attention forward, and the bf16 backward, for Hopper (sm_90a),
// bound to Python with ctypes.
//
// Replaces the TPU kernel `flash_attention_fwd` / `_fwd_kernel` in
// src/repro/kernels/flash_attention.py: blockwise online-softmax attention,
// causal with offset T - S, GQA query head h reading KV head h / (H / KV).
//
// What bounds it on the card: at the serve shape (B = 8, H = 32, KV = 4,
// S = T = 1000, D = 64, causal) the work is two matrix products, 4 * D
// operations per visible (query, key) pair, 3.3e10 in all, against 4.1e7
// bytes of q, k, v and o; at 989 TFLOP/s and 3.35 TB/s that is 0.0332 ms
// of tensor-core work and 0.012 ms of memory, so the tensor cores bound it.
// The softmax's exponentials (one per pair, on the 16-lane-per-SM special
// function units) cost about as much again as the products at full rate.
//
// The bf16 design, and what each part does about that:
// - Both products on `wgmma`, Hopper's only way to the tensor cores' full
//   rate.  A CTA is two consumer warpgroups (256 threads), 64 query rows
//   each, 128 rows per CTA, so every K/V tile in shared memory serves 128
//   rows.  S = Q K^T is wgmma m64n64k16 with Q and K read from shared
//   memory, both K-major (K stored [key][d], as it sits in memory).
//   O += P V is m64n64k16 per 64-wide panel of d, with P taken from the
//   registers (the fp32 score accumulator repacked to bf16 in the A-fragment
//   layout) and V read from shared memory in its natural [key][d] layout
//   through the descriptor's MN-major (transposed) mode: V is never
//   transposed by the threads.
// - Tiles of 64 keys land through `cp.async` 16-byte copies into a
//   two-stage ring in dynamic shared memory: tile j + 1's copies are in
//   flight while tile j's products and softmax run, and one barrier a tile
//   both publishes tile j and frees tile j - 1's stage.  Rows past T (and
//   query rows past S) use the zero-fill form (src-size 0).  Q is loaded
//   once per CTA.
// - Every tile is stored with the 128-byte swizzle that the wgmma
//   descriptors name (16-byte chunk c of row r at chunk c ^ (r % 8), in
//   panels of 64 columns, each row of a panel 128 bytes), so the copies and
//   the tensor cores' reads are free of bank conflicts.
// - The causal and ragged masks are applied only to a tile that holds the
//   diagonal of the warpgroup's rows or the ragged end of T; tiles wholly
//   above a warpgroup's diagonal are skipped by that warpgroup and, when
//   above the whole CTA's, never loaded.
// - The longest causal rows start first, and K and V stay in L2 while
//   they are read: CTAs are numbered in groups of (batch, head) pairs whose
//   K and V take at most 16 MiB together, and within a group the last
//   query tiles come first.  With GQA all heads of the serve shape make one
//   group; multi-head attention over 1024 keys makes groups of 64 pairs.
// - O leaves through the warpgroup's own Q rows in shared memory, so each
//   thread stores 16 contiguous bytes of a row.
// - D = 64, 128, 192 and 256 all take this kernel.  D = 64 holds two CTAs
//   on an SM (125 registers a thread); D = 128 (O: 64 registers a thread),
//   D = 192 (O: 96) and D = 256 (O: 128) hold one; none spills (ptxas -v).
//   D = 192 is three 64-column panels: Q K^T takes 12 k16 steps, 4 a
//   panel, and P V one product a panel; its shared memory is (128 * 192 +
//   4 * 64 * 192) * 2 + 1024 = 148,480 bytes.
// - D = 192 serves DeepSeek-V2's multi-head latent attention: q and k are
//   qk_nope 128 + qk_rope 64 wide and V (128 wide) arrives zero-padded to
//   192, as the reference pads it, so a third of P V and of V's bytes are
//   zeros.  At its prefill shape (B = 8, H = KV = 128, S = T = 1000,
//   causal) the bytes bound it: 4 tensors of 8 * 128 * 1000 * 192 bf16
//   values, 1.57e9 bytes, take 0.47 ms at 3.35 TB/s, the 3.9e11 operations
//   0.40 ms at 989 TFLOP/s.
//
// float32 inputs take their own kernel, also on the tensor cores.  What
// bounds it: at train_100m's shape (B = 8, H = 12, KV = 4, S = T = 256,
// D = 64, causal) the work is 3,158,016 visible pairs x 4 D = 0.808 GFLOP
// against 16.78 MB of q, k, v and o.  On the CUDA cores (67 TFLOP/s fp32)
// the operations take 0.0121 ms.  One tf32 pass on the tensor cores rounds
// every operand to 11 significant bits, about 3e-4 in the output against
// the 2e-5 that fp32 is held to; so each product is three tf32 products
// (3xTF32), 2.43 GFLOP at 495 TFLOP/s: 0.0049 ms, under the bytes' 0.0050
// ms at 3.35 TB/s.  This design is bound by bytes, at 0.0050 ms.
//
// The fp32 design, and what each part does about that:
// - Both products on `mma.sync.m16n8k8` with tf32 operands.  Each fp32
//   operand x is split into hi = rna(x) and lo = rna(x - hi), rna being
//   cvt.rna.tf32.f32's rounding (to nearest, ties away from zero); a
//   product is lo hi + hi lo + hi hi, accumulated in fp32, and the dropped
//   lo lo is about 2^-22 of it: the output stays within ~1e-6 of fp32
//   arithmetic.  mma.sync and not wgmma: wgmma takes tf32 operands only
//   K-major, so V ([key][d], which P V reads MN-major) would have to be
//   written transposed into shared memory; mma.sync reads V as it lies and
//   takes P from the registers.
// - The splits are made in registers right after each shared load, so
//   shared memory holds the fp32 tiles as cp.async lands them and no pass
//   over a tile comes before it is read; each of the four warps splits the
//   K and V values it reads.  rna is written as an add and a mask (the
//   cvt adds a NaN test and a select around them): ~14% less time at the
//   train shape (0.0313 vs 0.0365 ms in one call, tools/
//   torch_flash_variants.py --kernel flash32).
// - A CTA is four warps of 16 query rows, 64 rows a CTA (the scalar
//   kernel's was 16), so every K/V tile in shared memory serves 64 rows
//   and K and V cross from L2 to shared memory a quarter as often.  At the
//   train shape that is 4 x 96 = 384 CTAs, two an SM.
// - K and V tiles (64 keys at D = 64, 32 at the wider heads, for shared
//   memory) land through cp.async in a two-stage ring, as in the bf16
//   kernel: tile j + 1's copies are in flight while tile j is used.  Rows
//   past T and query rows past S are zero-filled.  Q is loaded once.
// - Every row in shared memory is padded to D + 4 floats, so the fragment
//   loads are free of bank conflicts: Q's and K's (row g, column t4) fall
//   in bank 4 g + t4, V's (row 2 t4, column g) in bank 8 t4 + g.
// - P's score accumulator is the A operand as it stands.  It holds keys
//   2 t4 and 2 t4 + 1 of each block of 8 where A wants k indices t4 and t4
//   + 4; P V takes a block's keys in that order, and V's B fragment reads
//   its rows 2 t4 and 2 t4 + 1, so no value moves between lanes.
// - The masks, the tiles above a warp's diagonal skipped, the online
//   softmax in log2 units (ex2.approx) and the launch order (longest
//   causal rows first) are the bf16 kernel's.
// - Budget per D, 128 threads: shared memory (64 + 4 BK) (D + 4) 4 bytes,
//   87,040 at D = 64, 101,376 at D = 128 (two CTAs an SM), 150,528 at D =
//   192 and 199,680 at D = 256 (one); O takes D / 2 registers a thread.
//   ptxas: 186, 215, 200 and 237 registers, none spills.  At D = 192 and
//   256 the K/V copies are issued by a loop that is not unrolled;
//   unrolled, their addresses stay in registers and the kernel spilled 20
//   and 312 bytes.
// - What holds it at the train shape is open; two causes fit the same
//   call's readings (tools/torch_flash_variants.py --kernel flash32):
//   latency (the shape without the causal mask, twice the work, takes
//   1.10-1.18x as long; 8x the batch takes 4.55-4.87x) and wave
//   quantization (384 CTAs on 264 slots, two an SM on 132 SMs, are 1.45
//   waves: the second runs 120 CTAs with most slots idle; 8x the batch
//   is 11.6 waves).
//
// The bf16 backward (fa_bwd_dq_bf16, fa_bwd_dkdv_bf16) replaces no TPU
// kernel: the reference's custom_vjp differentiates a plain attention.  It
// was added because that plain backward, autograd through the blockwise
// twin, held a third of the device's busy time in a MoE train step
// (granite, 8 x 1024 tokens, 16 layers): (8, 24, 512, 1024) fp32 score
// tensors and a chain of elementwise passes over them, ~205 ms a step.
//
// What bounds it: at that shape (B = 8, H = 24, KV = 8, S = T = 1024,
// D = 64, causal) the mathematics is five products over the 524,800
// visible pairs, 10 * D operations a pair, 64.5 GFLOP a layer: 0.065 ms at
// 989 TFLOP/s, against 0.041 ms for its 136 MB (Q, K, V, O and dO read,
// dQ, dK and dV written, LSE and delta; these kernels read no O) at 3.35
// TB/s.  The products bound it.
//
// The design, and what each part does about that:
// - The forward's bf16 instance with WITH_LSE writes each row's
//   log-sum-exp, so that the backward recomputes P = exp(scale S - LSE)
//   tile by tile and never holds S x T scores in device memory.
// - Two kernels and no atomics, so that gradients are the same bits from
//   run to run.  fa_bwd_dq_bf16 takes 128 query rows (the forward's CTA,
//   tile order and K/V ring) and passes over their keys twice, forming S =
//   Q K^T and dP = dO V^T (wgmma from shared memory) each time: the first
//   pass sums delta = rowsum(P o dP) (written for the second kernel), the
//   second forms dS = P o (dP - delta) in fp32 and dQ += dS K, dS from the
//   registers and K read MN-major.  fa_bwd_dkdv_bf16 holds 128 keys of K
//   and V, 64 a warpgroup, and streams Q, dO, LSE and delta through a
//   two-stage cp.async ring over the G query heads of its KV head and the
//   query tiles that see its keys.  S^T = K Q^T and dP^T = V dO^T put the
//   keys on wgmma's M side, so P^T and dS^T are A operands as they stand in
//   the registers; dV += P^T dO and dK += dS^T Q read dO and Q MN-major.
//   The GQA sum over the group's heads stays in the block's registers.
// - delta from the backward's own P and dP, and not as rowsum(dO o O):
//   O is rounded to bf16 and made from the forward's bf16 P, and where V
//   has a large common part (a bias, as whisper's) dP - delta cancels it,
//   so that rounding became a bias of dS: 11-31% off in dq and dk in a
//   plain emulation on the CPU, and whisper's train step on the card left
//   its limits on the q and k projections.  The first pass costs two
//   products a tile.
// - That is nine products where the mathematics needs five (S and dP are
//   formed three times), ~1.5 ms a step more at granite's shape, for no
//   fp32 dQ scratch, no conversion pass, determinism and that delta.
// - Scores stay fp32 as wgmma gives them; P and dS are rounded to bf16 only
//   as the products' operands.
// - The masks, the swizzle and the descriptors are the forward's.  D = 128
//   takes query tiles of 32 rows in the dK/dV kernel (wgmma m64n32k16), so
//   that its dK and dV accumulators (128 registers a thread) leave room
//   for the scores.
// - A row that sees no key (causal, S > T) has LSE +inf, so its P is 0 and
//   its gradients exact zeros; rows past S read zero LSE and delta beside
//   zero Q and dO rows, and add nothing.
//
// Semantics beyond the TPU kernel: ragged S and T tails are masked instead
// of refused, and a query row that sees no key returns zeros.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

struct Params {
  int B, H, KV, S, T, group, causal, offs;
  int bh_per_group;  // bf16 launch order: (batch, head) pairs per group
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh, o_ss;
  float scale;
};

// Last key (exclusive) that any row of the query tile [q0, q0 + rows) may see.
__device__ __forceinline__ int kv_end_for_tile(const Params& p, int q0, int rows) {
  if (!p.causal) return p.T;
  int last_row = min(q0 + rows, p.S) - 1;
  int end = last_row + p.offs + 1;
  return max(0, min(p.T, end));
}

// ---------------------------------------------------------------------------
// bf16: wgmma kernel
// ---------------------------------------------------------------------------
constexpr int BQ = 128;      // query rows per CTA: two warpgroups of 64
constexpr int BK = 64;       // keys per K/V tile
constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; with `full` false nothing is read and the 16
// bytes are zero-filled (src-size 0).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(full ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// make this thread's shared-memory writes visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk c (of D / 8) of row r in a tile of R rows
// stored with the 128-byte swizzle: panels of 64 columns, R rows of 128
// bytes each, chunk c % 8 of row r at position (c % 8) ^ (r % 8).
template <int R>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)((c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// Rows [row0, row0 + R) of a (rows, D) bf16 matrix with row stride `ld`
// into the swizzled tile at `dst`; rows at or past `nrows` are zeros.
template <int R, int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, long long ld,
                                          int row0, int nrows, int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  static_assert((R * CPR) % THREADS == 0, "tile must split evenly over the CTA");
#pragma unroll
  for (int it = 0; it < R * CPR / THREADS; ++it) {
    const int i = it * THREADS + tid;
    const int r = i / CPR, c = i % CPR;
    const bool in = row0 + r < nrows;
    const __nv_bfloat16* s = in ? src + (long long)(row0 + r) * ld + c * 8 : src;
    cp_async16(dst + swz<R>(r, c), s, in);
  }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle (layout type 1):
// start address >> 4 in bits 0-13, leading byte offset >> 4 in 16-29,
// stride byte offset >> 4 in 32-45.  The stride byte offset is the step
// between groups of 8 rows (8 x 128 bytes).  The leading byte offset is
// unused by the K-major operands here and by an MN-major operand 64
// elements wide; it is set to the same 1024 bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr) {
  constexpr uint64_t off = 1024 >> 4;
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | (off << 16) | (off << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses of an accumulator across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define WG_D32                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "    \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_ACC32(c, d)                                                                   \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]),        \
  c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]),          \
  c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]),         \
  c(d[25]), c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31])
#define WG_IN "+f"
#define WG_OUT "=f"

// D(64x64, fp32) = A(64x16) B(16x64), or += with ACCUMULATE; A and B
// K-major in shared memory.
template <bool ACCUMULATE>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  if constexpr (ACCUMULATE) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_ACC32(WG_IN, d)
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_ACC32(WG_OUT, d)
        : "l"(da), "l"(db), "r"(0));
  }
}

// D(64x64, fp32) += A(64x16) B(16x64); A in registers (the m16n8k16
// A-fragment layout, per warp of the warpgroup 16 rows), B MN-major
// (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC32(WG_IN, d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory: Q (BQ x D), then two stages of K (BK x D) and V (BK x D),
// each swizzled, from a 1024-byte-aligned base.
template <int D>
constexpr size_t bf16_smem_bytes() {
  return (size_t)(BQ * D + 2 * 2 * BK * D) * 2 + 1024;
}

// WITH_LSE: also write each query row's log-sum-exp of its scaled scores
// to `lse` (B, H, S), for the backward; without it `lse` is not read.
template <int D, int MIN_BLOCKS, bool WITH_LSE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fa_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, Params p,
            float* __restrict__ lse) {
  constexpr int NP = D / 64;              // 64-column panels of d
  constexpr uint32_t Q_BYTES = BQ * D * 2;
  constexpr uint32_t KV_BYTES = BK * D * 2;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + Q_BYTES;      // stage s: K at sKV + 2 s KV_BYTES, V after it

  const int tid = threadIdx.x;
  const int wg = tid >> 7;                // consumer warpgroup: query rows 64 wg ..
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // Launch order: groups of bh_per_group (batch, head) pairs, each group's
  // query tiles heaviest first (the last tiles of the group's pairs first)
  const int nq = (p.S + BQ - 1) / BQ;
  const int group_ctas = p.bh_per_group * nq;
  const int first = (int)blockIdx.x / group_ctas * p.bh_per_group;
  const int rem = (int)blockIdx.x % group_ctas;
  const int gsize = min(p.bh_per_group, p.B * p.H - first);
  const int bh = first + rem % gsize;
  const int q0 = (nq - 1 - rem / gsize) * BQ;
  const int h = bh % p.H, b = bh / p.H;
  const int kvh = h / p.group;

  const __nv_bfloat16* qb = q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = v + b * p.v_sb + kvh * p.v_sh;
  auto load_kv = [&](int t) {    // tile t into stage t % 2
    const uint32_t st = sKV + (t & 1) * 2 * KV_BYTES;
    load_tile<BK, D>(st, kb, p.k_st, t * BK, p.T, tid);
    load_tile<BK, D>(st + KV_BYTES, vb, p.v_st, t * BK, p.T, tid);
  };

  const int kv_end = kv_end_for_tile(p, q0, BQ);
  const int ntiles = (kv_end + BK - 1) / BK;
  load_tile<BQ, D>(sQ, qb, p.q_ss, q0, p.S, tid);
  if (ntiles > 0) load_kv(0);
  cp_async_commit();

  const int wr0 = q0 + wg * 64;           // this warpgroup's first row
  const int wg_end = wr0 < p.S ? kv_end_for_tile(p, wr0, 64) : 0;
  const int row0 = wr0 + warp * 16 + g;   // this thread's rows: row0, row0 + 8
  const int qpos0 = row0 + p.offs, qpos1 = qpos0 + 8;
  const float sl2 = p.scale * 1.4426950408889634f;  // scores in log2 units
  // Q descriptor of this warpgroup's rows; k-slice kk adds panel and 32-byte steps
  const uint64_t dq = make_desc(sQ + wg * 64 * 128);

  float o_acc[NP][32];
#pragma unroll
  for (int n = 0; n < NP; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) o_acc[n][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<0>();  // tile j (and, at j = 0, Q) has landed
    fence_proxy_async();
    __syncthreads();  // ... for every thread, and every thread is done with tile j - 1
    if (j + 1 < ntiles) load_kv(j + 1);  // into tile j - 1's stage, while tile j is used
    cp_async_commit();

    const int k0 = j * BK;
    if (k0 < wg_end) {  // uniform over the warpgroup
      const uint32_t sK = sKV + (j & 1) * 2 * KV_BYTES, sV = sK + KV_BYTES;
      const uint64_t dk = make_desc(sK);

      // S = Q K^T: 64 rows x 64 keys
      float s[32];
      wg_fence();
      wgmma_ss<false>(s, dq, dk);
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk) {
        const uint32_t qoff = (kk >> 2) * (BQ * 128) + (kk & 3) * 32;
        const uint32_t koff = (kk >> 2) * (BK * 128) + (kk & 3) * 32;
        wgmma_ss<true>(s, dq + (qoff >> 4), dk + (koff >> 4));
      }
      wg_commit();
      wg_wait0();
      fence_acc(s);

      // mask only the tile that holds this warpgroup's diagonal or T's end
      if (k0 + BK > p.T || (p.causal && k0 + BK - 1 > wr0 + p.offs)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = k0 + (i >> 2) * 8 + t4 * 2 + (i & 1);
          const int qpos = (i & 2) ? qpos1 : qpos0;
          if (key >= p.T || (p.causal && key > qpos)) s[i] = -INFINITY;
        }
      }

      // online softmax in fp32, log2 units
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // a row that has seen no key yet keeps p = 0 (exp2(-inf - 0))
      const float mu0 = (mn0 == -INFINITY) ? 0.f : mn0 * sl2;
      const float mu1 = (mn1 == -INFINITY) ? 0.f : mn1 * sl2;
      const float c0 = ex2(m0 * sl2 - mu0), c1 = ex2(m1 * sl2 - mu1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        s[i] = ex2(fmaf(s[i], sl2, -mu0));
        s[i + 1] = ex2(fmaf(s[i + 1], sl2, -mu0));
        s[i + 2] = ex2(fmaf(s[i + 2], sl2, -mu1));
        s[i + 3] = ex2(fmaf(s[i + 3], sl2, -mu1));
        ps0 += s[i] + s[i + 1];
        ps1 += s[i + 2] + s[i + 3];
      }
      l0 = l0 * c0 + ps0;  // per-thread partial row sums, reduced at the end
      l1 = l1 * c1 + ps1;

      // P as the A operand: keys 16 kk .. 16 kk + 15 are n-blocks 2 kk, 2 kk + 1
      uint32_t a[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
#pragma unroll
      for (int n = 0; n < NP; ++n) {
#pragma unroll
        for (int i = 0; i < 32; i += 4) {
          o_acc[n][i] *= c0;
          o_acc[n][i + 1] *= c0;
          o_acc[n][i + 2] *= c1;
          o_acc[n][i + 3] *= c1;
        }
        fence_acc(o_acc[n]);
      }

      // O += P V, V MN-major: k-slice kk is keys 16 kk .., 2048 bytes on
      const uint64_t dv = make_desc(sV);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int n = 0; n < NP; ++n)
          wgmma_rs(o_acc[n], a[kk], dv + ((n * (BK * 128) + kk * 2048) >> 4));
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int n = 0; n < NP; ++n) fence_acc(o_acc[n]);
      // the products read P from registers until they complete: keep it live
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i]) :: "memory");
    }
  }
  cp_async_wait<0>();  // with no tile at all, Q's copies land before O takes its rows

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffff, l0, off);
    l1 += __shfl_xor_sync(0xffffffff, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  if constexpr (WITH_LSE) {
    // m * scale + ln(l); a row that saw no key stores +inf, so that the
    // backward recomputes its probabilities as exact zeros
    if (t4 == 0) {
      float* const lb = lse + (long long)(b * p.H + h) * p.S;
      if (row0 < p.S) lb[row0] = l0 > 0.f ? fmaf(m0, p.scale, logf(l0)) : INFINITY;
      if (row0 + 8 < p.S) lb[row0 + 8] = l1 > 0.f ? fmaf(m1, p.scale, logf(l1)) : INFINITY;
    }
  }
  // O goes through this warpgroup's Q rows in shared memory (swizzled, as Q),
  // so that the global stores are 16 bytes a thread, rows contiguous
  const uint32_t sO = sQ + wg * 64 * 128;
  const int r0 = warp * 16 + g;  // rows r0 and r0 + 8 share r0 % 8
#pragma unroll
  for (int n = 0; n < NP; ++n)
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      const uint32_t at = sO + n * (BQ * 128) + r0 * 128 + (((i >> 2) ^ (r0 & 7)) << 4) + t4 * 4;
      asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(at),
                   "r"(pack_bf16(o_acc[n][i] * inv0, o_acc[n][i + 1] * inv0)));
      asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(at + 8 * 128),
                   "r"(pack_bf16(o_acc[n][i + 2] * inv1, o_acc[n][i + 3] * inv1)));
    }
  if (wg == 0)  // named barriers 1 and 2: each warpgroup's own
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
  __nv_bfloat16* ob = o + b * p.o_sb + h * p.o_sh;
  constexpr int CPR = D / 8;
#pragma unroll
  for (int it = 0; it < 64 * CPR / 128; ++it) {
    const int i = it * 128 + (tid & 127);
    const int r = i / CPR, c = i % CPR;
    uint4 val;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                 : "r"(sO + (c >> 3) * (BQ * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4)));
    if (wr0 + r < p.S)
      *reinterpret_cast<uint4*>(ob + (long long)(wr0 + r) * p.o_ss + c * 8) = val;
  }
}

// ---------------------------------------------------------------------------
// bf16 backward: dQ, then dK and dV (wgmma, from the forward's LSE)
// ---------------------------------------------------------------------------
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BKC = 128;  // keys per CTA of the dK/dV kernel: two warpgroups of 64

struct BwdParams {
  Params p;  // shapes and the q, k, v strides (o's unused)
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_st;
  long long dv_sb, dv_sh, dv_st;
};

// 4-byte asynchronous copy; with `full` false the 4 bytes are zero-filled.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(full ? 4 : 0) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define WG_D16                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_ACC16(c, d)                                                                   \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]),        \
  c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15])

// D(64x32, fp32) = A(64x16) B(16x32), or += with ACCUMULATE; A and B
// K-major in shared memory.
template <bool ACCUMULATE>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db) {
  if constexpr (ACCUMULATE) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_D16
        ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : WG_ACC16(WG_IN, d)
        : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_D16
        ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : WG_ACC16(WG_OUT, d)
        : "l"(da), "l"(db), "r"(0));
  }
}

// C(64 x N) = A B^T over d = D: A the 64 rows at `da`, B the N rows at
// `db`, both K-major and swizzled in tiles of RA and RB rows; k-slice kk
// is panel kk / 4, 32 bytes a step within it.
template <int D, int N, int RA, int RB>
__device__ __forceinline__ void product_ss(float (&c)[N / 2], uint64_t da, uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t aoff = (kk >> 2) * (RA * 128) + (kk & 3) * 32;
    const uint32_t boff = (kk >> 2) * (RB * 128) + (kk & 3) * 32;
    if constexpr (N == 64) {
      if (kk == 0) wgmma_ss<false>(c, da, db);
      else wgmma_ss<true>(c, da + (aoff >> 4), db + (boff >> 4));
    } else {
      if (kk == 0) wgmma_ss_n32<false>(c, da, db);
      else wgmma_ss_n32<true>(c, da + (aoff >> 4), db + (boff >> 4));
    }
  }
}

// The accumulator of a 64 x N product as A operands of the next: columns
// 16 kk .. 16 kk + 15 are n-blocks 2 kk, 2 kk + 1 (rounded to bf16).
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&c)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
    a[kk][1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// acc[n] += A B over K = 16 * KS rows of B: A from registers, B the
// (rows, D) tile at `sb` (R rows, swizzled) read MN-major, panel n of D.
template <int NP, int KS, int R>
__device__ __forceinline__ void product_rs(float (&acc)[NP][32], const uint32_t (&a)[KS][4],
                                           uint32_t sb) {
  const uint64_t db = make_desc(sb);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int n = 0; n < NP; ++n)
      wgmma_rs(acc[n], a[kk], db + ((n * (R * 128) + kk * 2048) >> 4));
}

// A warpgroup's 64 x D fp32 accumulator times `mul`, as bf16 rows
// [row0, row0 + 64) of the (rows, D) matrix at `dst` with row stride `ld`
// (rows at or past `nrows` are not written), through the warpgroup's rows
// of the R-row swizzled tile at `stage`: each thread stores 16 contiguous
// bytes of a row.  `bar` is the warpgroup's named barrier.
template <int D, int R>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 64][32], float mul,
                                           uint32_t stage, __nv_bfloat16* dst, long long ld,
                                           int row0, int nrows, int bar) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, g = (tid & 31) >> 2, t4 = tid & 3;
  const int r0 = warp * 16 + g;  // rows r0 and r0 + 8 share r0 % 8
#pragma unroll
  for (int n = 0; n < D / 64; ++n)
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      const uint32_t at = stage + n * (R * 128) + r0 * 128 + (((i >> 2) ^ (r0 & 7)) << 4) + t4 * 4;
      asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(at),
                   "r"(pack_bf16(acc[n][i] * mul, acc[n][i + 1] * mul)));
      asm volatile("st.shared.b32 [%0], %1;\n" :: "r"(at + 8 * 128),
                   "r"(pack_bf16(acc[n][i + 2] * mul, acc[n][i + 3] * mul)));
    }
  asm volatile("bar.sync %0, 128;\n" :: "r"(bar) : "memory");
  constexpr int CPR = D / 8;
#pragma unroll
  for (int it = 0; it < 64 * CPR / 128; ++it) {
    const int i = it * 128 + tid;
    const int r = i / CPR, c = i % CPR;
    uint4 val;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                 : "r"(stage + (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4)));
    if (row0 + r < nrows)
      *reinterpret_cast<uint4*>(dst + (long long)(row0 + r) * ld + c * 8) = val;
  }
}

// Shared memory of the dQ kernel: Q and dO (BQ x D each) and two stages of
// K and V (BK x D each), swizzled.
template <int D>
constexpr size_t dq_smem_bytes() {
  return (size_t)(2 * BQ * D + 2 * 2 * BK * D) * 2 + 1024;
}

// dQ = scale dS K for a tile of BQ query rows, dS = P o (dP - delta),
// P = exp(scale S - LSE), dP = dO V^T.  Two passes over the keys through
// the forward's K/V ring: the first sums delta = rowsum(P o dP) (written
// for the dK/dV kernel), the second forms dS and dQ.  delta is the
// backward's own P against its own dP, so every row of dS sums to zero as
// the mathematics has it; rowsum(dO o O) would take O rounded to bf16 and
// the forward's bf16 P, and a V with a large common part (a bias) turns
// that rounding into a bias of dS.  The tile order is the forward's.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
fa_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, __nv_bfloat16* __restrict__ dq,
               float* __restrict__ delta, BwdParams bp) {
  const Params& p = bp.p;
  constexpr int NP = D / 64;
  constexpr uint32_t Q_BYTES = BQ * D * 2;
  constexpr uint32_t KV_BYTES = BK * D * 2;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdO = sQ + Q_BYTES;
  const uint32_t sKV = sdO + Q_BYTES;     // stage s: K at sKV + 2 s KV_BYTES, V after it

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nq = (p.S + BQ - 1) / BQ;
  const int group_ctas = p.bh_per_group * nq;
  const int first = (int)blockIdx.x / group_ctas * p.bh_per_group;
  const int rem = (int)blockIdx.x % group_ctas;
  const int gsize = min(p.bh_per_group, p.B * p.H - first);
  const int bh = first + rem % gsize;
  const int q0 = (nq - 1 - rem / gsize) * BQ;
  const int h = bh % p.H, b = bh / p.H;
  const int kvh = h / p.group;

  const __nv_bfloat16* kb = k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = v + b * p.v_sb + kvh * p.v_sh;
  auto load_kv = [&](int t, int stage) {
    const uint32_t st = sKV + stage * 2 * KV_BYTES;
    load_tile<BK, D>(st, kb, p.k_st, t * BK, p.T, tid);
    load_tile<BK, D>(st + KV_BYTES, vb, p.v_st, t * BK, p.T, tid);
  };

  const int kv_end = kv_end_for_tile(p, q0, BQ);
  const int ntiles = (kv_end + BK - 1) / BK;
  load_tile<BQ, D>(sQ, q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.S, tid);
  load_tile<BQ, D>(sdO, dout + b * bp.do_sb + h * bp.do_sh, bp.do_ss, q0, p.S, tid);
  if (ntiles > 0) load_kv(0, 0);
  cp_async_commit();

  const int wr0 = q0 + wg * 64;
  const int wg_end = wr0 < p.S ? kv_end_for_tile(p, wr0, 64) : 0;
  const int row0 = wr0 + warp * 16 + g;   // this thread's rows: row0, row0 + 8
  const int qpos0 = row0 + p.offs, qpos1 = qpos0 + 8;
  const float sl2 = p.scale * LOG2E;
  // LSE in log2 units; rows past S take +inf (p = 0)
  const long long stat0 = (long long)(b * p.H + h) * p.S;
  const float ls0 = row0 < p.S ? lse[stat0 + row0] * LOG2E : INFINITY;
  const float ls1 = row0 + 8 < p.S ? lse[stat0 + row0 + 8] * LOG2E : INFINITY;
  const uint64_t dq_a = make_desc(sQ + wg * 64 * 128);
  const uint64_t ddo_a = make_desc(sdO + wg * 64 * 128);

  float dl0 = 0.f, dl1 = 0.f;  // delta of rows row0, row0 + 8: this thread's part, then the row's
  auto publish_delta = [&]() {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      dl0 += __shfl_xor_sync(0xffffffff, dl0, off);
      dl1 += __shfl_xor_sync(0xffffffff, dl1, off);
    }
    if (t4 == 0) {
      if (row0 < p.S) delta[stat0 + row0] = dl0;
      if (row0 + 8 < p.S) delta[stat0 + row0 + 8] = dl1;
    }
  };

  float dq_acc[NP][32];
#pragma unroll
  for (int n = 0; n < NP; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[n][i] = 0.f;

  // tiles 0 .. ntiles - 1 twice: the first pass sums delta, the second forms dQ
  for (int jj = 0; jj < 2 * ntiles; ++jj) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (jj + 1 < 2 * ntiles) load_kv((jj + 1) % ntiles, (jj + 1) & 1);
    cp_async_commit();
    const bool second = jj >= ntiles;
    if (jj == ntiles) publish_delta();

    const int k0 = (jj % ntiles) * BK;
    if (k0 < wg_end) {  // uniform over the warpgroup
      const uint32_t sK = sKV + (jj & 1) * 2 * KV_BYTES, sV = sK + KV_BYTES;
      // S = Q K^T and dP = dO V^T: 64 rows x 64 keys each
      float s[32], dp[32];
      wg_fence();
      product_ss<D, 64, BQ, BK>(s, dq_a, make_desc(sK));
      product_ss<D, 64, BQ, BK>(dp, ddo_a, make_desc(sV));
      wg_commit();
      wg_wait0();
      fence_regs(s);
      fence_regs(dp);

      if (k0 + BK > p.T || (p.causal && k0 + BK - 1 > wr0 + p.offs)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = k0 + (i >> 2) * 8 + t4 * 2 + (i & 1);
          const int qpos = (i & 2) ? qpos1 : qpos0;
          if (key >= p.T || (p.causal && key > qpos)) s[i] = -INFINITY;
        }
      }
      if (!second) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float pr = ex2(fmaf(s[i], sl2, (i & 2) ? -ls1 : -ls0));
          if (i & 2) dl1 = fmaf(pr, dp[i], dl1);
          else dl0 = fmaf(pr, dp[i], dl0);
        }
      } else {
        // dS = P o (dP - delta), in fp32, into dp
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float pr = ex2(fmaf(s[i], sl2, (i & 2) ? -ls1 : -ls0));
          dp[i] = pr * (dp[i] - ((i & 2) ? dl1 : dl0));
        }
        uint32_t a[BK / 16][4];
        pack_a<BK>(a, dp);
        // dQ += dS K, K read MN-major
        wg_fence();
        product_rs<NP, BK / 16, BK>(dq_acc, a, sK);
        wg_commit();
        wg_wait0();
#pragma unroll
        for (int n = 0; n < NP; ++n) fence_acc(dq_acc[n]);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i]) :: "memory");
      }
    }
  }
  if (ntiles == 0) publish_delta();  // no key for any row: delta 0
  cp_async_wait<0>();
  // dQ leaves through this warpgroup's Q rows in shared memory
  store_rows<D, BQ>(dq_acc, p.scale, sQ + wg * 64 * 128, dq + b * bp.dq_sb + h * bp.dq_sh,
                    bp.dq_ss, wr0, p.S, 1 + wg);
}

// Shared memory of the dK/dV kernel: the CTA's K and V (BKC x D each), two
// stages of Q and dO (BN x D each), swizzled, then two stages of BN floats
// of LSE and BN of delta.
template <int D, int BN>
constexpr size_t dkdv_smem_bytes() {
  return (size_t)(2 * BKC * D + 2 * 2 * BN * D) * 2 + 2 * 2 * BN * 4 + 1024;
}

// dV = P^T dO and dK = scale dS^T Q for a tile of BKC keys of one KV head,
// over the G query heads of its group and the query tiles (BN rows) that
// see any of its keys; each warpgroup takes 64 keys and forms S^T = K Q^T
// and dP^T = V dO^T, so that P^T and dS^T are A operands as they stand.
template <int D, int BN>
__global__ void __launch_bounds__(THREADS, 1)
fa_bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, BwdParams bp) {
  const Params& p = bp.p;
  constexpr int NP = D / 64;
  constexpr int NA = BN / 2;              // accumulator floats a thread of a 64 x BN product
  constexpr uint32_t KT_BYTES = BKC * D * 2;
  constexpr uint32_t QT_BYTES = BN * D * 2;
  static_assert(BN == 32 || BN == 64, "query tiles of 32 or 64 rows");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sK = (base + 1023u) & ~1023u;
  const uint32_t sV = sK + KT_BYTES;
  const uint32_t sRing = sV + KT_BYTES;   // stage s: Q at sRing + 2 s QT_BYTES, dO after it
  const uint32_t sStat = sRing + 4 * QT_BYTES;  // stage s: BN of LSE, then BN of delta
  const float* const stat = reinterpret_cast<const float*>(smem_raw + (sStat - base));

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // key tiles in order, each over all (batch, KV head) pairs: with the
  // causal mask the first see the most query rows, so they start first
  const int kt = (int)blockIdx.x / (p.B * p.KV);
  const int bkv = (int)blockIdx.x % (p.B * p.KV);
  const int b = bkv / p.KV, kvh = bkv % p.KV;
  const int k0c = kt * BKC, kw0 = k0c + wg * 64;

  // the query tiles that see any of the CTA's keys: with the mask, those
  // whose last row sits at or past the first key
  const int nq = (p.S + BN - 1) / BN;
  int qt_first = 0;
  if (p.causal) {
    const int lo = k0c - p.offs - (BN - 1);
    qt_first = lo <= 0 ? 0 : (lo + BN - 1) / BN;
  }
  const int nqv = max(nq - qt_first, 0);
  const int n_it = p.group * nqv;         // (head of the group, query tile) pairs

  auto load_q = [&](int it) {             // pair it into stage it % 2
    const int hh = kvh * p.group + it / nqv, r0 = (qt_first + it % nqv) * BN;
    const uint32_t st = sRing + (it & 1) * 2 * QT_BYTES;
    load_tile<BN, D>(st, q + b * p.q_sb + hh * p.q_sh, p.q_ss, r0, p.S, tid);
    load_tile<BN, D>(st + QT_BYTES, dout + b * bp.do_sb + hh * bp.do_sh, bp.do_ss, r0, p.S, tid);
    if (tid < 2 * BN) {  // rows past S read zeros: their Q and dO are zeros, so they add nothing
      const int r = tid % BN;
      const bool in = r0 + r < p.S;
      const float* src = (tid < BN ? lse : delta) + (long long)(b * p.H + hh) * p.S;
      cp_async4(sStat + (it & 1) * 2 * BN * 4 + tid * 4, in ? src + r0 + r : src, in);
    }
  };

  load_tile<BKC, D>(sK, k + b * p.k_sb + kvh * p.k_sh, p.k_st, k0c, p.T, tid);
  load_tile<BKC, D>(sV, v + b * p.v_sb + kvh * p.v_sh, p.v_st, k0c, p.T, tid);
  if (n_it > 0) load_q(0);
  cp_async_commit();

  const int key0 = kw0 + warp * 16 + g;   // this thread's keys: key0, key0 + 8
  const float sl2 = p.scale * LOG2E;
  const uint64_t dk_a = make_desc(sK + wg * 64 * 128);
  const uint64_t dv_a = make_desc(sV + wg * 64 * 128);

  float dk_acc[NP][32], dv_acc[NP][32];
#pragma unroll
  for (int n = 0; n < NP; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      dk_acc[n][i] = 0.f;
      dv_acc[n][i] = 0.f;
    }

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (it + 1 < n_it) load_q(it + 1);
    cp_async_commit();

    const int r0 = (qt_first + it % nqv) * BN;
    if (p.causal && r0 + BN - 1 + p.offs < kw0) continue;  // no row of the tile sees these keys
    const uint32_t sQt = sRing + (it & 1) * 2 * QT_BYTES, sdOt = sQt + QT_BYTES;
    const float* const st = stat + (it & 1) * 2 * BN;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x BN rows each
    float s[NA], dp[NA];
    wg_fence();
    product_ss<D, BN, BKC, BN>(s, dk_a, make_desc(sQt));
    product_ss<D, BN, BKC, BN>(dp, dv_a, make_desc(sdOt));
    wg_commit();
    wg_wait0();
    fence_regs(s);
    fence_regs(dp);

    if (p.causal && kw0 + 63 > r0 + p.offs) {  // the tile holds the diagonal
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int key = key0 + ((i & 2) ? 8 : 0);
        const int row = r0 + (i >> 2) * 8 + t4 * 2 + (i & 1);
        if (key > row + p.offs) s[i] = -INFINITY;
      }
    }
    // P^T = exp(scale S^T - LSE) into s, dS^T = P^T o (dP^T - delta) into dp;
    // columns (i >> 2) 8 + 2 t4 and + 1 are the rows of LSE and delta
#pragma unroll
    for (int i = 0; i < NA; i += 2) {
      const int c = (i >> 2) * 8 + t4 * 2;
      const float2 ls = *reinterpret_cast<const float2*>(st + c);
      const float2 dl = *reinterpret_cast<const float2*>(st + BN + c);
      s[i] = ex2(fmaf(s[i], sl2, -ls.x * LOG2E));
      s[i + 1] = ex2(fmaf(s[i + 1], sl2, -ls.y * LOG2E));
      dp[i] = s[i] * (dp[i] - dl.x);
      dp[i + 1] = s[i + 1] * (dp[i + 1] - dl.y);
    }
    uint32_t ap[BN / 16][4], as[BN / 16][4];
    pack_a<BN>(ap, s);
    pack_a<BN>(as, dp);
    // dV += P^T dO and dK += dS^T Q, dO and Q read MN-major
    wg_fence();
    product_rs<NP, BN / 16, BN>(dv_acc, ap, sdOt);
    product_rs<NP, BN / 16, BN>(dk_acc, as, sQt);
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int n = 0; n < NP; ++n) {
      fence_acc(dv_acc[n]);
      fence_acc(dk_acc[n]);
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        asm volatile("" : "+r"(ap[kk][i]) :: "memory");
        asm volatile("" : "+r"(as[kk][i]) :: "memory");
      }
  }
  cp_async_wait<0>();
  // dK and dV leave through this warpgroup's own K and V rows in shared memory
  store_rows<D, BKC>(dk_acc, p.scale, sK + wg * 64 * 128, dk + b * bp.dk_sb + kvh * bp.dk_sh,
                     bp.dk_st, kw0, p.T, 1 + wg);
  store_rows<D, BKC>(dv_acc, 1.f, sV + wg * 64 * 128, dv + b * bp.dv_sb + kvh * bp.dv_sh,
                     bp.dv_st, kw0, p.T, 1 + wg);
}

// ---------------------------------------------------------------------------
// float32: mma.sync on tf32 operand splits (3xTF32)
// ---------------------------------------------------------------------------
// The kernel's shape at head dimension D
template <int D>
struct F32 {
  static constexpr int WARPS = 4;               // 16 query rows each
  static constexpr int ROWS = 16 * WARPS;       // query rows per CTA
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BK = D == 64 ? 64 : 32;  // keys per K/V tile (shared memory)
  static constexpr int LD = D + 4;              // row stride of every tile in shared memory, floats
  // two CTAs an SM at D = 64 and 128 (shared memory), one at wider heads
  static constexpr int MIN_BLOCKS = D <= 128 ? 2 : 1;
  // Q (ROWS x D), then two stages of K (BK x D) and V (BK x D), each row
  // padded to LD floats (the fragment loads are then free of bank
  // conflicts: see the note at the head of the file)
  static constexpr size_t SMEM = (size_t)(ROWS + 4 * BK) * LD * 4;
};

// Rows [row0, row0 + R) of a (rows, D) fp32 matrix with row stride `ld`
// into the tile at `dst` (rows of D + 4 floats); rows at or past `nrows`
// are zeros.  At D > 128 the copies are issued by a loop that is not
// unrolled: unrolled, the compiler keeps every copy's address in registers
// across the K/V loop, and the kernel spills.
template <int R, int D>
__device__ __forceinline__ void load_tile_f32(uint32_t dst, const float* src, long long ld,
                                              int row0, int nrows, int tid) {
  constexpr int CPR = D / 4;  // 16-byte chunks per row
  constexpr int THREADS = F32<D>::THREADS;
  constexpr int N = R * CPR / THREADS;
  static_assert(N * THREADS == R * CPR, "tile must split evenly over the CTA");
  auto copy = [&](int it) {
    const int i = it * THREADS + tid;
    const int r = i / CPR, c = i % CPR;
    const bool in = row0 + r < nrows;
    const float* s = in ? src + (long long)(row0 + r) * ld + c * 4 : src;
    cp_async16(dst + (uint32_t)(r * (D + 4) + c * 4) * 4, s, in);
  };
  if constexpr (D <= 128) {
#pragma unroll
    for (int it = 0; it < N; ++it) copy(it);
  } else {
#pragma unroll 1
    for (int it = 0; it < N; ++it) copy(it);
  }
}

// x rounded to tf32 as cvt.rna.tf32.f32 rounds a finite x: to nearest on
// the low 13 mantissa bits, ties away from zero (a carry runs into the
// exponent).  Written as the add and the mask; the cvt adds a NaN test
// and a select around them.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo: hi is x rounded to tf32, lo the rest rounded the same way;
// hi + lo is x within about 2^-22 |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// D(16x8, fp32) += A(16x8) B(8x8), tf32 operands
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A B in three tf32 products of the splits, the small terms first:
// lo hi + hi lo + hi hi (lo lo, about 2^-22 of the product, is dropped)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

template <int D>
__global__ void __launch_bounds__(F32<D>::THREADS, F32<D>::MIN_BLOCKS)
fa_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o, Params p) {
  constexpr int FBQ = F32<D>::ROWS;
  constexpr int BKF = F32<D>::BK;
  constexpr int LD = F32<D>::LD;
  constexpr int NB = BKF / 8;     // 8-key blocks of a tile
  constexpr int ND = D / 8;       // 8-column blocks of d
  constexpr int KV_FLOATS = BKF * LD;

  extern __shared__ __align__(16) float fsm[];
  float* const Qs = fsm;                  // [FBQ][LD]
  float* const KVs = Qs + FBQ * LD;       // stage s: K at KVs + 2 s KV_FLOATS, V after it
  const uint32_t sQ = smem_u32(Qs), sKV = smem_u32(KVs);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // launch order as the bf16 kernel's: groups of (batch, head) pairs, each
  // group's query tiles heaviest first
  const int nq = (p.S + FBQ - 1) / FBQ;
  const int group_ctas = p.bh_per_group * nq;
  const int first = (int)blockIdx.x / group_ctas * p.bh_per_group;
  const int rem = (int)blockIdx.x % group_ctas;
  const int gsize = min(p.bh_per_group, p.B * p.H - first);
  const int bh = first + rem % gsize;
  const int q0 = (nq - 1 - rem / gsize) * FBQ;
  const int h = bh % p.H, b = bh / p.H;
  const int kvh = h / p.group;

  const float* qb = q + b * p.q_sb + h * p.q_sh;
  const float* kb = k + b * p.k_sb + kvh * p.k_sh;
  const float* vb = v + b * p.v_sb + kvh * p.v_sh;
  auto load_kv = [&](int t) {  // tile t into stage t % 2
    const uint32_t st = sKV + (uint32_t)((t & 1) * 2 * KV_FLOATS) * 4;
    load_tile_f32<BKF, D>(st, kb, p.k_st, t * BKF, p.T, tid);
    load_tile_f32<BKF, D>(st + KV_FLOATS * 4, vb, p.v_st, t * BKF, p.T, tid);
  };

  const int kv_end = kv_end_for_tile(p, q0, FBQ);
  const int ntiles = (kv_end + BKF - 1) / BKF;
  load_tile_f32<FBQ, D>(sQ, qb, p.q_ss, q0, p.S, tid);
  if (ntiles > 0) load_kv(0);
  cp_async_commit();

  const int wr0 = q0 + warp * 16;         // this warp's first row
  const int w_end = wr0 < p.S ? kv_end_for_tile(p, wr0, 16) : 0;
  const int qpos0 = wr0 + g + p.offs, qpos1 = qpos0 + 8;  // this thread's rows g, g + 8
  const float sl2 = p.scale * 1.4426950408889634f;       // scores in log2 units
  const float* const Qa = Qs + (warp * 16 + g) * LD + t4;  // A fragment of Q, k-step 0

  float o_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o_acc[n][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<0>();  // tile j (and, at j = 0, Q) has landed
    __syncthreads();     // ... for every thread, and every thread is done with tile j - 1
    if (j + 1 < ntiles) load_kv(j + 1);  // into tile j - 1's stage, while tile j is used
    cp_async_commit();

    const int k0 = j * BKF;
    if (k0 >= w_end) continue;  // uniform over the warp
    const float* const Ks = KVs + (j & 1) * 2 * KV_FLOATS;
    const float* const Vs = Ks + KV_FLOATS;

    // S = Q K^T: 16 rows x BKF keys; the accumulator of key block nb holds
    // (row g, keys 8 nb + 2 t4, + 1) and (row g + 8, the same keys)
    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nb][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ah[4], al[4];  // (g, t4), (g + 8, t4), (g, t4 + 4), (g + 8, t4 + 4)
      split_tf32(Qa[kk * 8], ah[0], al[0]);
      split_tf32(Qa[kk * 8 + 8 * LD], ah[1], al[1]);
      split_tf32(Qa[kk * 8 + 4], ah[2], al[2]);
      split_tf32(Qa[kk * 8 + 8 * LD + 4], ah[3], al[3]);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {  // B(d, key) = K[key][d]: key 8 nb + g, d t4 and t4 + 4
        const float* const kr = Ks + (nb * 8 + g) * LD + kk * 8 + t4;
        mma_3xtf32(s[nb], ah, al, kr[0], kr[4]);
      }
    }

    // mask only the tile that holds this warp's diagonal or T's end
    if (k0 + BKF > p.T || (p.causal && k0 + BKF - 1 > wr0 + p.offs)) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + nb * 8 + t4 * 2 + (i & 1);
          const int qpos = (i & 2) ? qpos1 : qpos0;
          if (key >= p.T || (p.causal && key > qpos)) s[nb][i] = -INFINITY;
        }
    }

    // online softmax in fp32, log2 units
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row that has seen no key yet keeps p = 0 (exp2(-inf - 0))
    const float mu0 = (mn0 == -INFINITY) ? 0.f : mn0 * sl2;
    const float mu1 = (mn1 == -INFINITY) ? 0.f : mn1 * sl2;
    const float c0 = ex2(m0 * sl2 - mu0), c1 = ex2(m1 * sl2 - mu1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      s[nb][0] = ex2(fmaf(s[nb][0], sl2, -mu0));
      s[nb][1] = ex2(fmaf(s[nb][1], sl2, -mu0));
      s[nb][2] = ex2(fmaf(s[nb][2], sl2, -mu1));
      s[nb][3] = ex2(fmaf(s[nb][3], sl2, -mu1));
      ps0 += s[nb][0] + s[nb][1];
      ps1 += s[nb][2] + s[nb][3];
    }
    l0 = l0 * c0 + ps0;  // per-thread partial row sums, reduced at the end
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o_acc[n][0] *= c0;
      o_acc[n][1] *= c0;
      o_acc[n][2] *= c1;
      o_acc[n][3] *= c1;
    }

    // O += P V.  P's accumulator is the A fragment as it stands, with the
    // keys of block nb taken in the order 2 t4 -> k index t4, 2 t4 + 1 ->
    // t4 + 4; V's B fragment reads its rows in the same order.
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      uint32_t ah[4], al[4];
      split_tf32(s[nb][0], ah[0], al[0]);
      split_tf32(s[nb][2], ah[1], al[1]);
      split_tf32(s[nb][1], ah[2], al[2]);
      split_tf32(s[nb][3], ah[3], al[3]);
      // B(key, d) = V[key][d]: keys 8 nb + 2 t4 and + 1, column 8 n + g
      const float* const vr = Vs + (nb * 8 + 2 * t4) * LD + g;
#pragma unroll
      for (int n = 0; n < ND; ++n) mma_3xtf32(o_acc[n], ah, al, vr[n * 8], vr[LD + n * 8]);
    }
  }
  cp_async_wait<0>();  // with no tile at all, nothing is left in flight at exit

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffff, l0, off);
    l1 += __shfl_xor_sync(0xffffffff, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  // each quad writes 32 contiguous bytes of a row
  float* const ob = o + b * p.o_sb + h * p.o_sh;
  const int r0 = wr0 + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c = n * 8 + 2 * t4;
    if (r0 < p.S)
      *reinterpret_cast<float2*>(ob + (long long)r0 * p.o_ss + c) =
          make_float2(o_acc[n][0] * inv0, o_acc[n][1] * inv0);
    if (r1 < p.S)
      *reinterpret_cast<float2*>(ob + (long long)r1 * p.o_ss + c) =
          make_float2(o_acc[n][2] * inv1, o_acc[n][3] * inv1);
  }
}

template <typename T>
cudaError_t launch(void (*kern)(const T*, const T*, const T*, T*, Params), dim3 grid,
                   int threads, size_t smem, cudaStream_t stream, const void* q,
                   const void* k, const void* v, void* o, const Params& p) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                        static_cast<const T*>(v), static_cast<T*>(o), p);
  return cudaGetLastError();
}

using bf16 = __nv_bfloat16;

template <int D, bool WITH_LSE>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                        const Params& p, cudaStream_t stream) {
  // D = 64 fits two CTAs on an SM (<= 128 registers a thread); wider
  // heads hold a larger O accumulator and take one
  constexpr int MIN_BLOCKS = D == 64 ? 2 : 1;
  const auto kern = fa_fwd_bf16<D, MIN_BLOCKS, WITH_LSE>;
  const size_t smem = bf16_smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((p.S + BQ - 1) / BQ) * p.H * p.B);
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                        static_cast<const bf16*>(v), static_cast<bf16*>(o), p,
                                        lse);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(int is_bf16, const void* q, const void* k, const void* v, void* o,
                     const Params& p, cudaStream_t stream) {
  if (is_bf16) return launch_bf16<D, false>(q, k, v, o, nullptr, p, stream);
  using C = F32<D>;
  dim3 grid((unsigned)((p.S + C::ROWS - 1) / C::ROWS) * p.H * p.B);
  return launch<float>(fa_fwd_f32<D>, grid, C::THREADS, C::SMEM, stream, q, k, v, o, p);
}

// dQ (and delta), then dK and dV, on one stream: the second kernel reads
// the delta the first wrote.  D = 128 takes query tiles of 32 rows in the
// dK/dV kernel, so that its two accumulators of 64 registers a thread
// leave room for the scores.
template <int D>
cudaError_t dispatch_bwd(const void* q, const void* k, const void* v, const float* lse,
                         const void* dout, void* dq, void* dk, void* dv, float* delta,
                         const BwdParams& bp, cudaStream_t stream) {
  constexpr int BN = D == 64 ? 64 : 32;
  const Params& p = bp.p;
  const auto kdq = fa_bwd_dq_bf16<D>;
  const size_t smem_dq = dq_smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return err;
  dim3 grid_dq((unsigned)((p.S + BQ - 1) / BQ) * p.H * p.B);
  kdq<<<grid_dq, THREADS, smem_dq, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, static_cast<bf16*>(dq), delta, bp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const auto kdkdv = fa_bwd_dkdv_bf16<D, BN>;
  const size_t smem_kv = dkdv_smem_bytes<D, BN>();
  err = cudaFuncSetAttribute(kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
  if (err != cudaSuccess) return err;
  dim3 grid_kv((unsigned)((p.T + BKC - 1) / BKC) * p.KV * p.B);
  kdkdv<<<grid_kv, THREADS, smem_kv, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      bp);
  return cudaGetLastError();
}

Params make_params(int is_bf16, int B, int H, int KV, int S, int T, int D, int causal,
                   float scale, long long q_sb, long long q_sh, long long q_ss,
                   long long k_sb, long long k_sh, long long k_st,
                   long long v_sb, long long v_sh, long long v_st,
                   long long o_sb, long long o_sh, long long o_ss) {
  Params p;
  p.B = B; p.H = H; p.KV = KV; p.S = S; p.T = T; p.group = H / KV;
  p.causal = causal; p.offs = T - S; p.scale = scale;
  // a group's K and V together take at most 16 MiB, a third of the 50 MB
  // L2, so that they stay there while the group's CTAs run (a query head's
  // share of its KV head is T * D * 2 * (element bytes) / group bytes)
  const long long kv_share = (long long)T * D * (is_bf16 ? 4 : 8) / p.group;
  const long long per = (16LL << 20) / (kv_share > 0 ? kv_share : 1);
  p.bh_per_group = per < 1 ? 1 : per > (long long)B * H ? B * H : (int)per;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_st = k_st;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_st = v_st;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  return p;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success); the caller
// has checked shapes, dtypes, strides (innermost stride 1, the others
// multiples of 16 bytes) and that D is 64, 128, 192 or 256.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int is_bf16,
    int B, int H, int KV, int S, int T, int D, int causal, float scale,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st,
    long long o_sb, long long o_sh, long long o_ss, void* stream) {
  const Params p = make_params(is_bf16, B, H, KV, S, T, D, causal, scale, q_sb, q_sh, q_ss,
                               k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb, o_sh, o_ss);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)dispatch<64>(is_bf16, q, k, v, o, p, st);
    case 128: return (int)dispatch<128>(is_bf16, q, k, v, o, p, st);
    case 192: return (int)dispatch<192>(is_bf16, q, k, v, o, p, st);
    case 256: return (int)dispatch<256>(is_bf16, q, k, v, o, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16 forward that also writes each row's log-sum-exp to `lse`, a
// contiguous (B, H, S) fp32 buffer; D is 64 or 128, the rest as above.
extern "C" int flash_attention_fwd_lse(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int H, int KV, int S, int T, int D, int causal, float scale,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st,
    long long o_sb, long long o_sh, long long o_ss, void* stream) {
  const Params p = make_params(1, B, H, KV, S, T, D, causal, scale, q_sb, q_sh, q_ss,
                               k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb, o_sh, o_ss);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 64: return (int)launch_bf16<64, true>(q, k, v, o, l, p, st);
    case 128: return (int)launch_bf16<128, true>(q, k, v, o, l, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The bf16 backward from the forward's `lse`: writes dq (q's shape), dk
// and dv (k's), and `delta` (contiguous (B, H, S) fp32, scratch).  Two
// launches; returns the first error.  The caller has checked what
// flash_attention_fwd's has, for dout, dq, dk and dv too, and that D is 64
// or 128.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* lse, const void* dout,
    void* dq, void* dk, void* dv, void* delta,
    int B, int H, int KV, int S, int T, int D, int causal, float scale,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st,
    long long do_sb, long long do_sh, long long do_ss,
    long long dq_sb, long long dq_sh, long long dq_ss,
    long long dk_sb, long long dk_sh, long long dk_st,
    long long dv_sb, long long dv_sh, long long dv_st, void* stream) {
  BwdParams bp;
  bp.p = make_params(1, B, H, KV, S, T, D, causal, scale, q_sb, q_sh, q_ss,
                     k_sb, k_sh, k_st, v_sb, v_sh, v_st, 0, 0, 0);
  bp.do_sb = do_sb; bp.do_sh = do_sh; bp.do_ss = do_ss;
  bp.dq_sb = dq_sb; bp.dq_sh = dq_sh; bp.dq_ss = dq_ss;
  bp.dk_sb = dk_sb; bp.dk_sh = dk_sh; bp.dk_st = dk_st;
  bp.dv_sb = dv_sb; bp.dv_sh = dv_sh; bp.dv_st = dv_st;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (D) {
    case 64: return (int)dispatch_bwd<64>(q, k, v, l, dout, dq, dk, dv, dl, bp, st);
    case 128: return (int)dispatch_bwd<128>(q, k, v, l, dout, dq, dk, dv, dl, bp, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
