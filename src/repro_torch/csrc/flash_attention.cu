// Flash attention forward for Hopper (sm_90a), bound to Python with ctypes.
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
// float32 inputs take a scalar kernel (CUDA cores, fp32 FMA), because the
// tensor cores would round fp32 operands to tf32.
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

template <int D, int MIN_BLOCKS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fa_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, Params p) {
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
// float32: scalar kernel
// ---------------------------------------------------------------------------
constexpr int FBQ = 16;  // query rows per CTA (4 per warp)
constexpr int FBK = 32;  // keys per tile, one per lane

template <int D>
__global__ void __launch_bounds__(128)
fa_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o, Params p) {
  constexpr int KLD = D + 1;  // odd row stride: lane j reads row j conflict-free
  constexpr int NC = D / 32;  // output columns per lane
  constexpr int RW = FBQ / 4; // rows per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [FBQ][D], pre-scaled
  float* Ks = Qs + FBQ * D;                         // [FBK][KLD]
  float* Vs = Ks + FBK * KLD;                       // [FBK][D]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * FBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.group;
  const float* qb = q + b * p.q_sb + h * p.q_sh;
  const float* kb = k + b * p.k_sb + kvh * p.k_sh;
  const float* vb = v + b * p.v_sb + kvh * p.v_sh;

  for (int i = tid; i < FBQ * D; i += blockDim.x) {
    int r = i / D, c = i % D;
    Qs[i] = (q0 + r < p.S) ? qb[(long long)(q0 + r) * p.q_ss + c] * p.scale : 0.f;
  }

  float acc[RW][NC], m[RW], l[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = kv_end_for_tile(p, q0, FBQ);
  for (int k0 = 0; k0 < kv_end; k0 += FBK) {
    __syncthreads();
    for (int i = tid; i < FBK * D; i += blockDim.x) {
      int r = i / D, c = i % D;
      bool in = k0 + r < p.T;
      Ks[r * KLD + c] = in ? kb[(long long)(k0 + r) * p.k_st + c] : 0.f;
      Vs[r * D + c] = in ? vb[(long long)(k0 + r) * p.v_st + c] : 0.f;
    }
    __syncthreads();
    const int key = k0 + lane;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int row = warp * RW + i;
      const int qpos = q0 + row + p.offs;
      float sc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) sc = fmaf(Qs[row * D + d], Ks[lane * KLD + d], sc);
      if (key >= p.T || (p.causal && key > qpos)) sc = -INFINITY;
      float mx = sc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float mu = (mn == -INFINITY) ? 0.f : mn;
      const float corr = expf(m[i] - mu);
      const float pr = expf(sc - mu);
      float ps = pr;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffff, ps, off);
      m[i] = mn;
      l[i] = l[i] * corr + ps;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
      for (int j = 0; j < FBK; ++j) {
        const float pj = __shfl_sync(0xffffffff, pr, j);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pj, Vs[j * D + lane + 32 * c], acc[i][c]);
      }
    }
  }

  float* ob = o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int row = q0 + warp * RW + i;
    if (row >= p.S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) ob[(long long)row * p.o_ss + lane + 32 * c] = acc[i][c] * inv;
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

template <int D>
cudaError_t dispatch(int is_bf16, const void* q, const void* k, const void* v, void* o,
                     const Params& p, cudaStream_t stream) {
  if (is_bf16) {
    // D = 64 fits two CTAs on an SM (<= 128 registers a thread); wider
    // heads hold a larger O accumulator and take one
    constexpr int MIN_BLOCKS = D == 64 ? 2 : 1;
    dim3 grid((unsigned)((p.S + BQ - 1) / BQ) * p.H * p.B);
    return launch<__nv_bfloat16>(fa_fwd_bf16<D, MIN_BLOCKS>, grid, THREADS,
                                 bf16_smem_bytes<D>(), stream, q, k, v, o, p);
  }
  size_t smem = (size_t)(FBQ * D + FBK * (D + 1) + FBK * D) * 4;
  dim3 grid((p.S + FBQ - 1) / FBQ, p.H, p.B);
  return launch<float>(fa_fwd_f32<D>, grid, 128, smem, stream, q, k, v, o, p);
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
  Params p;
  p.B = B; p.H = H; p.KV = KV; p.S = S; p.T = T; p.group = H / KV;
  p.causal = causal; p.offs = T - S; p.scale = scale;
  // a group's K and V together take at most 16 MiB, a third of the 50 MB
  // L2, so that they stay there while the group's CTAs run (a query head's
  // share of its KV head is T * D * 4 / group bytes)
  const long long kv_share = (long long)T * D * 4 / p.group;
  const long long per = (16LL << 20) / (kv_share > 0 ? kv_share : 1);
  p.bh_per_group = per < 1 ? 1 : per > (long long)B * H ? B * H : (int)per;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_st = k_st;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_st = v_st;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)dispatch<64>(is_bf16, q, k, v, o, p, st);
    case 128: return (int)dispatch<128>(is_bf16, q, k, v, o, p, st);
    case 192: return (int)dispatch<192>(is_bf16, q, k, v, o, p, st);
    case 256: return (int)dispatch<256>(is_bf16, q, k, v, o, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
