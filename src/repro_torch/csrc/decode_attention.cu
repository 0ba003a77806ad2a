// Flash decode for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel `flash_decode` / `_decode_kernel` in
// src/repro/kernels/decode_attention.py: one query token per (batch, head)
// against a KV cache with a per-batch valid length, fp32 online softmax,
// P rounded to the cache's dtype before P V.
//
// What bounds it on the card: bytes.  Each valid cache position is read
// once (K and V, D values each per KV head) and used for 4 * D operations
// per query head of its group, far below the ~295 operations per byte at
// which the tensor cores would become the limit.  At TinyLlama's serve
// shape (B = 8, KV = 4, D = 64, 1064 positions) that is 8.7 MB, 0.0026 ms
// at 3.35 TB/s; one (batch, KV head) pair holds only 272 KB of it.
//
// The design, and what each part does about that:
// - The cache axis is split across CTAs.  On the TPU the KV blocks are the
//   grid's innermost sequential axis with (m, l, acc) in scratch; here the
//   C CTAs of a (batch, KV head) pair each take a contiguous slice of
//   [0, length[b]) and keep a partial (m, l, acc) in fp32, so that B * KV *
//   C CTAs stream the cache at once (C is chosen on the host from B, KV
//   and T, about two CTAs per SM: 8 at TinyLlama's 32 pairs, 1 at Zamba2's
//   256, where more CTAs a pair measured slower).  The C CTAs form
//   one thread-block cluster along grid.x.  After a cluster barrier each
//   CTA merges a share of the outputs from all C partials, read through
//   distributed shared memory, by log-sum-exp, and writes O; a second
//   cluster barrier keeps every partial alive until it has been read.  One
//   launch, no workspace in device memory.
// - Inside a CTA each of the four warps owns a contiguous run of 16-key
//   chunks and its own online softmax; a CTA's slice is whole tiles of 64
//   keys.  A warp copies its chunks into its own ring of three stages in
//   shared memory with 16-byte `cp.async` copies (the cache is read as the
//   strided view it is, row stride KV * D), two chunks ahead of the one it
//   consumes, so the next chunks' bytes are in flight while this one is
//   used.  The warps need no block barrier until their partials are
//   merged.  K and V stay bf16 in shared memory, each 16-byte chunk c of
//   row r stored at c ^ (r % 8) so that `ldmatrix` reads are conflict-free.
// - Both products run on the tensor cores with `mma.sync.m16n8k16` (bf16
//   in, fp32 accumulate).  The G query heads of the group are the rows of
//   the M = 16 tile (zero rows pad G < 16; G = 32 takes two tiles) and stay
//   in registers as A fragments.  S = Q K^T reads K with `ldmatrix`; P is
//   formed from S's accumulators in registers, rounded to bf16 as the
//   reference rounds it, and is the A operand of P V, whose V fragments
//   come from `ldmatrix.trans` on V's natural [key][d] tile.
// - The merges are NaN-safe: a warp or CTA whose slice lies past length[b]
//   has m = -inf and weighs exp(-inf) = 0 against the largest m, which is
//   taken as 0 when every part is empty; length[b] == 0 gives zeros.
//
// float32 inputs keep a scalar kernel (CUDA cores, fp32 FMA), because the
// tensor cores would round fp32 operands to tf32; it takes the same CTA
// slices and the same cluster merge.
//
// Head dims 64, 128 and 256 (Gemma).  What D = 256 changes (G * D <= 2048
// still, so G <= 8 and one M tile):
// - Registers.  A warp's O accumulators over all of D are 256 / 8 n-tiles
//   x 4 = 128 fp32 registers a lane; Q as A fragments would take another
//   16 k-steps x 4 = 64 and leave too few under the 255 cap.  At D = 256
//   Q is staged once per CTA in shared memory ([16][D] bf16, 8 KB, the
//   rings' swizzle) and read with `ldmatrix` at each k-step, as K is.
//   ptxas (CUDA 12.8, sm_90a) gives decode_bf16<256, 1> 212 registers and
//   no spills.
// - Ring stages.  Three stages stay: a warp's ring is 3 x {K, V} x 16 x
//   256 x 2 B = 48 KB, four warps 192 KB, with Q and the partials about
//   209 KB at G = 8, under the 227 KB a CTA may take.
// - CTAs per SM.  One (two at D = 128, more at D = 64).  A CTA's four
//   warps keep two chunks each in flight, 128 KB an SM, which is more than
//   the memory's latency needs at 3.35 TB/s.
// The fp32 kernel's D = 256 instance needs 146 KB of shared memory at
// G = 8 (K and V tiles of 64 x 257 and 64 x 256 floats).
//
// Semantics beyond the TPU kernel: any cache length T is accepted (no
// T % block_k rule), and length[b] == 0 returns zeros as the TPU kernel does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CHUNK = 16;      // keys per warp step: one K-slice of P V
constexpr int WARPS = 4;       // warps of a bf16 CTA; a tile is WARPS * CHUNK keys
constexpr int MAX_SPLITS = 8;  // CTAs of a cluster (the portable limit)
constexpr int STAGES = 3;      // ring stages per warp
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  int B, H, KV, T, group, splits;
  long long q_sb, q_sh;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh;
  float scale;
};

// Chunks of 16 keys that each warp of the pair's C * WARPS warps takes; the
// warp numbered w (CTA rank r: w = r * WARPS + warp) has chunks
// [w * per, min((w + 1) * per, ceil(n / 16))), so CTA r has the keys
// [r * 64 per, min((r + 1) * 64 per, n)) and trailing CTAs may be empty.
__device__ __forceinline__ int chunks_per_warp(int n, int splits) {
  const int nc = (n + CHUNK - 1) / CHUNK;
  const int nw = splits * WARPS;
  return (nc + nw - 1) / nw;
}

// Each CTA of the cluster has its partial at the start of its shared
// memory: m[G], l[G] (the softmax's max and sum, in log2 units when LOG2),
// o[G][D] (unnormalised).  Every CTA merges a share of the G x D outputs
// from all C partials and writes them.
template <typename T, bool LOG2>
__device__ __forceinline__ void cluster_merge(float* part, T* ob, long long o_sh, int G, int D) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int nthreads = (int)blockDim.x;
  cluster.sync();  // every partial of the cluster is written
  for (int i = (int)cluster.block_rank() * nthreads + threadIdx.x; i < G * D;
       i += C * nthreads) {
    const int gi = i / D, d = i - gi * D;
    float mr[MAX_SPLITS];
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      mr[r] = r < C ? cluster.map_shared_rank(part, r)[gi] : -INFINITY;
      mx = fmaxf(mx, mr[r]);
    }
    const float mu = mx == -INFINITY ? 0.f : mx;
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      if (r < C) {
        const float* pr = cluster.map_shared_rank(part, r);
        const float w = LOG2 ? exp2f(mr[r] - mu) : expf(mr[r] - mu);
        l = fmaf(w, pr[G + gi], l);
        acc = fmaf(w, pr[2 * G + i], acc);
      }
    }
    const float out = acc / fmaxf(l, 1e-30f);
    if constexpr (sizeof(T) == 2)
      ob[gi * o_sh + d] = __float2bfloat16(out);
    else
      ob[gi * o_sh + d] = out;
  }
  cluster.sync();  // no CTA leaves while another reads its partial
}

// ---------------------------------------------------------------------------
// bf16: mma.sync kernel
// ---------------------------------------------------------------------------
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// d(16x8, fp32) += a(16x16, bf16, row) b(16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// Byte offset of 16-byte chunk c of row r in a [16][D] bf16 tile: chunk c
// stored at c ^ (r % 8) within its group of eight.
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * D * 2 + (((c & ~7) | ((c ^ r) & 7)) << 4));
}

// Shared memory of the bf16 kernel: the CTA's partial (m, l, o), then the
// warps' (m, l) rows, then, 128-byte aligned, Q's [16][D] tile when Q_SMEM
// (D = 256), then the warps' rings (each STAGES x {K, V} x [16][D] bf16).
// A warp's ring later holds its o rows.
template <int D, int MT>
struct Bf16Smem {
  static constexpr int ROWS = 16 * MT;
  static constexpr int OLD = D + 8;  // padded row of a warp's o in its ring
  static constexpr uint32_t TILE = CHUNK * D * 2;
  static constexpr uint32_t STAGE = 2 * TILE;
  static constexpr uint32_t RING = STAGES * STAGE;
  static constexpr bool Q_SMEM = D >= 256;  // Q from shared memory, not registers
  static constexpr uint32_t QBYTES = Q_SMEM ? TILE : 0;
  static_assert(ROWS * OLD * 4 <= (int)RING, "a warp's o rows must fit its ring");
  static_assert(!Q_SMEM || MT == 1, "Q in shared memory holds one M tile");
  static __host__ __device__ size_t head_bytes(int G) {
    return (size_t)(2 * G + G * D + 2 * WARPS * ROWS) * 4;
  }
  static __host__ size_t bytes(int G) { return head_bytes(G) + 128 + QBYTES + WARPS * RING; }
};

template <int D, int MT>
__global__ void __launch_bounds__(WARPS * 32)
decode_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const int* __restrict__ length,
            __nv_bfloat16* __restrict__ o, Params p) {
  using L = Bf16Smem<D, MT>;
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  const int G = p.group;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* part = reinterpret_cast<float*>(smem_raw);  // m[G], l[G], o[G][D]
  float* wm = part + 2 * G + G * D;                  // [WARPS][ROWS]
  float* wl = wm + WARPS * L::ROWS;                  // [WARPS][ROWS]
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t qs = (base + (uint32_t)L::head_bytes(G) + 127u) & ~127u;  // Q_SMEM only
  const uint32_t rings = qs + L::QBYTES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int pair = (int)blockIdx.x / p.splits, rank = (int)blockIdx.x % p.splits;
  const int kvh = pair % p.KV, b = pair / p.KV;
  const int n = min(max(length[b], 0), p.T);
  const int nc = (n + CHUNK - 1) / CHUNK;
  const int per = chunks_per_warp(n, p.splits);
  const int c_lo = min((rank * WARPS + warp) * per, nc);
  const int steps = min(c_lo + per, nc) - c_lo;

  const __nv_bfloat16* kb = k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = v + b * p.v_sb + kvh * p.v_sh;
  const uint32_t ring = rings + warp * L::RING;
  auto load = [&](int ck, int st) {  // chunk ck into stage st of this warp's ring
    const uint32_t sK = ring + st * L::STAGE, sV = sK + L::TILE;
#pragma unroll
    for (int it = 0; it < CHUNK * CPR / 32; ++it) {
      const int i = it * 32 + lane;
      const int r = i / CPR, c = i % CPR;
      const int key = ck * CHUNK + r;
      const bool in = key < n;
      const uint32_t off = swz<D>(r, c);
      cp_async16(sK + off, in ? kb + (long long)key * p.k_st + c * 8 : kb, in);
      cp_async16(sV + off, in ? vb + (long long)key * p.v_st + c * 8 : vb, in);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(c_lo + s, s);
    cp_async_commit();
  }

  // Q as A fragments: rows are the group's heads (zeros past G), register j
  // holds row g + 8 (j & 1), columns 16 kk + 2 t4 + 8 (j >> 1) and + 1.
  // With Q_SMEM the CTA stores Q's [16][D] tile (zero rows past G) once,
  // swizzled as the rings are, and each k-step reads its fragment with
  // ldmatrix: matrix lane >> 3 is rows 8 (mi & 1) .. and d-chunk
  // 2 kk + (mi >> 1), registers in the order above.
  uint32_t qa[L::Q_SMEM ? 1 : MT][L::Q_SMEM ? 1 : D / 16][4];
  const __nv_bfloat16* qb = q + b * p.q_sb + (long long)kvh * G * p.q_sh;
  if constexpr (L::Q_SMEM) {
    for (int i = tid; i < 16 * CPR; i += WARPS * 32) {
      const int r = i / CPR, c = i % CPR;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (r < G) {
        const __nv_bfloat16* src = qb + r * p.q_sh + c * 8;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          __nv_bfloat162 two = __halves2bfloat162(src[2 * e], src[2 * e + 1]);
          w[e] = *reinterpret_cast<uint32_t*>(&two);
        }
      }
      *reinterpret_cast<uint4*>(smem_raw + (qs - base) + swz<D>(r, c)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    __syncthreads();
  } else {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = mt * 16 + g + 8 * (j & 1);
          const int col = 16 * kk + 2 * t4 + 8 * (j >> 1);
          uint32_t val = 0;
          if (row < G) {
            const __nv_bfloat16* src = qb + row * p.q_sh + col;
            __nv_bfloat162 two = __halves2bfloat162(src[0], src[1]);
            val = *reinterpret_cast<uint32_t*>(&two);
          }
          qa[mt][kk][j] = val;
        }
  }

  const float sl2 = p.scale * LOG2E;  // scores in log2 units
  float m[MT][2], l[MT][2], oacc[MT][D / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int i = 0; i < 4; ++i) oacc[mt][nd][i] = 0.f;
  }

  for (int j = 0; j < steps; ++j) {
    cp_async_wait<STAGES - 2>();  // chunk j has landed for this lane
    __syncwarp();                 // ... for every lane, which is done with chunk j - 1
    if (j + STAGES - 1 < steps) load(c_lo + j + STAGES - 1, (j + STAGES - 1) % STAGES);
    cp_async_commit();
    const uint32_t sK = ring + (j % STAGES) * L::STAGE, sV = sK + L::TILE;
    const int key0 = (c_lo + j) * CHUNK;

    // S = Q K^T: 16 keys, n-blocks of 8; ldmatrix matrix lane >> 3 is keys
    // 8 (mi >> 1) .. and d-chunk 2 kk + (mi & 1)
    float s[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 8; ++i) s[mt][i >> 2][i & 3] = 0.f;
    {
      const int mi = lane >> 3;
      const int kr = ((mi >> 1) << 3) + (lane & 7);
      const int qr = ((mi & 1) << 3) + (lane & 7);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bk[4];
        ldsm_x4(bk, sK + swz<D>(kr, 2 * kk + (mi & 1)));
        if constexpr (L::Q_SMEM) {
          uint32_t a[4];
          ldsm_x4(a, qs + swz<D>(qr, 2 * kk + (mi >> 1)));
          mma_bf16(s[0][0], a, bk[0], bk[1]);
          mma_bf16(s[0][1], a, bk[2], bk[3]);
        } else {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][0], qa[mt][kk], bk[0], bk[1]);
            mma_bf16(s[mt][1], qa[mt][kk], bk[2], bk[3]);
          }
        }
      }
    }

    // online softmax in fp32, log2 units; the chunk holds at least one
    // valid key (key0 < n), so each row's max is finite
    const bool ragged = key0 + CHUNK > n;
    uint32_t pa[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int key = key0 + (i >> 2) * 8 + 2 * t4 + (i & 1);
        const float x = s[mt][i >> 2][i & 3] * sl2;
        s[mt][i >> 2][i & 3] = (ragged && key >= n) ? -INFINITY : x;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // row g (h = 0) and row g + 8
        float mx = fmaxf(fmaxf(s[mt][0][2 * h], s[mt][0][2 * h + 1]),
                         fmaxf(s[mt][1][2 * h], s[mt][1][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, 2));
        const float mn = fmaxf(m[mt][h], mx);
        const float corr = ex2(m[mt][h] - mn);
        m[mt][h] = mn;
        float sum = 0.f;
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pe = ex2(s[mt][nb][2 * h + e] - mn);
            s[mt][nb][2 * h + e] = pe;
            sum += pe;
          }
        l[mt][h] = l[mt][h] * corr + sum;
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          oacc[mt][nd][2 * h] *= corr;
          oacc[mt][nd][2 * h + 1] *= corr;
        }
      }
      // P as the A operand (keys 0..7 are n-block 0, keys 8..15 n-block 1)
      pa[mt][0] = pack_bf16(s[mt][0][0], s[mt][0][1]);
      pa[mt][1] = pack_bf16(s[mt][0][2], s[mt][0][3]);
      pa[mt][2] = pack_bf16(s[mt][1][0], s[mt][1][1]);
      pa[mt][3] = pack_bf16(s[mt][1][2], s[mt][1][3]);
    }

    // O += P V; ldmatrix.trans matrix mi is keys 8 (mi & 1) .. and
    // d-chunk nd + (mi >> 1): fragments of the n-blocks nd and nd + 1
    {
      const int mi = lane >> 3;
      const int vr = ((mi & 1) << 3) + (lane & 7);
#pragma unroll
      for (int nd = 0; nd < D / 8; nd += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, sV + swz<D>(vr, nd + (mi >> 1)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(oacc[mt][nd], pa[mt], bv[0], bv[1]);
          mma_bf16(oacc[mt][nd + 1], pa[mt], bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncwarp();  // the ring is free: it takes this warp's o rows

  float* wo = reinterpret_cast<float*>(smem_raw + (ring - base));  // [ROWS][OLD]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[mt][h];
      lt += __shfl_xor_sync(0xffffffff, lt, 1);
      lt += __shfl_xor_sync(0xffffffff, lt, 2);
      const int row = mt * 16 + g + 8 * h;
      if (t4 == 0) {
        wm[warp * L::ROWS + row] = m[mt][h];
        wl[warp * L::ROWS + row] = lt;
      }
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
        *reinterpret_cast<float2*>(wo + row * L::OLD + nd * 8 + 2 * t4) =
            make_float2(oacc[mt][nd][2 * h], oacc[mt][nd][2 * h + 1]);
    }
  __syncthreads();

  // the CTA's partial from its warps' (log-sum-exp; an empty warp weighs 0)
  for (int i = tid; i < G * D; i += WARPS * 32) {
    const int gi = i / D, d = i - gi * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wm[w * L::ROWS + gi]);
    const float mu = mx == -INFINITY ? 0.f : mx;
    float lsum = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = ex2(wm[w * L::ROWS + gi] - mu);
      const float* wow = reinterpret_cast<const float*>(
          smem_raw + (rings - base) + w * L::RING);
      lsum = fmaf(wt, wl[w * L::ROWS + gi], lsum);
      acc = fmaf(wt, wow[gi * L::OLD + d], acc);
    }
    part[2 * G + i] = acc;
    if (d == 0) {
      part[gi] = mx;
      part[G + gi] = lsum;
    }
  }
  cluster_merge<__nv_bfloat16, true>(part, o + b * p.o_sb + (long long)kvh * G * p.o_sh,
                                     p.o_sh, G, D);
}

// ---------------------------------------------------------------------------
// float32: scalar kernel, one CTA per slice
// ---------------------------------------------------------------------------
constexpr int F_THREADS = 256;
constexpr int F_BK = 64;     // cache positions per tile
constexpr int MAX_ACC = 8;   // outputs per thread: G * D <= F_THREADS * MAX_ACC

template <int D>
constexpr size_t f32_smem_floats(int G) {
  return (size_t)2 * G + G * D + G * D + F_BK * (D + 1) + F_BK * D + G * F_BK + G;
}

template <int D>
__global__ void __launch_bounds__(F_THREADS)
decode_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const int* __restrict__ length, float* __restrict__ o, Params p) {
  constexpr int KLD = D + 1;  // odd stride: lane j reads row j conflict-free
  constexpr int VEC = 4;      // floats per 16-byte load
  const int G = p.group;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* part = reinterpret_cast<float*>(smem_raw);  // the CTA's partial: m[G], l[G], o[G][D]
  float* ms = part;           // running max
  float* ls = part + G;       // running sum
  float* qs = part + 2 * G + G * D;  // [G][D], pre-scaled
  float* ks = qs + G * D;            // [BK][KLD]
  float* vs = ks + F_BK * KLD;       // [BK][D]
  float* ps = vs + F_BK * D;         // [G][BK] scores, then probabilities
  float* cs = ps + G * F_BK;         // [G] this tile's correction

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pair = (int)blockIdx.x / p.splits, rank = (int)blockIdx.x % p.splits;
  const int kvh = pair % p.KV, b = pair / p.KV;
  const int n = min(max(length[b], 0), p.T);
  const int slice = chunks_per_warp(n, p.splits) * WARPS * CHUNK;
  const int k_lo = min(rank * slice, n), k_hi = min(k_lo + slice, n);

  const float* qb = q + b * p.q_sb + (long long)kvh * G * p.q_sh;
  const float* kb = k + b * p.k_sb + kvh * p.k_sh;
  const float* vb = v + b * p.v_sb + kvh * p.v_sh;

  for (int i = tid; i < G * D; i += F_THREADS)
    qs[i] = qb[(i / D) * p.q_sh + i % D] * p.scale;
  for (int i = tid; i < G; i += F_THREADS) {
    ms[i] = -INFINITY;
    ls[i] = 0.f;
  }
  float acc[MAX_ACC];
#pragma unroll
  for (int r = 0; r < MAX_ACC; ++r) acc[r] = 0.f;

  for (int t0 = k_lo; t0 < k_hi; t0 += F_BK) {
    __syncthreads();  // previous tile consumed; qs/ms/ls visible on entry
    for (int i = tid; i < F_BK * D / VEC; i += F_THREADS) {
      int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
      float4 kr = make_float4(0.f, 0.f, 0.f, 0.f), vr = kr;
      if (t0 + r < k_hi) {
        kr = *reinterpret_cast<const float4*>(kb + (long long)(t0 + r) * p.k_st + c);
        vr = *reinterpret_cast<const float4*>(vb + (long long)(t0 + r) * p.v_st + c);
      }
      const float ke[VEC] = {kr.x, kr.y, kr.z, kr.w}, ve[VEC] = {vr.x, vr.y, vr.z, vr.w};
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ks[r * KLD + c + e] = ke[e];
        vs[r * D + c + e] = ve[e];
      }
    }
    __syncthreads();

    // scores for every (head, position) pair of the tile
    for (int i = tid; i < G * F_BK; i += F_THREADS) {
      int gi = i / F_BK, j = i % F_BK;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qs[gi * D + d], ks[j * KLD + d], s);
      ps[i] = (t0 + j < k_hi) ? s : -INFINITY;
    }
    __syncthreads();

    // online softmax, one warp per head; position t0 is valid, so max is finite
    for (int gi = warp; gi < G; gi += F_THREADS / 32) {
      float s0 = ps[gi * F_BK + lane], s1 = ps[gi * F_BK + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, off));
      const float m_old = ms[gi];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      ps[gi * F_BK + lane] = p0;
      ps[gi * F_BK + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffff, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        cs[gi] = corr;
        ls[gi] = ls[gi] * corr + sum;
        ms[gi] = m_new;
      }
    }
    __syncthreads();

    // acc(g, d) = acc * corr(g) + sum_j p(g, j) v(j, d)
#pragma unroll
    for (int r = 0; r < MAX_ACC; ++r) {
      const int i = tid + r * F_THREADS;
      if (i < G * D) {
        const int gi = i / D, d = i % D;
        float a = acc[r] * cs[gi];
#pragma unroll 8
        for (int j = 0; j < F_BK; ++j) a = fmaf(ps[gi * F_BK + j], vs[j * D + d], a);
        acc[r] = a;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MAX_ACC; ++r) {
    const int i = tid + r * F_THREADS;
    if (i < G * D) part[2 * G + i] = acc[r];
  }
  cluster_merge<float, false>(part, o + b * p.o_sb + (long long)kvh * G * p.o_sh, p.o_sh, G, D);
}

// One launch of C * KV * B CTAs in clusters of C along grid.x.  The
// dynamic shared memory limit is raised once per kernel, to the most any
// accepted group size needs.
template <typename T, typename Kern>
cudaError_t launch(Kern kern, const cudaError_t& attr_err, int threads, size_t smem,
                   const void* q, const void* k, const void* v, const int* length, void* o,
                   const Params& p, cudaStream_t stream) {
  if (attr_err != cudaSuccess) return attr_err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.splits * p.KV * p.B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(q),
                                       static_cast<const T*>(k), static_cast<const T*>(v),
                                       length, static_cast<T*>(o), p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int D, int MT>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const int* length, void* o,
                        const Params& p, cudaStream_t stream) {
  using L = Bf16Smem<D, MT>;
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      decode_bf16<D, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::bytes(16 * MT < 2048 / D ? 16 * MT : 2048 / D));
  return launch<__nv_bfloat16>(decode_bf16<D, MT>, attr_err, WARPS * 32, L::bytes(p.group),
                               q, k, v, length, o, p, stream);
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const int* length, void* o,
                       const Params& p, cudaStream_t stream) {
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      decode_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(f32_smem_floats<D>(2048 / D) * sizeof(float)));
  return launch<float>(decode_f32<D>, attr_err, F_THREADS,
                       f32_smem_floats<D>(p.group) * sizeof(float), q, k, v, length, o, p,
                       stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  The caller
// has checked shapes, dtypes and strides (innermost stride 1, K/V row
// strides multiples of 16 bytes), D in {64, 128, 256}, G * D <= 2048, and
// 1 <= splits <= 8.
extern "C" int flash_decode(
    const void* q, const void* k, const void* v, const void* length, void* o, int is_bf16,
    int B, int H, int KV, int T, int D, int splits, float scale,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st,
    long long o_sb, long long o_sh, void* stream) {
  Params p;
  p.B = B; p.H = H; p.KV = KV; p.T = T; p.group = H / KV; p.splits = splits; p.scale = scale;
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_st = k_st;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_st = v_st;
  p.o_sb = o_sb; p.o_sh = o_sh;
  if (splits < 1 || splits > MAX_SPLITS || p.group * D > 2048)
    return (int)cudaErrorInvalidValue;
  const int* len = static_cast<const int*>(length);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    if (D == 64) return (int)launch_f32<64>(q, k, v, len, o, p, st);
    if (D == 128) return (int)launch_f32<128>(q, k, v, len, o, p, st);
    if (D == 256) return (int)launch_f32<256>(q, k, v, len, o, p, st);
    return (int)cudaErrorInvalidValue;
  }
  if (D == 64 && p.group <= 16) return (int)launch_bf16<64, 1>(q, k, v, len, o, p, st);
  if (D == 64) return (int)launch_bf16<64, 2>(q, k, v, len, o, p, st);
  if (D == 128) return (int)launch_bf16<128, 1>(q, k, v, len, o, p, st);
  if (D == 256) return (int)launch_bf16<256, 1>(q, k, v, len, o, p, st);
  return (int)cudaErrorInvalidValue;
}
