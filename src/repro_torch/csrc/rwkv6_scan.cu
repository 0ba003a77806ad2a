// Chunked RWKV6 (Finch) WKV scan for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel `rwkv6_scan` / `_rwkv6_kernel` in
// src/repro/kernels/rwkv6_scan.py: per (batch, head), with a (K, V) state
// S, per-channel data-dependent log-decay w_t <= 0 and a bonus u,
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(exp w_t) S_{t-1} + k_t v_t^T
// in its chunked form.  Inside a chunk of L positions, with cw the
// inclusive cumsum of w per channel and cwx_t = cw_{t-1} the exclusive one:
//   y_t = (r_t * exp(cwx_t)) S + sum_{s<t} A_ts v_s + (sum_k r_tk u_k k_tk) v_t,
//   A_ts = sum_k r_tk k_sk exp(cwx_tk - cw_sk)
//   S'  = diag(exp cw_L) S + (k * exp(cw_L - cw))^T v
//
// What bounds it on the card: at the serve shape (B 8, S 1024, H 64,
// K = V = 64, r/k/v bf16, w fp32) the kernel must read r, k, v (201 MB) and
// w (134 MB) and write y (67 MB) and the fp32 state (8 MB): about 410 MB,
// 0.12 ms at 3.35 TB/s; the products are a few GFLOP, so the bound is
// bytes.  A first version (scalar fp32, kept below for fp32 inputs) was
// held back instead by the L^2 K / 2 accurate exponentials of the pair
// matrix, by products of scalar FMAs over shared memory, and by staging
// each chunk synchronously.  The bf16 kernel's design, and what each part
// does about that:
// - Grid: one CTA of four warps per (head, batch), looping over chunks of
//   L = 32 (the TPU grid's sequential chunk axis); about 54 KB of shared
//   memory and at most 128 registers a thread, so four CTAs fit an SM and
//   the serve shape's 512 CTAs are one resident wave.
// - Staging: r, k, v (bf16) and w (fp32) are copied by 16-byte `cp.async`
//   (zero-filled past S: a ragged last chunk has w = 0, k = v = 0 there,
//   and its rows of y are not stored).  While one CTA waits for its chunk
//   the three others on its SM compute: prefetching chunk c + 1 during
//   chunk c's products, or a two-stage ring, measured slower (the
//   registers they hold spill; PERF.md).  The cumsum of w overwrites w.
// - Pair matrix, cut into sub-blocks of SUB = 8 positions.  Inside each
//   diagonal sub-block A_ts is formed per (t, s, k), as the TPU kernel
//   does, but without an exponential per pair: walking down column s, the
//   decayed k_s exp(cwx_t - cw_s) = k_s prod_{s<j<t} exp(w_j) takes one
//   more factor exp(w_j) <= 1 a row (one exponential per (j, k), formed
//   with the cumsum).  Off the diagonal the decay is factored about a
//   sub-block boundary a with s <= a < t:
//     exp(cwx_t - cw_s) = exp(cwx_t - cw_a) * exp(cw_a - cw_s)
//   (rows 16..31 x columns 0..15 about a = 15; rows 8..15 x 0..7 about 7;
//   rows 24..31 x 16..23 about 23), and the two factored operands meet in
//   an mma.sync product.  With the fold below that is about 5 K
//   exponentials a token instead of L K / 2 + 2 K, each one MUFU op.
// - Signs: every exponent formed is w_j, cwx_t, cw_L - cw_t, or a
//   difference cw_i - cw_j with i >= j in fp32 (cwx_t = cw_{t-1} is the
//   same stored value); an fp32 running sum of w <= 0 never rises, so no
//   exponent is positive and nothing overflows (the factored form
//   r exp(cw) . k exp(-cw) about the chunk start, which the reference warns
//   of, is not used).  A factor or product underflows only where the
//   pair's true decay is smaller still.  For finite w every cumsum is
//   finite, so no inf - inf forms.
// - Products on the tensor cores, mma.sync.m16n8k16 (bf16 in, fp32
//   accumulate).  The fp32 state stays in registers across chunks, as the
//   accumulators of S^T: warp w owns rows v = 16 w .. 16 w + 15, and those
//   accumulators are its A operand in y^T = S^T r~^T (the FlashAttention-2
//   identity of accumulator and A-fragment layouts), so the state never
//   leaves the registers.  Operands that bf16 does not hold exactly are
//   split: x = hi + lo (+ lo2) in bf16, and the products summed over the
//   terms that matter: S^T r~^T as hi.hi + hi.lo + lo.hi (about 2^-16 of
//   each term), A v^T with v exact, and the state update v^T k~ with
//   k~ = k exp(cw_L - cw) in three bf16 parts (about 2^-24), because
//   the final state is held at 5e-5 against fp32 arithmetic (k~ in bf16
//   alone misses that by two orders; two parts used half of it on the
//   card).  diag(exp cw_L) scales the accumulators in place.  y goes out
//   through shared memory in 16-byte stores.
// - Four barriers a chunk: the previous chunk's products are done, the
//   chunk has landed, the cumsum is done, the pair matrix and the products'
//   operands are formed.
//
// float32 inputs keep the first version: one CTA of 256 threads per (head,
// batch), every product a scalar fp32 FMA over shared memory, accurate
// expf; it meets the reference's 5e-5 against fp32 plain arithmetic.
//
// Semantics beyond the TPU kernel: any S (a ragged last chunk is masked,
// not refused); strided r, k, v, w (innermost stride 1; views whose rows
// are not 16-byte aligned are staged by plain loads instead of cp.async).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int L = 32;  // chunk length of both kernels

struct Params {
  int B, S, H, aligned;
  long long r_sb, r_ss, r_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long w_sb, w_ss, w_sh;
};

// ---------------------------------------------------------------------------
// float32: the first version, scalar fp32
// ---------------------------------------------------------------------------
constexpr int F_THREADS = 256;
constexpr int NB = L / 2;                 // 2 x 2 blocks per side of the pair matrix
constexpr int LOWER = NB * (NB + 1) / 2;  // blocks on or below the diagonal (136)
constexpr int ALD = L + 1;                // row stride of the pair matrix

template <int K, int V>
constexpr size_t f32_smem_floats() {
  return 4 * (size_t)L * (K + 1) + (size_t)L * V + (size_t)L * ALD + (size_t)K * (V + 1) + 2 * K;
}

template <int K, int V>
__global__ void __launch_bounds__(F_THREADS)
rwkv6_f32(const float* __restrict__ r, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ w, const float* __restrict__ u,
          const float* __restrict__ s0, float* __restrict__ y, float* __restrict__ sfin,
          Params p) {
  constexpr int KP = K + 1;    // odd row stride
  constexpr int VP = V + 1;
  constexpr int JV = V / 16, IK = K / 16;
  static_assert(F_THREADS == LOWER + NB * (NB - 1) / 2, "one thread per 2 x 2 block");
  extern __shared__ __align__(16) float fsm[];
  float* rs = fsm;                // [L][KP] r, then r * exp(cwx)
  float* ks = rs + L * KP;        // [L][KP] k, then k * exp(total - cw)
  float* cw = ks + L * KP;        // [L][KP] inclusive cumsum of w
  float* cx = cw + L * KP;        // [L][KP] exclusive: cw - w
  float* vs = cx + L * KP;        // [L][V]
  float* am = vs + L * V;         // [L][ALD] pair matrix, bonus on the diagonal
  float* ss = am + L * ALD;       // [K][VP] state
  float* us = ss + K * VP;        // [K] bonus u
  float* tot = us + K;            // [K] cw at the chunk's end

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const float* rb = r + b * p.r_sb + h * p.r_sh;
  const float* kb = k + b * p.k_sb + h * p.k_sh;
  const float* vb = v + b * p.v_sb + h * p.v_sh;
  const float* wb = w + b * p.w_sb + h * p.w_sh;
  const long long state_off = ((long long)b * p.H + h) * K * V;

  // this thread's 2 x 2 block of the pair matrix: on or below the diagonal
  // for tid < LOWER (computed), above it otherwise (zeros)
  int bt, bs;
  if (tid < LOWER) {
    bt = 0;
    while ((bt + 1) * (bt + 2) / 2 <= tid) ++bt;
    bs = tid - bt * (bt + 1) / 2;
  } else {
    const int q = tid - LOWER;
    bs = 1;
    while (bs * (bs + 1) / 2 <= q) ++bs;
    bt = q - bs * (bs - 1) / 2;
  }

  for (int i = tid; i < K * V; i += F_THREADS)
    ss[(i / V) * VP + i % V] = s0 ? s0[state_off + i] : 0.f;
  for (int i = tid; i < K; i += F_THREADS) us[i] = u[(long long)h * K + i];

  for (int t0 = 0; t0 < p.S; t0 += L) {
    const int nv = min(L, p.S - t0);
    __syncthreads();  // the previous chunk is consumed; state and u are written

    // ---- stage r, k, w (into cw), v; positions past S are zeros
    for (int i = tid; i < L * K; i += F_THREADS) {
      const int t = i / K, c = i % K;
      const bool ok = t < nv;
      const long long o = t0 + t;
      rs[t * KP + c] = ok ? rb[o * p.r_ss + c] : 0.f;
      ks[t * KP + c] = ok ? kb[o * p.k_ss + c] : 0.f;
      cw[t * KP + c] = ok ? wb[o * p.w_ss + c] : 0.f;
    }
    for (int i = tid; i < L * V; i += F_THREADS) {
      const int t = i / V, c = i % V;
      vs[i] = t < nv ? vb[(long long)(t0 + t) * p.v_ss + c] : 0.f;
    }
    __syncthreads();

    // ---- per-channel inclusive cumsum over the chunk: a warp scan per
    // channel, lane = position
    for (int c = warp; c < K; c += F_THREADS / 32) {
      const float wv = cw[lane * KP + c];
      float incl = wv;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffff, incl, off);
        if (lane >= off) incl += o;
      }
      cw[lane * KP + c] = incl;
      cx[lane * KP + c] = incl - wv;
      if (lane == L - 1) tot[c] = incl;
    }
    __syncthreads();

    // ---- pair matrix: A[t][s] = sum_k r_tk k_sk exp(cwx_tk - cw_sk) for
    // s < t, the bonus sum_k r_tk u_k k_tk for s == t, 0 for s > t
    {
      const int t_0 = 2 * bt, s_0 = 2 * bs;
      if (tid < LOWER) {
        const bool diag = bt == bs;
        float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
        float bon[2] = {0.f, 0.f};
#pragma unroll 4
        for (int c = 0; c < K; ++c) {
          const float r0 = rs[t_0 * KP + c], r1 = rs[(t_0 + 1) * KP + c];
          const float x0 = cx[t_0 * KP + c], x1 = cx[(t_0 + 1) * KP + c];
          const float k0 = ks[s_0 * KP + c], k1 = ks[(s_0 + 1) * KP + c];
          const float w0 = cw[s_0 * KP + c], w1 = cw[(s_0 + 1) * KP + c];
          if (!diag) {
            acc[0][0] = fmaf(r0 * k0, expf(x0 - w0), acc[0][0]);
            acc[0][1] = fmaf(r0 * k1, expf(x0 - w1), acc[0][1]);
            acc[1][0] = fmaf(r1 * k0, expf(x1 - w0), acc[1][0]);
            acc[1][1] = fmaf(r1 * k1, expf(x1 - w1), acc[1][1]);
          } else {
            // t_0 + 1 > s_0 is the only strict pair of a diagonal block
            acc[1][0] = fmaf(r1 * k0, expf(x1 - w0), acc[1][0]);
            bon[0] = fmaf(r0 * us[c], k0, bon[0]);
            bon[1] = fmaf(r1 * us[c], k1, bon[1]);
          }
        }
        if (diag) {
          acc[0][0] = bon[0];
          acc[1][1] = bon[1];
          acc[0][1] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) am[(t_0 + i) * ALD + s_0 + j] = acc[i][j];
      } else {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) am[(t_0 + i) * ALD + s_0 + j] = 0.f;
      }
    }
    __syncthreads();

    // ---- fold the decays into r and k (exponents <= 0)
    for (int i = tid; i < L * K; i += F_THREADS) {
      const int t = i / K, c = i % K;
      rs[t * KP + c] *= expf(cx[t * KP + c]);
      ks[t * KP + c] *= expf(tot[c] - cw[t * KP + c]);
    }
    __syncthreads();

    // ---- y[t][v] = sum_k rs[t][k] S[k][v] + sum_s A[t][s] v[s][v]
    {
      float acc[2][JV];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < JV; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < K; ++c) {
        const float a0 = rs[ty * KP + c], a1 = rs[(ty + 16) * KP + c];
#pragma unroll
        for (int j = 0; j < JV; ++j) {
          const float sv = ss[c * VP + tx + 16 * j];
          acc[0][j] = fmaf(a0, sv, acc[0][j]);
          acc[1][j] = fmaf(a1, sv, acc[1][j]);
        }
      }
#pragma unroll 4
      for (int s = 0; s < L; ++s) {
        const float a0 = am[ty * ALD + s], a1 = am[(ty + 16) * ALD + s];
#pragma unroll
        for (int j = 0; j < JV; ++j) {
          const float vv = vs[s * V + tx + 16 * j];
          acc[0][j] = fmaf(a0, vv, acc[0][j]);
          acc[1][j] = fmaf(a1, vv, acc[1][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = ty + 16 * i;
        if (t < nv) {
          float* yrow = y + (((long long)b * p.S + t0 + t) * p.H + h) * V;
#pragma unroll
          for (int j = 0; j < JV; ++j) yrow[tx + 16 * j] = acc[i][j];
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // ---- S[k][v] = exp(total_k) S[k][v] + sum_s ks[s][k] v[s][v]
    {
      float acc[IK][JV];
#pragma unroll
      for (int i = 0; i < IK; ++i) {
        const float e = expf(tot[ty + 16 * i]);
#pragma unroll
        for (int j = 0; j < JV; ++j) acc[i][j] = ss[(ty + 16 * i) * VP + tx + 16 * j] * e;
      }
#pragma unroll 4
      for (int s = 0; s < L; ++s) {
        float kv[IK], vv[JV];
#pragma unroll
        for (int i = 0; i < IK; ++i) kv[i] = ks[s * KP + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < JV; ++j) vv[j] = vs[s * V + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < IK; ++i)
#pragma unroll
          for (int j = 0; j < JV; ++j) acc[i][j] = fmaf(kv[i], vv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < IK; ++i)
#pragma unroll
        for (int j = 0; j < JV; ++j) ss[(ty + 16 * i) * VP + tx + 16 * j] = acc[i][j];
    }
  }
  __syncthreads();
  for (int i = tid; i < K * V; i += F_THREADS) sfin[state_off + i] = ss[(i / V) * VP + i % V];
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, sub-chunk pair matrix, cp.async staging
// ---------------------------------------------------------------------------
constexpr int THREADS = 128;  // four warps
constexpr int SUB = 8;        // positions of a diagonal sub-block of the pair matrix
constexpr int KT_PARTS = 3;   // bf16 parts of k~ in the state update
// the diagonal sub-blocks have L / 2 column pairs, eight lanes each; the
// factored blocks are laid out for three of them, one a warp
static_assert(THREADS == 8 * L / 2 && L == 32 && SUB == 8, "the layout of the pair matrix");

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) = hi + lo, each a bf16 pair: hi rounds x, lo rounds the rest
// (x - hi is exact in fp32), so the pair keeps about 16 bits of x
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 hb = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(hb);
  hi = bits(hb);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// (x0, x1) = hi + lo + lo2: about 24 bits of x
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& lo,
                                       uint32_t& lo2) {
  const __nv_bfloat162 hb = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(hb);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 lb = __floats2bfloat162_rn(r0, r1);
  const float2 lf = __bfloat1622float2(lb);
  hi = bits(hb);
  lo = bits(lb);
  lo2 = bits(__floats2bfloat162_rn(r0 - lf.x, r1 - lf.y));
}

__device__ __forceinline__ void unpack8(uint4 q, float (&x)[8]) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Byte offset of 16-byte chunk c of row r in a bf16 tile of CPR chunks a
// row: the tile's chunks are numbered row by row, and chunk i of each line
// of eight is stored at i ^ (line % 8), so that the eight rows an ldmatrix
// reads (one chunk each) fall in eight different bank groups.
template <int CPR>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  const int i = r * CPR + c;
  return (uint32_t)(((i & ~7) | ((i ^ (i >> 3)) & 7)) << 4);
}

// Shared memory of the bf16 kernel, in bytes: the chunk as loaded (r, k, v
// as [L][D] bf16 tiles, swizzled; w as [L][WLD] fp32, turned into its
// cumsum cw in place); exp(w) ([L][WLD] fp32); the products' operands r~ in
// two and k~ in three bf16 parts ([L][D] tiles); the pair matrix A in
// two bf16 parts ([L][L]); exp(cw_L) and u.
template <int D>
struct Bf16Smem {
  static constexpr int WLD = D + 4;  // padded fp32 row, a multiple of 16 bytes
  static constexpr int TILE = L * D * 2;
  static constexpr int FT = L * WLD * 4;
  static constexpr int R = 0, K = TILE, V = 2 * TILE, W = 3 * TILE;
  static constexpr int DEC = W + FT;
  static constexpr int RT = DEC + FT, KT = RT + 2 * TILE;
  static constexpr int A_HI = KT + KT_PARTS * TILE, A_LO = A_HI + L * L * 2;
  static constexpr int ETOT = A_LO + L * L * 2;
  static constexpr int US = ETOT + D * 4;
  static constexpr int BYTES = US + D * 4;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 4)
rwkv6_bf16(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, const float* __restrict__ s0,
           __nv_bfloat16* __restrict__ y, float* __restrict__ sfin, Params p) {
  using M = Bf16Smem<D>;
  constexpr int CPR = D / 8;   // 16-byte chunks in a bf16 row of r, k, v
  constexpr int WCH = D / 4;   // 16-byte chunks in an fp32 row of w
  constexpr int NK = D / 8;    // n-tiles of eight channels of the state
  constexpr int NVW = D / 16;  // warps that own sixteen rows of S^T
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_u32(smem);
  float* cw = reinterpret_cast<float*>(smem + M::W);
  float* dec = reinterpret_cast<float*>(smem + M::DEC);
  float* etot = reinterpret_cast<float*>(smem + M::ETOT);
  float* us = reinterpret_cast<float*>(smem + M::US);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, mi = lane >> 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const __nv_bfloat16* rb = r + b * p.r_sb + h * p.r_sh;
  const __nv_bfloat16* kb = k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = v + b * p.v_sb + h * p.v_sh;
  const float* wb = w + b * p.w_sb + h * p.w_sh;
  const long long state_off = ((long long)b * p.H + h) * D * D;

  // the chunk at position tn: r, k, v and w; rows past S are zeros
  auto load = [&](int tn) {
    const int nvn = min(L, p.S - tn);
    if (p.aligned) {
      for (int i = tid; i < L * CPR; i += THREADS) {
        const int t = i / CPR, c = i % CPR;
        const bool in = t < nvn;
        const long long o = tn + t;
        const uint32_t off = swz<CPR>(t, c);
        cp_async16(sbase + M::R + off, in ? rb + o * p.r_ss + c * 8 : rb, in);
        cp_async16(sbase + M::K + off, in ? kb + o * p.k_ss + c * 8 : kb, in);
        cp_async16(sbase + M::V + off, in ? vb + o * p.v_ss + c * 8 : vb, in);
      }
      for (int i = tid; i < L * WCH; i += THREADS) {
        const int t = i / WCH, c = i % WCH;
        const bool in = t < nvn;
        cp_async16(sbase + M::W + (t * M::WLD + c * 4) * 4,
                   in ? wb + (long long)(tn + t) * p.w_ss + c * 4 : wb, in);
      }
    } else {  // rows not 16-byte aligned: plain loads
      const __nv_bfloat16 zero = __float2bfloat16(0.f);
      for (int i = tid; i < L * D; i += THREADS) {
        const int t = i / D, c = i % D;
        const bool in = t < nvn;
        const long long o = tn + t;
        const uint32_t off = swz<CPR>(t, c >> 3) + (c & 7) * 2;
        *reinterpret_cast<__nv_bfloat16*>(smem + M::R + off) = in ? rb[o * p.r_ss + c] : zero;
        *reinterpret_cast<__nv_bfloat16*>(smem + M::K + off) = in ? kb[o * p.k_ss + c] : zero;
        cw[t * M::WLD + c] = in ? wb[o * p.w_ss + c] : 0.f;
        *reinterpret_cast<__nv_bfloat16*>(smem + M::V + off) = in ? vb[o * p.v_ss + c] : zero;
      }
    }
  };

  // A above the diagonal is never written: zero both parts once
  for (int i = tid; i < 2 * L * L * 2 / 16; i += THREADS)
    reinterpret_cast<uint4*>(smem + M::A_HI)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < D; i += THREADS) us[i] = u[(long long)h * D + i];

  // the state as accumulators of S^T: warp w < NVW holds rows
  // v = 16 w + g (+ 8 for elements 2, 3), columns k = 8 nk + 2 t4 (+ 1)
  float sacc[NK][4];
#pragma unroll
  for (int nk = 0; nk < NK; ++nk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int vv = 16 * warp + g + 8 * (e >> 1), kk = 8 * nk + 2 * t4 + (e & 1);
      sacc[nk][e] = (s0 != nullptr && warp < NVW) ? s0[state_off + (long long)kk * D + vv] : 0.f;
    }

  // the diagonal sub-blocks: eight lanes (channel chunk c8) per column pair
  // cp of sub-block i0: columns sa = i0 + cp and sb = i0 + SUB - 1 - cp,
  // whose pairs (t > s inside the sub-block) number SUB - 1 together
  const int c8 = lane & 7, cp = (tid >> 3) % (SUB / 2);
  const int i0 = (tid >> 3) / (SUB / 2) * SUB, sa = i0 + cp, sb = i0 + SUB - 1 - cp;
  const int na = SUB - 1 - cp;  // pairs of column sa
  const bool has_c = c8 < CPR;  // K < 64: lanes past the row hold no channels
  auto row8 = [&](int slot, int t, float (&x)[8]) {  // 8 bf16 of row t, chunk c8
    if (has_c)
      unpack8(*reinterpret_cast<const uint4*>(smem + slot + swz<CPR>(t, c8)), x);
    else
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
  };
  auto f8 = [&](const float* base, int t, float (&x)[8]) {  // 8 floats of row t, chunk c8
    if (has_c) {
      const float4 a = *reinterpret_cast<const float4*>(base + t * M::WLD + 8 * c8);
      const float4 bq = *reinterpret_cast<const float4*>(base + t * M::WLD + 8 * c8 + 4);
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = bq.x; x[5] = bq.y; x[6] = bq.z; x[7] = bq.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
  };
  auto a_off = [](int t, int s) { return swz<L / 8>(t, s >> 3) + (s & 7) * 2; };
  auto put_a = [&](int t, int s, float x) {  // A[t][s] in two bf16 parts
    const __nv_bfloat16 hi = __float2bfloat16(x);
    *reinterpret_cast<__nv_bfloat16*>(smem + M::A_HI + a_off(t, s)) = hi;
    *reinterpret_cast<__nv_bfloat16*>(smem + M::A_LO + a_off(t, s)) =
        __float2bfloat16(x - __bfloat162float(hi));
  };

  const int nchunks = (p.S + L - 1) / L;
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * L, nv = min(L, p.S - t0);
    __syncthreads();  // chunk c - 1's products are done: the slots are free
    load(t0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();  // chunk c has landed

    // ---- inclusive cumsum of w per channel, in place; exp(w); exp(cw_L)
    if (tid < D) {
      float x[L];
#pragma unroll
      for (int t = 0; t < L; ++t) x[t] = cw[t * M::WLD + tid];
      float run = 0.f;
#pragma unroll
      for (int t = 0; t < L; ++t) {
        run += x[t];
        cw[t * M::WLD + tid] = run;
        dec[t * M::WLD + tid] = __expf(x[t]);
      }
      etot[tid] = expf(run);
    }
    __syncthreads();

    // ---- pair matrix, diagonal sub-blocks: A[t][s] for s < t is
    // sum_k r_tk k_sk prod_{s<j<t} exp(w_jk): walking down column s the
    // decayed k_s is multiplied by one exp(w) <= 1 a row; the bonus on the
    // diagonal
    {
      float kd[8], kbv[8], rx[8];
      row8(M::K, sa, kd);
      row8(M::K, sb, kbv);
      {
        float rbv[8];
        row8(M::R, sa, rx);
        row8(M::R, sb, rbv);
        float ba = 0.f, bb = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float ue = has_c ? us[8 * c8 + e] : 0.f;
          ba = fmaf(rx[e] * ue, kd[e], ba);
          bb = fmaf(rbv[e] * ue, kbv[e], bb);
        }
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) {
          ba += __shfl_xor_sync(0xffffffff, ba, o);
          bb += __shfl_xor_sync(0xffffffff, bb, o);
        }
        if (c8 == 0) {
          put_a(sa, sa, ba);
          put_a(sb, sb, bb);
        }
      }
#pragma unroll
      for (int j = 0; j < SUB - 1; ++j) {
        const bool on_a = j < na;
        const int s = on_a ? sa : sb, t = s + 1 + (on_a ? j : j - na);
        if (j > 0) {  // one more row of decay, unless column sb starts here
          float dd[8];
          f8(dec, t - 1, dd);
#pragma unroll
          for (int e = 0; e < 8; ++e) kd[e] = j == na ? kbv[e] : kd[e] * dd[e];
        }
        row8(M::R, t, rx);
        float a2[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 8; ++e) a2[e & 1] = fmaf(rx[e], kd[e], a2[e & 1]);
        float acc = a2[0] + a2[1];
        acc += __shfl_xor_sync(0xffffffff, acc, 1);
        acc += __shfl_xor_sync(0xffffffff, acc, 2);
        acc += __shfl_xor_sync(0xffffffff, acc, 4);
        if (c8 == 0) put_a(t, s, acc);
      }
    }

    // ---- pair matrix off the diagonal sub-blocks, factored about a
    // boundary a (s <= a < t), as an mma.sync product of
    // (r_t exp(cwx_t - cw_a)) and (k_s exp(cw_a - cw_s)), both exponents <= 0.
    // Warps 0 and 1: rows 16..31 about 15, columns 8 w .. 8 w + 7; warp 2:
    // rows 8..15 x columns 0..7 about 7, and warp 3: rows 24..31 x 16..23
    // about 23, each in the top half of its A tile (the bottom half is
    // zeros).
    {
      const bool top = warp < 2;  // the rows 16..31 about 15
      const int a = top ? 15 : (warp == 2 ? 7 : 23);
      const int t_lo = top ? 16 : a + 1, s_lo = top ? 8 * warp : a - 7;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      auto bf2 = [&](int slot, int t, int col) {
        return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            smem + slot + swz<CPR>(t, col >> 3) + (col & 7) * 2));
      };
      auto f2 = [&](int t, int col) { return *reinterpret_cast<const float2*>(cw + t * M::WLD + col); };
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ah[4] = {0u, 0u, 0u, 0u}, al[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int bot = j & 1;
          if (bot && !top) continue;
          const int t = t_lo + g + 8 * bot;
          const int col = 16 * kk + 2 * t4 + 8 * (j >> 1);
          const float2 rr = bf2(M::R, t, col), cx = f2(t - 1, col), ca = f2(a, col);
          split2(rr.x * __expf(cx.x - ca.x), rr.y * __expf(cx.y - ca.y), ah[j], al[j]);
        }
        uint32_t bh[2], bl[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 16 * kk + 2 * t4 + 8 * j;
          const float2 kx = bf2(M::K, s_lo + g, col), cs = f2(s_lo + g, col), ca = f2(a, col);
          split2(kx.x * __expf(ca.x - cs.x), kx.y * __expf(ca.y - cs.y), bh[j], bl[j]);
        }
        mma_bf16(acc, ah, bh[0], bh[1]);
        mma_bf16(acc, ah, bl[0], bl[1]);
        mma_bf16(acc, al, bh[0], bh[1]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // row g (hh = 0) or g + 8
        if (hh && !top) continue;
        const int t = t_lo + g + 8 * hh, s = s_lo + 2 * t4;
        uint32_t hi, lo;
        split2(acc[2 * hh], acc[2 * hh + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(smem + M::A_HI + a_off(t, s)) = hi;
        *reinterpret_cast<uint32_t*>(smem + M::A_LO + a_off(t, s)) = lo;
      }
    }

    // ---- fold the decays into r and k: r~ = r exp(cwx), k~ = k exp(cw_L - cw)
    // (exponents <= 0), each split into bf16 parts
    for (int un = tid; un < L * CPR; un += THREADS) {
      const int t = un / CPR, cc = un % CPR;
      const uint32_t off = swz<CPR>(t, cc);
      float rx[8], kx[8];
      unpack8(*reinterpret_cast<const uint4*>(smem + M::R + off), rx);
      unpack8(*reinterpret_cast<const uint4*>(smem + M::K + off), kx);
      const float* cwr = cw + t * M::WLD + 8 * cc;
      const float* cwl = cw + (L - 1) * M::WLD + 8 * cc;
      uint32_t q[2 + KT_PARTS][4];
#pragma unroll
      for (int e = 0; e < 8; e += 2) {
        const float x0 = t > 0 ? cwr[e - M::WLD] : 0.f, x1 = t > 0 ? cwr[e + 1 - M::WLD] : 0.f;
        split2(rx[e] * __expf(x0), rx[e + 1] * __expf(x1), q[0][e / 2], q[1][e / 2]);
        const float k0 = kx[e] * __expf(cwl[e] - cwr[e]);
        const float k1 = kx[e + 1] * __expf(cwl[e + 1] - cwr[e + 1]);
        split3(k0, k1, q[2][e / 2], q[3][e / 2], q[4][e / 2]);
      }
#pragma unroll
      for (int part = 0; part < 2 + KT_PARTS; ++part)
        *reinterpret_cast<uint4*>(smem + M::RT + part * M::TILE + off) =
            make_uint4(q[part][0], q[part][1], q[part][2], q[part][3]);
    }
    __syncthreads();  // the pair matrix and the products' operands are formed

    // ---- products of warp w < NVW, on its rows v = 16 w .. 16 w + 15:
    // y^T = S^T r~^T + v^T A^T, then S^T = S^T diag(exp cw_L) + v^T k~
    if (warp < NVW) {
      float yacc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[nt][e] = 0.f;
      // ldmatrix (B operand from a [n][k] tile): matrix mi is rows
      // 8 (mi >> 1) .. of the 16-row group and k-chunk 2 ks + (mi & 1)
      const int br = ((mi >> 1) << 3) + (lane & 7);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t ah[4], al[4];  // S^T as A fragments, from the accumulators
        split2(sacc[2 * ks][0], sacc[2 * ks][1], ah[0], al[0]);
        split2(sacc[2 * ks][2], sacc[2 * ks][3], ah[1], al[1]);
        split2(sacc[2 * ks + 1][0], sacc[2 * ks + 1][1], ah[2], al[2]);
        split2(sacc[2 * ks + 1][2], sacc[2 * ks + 1][3], ah[3], al[3]);
#pragma unroll
        for (int pr = 0; pr < 2; ++pr) {
          uint32_t bh[4], bl[4];
          const uint32_t off = swz<CPR>(16 * pr + br, 2 * ks + (mi & 1));
          ldsm_x4(bh, sbase + M::RT + off);
          ldsm_x4(bl, sbase + M::RT + M::TILE + off);
          mma_bf16(yacc[2 * pr], ah, bh[0], bh[1]);
          mma_bf16(yacc[2 * pr + 1], ah, bh[2], bh[3]);
          mma_bf16(yacc[2 * pr], ah, bl[0], bl[1]);
          mma_bf16(yacc[2 * pr + 1], ah, bl[2], bl[3]);
          mma_bf16(yacc[2 * pr], al, bh[0], bh[1]);
          mma_bf16(yacc[2 * pr + 1], al, bh[2], bh[3]);
        }
      }
      // v^T as A fragments (ldmatrix.trans of v's [s][v] tile): matrix mi is
      // rows s = 16 ks + 8 (mi >> 1) .. and v-chunk 2 w + (mi & 1)
      uint32_t va[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        ldsm_x4_trans(va[ks], sbase + M::V + swz<CPR>(16 * ks + br, 2 * warp + (mi & 1)));
#pragma unroll
        for (int pr = 0; pr < 2; ++pr) {
          if (pr < ks) continue;  // rows t < 16 have no pair with s >= 16
          uint32_t bh[4], bl[4];
          const uint32_t off = swz<L / 8>(16 * pr + br, 2 * ks + (mi & 1));
          ldsm_x4(bh, sbase + M::A_HI + off);
          ldsm_x4(bl, sbase + M::A_LO + off);
          mma_bf16(yacc[2 * pr], va[ks], bh[0], bh[1]);
          mma_bf16(yacc[2 * pr + 1], va[ks], bh[2], bh[3]);
          mma_bf16(yacc[2 * pr], va[ks], bl[0], bl[1]);
          mma_bf16(yacc[2 * pr + 1], va[ks], bl[2], bl[3]);
        }
      }
      // y through exp(w)'s slot (read by now) as [t][v] bf16 rows of YLD
      // bytes, so that each lane stores 16-byte runs of its row
      {
        constexpr int YLD = 2 * D + 16;
        unsigned char* ys = smem + M::DEC;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            *reinterpret_cast<__nv_bfloat16*>(
                ys + (8 * nt + 2 * t4 + (e & 1)) * YLD + (16 * warp + g + 8 * (e >> 1)) * 2) =
                __float2bfloat16(yacc[nt][e]);
        __syncwarp();
        if (lane < nv) {
          const uint4* src = reinterpret_cast<const uint4*>(ys + lane * YLD + 32 * warp);
          uint4* dst = reinterpret_cast<uint4*>(
              y + (((long long)b * p.S + t0 + lane) * p.H + h) * D + 16 * warp);
          dst[0] = src[0];
          dst[1] = src[1];
        }
      }

#pragma unroll
      for (int nk = 0; nk < NK; ++nk) {
        const float2 e = *reinterpret_cast<const float2*>(etot + 8 * nk + 2 * t4);
        sacc[nk][0] *= e.x;
        sacc[nk][1] *= e.y;
        sacc[nk][2] *= e.x;
        sacc[nk][3] *= e.y;
      }
      // k~ as B operand (ldmatrix.trans of its [t][k] tiles): matrix mi is
      // rows t = 16 ks + 8 (mi & 1) .. and k-chunk nd + (mi >> 1)
      const int kr = ((mi & 1) << 3) + (lane & 7);
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int nd = 0; nd < NK; nd += 2)
#pragma unroll
          for (int part = 0; part < KT_PARTS; ++part) {
            uint32_t bk[4];
            ldsm_x4_trans(bk, sbase + M::KT + part * M::TILE +
                                  swz<CPR>(16 * ks + kr, nd + (mi >> 1)));
            mma_bf16(sacc[nd], va[ks], bk[0], bk[1]);
            mma_bf16(sacc[nd + 1], va[ks], bk[2], bk[3]);
          }
    }
  }

  if (warp < NVW) {
#pragma unroll
    for (int nk = 0; nk < NK; ++nk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sfin[state_off + (long long)(8 * nk + 2 * t4 + (e & 1)) * D + 16 * warp + g +
             8 * (e >> 1)] = sacc[nk][e];
  }
}

// The bf16 kernel's shared-memory limit and carveout, set once per head
// size, on its first use.
template <int D>
cudaError_t prepare_bf16() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(rwkv6_bf16<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Bf16Smem<D>::BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(rwkv6_bf16<D>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return err;
}

template <int D>
cudaError_t launch_bf16(const void* r, const void* k, const void* v, const float* w,
                        const float* u, const float* s0, void* y, float* sfin, const Params& p,
                        cudaStream_t stream) {
  const cudaError_t attr_err = prepare_bf16<D>();
  if (attr_err != cudaSuccess) return attr_err;
  rwkv6_bf16<D><<<dim3(p.H, p.B), THREADS, Bf16Smem<D>::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(r), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), w, u, s0, static_cast<__nv_bfloat16*>(y), sfin, p);
  return cudaGetLastError();
}

template <int D>
int ctas_per_sm() {
  int n = 0;
  cudaError_t e = prepare_bf16<D>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, rwkv6_bf16<D>, THREADS,
                                                      Bf16Smem<D>::BYTES);
  return e == cudaSuccess ? n : -(int)e;
}

template <int D>
cudaError_t launch_f32(const void* r, const void* k, const void* v, const float* w,
                       const float* u, const float* s0, void* y, float* sfin, const Params& p,
                       cudaStream_t stream) {
  constexpr size_t smem = f32_smem_floats<D, D>() * sizeof(float);
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      rwkv6_f32<D, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr_err != cudaSuccess) return attr_err;
  rwkv6_f32<D, D><<<dim3(p.H, p.B), F_THREADS, smem, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k), static_cast<const float*>(v),
      w, u, s0, static_cast<float*>(y), sfin, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t by_dtype(int is_bf16, const void* r, const void* k, const void* v, const float* w,
                     const float* u, const float* s0, void* y, float* sfin, const Params& p,
                     cudaStream_t st) {
  if (is_bf16) return launch_bf16<D>(r, k, v, w, u, s0, y, sfin, p, st);
  return launch_f32<D>(r, k, v, w, u, s0, y, sfin, p, st);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  The caller
// has checked shapes, dtypes (r, k, v bf16 or fp32 alike; w, u, s0 fp32)
// and strides (innermost stride 1 for r, k, v, w; u, s0 contiguous; y and
// sfin contiguous outputs), K == V in {16, 32, 64}.  s0 may be null (zero
// initial state).
extern "C" int rwkv6_scan(
    const void* r, const void* k, const void* v, const void* w, const void* u, const void* s0,
    void* y, void* sfin, int is_bf16, int B, int S, int H, int K, int V,
    long long r_sb, long long r_ss, long long r_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long w_sb, long long w_ss, long long w_sh, void* stream) {
  Params p;
  p.B = B; p.S = S; p.H = H;
  p.r_sb = r_sb; p.r_ss = r_ss; p.r_sh = r_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.w_sb = w_sb; p.w_ss = w_ss; p.w_sh = w_sh;
  // every bf16 row and every fp32 row of w starts on 16 bytes: cp.async
  p.aligned = aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w) &&
              (r_sb | r_ss | r_sh | k_sb | k_ss | k_sh | v_sb | v_ss | v_sh) % 8 == 0 &&
              (w_sb | w_ss | w_sh) % 4 == 0;
  const float* wp = static_cast<const float*>(w);
  const float* up = static_cast<const float*>(u);
  const float* s0p = static_cast<const float*>(s0);
  float* sf = static_cast<float*>(sfin);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K != V) return (int)cudaErrorInvalidValue;
  switch (K) {
    case 16: return (int)by_dtype<16>(is_bf16, r, k, v, wp, up, s0p, y, sf, p, st);
    case 32: return (int)by_dtype<32>(is_bf16, r, k, v, wp, up, s0p, y, sf, p, st);
    case 64: return (int)by_dtype<64>(is_bf16, r, k, v, wp, up, s0p, y, sf, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// CTAs of the bf16 kernel that fit one SM at head size D (0 for another
// D), or minus a CUDA error.
extern "C" int rwkv6_ctas_per_sm(int D) {
  switch (D) {
    case 16: return ctas_per_sm<16>();
    case 32: return ctas_per_sm<32>();
    case 64: return ctas_per_sm<64>();
    default: return 0;
  }
}
