// Chunked Mamba2 (SSD) scan for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel `mamba2_scan` / `_mamba2_kernel` in
// src/repro/kernels/mamba2_scan.py: per (batch, head) the recurrence
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t
// in its chunked form.  Inside a chunk of L positions, with cs the
// inclusive cumsum of dt A (never increasing, so every exponent is <= 0):
//   y_t  = exp(cs_t) C_t . h + sum_{s<=t} W_ts x_s,  W_ts = exp(cs_t - cs_s) dt_s (C_t . B_s)
//   h'   = exp(cs_L) h + x^T B~,                     B~_s = exp(cs_L - cs_s) dt_s B_s
// It returns y and the final state.
//
// What bounds it on the card: at the serve shape (B 8, S 1024, H 64,
// P = N = 64, G 1, bf16) the kernel must read x (67 MB), B, C and dt and
// write y (67 MB) and the fp32 state (8 MB): about 147 MB, 0.0438 ms at
// 3.35 TB/s.  The chunked products are about 17 GFLOP, 0.017 ms on the
// tensor cores, so the bound is bytes.  PR 12's first version (kept below
// for fp32 inputs) ran every product as fp32 FMA on the CUDA cores, each
// shared-memory load feeding 16 FMAs, two CTAs an SM: 19x its bound.  The
// bf16 kernel's design, and what each part does about that:
// - Grid: one CTA of one warpgroup (128 threads) per (head, batch),
//   looping over chunks of L = 64 positions (the TPU grid's sequential
//   chunk axis); about 51 KB of shared memory and at most 128 registers a
//   thread, so four CTAs fit an SM and the serve shape's 512 CTAs are one
//   resident wave.  L = 64 is wgmma's M.
// - Staging: x, B and C (the head's group) land as bf16 through 16-byte
//   `cp.async` straight into the 128-byte swizzle that the wgmma
//   descriptors name (rows not 16-byte aligned take plain loads); positions
//   past S are zero-filled, with dt = 0 there.  While the copies fly, warp
//   0 loads dt and forms the cumsum, exp(cs_t), exp(cs_L) and
//   wst_s = exp(cs_L - cs_s) dt_s.  The SM's three other CTAs compute while
//   one waits for its chunk.
// - All four chunk products run on `wgmma m64n64k16` (bf16 in, fp32
//   accumulate), read by the warpgroup once from shared memory:
//     C B^T        A = C, B = B, both K-major and exact             4
//     C h^T        A = C, B = h in two bf16 parts, K-major          8
//     W x          A = W in two parts (registers), B = x MN-major   8
//     x^T B~       A = x MN-major, B = B~ in two parts, MN-major    8
//   28 a chunk at P = N = 64.  W is formed in the C B^T accumulators (the
//   exponent only where s <= t, whole 8-column blocks above the warp's
//   rows skipped; the cumsum is kept in log2 units, so that each exponent
//   is one subtraction and one ex2.approx) and repacked into A fragments;
//   exp(cs_t) scales the accumulator's rows between C h^T and W x.
// - Precision: bf16 keeps 8 bits.  C, B and x are bf16 inputs and enter
//   exactly; W, h and B~ are split into hi + lo bf16 parts (about 16 bits),
//   because one part takes y or the state to or past their limits: h in
//   one part puts y at 1.3-1.7x 2e-2, W at 0.8-1.1x, and B~ puts the fp32
//   state 19-39x past 1e-4 (tests/test_torch_mamba2_tc.py transcribes this
//   arithmetic).  Folding exp(cs_t) into C instead of the accumulator rows
//   would leave little margin on y.
// - The fp32 state is the accumulator of x^T B~ (M = p, N = n) and stays
//   in registers across all chunks (32 a thread at N = 64); after each
//   update its two bf16 parts go to shared memory for the next chunk's
//   C h^T.  y leaves through C's tile (free by then) in 16-byte stores.
// - Four barriers a chunk: the previous chunk is done, the chunk has
//   landed, the products that read B and C are done, y and B~ are staged.
// - P, N in {16, 32} use zero-padded 64-wide tiles (the padding is zeroed
//   once; the products over n take only the N / 16 real k-slices).  N = 128
//   takes two 64-column panels and two state accumulators (64 registers),
//   and runs at two CTAs an SM.
//
// float32 inputs keep the first version: one CTA of 256 threads per (head,
// batch), every product a scalar fp32 FMA over shared memory (the tensor
// cores would round fp32 operands to tf32).
//
// Semantics beyond the TPU kernel: any S (a ragged last chunk is masked,
// not refused); strided x, dt, B and C (innermost stride 1 for x, B, C).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int L = 64;  // chunk length of both kernels

struct Params {
  int B, S, H, G, aligned;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
};

// ---------------------------------------------------------------------------
// float32: the first version, scalar fp32
// ---------------------------------------------------------------------------
constexpr int F_THREADS = 256;
constexpr int WLD = L + 16;   // row stride of W: rows t and t + 1 fall in opposite bank halves

template <int P, int N>
constexpr size_t f32_smem_floats() {
  return (size_t)L * P + 2 * (size_t)L * (N + 1) + (size_t)L * WLD + (size_t)P * (N + 1) + 4 * L + 1;
}

template <int P, int N>
__global__ void __launch_bounds__(F_THREADS)
mamba2_f32(const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
           const float* __restrict__ Bm, const float* __restrict__ Cm, const float* __restrict__ h0,
           float* __restrict__ y, float* __restrict__ hfin, Params p) {
  constexpr int NP = N + 1;    // odd row stride: rows read by 16 lanes fall in 16 banks
  constexpr int IP = P / 16, JN = N / 16;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;               // [L][P]
  float* bs = xs + L * P;         // [L][NP]
  float* cs = bs + L * NP;        // [L][NP]
  float* wm = cs + L * NP;        // [L][WLD]  W[t][s]
  float* hs = wm + L * WLD;       // [P][NP]   state
  float* dts = hs + P * NP;       // [L] dt
  float* cum = dts + L;           // [L] inclusive cumsum of dt A
  float* ecs = cum + L;           // [L] exp(cum_t)
  float* wst = ecs + L;           // [L] exp(total - cum_s) dt_s
  float* etot = wst + L;          // [1] exp(total)

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (p.H / p.G);
  const float a_h = A[h];

  const float* xb = x + b * p.x_sb + h * p.x_sh;
  const float* dtb = dt + b * p.dt_sb + h * p.dt_sh;
  const float* bb = Bm + b * p.b_sb + g * p.b_sg;
  const float* cb = Cm + b * p.c_sb + g * p.c_sg;
  const long long state_off = ((long long)b * p.H + h) * P * N;

  for (int i = tid; i < P * N; i += F_THREADS)
    hs[(i / N) * NP + i % N] = h0 ? h0[state_off + i] : 0.f;

  for (int t0 = 0; t0 < p.S; t0 += L) {
    const int nv = min(L, p.S - t0);  // valid positions of this chunk
    __syncthreads();  // the previous chunk is consumed; the initial state is written

    // ---- stage x, B, C, dt; positions past S are zeros
    for (int i = tid; i < L * P; i += F_THREADS) {
      const int t = i / P, c = i % P;
      xs[i] = t < nv ? xb[(long long)(t0 + t) * p.x_ss + c] : 0.f;
    }
    for (int i = tid; i < L * N; i += F_THREADS) {
      const int t = i / N, c = i % N;
      const bool ok = t < nv;
      bs[t * NP + c] = ok ? bb[(long long)(t0 + t) * p.b_ss + c] : 0.f;
      cs[t * NP + c] = ok ? cb[(long long)(t0 + t) * p.c_ss + c] : 0.f;
    }
    // ---- inclusive cumsum of dt A: warp 0, two positions a lane
    if (tid < 32) {
      const int t = 2 * tid;
      const float d0 = t < nv ? dtb[(long long)(t0 + t) * p.dt_ss] : 0.f;
      const float d1 = t + 1 < nv ? dtb[(long long)(t0 + t + 1) * p.dt_ss] : 0.f;
      const float a0 = d0 * a_h, a1 = d1 * a_h;
      float incl = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffff, incl, off);
        if (tid >= off) incl += o;
      }
      const float c0 = (incl - (a0 + a1)) + a0, c1 = incl;
      const float total = __shfl_sync(0xffffffff, incl, 31);
      dts[t] = d0;
      dts[t + 1] = d1;
      cum[t] = c0;
      cum[t + 1] = c1;
      ecs[t] = expf(c0);
      ecs[t + 1] = expf(c1);
      wst[t] = expf(fminf(total - c0, 0.f)) * d0;
      wst[t + 1] = expf(fminf(total - c1, 0.f)) * d1;
      if (tid == 0) etot[0] = expf(total);
    }
    __syncthreads();

    // ---- W[t][s] = exp(cum_t - cum_s) dt_s (C_t . B_s) for s <= t, else 0
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + 16 * i) * NP + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[(tx + 16 * j) * NP + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx + 16 * j;
          // the exponent is only formed for s <= t, where it is <= 0
          wm[t * WLD + s] = s <= t ? expf(cum[t] - cum[s]) * dts[s] * acc[i][j] : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- y[t][p] = sum_s W[t][s] x[s][p] + exp(cum_t) sum_n C[t][n] h[p][n]
    {
      float acc[4][IP], acs[4][IP];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < IP; ++j) acc[i][j] = acs[i][j] = 0.f;
#pragma unroll 4
      for (int s = 0; s < L; ++s) {
        float wv[4], xv[IP];
#pragma unroll
        for (int i = 0; i < 4; ++i) wv[i] = wm[(ty + 16 * i) * WLD + s];
#pragma unroll
        for (int j = 0; j < IP; ++j) xv[j] = xs[s * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < IP; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[IP];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + 16 * i) * NP + n];
#pragma unroll
        for (int j = 0; j < IP; ++j) hv[j] = hs[(tx + 16 * j) * NP + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < IP; ++j) acs[i][j] = fmaf(cv[i], hv[j], acs[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t < nv) {
          float* yrow = y + (((long long)b * p.S + t0 + t) * p.H + h) * P;
#pragma unroll
          for (int j = 0; j < IP; ++j) yrow[tx + 16 * j] = fmaf(ecs[t], acs[i][j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // ---- h[p][n] = exp(total) h[p][n] + sum_s (wst_s x[s][p]) B[s][n]
    {
      float acc[IP][JN];
      const float et = etot[0];
#pragma unroll
      for (int i = 0; i < IP; ++i)
#pragma unroll
        for (int j = 0; j < JN; ++j) acc[i][j] = hs[(ty + 16 * i) * NP + tx + 16 * j] * et;
#pragma unroll 4
      for (int s = 0; s < L; ++s) {
        const float ws = wst[s];
        float xv[IP], bv[JN];
#pragma unroll
        for (int i = 0; i < IP; ++i) xv[i] = xs[s * P + ty + 16 * i] * ws;
#pragma unroll
        for (int j = 0; j < JN; ++j) bv[j] = bs[s * NP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < IP; ++i)
#pragma unroll
          for (int j = 0; j < JN; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < IP; ++i)
#pragma unroll
        for (int j = 0; j < JN; ++j) hs[(ty + 16 * i) * NP + tx + 16 * j] = acc[i][j];
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += F_THREADS) hfin[state_off + i] = hs[(i / N) * NP + i % N];
}

// ---------------------------------------------------------------------------
// bf16: one warpgroup, wgmma chunk products, state in registers
// ---------------------------------------------------------------------------
constexpr int THREADS = 128;  // one warpgroup

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
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
// make this thread's shared-memory writes visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk c of row r in a tile of L rows stored with
// the 128-byte swizzle: panels of 64 bf16 columns, L rows of 128 bytes
// each, chunk c % 8 of row r at position (c % 8) ^ (r % 8).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)((c >> 3) * (L * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle (layout type 1):
// start address >> 4 in bits 0-13, leading byte offset >> 4 in 16-29,
// stride byte offset >> 4 in 32-45.  The stride byte offset is the step
// between groups of 8 rows (8 x 128 bytes); the leading byte offset is
// unused by the K-major operands and by MN-major operands 64 elements wide,
// and is set to the same 1024 bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr) {
  constexpr uint64_t off = 1024 >> 4;
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | (off << 16) | (off << 32) | (1ull << 62);
}
// descriptor step to k-slice kk (16 columns) of a K-major tile: 32 bytes
// within a 128-byte row, panels of 64 columns L * 128 bytes apart
__device__ __forceinline__ uint64_t kmajor_step(int kk) {
  return (uint64_t)(((kk >> 2) * (L * 128) + (kk & 3) * 32) >> 4);
}
// descriptor step to k-slice kk (16 rows) of an MN-major tile
__device__ __forceinline__ uint64_t mnmajor_step(int kk) { return (uint64_t)((kk * 2048) >> 4); }

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

// D(64x64, fp32) = A(64x16) B(16x64), or += with ACCUMULATE; A and B from
// shared memory, each K-major (TRANS 0) or MN-major (TRANS 1).
template <bool ACCUMULATE, int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  if constexpr (ACCUMULATE) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
        ", %32, %33, p, 1, 1, %35, %36;\n}\n"
        : WG_ACC32(WG_IN, d)
        : "l"(da), "l"(db), "r"(1), "n"(TRANS_A), "n"(TRANS_B));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
        ", %32, %33, p, 1, 1, %35, %36;\n}\n"
        : WG_ACC32(WG_OUT, d)
        : "l"(da), "l"(db), "r"(0), "n"(TRANS_A), "n"(TRANS_B));
  }
}

// D(64x64, fp32) += A(64x16) B(16x64); A in registers (the m16n8k16
// A-fragment layout, per warp of the warpgroup 16 rows), B MN-major in
// shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC32(WG_IN, d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of the bf16 kernel, in bytes from a 1024-byte-aligned base:
// the chunk's x ([s][p], one 64-column panel), B (turned into B~'s hi part
// in place) and C ([s][n], N / 64 panels, at least one), B~'s lo part, the
// state's two parts ([p][n]), each swizzled; then dt, the cumsum in log2
// units (cs2 = cs log2 e), exp(cs), wst (L floats each) and exp(cs_L).  P < 64 and N < 64 are zero-padded to
// 64 columns.
template <int N>
struct Bf16Smem {
  static constexpr int NP = N < 64 ? 64 : N;
  static constexpr int XT = L * 64 * 2;
  static constexpr int BT = L * NP * 2;
  static constexpr int X = 0, B = X + XT, C = B + BT, BLO = C + BT;
  static constexpr int HHI = BLO + BT, HLO = HHI + BT;
  static constexpr int ARR = HLO + BT;
  static constexpr int BYTES = ARR + (4 * L + 4) * 4 + 1024;  // + the base's alignment
};

template <int P, int N, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
mamba2_bf16(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
            const __nv_bfloat16* __restrict__ Cm, const float* __restrict__ h0,
            __nv_bfloat16* __restrict__ y, float* __restrict__ hfin, Params p) {
  using M = Bf16Smem<N>;
  constexpr int NPAN = M::NP / 64;   // 64-column panels of B, C and the state
  constexpr int KN = N / 16;         // k-slices of the products over n
  constexpr int XC = P / 8, NC = N / 8;  // 16-byte chunks in a row of x, of B and C
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (sbase - raw);
  float* dts = reinterpret_cast<float*>(sm + M::ARR);
  float* cum = dts + L;  // cs2
  float* ecs = cum + L;
  float* wst = ecs + L;
  float* etot = wst + L;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * warp + g;  // accumulator rows of this thread: r0 and r0 + 8
  const int h = blockIdx.x, b = blockIdx.y;
  const int grp = h / (p.H / p.G);
  const float a_h = A[h];
  const __nv_bfloat16* xb = x + b * p.x_sb + h * p.x_sh;
  const float* dtb = dt + b * p.dt_sb + h * p.dt_sh;
  const __nv_bfloat16* bb = Bm + b * p.b_sb + grp * p.b_sg;
  const __nv_bfloat16* cb = Cm + b * p.c_sb + grp * p.c_sg;
  const long long state_off = ((long long)b * p.H + h) * P * N;

  // the chunk's tiles zeroed once: the padding of P, N < 64 stays zero
  // (the state's tiles are written whole, below)
  for (int i = tid; i < M::HHI / 16; i += THREADS)
    reinterpret_cast<uint4*>(sm)[i] = make_uint4(0u, 0u, 0u, 0u);

  // the state as accumulators of (M = p, N = n): element i of panel j is
  // p = r0 (+ 8 for i & 2), n = 64 j + 8 (i >> 2) + 2 t4 + (i & 1)
  float st[NPAN][32];
#pragma unroll
  for (int j = 0; j < NPAN; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int pp = r0 + 8 * ((i >> 1) & 1), n = 64 * j + 8 * (i >> 2) + 2 * t4 + (i & 1);
      st[j][i] = (h0 != nullptr && pp < P && n < N) ? h0[state_off + (long long)pp * N + n] : 0.f;
    }
  // the state's two bf16 parts into their [p][n] tiles, for C h^T
  auto put_state = [&]() {
#pragma unroll
    for (int j = 0; j < NPAN; ++j)
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        const uint32_t at = j * (L * 128) + r0 * 128 + (((i >> 2) ^ (r0 & 7)) << 4) + t4 * 4;
        uint32_t hi, lo;
        split2(st[j][i], st[j][i + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(sm + M::HHI + at) = hi;
        *reinterpret_cast<uint32_t*>(sm + M::HLO + at) = lo;
        split2(st[j][i + 2], st[j][i + 3], hi, lo);
        *reinterpret_cast<uint32_t*>(sm + M::HHI + at + 8 * 128) = hi;
        *reinterpret_cast<uint32_t*>(sm + M::HLO + at + 8 * 128) = lo;
      }
  };
  put_state();

  // x, B and C of the chunk at position t0 into their tiles; rows past S are zeros
  auto stage = [&](int t0, int nv) {
    if (p.aligned) {
      for (int i = tid; i < L * XC; i += THREADS) {
        const int t = i / XC, c = i % XC;
        const bool in = t < nv;
        cp_async16(sbase + M::X + swz(t, c), in ? xb + (long long)(t0 + t) * p.x_ss + c * 8 : xb,
                   in);
      }
      for (int i = tid; i < L * NC; i += THREADS) {
        const int t = i / NC, c = i % NC;
        const bool in = t < nv;
        const long long o = t0 + t;
        cp_async16(sbase + M::B + swz(t, c), in ? bb + o * p.b_ss + c * 8 : bb, in);
        cp_async16(sbase + M::C + swz(t, c), in ? cb + o * p.c_ss + c * 8 : cb, in);
      }
    } else {  // rows not 16-byte aligned: plain loads
      const __nv_bfloat16 zero = __float2bfloat16(0.f);
      for (int i = tid; i < L * P; i += THREADS) {
        const int t = i / P, c = i % P;
        *reinterpret_cast<__nv_bfloat16*>(sm + M::X + swz(t, c >> 3) + (c & 7) * 2) =
            t < nv ? xb[(long long)(t0 + t) * p.x_ss + c] : zero;
      }
      for (int i = tid; i < L * N; i += THREADS) {
        const int t = i / N, c = i % N;
        const bool in = t < nv;
        const long long o = t0 + t;
        const uint32_t off = swz(t, c >> 3) + (c & 7) * 2;
        *reinterpret_cast<__nv_bfloat16*>(sm + M::B + off) = in ? bb[o * p.b_ss + c] : zero;
        *reinterpret_cast<__nv_bfloat16*>(sm + M::C + off) = in ? cb[o * p.c_ss + c] : zero;
      }
    }
  };

  const uint64_t dX = make_desc(sbase + M::X), dB = make_desc(sbase + M::B);
  const uint64_t dC = make_desc(sbase + M::C), dBlo = make_desc(sbase + M::BLO);
  const uint64_t dHhi = make_desc(sbase + M::HHI), dHlo = make_desc(sbase + M::HLO);

  for (int t0 = 0; t0 < p.S; t0 += L) {
    const int nv = min(L, p.S - t0);  // valid positions of this chunk
    __syncthreads();  // the previous chunk is done with every tile and array
    stage(t0, nv);
    cp_async_commit();
    // ---- inclusive cumsum of dt A: warp 0, two positions a lane, while
    // the copies fly
    if (warp == 0) {
      const int t = 2 * lane;
      const float d0 = t < nv ? dtb[(long long)(t0 + t) * p.dt_ss] : 0.f;
      const float d1 = t + 1 < nv ? dtb[(long long)(t0 + t + 1) * p.dt_ss] : 0.f;
      const float a0 = d0 * a_h, a1 = d1 * a_h;
      float incl = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffff, incl, off);
        if (lane >= off) incl += o;
      }
      const float c0 = (incl - (a0 + a1)) + a0, c1 = incl;
      const float total = __shfl_sync(0xffffffff, incl, 31);
      *reinterpret_cast<float2*>(dts + t) = make_float2(d0, d1);
      *reinterpret_cast<float2*>(cum + t) = make_float2(c0 * LOG2E, c1 * LOG2E);
      *reinterpret_cast<float2*>(ecs + t) = make_float2(expf(c0), expf(c1));
      *reinterpret_cast<float2*>(wst + t) =
          make_float2(expf(fminf(total - c0, 0.f)) * d0, expf(fminf(total - c1, 0.f)) * d1);
      if (lane == 0) etot[0] = expf(total);
    }
    cp_async_wait_all();
    fence_proxy_async();  // ... and the state parts written last chunk
    __syncthreads();      // the chunk has landed

    // ---- C B^T (M = t, N = s, K = n)
    float acc[32];
    wg_fence();
    wgmma_ss<false, 0, 0>(acc, dC, dB);
#pragma unroll
    for (int kk = 1; kk < KN; ++kk) wgmma_ss<true, 0, 0>(acc, dC + kmajor_step(kk), dB + kmajor_step(kk));
    wg_commit();
    wg_wait0();
    fence_acc(acc);

    // ---- W[t][s] = 2^(cs2_t - cs2_s) dt_s CB[t][s] for s <= t, as A
    // fragments in two bf16 parts: k-slice kk is columns 16 kk .. 16 kk + 15,
    // the accumulator's column blocks 2 kk and 2 kk + 1
    uint32_t whi[4][4], wlo[4][4];
    {
      const float c0 = cum[r0], c1 = cum[r0 + 8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int s = 8 * j + 2 * t4;
        float w[4] = {0.f, 0.f, 0.f, 0.f};
        if (8 * j <= 16 * warp + 15) {  // uniform over the warp: a block above its rows is zero
          const float2 cs2 = *reinterpret_cast<const float2*>(cum + s);
          const float2 dt2 = *reinterpret_cast<const float2*>(dts + s);
          if (s <= r0) w[0] = ex2(c0 - cs2.x) * dt2.x * acc[4 * j];
          if (s + 1 <= r0) w[1] = ex2(c0 - cs2.y) * dt2.y * acc[4 * j + 1];
          if (s <= r0 + 8) w[2] = ex2(c1 - cs2.x) * dt2.x * acc[4 * j + 2];
          if (s + 1 <= r0 + 8) w[3] = ex2(c1 - cs2.y) * dt2.y * acc[4 * j + 3];
        }
        split2(w[0], w[1], whi[j >> 1][2 * (j & 1)], wlo[j >> 1][2 * (j & 1)]);
        split2(w[2], w[3], whi[j >> 1][2 * (j & 1) + 1], wlo[j >> 1][2 * (j & 1) + 1]);
      }
    }

    // ---- y = exp(cs_t) (C h^T) + W x (M = t, N = p): C h^T over h's two
    // parts (K = n), the rows scaled, then W's two parts times x (K = s)
    float yacc[32];
    wg_fence();
    wgmma_ss<false, 0, 0>(yacc, dC, dHhi);
    wgmma_ss<true, 0, 0>(yacc, dC, dHlo);
#pragma unroll
    for (int kk = 1; kk < KN; ++kk) {
      wgmma_ss<true, 0, 0>(yacc, dC + kmajor_step(kk), dHhi + kmajor_step(kk));
      wgmma_ss<true, 0, 0>(yacc, dC + kmajor_step(kk), dHlo + kmajor_step(kk));
    }
    wg_commit();
    wg_wait0();
    fence_acc(yacc);
    {
      const float e0 = ecs[r0], e1 = ecs[r0 + 8];
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        yacc[i] *= e0;
        yacc[i + 1] *= e0;
        yacc[i + 2] *= e1;
        yacc[i + 3] *= e1;
      }
    }
    fence_acc(yacc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs(yacc, whi[kk], dX + mnmajor_step(kk));
      wgmma_rs(yacc, wlo[kk], dX + mnmajor_step(kk));
    }
    wg_commit();
    wg_wait0();
    fence_acc(yacc);
    // the products read W from registers until they complete: keep it live
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        asm volatile("" : "+r"(whi[kk][i]) :: "memory");
        asm volatile("" : "+r"(wlo[kk][i]) :: "memory");
      }
    __syncthreads();  // every product that reads B and C is done

    // ---- y into C's tile (bf16, swizzled [t][p]); B~ = wst_s B_s in two
    // parts: hi over B in place, lo into its own tile
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      const uint32_t at = r0 * 128 + (((i >> 2) ^ (r0 & 7)) << 4) + t4 * 4;
      *reinterpret_cast<__nv_bfloat162*>(sm + M::C + at) =
          __floats2bfloat162_rn(yacc[i], yacc[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(sm + M::C + at + 8 * 128) =
          __floats2bfloat162_rn(yacc[i + 2], yacc[i + 3]);
    }
    for (int i = tid; i < L * NC; i += THREADS) {
      const int s = i / NC, c = i % NC;
      const uint32_t off = swz(s, c);
      const uint4 q = *reinterpret_cast<const uint4*>(sm + M::B + off);
      const uint32_t w4[4] = {q.x, q.y, q.z, q.w};
      const float ws = wst[s];
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w4[e]));
        split2(f.x * ws, f.y * ws, hi[e], lo[e]);
      }
      *reinterpret_cast<uint4*>(sm + M::B + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(sm + M::BLO + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    fence_proxy_async();
    __syncthreads();  // y and B~ are staged

    // ---- y out: 16-byte runs of rows t < nv
    for (int i = tid; i < L * XC; i += THREADS) {
      const int t = i / XC, c = i % XC;
      if (t < nv)
        *reinterpret_cast<uint4*>(y + (((long long)b * p.S + t0 + t) * p.H + h) * P + c * 8) =
            *reinterpret_cast<const uint4*>(sm + M::C + swz(t, c));
    }

    // ---- h = exp(cs_L) h + x^T B~ (M = p, N = n, K = s), both operands
    // MN-major: x^T from x's [s][p] tile, B~ from its [s][n] tiles
    {
      const float et = etot[0];
#pragma unroll
      for (int j = 0; j < NPAN; ++j) {
#pragma unroll
        for (int i = 0; i < 32; ++i) st[j][i] *= et;
        fence_acc(st[j]);
      }
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < NPAN; ++j) {
        const uint64_t pan = (uint64_t)((j * L * 128) >> 4) + mnmajor_step(kk);
        wgmma_ss<true, 1, 1>(st[j], dX + mnmajor_step(kk), dB + pan);
        wgmma_ss<true, 1, 1>(st[j], dX + mnmajor_step(kk), dBlo + pan);
      }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int j = 0; j < NPAN; ++j) fence_acc(st[j]);
    put_state();  // C h^T of this chunk is done: the parts' tiles are free
  }

#pragma unroll
  for (int j = 0; j < NPAN; ++j)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int pp = r0 + 8 * ((i >> 1) & 1), n = 64 * j + 8 * (i >> 2) + 2 * t4;
      if (pp < P && n < N)
        *reinterpret_cast<float2*>(hfin + state_off + (long long)pp * N + n) =
            make_float2(st[j][i], st[j][i + 1]);
    }
}

// four CTAs an SM (at most 128 registers a thread); N = 128 holds two
// state panels and takes two
template <int N>
constexpr int bf16_min_ctas() { return N == 128 ? 2 : 4; }

// The bf16 kernel's shared-memory limit and carveout, set once per shape,
// on its first use.
template <int P, int N>
cudaError_t prepare_bf16() {
  static const cudaError_t err = [] {
    constexpr int MINB = bf16_min_ctas<N>();
    auto kern = mamba2_bf16<P, N, MINB>;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Bf16Smem<N>::BYTES);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return err;
}

template <int P, int N>
cudaError_t launch_bf16(const void* x, const float* dt, const float* A, const void* Bm,
                        const void* Cm, const float* h0, void* y, float* hfin, const Params& p,
                        cudaStream_t stream) {
  constexpr int MINB = bf16_min_ctas<N>();
  const cudaError_t attr_err = prepare_bf16<P, N>();
  if (attr_err != cudaSuccess) return attr_err;
  mamba2_bf16<P, N, MINB><<<dim3(p.H, p.B), THREADS, Bf16Smem<N>::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(x), dt, A, static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), h0, static_cast<__nv_bfloat16*>(y), hfin, p);
  return cudaGetLastError();
}

template <int P, int N>
int ctas_per_sm() {
  constexpr int MINB = bf16_min_ctas<N>();
  int n = 0;
  cudaError_t e = prepare_bf16<P, N>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, mamba2_bf16<P, N, MINB>, THREADS,
                                                      Bf16Smem<N>::BYTES);
  return e == cudaSuccess ? n : -(int)e;
}

template <int P, int N>
cudaError_t launch_f32(const void* x, const float* dt, const float* A, const void* Bm,
                       const void* Cm, const float* h0, void* y, float* hfin, const Params& p,
                       cudaStream_t stream) {
  constexpr size_t smem = f32_smem_floats<P, N>() * sizeof(float);
  static const cudaError_t attr_err = cudaFuncSetAttribute(
      mamba2_f32<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr_err != cudaSuccess) return attr_err;
  mamba2_f32<P, N><<<dim3(p.H, p.B), F_THREADS, smem, stream>>>(
      static_cast<const float*>(x), dt, A, static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), h0, static_cast<float*>(y), hfin, p);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t by_dtype(int is_bf16, const void* x, const float* dt, const float* A, const void* Bm,
                     const void* Cm, const float* h0, void* y, float* hfin, const Params& p,
                     cudaStream_t st) {
  if (is_bf16) return launch_bf16<P, N>(x, dt, A, Bm, Cm, h0, y, hfin, p, st);
  return launch_f32<P, N>(x, dt, A, Bm, Cm, h0, y, hfin, p, st);
}

template <int P>
cudaError_t by_state(int N, int is_bf16, const void* x, const float* dt, const float* A,
                     const void* Bm, const void* Cm, const float* h0, void* y, float* hfin,
                     const Params& p, cudaStream_t st) {
  switch (N) {
    case 16: return by_dtype<P, 16>(is_bf16, x, dt, A, Bm, Cm, h0, y, hfin, p, st);
    case 32: return by_dtype<P, 32>(is_bf16, x, dt, A, Bm, Cm, h0, y, hfin, p, st);
    case 64: return by_dtype<P, 64>(is_bf16, x, dt, A, Bm, Cm, h0, y, hfin, p, st);
    case 128: return by_dtype<P, 128>(is_bf16, x, dt, A, Bm, Cm, h0, y, hfin, p, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int P>
int ctas_by_state(int N) {
  switch (N) {
    case 16: return ctas_per_sm<P, 16>();
    case 32: return ctas_per_sm<P, 32>();
    case 64: return ctas_per_sm<P, 64>();
    case 128: return ctas_per_sm<P, 128>();
    default: return 0;
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  The caller
// has checked shapes, dtypes (x, B, C bf16 or fp32 alike; dt, A, h0 fp32)
// and strides (innermost stride 1 for x, B and C; A, h0 contiguous; y and
// hfin contiguous outputs), P in {16, 32, 64}, N in {16, 32, 64, 128}.
// h0 may be null (zero initial state).
extern "C" int mamba2_scan(
    const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
    const void* h0, void* y, void* hfin, int is_bf16,
    int B, int S, int H, int G, int P, int N,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh,
    long long b_sb, long long b_ss, long long b_sg,
    long long c_sb, long long c_ss, long long c_sg, void* stream) {
  Params p;
  p.B = B; p.S = S; p.H = H; p.G = G;
  p.x_sb = x_sb; p.x_ss = x_ss; p.x_sh = x_sh;
  p.dt_sb = dt_sb; p.dt_ss = dt_ss; p.dt_sh = dt_sh;
  p.b_sb = b_sb; p.b_ss = b_ss; p.b_sg = b_sg;
  p.c_sb = c_sb; p.c_ss = c_ss; p.c_sg = c_sg;
  // every bf16 row of x, B and C starts on 16 bytes: cp.async
  p.aligned = aligned16(x) && aligned16(Bm) && aligned16(Cm) &&
              (x_sb | x_ss | x_sh | b_sb | b_ss | b_sg | c_sb | c_ss | c_sg) % 8 == 0;
  const float* dtp = static_cast<const float*>(dt);
  const float* Ap = static_cast<const float*>(A);
  const float* h0p = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(hfin);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 16: return (int)by_state<16>(N, is_bf16, x, dtp, Ap, Bm, Cm, h0p, y, hf, p, st);
    case 32: return (int)by_state<32>(N, is_bf16, x, dtp, Ap, Bm, Cm, h0p, y, hf, p, st);
    case 64: return (int)by_state<64>(N, is_bf16, x, dtp, Ap, Bm, Cm, h0p, y, hf, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// CTAs of the bf16 kernel that fit one SM at headdim P and d_state N (0
// for another shape), or minus a CUDA error.
extern "C" int mamba2_ctas_per_sm(int P, int N) {
  switch (P) {
    case 16: return ctas_by_state<16>(N);
    case 32: return ctas_by_state<32>(N);
    case 64: return ctas_by_state<64>(N);
    default: return 0;
  }
}
