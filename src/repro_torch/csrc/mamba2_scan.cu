// Chunked Mamba2 (SSD) scan for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel `mamba2_scan` / `_mamba2_kernel` in
// src/repro/kernels/mamba2_scan.py: per (batch, head) the recurrence
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t
// in its chunked form.  Inside a chunk of L positions, with cs the
// inclusive cumsum of dt A (never increasing, so every exponent is <= 0):
//   y_t  = sum_{s<=t} exp(cs_t - cs_s) dt_s (C_t . B_s) x_s + exp(cs_t) C_t . h
//   h'   = exp(cs_L) h + sum_s exp(cs_L - cs_s) dt_s x_s B_s^T
// It returns y and the final state.
//
// What bounds it on the card: at the serve shape (B 8, S 1024, H 64,
// P = N = 64, bf16) the kernel must read x (67 MB), B, C and dt and write y
// (67 MB) and the fp32 state (8 MB): about 150 MB, 0.045 ms at 3.35 TB/s.
// The chunked products are about 17 GFLOP, which the tensor cores would do
// in less time than that, so the bound is bytes.  This first version does
// all arithmetic in fp32 on the CUDA cores (mma.sync would round fp32 to
// tf32), so it is bound by its own shared-memory traffic instead:
//   - grid: one CTA of 256 threads per (head, batch), 512 CTAs at the serve
//     shape; the chunk loop inside the CTA takes the place of the TPU grid's
//     sequential chunk axis;
//   - per chunk of L = 64 positions, x, B, C (of the head's group) and dt
//     are staged in shared memory in fp32; the cumsum of dt A is a warp
//     scan; the (P, N) state stays in shared memory across chunks;
//   - the three chunk products (C B^T, then W x + C h, then the state
//     update) are 64 x 64 tiles, each thread holding a 4 x 4 (or smaller)
//     register tile, so each shared-memory load feeds several FMAs.
// Left for later: tensor cores (bf16 products for C B^T and W x), TMA or
// cp.async staging that overlaps the next chunk's loads, and splitting a
// sequence over several CTAs (a two-pass scan over chunk states).
//
// Semantics beyond the TPU kernel: any S (a ragged last chunk is masked,
// not refused); strided x, dt, B and C (innermost stride 1 for x, B, C).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int L = 64;         // chunk length
constexpr int WLD = L + 16;   // row stride of W: rows t and t + 1 fall in opposite bank halves

struct Params {
  int B, S, H, G;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float& d, float x) { d = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16& d, float x) { d = __float2bfloat16(x); }

template <int P, int N>
constexpr size_t smem_floats() {
  return (size_t)L * P + 2 * (size_t)L * (N + 1) + (size_t)L * WLD + (size_t)P * (N + 1) + 4 * L + 1;
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS)
mamba2_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
              const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ h0,
              T* __restrict__ y, float* __restrict__ hfin, Params p) {
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

  const T* xb = x + b * p.x_sb + h * p.x_sh;
  const float* dtb = dt + b * p.dt_sb + h * p.dt_sh;
  const T* bb = Bm + b * p.b_sb + g * p.b_sg;
  const T* cb = Cm + b * p.c_sb + g * p.c_sg;
  const long long state_off = ((long long)b * p.H + h) * P * N;

  for (int i = tid; i < P * N; i += THREADS)
    hs[(i / N) * NP + i % N] = h0 ? h0[state_off + i] : 0.f;

  for (int t0 = 0; t0 < p.S; t0 += L) {
    const int nv = min(L, p.S - t0);  // valid positions of this chunk
    __syncthreads();  // the previous chunk is consumed; the initial state is written

    // ---- stage x, B, C, dt in fp32; positions past S are zeros
    for (int i = tid; i < L * P; i += THREADS) {
      const int t = i / P, c = i % P;
      xs[i] = t < nv ? to_f(xb[(long long)(t0 + t) * p.x_ss + c]) : 0.f;
    }
    for (int i = tid; i < L * N; i += THREADS) {
      const int t = i / N, c = i % N;
      const bool ok = t < nv;
      bs[t * NP + c] = ok ? to_f(bb[(long long)(t0 + t) * p.b_ss + c]) : 0.f;
      cs[t * NP + c] = ok ? to_f(cb[(long long)(t0 + t) * p.c_ss + c]) : 0.f;
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
          T* yrow = y + (((long long)b * p.S + t0 + t) * p.H + h) * P;
#pragma unroll
          for (int j = 0; j < IP; ++j)
            from_f(yrow[tx + 16 * j], fmaf(ecs[t], acs[i][j], acc[i][j]));
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
  for (int i = tid; i < P * N; i += THREADS) hfin[state_off + i] = hs[(i / N) * NP + i % N];
}

template <typename T, int P, int N>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* Bm,
                   const void* Cm, const float* h0, void* y, float* hfin, const Params& p,
                   cudaStream_t stream) {
  const size_t smem = smem_floats<P, N>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(mamba2_kernel<T, P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.H, p.B);
  mamba2_kernel<T, P, N><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm), h0,
      static_cast<T*>(y), hfin, p);
  return cudaGetLastError();
}

template <int P, int N>
cudaError_t by_dtype(int is_bf16, const void* x, const float* dt, const float* A, const void* Bm,
                     const void* Cm, const float* h0, void* y, float* hfin, const Params& p,
                     cudaStream_t st) {
  if (is_bf16) return launch<__nv_bfloat16, P, N>(x, dt, A, Bm, Cm, h0, y, hfin, p, st);
  return launch<float, P, N>(x, dt, A, Bm, Cm, h0, y, hfin, p, st);
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
