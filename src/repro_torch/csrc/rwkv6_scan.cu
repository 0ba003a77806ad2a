// Chunked RWKV6 (Finch) WKV scan for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel `rwkv6_scan` / `_rwkv6_kernel` in
// src/repro/kernels/rwkv6_scan.py: per (batch, head), with a (K, V) state
// S, per-channel data-dependent log-decay w_t <= 0 and a bonus u,
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(exp w_t) S_{t-1} + k_t v_t^T
// in its chunked form.  Inside a chunk, with cw the inclusive cumsum of w
// per channel and cwx = cw - w the exclusive one:
//   y_t = (r_t * exp(cwx_t)) S + sum_{s<t} [sum_k r_tk k_sk exp(cwx_tk - cw_sk)] v_s
//         + (sum_k r_tk u_k k_tk) v_t
//   S'  = diag(exp cw_L) S + (k * exp(cw_L - cw))^T v
// The decay between t > s is formed per (t, s, k) as exp(cwx_t - cw_s), an
// exponent that is never positive, as the TPU kernel does; the factored
// form r exp(cw) . k exp(-cw) would overflow for strongly decaying channels.
//
// What bounds it on the card: at the serve shape (B 8, S 1024, H 64,
// K = V = 64, r/k/v bf16, w fp32) the kernel must read r, k, v (201 MB) and
// w (134 MB) and write y (67 MB) and the fp32 state (8 MB): about 410 MB,
// 0.12 ms at 3.35 TB/s; the products are a few GFLOP, so the bound is
// bytes.  This first version does everything in fp32 on the CUDA cores
// and is bound by the L^2 K / 2 exponentials of the intra-chunk pairs and
// by shared-memory traffic:
//   - grid: one CTA of 256 threads per (head, batch), 512 CTAs at the serve
//     shape; the chunk loop inside the CTA takes the place of the TPU grid's
//     sequential chunk axis; the (K, V) state stays in shared memory;
//   - chunk L = 32 (one position a lane for the per-channel cumsum, a warp
//     scan), which halves the exponentials per token against L = 64;
//   - the (t, s) pair matrix is cut into 2 x 2 blocks: the 136 blocks on or
//     below the diagonal take one thread each, the 120 above it are zeros;
//   - y = [r exp(cwx) | A] [S ; v] and the state update are register-tiled
//     products over shared memory.
// Left for later: tensor cores for the two products, staging the next
// chunk while this one computes, and splitting a sequence over CTAs.
//
// Semantics beyond the TPU kernel: any S (a ragged last chunk is masked,
// not refused); strided r, k, v, w (innermost stride 1).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int L = 32;          // chunk length: one position per lane
constexpr int NB = L / 2;      // 2 x 2 blocks per side of the pair matrix
constexpr int LOWER = NB * (NB + 1) / 2;  // blocks on or below the diagonal (136)
constexpr int ALD = L + 1;     // row stride of the pair matrix

struct Params {
  int B, S, H;
  long long r_sb, r_ss, r_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long w_sb, w_ss, w_sh;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float& d, float x) { d = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16& d, float x) { d = __float2bfloat16(x); }

template <int K, int V>
constexpr size_t smem_floats() {
  return 4 * (size_t)L * (K + 1) + (size_t)L * V + (size_t)L * ALD + (size_t)K * (V + 1) + 2 * K;
}

template <typename T, int K, int V>
__global__ void __launch_bounds__(THREADS)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
             const float* __restrict__ w, const float* __restrict__ u,
             const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ sfin,
             Params p) {
  constexpr int KP = K + 1;    // odd row stride
  constexpr int VP = V + 1;
  constexpr int JV = V / 16, IK = K / 16;
  static_assert(THREADS == LOWER + NB * (NB - 1) / 2, "one thread per 2 x 2 block");
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;               // [L][KP] r, then r * exp(cwx)
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
  const T* rb = r + b * p.r_sb + h * p.r_sh;
  const T* kb = k + b * p.k_sb + h * p.k_sh;
  const T* vb = v + b * p.v_sb + h * p.v_sh;
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

  for (int i = tid; i < K * V; i += THREADS)
    ss[(i / V) * VP + i % V] = s0 ? s0[state_off + i] : 0.f;
  for (int i = tid; i < K; i += THREADS) us[i] = u[(long long)h * K + i];

  for (int t0 = 0; t0 < p.S; t0 += L) {
    const int nv = min(L, p.S - t0);
    __syncthreads();  // the previous chunk is consumed; state and u are written

    // ---- stage r, k, w (into cw), v in fp32; positions past S are zeros
    for (int i = tid; i < L * K; i += THREADS) {
      const int t = i / K, c = i % K;
      const bool ok = t < nv;
      const long long o = t0 + t;
      rs[t * KP + c] = ok ? to_f(rb[o * p.r_ss + c]) : 0.f;
      ks[t * KP + c] = ok ? to_f(kb[o * p.k_ss + c]) : 0.f;
      cw[t * KP + c] = ok ? wb[o * p.w_ss + c] : 0.f;
    }
    for (int i = tid; i < L * V; i += THREADS) {
      const int t = i / V, c = i % V;
      vs[i] = t < nv ? to_f(vb[(long long)(t0 + t) * p.v_ss + c]) : 0.f;
    }
    __syncthreads();

    // ---- per-channel inclusive cumsum over the chunk: a warp scan per
    // channel, lane = position
    for (int c = warp; c < K; c += THREADS / 32) {
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
    for (int i = tid; i < L * K; i += THREADS) {
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
          T* yrow = y + (((long long)b * p.S + t0 + t) * p.H + h) * V;
#pragma unroll
          for (int j = 0; j < JV; ++j) from_f(yrow[tx + 16 * j], acc[i][j]);
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
  for (int i = tid; i < K * V; i += THREADS) sfin[state_off + i] = ss[(i / V) * VP + i % V];
}

template <typename T, int K, int V>
cudaError_t launch(const void* r, const void* k, const void* v, const float* w, const float* u,
                   const float* s0, void* y, float* sfin, const Params& p, cudaStream_t stream) {
  const size_t smem = smem_floats<K, V>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(rwkv6_kernel<T, K, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.H, p.B);
  rwkv6_kernel<T, K, V><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, u, s0,
      static_cast<T*>(y), sfin, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t by_dtype(int is_bf16, const void* r, const void* k, const void* v, const float* w,
                     const float* u, const float* s0, void* y, float* sfin, const Params& p,
                     cudaStream_t st) {
  if (is_bf16) return launch<__nv_bfloat16, D, D>(r, k, v, w, u, s0, y, sfin, p, st);
  return launch<float, D, D>(r, k, v, w, u, s0, y, sfin, p, st);
}

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
