// Flash decode for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel `flash_decode` / `_decode_kernel` in
// src/repro/kernels/decode_attention.py: one query token per (batch, head)
// against a KV cache with a per-batch valid length, fp32 online softmax.
//
// What bounds it on the card: bytes.  Each valid cache position is read once
// (K and V, KV heads x D each) and used for a handful of FMAs per query head,
// far below the ~295 operations per byte at which the tensor cores would
// become the limit.  The design reads every K/V row once per GQA group: one
// CTA per (batch, kv head) handles the H / KV query heads that share it, so
// the cache is not re-read per query head.  Tiles of 64 positions are
// staged in shared memory with 16-byte loads; scores, softmax and the PV
// sum run on the CUDA cores in fp32.  The loop stops at length[b], so bytes
// past the valid length are never read.  The first version is simple: with
// B x KV CTAs (32 for TinyLlama at batch 8) it fills a fraction of the 132
// SMs; splitting the KV axis across CTAs is later work.
//
// Semantics beyond the TPU kernel: any cache length T is accepted (no
// T % block_k rule), and length[b] == 0 returns zeros as the TPU kernel does.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int BK = 64;       // cache positions per tile
constexpr int MAX_ACC = 8;   // outputs per thread: G * D <= THREADS * MAX_ACC

struct Params {
  int B, H, KV, T, group;
  long long q_sb, q_sh;
  long long k_sb, k_sh, k_st;
  long long v_sb, v_sh, v_st;
  long long o_sb, o_sh;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float& d, float x) { d = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16& d, float x) { d = __float2bfloat16(x); }

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ length, T* __restrict__ o, Params p) {
  constexpr int KLD = D + 1;                // odd stride: lane j reads row j conflict-free
  constexpr int VEC = 16 / sizeof(T);       // elements per 16-byte load
  const int G = p.group;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [G][D], pre-scaled
  float* ks = qs + G * D;                           // [BK][KLD]
  float* vs = ks + BK * KLD;                        // [BK][D]
  float* ps = vs + BK * D;                          // [G][BK] scores, then probabilities
  float* ms = ps + G * BK;                          // [G] running max
  float* ls = ms + G;                               // [G] running sum
  float* cs = ls + G;                               // [G] this tile's correction

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int n = min(max(length[b], 0), p.T);

  const T* qb = q + b * p.q_sb + (long long)kvh * G * p.q_sh;
  const T* kb = k + b * p.k_sb + kvh * p.k_sh;
  const T* vb = v + b * p.v_sb + kvh * p.v_sh;

  for (int i = tid; i < G * D; i += THREADS)
    qs[i] = to_f(qb[(i / D) * p.q_sh + i % D]) * p.scale;
  for (int i = tid; i < G; i += THREADS) {
    ms[i] = -INFINITY;
    ls[i] = 0.f;
  }
  float acc[MAX_ACC];
#pragma unroll
  for (int r = 0; r < MAX_ACC; ++r) acc[r] = 0.f;

  for (int t0 = 0; t0 < n; t0 += BK) {
    __syncthreads();  // previous tile consumed; qs/ms/ls visible on entry
    for (int i = tid; i < BK * D / VEC; i += THREADS) {
      int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
      uint4 kr = make_uint4(0, 0, 0, 0), vr = make_uint4(0, 0, 0, 0);
      if (t0 + r < n) {
        kr = *reinterpret_cast<const uint4*>(kb + (long long)(t0 + r) * p.k_st + c);
        vr = *reinterpret_cast<const uint4*>(vb + (long long)(t0 + r) * p.v_st + c);
      }
      const T* ke = reinterpret_cast<const T*>(&kr);
      const T* ve = reinterpret_cast<const T*>(&vr);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ks[r * KLD + c + e] = to_f(ke[e]);
        vs[r * D + c + e] = to_f(ve[e]);
      }
    }
    __syncthreads();

    // scores for every (head, position) pair of the tile
    for (int i = tid; i < G * BK; i += THREADS) {
      int gi = i / BK, j = i % BK;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qs[gi * D + d], ks[j * KLD + d], s);
      ps[i] = (t0 + j < n) ? s : -INFINITY;
    }
    __syncthreads();

    // online softmax, one warp per head; position t0 is valid, so max is finite
    for (int gi = warp; gi < G; gi += THREADS / 32) {
      float s0 = ps[gi * BK + lane], s1 = ps[gi * BK + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffff, mx, off));
      const float m_old = ms[gi];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      ps[gi * BK + lane] = p0;
      ps[gi * BK + lane + 32] = p1;
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
      const int i = tid + r * THREADS;
      if (i < G * D) {
        const int gi = i / D, d = i % D;
        float a = acc[r] * cs[gi];
#pragma unroll 8
        for (int j = 0; j < BK; ++j) a = fmaf(ps[gi * BK + j], vs[j * D + d], a);
        acc[r] = a;
      }
    }
  }
  __syncthreads();  // ls final (also when no tile ran)

  T* ob = o + b * p.o_sb + (long long)kvh * G * p.o_sh;
#pragma unroll
  for (int r = 0; r < MAX_ACC; ++r) {
    const int i = tid + r * THREADS;
    if (i < G * D) {
      const int gi = i / D, d = i % D;
      from_f(ob[gi * p.o_sh + d], acc[r] / fmaxf(ls[gi], 1e-30f));
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* length, void* o,
                   const Params& p, cudaStream_t stream) {
  const size_t smem = (size_t)(p.group * D + BK * (D + 1) + BK * D + p.group * BK + 3 * p.group) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(decode_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.KV, p.B);
  decode_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), length,
      static_cast<T*>(o), p);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(int is_bf16, const void* q, const void* k, const void* v,
                     const int* length, void* o, const Params& p, cudaStream_t stream) {
  if (is_bf16) return launch<__nv_bfloat16, D>(q, k, v, length, o, p, stream);
  return launch<float, D>(q, k, v, length, o, p, stream);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).  The caller
// has checked shapes, dtypes and strides (innermost stride 1, K/V row
// strides multiples of 16 bytes), D in {64, 128}, and G * D <= 2048.
extern "C" int flash_decode(
    const void* q, const void* k, const void* v, const void* length, void* o, int is_bf16,
    int B, int H, int KV, int T, int D, float scale,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st,
    long long o_sb, long long o_sh, void* stream) {
  Params p;
  p.B = B; p.H = H; p.KV = KV; p.T = T; p.group = H / KV; p.scale = scale;
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_st = k_st;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_st = v_st;
  p.o_sb = o_sb; p.o_sh = o_sh;
  const int* len = static_cast<const int*>(length);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)dispatch<64>(is_bf16, q, k, v, len, o, p, st);
    case 128: return (int)dispatch<128>(is_bf16, q, k, v, len, o, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
