// Flash attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel `flash_attention_fwd` / `_fwd_kernel` in
// src/repro/kernels/flash_attention.py: blockwise online-softmax attention,
// causal with offset T - S, GQA query head h reading KV head h / (H / KV).
//
// What bounds it on the card: at prefill shapes (S = T = 1000, D = 64) the
// work is two matrix products per tile, about 4 * S * T / 2 * D operations
// per (batch, head) against 2 * (S + T) * D bytes, so the tensor cores bound
// it, not memory.  The design keeps every product on the tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 accumulate) and the S x T scores in
// registers: a CTA of 4 warps owns a 64-row query tile, each warp 16 rows,
// and loops over 64-key K/V tiles staged in shared memory (the loop takes
// the place of the TPU grid's sequential innermost axis).  Tiles wholly
// above the causal diagonal are never loaded.  The first version is simple:
// no cp.async/TMA pipelining and no wgmma; those are later work.
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
// bf16: tensor-core kernel
// ---------------------------------------------------------------------------
constexpr int BQ = 64;       // query rows per CTA (16 per warp)
constexpr int BK = 64;       // keys per K/V tile
constexpr int PADH = 8;      // bf16 elements of row padding (16 bytes)

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(128)
fa_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, Params p) {
  constexpr int QLD = D + PADH;   // row stride of Qs and Ks
  constexpr int VLD = BK + PADH;  // row stride of Vt (V transposed: [d][key])
  constexpr int NT_S = BK / 8;    // n-tiles of the score tile
  constexpr int NT_O = D / 8;     // n-tiles of the output tile
  constexpr int VEC = 8;          // bf16 per 16-byte load

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * QLD;
  __nv_bfloat16* Vt = Ks + BK * QLD;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma groupID / thread-in-group
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / p.group;

  const __nv_bfloat16* qb = q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = v + b * p.v_sb + kvh * p.v_sh;

  // stage the query tile; rows past S are zero
  for (int i = tid; i < BQ * D / VEC; i += blockDim.x) {
    int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < p.S) val = *reinterpret_cast<const uint4*>(qb + (long long)(q0 + r) * p.q_ss + c);
    *reinterpret_cast<uint4*>(Qs + r * QLD + c) = val;
  }

  const int r0 = warp * 16 + g;  // this thread's rows in the tile: r0, r0 + 8
  const int qpos0 = q0 + r0 + p.offs, qpos1 = qpos0 + 8;
  float o_acc[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) o_acc[j][0] = o_acc[j][1] = o_acc[j][2] = o_acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float sl2 = p.scale * 1.4426950408889634f;  // scores in log2 units

  const int kv_end = kv_end_for_tile(p, q0, BQ);
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // previous tile fully consumed (and Qs visible on entry)
    for (int i = tid; i < BK * D / VEC; i += blockDim.x) {
      int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
      uint4 kval = make_uint4(0, 0, 0, 0), vval = make_uint4(0, 0, 0, 0);
      if (k0 + r < p.T) {
        kval = *reinterpret_cast<const uint4*>(kb + (long long)(k0 + r) * p.k_st + c);
        vval = *reinterpret_cast<const uint4*>(vb + (long long)(k0 + r) * p.v_st + c);
      }
      *reinterpret_cast<uint4*>(Ks + r * QLD + c) = kval;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vval);
#pragma unroll
      for (int e = 0; e < VEC; ++e) Vt[(c + e) * VLD + r] = ve[e];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      const __nv_bfloat16* qa = Qs + r0 * QLD + kk * 16 + t4 * 2;
      a[0] = ld_u32(qa);
      a[1] = ld_u32(qa + 8 * QLD);
      a[2] = ld_u32(qa + 8);
      a[3] = ld_u32(qa + 8 * QLD + 8);
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        const __nv_bfloat16* kp = Ks + (j * 8 + g) * QLD + kk * 16 + t4 * 2;
        mma_bf16(s[j], a, ld_u32(kp), ld_u32(kp + 8));
      }
    }

    // mask (ragged T tail, causal diagonal) and online softmax in fp32
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int key = k0 + j * 8 + t4 * 2 + (e & 1);
        int qpos = (e < 2) ? qpos0 : qpos1;
        bool ok = key < p.T && (!p.causal || key <= qpos);
        s[j][e] = ok ? s[j][e] * sl2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row that has seen no key yet keeps p = 0 (exp2(-inf - 0))
    const float mu0 = (mn0 == -INFINITY) ? 0.f : mn0;
    const float mu1 = (mn1 == -INFINITY) ? 0.f : mn1;
    const float c0 = exp2f(m0 - mu0), c1 = exp2f(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      s[j][0] = exp2f(s[j][0] - mu0);
      s[j][1] = exp2f(s[j][1] - mu0);
      s[j][2] = exp2f(s[j][2] - mu1);
      s[j][3] = exp2f(s[j][3] - mu1);
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
    l0 = l0 * c0 + ps0;  // per-thread partial row sums, reduced at the end
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      o_acc[j][0] *= c0;
      o_acc[j][1] *= c0;
      o_acc[j][2] *= c1;
      o_acc[j][3] *= c1;
    }

    // O += P V: the score accumulators are re-packed as the A operand
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < NT_O; ++j) {
        const __nv_bfloat16* vp = Vt + (j * 8 + g) * VLD + kk * 16 + t4 * 2;
        mma_bf16(o_acc[j], a, ld_u32(vp), ld_u32(vp + 8));
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffff, l0, off);
    l1 += __shfl_xor_sync(0xffffffff, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = o + b * p.o_sb + h * p.o_sh;
  const int row0 = q0 + r0, row1 = row0 + 8;
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    int c = j * 8 + t4 * 2;
    if (row0 < p.S)
      *reinterpret_cast<uint32_t*>(ob + (long long)row0 * p.o_ss + c) =
          pack_bf16(o_acc[j][0] * inv0, o_acc[j][1] * inv0);
    if (row1 < p.S)
      *reinterpret_cast<uint32_t*>(ob + (long long)row1 * p.o_ss + c) =
          pack_bf16(o_acc[j][2] * inv1, o_acc[j][3] * inv1);
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
                   size_t smem, cudaStream_t stream, const void* q, const void* k,
                   const void* v, void* o, const Params& p) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, 128, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                    static_cast<const T*>(v), static_cast<T*>(o), p);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(int is_bf16, const void* q, const void* k, const void* v, void* o,
                     const Params& p, cudaStream_t stream) {
  if (is_bf16) {
    size_t smem = (size_t)(BQ * (D + PADH) + BK * (D + PADH) + D * (BK + PADH)) * 2;
    dim3 grid((p.S + BQ - 1) / BQ, p.H, p.B);
    return launch<__nv_bfloat16>(fa_fwd_bf16<D>, grid, smem, stream, q, k, v, o, p);
  }
  size_t smem = (size_t)(FBQ * D + FBK * (D + 1) + FBK * D) * 4;
  dim3 grid((p.S + FBQ - 1) / FBQ, p.H, p.B);
  return launch<float>(fa_fwd_f32<D>, grid, smem, stream, q, k, v, o, p);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success); the caller
// has checked shapes, dtypes, strides (innermost stride 1, the others
// multiples of 16 bytes) and that D is 64, 128 or 256.
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
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_st = k_st;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_st = v_st;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)dispatch<64>(is_bf16, q, k, v, o, p, st);
    case 128: return (int)dispatch<128>(is_bf16, q, k, v, o, p, st);
    case 256: return (int)dispatch<256>(is_bf16, q, k, v, o, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
