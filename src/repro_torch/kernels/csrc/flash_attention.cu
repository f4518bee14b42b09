// flash_attention: GQA forward attention with an online softmax, hand-written
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` / `_kernel` in
// src/repro/kernels/flash_attention.py.  It computes what the plain PyTorch
// version `attention_ref` (src/repro_torch/kernels/flash_attention.py)
// computes, for q [B, Hq, Tq, D] and k, v [B, Hkv, Tk, D] (float or bf16):
//
//   S = (q kᵀ) · D^-½ in f32;  causal: row i sees columns <= i + (Tk - Tq)
//   o = softmax(S) v, written in q's type
//
// Query head h reads KV head h / (Hq / Hkv); K and V are never repeated in
// memory.  The causal mask is aligned bottom-right, as the JAX package's
// oracle `ref.attention_ref` aligns it (its Pallas kernel aligns top-left;
// the two agree when Tq == Tk, the teacher-forced case).  Masked scores are
// -1e30, not -inf, so exp(m_prev - m_new) never sees -inf - -inf.  The
// ragged edges are masked, not padded: rows >= Tq are neither read nor
// written, and columns >= Tk never read.
//
// Grid and block: one CTA of 256 threads per (b·Hq, 64-row query block); a
// loop over the 64-column KV blocks inside the CTA takes the place of the
// TPU's sequential grid axis, with the running max m, normalizer l and the
// accumulator in f32 registers.  Under the causal mask the loop stops at
// the last block the block's last row can see, and the query blocks are
// launched longest first (blockIdx.y counts down the rows), so the short
// ones fill the tail.  The tiles sit in dynamic shared memory as f32:
//   Qᵀ [D][68], Kᵀ [D][68] (its space holds Pᵀ [64][68] once S is formed),
//   V [64][D]
// = 100 KB at D = 128, so two CTAs fit on an SM.  Thread t owns rows
// 4(t/16) .. +3 of the block: a 4 x 4 tile of S (columns 4(t%16) .. +3)
// and a 4 x D/16 tile of o; the 16 threads of a row group reduce the row
// statistics with warp shuffles.  Every product is plain f32 FMAs on the
// CUDA cores, fed by float4 loads from shared memory (no wgmma, no TMA).
//
// What bounds it on this card, at llama3.2-3b's shape (B=4, Hq=24, Hkv=8,
// T=2048, D=128, bf16): the two products are 2·2·T²·D flops per (b, h),
// halved by the mask, 103 GFLOP: 0.104 ms at the 989 TFLOP/s bf16 tensor
// rate; q, k, v and o are 134 MB, 0.040 ms at 3.35 TB/s.  So operations
// bound it, and a kernel that computes on the CUDA cores in f32 (67 TFLOP/s
// at best) stays far from that bound; tensor-core products (mma / wgmma)
// and TMA loads are the redesign.
//
// The kernel allocates nothing and runs on the caller's stream; the C entry
// point returns the first CUDA error of the attribute call or the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;         // query rows per CTA
constexpr int kBK = 64;         // key columns per loop step
constexpr int kLd = kBQ + 4;    // row stride of Qᵀ, Kᵀ and Pᵀ (kBQ == kBK)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four consecutive elements of a row of q, k or v, as f32.
__device__ __forceinline__ float4 load4(const float* p) { return ld4(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Shared-memory plan, in floats: Qᵀ, then Kᵀ (reused for Pᵀ), then V.
__host__ __device__ constexpr int kt_offset(int D) { return D * kLd; }
__host__ __device__ constexpr int v_offset(int D) {
  return kt_offset(D) + (D > kBK ? D : kBK) * kLd;
}
__host__ __device__ constexpr int smem_floats(int D) {
  return v_offset(D) + kBK * D;
}

// rows [r0, r0 + 64) of a [len, D] matrix into dst[d][r] (transposed), zero
// past len.  Thread t moves row t % 64, four columns at a time.
template <typename T, int D>
__device__ __forceinline__ void load_transposed(float* dst, const T* src,
                                                int r0, int len) {
  for (int i = threadIdx.x; i < kBQ * (D / 4); i += kThreads) {
    const int r = i % kBQ, d = (i / kBQ) * 4;
    const float4 x = r0 + r < len ? load4(src + (size_t)(r0 + r) * D + d)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[(d + 0) * kLd + r] = x.x;
    dst[(d + 1) * kLd + r] = x.y;
    dst[(d + 2) * kLd + r] = x.z;
    dst[(d + 3) * kLd + r] = x.w;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int Hq,
                           int Hkv, int Tq, int Tk, float scale, int causal) {
  constexpr int CD = D / 16;  // o columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                  // Qᵀ [D][kLd]
  float* kt = smem + kt_offset(D);   // Kᵀ [D][kLd], then Pᵀ [kBK][kLd]
  float* vs = smem + v_offset(D);    // V  [kBK][D]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = b * Hkv + h / (Hq / Hkv);
  const int nqb = gridDim.y;
  const int q0 = (causal ? nqb - 1 - (int)blockIdx.y : (int)blockIdx.y) * kBQ;
  const int off = Tk - Tq;           // bottom-right alignment of the mask
  const T* qb = q + (size_t)bh * Tq * D;
  const T* kb = k + (size_t)kvh * Tk * D;
  const T* vb = v + (size_t)kvh * Tk * D;

  const int rg = tid / 16, cs = tid % 16;  // row group, column slot
  const int i0 = rg * 4;                    // first of this thread's rows
  const int j0 = cs * 4;                    // first of its S columns
  const int d0 = cs * CD;                   // first of its o columns

  // KV blocks to visit: all, or up to the last one the block's last row sees.
  int nkb = (Tk + kBK - 1) / kBK;
  if (causal) {
    const int last_col = min(q0 + kBQ, Tq) - 1 + off;
    nkb = last_col < 0 ? 0 : min(nkb, last_col / kBK + 1);
  }

  float m[4], l[4], acc[4][CD];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[r][c] = 0.f;
  }

  load_transposed<T, D>(qt, qb, q0, Tq);

  for (int kbi = 0; kbi < nkb; ++kbi) {
    const int k0 = kbi * kBK;
    __syncthreads();  // the previous step is done with Pᵀ and V
    load_transposed<T, D>(kt, kb, k0, Tk);
    for (int i = tid; i < kBK * (D / 4); i += kThreads) {
      const int r = i / (D / 4), d = (i % (D / 4)) * 4;
      const float4 x = k0 + r < Tk ? load4(vb + (size_t)(k0 + r) * D + d)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(vs + r * D + d) = x;
    }
    __syncthreads();

    // S tile: s[r][c] = q[i0 + r] · k[j0 + c]
    float s[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = ld4(qt + d * kLd + i0);
      const float4 bb = ld4(kt + d * kLd + j0);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(av[r], bv[c], s[r][c]);
    }

    // scale, mask, online softmax; the row group of 16 lanes shares a row.
    float p[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + i0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + j0 + c;
        const bool ok = col < Tk && (!causal || col <= row + off);
        s[r][c] = ok ? s[r][c] * scale : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int sh = 8; sh >= 1; sh >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[r][c] = expf(s[r][c] - m_new);
        sum += p[r][c];
      }
#pragma unroll
      for (int sh = 8; sh >= 1; sh >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, sh);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[r][c] *= alpha;
    }

    __syncthreads();  // every thread is done reading Kᵀ
    float* pt = kt;   // Pᵀ [kBK][kLd]
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(pt + (j0 + c) * kLd + i0) =
          make_float4(p[0][c], p[1][c], p[2][c], p[3][c]);
    __syncthreads();

    // acc[r][c] += sum_j p[i0 + r][j] v[j][d0 + c]
    const int jn = min(kBK, Tk - k0);
    for (int j = 0; j < jn; ++j) {
      const float4 a = ld4(pt + j * kLd + i0);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float bv[CD];
      if constexpr (CD % 4 == 0) {
#pragma unroll
        for (int c = 0; c < CD; c += 4) {
          const float4 x = ld4(vs + j * D + d0 + c);
          bv[c] = x.x; bv[c + 1] = x.y; bv[c + 2] = x.z; bv[c + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < CD; ++c) bv[c] = vs[j * D + d0 + c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + i0 + r;
    if (row >= Tq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* out = o + ((size_t)bh * Tq + row) * D + d0;
#pragma unroll
    for (int c = 0; c < CD; ++c) store(out + c, acc[r][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Tq, int Tk, float scale, int causal,
           cudaStream_t stream) {
  const size_t smem = (size_t)smem_floats(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * Hq, (Tq + kBQ - 1) / kBQ);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Hq, Hkv, Tq, Tk, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int Tq, int Tk, int D, float scale, int causal,
             cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, Hq, Hkv, Tq, Tk, scale, causal, s);
    case 32: return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Tq, Tk, scale, causal, s);
    case 64: return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Tq, Tk, scale, causal, s);
    case 128: return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Tq, Tk, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory, in bytes, that a launch with head dim D needs.
extern "C" int flash_attention_smem_bytes(int D) {
  return smem_floats(D) * (int)sizeof(float);
}

// q, o: [B, Hq, Tq, D]; k, v: [B, Hkv, Tk, D]; all float (bf16 = 0) or all
// __nv_bfloat16 (bf16 = 1), contiguous.  Needs D in {16, 32, 64, 128} and
// Hq % Hkv == 0 (checked by the Python wrapper; another D returns
// cudaErrorInvalidValue).
extern "C" int flash_attention_launch(void* q, void* k, void* v, void* o,
                                      int B, int Hq, int Hkv, int Tq, int Tk,
                                      int D, float scale, int causal, int bf16,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale,
                                   causal, s);
  return launch_d<float>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale, causal, s);
}
