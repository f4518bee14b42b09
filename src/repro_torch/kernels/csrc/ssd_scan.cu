// ssd_scan: the Mamba-2 SSD (state-space duality) chunked scan, hand-written
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_scan` / `_kernel` in
// src/repro/kernels/ssd_scan.py.  It computes what the plain PyTorch version
// `ssd_ref` (src/repro_torch/kernels/ssd_scan.py) computes.  For every
// (batch, head) it walks the T/Q chunks in order with the f32 state
// h [N, P] carried from chunk to chunk:
//
//   l  = cumsum(a * dt)                              (inclusive, per chunk)
//   G  = (C Bᵀ) ⊙ exp(l_i - l_j) ⊙ dt_j,  j <= i      [Q, Q], lower triangle
//   y  = G x + (C ⊙ e^l) h                           [Q, P], written as x's type
//   h <- e^{l_Q} h + (B ⊙ e^{l_Q - l} dt)ᵀ x          [N, P]
//
// Layout: x, y [b, T, H, P]; dt [b, T, H]; A [H]; B, C [b, T, N] (shared by
// the heads), as the model produces them: no transpose around the call.
//
// Grid and block: one CTA of 256 threads per (batch, head); a loop inside the
// block takes the place of the TPU's sequential chunk axis.  One chunk is
// staged in dynamic shared memory as f32; at Q = 128, P = N = 64:
//   x [Q, P] 32 KB, Cᵀ and Bᵀ [N, Q+4] 33 KB each, Gᵀ [Q, Q+4] 66 KB (reused
//   for B ⊙ w once y is written), h [N, P] 16 KB, l, e^l, w, dt 2 KB
// = 186 KB, above the 48 KB default, so the launch sets
// cudaFuncAttributeMaxDynamicSharedMemorySize; one CTA fits on an SM.  Every
// product is a loop of 4 x 4 register tiles fed by float4 loads from shared
// memory, plain CUDA-core f32 FMAs (no wgmma, no TMA).  G is formed for the
// tiles on and below the diagonal only, and y's intra-chunk product stops at
// the diagonal; the y tiles are handed out folded (short rows paired with
// long ones) so the threads of a warp do equal work.
//
// What bounds it on this card, at the serving shape (b=4, T=1024, H=64,
// P=N=64, Q=128): about 70 MB moved (x and y in bf16 as the serving path
// gives them, B, C and dt in f32; 137 MB with x and y in f32), 21-41 µs at
// 3.35 TB/s; about 8.6 GFLOP counting the triangle (12.9 GFLOP for full
// Q x Q blocks), 0.13-0.19 ms at the 67 TFLOP/s f32 rate.  So the kernel,
// which computes in f32, is bound by operations, not bytes.  A later redesign would run the two
// Q x Q products and the state update on the tensor cores (TF32 or bf16
// wgmma), which changes both the bound and the numbers and needs its own
// tolerance.
//
// The kernel allocates nothing and runs on the caller's stream; the C entry
// point returns the first CUDA error of the attribute call or the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch does
}

// acc[r][c] += a[r] * b[c]
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4 a,
                                       const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Shared-memory plan, in floats; every segment starts on a 16-byte boundary
// because P, N and Qp are multiples of 4.
struct Plan {
  int Qp, ldq, xs, ct, bt, g, h, l, el, w, dt, total;
  __host__ __device__ Plan(int Q, int P, int N) {
    Qp = (Q + 3) & ~3;
    ldq = Qp + 4;  // row stride of Cᵀ, Bᵀ, Gᵀ: spreads a column over banks
    const int gsz = Qp * ldq > Qp * N ? Qp * ldq : Qp * N;
    xs = 0;
    ct = xs + Qp * P;
    bt = ct + N * ldq;
    g = bt + N * ldq;
    h = g + gsz;
    l = h + N * P;
    el = l + Qp;
    w = el + Qp;
    dt = w + Qp;
    total = dt + Qp;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, T* __restrict__ y, int Tlen,
                    int H, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  const Plan pl(Q, P, N);
  const int Qp = pl.Qp, ldq = pl.ldq;
  float* xs = smem + pl.xs;   // x chunk          [Qp][P]
  float* ct = smem + pl.ct;   // Cᵀ               [N][ldq]
  float* bt = smem + pl.bt;   // Bᵀ               [N][ldq]
  float* g = smem + pl.g;     // Gᵀ [Qp][ldq], then B ⊙ w [Qp][N]
  float* hs = smem + pl.h;    // state h          [N][P]
  float* lv = smem + pl.l;    // l = cumsum(a dt) [Qp]
  float* el = smem + pl.el;   // e^l              [Qp]
  float* wv = smem + pl.w;    // e^{l_Q - l} dt   [Qp]
  float* dv = smem + pl.dt;   // dt               [Qp]

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int hh = blockIdx.x % H;
  const float a = A[hh];
  const int QB = Qp / 4, PB = P / 4, NB = N / 4;
  const int ntri = QB * (QB + 1) / 2;
  const int half = (QB + 1) / 2;

  for (int i = tid; i < N * P; i += kThreads) hs[i] = 0.0f;

  for (int c0 = 0; c0 < Tlen; c0 += Q) {
    __syncthreads();  // the previous chunk is done with every buffer
    const size_t row0 = (size_t)b * Tlen + c0;  // first (b, t) row of chunk
    for (int i = tid; i < Qp * P; i += kThreads) {
      const int t = i / P, p = i - t * P;
      xs[i] = t < Q ? to_f32(x[((row0 + t) * H + hh) * P + p]) : 0.0f;
    }
    for (int i = tid; i < Qp * N; i += kThreads) {
      const int t = i / N, n = i - t * N;
      const size_t gi = (row0 + t) * N + n;
      bt[n * ldq + t] = t < Q ? Bm[gi] : 0.0f;
      ct[n * ldq + t] = t < Q ? Cm[gi] : 0.0f;
    }
    for (int t = tid; t < Qp; t += kThreads)
      dv[t] = t < Q ? dt[(row0 + t) * H + hh] : 0.0f;
    __syncthreads();

    // inclusive prefix sum of a*dt: one warp, four consecutive steps a lane
    // (Qp <= 128); padded steps have dt = 0 and leave l unchanged.
    if (tid < 32) {
      float v[4];
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = tid * 4 + k;
        s += t < Qp ? a * dv[t] : 0.0f;
        v[k] = s;
      }
      float incl = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      const float excl = incl - s;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = tid * 4 + k;
        if (t < Qp) lv[t] = excl + v[k];
      }
    }
    __syncthreads();
    const float llast = lv[Qp - 1];
    for (int t = tid; t < Qp; t += kThreads) {
      el[t] = expf(lv[t]);
      wv[t] = expf(llast - lv[t]) * dv[t];
    }

    // Gᵀ: the 4 x 4 tiles (ib, jb) with jb <= ib; entries above the diagonal
    // of a diagonal tile are written as 0, the tiles above it not at all.
    for (int t = tid; t < ntri; t += kThreads) {
      int ib = (int)((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
      while ((ib + 1) * (ib + 2) / 2 <= t) ++ib;
      while (ib * (ib + 1) / 2 > t) --ib;
      const int jb = t - ib * (ib + 1) / 2;
      const int i0 = ib * 4, j0 = jb * 4;
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n)
        outer4(acc, ld4(ct + n * ldq + i0), ld4(bt + n * ldq + j0));
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + c;
        float col[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + r;
          col[r] = j <= i ? acc[r][c] * expf(lv[i] - lv[j]) * dv[j] : 0.0f;
        }
        *reinterpret_cast<float4*>(g + j * ldq + i0) =
            make_float4(col[0], col[1], col[2], col[3]);
      }
    }
    __syncthreads();

    // y = G x + e^l ⊙ (C h), tiles of 4 rows x 4 columns.
    for (int t = tid; t < QB * PB; t += kThreads) {
      const int r = t / PB, pb = t - r * PB;
      const int ib = r < half ? r : QB - 1 - (r - half);
      const int i0 = ib * 4, p0 = pb * 4;
      float acc[4][4] = {};
      float inter[4][4] = {};
      for (int j = 0; j < i0 + 4; ++j)
        outer4(acc, ld4(g + j * ldq + i0), ld4(xs + j * P + p0));
      for (int n = 0; n < N; ++n)
        outer4(inter, ld4(ct + n * ldq + i0), ld4(hs + n * P + p0));
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int i = i0 + rr;
        if (i >= Q) continue;
        const float e = el[i];
        T* out = y + ((row0 + i) * H + hh) * P + p0;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          out[c] = from_f32<T>(fmaf(e, inter[rr][c], acc[rr][c]));
      }
    }
    __syncthreads();

    // B ⊙ w, row-major [Qp][N], into the space Gᵀ held.
    for (int i = tid; i < Qp * N; i += kThreads) {
      const int j = i / N, n = i - j * N;
      g[i] = bt[n * ldq + j] * wv[j];
    }
    __syncthreads();

    // h <- e^{l_Q} h + (B ⊙ w)ᵀ x; each thread owns its 4 x 4 tile of h.
    const float eq = expf(llast);
    for (int t = tid; t < NB * PB; t += kThreads) {
      const int nb = t / PB, pb = t - nb * PB;
      const int n0 = nb * 4, p0 = pb * 4;
      float acc[4][4] = {};
      for (int j = 0; j < Qp; ++j)
        outer4(acc, ld4(g + j * N + n0), ld4(xs + j * P + p0));
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float* hp = hs + (n0 + rr) * P + p0 + c;
          *hp = fmaf(eq, *hp, acc[rr][c]);
        }
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, int nb, int Tlen, int H, int P, int N,
           int Q, cudaStream_t stream) {
  const size_t smem = (size_t)Plan(Q, P, N).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T><<<nb * H, kThreads, smem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const float*)B,
      (const float*)C, (T*)y, Tlen, H, P, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory, in bytes, that a launch with these sizes needs.
extern "C" int ssd_scan_smem_bytes(int Q, int P, int N) {
  return Plan(Q, P, N).total * (int)sizeof(float);
}

// x, y: float (x_bf16 = 0) or __nv_bfloat16 (x_bf16 = 1).  Needs
// 1 <= Q <= 128, Tlen % Q == 0, P % 4 == 0 and N % 4 == 0 (checked by the
// Python wrapper).
extern "C" int ssd_scan_launch(void* x, void* dt, void* A, void* B, void* C,
                               void* y, int nb, int Tlen, int H, int P, int N,
                               int Q, int x_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16)
    return launch<__nv_bfloat16>(x, dt, A, B, C, y, nb, Tlen, H, P, N, Q, s);
  return launch<float>(x, dt, A, B, C, y, nb, Tlen, H, P, N, Q, s);
}
