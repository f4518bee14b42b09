// ssd_scan: the Mamba-2 SSD (state-space duality) chunked scan, hand-written
// for Hopper (sm_90a): a bf16 kernel on the tensor cores and an f32 kernel
// on the CUDA cores.
//
// Replaces the Pallas TPU kernel `ssd_scan` / `_kernel` in
// src/repro/kernels/ssd_scan.py.  Both kernels compute what the plain
// PyTorch version `ssd_ref` (src/repro_torch/kernels/ssd_scan.py) computes.
// For every (batch, head) they walk the T/Q chunks in order with the f32
// state h [N, P] carried from chunk to chunk:
//
//   l  = cumsum(a * dt)                              (inclusive, per chunk)
//   G  = (C Bᵀ) ⊙ exp(l_i - l_j) ⊙ dt_j,  j <= i      [Q, Q], lower triangle
//   y  = G x + (C ⊙ e^l) h                           [Q, P], written as x's type
//   h <- e^{l_Q} h + (B ⊙ e^{l_Q - l} dt)ᵀ x          [N, P]
//
// and, when asked, write the h left after the last step (f32 [b, H, N, P]):
// the SSM state a prefill hands to decode.
//
// Layout: x [b, T, H, P] is read through its (b, t, h) strides in elements,
// the last dimension contiguous and every row on 16 bytes, so the model's
// x, a view of a wider [b, T, H·P + 2N] activation, is read in place; y is
// written contiguous [b, T, H, P]; dt [b, T, H]; A [H]; B, C [b, T, N]
// (shared by the heads), contiguous f32.
//
// What bounds it on this card, at the serving shape (b=4, T=1024, H=64,
// P=N=64, Q=128): x and y in bf16 are 67.1 MB and dt, A, B, C in f32 3.1 MB,
// 70.3 MB in all, 0.0210 ms at 3.35 TB/s; the products are 8.62 GFLOP
// counting the triangle, 0.0087 ms at the 989 TFLOP/s bf16 tensor rate.  So
// the bf16 path is bound by bytes: it has to run its products on the tensor
// cores, fill the card in one wave and keep x's loads in flight.  The f32
// path (137 MB, 0.041 ms; 0.129 ms at the 67 TFLOP/s f32 rate) computes on
// the CUDA cores and is bound by operations.
//
// bf16 kernel (`ssd_wgmma`): one CTA of 2 warpgroups per (batch, head); a
// loop inside the CTA walks the chunks in order.  A chunk is a tile of 128
// rows (rows past Q zero-filled, dt = 0: identity steps); warpgroup w owns
// rows 64w..64w+63.
//   - y = e^l ⊙ (C h): `wgmma` m64nPk16, C (K-major) against a bf16 copy of
//     h in shared memory (the MN-major B operand), scaled by e^{l_i} per row
//     in y's f32 accumulator.
//   - Then, for each 64-column block of the chunk at or below the
//     warpgroup's rows (one block for the first warpgroup, two for the
//     second): S = C Bᵀ by m64n64k16 from shared memory (both K-major);
//     G = S ⊙ 2^{l2_i - l2_j} ⊙ dt_j (l2 = l·log2 e, `ex2.approx`) formed in
//     S's accumulator registers and rounded to bf16 in place as the register
//     A operand of y += G x, x being the MN-major B operand.  One block at a
//     time keeps S, G's fragments and y's accumulator in registers together.
//   - y leaves through a per-warp staging tile as 16-byte row stores.
//   - h stays in f32 registers across all chunks, warpgroup w holding
//     columns w·P/2..: h <- e^{l_Q} h + (B ⊙ w)ᵀ x by m64n(P/2)k16, with
//     (B ⊙ w)ᵀ built as a register A operand (bf16) from B's tile.  After
//     each chunk each warpgroup writes its half of the bf16 copy of h.
//   - x goes through a 2-stage `cp.async` ring (chunk c+1 loads while chunk
//     c computes), zero-filled past Q and P; B and C arrive as f32 (L2 hits:
//     every head of a batch reads them, and the next chunk's lines are
//     prefetched into L2) and are rounded to bf16 on the way into shared
//     memory through registers.  A proxy fence makes the generic writes
//     visible to wgmma, which reads shared memory through the async proxy.
//   - Tiles are stored in wgmma's canonical swizzled layout: column blocks
//     of W elements whose 16-byte chunks are XOR-swizzled (W = N for C and
//     B, P/2 for x and h, so each warpgroup's half of h is one block).
//   - Shared memory at P = N = 64: x 2 x 16 KB, B and C 16 KB each, h 8 KB,
//     y staging 16 KB, l, e^l, w, dt 2 KB, 1 KB of alignment = 91 KB.  At
//     128 registers a thread 2 CTAs fit on an SM, so the 256 CTAs of the
//     serving shape run in one wave on 132 SMs.  What pushes a thread past
//     128 registers is addresses the compiler would hoist out of the chunk
//     loop; `fresh` keeps them inside it.
//   N and P are padded to the tile (N to 16, 32 or 64, P to 32 or 64) with
//   zeros; the wrapper refuses P, N > 64 and P not a multiple of 8.
//
// f32 kernel (`ssd_f32`): one CTA of 256 threads per (batch, head); the
// chunk's x, Cᵀ, Bᵀ, Gᵀ and h staged in f32 in dynamic shared memory
// (186 KB at Q = 128, P = N = 64, one CTA per SM); 4 x 4 register tiles of
// plain f32 FMAs, G formed on and below the diagonal only, `expf`.  It keeps
// the 1e-4 checks, which bf16 products cannot meet.
//
// The kernels allocate nothing and run on the caller's stream; the C entry
// point returns the first CUDA error of the attribute call or the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// Strides in elements of x's b, t and h dimensions.
struct XStrides {
  long long b, t, h;
};

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;

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

__global__ void __launch_bounds__(kThreads)
    ssd_f32(const float* __restrict__ x, XStrides xst,
            const float* __restrict__ dt, const float* __restrict__ A,
            const float* __restrict__ Bm, const float* __restrict__ Cm,
            float* __restrict__ y, float* __restrict__ hT, int Tlen, int H,
            int P, int N, int Q) {
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
  const float* xb = x + b * xst.b + hh * xst.h;
  const int QB = Qp / 4, PB = P / 4, NB = N / 4;
  const int ntri = QB * (QB + 1) / 2;
  const int half = (QB + 1) / 2;

  for (int i = tid; i < N * P; i += kThreads) hs[i] = 0.0f;

  for (int c0 = 0; c0 < Tlen; c0 += Q) {
    __syncthreads();  // the previous chunk is done with every buffer
    const size_t row0 = (size_t)b * Tlen + c0;  // first (b, t) row of chunk
    for (int i = tid; i < Qp * P; i += kThreads) {
      const int t = i / P, p = i - t * P;
      xs[i] = t < Q ? xb[(c0 + t) * xst.t + p] : 0.0f;
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
        float* out = y + ((row0 + i) * H + hh) * P + p0;
#pragma unroll
        for (int c = 0; c < 4; ++c) out[c] = fmaf(e, inter[rr][c], acc[rr][c]);
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
  if (hT) {
    __syncthreads();
    float* out = hT + (size_t)blockIdx.x * N * P;
    for (int i = tid; i < N * P; i += kThreads) out[i] = hs[i];
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma)
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 256;  // 2 warpgroups
constexpr int kQT = 128;         // rows of a chunk tile, 64 per warpgroup

// Shared-memory plan in bytes, after aligning the base to 1024 (every
// segment is a multiple of 1024 bytes, so each tile starts on its swizzle's
// period).
template <int NP, int PP>
struct WgPlan {
  static constexpr int x = 0;                        // 2 stages [kQT][PP]
  static constexpr int b = x + 2 * kQT * PP * 2;     // B [kQT][NP]
  static constexpr int c = b + kQT * NP * 2;         // C [kQT][NP]
  static constexpr int h = c + kQT * NP * 2;         // h [NP][PP]
  static constexpr int y = h + NP * PP * 2;          // y staging [kQT][PP]
  static constexpr int l2 = y + kQT * PP * 2;        // f32 [kQT] each:
  static constexpr int el = l2 + kQT * 4;            //   l·log2 e, e^l,
  static constexpr int w = el + kQT * 4;             //   e^{l_Q - l} dt,
  static constexpr int dt = w + kQT * 4;             //   dt
  static constexpr int bytes = dt + kQT * 4 + 1024;  // + alignment slack
};

// d (+)= A·B for m64nNk16 from shared memory, B MN-major.
template <int N>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[N / 2], uint64_t da,
                                           uint64_t db, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64<1>(d, da, db, scale_d);
  else wgmma_ss_n32<1>(d, da, db, scale_d);
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// v, opaque to the compiler where this is called: the addresses derived from
// it are formed next to their use inside the chunk loop, not hoisted out of
// it, where they would hold registers (and spill) across the whole loop.
__device__ __forceinline__ int fresh(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

// y for the 64 chunk rows rw.. of one warpgroup, whose rows see the first
// NC columns of the chunk: y = e^l ⊙ (C h) + G x with G = (C Bᵀ) ⊙ decay ⊙ dt
// formed in registers one 64-column block at a time (so S, G's fragments
// and y's accumulator fit in registers together), stored to y's rows < Q.
template <int NP, int PP, int NC>
__device__ __forceinline__ void chunk_rows(
    const bf16* sc, const bf16* sb, const bf16* sh, const bf16* sxs,
    bf16* sy, const float* l2s, const float* els, const float* dts, int rw,
    bool has_h, bf16* __restrict__ y, size_t row0, int H, int hh, int P,
    int Q) {
  using TN = Tile<NP>;
  using TX = Tile<PP / 2>;
  constexpr int WX = PP / 2;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const uint32_t sbo_n = 8 * TN::RB, sbo_x = 8 * TX::RB;
  const int r_lo = rw + warp * 16 + g, r_hi = r_lo + 8;

  // y = e^l ⊙ (C h): C against the bf16 copy of h, NP / 16 k-steps.
  float acc[PP / 2];
  if (has_h) {
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < NP / 16; ++ks)
      wgmma_ss_t<PP>(
          acc, gmma_desc(sc + rw * NP + ks * 16, 16, sbo_n, TN::kMode),
          gmma_desc(sh + ks * 16 * WX, NP * TX::RB, sbo_x, TX::kMode), ks > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    const float e_lo = els[r_lo], e_hi = els[r_hi];
#pragma unroll
    for (int i = 0; i < PP / 2; ++i) acc[i] *= (i & 2) ? e_hi : e_lo;
  } else {
#pragma unroll
    for (int i = 0; i < PP / 2; ++i) acc[i] = 0.f;
  }

  const float l_lo = l2s[r_lo], l_hi = l2s[r_hi];
#pragma unroll
  for (int kb = 0; kb < NC / 64; ++kb) {
    // S = C Bᵀ for columns kb·64.. of the chunk, NP / 16 k-steps.
    float s[32];
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < NP / 16; ++ks)
      wgmma_ss_n64<0>(s,
                      gmma_desc(sc + rw * NP + ks * 16, 16, sbo_n, TN::kMode),
                      gmma_desc(sb + kb * 64 * NP + ks * 16, 16, sbo_n,
                                TN::kMode),
                      ks > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // G = S ⊙ 2^{l2_i - l2_j} ⊙ dt_j on and below the diagonal, as bf16 A
    // fragments: this thread's rows r_lo, r_hi, columns 2·t4 (+1, +8, +9)
    // of each 16-column k-step.
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = kb * 64 + nt * 8 + 2 * t4 + e;
        const float lc = l2s[col], dc = dts[col];
        s[nt * 4 + e] =
            col <= r_lo ? s[nt * 4 + e] * ex2(l_lo - lc) * dc : 0.f;
        s[nt * 4 + 2 + e] =
            col <= r_hi ? s[nt * 4 + 2 + e] * ex2(l_hi - lc) * dc : 0.f;
      }
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // y += G x over these 64 rows of x.
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<PP>(acc, a[kk],
                   gmma_desc(sxs + (kb * 64 + kk * 16) * WX, kQT * TX::RB,
                             sbo_x, TX::kMode));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
  }

  // y through this warp's own 16 rows of the staging tile (16-byte chunks
  // XOR-swizzled by row, so the pair writes hit distinct banks), then
  // 16-byte stores of whole rows.
  constexpr int CPY = PP / 8;
  auto yoff = [](int r, int c) {
    return r * PP + ((c ^ (r & (CPY - 1))) << 3);
  };
#pragma unroll
  for (int nt = 0; nt < PP / 8; ++nt)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<uint32_t*>(sy + yoff(half ? r_hi : r_lo, nt) +
                                   2 * t4) =
          pack_bf16(acc[nt * 4 + 2 * half], acc[nt * 4 + 2 * half + 1]);
  __syncwarp();
  const int wr = rw + warp * 16;
#pragma unroll
  for (int it = 0; it < 16 * CPY / 32; ++it) {
    const int i = it * 32 + lane;
    const int r = wr + i / CPY, c = i % CPY;
    if (r < Q && c * 8 < P)
      *reinterpret_cast<uint4*>(y + ((row0 + r) * H + hh) * P + c * 8) =
          *reinterpret_cast<const uint4*>(sy + yoff(r, c));
  }
}

template <int NP, int PP>
__global__ void __launch_bounds__(kWgThreads, 2)
    ssd_wgmma(const bf16* __restrict__ x, XStrides xst,
              const float* __restrict__ dt, const float* __restrict__ A,
              const float* __restrict__ Bm, const float* __restrict__ Cm,
              bf16* __restrict__ y, float* __restrict__ hT, int Tlen, int H,
              int P, int N, int Q) {
  using L = WgPlan<NP, PP>;
  using TN = Tile<NP>;
  using TX = Tile<PP / 2>;
  constexpr int WX = PP / 2;
  // the tiles start on 1024 bytes; an offset from smem_raw (not an integer
  // round trip) keeps the pointers known as shared-memory ones.
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* sx = reinterpret_cast<bf16*>(base + L::x);
  bf16* sb = reinterpret_cast<bf16*>(base + L::b);
  bf16* sc = reinterpret_cast<bf16*>(base + L::c);
  bf16* sh = reinterpret_cast<bf16*>(base + L::h);
  bf16* sy = reinterpret_cast<bf16*>(base + L::y);
  float* l2s = reinterpret_cast<float*>(base + L::l2);
  float* els = reinterpret_cast<float*>(base + L::el);
  float* ws = reinterpret_cast<float*>(base + L::w);
  float* dts = reinterpret_cast<float*>(base + L::dt);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / H, hh = blockIdx.x % H;
  const float a = A[hh];
  const bf16* xb = x + b * xst.b + hh * xst.h;
  const int nchunks = Tlen / Q;
  const uint32_t sbo_x = 8 * TX::RB;

  // x rows [c·Q, c·Q + Q) into stage s; rows past Q, columns past P zero.
  auto load_x = [&](int s, int c) {
    constexpr int CH = PP / 8, kCopies = kQT * CH;
    bf16* dst = sx + s * kQT * PP;
    const int t = fresh(tid);
#pragma unroll
    for (int it = 0; it < kCopies / kWgThreads; ++it) {
      const int i = it * kWgThreads + t;
      const int r = i / CH, ch = i % CH;
      const bool ok = r < Q && ch * 8 < P;
      cp_async16(dst + TX::off(kQT, r, ch),
                 ok ? xb + (long long)(c * Q + r) * xst.t + ch * 8 : xb, ok);
    }
  };

  // This warpgroup's columns wg·WX.. of h, rows m_lo, m_lo + 8 (f32, all
  // chunks long).
  float hacc[WX / 2];
#pragma unroll
  for (int i = 0; i < WX / 2; ++i) hacc[i] = 0.f;
  const int m_lo = warp * 16 + g, m_hi = m_lo + 8;

  load_x(0, 0);
  cp_async_commit();

  for (int c = 0; c < nchunks; ++c) {
    const size_t row0 = (size_t)b * Tlen + (size_t)c * Q;
    const bf16* sxs = sx + (c & 1) * kQT * PP;
    __syncthreads();  // chunk c-1 is done with B, C, h and its x stage
    if (c + 1 < nchunks) load_x((c + 1) & 1, c + 1);
    cp_async_commit();

    // l, e^l, w and dt of the chunk: one warp, four consecutive rows a lane.
    if (tid < 32) {
      float d[4], v[4];
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = tid * 4 + k;
        d[k] = t < Q ? dt[(row0 + t) * H + hh] : 0.f;
        s += a * d[k];
        v[k] = s;
      }
      float incl = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      const float excl = incl - s;
      const float total = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = tid * 4 + k;
        const float l = excl + v[k];
        l2s[t] = l * kLog2e;
        els[t] = ex2(l * kLog2e);
        ws[t] = ex2((total - l) * kLog2e) * d[k];
        dts[t] = d[k];
      }
    }

    // B and C: f32 rows → bf16 tiles, zero past Q and N; loads first, so
    // all of them are in flight together.
    {
      constexpr int C4 = NP / 4, kIt = kQT * C4 / kWgThreads;
      const int t = fresh(tid);
      float4 vb[kIt], vc[kIt];
#pragma unroll
      for (int it = 0; it < kIt; ++it) {
        const int i = it * kWgThreads + t;
        const int r = i / C4, q = i % C4;
        const bool ok = r < Q && q * 4 < N;
        const size_t gi = (row0 + r) * N + q * 4;
        vb[it] = ok ? ld4(Bm + gi) : make_float4(0.f, 0.f, 0.f, 0.f);
        vc[it] = ok ? ld4(Cm + gi) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int it = 0; it < kIt; ++it) {
        const int i = it * kWgThreads + t;
        const int r = i / C4, q = i % C4;
        const int o = TN::off(kQT, r, q >> 1) + (q & 1) * 4;
        *reinterpret_cast<uint2*>(sb + o) = make_uint2(
            pack_bf16(vb[it].x, vb[it].y), pack_bf16(vb[it].z, vb[it].w));
        *reinterpret_cast<uint2*>(sc + o) = make_uint2(
            pack_bf16(vc[it].x, vc[it].y), pack_bf16(vc[it].z, vc[it].w));
      }
    }
    if (c + 1 < nchunks) {  // the next chunk's B and C lines into L2
      const size_t nxt = (row0 + Q) * N;
      for (int i = tid * 32; i < Q * N; i += kWgThreads * 32) {
        prefetch_l2(Bm + nxt + i);
        prefetch_l2(Cm + nxt + i);
      }
    }
    cp_async_wait<1>();  // this thread's copies of chunk c have landed
    fence_async_shared();
    __syncthreads();

    const int rw = wg * 64;
    if (rw < Q) {
      if (wg == 0)
        chunk_rows<NP, PP, 64>(sc, sb, sh, sxs, sy, l2s, els, dts, rw,
                               c > 0, y, row0, H, hh, P, Q);
      else
        chunk_rows<NP, PP, 128>(sc, sb, sh, sxs, sy, l2s, els, dts, rw,
                                c > 0, y, row0, H, hh, P, Q);
    }
    __syncthreads();  // every C·h of this chunk has read the bf16 h

    // h <- e^{l_Q} h + (B ⊙ w)ᵀ x for this warpgroup's columns; (B ⊙ w)ᵀ
    // [n, j] as bf16 A fragments, rows m_lo, m_hi, columns j of each k-step.
    // B[j][n] sits at row j, chunk n / 8 of B's tile, whose swizzle
    // depends on j only through j % 8 = 2·t4 (+1): one offset per (row,
    // column pair), the k-steps at fixed distances from it.
    uint32_t af[kQT / 16][4];
    {
      int bo[2][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = fresh(mi ? m_hi : m_lo), j = 2 * t4 + e;
          bo[mi][e] = m < NP ? TN::off(kQT, j, m >> 3) + (m & 7) : -1;
        }
#pragma unroll
      for (int kk = 0; kk < kQT / 16; ++kk) {
        float v[2][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e = q & 1, dj = kk * 16 + (q >> 1) * 8;
          const float wj = ws[dj + 2 * t4 + e];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            v[mi][q] = bo[mi][e] >= 0
                ? __bfloat162float(sb[bo[mi][e] + dj * NP]) * wj
                : 0.f;
        }
        af[kk][0] = pack_bf16(v[0][0], v[0][1]);
        af[kk][1] = pack_bf16(v[1][0], v[1][1]);
        af[kk][2] = pack_bf16(v[0][2], v[0][3]);
        af[kk][3] = pack_bf16(v[1][2], v[1][3]);
      }
    }
    const float eq = els[kQT - 1];
#pragma unroll
    for (int i = 0; i < WX / 2; ++i) hacc[i] *= eq;
    fence_regs(hacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQT / 16; ++kk)
      wgmma_rs<WX>(hacc, af[kk],
                   gmma_desc(sxs + wg * kQT * WX + kk * 16 * WX, kQT * TX::RB,
                             sbo_x, TX::kMode));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(hacc);

    // this warpgroup's half of the bf16 copy of h (column block wg).
#pragma unroll
    for (int nt = 0; nt < WX / 8; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = half ? m_hi : m_lo;
        const int col = wg * WX + nt * 8 + 2 * t4;
        if (m < NP)
          *reinterpret_cast<uint32_t*>(sh + TX::off(NP, m, col >> 3) +
                                       (col & 7)) =
              pack_bf16(hacc[nt * 4 + 2 * half], hacc[nt * 4 + 2 * half + 1]);
      }
  }

  if (hT) {
    float* out = hT + (size_t)blockIdx.x * N * P;
#pragma unroll
    for (int nt = 0; nt < WX / 8; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = half ? m_hi : m_lo;
        const int col = wg * WX + nt * 8 + 2 * t4;
        if (m < N && col < P)
          *reinterpret_cast<float2*>(out + m * P + col) = make_float2(
              hacc[nt * 4 + 2 * half], hacc[nt * 4 + 2 * half + 1]);
      }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

int launch_f32(const void* x, XStrides xst, const void* dt, const void* A,
               const void* B, const void* C, void* y, void* hT, int nb,
               int Tlen, int H, int P, int N, int Q, cudaStream_t stream) {
  const size_t smem = (size_t)Plan(Q, P, N).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_f32<<<nb * H, kThreads, smem, stream>>>(
      (const float*)x, xst, (const float*)dt, (const float*)A,
      (const float*)B, (const float*)C, (float*)y, (float*)hT, Tlen, H, P, N,
      Q);
  return (int)cudaGetLastError();
}

template <int NP, int PP>
int launch_wgmma(const void* x, XStrides xst, const void* dt, const void* A,
                 const void* B, const void* C, void* y, void* hT, int nb,
                 int Tlen, int H, int P, int N, int Q, cudaStream_t stream) {
  const int smem = WgPlan<NP, PP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_wgmma<NP, PP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_wgmma<NP, PP><<<nb * H, kWgThreads, smem, stream>>>(
      (const bf16*)x, xst, (const float*)dt, (const float*)A,
      (const float*)B, (const float*)C, (bf16*)y, (float*)hT, Tlen, H, P, N,
      Q);
  return (int)cudaGetLastError();
}

// The padded tile sizes of the bf16 kernel: N to 16, 32 or 64, P to 32 or
// 64; 0 when N or P is above 64.
int pad_n(int N) { return N <= 16 ? 16 : N <= 32 ? 32 : N <= 64 ? 64 : 0; }
int pad_p(int P) { return P <= 32 ? 32 : P <= 64 ? 64 : 0; }

// fn<NP, PP> ARGS for the padded sizes of N and P.
#define SSD_DISPATCH(fn, ARGS)                          \
  switch (pad_n(N) * 1000 + pad_p(P)) {                 \
    case 16032: return fn<16, 32> ARGS;                 \
    case 16064: return fn<16, 64> ARGS;                 \
    case 32032: return fn<32, 32> ARGS;                 \
    case 32064: return fn<32, 64> ARGS;                 \
    case 64032: return fn<64, 32> ARGS;                 \
    case 64064: return fn<64, 64> ARGS;                 \
    default: return -1;                                 \
  }

template <int NP, int PP>
int wg_smem() { return WgPlan<NP, PP>::bytes; }

template <int NP, int PP>
int wg_occupancy() {
  const int smem = WgPlan<NP, PP>::bytes;
  if (cudaFuncSetAttribute(ssd_wgmma<NP, PP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  int n = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssd_wgmma<NP, PP>,
                                                    kWgThreads, smem) !=
      cudaSuccess)
    return -1;
  return n;
}

}  // namespace

// Dynamic shared memory, in bytes, that a launch with these sizes needs;
// -1 when the bf16 kernel does not take them (N or P above 64).
extern "C" int ssd_scan_smem_bytes(int Q, int P, int N, int x_bf16) {
  if (!x_bf16) return Plan(Q, P, N).total * (int)sizeof(float);
  SSD_DISPATCH(wg_smem, ())
}

// CTAs of the kernel that fit on one SM at these sizes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); -1 on error.
extern "C" int ssd_scan_ctas_per_sm(int Q, int P, int N, int x_bf16) {
  if (x_bf16) {
    SSD_DISPATCH(wg_occupancy, ())
  }
  const int smem = Plan(Q, P, N).total * (int)sizeof(float);
  if (cudaFuncSetAttribute(ssd_f32,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return -1;
  int n = -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssd_f32, kThreads,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}

// x: float (x_bf16 = 0) or __nv_bfloat16 (x_bf16 = 1), read through
// xstrides = its (b, t, h) strides in elements (last dimension contiguous,
// rows on 16 bytes); y: x's type, contiguous [nb, Tlen, H, P]; hT: f32
// [nb, H, N, P] or null.  Needs 1 <= Q <= 128, Tlen % Q == 0, P % 4 == 0 and
// N % 4 == 0, and for bf16 P % 8 == 0 and P, N <= 64 (checked by the Python
// wrapper; other sizes return cudaErrorInvalidValue).
extern "C" int ssd_scan_launch(void* x, void* dt, void* A, void* B, void* C,
                               void* y, void* hT, int nb, int Tlen, int H,
                               int P, int N, int Q,
                               const long long* xstrides, int x_bf16,
                               void* stream) {
  const XStrides xst = {xstrides[0], xstrides[1], xstrides[2]};
  cudaStream_t s = (cudaStream_t)stream;
  if (!x_bf16)
    return launch_f32(x, xst, dt, A, B, C, y, hT, nb, Tlen, H, P, N, Q, s);
  if (P % 8 || !pad_n(N) || !pad_p(P)) return (int)cudaErrorInvalidValue;
  SSD_DISPATCH(launch_wgmma,
               (x, xst, dt, A, B, C, y, hT, nb, Tlen, H, P, N, Q, s))
}
