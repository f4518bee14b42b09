// flash_attention: GQA forward attention with an online softmax, hand-written
// for Hopper (sm_90a): a bf16 kernel on the tensor cores and an f32 kernel
// on the CUDA cores.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_kernel` in
// src/repro/kernels/flash_attention.py.  Both kernels compute what the plain
// PyTorch version `attention_ref` (src/repro_torch/kernels/flash_attention.py)
// computes, for q [B, Hq, Tq, D] and k, v [B, Hkv, Tk, D]:
//
//   S = (q kᵀ) · D^-½ in f32;  causal: row i sees columns <= i + (Tk - Tq)
//   o = softmax(S) v, written in q's type
//
// Query head h reads KV head h / (Hq / Hkv); K and V are never repeated in
// memory.  The causal mask is aligned bottom-right, as the JAX package's
// oracle `ref.attention_ref` aligns it (its Pallas kernel aligns top-left;
// the two agree when Tq == Tk, the teacher-forced case).  Masked scores are
// -1e30, not -inf, so the running-max update never sees -inf - -inf.  The
// ragged edges are masked, not padded: rows >= Tq are neither read nor
// written, and columns >= Tk never read.
//
// Layout: q, k, v and o are read and written through their own strides (in
// elements) for B, H and T; the last dimension is contiguous.  So the
// model's [B, T, H, D] activations, seen as [B, H, T, D] by a transpose, are
// read in place and o comes back in the same layout.  Every row must start
// on 16 bytes (the wrapper checks the base and the strides).
//
// Grid: one CTA per (b·Hq, query block); a loop over the KV blocks inside
// the CTA takes the place of the TPU's sequential grid axis, with the running
// max m, normalizer l and the accumulator in f32 registers.  Under the causal
// mask the loop stops at the last block the block's last row can see, and
// the query blocks are launched longest first (blockIdx.y counts down the
// rows), so the short ones fill the tail.
//
// What bounds it on this card, at llama3.2-3b's shape (B=4, Hq=24, Hkv=8,
// T=2048, D=128, bf16): the two products are 2·2·T²·D flops per (b, h),
// halved by the mask, 103 GFLOP: 0.104 ms at the 989 TFLOP/s bf16 tensor
// rate; q, k, v and o are 134 MB, 0.040 ms at 3.35 TB/s.  So operations
// bound it, and the products have to run on the tensor cores.
//
// bf16 kernel (`flash_wgmma`), FlashAttention-2's loop on Hopper's
// warpgroup products: 256 threads = 2 warpgroups, 128 query rows per CTA
// (64 per warpgroup), KV blocks of 64.
//   - Both products are `wgmma.mma_async` bf16 × bf16 → f32: S = Q Kᵀ as
//     m64n64k16 with Q and K read from shared memory (both K-major), o += P V
//     as m64nDk16 with P from registers and V read from shared memory as the
//     MN-major (transposed) B operand.  No `ldmatrix`, no transposed copy.
//   - P never leaves registers: wgmma's accumulator fragment of S, after
//     the softmax update, is rounded to bf16 and is the register A operand
//     of P·V.  l is summed from the f32 P; only the P·V operand is rounded.
//   - Softmax in exp2: scale·log2(e) is folded into S once, and 2^x is the
//     SFU's `ex2.approx`.  The mask is applied only on the diagonal and
//     ragged blocks.
//   - K and V go through a ring of two stages filled by `cp.async.cg`
//     16-byte copies: block j+1 loads while block j computes.  Q is loaded
//     once.  Rows past Tq or Tk are zero-filled by the copy itself.  A proxy
//     fence makes the copies visible to wgmma, which reads shared memory
//     through the async proxy.
//   - Shared memory holds Q [128][D] and two stages of K, V [64][D] in bf16
//     (96 KB at D = 128, so two CTAs, four warpgroups, share an SM and one
//     computes while another waits), each tile in wgmma's canonical layout:
//     column blocks of min(D, 64) elements whose 16-byte chunks are XOR-
//     swizzled (128-, 64- or 32-byte swizzle), so the copies and wgmma's
//     reads fall in distinct banks.
//   - Two CTAs per SM cap a thread at 128 registers: at D = 128 the
//     accumulator o (64), S (32) and the descriptors leave ~120 B of spills.
//     One CTA per SM without spills was slower (PERF.md).  D = 160 runs one
//     CTA per SM (its tiles take 121 KB) with up to 255 registers a thread,
//     and its P·V as five m64n32k16 products, one per 32-column block of V.
//   - o is normalized in registers, staged through the warp's own rows of
//     Q's tile and written as 16-byte stores.
//
// f32 kernel (`flash_f32`): one 256-thread CTA per (b·Hq, 64-row query
// block); Qᵀ, Kᵀ (reused for Pᵀ) and V staged in f32 in 100 KB of shared
// memory at D = 128 (125 KB at D = 160: one CTA per SM); 4 x 4 register
// tiles of plain f32 FMAs (4 x D/16 for o); `expf`.  It keeps the
// checks at 2e-5, which bf16 tensor-core products cannot meet; f32 is off
// the main path.
//
// The kernels allocate nothing and run on the caller's stream; the C entry
// point returns the first CUDA error of the attribute call or the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Strides in elements of one tensor's B, H and T dimensions.
struct Strides {
  long long b, h, t;
};
struct Layout {
  Strides q, k, v, o;
};

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBQ = 64;         // query rows per CTA
constexpr int kBK = 64;         // key columns per loop step
constexpr int kLd = kBQ + 4;    // row stride of Qᵀ, Kᵀ and Pᵀ (kBQ == kBK)

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Shared-memory plan, in floats: Qᵀ, then Kᵀ (reused for Pᵀ), then V.
__host__ __device__ constexpr int kt_offset(int D) { return D * kLd; }
__host__ __device__ constexpr int v_offset(int D) {
  return kt_offset(D) + (D > kBK ? D : kBK) * kLd;
}
__host__ __device__ constexpr int smem_floats(int D) {
  return v_offset(D) + kBK * D;
}

// rows [r0, r0 + 64) of a [len, D] matrix with row stride st into dst[d][r]
// (transposed), zero past len.  Thread t moves row t % 64, four columns at a
// time.
template <int D>
__device__ __forceinline__ void load_transposed(float* dst, const float* src,
                                                long long st, int r0,
                                                int len) {
  for (int i = threadIdx.x; i < kBQ * (D / 4); i += kThreads) {
    const int r = i % kBQ, d = (i / kBQ) * 4;
    const float4 x = r0 + r < len ? ld4(src + (r0 + r) * st + d)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[(d + 0) * kLd + r] = x.x;
    dst[(d + 1) * kLd + r] = x.y;
    dst[(d + 2) * kLd + r] = x.z;
    dst[(d + 3) * kLd + r] = x.w;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, Layout L,
              int Hq, int Hkv, int Tq, int Tk, float scale, int causal) {
  constexpr int CD = D / 16;  // o columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                  // Qᵀ [D][kLd]
  float* kt = smem + kt_offset(D);   // Kᵀ [D][kLd], then Pᵀ [kBK][kLd]
  float* vs = smem + v_offset(D);    // V  [kBK][D]

  const int tid = threadIdx.x;
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  const int nqb = gridDim.y;
  const int q0 = (causal ? nqb - 1 - (int)blockIdx.y : (int)blockIdx.y) * kBQ;
  const int off = Tk - Tq;           // bottom-right alignment of the mask
  const float* qb = q + b * L.q.b + h * L.q.h;
  const float* kb = k + b * L.k.b + hk * L.k.h;
  const float* vb = v + b * L.v.b + hk * L.v.h;

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

  load_transposed<D>(qt, qb, L.q.t, q0, Tq);

  for (int kbi = 0; kbi < nkb; ++kbi) {
    const int k0 = kbi * kBK;
    __syncthreads();  // the previous step is done with Pᵀ and V
    load_transposed<D>(kt, kb, L.k.t, k0, Tk);
    for (int i = tid; i < kBK * (D / 4); i += kThreads) {
      const int r = i / (D / 4), d = (i % (D / 4)) * 4;
      const float4 x = k0 + r < Tk ? ld4(vb + (k0 + r) * L.v.t + d)
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

  float* ob = o + b * L.o.b + h * L.o.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + i0 + r;
    if (row >= Tq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < CD; ++c) ob[row * L.o.t + d0 + c] = acc[r][c] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma)
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 256;   // 2 warpgroups
constexpr int kWBQ = 128;         // query rows per CTA, 64 per warpgroup
constexpr int kWBK = 64;          // key columns per loop step
constexpr int kStages = 2;        // K/V ring depth

// A [R][D] tile is D / W column blocks of [R][W]: W = D below 64, else 64
// where 64 divides D, else 32.  D = 160 (stablelm-12b) takes W = 32: five
// column blocks under the 64-byte swizzle, the layout D = 32 already uses,
// rather than padding D to 192 with zero columns, which would load and
// multiply 20 % more and need a masked store.
template <int D>
using TileD = Tile<(D < 64 ? D : D % 64 ? 32 : 64)>;

// CTAs per SM a launch bound asks for: two where they fit in shared memory
// (D <= 128), one at D = 160, whose 121 KB of tiles fill the SM alone; the
// bound then leaves a thread 255 registers instead of 128, room for the
// accumulator o (80 at D = 160) and S (32) without spills.
__host__ __device__ constexpr int wg_ctas(int D) { return D > 128 ? 1 : 2; }

__host__ __device__ constexpr int wg_smem_bytes(int D) {
  // Q, the K/V ring, and 1 KB to align the tiles to the swizzle's 1024 B.
  return (kWBQ + 2 * kStages * kWBK) * D * (int)sizeof(bf16) + 1024;
}

// Rows [r0, r0 + R) of a [len, D] matrix with row stride st into a tile by
// cp.async; rows past len are zero-filled.
template <int D, int R>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long st, int r0, int len) {
  constexpr int kChunks = D / 8, kCopies = R * kChunks;
#pragma unroll
  for (int it = 0; it < (kCopies + kWgThreads - 1) / kWgThreads; ++it) {
    const int i = it * kWgThreads + threadIdx.x;
    if (kCopies % kWgThreads && i >= kCopies) break;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r0 + r < len;
    cp_async16(dst + TileD<D>::off(R, r, c),
               ok ? src + (r0 + r) * st + c * 8 : src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, wg_ctas(D))
    flash_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, Layout L,
                int Hq, int Hkv, int Tq, int Tk, float scale_log2,
                int causal) {
  using TL = TileD<D>;
  constexpr int W = TL::W, RB = TL::RB;
  constexpr int NT = kWBK / 8;   // 8-column tiles of S
  constexpr int DT = D / 8;      // 8-column tiles of o
  extern __shared__ unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  bf16* sk = sq + kWBQ * D;                       // K [kStages][kWBK][D]
  bf16* sv = sk + kStages * kWBK * D;             // V [kStages][kWBK][D]

  const int wg = threadIdx.x >> 7;                // warpgroup: rows wg*64..
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  const int nqb = gridDim.y;
  const int q0 = (causal ? nqb - 1 - (int)blockIdx.y : (int)blockIdx.y) * kWBQ;
  const int off = Tk - Tq;           // bottom-right alignment of the mask
  const bf16* qb = q + b * L.q.b + h * L.q.h;
  const bf16* kb = k + b * L.k.b + hk * L.k.h;
  const bf16* vb = v + b * L.v.b + hk * L.v.h;

  int nkb = (Tk + kWBK - 1) / kWBK;
  if (causal) {
    const int last_col = min(q0 + kWBQ, Tq) - 1 + off;
    nkb = last_col < 0 ? 0 : min(nkb, last_col / kWBK + 1);
  }

  // group 0: Q and the first K/V block.
  load_tile<D, kWBQ>(sq, qb, L.q.t, q0, Tq);
  if (nkb > 0) {
    load_tile<D, kWBK>(sk, kb, L.k.t, 0, Tk);
    load_tile<D, kWBK>(sv, vb, L.v.t, 0, Tk);
  }
  cp_async_commit();

  // This thread's rows: wg*64 + warp*16 + g + 8*half (statistic `half`);
  // its columns of each 8-wide tile: 2*t4, +1.
  const int wr = wg * 64 + warp * 16;
  const int g = lane >> 2, t4 = lane & 3;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // Q's descriptor for this warpgroup's 64 rows; K-major, LBO unused.
  const uint32_t sbo = 8 * RB;
  for (int j = 0; j < nkb; ++j) {
    const int stage = j % kStages;
    if (j + 1 < nkb) {
      const int nxt = (j + 1) % kStages;
      load_tile<D, kWBK>(sk + nxt * kWBK * D, kb, L.k.t, (j + 1) * kWBK, Tk);
      load_tile<D, kWBK>(sv + nxt * kWBK * D, vb, L.v.t, (j + 1) * kWBK, Tk);
      cp_async_commit();
      cp_async_wait<1>();  // block j (and Q) have landed
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();
    const bf16* skj = sk + stage * kWBK * D;
    const bf16* svj = sv + stage * kWBK * D;

    // S = Q Kᵀ: [64 rows of this warpgroup] x [64 keys], D / 16 k-steps.
    float s[NT * 4];
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int blk = ks * 16 / W, kin = ks * 16 % W;
      const uint64_t da = gmma_desc(sq + blk * kWBQ * W + wg * 64 * W + kin,
                                    16, sbo, TL::kMode);
      const uint64_t db = gmma_desc(skj + blk * kWBK * W + kin, 16, sbo,
                                    TL::kMode);
      wgmma_ss_n64<0>(s, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // scale into the log2 domain; mask only the diagonal and ragged blocks.
    const int k0 = j * kWBK;
    const bool masked = k0 + kWBK > Tk || (causal && k0 + kWBK - 1 > q0 + off);
#pragma unroll
    for (int i = 0; i < NT * 4; ++i) {
      float x = s[i] * scale_log2;
      if (masked) {
        const int row = q0 + wr + g + ((i >> 1) & 1) * 8;
        const int col = k0 + (i >> 2) * 8 + 2 * t4 + (i & 1);
        if (col >= Tk || (causal && col > row + off)) x = kNegInf;
      }
      s[i] = x;
    }

    // online softmax: the four lanes of a quad share a row.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt * 4 + 2 * half], s[nt * 4 + 2 * half + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[half], mx);
      const float alpha = ex2(m[half] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(s[nt * 4 + 2 * half + e] - m_new);
          s[nt * 4 + 2 * half + e] = p;
          sum += p;
        }
      l[half] = l[half] * alpha + sum;
      m[half] = m_new;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        acc[dt * 4 + 2 * half] *= alpha;
        acc[dt * 4 + 2 * half + 1] *= alpha;
      }
    }

    // o += P V: the accumulator fragments of S, rounded to bf16, are P's A
    // fragments; V is the MN-major B operand.
    uint32_t a[kWBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kWBK / 16; ++kk) {
      a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWBK / 16; ++kk) {
      if constexpr (D <= 128) {
        wgmma_rs<D>(acc, a[kk],
                    gmma_desc(svj + kk * 16 * W, kWBK * RB, sbo, TL::kMode));
      } else {
        // N = D has no single instruction here: one m64n32k16 per column
        // block of V, each into its 16 floats of the accumulator (the
        // fragment of columns 32c.. is acc[16c..16c + 16)).
#pragma unroll
        for (int c = 0; c < D / W; ++c)
          wgmma_rs<W>(*reinterpret_cast<float(*)[W / 2]>(acc + c * (W / 2)),
                      a[kk],
                      gmma_desc(svj + c * kWBK * W + kk * 16 * W, kWBK * RB,
                                sbo, TL::kMode));
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    __syncthreads();  // stage j is free for block j + 2
  }

  // o = acc / l, through this warp's own 16 rows of Q's tile, then 16-byte
  // stores.
  cp_async_wait<0>();  // Q's copy, when no block was visited
  __syncthreads();     // every warpgroup's wgmma is done with Q's tile
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float sum = l[half];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int row = wr + g + 8 * half;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(sq + TL::off(kWBQ, row, dt) +
                                   2 * t4) =
          pack_bf16(acc[dt * 4 + 2 * half] * inv,
                    acc[dt * 4 + 2 * half + 1] * inv);
  }
  __syncwarp();
  bf16* ob = o + b * L.o.b + h * L.o.h;
#pragma unroll
  for (int it = 0; it < DT / 2; ++it) {  // 16 rows x DT chunks, 32 per step
    const int i = it * 32 + lane;
    const int rr = i / DT, c = i % DT;
    const int row = q0 + wr + rr;
    if (row < Tq)
      *reinterpret_cast<uint4*>(ob + row * L.o.t + c * 8) =
          *reinterpret_cast<const uint4*>(
              sq + TL::off(kWBQ, wr + rr, c));
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               const Layout& L, int B, int Hq, int Hkv, int Tq, int Tk,
               float scale, int causal, cudaStream_t stream) {
  const size_t smem = (size_t)smem_floats(D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * Hq, (Tq + kBQ - 1) / kBQ);
  flash_f32<D><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, L, Hq,
      Hkv, Tq, Tk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 const Layout& L, int B, int Hq, int Hkv, int Tq, int Tk,
                 float scale, int causal, cudaStream_t stream) {
  const int smem = wg_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * Hq, (Tq + kWBQ - 1) / kWBQ);
  flash_wgmma<D><<<grid, kWgThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, L, Hq, Hkv,
      Tq, Tk, scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

#define FLASH_DISPATCH(fn, ...)                 \
  switch (D) {                                  \
    case 16: return fn<16>(__VA_ARGS__);        \
    case 32: return fn<32>(__VA_ARGS__);        \
    case 64: return fn<64>(__VA_ARGS__);        \
    case 128: return fn<128>(__VA_ARGS__);      \
    case 160: return fn<160>(__VA_ARGS__);      \
    default: return (int)cudaErrorInvalidValue; \
  }

}  // namespace

// Dynamic shared memory, in bytes, that a launch with head dim D needs.
extern "C" int flash_attention_smem_bytes(int D, int bf16) {
  return bf16 ? wg_smem_bytes(D) : smem_floats(D) * (int)sizeof(float);
}

// q, o: [B, Hq, Tq, D]; k, v: [B, Hkv, Tk, D]; all float (bf16 = 0) or all
// __nv_bfloat16 (bf16 = 1).  strides: 12 element strides, (B, H, T) of q, k,
// v and o in that order; the last dimension is contiguous, every row starts
// on 16 bytes.  Needs D in {16, 32, 64, 128, 160} and Hq % Hkv == 0 (checked by
// the Python wrapper; another D returns cudaErrorInvalidValue).
extern "C" int flash_attention_launch(void* q, void* k, void* v, void* o,
                                      int B, int Hq, int Hkv, int Tq, int Tk,
                                      int D, const long long* strides,
                                      float scale, int causal, int bf16,
                                      void* stream) {
  const Layout L = {{strides[0], strides[1], strides[2]},
                    {strides[3], strides[4], strides[5]},
                    {strides[6], strides[7], strides[8]},
                    {strides[9], strides[10], strides[11]}};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    FLASH_DISPATCH(launch_wgmma, q, k, v, o, L, B, Hq, Hkv, Tq, Tk, scale,
                   causal, s)
  }
  FLASH_DISPATCH(launch_f32, q, k, v, o, L, B, Hq, Hkv, Tq, Tk, scale, causal,
                 s)
}
