// event_apply: per-object batched event application (the PHOLD hot loop),
// hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `build_event_apply` / `_kernel` in
// src/repro/kernels/event_apply.py.  It computes exactly what the plain
// PyTorch version `event_apply_ref` (src/repro_torch/kernels/event_apply.py)
// computes: for every object, apply its (ts, seed)-sorted epoch batch in
// order —
//   * K-window touch   payload[start:start+K, :] = x * 0.5 + dyadic10(fold5)
//                      with start = fold0 % (S - K + 1),
//   * arena free/alloc addresses[top-KR : top] = start+KR-1 .. start,
//   * KR-node init     payload[start:start+KR, :] = dyadic10(fold6)
//                      (start clamped to S - KR),
//   * one emission     dst = fold1 % n_objects (or the hot dst of folds 8/9),
//                      ts + lookahead + draw(fold2), fold3, dyadic10(fold4)
// — and writes every unused emission slot as ts=+inf, valid=0.
//
// Why no event waits for another.  An event's whole effect follows from its
// seed: its window, touch increment, init range and value, and emission.
// So node j's final value is the in-order composition of the events that
// cover it (x <- x * 0.5 + delta_e where j is in e's window, then x <- init_e
// where j is in e's init range), and since `top` never moves every event
// writes the same KR arena slots, of which the last event's values survive.
// The kernel therefore runs two steps with one barrier between them:
//   1. thread r reads event r's seed, puts its window start, init start,
//      delta and init value in shared memory (16 B an event) and sets its
//      nodes in a coverage bitmap (a bit per node, a word per kTile nodes);
//      in part 0 it also writes emission slot r (or the empty slot for
//      r >= cnt), and the thread of the last event writes the arena slots.
//   2. the warps take the tiles of kTile nodes in turn and skip those whose
//      bitmap word is 0.  A lane holds kChunk floats of a tile, float
//      l + 32 i of the tile for lane l (each load a whole 128-byte row), and
//      loads those of covered nodes; a warp has kTilesInFlight tiles' loads
//      in flight.  A ballot over the events finds those that meet the tile,
//      in event order, and each float gets their touches and inits in that
//      order before it is stored once.  Every node thus sees the plain
//      version's f32 operations in its order, so the result is bit-exact.
// A tile costs O(events that meet it), so a full bucket costs more tiles,
// not a chain of barriers.  An object with many events is split over
// ceil(cnt / kEventsPerPart) CTAs (at most the launch's parts), which take
// every parts-th tile; the other CTAs of the object exit once they read cnt.
// The grid puts every object's part 0 first.
//
// What bounds it on this card: bytes.  The function reads and writes the
// union of the touched windows (LANES * 4 B a node) and writes C emission
// slots per object, at ~2 flops per touched float.  At default PHOLD (1024
// objects, ~5 events of a 125-node window each) that is ~31.6 MB, 9.4 us at
// 3.35 TB/s; a device-to-device copy of as many bytes takes about as long as
// this kernel (PERF.md).  The 1024 part-0 CTAs of 128 threads fit in one
// wave (8 per SM at <= 64 registers).
//
// Bit-exactness: the file is compiled with -fmad=false and the float
// arithmetic is spelled with __fadd_rn/__fmul_rn, so `ts + lookahead + draw`
// and `x * 0.5 + delta` round exactly as the plain version does.  dyadic and
// uniform24 are bit-exact; exponential goes through log1pf and matches to a
// relative 1e-6.
//
// The kernel allocates nothing and runs on the caller's stream; the C entry
// point returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;        // threads per CTA
constexpr int kTile = 32;            // nodes per tile: one bitmap word
constexpr int kChunk = 6;            // payload floats a lane holds per tile
constexpr int kTilesInFlight = 2;    // covered tiles a warp loads at once
constexpr int kEventsPerPart = 16;   // events that justify one more CTA
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ uint32_t mix32(uint32_t z) {
  z = z + 0x9E3779B9u;
  z = (z ^ (z >> 16)) * 0x85EBCA6Bu;
  z = (z ^ (z >> 13)) * 0xC2B2AE35u;
  return z ^ (z >> 16);
}

__device__ __forceinline__ uint32_t fold(uint32_t seed, uint32_t k) {
  return mix32(seed ^ (k * 0x632BE59Bu));
}

__device__ __forceinline__ float dyadic10(uint32_t bits) {
  return __fmul_rn((float)(bits & 1023u), 1.0f / 1024.0f);
}

__device__ __forceinline__ float uniform24(uint32_t bits) {
  return __fmul_rn((float)(bits >> 8), 1.0f / 16777216.0f);
}

// dist: 0 dyadic, 1 uniform24, 2 exponential (see DISTS in event_apply.py).
__device__ __forceinline__ float draw(uint32_t bits, int dist, float mean) {
  if (dist == 0) return dyadic10(bits);
  if (dist == 1) return __fmul_rn(uniform24(bits), mean);
  return __fmul_rn(-log1pf(-uniform24(bits)), mean);
}

// Sets the bits of nodes [lo, lo + len) in the coverage bitmap.
__device__ __forceinline__ void mark(unsigned* cover, int lo, int len) {
  const int hi = lo + len - 1;
  for (int w = lo / kTile; w <= hi / kTile; ++w) {
    const int a = max(lo - w * kTile, 0), b = min(hi - w * kTile, kTile - 1);
    atomicOr(&cover[w], (kAll >> (kTile - 1 - b + a)) << a);
  }
}

// Does the event (window start, init start, delta and init bits) meet tile
// [lo, lo + kTile) with its window or its init range?
__device__ __forceinline__ bool meets(int4 e, int lo, int K, int KR) {
  return (e.x < lo + kTile && e.x + K > lo) ||
         (e.y < lo + kTile && e.y + KR > lo);
}

__global__ void __launch_bounds__(kThreads, 2048 / kThreads / 2)
event_apply_kernel(
    float* __restrict__ payload, int* __restrict__ addresses,
    const int* __restrict__ top, const float* __restrict__ ts,
    const long long* __restrict__ seed, const int* __restrict__ cnt,
    int* __restrict__ odst, float* __restrict__ ots,
    long long* __restrict__ oseed, float* __restrict__ opay,
    int* __restrict__ ovalid, int n, int S, int LANES, int C, int K, int KR,
    int n_objects, float lookahead, int dist, float mean, int hot_objects,
    int hot_prob, int max_parts) {
  extern __shared__ int4 ev[];  // C events, then the coverage bitmap
  unsigned* cover = reinterpret_cast<unsigned*>(ev + C);
  const int obj = (int)(blockIdx.x % n);
  const int part = (int)(blockIdx.x / n);  // every object's part 0 first
  const int tid = threadIdx.x;
  const int ntiles = (S + kTile - 1) / kTile;
  const size_t row = (size_t)obj * C;
  const int raw = cnt[obj];
  for (int w = tid; w < ntiles; w += kThreads) cover[w] = 0;
  const int c = min(max(raw, 0), C);
  const int parts = min(max((c + kEventsPerPart - 1) / kEventsPerPart, 1),
                        max_parts);
  if (part >= parts) return;
  const uint32_t span = (uint32_t)(S - K + 1);
  __syncthreads();

  // 1. every event's parameters and covered nodes; in part 0 its emission
  //    and (last event) the arena slots.
  for (int r = tid; r < C; r += kThreads) {
    if (r < c) {
      const uint32_t s = (uint32_t)seed[row + r];
      const int start = (int)(fold(s, 0u) % span);
      const int istart = min(start, S - KR);
      ev[r] = make_int4(start, istart,
                        __float_as_int(dyadic10(fold(s, 5u))),
                        __float_as_int(dyadic10(fold(s, 6u))));
      mark(cover, start, K);
      mark(cover, istart, KR);
      if (part != 0) continue;
      uint32_t dst = fold(s, 1u) % (uint32_t)n_objects;
      if (hot_objects != 0 && hot_prob != 0 &&
          (fold(s, 8u) & 255u) < (uint32_t)hot_prob)
        dst = fold(s, 9u) % (uint32_t)hot_objects;
      odst[row + r] = (int)dst;
      ots[row + r] = __fadd_rn(__fadd_rn(ts[row + r], lookahead),
                               draw(fold(s, 2u), dist, mean));
      oseed[row + r] = (long long)fold(s, 3u);
      opay[row + r] = dyadic10(fold(s, 4u));
      ovalid[row + r] = 1;
      if (r == c - 1) {
        // the reference's dynamic_update_slice clamps its start into range.
        int* addr = addresses + (size_t)obj * S;
        const int at = min(max(top[obj] - KR, 0), S - KR);
        for (int j = 0; j < KR; ++j) addr[at + j] = start + KR - 1 - j;
      }
    } else if (part == 0) {
      odst[row + r] = 0;
      ots[row + r] = INFINITY;
      oseed[row + r] = 0;
      opay[row + r] = 0.0f;
      ovalid[row + r] = 0;
    }
  }
  if (c == 0) return;
  __syncthreads();

  // 2. each covered node read once, composed over its events, written once.
  //    The object's warps (of all its CTAs) take the tiles in turn; a warp
  //    loads kTilesInFlight covered tiles before it applies their events.
  const int lane = tid & 31;
  const int warps = parts * (kThreads / 32);
  const int words = (c + 31) / 32;
  float* pay = payload + (size_t)obj * S * LANES;
  for (int i0 = 0; i0 < LANES; i0 += kChunk) {
    // node (within the tile) of this lane's float i0 + j, float l + 32 i of
    // the tile, and which of the kChunk floats exist.
    int node[kChunk];
    unsigned held = 0;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      node[j] = (lane + 32 * (i0 + j)) / LANES % kTile;
      held |= (unsigned)(i0 + j < LANES) << j;
    }
    int t = part * (kThreads / 32) + tid / 32;
    for (;;) {
      int lo[kTilesInFlight];
      unsigned cov[kTilesInFlight];
      float x[kTilesInFlight][kChunk];
#pragma unroll
      for (int u = 0; u < kTilesInFlight; ++u) {
        while (t < ntiles && cover[t] == 0) t += warps;  // uniform
        const unsigned word = t < ntiles ? cover[t] : 0u;
        lo[u] = t * kTile;
        t += warps;
        cov[u] = 0;
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          cov[u] |= ((word >> node[j]) & 1u) << j;
        cov[u] &= held;
        const float* at = pay + (size_t)lo[u] * LANES + 32 * i0 + lane;
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          x[u][j] = (cov[u] >> j) & 1u ? at[32 * j] : 0.0f;
      }
      if (lo[0] >= S) break;
#pragma unroll
      for (int u = 0; u < kTilesInFlight; ++u) {
        if (lo[u] >= S) break;
        for (int w = 0; w < words; ++w) {
          const int mine = 32 * w + lane;
          unsigned m = __ballot_sync(
              kAll, mine < c && meets(ev[mine], lo[u], K, KR));
          while (m) {
            const int4 e = ev[32 * w + __ffs(m) - 1];
            m &= m - 1;
            const float delta = __int_as_float(e.z);
            const float init = __int_as_float(e.w);
#pragma unroll
            for (int j = 0; j < kChunk; ++j) {
              const int nd = lo[u] + node[j];
              const float y = __fadd_rn(__fmul_rn(x[u][j], 0.5f), delta);
              x[u][j] = (unsigned)(nd - e.x) < (unsigned)K ? y : x[u][j];
              x[u][j] = (unsigned)(nd - e.y) < (unsigned)KR ? init : x[u][j];
            }
          }
        }
        float* at = pay + (size_t)lo[u] * LANES + 32 * i0 + lane;
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          if ((cov[u] >> j) & 1u) at[32 * j] = x[u][j];
      }
    }
  }
}

// Allows the kernel more than the default 48 KB where it needs it.
cudaError_t allow_smem(int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(event_apply_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

// Dynamic shared memory of one CTA with C event slots over S nodes: the
// events' parameters, then the coverage bitmap.
extern "C" int event_apply_smem_bytes(int S, int C) {
  return C * (int)sizeof(int4) + (S + kTile - 1) / kTile * (int)sizeof(int);
}

// CTAs of the kernel that fit on one SM with C event slots over S nodes
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); -1 on error.
extern "C" int event_apply_ctas_per_sm(int S, int C) {
  const int smem = event_apply_smem_bytes(S, C);
  int n = -1;
  if (allow_smem(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, event_apply_kernel, kThreads, smem) != cudaSuccess)
    return -1;
  return n;
}

extern "C" int event_apply_launch(
    void* payload, void* addresses, void* top, void* ts, void* seed,
    void* cnt, void* odst, void* ots, void* oseed, void* opay, void* ovalid,
    int n, int S, int LANES, int C, int K, int KR, int n_objects,
    float lookahead, int dist, float mean, int hot_objects, int hot_prob,
    void* stream) {
  const int smem = event_apply_smem_bytes(S, C);
  const cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return (int)err;
  const int max_parts = max((C + kEventsPerPart - 1) / kEventsPerPart, 1);
  event_apply_kernel<<<n * max_parts, kThreads, smem,
                       (cudaStream_t)stream>>>(
      (float*)payload, (int*)addresses, (const int*)top, (const float*)ts,
      (const long long*)seed, (const int*)cnt, (int*)odst, (float*)ots,
      (long long*)oseed, (float*)opay, (int*)ovalid, n, S, LANES, C, K, KR,
      n_objects, lookahead, dist, mean, hot_objects, hot_prob, max_parts);
  return (int)cudaGetLastError();
}
