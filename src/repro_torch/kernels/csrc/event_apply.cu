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
//   * KR-node init     payload[start:start+KR, :] = dyadic10(fold6),
//   * one emission     dst = fold1 % n_objects (or the hot dst of folds 8/9),
//                      ts + lookahead + draw(fold2), fold3, dyadic10(fold4)
// — and writes every unused emission slot as ts=+inf, valid=0.
//
// Layout: payload is [n, S, LANES] (node-major), so one K-window is one
// contiguous run of K*LANES floats and no transpose is needed around the call.
//
// What bounds it on this card: bytes.  An event reads and writes one K-window
// (K*LANES*4 bytes, 3,000 B at default PHOLD) and does ~2 flops per float,
// far below the 67 TFLOP/s f32 rate.  At default PHOLD an object receives
// about 5 events per epoch, so touching the windows in place moves ~30 KB per
// object per epoch, where staging the whole 96,000 B payload tile plus the
// 16,000 B address tile through shared memory and back would move 224 KB.  So
// this design updates payload, addresses and top in place in device memory:
// one CTA per object walks its batch in order (the events of one object are a
// dependent chain), the CTA's threads stride the window, and 1024 objects give
// the 132 SMs several CTAs each.  Consecutive windows of one object may
// overlap, so a barrier separates events; another one separates the touch
// from the KR-node init that overwrites the window's first nodes.  Thread 0
// writes the KR arena entries and the emission.
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

__global__ void event_apply_kernel(
    float* __restrict__ payload, int* __restrict__ addresses,
    const int* __restrict__ top, const float* __restrict__ ts,
    const long long* __restrict__ seed, const int* __restrict__ cnt,
    int* __restrict__ odst, float* __restrict__ ots,
    long long* __restrict__ oseed, float* __restrict__ opay,
    int* __restrict__ ovalid, int S, int LANES, int C, int K, int KR,
    int n_objects, float lookahead, int dist, float mean, int hot_objects,
    int hot_prob) {
  const int obj = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  float* pay = payload + (size_t)obj * S * LANES;
  int* addr = addresses + (size_t)obj * S;
  const size_t row = (size_t)obj * C;
  const int c = min(max(cnt[obj], 0), C);
  // the reference's dynamic_update_slice clamps its start into range.
  const int arena_at = min(max(top[obj] - KR, 0), S - KR);
  const uint32_t span = (uint32_t)(S - K + 1);
  const int wlen = K * LANES;
  const int ilen = KR * LANES;

  for (int r = c + tid; r < C; r += nthreads) {
    odst[row + r] = 0;
    ots[row + r] = INFINITY;
    oseed[row + r] = 0;
    opay[row + r] = 0.0f;
    ovalid[row + r] = 0;
  }

  for (int r = 0; r < c; ++r) {
    const uint32_t s = (uint32_t)seed[row + r];
    const int start = (int)(fold(s, 0u) % span);
    const float delta = dyadic10(fold(s, 5u));
    float* win = pay + (size_t)start * LANES;
    for (int i = tid; i < wlen; i += nthreads)
      win[i] = __fadd_rn(__fmul_rn(win[i], 0.5f), delta);
    __syncthreads();

    const float initval = dyadic10(fold(s, 6u));
    float* init = pay + (size_t)min(start, S - KR) * LANES;
    for (int i = tid; i < ilen; i += nthreads) init[i] = initval;

    if (tid == 0) {
      for (int j = 0; j < KR; ++j) addr[arena_at + j] = start + KR - 1 - j;
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
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int event_apply_launch(
    void* payload, void* addresses, void* top, void* ts, void* seed,
    void* cnt, void* odst, void* ots, void* oseed, void* opay, void* ovalid,
    int n, int S, int LANES, int C, int K, int KR, int n_objects,
    float lookahead, int dist, float mean, int hot_objects, int hot_prob,
    void* stream) {
  const int threads = 128;
  event_apply_kernel<<<n, threads, 0, (cudaStream_t)stream>>>(
      (float*)payload, (int*)addresses, (const int*)top, (const float*)ts,
      (const long long*)seed, (const int*)cnt, (int*)odst, (float*)ots,
      (long long*)oseed, (float*)opay, (int*)ovalid, S, LANES, C, K, KR,
      n_objects, lookahead, dist, mean, hot_objects, hot_prob);
  return (int)cudaGetLastError();
}
