// The live-group list of the f32 decode kernels (csrc/fused_decode.cu, K3,
// and csrc/fused_decode_bwd.cu, K4), built on the device.
//
// A shading group g (rows g*K .. g*K + K - 1) is live for K3 when any of its
// K weights is nonzero, and live for K4 when it is live for K3 or when
// g_fagg[g] or g_alpha[g] has a nonzero element. Both rules are exact: a
// dead group's fagg and alpha are sums of h * 0, and its row gradients are
// zero (g_h = g_f w + g_za wa with g_za proportional to w, and
// g_w = h . g_f + softplus(za - 1) g_a). Rows with w == 0 inside a live group
// are still computed, so g_w stays exact there.
//
// The list is one ascending, stable compaction in two launches, with no
// atomics and no host synchronisation:
//  1. live_flags: a block takes kGroups consecutive groups, writes their
//     flags (one byte each) and the block's live count, and writes zeros into
//     every output a dead group owns (fagg and alpha for K3, the row
//     gradients for K4), so the decode kernels never visit a dead group;
//  2. live_compact: block b sums the counts of blocks 0 .. b - 1 (its
//     offset), scans its flags in order and writes the live group ids from
//     that offset; the last block writes the total to `count` in device
//     memory, from which the decode kernels take their number of tiles.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dlive {

constexpr int kGroups = 1024;   // groups per block
constexpr int kThreads = 256;
constexpr int kPer = kGroups / kThreads;  // consecutive groups per thread

// The outputs a group owns, zeroed when it is dead: array a holds n[a]
// consecutive floats per group (an entry with n[a] == 0 is skipped).
struct Owned {
  float* p[4];
  int n[4];
};

inline int blocks(int G) { return (G + kGroups - 1) / kGroups; }

// sum of v over the block (every thread gets it); red holds kThreads / 32
__device__ __forceinline__ int block_sum(int v, int* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) s += red[i];
  return s;
}

// zero n floats per dead group of the block, from group g0 on
__device__ __forceinline__ void zero_dead(float* p, int n, int g0, int ng,
                                          const unsigned char* live_s) {
  float* base = p + (size_t)g0 * n;
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < ng * n4; i += kThreads)
      if (!live_s[i / n4])
        reinterpret_cast<float4*>(base)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int i = threadIdx.x; i < ng * n; i += kThreads)
      if (!live_s[i / n]) base[i] = 0.f;
  }
}

// Pass 1. w [G*K]; with kGrad (K4's rule) also gf [G][H] and ga [G]. The
// rule is a template argument so that a trace tells K3's pass from K4's.
template <bool kGrad>
__global__ void __launch_bounds__(kThreads)
live_flags(const float* __restrict__ w, const float* __restrict__ gf,
           const float* __restrict__ ga, int G, int K, int H, Owned own,
           unsigned char* __restrict__ flags, int* __restrict__ counts) {
  __shared__ unsigned char live_s[kGroups];
  __shared__ int red[kThreads / 32];
  const int tid = threadIdx.x;
  const int g0 = blockIdx.x * kGroups;
  const int ng = G - g0 < kGroups ? G - g0 : kGroups;
  for (int i = tid; i < ng; i += kThreads) {
    const float* wg = w + (size_t)(g0 + i) * K;
    bool live = false;
    for (int k = 0; k < K; ++k) live |= wg[k] != 0.f;
    if (kGrad) live |= ga[g0 + i] != 0.f;
    live_s[i] = live;
  }
  __syncthreads();
  if (kGrad) {
    // a warp per group: one 128-byte row segment per step
    const int lane = tid & 31;
    for (int i = tid >> 5; i < ng; i += kThreads / 32) {
      if (live_s[i]) continue;  // the same value for every lane
      const float* row = gf + (size_t)(g0 + i) * H;
      bool nz = false;
      for (int c = lane; c < H; c += 32) nz |= row[c] != 0.f;
      if (__any_sync(0xffffffffu, nz) && lane == 0) live_s[i] = 1;
    }
    __syncthreads();
  }
  int n = 0;
  for (int i = tid; i < ng; i += kThreads) {
    flags[g0 + i] = live_s[i];
    n += live_s[i];
  }
  n = block_sum(n, red);
  if (tid == 0) counts[blockIdx.x] = n;
  for (int a = 0; a < 4; ++a)
    if (own.n[a] > 0) zero_dead(own.p[a], own.n[a], g0, ng, live_s);
}

// Pass 2: list[0 .. count) = the live groups in ascending order.
template <bool kGrad>
__global__ void __launch_bounds__(kThreads)
live_compact(const unsigned char* __restrict__ flags,
             const int* __restrict__ counts, int G,
             int* __restrict__ list, int* __restrict__ count) {
  __shared__ int red[kThreads / 32];
  __shared__ int warp_excl[kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g0 = blockIdx.x * kGroups;
  int s = 0;
  for (int b = tid; b < (int)blockIdx.x; b += kThreads) s += counts[b];
  const int offset = block_sum(s, red);
  // thread t takes groups g0 + t*kPer .. + kPer - 1, in order
  const int first = g0 + tid * kPer;
  unsigned char f[kPer];
  int c = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    f[q] = first + q < G ? flags[first + q] : 0;
    c += f[q];
  }
  // exclusive scan of c over the block
  int incl = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_excl[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int i = 0; i < warp; ++i) before += warp_excl[i];
  int pos = offset + before + incl - c;
#pragma unroll
  for (int q = 0; q < kPer; ++q)
    if (f[q]) list[pos++] = first + q;
  if (blockIdx.x == gridDim.x - 1 && tid == kThreads - 1) *count = pos;
}

// Both passes on the caller's stream, K4's rule when gf is given; count = 0
// when G == 0.
inline cudaError_t build(const float* w, const float* gf, const float* ga,
                         int G, int K, int H, Owned own,
                         unsigned char* flags, int* counts, int* list,
                         int* count, cudaStream_t s) {
  if (G == 0) return cudaMemsetAsync(count, 0, sizeof(int), s);
  const int nb = blocks(G);
  if (gf != nullptr)
    live_flags<true><<<nb, kThreads, 0, s>>>(w, gf, ga, G, K, H, own, flags,
                                             counts);
  else
    live_flags<false><<<nb, kThreads, 0, s>>>(w, gf, ga, G, K, H, own, flags,
                                              counts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (gf != nullptr)
    live_compact<true><<<nb, kThreads, 0, s>>>(flags, counts, G, list, count);
  else
    live_compact<false><<<nb, kThreads, 0, s>>>(flags, counts, G, list, count);
  return cudaGetLastError();
}

}  // namespace dlive
