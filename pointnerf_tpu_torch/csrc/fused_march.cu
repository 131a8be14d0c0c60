// K2: single-pass ray-march compositor.
//
// Replaces: pointnerf_tpu/ops/pallas_march.py::pallas_ray_march
// (_pallas_march_fwd_impl -> _march_kernel), called from
// pointnerf_tpu/models/renderer.py::_finalize when render.fused_march is set.
//
// Function, per ray r over its SR samples s in order:
//   op_s   = 1 - exp(-(feat[s][0] * valid[s]) * dist[s])
//   acc   += feat[s][1:] * (op_s * T);   T *= (1 - op_s + 1e-10)   (T_0 = 1)
//   color  = acc + bg * T_end;  opacity[s] = op_s;  bg_transmission = T_end
//
// Bound on the H100: bytes. At R = 3600, SR = 80, C = 3 the kernel reads
// dist, valid and feats (~6.9 MB) and writes opacity and colors (~1.2 MB):
// ~2.4 us at 3.35 TB/s, about one launch's overhead.
//
// Design: a block of 128 threads takes a tile of rays (8 at the main path's
// widths, 450 blocks for R = 3,600; 4 where SR * (C + 2) floats a ray would
// not fit in shared memory). Its features are one contiguous stretch of
// device memory, read with coalesced 16-byte loads (the wrapper checks that
// feats is 16-byte aligned; a tile starts at a multiple of 4 rays, so every
// tile is) into shared memory, several loads in flight per thread, with the
// tile's dist and valid. Then one thread per sample computes the opacities
// in parallel (opacity written coalesced), and one thread per ray walks its
// samples in order from shared memory (per-ray strides made odd, so the
// rays hit distinct banks), carrying T and the color sums in registers,
// unrolled over the C channels (one instance per C). The walk rounds
// exactly as the plain PyTorch twin's sequence of ops (built with
// -fmad=false), so the outputs are the same bits.
//
// Wide rays (C > 8, or a tile of 4 rays too wide for shared memory):
// fused_march_wide_launch. At C = 128 and SR = 80 one ray's features are
// 41 KB, so a tile of rays no longer fits in shared memory and a thread
// cannot hold a register per channel. One warp takes one ray. The lanes
// take the samples 32 at a time: lane l computes sample s0 + l's opacity
// (written coalesced), and the warp then walks the 32 samples in order,
// each lane reading sample s's opacity from lane s - s0 by a shuffle, so
// every lane carries the same T in a register and sums its own channels
// c = lane, lane + 32, ... (kWideRegs of them a pass; wider C takes more
// passes over the samples, each repeating the same T sequence). A
// sample's 1 + C floats are contiguous, so the lanes' loads of one sample
// coalesce. Each channel is summed in the plain version's order, so the
// outputs are its bits too. Nothing is staged, so neither SR nor C is
// limited. Bound: bytes (R * SR * (C + 1) * 4 read: ~95 MB at R = 2,304,
// SR = 80, C = 128, ~0.03 ms at 3.35 TB/s).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 8;
constexpr int kThreads = 128;
constexpr int kU = 8;             // loads in flight per thread
constexpr int kMaxSmem = 232448;  // 227 KB, an H100 block's most

template <int NC>
__global__ void __launch_bounds__(kThreads)
    fused_march_kernel(const float* __restrict__ dist,
                       const uint8_t* __restrict__ valid,
                       const float* __restrict__ feats,
                       const float* __restrict__ bg, int R, int SR, int rays,
                       float* __restrict__ color,
                       float* __restrict__ opacity,
                       float* __restrict__ bgtr) {
  extern __shared__ float smem[];
  const int F = SR * (NC + 1);  // floats of one ray's features
  const int fs = F | 1, os = SR | 1;
  float* sf = smem;              // [rays][fs]
  float* so = smem + rays * fs;  // [rays][os]
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * rays;
  const int nr = min(rays, R - r0);
  const int ns = nr * SR;
  const size_t g0 = (size_t)r0 * SR;

  // the first kU samples' dist and valid of this thread, in flight with
  // the features
  float d[kU];
  uint8_t ok[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int e = t + u * kThreads;
    if (e < ns) {
      d[u] = dist[g0 + e];
      ok[u] = valid[g0 + e];
    }
  }

  // 1. the tile's features: nr * F contiguous floats, 16-byte loads, kU
  // of them in flight per thread before the first is stored
  const float* gf = feats + (size_t)r0 * F;
  const int n = nr * F, n4 = n >> 2;
  const float4* gf4 = reinterpret_cast<const float4*>(gf);
  for (int i0 = t; i0 < n4; i0 += kThreads * kU) {
    float4 v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n4) v[u] = gf4[i];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n4) {
        const float part[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
        int ray = (4 * i) / F, k = 4 * i - ray * F;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          sf[ray * fs + k] = part[q];
          if (++k == F) {
            k = 0;
            ++ray;
          }
        }
      }
    }
  }
  for (int e = 4 * n4 + t; e < n; e += kThreads) {
    const int ray = e / F;
    sf[ray * fs + e - ray * F] = gf[e];
  }
  __syncthreads();

  // 2. the opacities, one thread per sample
  for (int e0 = t; e0 < ns; e0 += kThreads * kU) {
    if (e0 != t) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = e0 + u * kThreads;
        if (e < ns) {
          d[u] = dist[g0 + e];
          ok[u] = valid[g0 + e];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + u * kThreads;
      if (e < ns) {
        const int ray = e / SR, s = e - ray * SR;
        const float sigma =
            sf[ray * fs + s * (NC + 1)] * (ok[u] ? 1.f : 0.f);
        const float op = 1.f - expf(-sigma * d[u]);
        opacity[g0 + e] = op;
        so[ray * os + s] = op;
      }
    }
  }
  __syncthreads();

  // 3. the walk, one thread per ray, in sample order
  if (t < nr) {
    const float* f = sf + t * fs + 1;
    const float* o = so + t * os;
    float acc[NC > 0 ? NC : 1];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = 0.f;
    float trans = 1.f;
#pragma unroll 4
    for (int s = 0; s < SR; ++s) {
      const float op = o[s];
      const float wgt = op * trans;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        acc[c] = acc[c] + f[s * (NC + 1) + c] * wgt;
      trans = trans * (1.f - op + 1e-10f);
    }
    const int r = r0 + t;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      color[(size_t)r * NC + c] = acc[c] + bg[c] * trans;
    bgtr[r] = trans;
  }
}

template <int NC>
int launch(const float* dist, const uint8_t* valid, const float* feats,
           const float* bg, int R, int SR, int rays, float* color,
           float* opacity, float* bgtr, size_t smem, cudaStream_t s) {
  // above 48 KB of dynamic shared memory a kernel must opt in, once
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_march_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  fused_march_kernel<NC><<<(R + rays - 1) / rays, kThreads, smem, s>>>(
      dist, valid, feats, bg, R, SR, rays, color, opacity, bgtr);
  return 0;
}

constexpr int kWideRegs = 4;       // channels a lane sums per pass
constexpr int kWideWarps = 4;      // rays (warps) per block

__global__ void __launch_bounds__(kWideWarps * 32)
    fused_march_wide_kernel(const float* __restrict__ dist,
                            const uint8_t* __restrict__ valid,
                            const float* __restrict__ feats,
                            const float* __restrict__ bg, int R, int SR,
                            int C, float* __restrict__ color,
                            float* __restrict__ opacity,
                            float* __restrict__ bgtr) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWideWarps + (threadIdx.x >> 5);
  if (r >= R) return;  // the whole warp: the shuffles stay full
  const size_t F = (size_t)C + 1;
  const float* fr = feats + (size_t)r * SR * F;
  const float* dr = dist + (size_t)r * SR;
  const uint8_t* vr = valid + (size_t)r * SR;
  float* orow = opacity + (size_t)r * SR;
  // one pass per kWideRegs * 32 channels (one pass at C = 0: the
  // opacities and T)
  const int passes = max(1, (C + 32 * kWideRegs - 1) / (32 * kWideRegs));
  float trans = 1.f;
  for (int p = 0; p < passes; ++p) {
    const int c0 = p * 32 * kWideRegs;
    float acc[kWideRegs];
#pragma unroll
    for (int j = 0; j < kWideRegs; ++j) acc[j] = 0.f;
    trans = 1.f;
    for (int s0 = 0; s0 < SR; s0 += 32) {
      const int s = s0 + lane;
      float op = 0.f;
      if (s < SR) {
        const float sigma = fr[(size_t)s * F] * (vr[s] ? 1.f : 0.f);
        op = 1.f - expf(-sigma * dr[s]);
        if (p == 0) orow[s] = op;
      }
      const int n = min(32, SR - s0);
      const float* f = fr + (size_t)s0 * F + 1 + c0 + lane;
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const float op_i = __shfl_sync(0xffffffffu, op, i);
        const float wgt = op_i * trans;
#pragma unroll
        for (int j = 0; j < kWideRegs; ++j)
          if (c0 + lane + 32 * j < C)
            acc[j] = acc[j] + __ldg(f + (size_t)i * F + 32 * j) * wgt;
        trans = trans * (1.f - op_i + 1e-10f);
      }
    }
#pragma unroll
    for (int j = 0; j < kWideRegs; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < C) color[(size_t)r * C + c] = acc[j] + bg[c] * trans;
    }
  }
  if (lane == 0) bgtr[r] = trans;
}

}  // namespace

// Any C and SR: one warp per ray (fused_march_wide_kernel); feats needs
// only its 4-byte alignment.
extern "C" int fused_march_wide_launch(const float* dist,
                                       const uint8_t* valid,
                                       const float* feats, const float* bg,
                                       int R, int SR, int C, float* color,
                                       float* opacity, float* bgtr,
                                       void* stream) {
  if (R == 0) return 0;
  if (C < 0 || SR < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (R + kWideWarps - 1) / kWideWarps;
  fused_march_wide_kernel<<<blocks, kWideWarps * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      dist, valid, feats, bg, R, SR, C, color, opacity, bgtr);
  return (int)cudaGetLastError();
}

// rays: rays per block, a multiple of 4 picked by the wrapper
// (ops/fused_march.py `rays_per_block`) so that the tile fits in shared
// memory; feats must be 16-byte aligned. One instance per channel count C.
extern "C" int fused_march_launch(const float* dist, const uint8_t* valid,
                                  const float* feats, const float* bg, int R,
                                  int SR, int C, int rays, float* color,
                                  float* opacity, float* bgtr, void* stream) {
  if (R == 0) return 0;
  const size_t smem =
      (size_t)rays * ((SR * (C + 1) | 1) + (SR | 1)) * sizeof(float);
  if (C < 0 || C > kMaxC || SR < 0 || rays < 4 || rays % 4 ||
      smem > (size_t)kMaxSmem || ((uintptr_t)feats & 15))
    return (int)cudaErrorInvalidValue;
  using Launch = int (*)(const float*, const uint8_t*, const float*,
                         const float*, int, int, int, float*, float*, float*,
                         size_t, cudaStream_t);
  static const Launch by_c[kMaxC + 1] = {
      &launch<0>, &launch<1>, &launch<2>, &launch<3>, &launch<4>,
      &launch<5>, &launch<6>, &launch<7>, &launch<8>};
  const int err = by_c[C](dist, valid, feats, bg, R, SR, rays, color,
                          opacity, bgtr, smem,
                          static_cast<cudaStream_t>(stream));
  return err ? err : (int)cudaGetLastError();
}
