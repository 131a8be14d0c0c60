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
// ~2.4 us at 3.35 TB/s, well under one launch's overhead.
//
// Design: one thread per ray walking its samples with T and the color sums
// in registers. The inputs are [R, SR]-major, so no transpose is needed
// (the TPU kernel transposed to put rays on lanes). Built with -fmad=false
// so the sums round as the plain PyTorch twin's separate ops do.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 8;

__global__ void fused_march_kernel(const float* __restrict__ dist,
                                   const uint8_t* __restrict__ valid,
                                   const float* __restrict__ feats,
                                   const float* __restrict__ bg, int R,
                                   int SR, int C,
                                   float* __restrict__ color,
                                   float* __restrict__ opacity,
                                   float* __restrict__ bgtr) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float acc[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) acc[c] = 0.f;
  float trans = 1.f;
  for (int s = 0; s < SR; ++s) {
    const size_t i = (size_t)r * SR + s;
    const float* f = feats + i * (C + 1);
    const float sigma = f[0] * (valid[i] ? 1.f : 0.f);
    const float op = 1.f - expf(-sigma * dist[i]);
    opacity[i] = op;
    const float wgt = op * trans;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c)
      if (c < C) acc[c] = acc[c] + f[1 + c] * wgt;
    trans = trans * (1.f - op + 1e-10f);
  }
#pragma unroll
  for (int c = 0; c < kMaxC; ++c)
    if (c < C) color[(size_t)r * C + c] = acc[c] + bg[c] * trans;
  bgtr[r] = trans;
}

}  // namespace

extern "C" int fused_march_launch(const float* dist, const uint8_t* valid,
                                  const float* feats, const float* bg, int R,
                                  int SR, int C, float* color, float* opacity,
                                  float* bgtr, void* stream) {
  if (R == 0) return 0;
  if (C > kMaxC) return (int)cudaErrorInvalidValue;
  const int block = 128;
  fused_march_kernel<<<(R + block - 1) / block, block, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      dist, valid, feats, bg, R, SR, C, color, opacity, bgtr);
  return (int)cudaGetLastError();
}
