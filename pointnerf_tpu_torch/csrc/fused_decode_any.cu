// K3: fused decode forward, the general route, on the CUDA cores.
//
// Replaces: pointnerf_tpu/ops/pallas_decode.py::fused_decode, forward
// (_fwd_impl -> pallas_call at :404 of _fwd_kernel), for every DecodeSpec
// inside JAX's fused envelope that the tuned kernels (fused_decode_tc.cu,
// bf16; fused_decode.cu, f32) do not take: H not a multiple of 32 or past
// 256, more than 8 block layers, 64 % K != 0, wide layer inputs. JAX's own
// kernel needs only M % K == 0.
//
// Function, per neighbor row m of M = G*K rows (ops/fused_decode.py::
// fused_decode_plain, whose spec.bf16 picks the template):
//   x   = [feat | PE(feat) | PE(dists)]
//   h   = leaky(h @ W + b) through block1, then h = [h | extras] and block3
//   za  = h . wa + ba;  alpha_pp = softplus(za - 1)
//   fagg[g]  = sum_k h[g*K+k] * w[g*K+k];  alpha[g] = sum_k alpha_pp * w
//
// Design (csrc/decode_any.cuh): CTAs of 256 threads walk tiles of whole
// groups; a tile whose rows all have w == 0 writes zeros (its outputs are
// exactly 0) and is not decoded. The tile's state is two activation
// buffers [T][ld] (each layer reads one and writes the other) and two
// per-row floats, in shared memory when it fits, else in a global
// workspace slice per CTA. Making it fast is later work.
#include "decode_any.cuh"

namespace {

using namespace dany;

__host__ __device__ long long state_floats(const Dims& d) {
  return 2LL * d.T * d.ld + 2LL * d.T + 4;
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
fused_decode_any(const float* __restrict__ feat,
                 const float* __restrict__ dists,
                 const float* __restrict__ extras,
                 const float* __restrict__ w, const float* __restrict__ W,
                 const float* __restrict__ bias,
                 const float* __restrict__ wa, const float* __restrict__ ba,
                 Dims d, float slope, float* __restrict__ ws,
                 float* __restrict__ fagg, float* __restrict__ alpha) {
  extern __shared__ __align__(16) float smem[];
  float* S = ws == nullptr ? smem : ws + (long long)blockIdx.x * state_floats(d);
  float* X0 = S;
  float* X1 = X0 + (long long)d.T * d.ld;
  float* w_s = X1 + (long long)d.T * d.ld;   // [T] rounded w
  float* aw_s = w_s + d.T;                    // [T] alpha_pp * w
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = d.H, K = d.K;

  for (int t = blockIdx.x; t < d.ntiles; t += gridDim.x) {
    const long long g0 = (long long)t * d.gpt;
    const int ng = (int)(d.G - g0 < d.gpt ? d.G - g0 : d.gpt);
    const int rows = ng * K;
    const long long m0 = g0 * K;
    int live = 0;
    for (int r = tid; r < rows; r += kThreads) {
      const float v = rnd<BF16>(w[m0 + r]);
      w_s[r] = v;
      live |= v != 0.f;
    }
    if (!__syncthreads_or(live)) {
      for (int i = tid; i < ng * H; i += kThreads) fagg[g0 * H + i] = 0.f;
      for (int i = tid; i < ng; i += kThreads) alpha[g0 + i] = 0.f;
      continue;
    }
    build_x<BF16>(d, feat, dists, m0, rows, X0, d.ld);
    __syncthreads();
    float* in = X0;
    float* out = X1;
    long long woff = 0;
    for (int l = 0; l < d.L; ++l) {
      const int nin = layer_in(d, l);
      product<BF16>(in, d.ld, nin, W + woff, H, rows, out, d.ld,
                    bias + (long long)l * H, slope, nullptr);
      if (l == d.L1 - 1) put_extras<BF16>(d, extras, m0, rows, out, d.ld);
      __syncthreads();
      woff += (long long)nin * H;
      float* tmp = in; in = out; out = tmp;
    }
    // in: the last layer's h. The alpha head, warp per row.
    for (int r = warp; r < rows; r += kThreads / 32) {
      float part = 0.f;
      for (int c = lane; c < H; c += 32)
        part = fmaf(in[(long long)r * d.ld + c], __ldg(wa + c), part);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) aw_s[r] = softplus(part + __ldg(ba) - 1.f) * w_s[r];
    }
    __syncthreads();
    for (int i = tid; i < ng * H; i += kThreads) {
      const int g = i / H, c = i - g * H;
      float s = 0.f;
      for (int k = 0; k < K; ++k)
        s += in[(long long)(g * K + k) * d.ld + c] * w_s[g * K + k];
      fagg[(g0 + g) * H + c] = s;
    }
    for (int g = tid; g < ng; g += kThreads) {
      float s = 0.f;
      for (int k = 0; k < K; ++k) s += aw_s[g * K + k];
      alpha[g0 + g] = s;
    }
    __syncthreads();  // the tile's buffers are free for the next
  }
}

template <bool BF16>
int launch(const float* feat, const float* dists, const float* extras,
           const float* w, const float* W, const float* bias,
           const float* wa, const float* ba, const Dims& d, float slope,
           float* ws, float* fagg, float* alpha, int grid, cudaStream_t s) {
  const long long st = state_floats(d);
  const bool sm = in_smem(st);
  const size_t smem = sm ? (size_t)st * 4 : 0;
  cudaError_t e = cudaFuncSetAttribute(
      fused_decode_any<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  fused_decode_any<BF16><<<grid, kThreads, smem, s>>>(
      feat, dists, extras, w, W, bias, wa, ba, d, slope, sm ? nullptr : ws,
      fagg, alpha);
  return (int)cudaGetLastError();
}

}  // namespace

// The grid and the global workspace (floats; 0 when a tile's state fits
// shared memory) of a launch; nonzero when the dims are not taken.
extern "C" int fused_decode_any_workspace(long long M, int Fi, int Dd, int E,
                                          int Ff, int Fd, int H, int K,
                                          int L1, int L3, int* grid,
                                          long long* ws_floats,
                                          int* smem_bytes) {
  const Dims d = make_dims(M, Fi, Dd, E, Ff, Fd, H, K, L1, L3);
  if (!takes(d)) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int e = sm_count(&sms);
  if (e) return e;
  *grid = d.ntiles < 2 * sms ? d.ntiles : 2 * sms;
  const long long st = state_floats(d);
  *ws_floats = in_smem(st) ? 0 : st * *grid;
  *smem_bytes = in_smem(st) ? (int)(st * 4) : 0;
  return 0;
}

// W: block weights [in_l][H] one after another (bf16 values with bf16);
// bias: [L][H]; ws: the workspace fused_decode_any_workspace asked for
// (may be null when it asked for none).
extern "C" int fused_decode_any_launch(const float* feat, const float* dists,
                                       const float* extras, const float* w,
                                       const float* W, const float* bias,
                                       const float* wa, const float* ba,
                                       long long M, int Fi, int Dd, int E,
                                       int Ff, int Fd, int H, int K, int L1,
                                       int L3, float slope, int bf16,
                                       int grid, float* ws, float* fagg,
                                       float* alpha, void* stream) {
  const Dims d = make_dims(M, Fi, Dd, E, Ff, Fd, H, K, L1, L3);
  if (!takes(d)) return (int)cudaErrorInvalidValue;
  if (d.ntiles == 0) return 0;
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<true>(feat, dists, extras, w, W, bias, wa, ba, d,
                             slope, ws, fagg, alpha, grid, s)
              : launch<false>(feat, dists, extras, w, W, bias, wa, ba, d,
                              slope, ws, fagg, alpha, grid, s);
}
