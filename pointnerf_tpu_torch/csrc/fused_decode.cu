// K3: fused decode forward.
//
// Replaces: pointnerf_tpu/ops/pallas_decode.py::fused_decode, forward
// (_fwd_impl -> _fwd_kernel, _forward_tile, _build_x), called from
// pointnerf_tpu/models/aggregator.py::aggregate when agg.fused_decode is set.
//
// Function, per neighbor row m of M = C*K rows:
//   x   = [feat | PE(feat) | PE(dists)]    interleaved (sin, cos) per
//                                          (channel, freq), as ops/pe.py
//   h   = leaky(h @ W + b) through block1, then h = [h | extras] and block3
//   za  = h . wa + ba;  alpha_pp = softplus(za - 1)
//   fagg[g]  = sum_k h[g*K+k] * w[g*K+k];  alpha[g] = sum_k alpha_pp * w
// In bf16 mode (bf16 != 0) feat, dists, extras, w, x and every hidden h are
// rounded to bf16 (round to nearest even), the block weights arrive already
// rounded, products accumulate in f32, and the alpha head stays f32 — the
// rounding points of the JAX kernel.
//
// Bound on the H100: operations. At bench_config (x1 = 284, H = 256, two
// block1 and two block3 layers) a row costs ~0.54 MFLOP against ~0.3 KB of
// input, so M = 290,816 rows is ~158 GFLOP: 0.16 ms at the 989 TFLOP/s bf16
// tensor-core peak, 2.4 ms at the 67 TFLOP/s f32 CUDA-core peak.
//
// Design (a first, simple kernel): one CTA of 256 threads per tile of 64
// rows (a multiple of K, so the K-reduction stays in the CTA). The tile's
// activations live in shared memory in two ping-pong buffers; no activation
// ever goes to device memory. Each thread owns 8 rows x H/32 columns of the
// layer output in registers; the 8 warps of a CTA read the same weight
// column block, which stays L1/L2-resident (the weights are < 1.2 MB). The
// products run on CUDA cores in f32, which is what bounds this version: a
// tensor-core (mma/wgmma) version is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;      // rows per CTA
constexpr int kThreads = 256;  // 8 warps; warp r owns rows 8r .. 8r+7
constexpr int kMaxLayers = 8;

struct Net {
  const float* W[kMaxLayers];
  const float* b[kMaxLayers];
};

__device__ __forceinline__ float round_bf16(float v, bool on) {
  return on ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// out[r][col] = act(in[r][:in_dim] @ W[:, col] + b[col]) for the tile.
template <int NJ>
__device__ __forceinline__ void dense_layer(const float* __restrict__ in_s,
                                            int in_dim, int stride,
                                            const float* __restrict__ W,
                                            const float* __restrict__ bias,
                                            int H, float* __restrict__ out_s,
                                            float slope, bool bf16) {
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 8;
  float acc[8][NJ];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.f;
  const float* xr = in_s + r0 * stride;
  for (int k = 0; k < in_dim; ++k) {
    float wv[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) wv[j] = __ldg(W + (size_t)k * H + lane + 32 * j);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float xv = xr[r * stride + k];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[r][j] = fmaf(xv, wv[j], acc[r][j]);
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = lane + 32 * j;
    const float bj = __ldg(bias + col);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float z = acc[r][j] + bj;
      out_s[(r0 + r) * stride + col] = round_bf16(z > 0.f ? z : z * slope, bf16);
    }
  }
}

template <int NJ>
__global__ void __launch_bounds__(kThreads)
fused_decode_kernel(const float* __restrict__ feat,
                    const float* __restrict__ dists,
                    const float* __restrict__ extras,
                    const float* __restrict__ w, Net net, int L1, int L3,
                    const float* __restrict__ wa, const float* __restrict__ ba,
                    int M, int Fi, int Dd, int E, int Ff, int Fd, int H,
                    int K, float slope, int bf16_flag, int stride,
                    float* __restrict__ fagg, float* __restrict__ alpha) {
  extern __shared__ float smem[];
  // ping-pong activation buffers: buf(0) = smem, buf(1) = smem + tile
  auto buf = [&](int i) { return smem + i * kRows * stride; };
  __shared__ float aw_s[kRows];
  const bool bf16 = bf16_flag != 0;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int x1 = Fi + 2 * Ff * Fi + (Fd > 0 ? 2 * Fd * Dd : Dd);

  // x = [feat | PE(feat) | PE(dists)] for the tile's rows (zeros past M)
  for (int i = tid; i < kRows * x1; i += kThreads) {
    const int r = i / x1, c = i - r * x1;
    const int m = row0 + r;
    float v = 0.f;
    if (m < M) {
      if (c < Fi) {
        v = round_bf16(feat[(size_t)m * Fi + c], bf16);
      } else if (c < Fi + 2 * Ff * Fi) {
        const int q = c - Fi;  // (d * Ff + f) * 2 + s
        const int d = q / (2 * Ff), f = (q >> 1) % Ff;
        const float base = round_bf16(feat[(size_t)m * Fi + d], bf16) *
                           (float)(1 << f);
        v = (q & 1) ? cosf(base) : sinf(base);
      } else if (Fd > 0) {
        const int q = c - Fi - 2 * Ff * Fi;
        const int d = q / (2 * Fd), f = (q >> 1) % Fd;
        const float base = round_bf16(dists[(size_t)m * Dd + d], bf16) *
                           (float)(1 << f);
        v = (q & 1) ? cosf(base) : sinf(base);
      } else {
        v = round_bf16(dists[(size_t)m * Dd + (c - Fi - 2 * Ff * Fi)], bf16);
      }
    }
    buf(0)[r * stride + c] = round_bf16(v, bf16);
  }
  __syncthreads();

  int cur = 0, in_dim = x1;
  for (int l = 0; l < L1 + L3; ++l) {
    if (l == L1) {
      // block3 input: [h | extras]
      for (int i = tid; i < kRows * E; i += kThreads) {
        const int r = i / E, c = i - r * E;
        const int m = row0 + r;
        buf(cur)[r * stride + H + c] =
            m < M ? round_bf16(extras[(size_t)m * E + c], bf16) : 0.f;
      }
      __syncthreads();
      in_dim = H + E;
    }
    dense_layer<NJ>(buf(cur), in_dim, stride, net.W[l], net.b[l], H,
                    buf(cur ^ 1), slope, bf16);
    __syncthreads();
    cur ^= 1;
    in_dim = H;
  }

  // alpha head per row (f32) and the weighting of h by w, in place
  {
    const int lane = tid & 31;
    const int r0 = (tid >> 5) * 8;
    float* hs = buf(cur);
    for (int r = 0; r < 8; ++r) {
      const int m = row0 + r0 + r;
      const float wr = m < M ? round_bf16(w[m], bf16) : 0.f;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = lane + 32 * j;
        const float hv = hs[(r0 + r) * stride + col];
        part = fmaf(hv, __ldg(wa + col), part);
        hs[(r0 + r) * stride + col] = hv * wr;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) {
        const float x = part + __ldg(ba) - 1.f;
        const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
        aw_s[r0 + r] = sp * wr;
      }
    }
  }
  __syncthreads();

  // K-sums per shading point
  const int groups = kRows / K;
  const int g0 = row0 / K;
  const int Mk = M / K;
  for (int i = tid; i < groups * H; i += kThreads) {
    const int g = i / H, col = i - g * H;
    if (g0 + g >= Mk) continue;
    float s = 0.f;
    const float* hs = buf(cur);
    for (int k = 0; k < K; ++k) s += hs[(g * K + k) * stride + col];
    fagg[(size_t)(g0 + g) * H + col] = s;
  }
  for (int g = tid; g < groups; g += kThreads) {
    if (g0 + g >= Mk) continue;
    float s = 0.f;
    for (int k = 0; k < K; ++k) s += aw_s[g * K + k];
    alpha[g0 + g] = s;
  }
}

template <int NJ>
int launch(const float* feat, const float* dists, const float* extras,
           const float* w, const Net& net, int L1, int L3, const float* wa,
           const float* ba, int M, int Fi, int Dd, int E, int Ff, int Fd,
           int H, int K, float slope, int bf16, float* fagg, float* alpha,
           cudaStream_t s) {
  const int x1 = Fi + 2 * Ff * Fi + (Fd > 0 ? 2 * Fd * Dd : Dd);
  const int stride = (x1 > H + E ? x1 : H + E) + 1;
  const size_t smem = 2 * (size_t)kRows * stride * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      fused_decode_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + kRows - 1) / kRows);
  fused_decode_kernel<NJ><<<grid, kThreads, smem, s>>>(
      feat, dists, extras, w, net, L1, L3, wa, ba, M, Fi, Dd, E, Ff, Fd, H, K,
      slope, bf16, stride, fagg, alpha);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_decode_launch(const float* feat, const float* dists,
                                   const float* extras, const float* w,
                                   const void* const* Ws,
                                   const void* const* bs, int L1, int L3,
                                   const float* wa, const float* ba, int M,
                                   int Fi, int Dd, int E, int Ff, int Fd,
                                   int H, int K, float slope, int bf16,
                                   float* fagg, float* alpha, void* stream) {
  if (M == 0) return 0;
  if (L1 + L3 > kMaxLayers || H % 32 != 0 || H > 256 || kRows % K != 0)
    return (int)cudaErrorInvalidValue;
  Net net;
  for (int i = 0; i < L1 + L3; ++i) {
    net.W[i] = static_cast<const float*>(Ws[i]);
    net.b[i] = static_cast<const float*>(bs[i]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H / 32) {
#define PNT_CASE(n)                                                          \
  case n:                                                                    \
    return launch<n>(feat, dists, extras, w, net, L1, L3, wa, ba, M, Fi, Dd, \
                     E, Ff, Fd, H, K, slope, bf16, fagg, alpha, s);
    PNT_CASE(1) PNT_CASE(2) PNT_CASE(3) PNT_CASE(4)
    PNT_CASE(5) PNT_CASE(6) PNT_CASE(7) PNT_CASE(8)
#undef PNT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
