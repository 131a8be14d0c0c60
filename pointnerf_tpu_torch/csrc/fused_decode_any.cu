// K3: fused decode forward, the general route.
//
// Replaces: pointnerf_tpu/ops/pallas_decode.py::fused_decode, forward
// (_fwd_impl -> pallas_call at :404 of _fwd_kernel), for every DecodeSpec
// inside JAX's fused envelope that the tuned kernels (fused_decode_tc.cu,
// bf16; fused_decode.cu, f32) do not take: H not a multiple of 32 or past
// 256, more than 8 block layers, 64 % K != 0, wide layer inputs. JAX's own
// kernel needs only M % K == 0.
//
// Function, per neighbor row m of M = G*K rows (ops/fused_decode.py::
// fused_decode_plain, whose spec.bf16 picks the rounding):
//   x   = [feat | PE(feat) | PE(dists)]
//   h   = leaky(h @ W + b) through block1, then h = [h | extras] and block3
//   za  = h . wa + ba;  alpha_pp = softplus(za - 1)
//   fagg[g]  = sum_k h[g*K+k] * w[g*K+k];  alpha[g] = sum_k alpha_pp * w
//
// Bound on the H100: operations, on the rows that carry a weight: 2 x (sum
// of layer inputs) x H + 2 H flops a row, at 989 TFLOP/s (bf16) or 67 (f32).
// bench_config at H = 512 (x1 = 284): ~1.9 MFLOP a row.
//
// Design (csrc/decode_any.cuh for the plan, the padding and the products):
// the live-group list pass (csrc/decode_live.cuh) writes zeros into a dead
// group's fagg and alpha and lists the groups with a weight, with their
// number in device memory. Persistent CTAs of 256 threads then walk items
// of whole live groups (T / K of them, or one group in ceil(K / T) slabs of
// T rows when K > T): gather the rows, build x in shared memory, run each
// layer through the plan's product (tensor cores, two bf16 activation
// buffers, output blocks of 256 columns; or the CUDA-core register tile, in
// place), then the alpha head (a warp per row, f32) and the weighted
// K-sums from shared memory.
#include "decode_any.cuh"

namespace {

using namespace dany;

// Tensor cores (bf16). W: the packed bf16 weights; bias: [L][Hp], zero past
// H.
__global__ void __launch_bounds__(kThreads, 1)
k3_tc(const float* __restrict__ feat, const float* __restrict__ dists,
      const float* __restrict__ extras, const float* __restrict__ w,
      const bf16* __restrict__ W, const float* __restrict__ bias,
      const float* __restrict__ wa, const float* __restrict__ ba, Dims d,
      float slope, const int* __restrict__ list,
      const int* __restrict__ count, float* __restrict__ fagg,
      float* __restrict__ alpha) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TcShape sh = tc_shape(d, false);
  bf16* A0 = reinterpret_cast<bf16*>(smem_raw);
  bf16* A1 = reinterpret_cast<bf16*>(smem_raw + sh.a1);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + sh.ring);
  float* w_s = reinterpret_cast<float*>(smem_raw + sh.rows);
  float* aw_s = w_s + d.T;
  int* m_s = reinterpret_cast<int*>(aw_s + d.T);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = d.T, H = d.H, Hp = d.Hp;
  const int lda = tc_lda(d), ldb = tc_ldb(d), stage = tc_stage(d, false);
  const int ngroups = *count;
  const int items = d.K <= T ? (ngroups + d.gpt - 1) / d.gpt : ngroups;

  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int ng = d.K <= T ? imin(d.gpt, ngroups - it * d.gpt) : 1;
    for (int s = 0; s < d.slabs; ++s) {
      for (int c = 0; c < kStages - 1; ++c)
        tc_issue(d, W, c, false, ring, stage);
      for (int r = tid; r < T; r += kThreads) {
        const int m = k3_row(d, list, ngroups, it, s, r);
        m_s[r] = m;
        w_s[r] = m >= 0 ? dtc::round_bf16(w[m]) : 0.f;
      }
      __syncthreads();
      build_x<true>(d, feat, dists, m_s, [&](int r, int c, float v) {
        A0[r * lda + c] = __float2bfloat16_rn(v);
      });
      bf16* in = A0;
      bf16* out = A1;
      int c = 0;
      for (int l = 0; l < d.L; ++l) {
        const float* bl = bias + (size_t)l * Hp;
        c = tc_product<true>(
            d, W, false, ring, stage, c, in, lda, kp_of(d, l), Hp, ldb,
            [&](int r, int col, float v0, float v1) {
              float z0 = v0 + __ldg(bl + col), z1 = v1 + __ldg(bl + col + 1);
              z0 = z0 > 0.f ? z0 : z0 * slope;
              z1 = z1 > 0.f ? z1 : z1 * slope;
              *reinterpret_cast<__nv_bfloat162*>(out + r * lda + col) =
                  __floats2bfloat162_rn(z0, z1);
            });
        if (l == d.L1 - 1) {
          __syncthreads();  // the padded columns are written
          put_extras<true>(d, extras, m_s, [&](int r, int cc, float v) {
            out[r * lda + cc] = __float2bfloat16_rn(v);
          });
        }
        bf16* tmp = in; in = out; out = tmp;
      }
      __syncthreads();  // the last layer's h is complete

      // alpha head per row (f32)
      for (int r = warp; r < T; r += kThreads / 32) {
        float part = 0.f;
        for (int col = lane; col < H; col += 32)
          part = fmaf(__bfloat162float(in[r * lda + col]), __ldg(wa + col),
                      part);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (lane == 0) aw_s[r] = softplus(part + __ldg(ba) - 1.f) * w_s[r];
      }
      __syncthreads();
      k_sums(d, list, it * d.gpt, ng, s, w_s, aw_s,
             [&](int r, int col) { return __bfloat162float(in[r * lda + col]); },
             fagg, alpha);
      __syncthreads();  // the tile's buffers are free for the next
    }
  }
  dtc::cp_async_wait<0>();
}

// CUDA cores (f32, or bf16 values with BF16). W: the packed f32 weights
// (forward stream); bias [L][Hp]; ws: the workspace when d.ws.
template <bool BF16>
__global__ void __launch_bounds__(kThreads, 1)
k3_cc(const float* __restrict__ feat, const float* __restrict__ dists,
      const float* __restrict__ extras, const float* __restrict__ w,
      const float* __restrict__ W, const float* __restrict__ bias,
      const float* __restrict__ wa, const float* __restrict__ ba, Dims d,
      float slope, const int* __restrict__ list,
      const int* __restrict__ count, float* __restrict__ ws,
      float* __restrict__ fagg, float* __restrict__ alpha) {
  extern __shared__ __align__(16) float smem_f[];
  const int T = d.T, H = d.H, Hp = d.Hp, LD = cc_ld(T), half = cc_cw(T) / 2;
  const size_t xf = (size_t)d.kmax * LD;
  float* X = d.ws ? ws + (size_t)blockIdx.x * cc_state_floats(d, false)
                  : smem_f;
  float* Xo = d.ws ? X + xf : X;  // in place in shared memory (one pass)
  float* ring = d.ws ? smem_f : smem_f + xf;
  float* w_s = ring + (size_t)kCcStages * kCcKC * cc_cw(T);
  float* aw_s = w_s + T;
  int* m_s = reinterpret_cast<int*>(aw_s + T);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ngroups = *count;
  const int items = d.K <= T ? (ngroups + d.gpt - 1) / d.gpt : ngroups;
  // padding columns and rows the weights multiply by zero must be finite
  for (size_t i = tid; i < (d.ws ? 2 : 1) * xf; i += kThreads) X[i] = 0.f;

  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int ng = d.K <= T ? imin(d.gpt, ngroups - it * d.gpt) : 1;
    for (int s = 0; s < d.slabs; ++s) {
      for (int c = 0; c < kCcStages - 1; ++c) cc_issue(d, W, c, false, ring);
      for (int r = tid; r < T; r += kThreads) {
        const int m = k3_row(d, list, ngroups, it, s, r);
        m_s[r] = m;
        w_s[r] = m >= 0 ? rnd<BF16>(w[m]) : 0.f;
      }
      __syncthreads();
      float* in = X;
      float* out = Xo;
      build_x<BF16>(d, feat, dists, m_s,
                    [&](int r, int c, float v) { in[c * LD + r] = v; });
      int c = 0;
      for (int l = 0; l < d.L; ++l) {
        const float* bl = bias + (size_t)l * Hp;
        c = cc_product(d, W, false, ring, c, in, kp_of(d, l), Hp,
                       [&](float (&acc)[8][8], int cp, int r0, int c0) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = cp + cc_col(c0, j, half);
            if (col < Hp) {
              const float bj = __ldg(bl + col);
              float o[8];
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const float z = acc[i][j] + bj;
                o[i] = rnd<BF16>(z > 0.f ? z : z * slope);
              }
              float* dst = out + (size_t)col * LD + r0;
              *reinterpret_cast<float4*>(dst) =
                  make_float4(o[0], o[1], o[2], o[3]);
              *reinterpret_cast<float4*>(dst + 4) =
                  make_float4(o[4], o[5], o[6], o[7]);
            }
          }
        });
        if (l == d.L1 - 1) {
          __syncthreads();  // the padded columns are written
          put_extras<BF16>(d, extras, m_s, [&](int r, int cc, float v) {
            out[cc * LD + r] = v;
          });
        }
        if (out != in) { float* tmp = in; in = out; out = tmp; }
      }
      __syncthreads();  // the last layer's h is complete

      for (int r = warp; r < T; r += kThreads / 32) {
        float part = 0.f;
        for (int col = lane; col < H; col += 32)
          part = fmaf(in[(size_t)col * LD + r], __ldg(wa + col), part);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (lane == 0) aw_s[r] = softplus(part + __ldg(ba) - 1.f) * w_s[r];
      }
      __syncthreads();
      k_sums(d, list, it * d.gpt, ng, s, w_s, aw_s,
             [&](int r, int col) { return in[(size_t)col * LD + r]; }, fagg,
             alpha);
      __syncthreads();
      if (d.ws) {  // the next slab starts from X
        X = in;
        Xo = out;
      }
    }
  }
  dtc::cp_async_wait<0>();
}

const void* kernel_of(const Dims& d) {
  if (d.kind == kTensorCores) return (const void*)k3_tc;
  return d.bf16 ? (const void*)k3_cc<true> : (const void*)k3_cc<false>;
}

// items a grid can need: the groups of G in items of gpt
int max_items(const Dims& d) {
  return d.K <= d.T ? (d.G + d.gpt - 1) / d.gpt : d.G;
}

int grid_of(const Dims& d, size_t smem, int* grid) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel_of(d), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  *grid = 0;
  if (max_items(d) == 0) return 0;
  return df32::persistent_grid(kernel_of(d), smem, max_items(d), grid);
}

}  // namespace

// The plan of a launch at M rows: out[0..9] = kind (0 tensor cores, 1 CUDA
// cores), rows per tile T, groups per item, slabs per item, shared memory
// bytes, workspace floats per CTA (0: the tile lies in shared memory), grid,
// Hp, kp0, kpE. Nonzero when the dims are not taken.
extern "C" int fused_decode_any_plan(long long M, int Fi, int Dd, int E,
                                     int Ff, int Fd, int H, int K, int L1,
                                     int L3, int use_bf16, int* out) {
  const Dims d = plan(M, Fi, Dd, E, Ff, Fd, H, K, L1, L3, use_bf16, false);
  if (!takes(d)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_need(d, false);
  int grid = 0;
  const int e = grid_of(d, smem, &grid);
  if (e) return e;
  const int v[10] = {d.kind, d.T, d.gpt, d.slabs, (int)smem,
                     d.ws ? (int)cc_state_floats(d, false) : 0, grid, d.Hp,
                     d.kp0, d.kpE};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

// W: the packed weights (ops/fused_decode.pack_any_weights for this plan);
// bias [L][Hp]; flags [G] bytes, counts [ceil(G / 1024)], list [G], count
// [1]: the live list's scratch; ws: grid x the plan's workspace floats (may
// be null when it asked for none); grid: the plan's.
extern "C" int fused_decode_any_launch(
    const float* feat, const float* dists, const float* extras,
    const float* w, const void* W, const float* bias, const float* wa,
    const float* ba, long long M, int Fi, int Dd, int E, int Ff, int Fd,
    int H, int K, int L1, int L3, float slope, int use_bf16, int grid,
    void* flags, int* counts, int* list, int* count, float* ws, float* fagg,
    float* alpha, void* stream) {
  const Dims d = plan(M, Fi, Dd, E, Ff, Fd, H, K, L1, L3, use_bf16, false);
  if (!takes(d)) return (int)cudaErrorInvalidValue;
  if (d.G == 0) return 0;
  if (grid < 1 || (d.ws && ws == nullptr))
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dlive::Owned own{{fagg, alpha, nullptr, nullptr}, {H, 1, 0, 0}};
  cudaError_t e = dlive::build(w, nullptr, nullptr, d.G, K, H, own,
                               static_cast<unsigned char*>(flags), counts,
                               list, count, s);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = smem_need(d, false);
  e = cudaFuncSetAttribute(kernel_of(d),
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (d.kind == kTensorCores)
    k3_tc<<<grid, kThreads, smem, s>>>(
        feat, dists, extras, w, static_cast<const bf16*>(W), bias, wa, ba, d,
        slope, list, count, fagg, alpha);
  else if (d.bf16)
    k3_cc<true><<<grid, kThreads, smem, s>>>(
        feat, dists, extras, w, static_cast<const float*>(W), bias, wa, ba,
        d, slope, list, count, ws, fagg, alpha);
  else
    k3_cc<false><<<grid, kThreads, smem, s>>>(
        feat, dists, extras, w, static_cast<const float*>(W), bias, wa, ba,
        d, slope, list, count, ws, fagg, alpha);
  return (int)cudaGetLastError();
}
