// K3: fused decode forward, f32 route, on the CUDA cores.
//
// Replaces: pointnerf_tpu/ops/pallas_decode.py::fused_decode, forward
// (_fwd_impl -> pallas_call at :404 of _fwd_kernel, _forward_tile,
// _build_x), called from pointnerf_tpu/models/aggregator.py::aggregate when
// agg.fused_decode is set, for DecodeSpec with bf16 unset. The bf16 route,
// with the JAX kernel's rounding points, is csrc/fused_decode_tc.cu.
//
// Function, per neighbor row m of M = G*K rows:
//   x   = [feat | PE(feat) | PE(dists)]    interleaved (sin, cos) per
//                                          (channel, freq), as ops/pe.py
//   h   = leaky(h @ W + b) through block1, then h = [h | extras] and block3
//   za  = h . wa + ba;  alpha_pp = softplus(za - 1)
//   fagg[g]  = sum_k h[g*K+k] * w[g*K+k];  alpha[g] = sum_k alpha_pp * w
// No value is rounded: every product is an exact f32 FMA on the CUDA cores
// (TF32 tensor cores would add a rounding point).
//
// Bound on the H100: operations, counted on the rows that carry a weight
// (a row costs 2 * (sum of layer inputs) * H + 2 * H flops, ~0.54 MFLOP at
// x1 = 284, H = 256, two block1 and two block3 layers), at the 67 TFLOP/s
// f32 CUDA-core peak. bench_config: 131,386 of 290,816 rows, ~71 GFLOP,
// 1.06 ms. The dataset path at scene_config() (PERF.md §6): a train step,
// 25,666 of 2,304,000 rows, 13.9 GFLOP, 0.21 ms; an 800 x 800 eval chunk,
// 294,008 of 5,898,240 rows, 160 GFLOP, 2.38 ms. Bytes (the weighted rows'
// inputs read once, fagg and alpha written once) stay under these.
//
// Design. A group is decoded only when it is live (csrc/decode_live.cuh):
// the list pass writes zeros into a dead group's fagg and alpha and lists
// the live groups in order, with their number in device memory. Dense rows
// are laid out [R, SR, K], so live slots lie scattered over every ray's
// slots: the list, not a test per tile, is what skips the dead rows. Then
// persistent CTAs of 256 threads, two per SM (16 warps), walk tiles of
// 64 / K live groups (64 rows) from the list: gather the rows (size_t
// indexing), build x transposed in shared memory, and run each layer as a
// register-tiled product (a thread owns 8 rows x 8 columns, 4 float4 loads
// from shared memory per 64 FMAs) whose weights stream through a 2-stage
// cp.async ring of 16-row chunks (one barrier per 16 k steps), so the inner
// loop never waits on L1/L2.
// Each layer's output overwrites its input in place after a barrier; the
// alpha head and the weighted K-sums read the last layer from shared
// memory.
#include "decode_f32.cuh"
#include "decode_live.cuh"

namespace {

using namespace df32;

constexpr int kKC = 16;    // weight rows per ring chunk
constexpr int kStages = 2;  // ring depth

size_t smem_bytes(const Dims& d) {
  return sizeof(float) * ((size_t)d.kmax * kLds + (size_t)kStages * kKC * kBN +
                          3 * kRows);
}

__global__ void __launch_bounds__(kThreads, 2)
fused_decode_f32(const float* __restrict__ feat,
                 const float* __restrict__ dists,
                 const float* __restrict__ extras,
                 const float* __restrict__ w, const float* __restrict__ W,
                 const float* __restrict__ bias,
                 const float* __restrict__ wa, const float* __restrict__ ba,
                 Dims d, float slope, const int* __restrict__ list,
                 const int* __restrict__ count, float* __restrict__ fagg,
                 float* __restrict__ alpha) {
  extern __shared__ __align__(16) float smem[];
  float* X = smem;                                // [kmax][kLds]
  float* ring = X + d.kmax * kLds;                // [kStages][kKC][kBN]
  float* w_s = ring + kStages * kKC * kBN;        // [kRows]
  float* aw_s = w_s + kRows;                      // [kRows]
  int* m_s = reinterpret_cast<int*>(aw_s + kRows);  // [kRows], -1: none
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = d.H, K = d.K;
  const int gpt = kRows / K;  // groups per tile
  const int ng = *count;
  const int ntiles = (ng + gpt - 1) / gpt;
  const int r0 = tile_r0(), c0 = tile_c0();
  zero_tile(X, d.kmax);

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    for (int c = 0; c < kStages - 1; ++c)
      issue_chunk<kKC, kStages>(d, W, c, false, ring);
    for (int r = tid; r < kRows; r += kThreads) {
      const int gi = t * gpt + r / K;
      const int m = gi < ng ? list[gi] * K + r % K : -1;
      m_s[r] = m;
      w_s[r] = m >= 0 ? w[m] : 0.f;
    }
    __syncthreads();
    build_x(d, feat, dists, m_s, X);

    float acc[8][8];
    int c = 0;
    for (int l = 0; l < d.L; ++l) {
      c = forward_product<kKC, kStages>(d, W, l, c, false, X, ring, acc, r0,
                                        c0);
      __syncthreads();  // every warp has read this layer's input
      const float* bl = bias + l * H;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tile_col(c0, j);
        if (col < H) {
          const float bj = __ldg(bl + col);
          float o[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float z = acc[i][j] + bj;
            o[i] = z > 0.f ? z : z * slope;
          }
          float* dst = X + col * kLds + r0;
          *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
          *reinterpret_cast<float4*>(dst + 4) =
              make_float4(o[4], o[5], o[6], o[7]);
        }
      }
      if (l == d.L1 - 1) put_extras(d, extras, m_s, X);
      __syncthreads();
    }

    // alpha head per row (warp w takes rows 8w .. 8w + 7)
    for (int r = warp * 8; r < warp * 8 + 8; ++r) {
      float part = 0.f;
      for (int col = lane; col < H; col += 32)
        part = fmaf(X[col * kLds + r], __ldg(wa + col), part);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) {
        const float x = part + __ldg(ba) - 1.f;
        const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
        aw_s[r] = sp * w_s[r];
      }
    }
    __syncthreads();

    // the weighted K-sums of the tile's live groups
    for (int i = tid; i < gpt * H; i += kThreads) {
      const int gl = i / H, col = i - gl * H;
      const int gi = t * gpt + gl;
      if (gi >= ng) continue;
      float s = 0.f;
      for (int k = 0; k < K; ++k)
        s += X[col * kLds + gl * K + k] * w_s[gl * K + k];
      fagg[(size_t)list[gi] * H + col] = s;
    }
    for (int gl = tid; gl < gpt; gl += kThreads) {
      const int gi = t * gpt + gl;
      if (gi >= ng) continue;
      float s = 0.f;
      for (int k = 0; k < K; ++k) s += aw_s[gl * K + k];
      alpha[list[gi]] = s;
    }
    __syncthreads();  // the tile's buffers are free for the next
  }
  cp_async_wait<0>();
}

}  // namespace

// Shared memory of one CTA for these dims (0 if the kernel does not take
// them), for the wrapper's envelope check.
extern "C" int fused_decode_smem(int Fi, int Dd, int E, int Ff, int Fd, int H,
                                 int K, int L1, int L3) {
  const Dims d = make_dims(0, Fi, Dd, E, Ff, Fd, H, K, L1, L3);
  return takes(d) ? (int)smem_bytes(d) : 0;
}

// The live-group list alone (K3's rule with gf == ga == null, K4's rule
// otherwise): flags [G] bytes, counts [ceil(G / 1024)], list [G], count [1].
extern "C" int fused_decode_live(const float* w, const float* gf,
                                 const float* ga, int G, int K, int H,
                                 void* flags, int* counts, int* list,
                                 int* count, void* stream) {
  dlive::Owned none{};
  return (int)dlive::build(w, gf, ga, G, K, H, none,
                           static_cast<unsigned char*>(flags), counts, list,
                           count, static_cast<cudaStream_t>(stream));
}

// W: the packed weights (pack_f32_weights, forward stream); bias: [L][H];
// flags/counts/list/count: the list's scratch, as fused_decode_live.
extern "C" int fused_decode_launch(const float* feat, const float* dists,
                                   const float* extras, const float* w,
                                   const float* W, const float* bias,
                                   const float* wa, const float* ba, int M,
                                   int Fi, int Dd, int E, int Ff, int Fd,
                                   int H, int K, int L1, int L3, float slope,
                                   void* flags, int* counts, int* list,
                                   int* count, float* fagg, float* alpha,
                                   void* stream) {
  const Dims d = make_dims(M, Fi, Dd, E, Ff, Fd, H, K, L1, L3);
  if (!takes(d)) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dlive::Owned own{{fagg, alpha, nullptr, nullptr}, {H, 1, 0, 0}};
  cudaError_t e = dlive::build(w, nullptr, nullptr, d.G, K, H, own,
                               static_cast<unsigned char*>(flags), counts,
                               list, count, s);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = smem_bytes(d);
  e = cudaFuncSetAttribute(fused_decode_f32,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int gpt = kRows / K;
  int grid = 0;
  int err = persistent_grid((const void*)fused_decode_f32, smem,
                            (d.G + gpt - 1) / gpt, &grid);
  if (err) return err;
  if (grid == 0) return 0;
  fused_decode_f32<<<grid, kThreads, smem, s>>>(feat, dists, extras, w, W,
                                                bias, wa, ba, d, slope, list,
                                                count, fagg, alpha);
  return (int)cudaGetLastError();
}
