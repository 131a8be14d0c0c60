// K3 on tensor cores: the fused decode forward, bf16 route.
//
// Replaces: pointnerf_tpu/ops/pallas_decode.py::fused_decode, forward
// (_fwd_impl -> pallas_call at :404 of _fwd_kernel :205), for DecodeSpec
// with bf16 set. The f32 route keeps csrc/fused_decode.cu.
//
// Function: that of csrc/fused_decode.cu, with its bf16 rounding points:
// feat, dists, extras, w, x and every hidden h are bf16 values, the block
// weights arrive as bf16, the products accumulate in f32, the alpha head is
// an f32 dot against an f32 wa. Tensor cores add no rounding point: every
// operand of a product already is a bf16 value.
//
// Bound on the H100: operations. At bench_config a row costs ~0.55 MFLOP
// (x1 = 284, H = 256, two block1 and two block3 layers); the 131,386 rows
// of the main path that carry a weight are ~72 GFLOP: 0.072 ms at the 989
// TFLOP/s bf16 tensor-core peak. Bytes: ~0.2 KB of input per row and 1.1 MB
// of weights, ~0.03 ms.
//
// Design: one CTA of 8 warps per tile of 64 rows (whole K-groups, so the
// K-sums stay in the CTA). The tile's activations live in shared memory as
// bf16 ([64][kmax + 8]); each layer is a warp-level mma.sync m16n8k16
// product (warp = 16 rows x H/2 columns, f32 accumulators in registers)
// whose epilogue (bias, LeakyReLU, bf16) writes the output back in place
// after a barrier. The weights are streamed in chunks of 32 rows through a
// 3-stage cp.async ring shared by the 8 warps, so the next chunk loads while
// the current one multiplies; each chunk is summed from 0 and added to the
// layer's sum in f32 (see mma_chunk), which keeps the products as close to
// exact as cuBLAS's f32 GEMM. The PE is built by four threads per row, a
// channel at a time (precise sinf / cosf, as the f32 kernels). A tile whose
// rows all have w == 0 writes zeros and exits, decided on the device: the
// main path's padding slots form a tail of whole groups (compact_select puts
// the valid slots first), so 46% of the tiles are never decoded.
#include "decode_tc.cuh"

namespace {

using namespace dtc;

constexpr int kRows = 64;
constexpr int kThreads = 256;
constexpr int kNT = 16;  // n8 tiles per warp: H / 2 <= 128 columns

size_t smem_bytes(const Dims& d) {
  return sizeof(bf16) * ((size_t)kRows * (d.kmax + kPad) +
                         (size_t)kStages * kKC * (d.H + kPad)) +
         sizeof(float) * 2 * kRows;
}

__global__ void __launch_bounds__(kThreads, 1)
fused_decode_tc_fwd(const float* __restrict__ feat,
                    const float* __restrict__ dists,
                    const float* __restrict__ extras,
                    const float* __restrict__ w, const bf16* __restrict__ W,
                    const float* __restrict__ bias,
                    const float* __restrict__ wa,
                    const float* __restrict__ ba, Dims d, float slope,
                    float* __restrict__ fagg, float* __restrict__ alpha) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int H = d.H, K = d.K, M = d.M;
  const int lda = d.kmax + kPad;
  const int stage_elems = kKC * (H + kPad);
  bf16* A = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = A + kRows * lda;
  float* wr_s = reinterpret_cast<float*>(ring + kStages * stage_elems);
  float* aw_s = wr_s + kRows;
  const int row0 = blockIdx.x * kRows;
  const int groups = kRows / K, g0 = row0 / K, Mk = M / K;

  // a tile without weight contributes exactly 0
  int live = 0;
  for (int r = tid; r < kRows; r += kThreads) {
    const int m = row0 + r;
    live |= (m < M && w[m] != 0.f);
  }
  if (!__syncthreads_or(live)) {
    for (int i = tid; i < groups * H; i += kThreads) {
      const int g = g0 + i / H;
      if (g < Mk) fagg[(size_t)g * H + i % H] = 0.f;
    }
    for (int g = tid; g < groups; g += kThreads)
      if (g0 + g < Mk) alpha[g0 + g] = 0.f;
    return;
  }

  for (int c = 0; c < kStages - 1; ++c)
    issue_chunk(d, W, c, false, ring, stage_elems);
  build_x(d, feat, dists, row0, kRows, A, lda);
  for (int r = tid; r < kRows; r += kThreads) {
    const int m = row0 + r;
    wr_s[r] = m < M ? round_bf16(w[m]) : 0.f;
  }

  const int warp = tid >> 5;
  const int arow = (warp & 3) * 16;          // one m16 tile
  const int bn0 = (warp >> 2) * (H / 2);     // H / 16 n8 tiles
  const int ntv = H / 16;
  float acc[1][kNT][4];
  int c = 0;
  for (int l = 0; l < d.L; ++l) {
    zero_acc(acc);
    for (int kk = 0; kk < d.kp[l]; kk += kKC, ++c) {
      const bf16* st = next_chunk(d, W, c, false, ring, stage_elems);
      mma_chunk<1, kNT, true>(acc, ntv, A, lda, arow, kk, st, H + kPad, bn0);
    }
    __syncthreads();  // every warp has read this layer's input
    const float* bl = bias + l * H;
    for_acc(acc, ntv, arow, bn0, [&](int r, int col, float v0, float v1) {
      float z0 = v0 + __ldg(bl + col), z1 = v1 + __ldg(bl + col + 1);
      z0 = z0 > 0.f ? z0 : z0 * slope;
      z1 = z1 > 0.f ? z1 : z1 * slope;
      *reinterpret_cast<__nv_bfloat162*>(A + r * lda + col) =
          __floats2bfloat162_rn(z0, z1);
    });
    if (l == d.L1 - 1) put_extras(d, extras, row0, kRows, A, lda);
    __syncthreads();
  }

  // alpha head per row (f32): warp w takes rows 8w .. 8w + 7
  const int lane = tid & 31;
  for (int r = warp * 8; r < warp * 8 + 8; ++r) {
    float part = 0.f;
    for (int col = lane; col < H; col += 32)
      part = fmaf(__bfloat162float(A[r * lda + col]), __ldg(wa + col), part);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) {
      const float x = part + __ldg(ba) - 1.f;
      const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
      aw_s[r] = sp * wr_s[r];
    }
  }
  __syncthreads();

  // K-sums per shading point
  for (int i = tid; i < groups * H; i += kThreads) {
    const int g = i / H, col = i - g * H;
    if (g0 + g >= Mk) continue;
    float s = 0.f;
    for (int k = 0; k < K; ++k) {
      const int r = g * K + k;
      s = __fadd_rn(s, __fmul_rn(__bfloat162float(A[r * lda + col]), wr_s[r]));
    }
    fagg[(size_t)(g0 + g) * H + col] = s;
  }
  for (int g = tid; g < groups; g += kThreads) {
    if (g0 + g >= Mk) continue;
    float s = 0.f;
    for (int k = 0; k < K; ++k) s += aw_s[g * K + k];
    alpha[g0 + g] = s;
  }
}

}  // namespace

// Shared memory one CTA needs for these dims (0 if the kernel does not
// take them), for the wrapper's envelope check.
extern "C" int fused_decode_tc_smem(int Fi, int Dd, int E, int Ff, int Fd,
                                    int H, int K, int L1, int L3) {
  const Dims d = make_dims(0, Fi, Dd, E, Ff, Fd, H, K, L1, L3);
  return takes(d) ? (int)smem_bytes(d) : 0;
}

extern "C" int fused_decode_tc_launch(const float* feat, const float* dists,
                                      const float* extras, const float* w,
                                      const void* W, const float* bias,
                                      const float* wa, const float* ba, int M,
                                      int Fi, int Dd, int E, int Ff, int Fd,
                                      int H, int K, int L1, int L3,
                                      float slope, float* fagg, float* alpha,
                                      void* stream) {
  const Dims d = make_dims(M, Fi, Dd, E, Ff, Fd, H, K, L1, L3);
  if (!takes(d)) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const size_t smem = smem_bytes(d);
  cudaError_t e = cudaFuncSetAttribute(
      fused_decode_tc_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  fused_decode_tc_fwd<<<(M + kRows - 1) / kRows, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      feat, dists, extras, w, static_cast<const bf16*>(W), bias, wa, ba, d,
      slope, fagg, alpha);
  return (int)cudaGetLastError();
}
