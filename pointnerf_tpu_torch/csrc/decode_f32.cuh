// Shared pieces of the f32 decode kernels (fused_decode.cu, K3, and
// fused_decode_bwd.cu, K4) on the CUDA cores: the dims, the register-tiled
// f32 product, the cp.async ring that streams the block weights through
// shared memory, and the gather of a tile's rows from the live-group list.
//
// A tile is kRows rows. Its activations live in shared memory transposed,
// X[c][r] (row stride kLds = kRows + 4), so that a thread reads its 8 rows
// at one k as two float4. 256 threads each own 8 rows x 8 columns of a
// 64 x 256 product: warp w takes rows (w & 1) * 32 + 8 * (lane >> 3) and
// columns 4 * ((w >> 1) * 8 + (lane & 7)) and the same + 128, so every k
// step is 4 shared-memory float4 loads for 64 exact f32 FMAs.
//
// The block weights arrive packed by ops/fused_decode.pack_f32_weights as
// one f32 buffer. The forward stream holds each W_l [in_l, H] zero-padded to
// [kp_l][H] (kp_l: in_l rounded up to kPadK), layer after layer; the
// backward stream (K4) follows it and holds each W_l^T as [H][kq_l] (kq_l:
// in_l rounded up to 4, zero columns). A ring of ST shared-memory stages
// streams chunks of KC rows (KC divides kPadK and 32) by at most kBN
// columns in the order the kernels consume them: the forward chunks of
// layers 0 .. L-1, then for layers L-1 .. 0 the backward chunks, column
// block after column block. K3 takes 2 stages of 16 rows, K4 3 of 8.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace df32 {

constexpr int kMaxLayers = 8;
constexpr int kRows = 64;          // rows per tile
constexpr int kLds = kRows + 4;    // row stride of the transposed tiles
constexpr int kThreads = 256;
constexpr int kPadK = 16;          // forward weight rows pad to this
constexpr int kBN = 256;           // columns of a ring stage

struct Dims {
  int G, Fi, Dd, E, Ff, Fd, H, K, L1, L3, L, x1;
  int in[kMaxLayers];   // input width of each layer
  int kp[kMaxLayers];   // the same padded to kPadK: forward stream rows
  int kq[kMaxLayers];   // the same padded to 4: columns of W^T, scratch rows
  int kmax;             // widest kp
  size_t foff[kMaxLayers];  // float offset of W_l in the packed weights
  size_t boff[kMaxLayers];  // float offset of W_l^T
  // the parameter vector (dW_0, db_0, dW_1, db_1, ..., dwa, dba)
  int pw[kMaxLayers], pb[kMaxLayers], pwa, pba, P;
  int Ps;  // P rounded up to 4: the stride of per-split dW partials
};

inline Dims make_dims(int M, int Fi, int Dd, int E, int Ff, int Fd, int H,
                      int K, int L1, int L3) {
  Dims d{};
  d.Fi = Fi; d.Dd = Dd; d.E = E; d.Ff = Ff; d.Fd = Fd; d.H = H;
  d.K = K; d.L1 = L1; d.L3 = L3; d.L = L1 + L3;
  d.G = K > 0 ? M / K : 0;
  d.x1 = Fi + 2 * Ff * Fi + (Fd > 0 ? 2 * Fd * Dd : Dd);
  size_t f = 0;
  int p = 0;
  for (int l = 0; l < d.L && l < kMaxLayers; ++l) {
    d.in[l] = l == 0 ? d.x1 : (l == L1 ? H + E : H);
    d.kp[l] = (d.in[l] + kPadK - 1) / kPadK * kPadK;
    d.kq[l] = (d.in[l] + 3) / 4 * 4;
    d.kmax = d.kmax > d.kp[l] ? d.kmax : d.kp[l];
    d.foff[l] = f;
    f += (size_t)d.kp[l] * H;
    d.pw[l] = p;
    p += d.in[l] * H;
    d.pb[l] = p;
    p += H;
  }
  for (int l = 0; l < d.L && l < kMaxLayers; ++l) {
    d.boff[l] = f;
    f += (size_t)H * d.kq[l];
  }
  d.pwa = p;
  d.pba = p + H;
  d.P = p + H + 1;
  d.Ps = (d.P + 3) / 4 * 4;
  return d;
}

// the limits both f32 kernels share (mirrored by
// ops/fused_decode.kernel_takes for f32 specs; each kernel also needs its
// shared memory within one block's)
inline bool takes(const Dims& d) {
  return d.L1 >= 1 && d.L3 >= 1 && d.L <= kMaxLayers && d.H % 32 == 0 &&
         d.H >= 32 && d.H <= kBN && d.K >= 1 && kRows % d.K == 0;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// the same, or 16 zero bytes when !valid (src is not read)
__device__ __forceinline__ void cp_async16_or_zero(void* dst, const void* src,
                                                   bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the thread's first row and first column of a 64 x 256 product
__device__ __forceinline__ int tile_r0() {
  return (threadIdx.x >> 5 & 1) * 32 + 8 * ((threadIdx.x & 31) >> 3);
}
__device__ __forceinline__ int tile_c0() {
  return 4 * ((threadIdx.x >> 6) * 8 + (threadIdx.x & 7));
}
// column j (0 .. 7) of the thread's 8
__device__ __forceinline__ int tile_col(int c0, int j) {
  return c0 + (j & 3) + (j >> 2) * 128;
}

__device__ __forceinline__ void zero8x8(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_{k < KC} A[k * lda + r0 + i] * B[k * ldb + col(j)]: the
// thread's 8 rows of A (k-major in shared memory) times its 8 columns of B
// (a ring stage or a staged tile, k-major), exact f32 FMAs
template <int KC>
__device__ __forceinline__ void mm(float (&acc)[8][8],
                                   const float* __restrict__ A, int lda,
                                   const float* __restrict__ B, int ldb,
                                   int r0, int c0) {
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + k * lda + r0);
    const float4 a1 = *reinterpret_cast<const float4*>(A + k * lda + r0 + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(B + k * ldb + c0);
    const float4 b1 = *reinterpret_cast<const float4*>(B + k * ldb + c0 + 128);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Chunk c of the weight stream: KC rows of `cols` floats, row stride
// `stride`, from `src`. False past the last chunk.
template <int KC>
__device__ __forceinline__ bool chunk_at(const Dims& d, const float* W, int c,
                                         bool with_bwd, const float*& src,
                                         int& cols, int& stride) {
  for (int l = 0; l < d.L; ++l) {
    const int n = d.kp[l] / KC;
    if (c < n) {
      src = W + d.foff[l] + (size_t)c * KC * d.H;
      cols = d.H;
      stride = d.H;
      return true;
    }
    c -= n;
  }
  if (!with_bwd) return false;
  const int nk = d.H / KC;
  for (int l = d.L - 1; l >= 0; --l) {
    const int nb = (d.kq[l] + kBN - 1) / kBN;
    if (c < nb * nk) {
      const int cb = c / nk, kk = (c - cb * nk) * KC;
      src = W + d.boff[l] + (size_t)kk * d.kq[l] + cb * kBN;
      cols = d.kq[l] - cb * kBN < kBN ? d.kq[l] - cb * kBN : kBN;
      stride = d.kq[l];
      return true;
    }
    c -= nb * nk;
  }
  return false;
}

// Start the copy of chunk c into its ring stage and commit a group (an
// empty one past the last chunk, so that every thread counts the same).
// Thread t copies float4 column t % 64 of rows t / 64, + 4, ...
template <int KC, int ST>
__device__ __forceinline__ void issue_chunk(const Dims& d, const float* W,
                                            int c, bool with_bwd,
                                            float* ring) {
  static_assert(kThreads == 4 * (kBN / 4), "a pass copies 4 stage rows");
  const float* src;
  int cols, stride;
  const int q = threadIdx.x & (kBN / 4 - 1);
  if (chunk_at<KC>(d, W, c, with_bwd, src, cols, stride) && 4 * q < cols) {
    float* dst = ring + (c % ST) * KC * kBN + 4 * q;
    src += 4 * q;
#pragma unroll
    for (int r = threadIdx.x / (kBN / 4); r < KC; r += 4)
      cp_async16(dst + r * kBN, src + (size_t)r * stride);
  }
  cp_async_commit();
}

// Wait for chunk c, make it visible to the CTA, and start chunk c + ST - 1
// into the stage chunk c - 1 used (every thread is done with it once past
// the barrier). Returns chunk c's stage.
template <int KC, int ST>
__device__ __forceinline__ const float* next_chunk(const Dims& d,
                                                   const float* W, int c,
                                                   bool with_bwd,
                                                   float* ring) {
  cp_async_wait<ST - 2>();
  __syncthreads();
  issue_chunk<KC, ST>(d, W, c + ST - 1, with_bwd, ring);
  return ring + (c % ST) * KC * kBN;
}

// x = [feat | PE(feat) | PE(dists)] of the tile's rows into X (transposed),
// zero from x1 up to kp_0 and on rows without a source (m_s[r] < 0); precise
// sinf / cosf, as the plain version. Four threads share a row and take
// every fourth channel.
__device__ __forceinline__ void build_x(const Dims& d, const float* feat,
                                        const float* dists, const int* m_s,
                                        float* X) {
  const int Fi = d.Fi, Dd = d.Dd, Ff = d.Ff, Fd = d.Fd, kp0 = d.kp[0];
  const int pe_d = Fi + 2 * Ff * Fi;  // first column of the dists part
  for (int i = threadIdx.x; i < kRows * 4; i += kThreads) {
    const int r = i >> 2, sub = i & 3;
    const int m = m_s[r];
    if (m < 0) {
      for (int c = sub; c < kp0; c += 4) X[c * kLds + r] = 0.f;
      continue;
    }
    for (int ch = sub; ch < Fi; ch += 4) {
      const float v = feat[(size_t)m * Fi + ch];
      X[ch * kLds + r] = v;
      for (int f = 0; f < Ff; ++f) {
        const float b = v * (float)(1 << f);
        X[(Fi + (ch * Ff + f) * 2) * kLds + r] = sinf(b);
        X[(Fi + (ch * Ff + f) * 2 + 1) * kLds + r] = cosf(b);
      }
    }
    for (int ch = sub; ch < Dd; ch += 4) {
      const float v = dists[(size_t)m * Dd + ch];
      if (Fd == 0) X[(pe_d + ch) * kLds + r] = v;
      for (int f = 0; f < Fd; ++f) {
        const float b = v * (float)(1 << f);
        X[(pe_d + (ch * Fd + f) * 2) * kLds + r] = sinf(b);
        X[(pe_d + (ch * Fd + f) * 2 + 1) * kLds + r] = cosf(b);
      }
    }
    for (int c = d.x1 + sub; c < kp0; c += 4) X[c * kLds + r] = 0.f;
  }
}

// the block3 input's tail: extras in columns H .. H+E-1 of X, zeros up to
// kp of layer L1 (and on rows without a source)
__device__ __forceinline__ void put_extras(const Dims& d, const float* extras,
                                           const int* m_s, float* X) {
  const int w = d.kp[d.L1] - d.H;
  for (int i = threadIdx.x; i < kRows * w; i += kThreads) {
    const int c = i / kRows, r = i - c * kRows;
    const int m = m_s[r];
    X[(d.H + c) * kLds + r] =
        (m >= 0 && c < d.E) ? extras[(size_t)m * d.E + c] : 0.f;
  }
}

// One layer's forward product for the tile: acc = X[:kp_l] . W_l, the
// weights through the ring from chunk c on; returns the next chunk.
template <int KC, int ST>
__device__ __forceinline__ int forward_product(const Dims& d, const float* W,
                                               int l, int c, bool with_bwd,
                                               const float* X, float* ring,
                                               float (&acc)[8][8], int r0,
                                               int c0) {
  zero8x8(acc);
  for (int kk = 0; kk < d.kp[l]; kk += KC, ++c) {
    const float* st = next_chunk<KC, ST>(d, W, c, with_bwd, ring);
    mm<KC>(acc, X + kk * kLds, kLds, st, kBN, r0, c0);
  }
  return c;
}

// The grid of a persistent kernel: as many CTAs as fit on the card at once,
// at most max_tiles.
inline int persistent_grid(const void* kernel, size_t smem, int max_tiles,
                           int* grid) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int n = per_sm * sms;
  *grid = n < max_tiles ? n : max_tiles;
  return 0;
}

// Zero the activation tile once, so that padding rows the weights multiply
// by zero never hold a NaN pattern left in shared memory.
__device__ __forceinline__ void zero_tile(float* X, int rows) {
  for (int i = threadIdx.x; i < rows * kLds; i += kThreads) X[i] = 0.f;
}

}  // namespace df32
