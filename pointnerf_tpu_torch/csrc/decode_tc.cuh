// Shared pieces of the tensor-core decode kernels (fused_decode_tc.cu, K3,
// and fused_decode_bwd_tc.cu, K4) for the bf16 route: warp-level bf16 mma
// (mma.sync m16n8k16, f32 accumulate) fed by ldmatrix from shared memory,
// and a ring of shared-memory stages through which cp.async streams the
// block weights in chunks, shared by every warp of the CTA.
//
// Weights arrive packed by ops/fused_decode.pack_tc_weights as one bf16
// buffer. Layer l's input width in_l is padded with zero rows to kp_l, a
// multiple of kKC. The forward stream holds each W_l as [kp_l][H], row-major,
// layer after layer (chunk j = rows 32j .. 32j + 31, contiguous). The
// backward stream follows it and holds, per layer, the column blocks
// W_l[:, 32j : 32j + 32] as contiguous [kp_l][32] blocks (the B operand of
// g_h = g_z W^T, k-contiguous).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dtc {

typedef __nv_bfloat16 bf16;

constexpr int kMaxLayers = 8;
constexpr int kKC = 32;      // weight rows (the k of a product) per chunk
constexpr int kStages = 3;   // ring depth
constexpr int kMaxIn = 320;  // widest padded layer input the kernels take
constexpr int kPad = 8;      // bf16 row padding in shared memory (16 bytes)

struct Dims {
  int M, Fi, Dd, E, Ff, Fd, H, K, L1, L3, L, x1;
  int in[kMaxLayers];    // input width of each layer
  int kp[kMaxLayers];    // the same padded to a multiple of kKC
  int kmax;              // widest kp
  int foff[kMaxLayers];  // element offset of layer l in the forward stream
  int boff[kMaxLayers];  // element offset of layer l in the backward stream
  int nf;                // forward chunks: sum kp_l / kKC
  // the parameter vector (dW_0, db_0, dW_1, db_1, ..., dwa, dba)
  int pw[kMaxLayers], pb[kMaxLayers], pwa, pba, P;
  int Ps;  // P rounded up to 4: the stride of per-split dW partials
};

inline Dims make_dims(int M, int Fi, int Dd, int E, int Ff, int Fd, int H,
                      int K, int L1, int L3) {
  Dims d{};
  d.M = M; d.Fi = Fi; d.Dd = Dd; d.E = E; d.Ff = Ff; d.Fd = Fd; d.H = H;
  d.K = K; d.L1 = L1; d.L3 = L3; d.L = L1 + L3;
  d.x1 = Fi + 2 * Ff * Fi + (Fd > 0 ? 2 * Fd * Dd : Dd);
  int f = 0, p = 0;
  d.kmax = 0;
  d.nf = 0;
  for (int l = 0; l < d.L && l < kMaxLayers; ++l) {
    d.in[l] = l == 0 ? d.x1 : (l == L1 ? H + E : H);
    d.kp[l] = (d.in[l] + kKC - 1) / kKC * kKC;
    d.kmax = d.kmax > d.kp[l] ? d.kmax : d.kp[l];
    d.foff[l] = f;
    f += d.kp[l] * H;
    d.nf += d.kp[l] / kKC;
    d.pw[l] = p;
    p += d.in[l] * H;
    d.pb[l] = p;
    p += H;
  }
  for (int l = 0; l < d.L && l < kMaxLayers; ++l) d.boff[l] = f + d.foff[l];
  d.pwa = p;
  d.pba = p + H;
  d.P = p + H + 1;
  d.Ps = (d.P + 3) / 4 * 4;
  return d;
}

// the limits every tensor-core decode kernel shares (mirrored by
// ops/fused_decode.kernel_takes for bf16 specs)
inline bool takes(const Dims& d) {
  if (d.L1 < 1 || d.L3 < 1 || d.L > kMaxLayers) return false;
  if (d.H % 32 != 0 || d.H < 32 || d.H > 256 || d.K < 1 || 64 % d.K != 0)
    return false;
  return d.kmax <= kMaxIn;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// acc += part over the ntv valid n8 tiles
template <int MT, int NT>
__device__ __forceinline__ void add_acc(float (&acc)[MT][NT][4],
                                        const float (&part)[MT][NT][4],
                                        int ntv) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < ntv) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
      }
}

// One chunk (k = kKC) of a warp's product: acc[mt][j] += A[rows] . B[:, cols]
// for the warp's MT m16 tiles from row arow and its ntv (even, <= NT) n8
// tiles from column bn0. A is row-major [m][k] in shared memory (row stride
// lda), its k offset acol. B is the chunk in a ring stage: with TB it is
// [k][n] (n contiguous, the forward W), else [n][k] (k contiguous, the
// backward W^T blocks); ldb is its row stride.
// The tensor cores round toward zero as they accumulate, an error that
// grows with the running sum and does not average out; so each chunk sums
// from 0 and joins acc in one IEEE add, which keeps the products about as
// close to their exact value as cuBLAS's f32 GEMM is.
template <int MT, int NT, bool TB>
__device__ __forceinline__ void mma_chunk(float (&acc)[MT][NT][4], int ntv,
                                          const bf16* A, int lda, int arow,
                                          int acol, const bf16* B, int ldb,
                                          int bn0) {
  const int lane = threadIdx.x & 31;
  const int j8 = lane >> 3, r8 = lane & 7;
  float part[MT][NT][4];
  zero_acc(part);
#pragma unroll
  for (int k16 = 0; k16 < kKC / 16; ++k16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm4(a[mt], A + (arow + mt * 16 + r8 + 8 * (j8 & 1)) * lda + acol +
                       k16 * 16 + 8 * (j8 >> 1));
    // every B fragment of this k16 step first, so that the loads are in
    // flight together before the products wait on them
    uint32_t b[NT / 2][4];
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      if (2 * np < ntv) {
        if (TB)
          ldsm4t(b[np], B + (k16 * 16 + r8 + 8 * (j8 & 1)) * ldb + bn0 +
                            np * 16 + 8 * (j8 >> 1));
        else
          ldsm4(b[np], B + (bn0 + np * 16 + r8 + 8 * (j8 >> 1)) * ldb +
                           k16 * 16 + 8 * (j8 & 1));
      }
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      if (2 * np < ntv) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(part[mt][2 * np], a[mt], b[np][0], b[np][1]);
          mma16816(part[mt][2 * np + 1], a[mt], b[np][2], b[np][3]);
        }
      }
    }
  }
  add_acc(acc, part, ntv);
}

// Visit the warp's accumulator as (row, col, v(col), v(col + 1)) pairs:
// f(r, c, v0, v1) for rows arow + ..., columns bn0 + ... (the mma C layout)
template <int MT, int NT, typename F>
__device__ __forceinline__ void for_acc(const float (&acc)[MT][NT][4],
                                        int ntv, int arow, int bn0, F f) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < ntv) {
        const int c = bn0 + j * 8 + 2 * t;
        f(arow + mt * 16 + g, c, acc[mt][j][0], acc[mt][j][1]);
        f(arow + mt * 16 + g + 8, c, acc[mt][j][2], acc[mt][j][3]);
      }
    }
}

// The weight chunks in the order the kernels consume them: the forward
// chunks of layers 0 .. L-1, then (with_bwd) the backward blocks of layers
// L-1 .. 0. Chunk c: its source, rows and columns (0 rows past the end).
__device__ __forceinline__ void chunk_desc(const Dims& d, const bf16* W,
                                           int c, bool with_bwd,
                                           const bf16*& src, int& rows,
                                           int& cols) {
  rows = 0;
  for (int l = 0; l < d.L; ++l) {
    const int n = d.kp[l] / kKC;
    if (c < n) {
      src = W + d.foff[l] + (size_t)c * kKC * d.H;
      rows = kKC;
      cols = d.H;
      return;
    }
    c -= n;
  }
  if (!with_bwd) return;
  for (int l = d.L - 1; l >= 0; --l) {
    const int n = d.H / kKC;
    if (c < n) {
      src = W + d.boff[l] + (size_t)c * d.kp[l] * kKC;
      rows = d.kp[l];
      cols = kKC;
      return;
    }
    c -= n;
  }
}

// Start the copy of chunk c into its ring stage (row stride cols + kPad) and
// commit a group (an empty one past the last chunk, so that every thread
// counts the same groups).
__device__ __forceinline__ void issue_chunk(const Dims& d, const bf16* W,
                                            int c, bool with_bwd, bf16* ring,
                                            int stage_elems) {
  const bf16* src;
  int rows, cols;
  chunk_desc(d, W, c, with_bwd, src, rows, cols);
  if (rows > 0) {
    bf16* dst = ring + (c % kStages) * stage_elems;
    const int per_row = cols / 8;
    const int n = rows * per_row;
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      const int r = p / per_row, q = p - r * per_row;
      cp_async16(dst + r * (cols + kPad) + q * 8, src + (size_t)r * cols + q * 8);
    }
  }
  cp_async_commit();
}

// Wait for chunk c, make it visible to the CTA, and start chunk
// c + kStages - 1 (into the stage chunk c - 1 used, which every thread has
// finished with once past the barrier). Returns chunk c's stage.
__device__ __forceinline__ const bf16* next_chunk(const Dims& d, const bf16* W,
                                                  int c, bool with_bwd,
                                                  bf16* ring,
                                                  int stage_elems) {
  cp_async_wait<kStages - 2>();
  __syncthreads();
  issue_chunk(d, W, c + kStages - 1, with_bwd, ring, stage_elems);
  return ring + (c % kStages) * stage_elems;
}

// x = [feat | PE(feat) | PE(dists)] of `rows` rows from row0 into A (row
// stride lda) as bf16, zero past x1 up to kp0 and on rows past M; the
// rounding points of the f32 kernels: feat and dists rounded before the PE,
// precise sinf / cosf. Four threads share a row and take every fourth
// channel, so no index is divided per element.
__device__ __forceinline__ void build_x(const Dims& d, const float* feat,
                                        const float* dists, int row0,
                                        int rows, bf16* A, int lda) {
  const int Fi = d.Fi, Dd = d.Dd, Ff = d.Ff, Fd = d.Fd, kp0 = d.kp[0];
  const int pe_d = Fi + 2 * Ff * Fi;  // first column of the dists part
  for (int i = threadIdx.x; i < rows * 4; i += blockDim.x) {
    const int r = i >> 2, sub = i & 3;
    const int m = row0 + r;
    bf16* xr = A + r * lda;
    if (m >= d.M) {
      for (int c = sub; c < kp0; c += 4) xr[c] = __float2bfloat16_rn(0.f);
      continue;
    }
    for (int ch = sub; ch < Fi; ch += 4) {
      const float v = round_bf16(feat[(size_t)m * Fi + ch]);
      xr[ch] = __float2bfloat16_rn(v);
      for (int f = 0; f < Ff; ++f) {
        const float b = v * (float)(1 << f);
        xr[Fi + (ch * Ff + f) * 2] = __float2bfloat16_rn(sinf(b));
        xr[Fi + (ch * Ff + f) * 2 + 1] = __float2bfloat16_rn(cosf(b));
      }
    }
    for (int ch = sub; ch < Dd; ch += 4) {
      const float v = round_bf16(dists[(size_t)m * Dd + ch]);
      if (Fd == 0) xr[pe_d + ch] = __float2bfloat16_rn(v);
      for (int f = 0; f < Fd; ++f) {
        const float b = v * (float)(1 << f);
        xr[pe_d + (ch * Fd + f) * 2] = __float2bfloat16_rn(sinf(b));
        xr[pe_d + (ch * Fd + f) * 2 + 1] = __float2bfloat16_rn(cosf(b));
      }
    }
    for (int c = d.x1 + sub; c < kp0; c += 4) xr[c] = __float2bfloat16_rn(0.f);
  }
}

// the block3 input's tail: extras (rounded) in columns H .. H+E-1, zeros up
// to kp of layer L1
__device__ __forceinline__ void put_extras(const Dims& d, const float* extras,
                                           int row0, int rows, bf16* A,
                                           int lda) {
  const int w = d.kp[d.L1] - d.H;
  for (int i = threadIdx.x; i < rows * w; i += blockDim.x) {
    const int r = i / w, c = i - r * w;
    const int m = row0 + r;
    const float v = (m < d.M && c < d.E) ? extras[(size_t)m * d.E + c] : 0.f;
    A[r * lda + d.H + c] = __float2bfloat16_rn(v);
  }
}

}  // namespace dtc
