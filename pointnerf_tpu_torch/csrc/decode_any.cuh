// Shared pieces of the general decode kernels (fused_decode_any.cu, K3, and
// fused_decode_bwd_any.cu, K4): the dims of any spec, the tile size, the
// placement of a tile's state, the input gather and the layer product.
//
// These kernels take every spec inside the fused envelope: any Fi, Dd, E,
// Ff, Fd >= 0, H >= 1, L1, L3 >= 1 and any K dividing M. A CTA of 256
// threads walks tiles of whole K-groups (kRows / K groups, or one group
// when K > kRows) and keeps a tile's state (activations and per-row
// values) in one float region S. S lies in shared memory when it fits one
// block's, else in a slice of a global workspace, one slice per CTA; the
// code is the same.
//
// Products run on the CUDA cores as exact f32 FMAs (k ascending). A
// thread owns one output column and up to 8 rows of a 64-row block, so the
// 8 warps read one activation per FMA from S (a broadcast: a warp's lanes
// share their row) and each weight once per 8 FMAs, straight from global
// memory through L1 and L2 (the block weights are read as the wrapper
// packs them: W_l [in_l][H] row-major, and for K4 also W_l^T [H][in_l]).
//
// Rounding: with BF16 the inputs (feat, dists, extras, w), x and every
// hidden activation round to bf16 values and the block weights arrive as
// bf16 values, so each product is exact and sums in f32: the function of
// ops/fused_decode.fused_decode_plain with spec.bf16. Without BF16 nothing
// rounds.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dany {

constexpr int kThreads = 256;
constexpr int kRows = 64;               // rows per tile when K divides it
constexpr int kSmemMax = 232448;        // the dynamic shared memory of a block

struct Dims {
  long long M;
  int G, Fi, Dd, E, Ff, Fd, H, K, L1, L3, L, x1;
  int T;      // rows per tile: whole groups
  int gpt;    // groups per tile
  int ld;     // row stride of the activation buffers: max layer input, >= H
  int ntiles;
  long long P;  // floats of all dW, db, dwa, dba
};

__host__ __device__ inline int layer_in(const Dims& d, int l) {
  return l == 0 ? d.x1 : (l == d.L1 ? d.H + d.E : d.H);
}

inline Dims make_dims(long long M, int Fi, int Dd, int E, int Ff, int Fd,
                      int H, int K, int L1, int L3) {
  Dims d{};
  d.M = M; d.Fi = Fi; d.Dd = Dd; d.E = E; d.Ff = Ff; d.Fd = Fd; d.H = H;
  d.K = K; d.L1 = L1; d.L3 = L3; d.L = L1 + L3;
  d.G = K > 0 ? (int)(M / K) : 0;
  d.x1 = Fi + 2 * Ff * Fi + (Fd > 0 ? 2 * Fd * Dd : Dd);
  d.gpt = K > 0 && K <= kRows ? kRows / K : 1;
  d.T = d.gpt * K;
  d.ld = d.x1 > H + E ? d.x1 : H + E;
  d.ntiles = d.G > 0 ? (d.G + d.gpt - 1) / d.gpt : 0;
  long long p = 0;
  for (int l = 0; l < d.L; ++l) p += (long long)layer_in(d, l) * H + H;
  d.P = p + H + 1;
  return d;
}

inline bool takes(const Dims& d) {
  return d.Fi >= 0 && d.Dd >= 0 && d.E >= 0 && d.Ff >= 0 && d.Fd >= 0 &&
         d.H >= 1 && d.K >= 1 && d.L1 >= 1 && d.L3 >= 1 && d.M % d.K == 0;
}

// float offset of W_l in the forward stream, and of db_l / dW_l in the
// parameter vector (dW_0, db_0, dW_1, db_1, ..., dwa, dba)
__host__ __device__ inline long long wf_off(const Dims& d, int l) {
  long long o = 0;
  for (int i = 0; i < l; ++i) o += (long long)layer_in(d, i) * d.H;
  return o;
}
__host__ __device__ inline long long pw_off(const Dims& d, int l) {
  long long o = 0;
  for (int i = 0; i < l; ++i) o += (long long)layer_in(d, i) * d.H + d.H;
  return o;
}

// the placement of a tile's state of `floats` floats: shared memory when
// it fits, else a global workspace slice per CTA
inline bool in_smem(long long floats) {
  return floats * 4 <= kSmemMax;
}

inline int sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// x of `rows` rows from row m0: [feat | PE(feat) | PE(dists)] (dists as
// they are when Fd == 0), PE interleaved (sin, cos) per (channel, freq) as
// ops/pe.py, into X [rows][ldx].
template <bool BF16>
__device__ void build_x(const Dims& d, const float* __restrict__ feat,
                        const float* __restrict__ dists, long long m0,
                        int rows, float* X, int ldx) {
  const int npe = 2 * d.Ff * d.Fi;
  const int off = d.Fi + npe;
  for (int i = threadIdx.x; i < rows * d.x1; i += kThreads) {
    const int r = i / d.x1, j = i - r * d.x1;
    const long long m = m0 + r;
    float v;
    if (j < d.Fi) {
      v = rnd<BF16>(feat[m * d.Fi + j]);
    } else if (j < off) {
      const int q = j - d.Fi, ch = q / (2 * d.Ff), f = (q >> 1) % d.Ff;
      const float b = rnd<BF16>(feat[m * d.Fi + ch]) * (float)(1 << f);
      v = (q & 1) ? cosf(b) : sinf(b);
    } else if (d.Fd > 0) {
      const int q = j - off, ch = q / (2 * d.Fd), f = (q >> 1) % d.Fd;
      const float b = rnd<BF16>(dists[m * d.Dd + ch]) * (float)(1 << f);
      v = (q & 1) ? cosf(b) : sinf(b);
    } else {
      v = rnd<BF16>(dists[m * d.Dd + (j - off)]);
    }
    X[r * ldx + j] = rnd<BF16>(v);
  }
}

// The extras of `rows` rows into columns [H, H + E) of X [rows][ldx].
template <bool BF16>
__device__ void put_extras(const Dims& d, const float* __restrict__ extras,
                           long long m0, int rows, float* X, int ldx) {
  for (int i = threadIdx.x; i < rows * d.E; i += kThreads) {
    const int r = i / d.E, e = i - r * d.E;
    X[r * ldx + d.H + e] = rnd<BF16>(extras[(m0 + r) * d.E + e]);
  }
}

// C[r][c] = A[r][:nin] . B[:nin][c] for r < rows, c < nout; B row-major in
// global memory. With bias: z = C + bias[c]; the z > 0 bits go to sign
// [rows][nout] when given, and C = rnd(leaky(z)).
template <bool BF16>
__device__ void product(const float* A, int lda, int nin,
                        const float* __restrict__ B, int nout, int rows,
                        float* C, int ldc, const float* __restrict__ bias,
                        float slope, unsigned char* sign) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r0 = 0; r0 < rows; r0 += kRows) {
    int nr = rows - r0 - ty;
    nr = nr > 0 ? (nr + 7) >> 3 : 0;
    if (nr > 8) nr = 8;
    const float* a = A + (long long)(r0 + ty) * lda;
    for (int c0 = 0; c0 < nout; c0 += 32) {
      const int c = c0 + tx;
      const bool cv = c < nout;
      float acc[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.f;
      for (int k = 0; k < nin; ++k) {
        const float bv = cv ? __ldg(B + (long long)k * nout + c) : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (i < nr) acc[i] = fmaf(a[(long long)i * 8 * lda + k], bv, acc[i]);
      }
      if (!cv) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i >= nr) break;
        const int r = r0 + ty + 8 * i;
        float v = acc[i];
        if (bias != nullptr) {
          const float z = v + __ldg(bias + c);
          if (sign != nullptr) sign[(long long)r * nout + c] = z > 0.f;
          v = rnd<BF16>(z > 0.f ? z : z * slope);
        }
        C[(long long)r * ldc + c] = v;
      }
    }
  }
}

}  // namespace dany
