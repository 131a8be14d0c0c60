// Shared pieces of the general decode kernels (fused_decode_any.cu, K3, and
// fused_decode_bwd_any.cu, K4): the dims and the tile plan of any spec,
// the padded layouts, the weight rings, the row gather from the live-group
// list and the two products.
//
// These kernels take every spec inside the fused envelope: any Fi, Dd, E,
// Ff, Fd >= 0, H >= 1, L1, L3 >= 1 and any K dividing M. They decode only
// the live groups of a list built on the device (csrc/decode_live.cuh), as
// the tuned f32 kernels do, in both roundings.
//
// Two products, picked by the plan (`plan`):
//  - tensor cores (bf16): warp-level mma.sync m16n8k16 fed by ldmatrix, the
//    pieces of decode_tc.cuh. A tile's activations are bf16 in shared
//    memory, row-major [T][kmax + 8], two buffers (each layer reads one and
//    writes the other). The output columns go in blocks of at most 256, a
//    warp's share of a block in its registers (16 rows x at most 128
//    columns), so H = 512 keeps its accumulators in registers too. The
//    block weights stream through a 3-stage cp.async ring of 32-row chunks
//    shared by the 8 warps.
//  - CUDA cores (f32, exact FMAs, no TF32): a register tile of 8 rows x 8
//    columns a thread over activations kept transposed in shared memory
//    ([kmax][T + 4]), the weights through a 3-stage cp.async ring of 8-row
//    chunks, as decode_f32.cuh. One pass of the CTA covers 16384 / T
//    columns, so a layer writes its output in place. With BF16 the same
//    kernels round where the bf16 function rounds (x, every hidden h, every
//    g_z to bf16 values; products of bf16 values are exact in f32): that is
//    the one case that keeps a global workspace, below.
//
// Padding. Every layer width is padded to the product's granularity (32 on
// the tensor cores, 16 on the CUDA cores): H to Hp with zero weight columns
// and zero bias (a padded column is leaky(0) = 0 and feeds zero weight rows
// of the next layer), each layer input in_l to kp_l with zero weight rows.
// The block3 input keeps [h | extras] at columns [0, H) and [H, H + E), as
// the parameters hold it. The alpha head reads the first H columns and
// only those of fagg are written. A tile of T rows holds whole groups where
// K <= T (T / K groups; K = 6 at T = 64 takes 10 groups = 60 rows and 4
// rows with no source, x = 0 and w = 0); where K > T one group spans
// ceil(K / T) slabs of T rows, decoded in turn by one CTA that carries the
// K-sum across them. So the padding is exact.
//
// Plan: the rows per tile T is the largest of 64, 32, 16 whose state fits
// one block's shared memory (on the CUDA cores also with 16384 / T >= Hp,
// one pass a layer). A bf16 spec takes the tensor cores when a tile fits,
// else the CUDA cores with BF16 rounding; a spec for which no CUDA-core
// tile fits either (a layer input or H in the thousands) keeps its tile's
// activations in a global workspace slice per CTA (T = 64, two buffers),
// the ring in shared memory: the one workspace placement.
#pragma once

#include "decode_f32.cuh"
#include "decode_live.cuh"
#include "decode_tc.cuh"

namespace dany {

using dtc::bf16;

constexpr int kThreads = 256;
constexpr int kSmemMax = 232448;     // the dynamic shared memory of a block
constexpr int kTensorCores = 0, kCudaCores = 1;
// tensor cores
constexpr int kKC = dtc::kKC;        // weight rows (the k of a product) a chunk
constexpr int kPad = dtc::kPad;      // bf16 row padding in shared memory
constexpr int kStages = dtc::kStages;
constexpr int kBlock = 256;          // output columns a block
constexpr int kBStride = kKC + kPad; // row stride of a backward stage
// CUDA cores
constexpr int kCcKC = 8;             // weight rows a chunk
constexpr int kCcStages = 3;
constexpr int kCcPad = df32::kPadK;  // 16

struct Dims {
  long long M;
  int G, Fi, Dd, E, Ff, Fd, H, K, L1, L3, L, x1;
  int bf16;   // the rounding
  int kind;   // kTensorCores or kCudaCores
  int Hp;     // H padded
  int kp0;    // layer 0's input padded
  int kpE;    // layer L1's input (H + E) padded
  int kmax;   // widest padded layer input (>= Hp)
  int T;      // rows per tile
  int gpt;    // groups per K3 item: T / K, or 1 when K > T
  int slabs;  // slabs of T rows per K3 item: 1, or ceil(K / T) when K > T
  int ws;     // 1: the tile's activations lie in a global workspace slice
  long long P;  // floats of all dW, db, dwa, dba (the _flatten order)
};

__host__ __device__ inline int rup(int n, int m) { return (n + m - 1) / m * m; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline int in_of(const Dims& d, int l) {
  return l == 0 ? d.x1 : (l == d.L1 ? d.H + d.E : d.H);
}
__host__ __device__ inline int kp_of(const Dims& d, int l) {
  return l == 0 ? d.kp0 : (l == d.L1 ? d.kpE : d.Hp);
}
// sum of kp_i over layers i < l (the layer's row in the packed weights and
// the scratch)
__host__ __device__ inline long long kp_before(const Dims& d, int l) {
  if (l <= 0) return 0;
  return (long long)d.kp0 + (long long)(l - 1) * d.Hp +
         (d.L1 <= l - 1 ? d.kpE - d.Hp : 0);
}
__host__ __device__ inline long long in_before(const Dims& d, int l) {
  if (l <= 0) return 0;
  return (long long)d.x1 + (long long)(l - 1) * d.H +
         (d.L1 <= l - 1 ? d.E : 0);
}
// dW_l's and db_l's offsets in the parameter vector (dW_0, db_0, ..., dwa,
// dba)
__host__ __device__ inline long long pw_of(const Dims& d, int l) {
  return (in_before(d, l) + l) * d.H;
}
__host__ __device__ inline long long pb_of(const Dims& d, int l) {
  return pw_of(d, l) + (long long)in_of(d, l) * d.H;
}
// values of one tile's db / dwa / dba slice
__host__ __device__ inline int slice_floats(const Dims& d) {
  return d.L * d.H + d.H + 1;
}

inline Dims base_dims(long long M, int Fi, int Dd, int E, int Ff, int Fd,
                      int H, int K, int L1, int L3, int bf16) {
  Dims d{};
  d.M = M; d.Fi = Fi; d.Dd = Dd; d.E = E; d.Ff = Ff; d.Fd = Fd; d.H = H;
  d.K = K; d.L1 = L1; d.L3 = L3; d.L = L1 + L3; d.bf16 = bf16 ? 1 : 0;
  d.G = K > 0 ? (int)(M / K) : 0;
  d.x1 = Fi + 2 * Ff * Fi + (Fd > 0 ? 2 * Fd * Dd : Dd);
  long long p = 0;
  for (int l = 0; l < d.L; ++l) p += (long long)in_of(d, l) * H + H;
  d.P = p + H + 1;
  return d;
}

inline bool takes(const Dims& d) {
  return d.Fi >= 0 && d.Dd >= 0 && d.E >= 0 && d.Ff >= 0 && d.Fd >= 0 &&
         d.H >= 1 && d.K >= 1 && d.L1 >= 1 && d.L3 >= 1 && d.M >= 0 &&
         d.M % d.K == 0 && d.M < (1LL << 31);
}

inline void set_tile(Dims& d, int kind, int T, int ws) {
  const int pad = kind == kTensorCores ? kKC : kCcPad;
  d.kind = kind;
  d.Hp = rup(d.H, pad);
  d.kp0 = rup(d.x1, pad);
  d.kpE = rup(d.H + d.E, pad);
  d.kmax = imax(d.kp0, d.kpE);
  d.T = T;
  d.ws = ws;
  d.gpt = d.K <= T ? T / d.K : 1;
  d.slabs = d.K <= T ? 1 : (d.K + T - 1) / T;
}

// ---- the tensor-core layouts (bytes) --------------------------------------
__host__ __device__ inline int tc_lda(const Dims& d) { return d.kmax + kPad; }
__host__ __device__ inline int tc_ldb(const Dims& d) {  // forward stage rows
  return imin(kBlock, d.Hp) + kPad;
}
__host__ __device__ inline int tc_ldg(const Dims& d) { return d.Hp + kPad; }
__host__ __device__ inline int tc_gxs(const Dims& d) { return d.kmax + 4; }
// bf16 elements of a ring stage: a forward chunk [32][ldb], or with the
// backward a W block [<= 256][32 + 8]
__host__ __device__ inline int tc_stage(const Dims& d, bool bwd) {
  const int f = kKC * tc_ldb(d);
  const int b = imin(kBlock, d.kmax) * kBStride;
  return bwd && b > f ? b : f;
}

struct TcShape {  // offsets in bytes from the base of shared memory
  size_t a1, gr, masks, ring, rows, total;
};

// K3 (bwd false): A0 | A1 | ring | w_s, aw_s, m_s. K4 phase A: A0 | A1
// (later the f32 input gradients GX [T][gxs]) | Gr (bf16 g_zr [T][ldg]) |
// z-sign bits [L][T][Hp / 32] | ring | w_s, gza_s, m_s.
__host__ __device__ inline TcShape tc_shape(const Dims& d, bool bwd) {
  TcShape s{};
  const size_t abytes = (size_t)d.T * tc_lda(d) * sizeof(bf16);
  s.a1 = abytes;
  size_t u = 2 * abytes;
  if (bwd) {
    const size_t gx = (size_t)d.T * tc_gxs(d) * sizeof(float);
    u = u > gx ? u : gx;
  }
  s.gr = u;
  s.masks = s.gr + (bwd ? (size_t)d.T * tc_ldg(d) * sizeof(bf16) : 0);
  s.ring = s.masks + (bwd ? (size_t)d.L * d.T * (d.Hp / 32) * 4 : 0);
  s.ring = (s.ring + 15) / 16 * 16;
  s.rows = s.ring + (size_t)kStages * tc_stage(d, bwd) * sizeof(bf16);
  s.total = s.rows + (size_t)3 * d.T * 4;
  return s;
}

// ---- the CUDA-core layouts (floats) --------------------------------------
__host__ __device__ inline int cc_cw(int T) { return 16384 / T; }
__host__ __device__ inline int cc_ld(int T) { return T + 4; }
__host__ __device__ inline int cc_hw(const Dims& d) { return (d.Hp + 31) / 32; }
// the activations X [kmax][T + 4] (two with the workspace), with bwd also
// Gz [Hp][T + 4] and the z-sign bits [L][T][ceil(Hp / 32)]
__host__ __device__ inline long long cc_state_floats(const Dims& d, bool bwd) {
  const long long x = (long long)d.kmax * cc_ld(d.T);
  long long s = d.ws ? 2 * x : x;
  if (bwd)
    s += (long long)d.Hp * cc_ld(d.T) + (long long)d.L * d.T * cc_hw(d);
  return s;
}
__host__ __device__ inline size_t cc_smem(const Dims& d, bool bwd) {
  const size_t ring = (size_t)kCcStages * kCcKC * cc_cw(d.T);
  return sizeof(float) * ((d.ws ? 0 : cc_state_floats(d, bwd)) + ring +
                          3 * (size_t)d.T);
}

inline size_t smem_need(const Dims& d, bool bwd) {
  return d.kind == kTensorCores ? tc_shape(d, bwd).total : cc_smem(d, bwd);
}

// The plan of K3 (bwd false) or K4 phase A (bwd true): the product, the
// rows per tile, the placement (module comment).
inline Dims plan(long long M, int Fi, int Dd, int E, int Ff, int Fd, int H,
                 int K, int L1, int L3, int bf16, bool bwd) {
  Dims d = base_dims(M, Fi, Dd, E, Ff, Fd, H, K, L1, L3, bf16);
  const int tiles[3] = {64, 32, 16};
  if (bf16) {
    for (int T : tiles) {
      set_tile(d, kTensorCores, T, 0);
      if (smem_need(d, bwd) <= (size_t)kSmemMax) return d;
    }
  }
  for (int T : tiles) {
    set_tile(d, kCudaCores, T, 0);
    if (d.Hp <= cc_cw(T) && smem_need(d, bwd) <= (size_t)kSmemMax) return d;
  }
  set_tile(d, kCudaCores, 64, 1);
  return d;
}

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// ---- rows ------------------------------------------------------------------
// K3: the neighbor row that row r of slab s of item `item` decodes (-1:
// none). An item is gpt live groups (list entries item * gpt ...), or one
// group in slabs when K > T.
__device__ __forceinline__ int k3_row(const Dims& d, const int* list,
                                      int ngroups, int item, int s, int r) {
  const int q = s * d.T + r;
  const int gl = q / d.K;
  const int gi = item * d.gpt + gl;
  if (gl >= d.gpt || gi >= ngroups) return -1;
  return list[gi] * d.K + (q - gl * d.K);
}

// K4: row r of tile t of the live rows (the live groups' K rows each, in
// list order; -1 past them)
__device__ __forceinline__ int k4_row(const Dims& d, const int* list,
                                      int nrows, int t, int r) {
  const int j = t * d.T + r;
  return j < nrows ? list[j / d.K] * d.K + j % d.K : -1;
}

// ---- the weight rings ------------------------------------------------------
template <typename E>
struct Chunk {
  const E* src;
  int rows, cols;   // cols: a multiple of 16 bytes
  long long lds;    // source row stride
  int ldd;          // stage row stride
};

// one chunk into its stage, 16 bytes per cp.async
template <typename E>
__device__ __forceinline__ void copy_chunk(E* dst, const Chunk<E>& ch) {
  constexpr int V = 16 / sizeof(E);
  const int per = ch.cols / V, n = ch.rows * per;
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const int r = p / per, q = p - r * per;
    dtc::cp_async16(dst + (size_t)r * ch.ldd + q * V,
                     ch.src + (long long)r * ch.lds + q * V);
  }
}

// Tensor cores. W: each W_l zero-padded to [kp_l][Hp], bf16, layer after
// layer. The chunks in the order the kernels take them: per layer 0 ..
// L-1, per block of 256 output columns, the 32-row chunks of its inputs
// ([32][<= 256]); then (bwd) per layer L-1 .. 0, per block of 256 of its
// kp_l inputs (the output of g_h = g_z W^T), the 32-column chunks of H
// ([<= 256][32] of W_l itself: the B operand k-contiguous).
__device__ __forceinline__ bool tc_chunk(const Dims& d, const bf16* W, int c,
                                         bool bwd, Chunk<bf16>& ch) {
  const int Hp = d.Hp;
  for (int l = 0; l < d.L; ++l) {
    const int nk = kp_of(d, l) / kKC, n = (Hp + kBlock - 1) / kBlock * nk;
    if (c < n) {
      const int cb = c / nk, kk = c - cb * nk;
      ch.src = W + (long long)Hp * kp_before(d, l) + (long long)kk * kKC * Hp +
               cb * kBlock;
      ch.rows = kKC;
      ch.cols = imin(kBlock, Hp - cb * kBlock);
      ch.lds = Hp;
      ch.ldd = tc_ldb(d);
      return true;
    }
    c -= n;
  }
  if (!bwd) return false;
  const int nk = Hp / kKC;
  for (int l = d.L - 1; l >= 0; --l) {
    const int kp = kp_of(d, l), n = (kp + kBlock - 1) / kBlock * nk;
    if (c < n) {
      const int ob = c / nk, kk = c - ob * nk;
      ch.src = W + (long long)Hp * kp_before(d, l) +
               (long long)ob * kBlock * Hp + kk * kKC;
      ch.rows = imin(kBlock, kp - ob * kBlock);
      ch.cols = kKC;
      ch.lds = Hp;
      ch.ldd = kBStride;
      return true;
    }
    c -= n;
  }
  return false;
}

// CUDA cores. W: each W_l zero-padded to [kp_l][Hp], f32, layer after
// layer, then (bwd) each W_l^T as [Hp][kp_l]. The chunks: per layer 0 ..
// L-1, per pass of 16384 / T output columns, the 8-row chunks of its
// inputs; then per layer L-1 .. 0, per pass over its kp_l inputs, the
// 8-row chunks of W_l^T.
__device__ __forceinline__ bool cc_chunk(const Dims& d, const float* W, int c,
                                         bool bwd, Chunk<float>& ch) {
  const int Hp = d.Hp, CW = cc_cw(d.T);
  for (int l = 0; l < d.L; ++l) {
    const int nk = kp_of(d, l) / kCcKC, n = (Hp + CW - 1) / CW * nk;
    if (c < n) {
      const int cp = c / nk * CW, kk = (c % nk) * kCcKC;
      ch.src = W + (long long)Hp * kp_before(d, l) + (long long)kk * Hp + cp;
      ch.rows = kCcKC;
      ch.cols = imin(CW, Hp - cp);
      ch.lds = Hp;
      ch.ldd = CW;
      return true;
    }
    c -= n;
  }
  if (!bwd) return false;
  const long long base = (long long)Hp * kp_before(d, d.L);
  const int nk = Hp / kCcKC;
  for (int l = d.L - 1; l >= 0; --l) {
    const int kp = kp_of(d, l), n = (kp + CW - 1) / CW * nk;
    if (c < n) {
      const int cp = c / nk * CW, kk = (c % nk) * kCcKC;
      ch.src = W + base + (long long)Hp * kp_before(d, l) +
               (long long)kk * kp + cp;
      ch.rows = kCcKC;
      ch.cols = imin(CW, kp - cp);
      ch.lds = kp;
      ch.ldd = CW;
      return true;
    }
    c -= n;
  }
  return false;
}

// Start the copy of chunk c into its ring stage and commit a group (an
// empty one past the last chunk, so that every thread counts the same).
__device__ __forceinline__ void tc_issue(const Dims& d, const bf16* W, int c,
                                         bool bwd, bf16* ring, int stage) {
  Chunk<bf16> ch;
  if (tc_chunk(d, W, c, bwd, ch)) copy_chunk(ring + (c % kStages) * stage, ch);
  dtc::cp_async_commit();
}
__device__ __forceinline__ void cc_issue(const Dims& d, const float* W, int c,
                                         bool bwd, float* ring) {
  Chunk<float> ch;
  if (cc_chunk(d, W, c, bwd, ch))
    copy_chunk(ring + (size_t)(c % kCcStages) * kCcKC * cc_cw(d.T), ch);
  dtc::cp_async_commit();
}

// Wait for chunk c, make it visible to the CTA, and start chunk c +
// stages - 1 (into the stage chunk c - 1 used, which every thread is done
// with once past the barrier). Returns chunk c's stage.
__device__ __forceinline__ const bf16* tc_next(const Dims& d, const bf16* W,
                                               int c, bool bwd, bf16* ring,
                                               int stage) {
  dtc::cp_async_wait<kStages - 2>();
  __syncthreads();
  tc_issue(d, W, c + kStages - 1, bwd, ring, stage);
  return ring + (c % kStages) * stage;
}
__device__ __forceinline__ const float* cc_next(const Dims& d, const float* W,
                                                int c, bool bwd, float* ring) {
  dtc::cp_async_wait<kCcStages - 2>();
  __syncthreads();
  cc_issue(d, W, c + kCcStages - 1, bwd, ring);
  return ring + (size_t)(c % kCcStages) * kCcKC * cc_cw(d.T);
}

// ---- the products ----------------------------------------------------------
// Tensor cores: one layer's product for a tile. For each block of at most
// 256 of the nout output columns: acc = A[:, :kin] . B with the chunks from
// the ring (TB: a forward chunk [k][n], else a backward one [n][k]), then
// epi(r, col, v0, v1) over the warp's accumulator pairs. The T / 16 row
// warps take 16 rows each; the 8 / (T / 16) warps of a row share a block's
// columns in units of 16. Returns the next chunk.
template <bool TB, typename Epi>
__device__ __forceinline__ int tc_product(const Dims& d, const bf16* W,
                                          bool bwd, bf16* ring, int stage,
                                          int c, const bf16* A, int lda,
                                          int kin, int nout, int ldb,
                                          Epi epi) {
  const int warp = threadIdx.x >> 5;
  const int WR = d.T / 16, WC = 8 / WR;
  const int arow = (warp % WR) * 16, wc = warp / WR;
  float acc[1][16][4];
  for (int cs = 0; cs < nout; cs += kBlock) {
    const int n16 = imin(kBlock, nout - cs) / 16;
    const int u = (n16 + WC - 1) / WC, u0 = wc * u;
    const int ntv = 2 * imax(0, imin(u, n16 - u0)), bn0 = 16 * u0;
    dtc::zero_acc(acc);
    for (int kk = 0; kk < kin; kk += kKC, ++c) {
      const bf16* st = tc_next(d, W, c, bwd, ring, stage);
      dtc::mma_chunk<1, 16, TB>(acc, ntv, A, lda, arow, kk, st, ldb, bn0);
    }
    dtc::for_acc(acc, ntv, arow, cs + bn0, epi);
  }
  return c;
}

// CUDA cores: the thread's first row and first column of a tile of T rows
// by 16384 / T columns (8 x 8 a thread: 8 lanes of a warp share a row
// group and take 32 consecutive columns, so the z-sign bits of a row's
// 32-column word come from 8 consecutive lanes); its columns are c0 + j and
// c0 + CW / 2 + j, j < 4.
__device__ __forceinline__ void cc_map(int T, int& r0, int& c0) {
  const int RT = T / 8, RW = RT < 4 ? RT : 4, LC = 32 / RW, WR = RT / RW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  r0 = 8 * ((warp % WR) * RW + lane / LC);
  c0 = 4 * ((warp / WR) * LC + lane % LC);
}
__device__ __forceinline__ int cc_col(int c0, int j, int half) {
  return c0 + (j & 3) + (j >> 2) * half;
}

// acc[i][j] += sum_{k < KC} A[k * lda + r0 + i] * B[k * ldb + col(j)]:
// exact f32 FMAs, A k-major (transposed activations), B k-major
template <int KC>
__device__ __forceinline__ void cc_mm(float (&acc)[8][8],
                                      const float* __restrict__ A, int lda,
                                      const float* __restrict__ B, int ldb,
                                      int r0, int c0, int half) {
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + k * lda + r0);
    const float4 a1 = *reinterpret_cast<const float4*>(A + k * lda + r0 + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(B + k * ldb + c0);
    const float4 b1 =
        *reinterpret_cast<const float4*>(B + k * ldb + c0 + half);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// One layer's product on the CUDA cores: per pass of CW output columns,
// acc = A[:kin] . B (A transposed, row stride T + 4; the chunks from the
// ring), a barrier (so that the epilogue may write over A), then
// epi(acc, pass start, r0, c0). Returns the next chunk.
template <typename Epi>
__device__ __forceinline__ int cc_product(const Dims& d, const float* W,
                                          bool bwd, float* ring, int c,
                                          const float* A, int kin, int nout,
                                          Epi epi) {
  const int CW = cc_cw(d.T), LD = cc_ld(d.T);
  int r0, c0;
  cc_map(d.T, r0, c0);
  float acc[8][8];
  for (int cp = 0; cp < nout; cp += CW) {
    df32::zero8x8(acc);
    for (int kk = 0; kk < kin; kk += kCcKC, ++c) {
      const float* st = cc_next(d, W, c, bwd, ring);
      cc_mm<kCcKC>(acc, A + (size_t)kk * LD, LD, st, CW, r0, c0, CW / 2);
    }
    __syncthreads();  // every warp has read A
    epi(acc, cp, r0, c0);
  }
  return c;
}

// ---- inputs ---------------------------------------------------------------
// x = [feat | PE(feat) | PE(dists)] of the rows m_s (-1: none, all zero),
// PE interleaved (sin, cos) per (channel, freq) as ops/pe.py, zero from x1
// up to kp0; precise sinf / cosf. feat and dists round before the PE and
// every value rounds with BF16. put(r, c, v) writes one value. Four threads
// share a row and take every fourth channel.
template <bool BF16, typename Put>
__device__ __forceinline__ void build_x(const Dims& d,
                                        const float* __restrict__ feat,
                                        const float* __restrict__ dists,
                                        const int* m_s, Put put) {
  const int Fi = d.Fi, Dd = d.Dd, Ff = d.Ff, Fd = d.Fd, kp0 = d.kp0;
  const int pe_d = Fi + 2 * Ff * Fi;  // first column of the dists part
  for (int i = threadIdx.x; i < d.T * 4; i += kThreads) {
    const int r = i >> 2, sub = i & 3;
    const int m = m_s[r];
    if (m < 0) {
      for (int c = sub; c < kp0; c += 4) put(r, c, 0.f);
      continue;
    }
    for (int ch = sub; ch < Fi; ch += 4) {
      const float v = rnd<BF16>(feat[(size_t)m * Fi + ch]);
      put(r, ch, v);
      for (int f = 0; f < Ff; ++f) {
        const float b = v * (float)(1 << f);
        put(r, Fi + (ch * Ff + f) * 2, rnd<BF16>(sinf(b)));
        put(r, Fi + (ch * Ff + f) * 2 + 1, rnd<BF16>(cosf(b)));
      }
    }
    for (int ch = sub; ch < Dd; ch += 4) {
      const float v = rnd<BF16>(dists[(size_t)m * Dd + ch]);
      if (Fd == 0) put(r, pe_d + ch, v);
      for (int f = 0; f < Fd; ++f) {
        const float b = v * (float)(1 << f);
        put(r, pe_d + (ch * Fd + f) * 2, rnd<BF16>(sinf(b)));
        put(r, pe_d + (ch * Fd + f) * 2 + 1, rnd<BF16>(cosf(b)));
      }
    }
    for (int c = d.x1 + sub; c < kp0; c += 4) put(r, c, 0.f);
  }
}

// the block3 input's tail: extras (rounded with BF16) in columns H .. H+E-1,
// zeros up to kpE (and on rows without a source)
template <bool BF16, typename Put>
__device__ __forceinline__ void put_extras(const Dims& d,
                                           const float* __restrict__ extras,
                                           const int* m_s, Put put) {
  const int w = d.kpE - d.H;
  for (int i = threadIdx.x; i < d.T * w; i += kThreads) {
    const int r = i / w, c = i - r * w;
    const int m = m_s[r];
    put(r, d.H + c,
        (m >= 0 && c < d.E) ? rnd<BF16>(extras[(size_t)m * d.E + c]) : 0.f);
  }
}

// The weighted K-sums of slab s of an item: fagg[g] and alpha[g] of each of
// its ng groups (list entries gb ...), from the last layer's h(r, col) and
// the rows' w and alpha_pp * w; the first slab writes, later ones add (the
// same thread each time). Products and sums rounded one by one, as the
// plain version's (h * w).sum.
template <typename Hv>
__device__ __forceinline__ void k_sums(const Dims& d, const int* list, int gb,
                                       int ng, int s, const float* w_s,
                                       const float* aw_s, Hv h,
                                       float* __restrict__ fagg,
                                       float* __restrict__ alpha) {
  const int H = d.H, K = d.K, T = d.T;
  for (int i = threadIdx.x; i < ng * H; i += kThreads) {
    const int gl = i / H, col = i - gl * H;
    const int q0 = imax(gl * K - s * T, 0), q1 = imin(gl * K + K - s * T, T);
    if (q0 >= q1) continue;
    float sum = 0.f;
    for (int r = q0; r < q1; ++r)
      sum = __fadd_rn(sum, __fmul_rn(h(r, col), w_s[r]));
    float* p = fagg + (size_t)list[gb + gl] * H + col;
    *p = s == 0 ? sum : *p + sum;
  }
  for (int gl = threadIdx.x; gl < ng; gl += kThreads) {
    const int q0 = imax(gl * K - s * T, 0), q1 = imin(gl * K + K - s * T, T);
    if (q0 >= q1) continue;
    float sum = 0.f;
    for (int r = q0; r < q1; ++r) sum += aw_s[r];
    float* p = alpha + list[gb + gl];
    *p = s == 0 ? sum : *p + sum;
  }
}

}  // namespace dany
