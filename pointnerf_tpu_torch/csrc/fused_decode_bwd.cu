// K4: fused decode backward.
//
// Replaces: pointnerf_tpu/ops/pallas_decode.py::fused_decode, backward
// (_bwd_rule -> pallas_call of _bwd_kernel), reached from
// pointnerf_tpu/models/aggregator.py::aggregate when the model trains with
// agg.fused_decode set.
//
// Function, per neighbor row m of M rows (g = m / K its shading point):
//   recompute the forward of K3 (x = [feat | PE(feat) | PE(dists)], block1,
//   [h | extras], block3, za = h . wa + ba), keeping every layer's input
//   activation and the sign of every pre-activation z;
//   g_w[m]  = sum(h_last * g_fagg[g]) + softplus(za - 1) * g_alpha[g]
//   g_za    = g_alpha[g] * w * sigmoid(za - 1);   dwa += h_last * g_za,
//   dba += g_za;  g_h = g_fagg[g] * w + g_za * wa
//   then through block3 and block1 in reverse: g_z = g_h * (z > 0 ? 1 : slope),
//   db += g_z, dW += act^T g_z, g_h = g_z W^T; g_extras from the block3 input
//   slice, and the PE backward to g_feat and g_dists in the interleaved
//   (sin, cos) per (channel, freq) layout of ops/pe.py, so the first block1
//   dW comes out in the JAX parameter layout.
// This is the f32 route (`spec.bf16` false): no value is rounded. The bf16
// route, with the JAX kernel's rounding points, is
// csrc/fused_decode_bwd_tc.cu.
//
// Bound on the H100: operations. A row costs the forward again (~0.54 MFLOP
// at bench_config) plus as much for dW and for the input gradients, ~1.63
// MFLOP; M = 290,816 rows is ~473 GFLOP: ~7 ms at the 67 TFLOP/s f32
// CUDA-core peak.
//
// Design (a simple kernel on CUDA cores, f32 FMA): persistent CTAs of 256
// threads, as many as fit on the card at once, each walking tiles of 32 rows
// (tile = blockIdx.x, += gridDim.x). A tile keeps every layer's input
// activations, the last hidden layer (then its gradient), the input-gradient
// buffer and the z-sign bitmasks in shared memory (~209 KB at bench_config);
// nothing per row goes to device memory except the row gradients. Each CTA
// accumulates dW/db/dwa/dba for its tiles in its own f32 slice of a
// workspace (no atomics), and a second launch sums the slices in CTA order,
// so the result is deterministic run to run on a given card.
// The products are register-tiled: in the row-parallel ones (the forward
// again and g_h = g_z W^T) a thread owns 8 rows x 4 columns and reads 4
// weight rows as float4 per step, the 32 lanes of a warp sharing their rows
// so each activation read is a shared-memory broadcast; in dW a thread owns
// 4 input rows x 8 columns and sums over the tile's 32 rows. Layer widths are
// padded to a multiple of 4 in shared memory and in the weights the wrapper
// passes (zero rows of W, zero columns of W^T). Tensor cores are later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 32;          // rows per tile
constexpr int kThreads = 256;      // 8 warps
constexpr int kMaxLayers = 8;

struct Net {
  const float* W[kMaxLayers];   // [inp, H], zero rows past in
  const float* WT[kMaxLayers];  // [H, inp], the same weights transposed
  const float* b[kMaxLayers];
};

struct Dims {
  int M, Fi, Dd, E, Ff, Fd, H, K, L1, L3, x1;
  int in[kMaxLayers];       // input width of each layer
  int inp[kMaxLayers];      // the same rounded up to 4 (row strides)
  int act_off[kMaxLayers];  // per-row float offset of each layer's input
  int sum_in;               // per-row floats of all padded layer inputs
  int gx_stride;            // widest padded layer input
  int pw[kMaxLayers];       // workspace offsets of dW, db per layer
  int pb[kMaxLayers];
  int pwa, pba, P;          // dwa, dba, floats of dW/db/dwa/dba
  int Ps;                   // P rounded up to 4: the stride of CTA slices
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// acc[r][j] = sum_{k < kdim} A[r0 + r][k] * B[k][c0 + j] for the thread's 8
// rows and 4 columns. A in shared memory (row stride lda), B in device
// memory (row stride ldb); kdim, lda, ldb and c0 are multiples of 4. The
// next 4 rows of B are loaded while the current 4 are used.
__device__ __forceinline__ void mm_8x4(const float* __restrict__ A, int lda,
                                       int kdim, const float* __restrict__ B,
                                       int ldb, int r0, int c0,
                                       float acc[8][4]) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  const float* Ar = A + r0 * lda;
  const float* Bc = B + c0;
  float4 b[4], bn[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    b[q] = __ldg(reinterpret_cast<const float4*>(Bc + (size_t)q * ldb));
  for (int k = 0; k < kdim; k += 4) {
    if (k + 4 < kdim) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        bn[q] = __ldg(reinterpret_cast<const float4*>(
            Bc + (size_t)(k + 4 + q) * ldb));
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float4 a = ld4(Ar + r * lda + k);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[r][0] = fmaf(av[q], b[q].x, acc[r][0]);
        acc[r][1] = fmaf(av[q], b[q].y, acc[r][1]);
        acc[r][2] = fmaf(av[q], b[q].z, acc[r][2]);
        acc[r][3] = fmaf(av[q], b[q].w, acc[r][3]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) b[q] = bn[q];
  }
}

// One forward layer for the tile: out[r][c] = act(in[r] @ W[:, c] + b[c]),
// c < H; the sign of each pre-activation is or-ed into
// mask_s[r][c / 32] bit c % 32 (cleared by the caller).
__device__ __forceinline__ void forward_layer(const float* __restrict__ in_s,
                                              int inp,
                                              const float* __restrict__ W,
                                              const float* __restrict__ bias,
                                              int H, float* __restrict__ out_s,
                                              int ostride,
                                              unsigned* __restrict__ mask_s,
                                              float slope) {
  const int r0 = (threadIdx.x >> 6) * 8;
  const int c0 = (threadIdx.x & 63) * 4;
  if (c0 >= H) return;
  float acc[8][4];
  mm_8x4(in_s, inp, inp, W, H, r0, c0, acc);
  const float4 bv = __ldg(reinterpret_cast<const float4*>(bias + c0));
  const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
  const int HW = H >> 5;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float o[4];
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float z = acc[r][j] + bj[j];
      bits |= (z > 0.f ? 1u : 0u) << j;
      o[j] = z > 0.f ? z : z * slope;
    }
    st4(out_s + (r0 + r) * ostride + c0, make_float4(o[0], o[1], o[2], o[3]));
    atomicOr(mask_s + (r0 + r) * HW + (c0 >> 5), bits << (c0 & 31));
  }
}

// gx[r][c] = sum_{k < H} g[r][k] * WT[k][c] for c < inp (g_h = g_z W^T)
__device__ __forceinline__ void input_grad(const float* __restrict__ g_s,
                                           int H, const float* __restrict__ WT,
                                           int inp, float* __restrict__ gx_s,
                                           int gx_stride) {
  const int r0 = (threadIdx.x >> 6) * 8;
  for (int c0 = (threadIdx.x & 63) * 4; c0 < inp; c0 += 256) {
    float acc[8][4];
    mm_8x4(g_s, H, H, WT, inp, r0, c0, acc);
#pragma unroll
    for (int r = 0; r < 8; ++r)
      st4(gx_s + (r0 + r) * gx_stride + c0,
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
  }
}

// this CTA's dW[k][c] (+)= sum_r act[r][k] * g[r][c] over the tile, for the
// layer's kin real input rows (act padded to row stride inp)
__device__ __forceinline__ void accum_dw(const float* __restrict__ act_s,
                                         int inp, int kin,
                                         const float* __restrict__ g_s, int H,
                                         float* __restrict__ pw, bool first) {
  const int c0 = (threadIdx.x & 31) * 8;
  if (c0 >= H) return;
  for (int k0 = (threadIdx.x >> 5) * 4; k0 < kin; k0 += 32) {
    float acc[4][8];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[q][j] = 0.f;
    for (int r = 0; r < kRows; ++r) {
      const float4 a = ld4(act_s + r * inp + k0);
      const float4 g0 = ld4(g_s + r * H + c0);
      const float4 g1 = ld4(g_s + r * H + c0 + 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[q][j] = fmaf(av[q], gv[j], acc[q][j]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (k0 + q >= kin) break;
      float* p = pw + (size_t)(k0 + q) * H + c0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float4 v = make_float4(acc[q][4 * h], acc[q][4 * h + 1],
                               acc[q][4 * h + 2], acc[q][4 * h + 3]);
        if (!first) {
          const float4 o = ld4(p + 4 * h);
          v.x += o.x; v.y += o.y; v.z += o.z; v.w += o.w;
        }
        st4(p + 4 * h, v);
      }
    }
  }
}

__device__ __forceinline__ void accum(float* p, float v, bool first) {
  *p = first ? v : *p + v;
}

__global__ void __launch_bounds__(kThreads, 1)
fused_decode_bwd_kernel(const float* __restrict__ feat,
                        const float* __restrict__ dists,
                        const float* __restrict__ extras,
                        const float* __restrict__ w, Net net,
                        const float* __restrict__ wa,
                        const float* __restrict__ ba,
                        const float* __restrict__ gf,
                        const float* __restrict__ ga, Dims d, float slope,
                        float* __restrict__ g_feat,
                        float* __restrict__ g_dists,
                        float* __restrict__ g_extras,
                        float* __restrict__ g_w, float* __restrict__ partials) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int L = d.L1 + d.L3;
  const int M = d.M, Fi = d.Fi, Dd = d.Dd, E = d.E, Ff = d.Ff, Fd = d.Fd;
  const int H = d.H, HW = d.H / 32, K = d.K, gxs = d.gx_stride;
  const int s0 = d.inp[0], s3 = d.inp[d.L1];
  float* X = smem;                                // layer 0 input
  float* X3 = smem + kRows * d.act_off[d.L1];     // block3 input
  float* G = smem + kRows * d.sum_in;             // [kRows][H]
  float* GX = G + kRows * H;                      // [kRows][gxs]
  unsigned* masks = reinterpret_cast<unsigned*>(GX + kRows * gxs);
  float* wr_s = reinterpret_cast<float*>(masks + L * kRows * HW);
  float* gza_s = wr_s + kRows;
  float* part = partials + (size_t)blockIdx.x * d.Ps;
  const int ntiles = (M + kRows - 1) / kRows;

  // the padding columns of the layer inputs are never written: zero them
  // once (the padded weight rows are zero, but 0 * garbage need not be)
  for (int l = 0; l < L; ++l)
    for (int i = tid; i < kRows * (d.inp[l] - d.in[l]); i += kThreads) {
      const int pad = d.inp[l] - d.in[l];
      smem[kRows * d.act_off[l] + (i / pad) * d.inp[l] + d.in[l] + i % pad] =
          0.f;
    }

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const int row0 = tile * kRows;

    // x = [feat | PE(feat) | PE(dists)] and the extras of the block3 input
    for (int i = tid; i < kRows * d.x1; i += kThreads) {
      const int r = i / d.x1, c = i - r * d.x1;
      const int m = row0 + r;
      float v = 0.f;
      if (m < M) {
        if (c < Fi) {
          v = feat[(size_t)m * Fi + c];
        } else if (c < Fi + 2 * Ff * Fi) {
          const int q = c - Fi;  // (ch * Ff + f) * 2 + s
          const int ch = q / (2 * Ff), f = (q >> 1) % Ff;
          const float base = feat[(size_t)m * Fi + ch] * (float)(1 << f);
          v = (q & 1) ? cosf(base) : sinf(base);
        } else if (Fd > 0) {
          const int q = c - Fi - 2 * Ff * Fi;
          const int ch = q / (2 * Fd), f = (q >> 1) % Fd;
          const float base = dists[(size_t)m * Dd + ch] * (float)(1 << f);
          v = (q & 1) ? cosf(base) : sinf(base);
        } else {
          v = dists[(size_t)m * Dd + (c - Fi - 2 * Ff * Fi)];
        }
      }
      X[r * s0 + c] = v;
    }
    for (int i = tid; i < kRows * E; i += kThreads) {
      const int r = i / E, c = i - r * E;
      const int m = row0 + r;
      X3[r * s3 + H + c] =
          m < M ? extras[(size_t)m * E + c] : 0.f;
    }
    for (int i = tid; i < L * kRows * HW; i += kThreads) masks[i] = 0u;
    __syncthreads();

    // forward recompute: layer l reads act[l] and writes act[l + 1] (the
    // last layer writes G)
    for (int l = 0; l < L; ++l) {
      float* in_s = smem + kRows * d.act_off[l];
      float* out_s = l + 1 < L ? smem + kRows * d.act_off[l + 1] : G;
      const int ostride = l + 1 < L ? d.inp[l + 1] : H;
      forward_layer(in_s, d.inp[l], net.W[l], net.b[l], H, out_s, ostride,
                    masks + l * kRows * HW, slope);
      __syncthreads();
    }

    // alpha head per row: g_w, g_za (warp w takes rows 4w .. 4w + 3)
    for (int r = (tid >> 5) * 4; r < (tid >> 5) * 4 + 4; ++r) {
      const int m = row0 + r;
      const bool valid = m < M;
      const float* gfr = gf + (size_t)(valid ? m / K : 0) * H;
      float pa = 0.f, pg = 0.f;
      for (int col = lane; col < H; col += 32) {
        const float hv = G[r * H + col];
        pa = fmaf(hv, __ldg(wa + col), pa);
        pg = fmaf(hv, valid ? __ldg(gfr + col) : 0.f, pg);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        pa += __shfl_xor_sync(0xffffffffu, pa, off);
        pg += __shfl_xor_sync(0xffffffffu, pg, off);
      }
      if (lane == 0) {
        const float wr = valid ? w[m] : 0.f;
        const float gav = valid ? ga[m / K] : 0.f;
        const float x = pa + __ldg(ba) - 1.f;
        const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
        const float sig = 1.f / (1.f + expf(-x));
        wr_s[r] = wr;
        gza_s[r] = gav * wr * sig;
        if (valid) g_w[m] = pg + sp * gav;
      }
    }
    __syncthreads();
    for (int c = tid; c < H; c += kThreads) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s = fmaf(G[r * H + c], gza_s[r], s);
      accum(part + d.pwa + c, s, first);
    }
    if (tid == 0) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s += gza_s[r];
      accum(part + d.pba, s, first);
    }
    __syncthreads();
    // g_h of the last layer, in place of h_last
    for (int i = tid; i < kRows * H; i += kThreads) {
      const int r = i / H, c = i - r * H;
      const int m = row0 + r;
      const float gfv = m < M ? gf[(size_t)(m / K) * H + c] : 0.f;
      G[i] = gfv * wr_s[r] + gza_s[r] * __ldg(wa + c);
    }
    __syncthreads();

    // block3 then block1, in reverse
    for (int l = L - 1; l >= 0; --l) {
      const float* gh = l == L - 1 ? G : GX;
      const int ghs = l == L - 1 ? H : gxs;
      for (int c = tid; c < H; c += kThreads) {
        float s = 0.f;
        for (int r = 0; r < kRows; ++r) {
          const unsigned bits = masks[(l * kRows + r) * HW + (c >> 5)];
          const float gz =
              gh[r * ghs + c] * (((bits >> (c & 31)) & 1u) ? 1.f : slope);
          s += gz;
          G[r * H + c] = gz;
        }
        accum(part + d.pb[l] + c, s, first);
      }
      __syncthreads();
      accum_dw(smem + kRows * d.act_off[l], d.inp[l], d.in[l], G, H,
               part + d.pw[l], first);
      input_grad(G, H, net.WT[l], d.inp[l], GX, gxs);
      __syncthreads();
      if (l == d.L1) {
        for (int i = tid; i < kRows * E; i += kThreads) {
          const int r = i / E, c = i - r * E;
          const int m = row0 + r;
          if (m < M) g_extras[(size_t)m * E + c] = GX[r * gxs + H + c];
        }
      }
    }

    // PE backward: GX holds g_x [kRows][x1]
    for (int i = tid; i < kRows * Fi; i += kThreads) {
      const int r = i / Fi, ch = i - r * Fi;
      const int m = row0 + r;
      if (m >= M) continue;
      const float* gx = GX + r * gxs;
      const float fv = feat[(size_t)m * Fi + ch];
      float g = gx[ch];
      for (int f = 0; f < Ff; ++f) {
        const float sc = (float)(1 << f);
        const float b = fv * sc;
        const int q = Fi + (ch * Ff + f) * 2;
        g = g + sc * (gx[q] * cosf(b) - gx[q + 1] * sinf(b));
      }
      g_feat[(size_t)m * Fi + ch] = g;
    }
    for (int i = tid; i < kRows * Dd; i += kThreads) {
      const int r = i / Dd, ch = i - r * Dd;
      const int m = row0 + r;
      if (m >= M) continue;
      const float* gx = GX + r * gxs + Fi + 2 * Ff * Fi;
      float g;
      if (Fd > 0) {
        const float dv = dists[(size_t)m * Dd + ch];
        g = 0.f;
        for (int f = 0; f < Fd; ++f) {
          const float sc = (float)(1 << f);
          const float b = dv * sc;
          const int q = (ch * Fd + f) * 2;
          g = g + sc * (gx[q] * cosf(b) - gx[q + 1] * sinf(b));
        }
      } else {
        g = gx[ch];
      }
      g_dists[(size_t)m * Dd + ch] = g;
    }
    __syncthreads();
  }
}

// out[i] = sum over CTA slices b (in order) of partials[b][i], i < P
__global__ void fused_decode_bwd_reduce(const float* __restrict__ partials,
                                        int nblk, int P, int Ps,
                                        float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  float s = 0.f;
  for (int b = 0; b < nblk; ++b) s += partials[(size_t)b * Ps + i];
  out[i] = s;
}

Dims make_dims(int M, int Fi, int Dd, int E, int Ff, int Fd, int H, int K,
               int L1, int L3) {
  Dims d{};
  d.M = M; d.Fi = Fi; d.Dd = Dd; d.E = E; d.Ff = Ff; d.Fd = Fd; d.H = H;
  d.K = K; d.L1 = L1; d.L3 = L3;
  d.x1 = Fi + 2 * Ff * Fi + (Fd > 0 ? 2 * Fd * Dd : Dd);
  int off = 0, p = 0, gx = 0;
  for (int l = 0; l < L1 + L3; ++l) {
    d.in[l] = l == 0 ? d.x1 : (l == L1 ? H + E : H);
    d.inp[l] = (d.in[l] + 3) / 4 * 4;
    d.act_off[l] = off;
    off += d.inp[l];
    gx = gx > d.inp[l] ? gx : d.inp[l];
    d.pw[l] = p;
    p += d.in[l] * H;
    d.pb[l] = p;
    p += H;
  }
  d.sum_in = off;
  d.gx_stride = gx;
  d.pwa = p;
  d.pba = p + H;
  d.P = p + H + 1;
  d.Ps = (d.P + 3) / 4 * 4;
  return d;
}

size_t smem_bytes(const Dims& d) {
  const int L = d.L1 + d.L3;
  return sizeof(float) * ((size_t)kRows * (d.sum_in + d.H + d.gx_stride) +
                          (size_t)L * kRows * (d.H / 32) + 2 * kRows);
}

bool takes(const Dims& d) {
  return d.L1 >= 1 && d.L3 >= 1 && d.L1 + d.L3 <= kMaxLayers && d.H % 32 == 0 &&
         d.H <= 256 && d.K >= 1;
}

int set_smem(const Dims& d) {
  return (int)cudaFuncSetAttribute(fused_decode_bwd_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_bytes(d));
}

}  // namespace

// Number of persistent CTAs the launch will use for M rows (the workspace
// holds that many slices of P floats, each starting at a multiple of 4).
extern "C" int fused_decode_bwd_blocks(int M, int Fi, int Dd, int E, int Ff,
                                       int Fd, int H, int K, int L1, int L3,
                                       int* nblocks) {
  const Dims d = make_dims(M, Fi, Dd, E, Ff, Fd, H, K, L1, L3);
  if (!takes(d)) return (int)cudaErrorInvalidValue;
  *nblocks = 0;
  if (M == 0) return 0;
  int e = set_smem(d);
  if (e) return e;
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_decode_bwd_kernel, kThreads, smem_bytes(d));
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int ntiles = (M + kRows - 1) / kRows;
  const int n = per_sm * sms;
  *nblocks = n < ntiles ? n : ntiles;
  return 0;
}

extern "C" int fused_decode_bwd_launch(
    const float* feat, const float* dists, const float* extras,
    const float* w, const void* const* Ws, const void* const* WTs,
    const void* const* bs, int L1, int L3, const float* wa, const float* ba,
    const float* g_fagg, const float* g_alpha, int M, int Fi, int Dd, int E,
    int Ff, int Fd, int H, int K, float slope, float* g_feat,
    float* g_dists, float* g_extras, float* g_w, float* partials, int nblocks,
    float* dparams, void* stream) {
  const Dims d = make_dims(M, Fi, Dd, E, Ff, Fd, H, K, L1, L3);
  if (!takes(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0 || nblocks == 0)
    return (int)cudaMemsetAsync(dparams, 0, sizeof(float) * d.P, s);
  Net net;
  for (int i = 0; i < L1 + L3; ++i) {
    net.W[i] = static_cast<const float*>(Ws[i]);
    net.WT[i] = static_cast<const float*>(WTs[i]);
    net.b[i] = static_cast<const float*>(bs[i]);
  }
  int e = set_smem(d);
  if (e) return e;
  fused_decode_bwd_kernel<<<nblocks, kThreads, smem_bytes(d), s>>>(
      feat, dists, extras, w, net, wa, ba, g_fagg, g_alpha, d, slope,
      g_feat, g_dists, g_extras, g_w, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_decode_bwd_reduce<<<(d.P + 255) / 256, 256, 0, s>>>(
      partials, nblocks, d.P, d.Ps, dparams);
  return (int)cudaGetLastError();
}
