// K4: fused decode backward, f32 route, on the CUDA cores.
//
// Replaces: pointnerf_tpu/ops/pallas_decode.py::fused_decode, backward
// (_bwd_rule :430 -> pallas_call at :467 of _bwd_kernel), reached from
// pointnerf_tpu/models/aggregator.py::aggregate when the model trains with
// agg.fused_decode set, for DecodeSpec with bf16 unset. The bf16 route, with
// the JAX kernel's rounding points, is csrc/fused_decode_bwd_tc.cu.
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
//   dW comes out in the JAX parameter layout. No value is rounded: every
//   product is an exact f32 FMA on the CUDA cores.
//
// Bound on the H100: operations, 3 x K3's (the forward again, g_h = g_z W^T
// and dW), counted on the rows that carry a weight, at the 67 TFLOP/s f32
// CUDA-core peak. bench_config: 131,099 of 290,816 rows, ~213 GFLOP,
// 3.19 ms. The dataset path's train step at scene_config() (PERF.md §6):
// 25,666 of 2,304,000 rows, 41.8 GFLOP, 0.62 ms. Bytes: the weighted rows'
// inputs and every row gradient (written for all M rows) once, under these.
//
// Design, on the caller's stream:
//  0. the live-group list (csrc/decode_live.cuh) with K4's rule: a group is
//     live when a weight or its upstream gradient is nonzero. The pass
//     writes zeros into a dead group's row gradients; the live rows (the
//     live groups' K rows each, in list order) are what the phases visit.
//  A. fused_decode_bwd_f32_rows: persistent CTAs of 256 threads walk tiles
//     of 64 live rows, gathered from the list with size_t indexing. A tile
//     recomputes the forward as K3 does (activations transposed in shared
//     memory, each layer a register-tiled product whose weights stream
//     through a 3-stage cp.async ring of 8-row chunks) and keeps each
//     layer's z signs as bits; it writes every layer's input to a scratch
//     buffer in device memory. Then the alpha head and g_w, g_za; the chain g_z -> g_h =
//     g_z W^T layer by layer, the same products with W^T streamed through
//     the ring in column blocks of 256, each g_z written to scratch; g_extras;
//     the PE backward. The tile's db, dwa and dba sums go to its own slice.
//  B. fused_decode_bwd_f32_dw: dW_l = act_l^T g_z_l as a split-K product
//     over the scratch rows: CTA (64 input rows of layer l, split s) sums the
//     32-row chunks s, s + S, ... in order, staged through shared memory
//     with cp.async, into its own f32 partial.
//  C. fused_decode_bwd_f32_reduce sums the S partials of dW and the live
//     tiles' slices of db/dwa/dba, each in a fixed order.
// The scratch holds at most `cap` rows (f32, every layer's padded input and
// every g_z: 8,336 bytes a row at scene_config), so A and B run in batches
// of cap rows, as many as M rows could need; a batch past the live rows
// exits at once. Nothing is summed with atomics: dW, db, dwa, dba and every
// row gradient are the same bits run to run on a given card. No dW slice
// is read and written per tile: phase B reads each scratch row a few times
// (once per 64 inputs of its layer) and writes each partial once a batch.
#include "decode_f32.cuh"
#include "decode_live.cuh"

namespace {

using namespace df32;

constexpr int kKC = 8;      // phase A: weight rows per ring chunk
constexpr int kStages = 3;  // phase A: ring depth
constexpr int kKB = 32;   // phase B: scratch rows per staged chunk
constexpr int kBI = 64;   // phase B: dW rows (layer inputs) per CTA

size_t smem_a(const Dims& d) {
  return sizeof(float) * ((size_t)(d.kmax + d.H) * kLds +
                          (size_t)d.L * kRows * (d.H / 32) +
                          (size_t)kStages * kKC * kBN + 3 * kRows);
}

size_t smem_b() { return sizeof(float) * 2 * (size_t)kKB * (kBI + kBN); }

// floats of one tile's db/dwa/dba slice
__host__ __device__ inline int slice_floats(const Dims& d) {
  return d.L * d.H + d.H + 1;
}

// phase B's CTAs along x: ceil(in_l / kBI) for each layer
inline int dw_blocks(const Dims& d) {
  int n = 0;
  for (int l = 0; l < d.L; ++l) n += (d.in[l] + kBI - 1) / kBI;
  return n;
}

// float offset of layer l's scratch inputs ([cap][kq_l], layer after layer)
__device__ __forceinline__ size_t act_at(const Dims& d, int l, int cap) {
  size_t o = 0;
  for (int j = 0; j < l; ++j) o += d.kq[j];
  return o * cap;
}

// rows x 4*n4 floats of the transposed tile S (element (r, c) at
// S[c * kLds + r]) to dst, row r at dst + r * ld; consecutive threads take
// consecutive rows, so the shared-memory reads do not conflict
__device__ __forceinline__ void store_rows(const float* S, int n4, float* dst,
                                           int ld) {
  for (int i = threadIdx.x; i < kRows * n4; i += kThreads) {
    const int q = i / kRows, r = i - q * kRows;
    const float* s = S + 4 * q * kLds + r;
    *reinterpret_cast<float4*>(dst + (size_t)r * ld + 4 * q) =
        make_float4(s[0], s[kLds], s[2 * kLds], s[3 * kLds]);
  }
}

__device__ __forceinline__ bool zsign(const unsigned* masks, int HW, int l,
                                      int r, int c) {
  return (masks[(l * kRows + r) * HW + (c >> 5)] >> (c & 31)) & 1u;
}

// Phase A for tiles t0 + blockIdx.x, + gridDim.x, ... below t1 and the
// live rows' tiles. act/gz: the batch's scratch (row (t - t0) * 64 + r).
__global__ void __launch_bounds__(kThreads, 1)
fused_decode_bwd_f32_rows(
    const float* __restrict__ feat, const float* __restrict__ dists,
    const float* __restrict__ extras, const float* __restrict__ w,
    const float* __restrict__ W, const float* __restrict__ bias,
    const float* __restrict__ wa, const float* __restrict__ ba,
    const float* __restrict__ gf, const float* __restrict__ ga, Dims d,
    float slope, const int* __restrict__ list, const int* __restrict__ count,
    int t0, int t1, int cap, float* __restrict__ g_feat,
    float* __restrict__ g_dists, float* __restrict__ g_extras,
    float* __restrict__ g_w, float* __restrict__ act, float* __restrict__ gz,
    float* __restrict__ slices) {
  extern __shared__ __align__(16) float smem[];
  float* X = smem;                        // [kmax][kLds]: acts, then g_h
  float* Gz = X + d.kmax * kLds;          // [H][kLds]: a layer's g_z
  unsigned* masks = reinterpret_cast<unsigned*>(Gz + d.H * kLds);
  float* ring = reinterpret_cast<float*>(masks + d.L * kRows * (d.H / 32));
  float* w_s = ring + kStages * kKC * kBN;  // [kRows]
  float* gza_s = w_s + kRows;               // [kRows]
  int* m_s = reinterpret_cast<int*>(gza_s + kRows);  // [kRows], -1: none
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = d.H, K = d.K, L = d.L, HW = d.H / 32;
  const int Fi = d.Fi, Dd = d.Dd, E = d.E, Ff = d.Ff, Fd = d.Fd;
  const int nrows = *count * K;
  const int ntiles = (nrows + kRows - 1) / kRows;
  const int tend = t1 < ntiles ? t1 : ntiles;
  const int r0 = tile_r0(), c0 = tile_c0();
  zero_tile(X, d.kmax);

  for (int t = t0 + blockIdx.x; t < tend; t += gridDim.x) {
    const size_t jb = (size_t)(t - t0) * kRows;  // the tile's scratch row
    float* slice = slices + (size_t)t * slice_floats(d);
    for (int c = 0; c < kStages - 1; ++c)
      issue_chunk<kKC, kStages>(d, W, c, true, ring);
    for (int r = tid; r < kRows; r += kThreads) {
      const int j = t * kRows + r;
      const int m = j < nrows ? list[j / K] * K + j % K : -1;
      m_s[r] = m;
      w_s[r] = m >= 0 ? w[m] : 0.f;
    }
    for (int i = tid; i < L * kRows * HW; i += kThreads) masks[i] = 0u;
    __syncthreads();
    build_x(d, feat, dists, m_s, X);
    __syncthreads();
    store_rows(X, d.kq[0] / 4, act + jb * d.kq[0], d.kq[0]);

    // forward recompute; layer l's output overwrites its input in place
    float acc[8][8];
    int c = 0;
    for (int l = 0; l < L; ++l) {
      c = forward_product<kKC, kStages>(d, W, l, c, true, X, ring, acc, r0,
                                        c0);
      __syncthreads();  // every warp has read this layer's input
      const float* bl = bias + l * H;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tile_col(c0, j);
        const float bj = col < H ? __ldg(bl + col) : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] += bj;
      }
      // the z signs: 8 lanes (lane & 7) share each row's 32-column word
      unsigned* ml = masks + l * kRows * HW;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        unsigned b0 = 0, b1 = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b0 |= (acc[i][j] > 0.f ? 1u : 0u) << ((lane & 7) * 4 + j);
          b1 |= (acc[i][4 + j] > 0.f ? 1u : 0u) << ((lane & 7) * 4 + j);
        }
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) {
          b0 |= __shfl_xor_sync(0xffffffffu, b0, off);
          b1 |= __shfl_xor_sync(0xffffffffu, b1, off);
        }
        if ((lane & 7) == 0) {
          if (c0 / 32 < HW) ml[(r0 + i) * HW + c0 / 32] = b0;
          if ((c0 + 128) / 32 < HW) ml[(r0 + i) * HW + (c0 + 128) / 32] = b1;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tile_col(c0, j);
        if (col < H) {
          float o[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            o[i] = acc[i][j] > 0.f ? acc[i][j] : acc[i][j] * slope;
          float* dst = X + col * kLds + r0;
          *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
          *reinterpret_cast<float4*>(dst + 4) =
              make_float4(o[4], o[5], o[6], o[7]);
        }
      }
      if (l == d.L1 - 1) put_extras(d, extras, m_s, X);
      __syncthreads();
      if (l + 1 < L)
        store_rows(X, d.kq[l + 1] / 4,
                   act + act_at(d, l + 1, cap) + jb * d.kq[l + 1],
                   d.kq[l + 1]);
    }

    // alpha head per row (warp w takes rows 8w .. 8w + 7): g_w and g_za
    for (int r = warp * 8; r < warp * 8 + 8; ++r) {
      const int m = m_s[r];
      const bool valid = m >= 0;
      const float* gfr = gf + (size_t)(valid ? m / K : 0) * H;
      float pa = 0.f, pg = 0.f;
      for (int col = lane; col < H; col += 32) {
        const float hv = X[col * kLds + r];
        pa = fmaf(hv, __ldg(wa + col), pa);
        pg = fmaf(hv, valid ? __ldg(gfr + col) : 0.f, pg);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        pa += __shfl_xor_sync(0xffffffffu, pa, off);
        pg += __shfl_xor_sync(0xffffffffu, pg, off);
      }
      if (lane == 0) {
        const float gav = valid ? ga[m / K] : 0.f;
        const float x = pa + __ldg(ba) - 1.f;
        const float sp = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
        const float sig = 1.f / (1.f + expf(-x));
        gza_s[r] = gav * w_s[r] * sig;
        if (valid) g_w[m] = pg + sp * gav;
      }
    }
    __syncthreads();
    // the tile's dwa, dba; the last layer's g_z = (g_f w + g_za wa) *
    // leaky'(z) and its db
    for (int col = tid; col < H; col += kThreads) {
      const float wac = __ldg(wa + col);
      float sa = 0.f, sb = 0.f;
      for (int r = 0; r < kRows; ++r) {
        sa = fmaf(X[col * kLds + r], gza_s[r], sa);
        const int m = m_s[r];
        const float gfv = m >= 0 ? gf[(size_t)(m / K) * H + col] : 0.f;
        const float g = (gfv * w_s[r] + gza_s[r] * wac) *
                        (zsign(masks, HW, L - 1, r, col) ? 1.f : slope);
        sb += g;
        Gz[col * kLds + r] = g;
      }
      slice[L * H + col] = sa;
      slice[(L - 1) * H + col] = sb;
    }
    if (tid == 0) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s += gza_s[r];
      slice[L * H + H] = s;
    }
    __syncthreads();

    // block3 then block1, in reverse: g_h = g_z W^T into X
    for (int l = L - 1; l >= 0; --l) {
      store_rows(Gz, H / 4, gz + ((size_t)l * cap + jb) * H, H);
      const int kq = d.kq[l];
      for (int cb = 0; cb < kq; cb += kBN) {
        zero8x8(acc);
        for (int kk = 0; kk < H; kk += kKC, ++c) {
          const float* st = next_chunk<kKC, kStages>(d, W, c, true, ring);
          mm<kKC>(acc, Gz + kk * kLds, kLds, st, kBN, r0, c0);
        }
        const int ncol = kq - cb < kBN ? kq - cb : kBN;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = tile_col(c0, j);
          if (col < ncol) {
            float* dst = X + (cb + col) * kLds + r0;
            *reinterpret_cast<float4*>(dst) =
                make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
            *reinterpret_cast<float4*>(dst + 4) =
                make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
          }
        }
      }
      __syncthreads();  // g_h in X; every warp has read Gz
      if (l == d.L1) {
        for (int i = tid; i < kRows * E; i += kThreads) {
          const int r = i / E, e = i - r * E;
          const int m = m_s[r];
          if (m >= 0) g_extras[(size_t)m * E + e] = X[(H + e) * kLds + r];
        }
      }
      if (l > 0) {
        for (int col = tid; col < H; col += kThreads) {
          float s = 0.f;
          for (int r = 0; r < kRows; ++r) {
            const float g = X[col * kLds + r] *
                            (zsign(masks, HW, l - 1, r, col) ? 1.f : slope);
            s += g;
            Gz[col * kLds + r] = g;
          }
          slice[(l - 1) * H + col] = s;
        }
      } else {
        // PE backward: X holds g_x [x1][kRows]
        for (int i = tid; i < kRows * Fi; i += kThreads) {
          const int r = i / Fi, ch = i - r * Fi;
          const int m = m_s[r];
          if (m < 0) continue;
          const float fv = feat[(size_t)m * Fi + ch];
          float g = X[ch * kLds + r];
          for (int f = 0; f < Ff; ++f) {
            const float sc = (float)(1 << f);
            const float b = fv * sc;
            const int q = Fi + (ch * Ff + f) * 2;
            g = g + sc * (X[q * kLds + r] * cosf(b) -
                          X[(q + 1) * kLds + r] * sinf(b));
          }
          g_feat[(size_t)m * Fi + ch] = g;
        }
        const int pe_d = Fi + 2 * Ff * Fi;
        for (int i = tid; i < kRows * Dd; i += kThreads) {
          const int r = i / Dd, ch = i - r * Dd;
          const int m = m_s[r];
          if (m < 0) continue;
          float g;
          if (Fd > 0) {
            const float dv = dists[(size_t)m * Dd + ch];
            g = 0.f;
            for (int f = 0; f < Fd; ++f) {
              const float sc = (float)(1 << f);
              const float b = dv * sc;
              const int q = pe_d + (ch * Fd + f) * 2;
              g = g + sc * (X[q * kLds + r] * cosf(b) -
                            X[(q + 1) * kLds + r] * sinf(b));
            }
          } else {
            g = X[(pe_d + ch) * kLds + r];
          }
          g_dists[(size_t)m * Dd + ch] = g;
        }
      }
      __syncthreads();
    }
  }
  cp_async_wait<0>();
}

// Phase B for one batch: partial[s] of dW_l[i0 : i0 + 64, :] (+)= the sum
// over the batch's 32-row chunks s, s + S, ... of act_l^T g_z_l. `first`:
// the batch that writes the partials (later batches add to them).
__global__ void __launch_bounds__(kThreads, 2)
fused_decode_bwd_f32_dw(const float* __restrict__ act,
                        const float* __restrict__ gz, Dims d,
                        const int* __restrict__ count, int t0, int cap,
                        int first, float* __restrict__ partial) {
  extern __shared__ __align__(16) float smem[];
  int l = 0, ib = blockIdx.x;
  while (l < d.L - 1 && ib >= (d.in[l] + kBI - 1) / kBI) {
    ib -= (d.in[l] + kBI - 1) / kBI;
    ++l;
  }
  const int S = gridDim.y, s = blockIdx.y;
  const int H = d.H, kq = d.kq[l], i0 = ib * kBI;
  int rows = *count * d.K - t0 * kRows;  // the batch's live rows
  rows = rows < 0 ? 0 : (rows > cap ? cap : rows);
  const int nch = (rows + kRows - 1) / kRows * (kRows / kKB);
  if (!first && s >= nch) return;
  const float* A = act + act_at(d, l, cap);
  const float* B = gz + (size_t)l * cap * H;
  const int tid = threadIdx.x;
  auto load = [&](int ch, int stage) {
    float* As = smem + stage * kKB * (kBI + kBN);
    float* Bs = As + kKB * kBI;
    for (int p = tid; p < kKB * (kBI / 4); p += kThreads) {
      const int rr = p / (kBI / 4), q = p - rr * (kBI / 4);
      const int col = i0 + 4 * q;
      const bool ok = col < kq;
      cp_async16_or_zero(As + rr * kBI + 4 * q,
                         ok ? A + (size_t)(ch * kKB + rr) * kq + col : A, ok);
    }
    const int h4 = H / 4;
    for (int p = tid; p < kKB * h4; p += kThreads) {
      const int rr = p / h4, q = p - rr * h4;
      cp_async16(Bs + rr * kBN + 4 * q, B + (size_t)(ch * kKB + rr) * H + 4 * q);
    }
  };
  const int r0 = tile_r0(), c0 = tile_c0();
  float acc[8][8];
  zero8x8(acc);
  int ch = s, stage = 0;
  if (ch < nch) load(ch, 0);
  cp_async_commit();
  while (ch < nch) {
    const int cn = ch + S;
    if (cn < nch) load(cn, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* As = smem + stage * kKB * (kBI + kBN);
    mm<kKB>(acc, As, kBI, As + kKB * kBI, kBN, r0, c0);
    __syncthreads();  // the stage is free for the load after next
    ch = cn;
    stage ^= 1;
  }
  cp_async_wait<0>();

  float* out = partial + (size_t)s * d.Ps + d.pw[l];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = i0 + r0 + i;
    if (row >= d.in[l]) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = c0 + 128 * h;
      if (col >= H) continue;
      float4* p = reinterpret_cast<float4*>(out + (size_t)row * H + col);
      float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                             acc[i][4 * h + 2], acc[i][4 * h + 3]);
      if (!first) {
        const float4 o = *p;
        v.x += o.x; v.y += o.y; v.z += o.z; v.w += o.w;
      }
      *p = v;
    }
  }
}

// Phase C: out[i] for every parameter i, in a fixed order: dW from the S
// phase-B partials, db/dwa/dba from the live tiles' slices. Block (32, 8):
// x takes 32 consecutive parameters, y an eighth of the sources; the eight
// sums are added in y order.
__global__ void fused_decode_bwd_f32_reduce(const float* __restrict__ partial,
                                            int S,
                                            const float* __restrict__ slices,
                                            const int* __restrict__ count,
                                            Dims d, float* __restrict__ out) {
  __shared__ float part[8][33];
  const int i = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (i < d.P) {
    int q = -1;  // the parameter's place in a tile slice, if it has one
    if (i >= d.pwa) {
      q = d.L * d.H + (i - d.pwa);
    } else {
      for (int l = 0; l < d.L; ++l)
        if (i >= d.pb[l] && i < d.pb[l] + d.H) q = l * d.H + (i - d.pb[l]);
    }
    if (q < 0) {
      for (int k = threadIdx.y; k < S; k += 8) s += partial[(size_t)k * d.Ps + i];
    } else {
      const int ntiles = (*count * d.K + kRows - 1) / kRows;
      const int ns = slice_floats(d);
      for (int t = threadIdx.y; t < ntiles; t += 8)
        s += slices[(size_t)t * ns + q];
    }
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < d.P) {
    float r = 0.f;
    for (int y = 0; y < 8; ++y) r += part[y][threadIdx.x];
    out[i] = r;
  }
}

}  // namespace

// Shared memory of one CTA of phase A and of phase B for these dims (0 if
// the kernels do not take them), for the wrapper's envelope check.
extern "C" int fused_decode_bwd_smem(int Fi, int Dd, int E, int Ff, int Fd,
                                     int H, int K, int L1, int L3,
                                     int* phase_a, int* phase_b) {
  const Dims d = make_dims(0, Fi, Dd, E, Ff, Fd, H, K, L1, L3);
  *phase_a = takes(d) ? (int)smem_a(d) : 0;
  *phase_b = takes(d) ? (int)smem_b() : 0;
  return 0;
}

// W: the packed weights (pack_f32_weights, both streams); bias [L][H];
// flags [G] bytes, counts [ceil(G / 1024)], list [G], count [1]: the list's
// scratch; act [cap][sum kq] and gz [L][cap][H]: the batch scratch (cap a
// multiple of 64); slices [ceil(M / 64)][L*H + H + 1]; partial [splits][P
// rounded up to 4]; dparams [P]: the parameter gradients in _flatten order.
extern "C" int fused_decode_bwd_launch(
    const float* feat, const float* dists, const float* extras,
    const float* w, const float* W, const float* bias, const float* wa,
    const float* ba, const float* g_fagg, const float* g_alpha, int M, int Fi,
    int Dd, int E, int Ff, int Fd, int H, int K, int L1, int L3, float slope,
    float* g_feat, float* g_dists, float* g_extras, float* g_w, void* flags,
    int* counts, int* list, int* count, float* act, float* gz, int cap,
    float* slices, float* partial, int splits, float* dparams,
    void* stream) {
  const Dims d = make_dims(M, Fi, Dd, E, Ff, Fd, H, K, L1, L3);
  if (!takes(d) || splits < 1 || cap < kRows || cap % kRows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0) return (int)cudaMemsetAsync(dparams, 0, sizeof(float) * d.P, s);
  dlive::Owned own{{g_feat, g_dists, g_extras, g_w},
                   {K * Fi, K * Dd, K * E, K}};
  cudaError_t e = dlive::build(w, g_fagg, g_alpha, d.G, K, H, own,
                               static_cast<unsigned char*>(flags), counts,
                               list, count, s);
  if (e != cudaSuccess) return (int)e;
  const size_t sa = smem_a(d), sb = smem_b();
  e = cudaFuncSetAttribute(fused_decode_bwd_f32_rows,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sa);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(fused_decode_bwd_f32_dw,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sb);
  if (e != cudaSuccess) return (int)e;
  const int cap_tiles = cap / kRows;
  int grid = 0;
  int err = persistent_grid((const void*)fused_decode_bwd_f32_rows, sa,
                            cap_tiles, &grid);
  if (err) return err;
  const int max_tiles = (M + kRows - 1) / kRows;
  const dim3 gb(dw_blocks(d), splits);
  for (int b = 0; b * cap_tiles < max_tiles; ++b) {
    const int t0 = b * cap_tiles;
    fused_decode_bwd_f32_rows<<<grid, kThreads, sa, s>>>(
        feat, dists, extras, w, W, bias, wa, ba, g_fagg, g_alpha, d, slope,
        list, count, t0, t0 + cap_tiles, cap, g_feat, g_dists, g_extras, g_w,
        act, gz, slices);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    fused_decode_bwd_f32_dw<<<gb, kThreads, sb, s>>>(act, gz, d, count, t0,
                                                     cap, b == 0, partial);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  fused_decode_bwd_f32_reduce<<<(d.P + 31) / 32, dim3(32, 8), 0, s>>>(
      partial, splits, slices, count, d, dparams);
  return (int)cudaGetLastError();
}
