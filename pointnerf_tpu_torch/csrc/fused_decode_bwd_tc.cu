// K4 on tensor cores: the fused decode backward, bf16 route.
//
// Replaces: pointnerf_tpu/ops/pallas_decode.py::fused_decode, backward
// (_bwd_rule :430 -> pallas_call at :467 of _bwd_kernel :235), for
// DecodeSpec with bf16 set. The f32 route keeps csrc/fused_decode_bwd.cu.
//
// Function: that of csrc/fused_decode_bwd.cu, with its bf16 rounding points
// (feat, dists, extras, w, x and every hidden activation are bf16 values,
// the block weights arrive as bf16, every g_z is rounded to bf16 before its
// two products; db, the alpha head, the PE backward and all accumulation are
// f32). The products take bf16 operands and accumulate in f32 on the tensor
// cores, which adds no rounding point.
//
// Bound on the H100, at the main path's shapes (bench_config, M = 290,816
// rows of which 131,099 carry a weight): operations, 3 x K3's over the live
// rows, ~216 GFLOP = 0.216 ms at 989 TFLOP/s bf16; the function's own bytes
// (inputs read once, outputs written once) take 0.035 ms (chip_smoke.py
// computes both from the run's inputs). This design adds bytes the function
// does not need: the two-phase dW moves every live row's layer inputs
// (2,118 B; 2,176 B padded) and g_z (2,048 B) as bf16 through device
// memory, written once and read once, ~1.1 GB = ~0.33 ms at 3.35 TB/s.
//
// Design, three launches on the caller's stream:
//  A. fused_decode_bwd_tc_rows, one CTA of 8 warps per tile of 64 rows
//     (whole K-groups). It recomputes the forward with warp-level mma.sync
//     m16n8k16 products, the activations in shared memory as bf16 and each
//     layer's z signs as bits; it writes every layer's input to a scratch
//     buffer in device memory (bf16: exact, they are bf16 values). Then the
//     alpha head and g_w, g_za, dwa, dba in f32; the chain g_z -> bf16 ->
//     scratch -> g_h = g_zr W^T on the tensor cores, layer by layer, with db
//     summed per tile in f32; g_extras; the PE backward to g_feat, g_dists.
//     Its per-tile db/dwa/dba sums go to a per-tile slice. The weights
//     stream through a 3-stage cp.async ring in 32-row chunks, forward
//     chunks then W^T column blocks, shared by the 8 warps; each chunk is
//     summed from 0 and added in f32 (see mma_chunk).
//  B. fused_decode_bwd_tc_dw: dW_l = act_l^T g_zr_l on the tensor cores, a
//     split-K product over the tiles: CTA (column block of 64, layer l,
//     split s) sums the live tiles t = s, s + S, ... in order into its own
//     f32 partial, each tile from 0 and then added in f32.
//  C. fused_decode_bwd_tc_reduce sums the S partials of dW and the live
//     tiles' slices of db/dwa/dba, each in a fixed order: dW is bit-identical
//     run to run (no atomics).
// Dead tiles: a tile whose rows all have w == 0 and whose groups all have
// zero g_fagg and g_alpha has all-zero gradients (g_h = g_f w + g_za wa and
// g_za is proportional to w; g_w = h . g_f + softplus(za - 1) g_a). Phase A
// decides this on the device, writes zero row gradients for it and flags
// it dead; phases B and C skip it. A tile with w == 0 but a nonzero g_fagg
// or g_alpha is computed, so g_w stays exact there.
#include "decode_tc.cuh"

namespace {

using namespace dtc;

constexpr int kRows = 64;       // rows per phase-A tile
constexpr int kThreads = 256;   // 8 warps
constexpr int kNT = kMaxIn / 16;  // n8 tiles per warp: kp / 2 <= 160 columns
constexpr int kBN = 64;         // phase B: dW columns per CTA
constexpr int kBMT = kMaxIn / 64;  // phase B: m16 tiles per warp (4 warps)

struct Shape {  // phase A shared memory, in bytes from the base
  int lda, gxs, ldg, stage_elems;
  size_t u, gr, masks, ring, rows, total;
};

__host__ __device__ inline Shape shape_a(const Dims& d) {
  Shape s;
  s.lda = d.kmax + kPad;    // bf16 activations, forward
  s.gxs = d.kmax + 4;       // f32 input gradients, backward (same bytes)
  s.ldg = d.H + kPad;       // bf16 g_zr
  const int f = kKC * (d.H + kPad), b = d.kmax * (kKC + kPad);
  s.stage_elems = f > b ? f : b;
  const size_t ua = (size_t)kRows * s.lda * sizeof(bf16);
  const size_t ub = (size_t)kRows * s.gxs * sizeof(float);
  s.u = 0;
  s.gr = ua > ub ? ua : ub;
  s.masks = s.gr + (size_t)kRows * s.ldg * sizeof(bf16);
  s.ring = s.masks + (size_t)d.L * kRows * (d.H / 32) * sizeof(unsigned);
  s.ring = (s.ring + 15) / 16 * 16;
  s.rows = s.ring + (size_t)kStages * s.stage_elems * sizeof(bf16);
  s.total = s.rows + 2 * kRows * sizeof(float);
  return s;
}

size_t smem_b(const Dims& d) {
  return 2 * sizeof(bf16) * (size_t)kRows * ((d.kmax + kPad) + (kBN + kPad));
}

// floats of one tile's db/dwa/dba slice
__host__ __device__ inline int slice_floats(const Dims& d) {
  return d.L * d.H + d.H + 1;
}

// row r of layer l's scratch input of tile t, and of its g_zr
__device__ __forceinline__ bf16* act_at(const Dims& d, bf16* act, int ntiles,
                                        int l, int t) {
  int off = 0;
  for (int j = 0; j < l; ++j) off += d.kp[j];
  return act + (size_t)ntiles * kRows * off + (size_t)t * kRows * d.kp[l];
}

__device__ __forceinline__ bf16* gz_at(const Dims& d, bf16* gz, int ntiles,
                                       int l, int t) {
  return gz + ((size_t)l * ntiles + t) * kRows * d.H;
}

// copy rows x cols bf16 (cols % 8 == 0) from shared (row stride lds) to a
// dense [rows][cols] block in device memory, 16 bytes at a time
__device__ __forceinline__ void store_rows(const bf16* src, int lds,
                                           bf16* dst, int rows, int cols) {
  const int per_row = cols / 8;
  for (int p = threadIdx.x; p < rows * per_row; p += blockDim.x) {
    const int r = p / per_row, q = p - r * per_row;
    *reinterpret_cast<uint4*>(dst + (size_t)r * cols + q * 8) =
        *reinterpret_cast<const uint4*>(src + r * lds + q * 8);
  }
}

__device__ __forceinline__ bool zsign(const unsigned* masks, int HW, int l,
                                      int r, int c) {
  return (masks[(l * kRows + r) * HW + (c >> 5)] >> (c & 31)) & 1u;
}

__global__ void __launch_bounds__(kThreads, 1)
fused_decode_bwd_tc_rows(const float* __restrict__ feat,
                         const float* __restrict__ dists,
                         const float* __restrict__ extras,
                         const float* __restrict__ w,
                         const bf16* __restrict__ W,
                         const float* __restrict__ bias,
                         const float* __restrict__ wa,
                         const float* __restrict__ ba,
                         const float* __restrict__ gf,
                         const float* __restrict__ ga, Dims d, float slope,
                         float* __restrict__ g_feat,
                         float* __restrict__ g_dists,
                         float* __restrict__ g_extras,
                         float* __restrict__ g_w, bf16* __restrict__ act,
                         bf16* __restrict__ gz, int* __restrict__ flags,
                         float* __restrict__ slices) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Shape sh = shape_a(d);
  bf16* A = reinterpret_cast<bf16*>(smem_raw + sh.u);
  float* GX = reinterpret_cast<float*>(smem_raw + sh.u);  // aliases A
  bf16* Gr = reinterpret_cast<bf16*>(smem_raw + sh.gr);
  unsigned* masks = reinterpret_cast<unsigned*>(smem_raw + sh.masks);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + sh.ring);
  float* wr_s = reinterpret_cast<float*>(smem_raw + sh.rows);
  float* gza_s = wr_s + kRows;
  const int lda = sh.lda, gxs = sh.gxs, ldg = sh.ldg;
  const int stage_elems = sh.stage_elems;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = d.M, H = d.H, K = d.K, L = d.L, HW = d.H / 32;
  const int Fi = d.Fi, Dd = d.Dd, E = d.E, Ff = d.Ff, Fd = d.Fd;
  const int t = blockIdx.x, ntiles = gridDim.x;
  const int row0 = t * kRows;
  const int g0 = row0 / K, Mk = M / K;
  float* slice = slices + (size_t)t * slice_floats(d);

  // dead tile: no weight, and no upstream gradient on its groups
  int live = 0;
  for (int r = tid; r < kRows; r += kThreads) {
    const int m = row0 + r;
    live |= (m < M && w[m] != 0.f);
  }
  for (int i = tid; i < (kRows / K) * H; i += kThreads) {
    const int g = g0 + i / H;
    live |= (g < Mk && gf[(size_t)g * H + i % H] != 0.f);
  }
  for (int i = tid; i < kRows / K; i += kThreads)
    live |= (g0 + i < Mk && ga[g0 + i] != 0.f);
  if (!__syncthreads_or(live)) {
    for (int i = tid; i < kRows * Fi; i += kThreads)
      if (row0 + i / Fi < M) g_feat[(size_t)row0 * Fi + i] = 0.f;
    for (int i = tid; i < kRows * Dd; i += kThreads)
      if (row0 + i / Dd < M) g_dists[(size_t)row0 * Dd + i] = 0.f;
    for (int i = tid; i < kRows * E; i += kThreads)
      if (row0 + i / E < M) g_extras[(size_t)row0 * E + i] = 0.f;
    for (int r = tid; r < kRows; r += kThreads)
      if (row0 + r < M) g_w[row0 + r] = 0.f;
    if (tid == 0) flags[t] = 0;
    return;
  }
  if (tid == 0) flags[t] = 1;

  for (int c = 0; c < kStages - 1; ++c)
    issue_chunk(d, W, c, true, ring, stage_elems);
  build_x(d, feat, dists, row0, kRows, A, lda);
  for (int i = tid; i < L * kRows * HW; i += kThreads) masks[i] = 0u;
  for (int r = tid; r < kRows; r += kThreads) {
    const int m = row0 + r;
    wr_s[r] = m < M ? round_bf16(w[m]) : 0.f;
  }
  __syncthreads();
  store_rows(A, lda, act_at(d, act, ntiles, 0, t), kRows, d.kp[0]);

  const int arow = (warp & 3) * 16;  // one m16 tile per warp
  const int half = warp >> 2;        // which half of the columns
  float acc[1][kNT][4];
  int c = 0;

  // forward recompute; layer l's output overwrites its input in place
  for (int l = 0; l < L; ++l) {
    zero_acc(acc);
    const int bn0 = half * (H / 2);
    for (int kk = 0; kk < d.kp[l]; kk += kKC, ++c) {
      const bf16* st = next_chunk(d, W, c, true, ring, stage_elems);
      mma_chunk<1, kNT, true>(acc, H / 16, A, lda, arow, kk, st, H + kPad,
                              bn0);
    }
    __syncthreads();
    const float* bl = bias + l * H;
    unsigned* ml = masks + l * kRows * HW;
    for_acc(acc, H / 16, arow, bn0, [&](int r, int col, float v0, float v1) {
      float z0 = v0 + __ldg(bl + col), z1 = v1 + __ldg(bl + col + 1);
      const unsigned bits = (z0 > 0.f ? 1u : 0u) | (z1 > 0.f ? 2u : 0u);
      if (bits) atomicOr(ml + r * HW + (col >> 5), bits << (col & 31));
      z0 = z0 > 0.f ? z0 : z0 * slope;
      z1 = z1 > 0.f ? z1 : z1 * slope;
      *reinterpret_cast<__nv_bfloat162*>(A + r * lda + col) =
          __floats2bfloat162_rn(z0, z1);
    });
    if (l == d.L1 - 1) put_extras(d, extras, row0, kRows, A, lda);
    __syncthreads();
    if (l + 1 < L)
      store_rows(A, lda, act_at(d, act, ntiles, l + 1, t), kRows, d.kp[l + 1]);
  }

  // alpha head per row (warp w takes rows 8w .. 8w + 7): g_w and g_za
  for (int r = warp * 8; r < warp * 8 + 8; ++r) {
    const int m = row0 + r;
    const bool valid = m < M;
    const float* gfr = gf + (size_t)(valid ? m / K : 0) * H;
    float pa = 0.f, pg = 0.f;
    for (int col = lane; col < H; col += 32) {
      const float hv = __bfloat162float(A[r * lda + col]);
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
      gza_s[r] = gav * wr_s[r] * sig;
      if (valid) g_w[m] = pg + sp * gav;
    }
  }
  __syncthreads();
  for (int col = tid; col < H; col += kThreads) {
    float s = 0.f;
    for (int r = 0; r < kRows; ++r)
      s = fmaf(__bfloat162float(A[r * lda + col]), gza_s[r], s);
    slice[L * H + col] = s;
  }
  if (tid == 0) {
    float s = 0.f;
    for (int r = 0; r < kRows; ++r) s += gza_s[r];
    slice[L * H + H] = s;
  }
  __syncthreads();  // A (h_last) is dead from here; GX takes its place

  // the last layer's g_z = (g_f w + g_za wa) * leaky'(z); db; bf16 g_zr
  for (int col = tid; col < H; col += kThreads) {
    const float wac = __ldg(wa + col);
    float s = 0.f;
    for (int r = 0; r < kRows; ++r) {
      const int m = row0 + r;
      const float gfv = m < M ? gf[(size_t)(m / K) * H + col] : 0.f;
      const float gh = gfv * wr_s[r] + gza_s[r] * wac;
      const float g = gh * (zsign(masks, HW, L - 1, r, col) ? 1.f : slope);
      s += g;
      Gr[r * ldg + col] = __float2bfloat16_rn(g);
    }
    slice[(L - 1) * H + col] = s;
  }
  __syncthreads();

  // block3 then block1, in reverse: g_h = g_zr W^T on the tensor cores
  for (int l = L - 1; l >= 0; --l) {
    store_rows(Gr, ldg, gz_at(d, gz, ntiles, l, t), kRows, H);
    zero_acc(acc);
    const int kp = d.kp[l];
    const int bn0 = half * (kp / 2);
    for (int kk = 0; kk < H; kk += kKC, ++c) {
      const bf16* st = next_chunk(d, W, c, true, ring, stage_elems);
      mma_chunk<1, kNT, false>(acc, kp / 16, Gr, ldg, arow, kk, st,
                               kKC + kPad, bn0);
    }
    __syncthreads();  // every warp has read g_zr
    for_acc(acc, kp / 16, arow, bn0, [&](int r, int col, float v0, float v1) {
      *reinterpret_cast<float2*>(GX + r * gxs + col) = make_float2(v0, v1);
    });
    __syncthreads();
    if (l == d.L1) {
      for (int i = tid; i < kRows * E; i += kThreads) {
        const int r = i / E, cc = i - r * E;
        if (row0 + r < M)
          g_extras[(size_t)(row0 + r) * E + cc] = GX[r * gxs + H + cc];
      }
    }
    if (l > 0) {
      for (int col = tid; col < H; col += kThreads) {
        float s = 0.f;
        for (int r = 0; r < kRows; ++r) {
          const float g = GX[r * gxs + col] *
                          (zsign(masks, HW, l - 1, r, col) ? 1.f : slope);
          s += g;
          Gr[r * ldg + col] = __float2bfloat16_rn(g);
        }
        slice[(l - 1) * H + col] = s;
      }
    } else {
      // PE backward: GX holds g_x [kRows][x1]
      for (int i = tid; i < kRows * Fi; i += kThreads) {
        const int r = i / Fi, ch = i - r * Fi;
        const int m = row0 + r;
        if (m >= M) continue;
        const float* gx = GX + r * gxs;
        const float fv = round_bf16(feat[(size_t)m * Fi + ch]);
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
          const float dv = round_bf16(dists[(size_t)m * Dd + ch]);
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
    }
    __syncthreads();
  }
}

// Phase B: partial[s] of dW_l[:, n0 : n0 + 64] = sum over the live tiles
// t = s, s + S, ... of act_l[t]^T g_zr_l[t]. 8 warps: warp & 3 takes the
// m16 tiles (input rows) 4i + (warp & 3), warp >> 2 one 32-column half.
__global__ void __launch_bounds__(kThreads)
fused_decode_bwd_tc_dw(const bf16* __restrict__ act,
                       const bf16* __restrict__ gz,
                       const int* __restrict__ flags, Dims d, int ntiles,
                       float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n0 = blockIdx.x * kBN, l = blockIdx.y, s = blockIdx.z;
  const int S = gridDim.z, H = d.H, kp = d.kp[l];
  const int lda = kp + kPad, ldg = kBN + kPad;
  const int a_elems = kRows * (d.kmax + kPad), g_elems = kRows * ldg;
  bf16* base = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int ncol = H - n0 < kBN ? H - n0 : kBN;  // 32 or 64
  const bool active = wn * 32 < ncol;
  const int mtiles = kp / 16;
  const int j8 = lane >> 3, r8 = lane & 7;

  auto load = [&](int t, int stage) {
    bf16* As = base + stage * (a_elems + g_elems);
    bf16* Gs = As + a_elems;
    const bf16* asrc = act_at(d, const_cast<bf16*>(act), ntiles, l, t);
    const int apr = kp / 8;
    for (int p = tid; p < kRows * apr; p += kThreads) {
      const int r = p / apr, q = p - r * apr;
      cp_async16(As + r * lda + q * 8, asrc + (size_t)r * kp + q * 8);
    }
    const bf16* gsrc = gz_at(d, const_cast<bf16*>(gz), ntiles, l, t) + n0;
    const int gpr = ncol / 8;
    for (int p = tid; p < kRows * gpr; p += kThreads) {
      const int r = p / gpr, q = p - r * gpr;
      cp_async16(Gs + r * ldg + q * 8, gsrc + (size_t)r * H + q * 8);
    }
  };
  auto next_live = [&](int t) {
    while (t < ntiles && !flags[t]) t += S;
    return t;
  };

  float acc[kBMT][4][4], part[kBMT][4][4];
  zero_acc(acc);
  int t = next_live(s), stage = 0;
  if (t < ntiles) load(t, 0);
  cp_async_commit();
  while (t < ntiles) {
    const int tn = next_live(t + S);
    if (tn < ntiles) load(tn, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* As = base + stage * (a_elems + g_elems);
    const bf16* Gs = As + a_elems;
    if (active) {
      // each tile sums from 0 and joins acc in one IEEE add (see mma_chunk)
      zero_acc(part);
#pragma unroll
      for (int k16 = 0; k16 < kRows / 16; ++k16) {
        uint32_t b[2][4];
#pragma unroll
        for (int np = 0; np < 2; ++np)
          ldsm4t(b[np], Gs + (k16 * 16 + r8 + 8 * (j8 & 1)) * ldg + wn * 32 +
                            np * 16 + 8 * (j8 >> 1));
        uint32_t a[kBMT][4];
#pragma unroll
        for (int i = 0; i < kBMT; ++i)
          if (4 * i + wm < mtiles)
            ldsm4t(a[i], As + (k16 * 16 + r8 + 8 * (j8 >> 1)) * lda +
                             (4 * i + wm) * 16 + 8 * (j8 & 1));
#pragma unroll
        for (int i = 0; i < kBMT; ++i) {
          if (4 * i + wm < mtiles) {
#pragma unroll
            for (int np = 0; np < 2; ++np) {
              mma16816(part[i][2 * np], a[i], b[np][0], b[np][1]);
              mma16816(part[i][2 * np + 1], a[i], b[np][2], b[np][3]);
            }
          }
        }
      }
      add_acc(acc, part, 4);
    }
    __syncthreads();  // the stage is free for the load after next
    t = tn;
    stage ^= 1;
  }
  cp_async_wait<0>();

  if (!active) return;
  const int g = lane >> 2, tq = lane & 3;
  float* out = partial + (size_t)s * d.Ps + d.pw[l];
#pragma unroll
  for (int i = 0; i < kBMT; ++i) {
    const int mt = 4 * i + wm;
    if (mt >= mtiles) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn * 32 + j * 8 + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt * 16 + g + 8 * h;
        if (row < d.in[l])
          *reinterpret_cast<float2*>(out + (size_t)row * H + col) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

// Phase C: out[i] for every parameter i, in a fixed order: dW from the S
// phase-B partials, db/dwa/dba from the live tiles' slices. Block (32, 8):
// x takes 32 consecutive parameters, y an eighth of the sources; the eight
// sums are added in y order.
__global__ void fused_decode_bwd_tc_reduce(const float* __restrict__ partial,
                                           int S,
                                           const float* __restrict__ slices,
                                           const int* __restrict__ flags,
                                           int ntiles, Dims d,
                                           float* __restrict__ out) {
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
    const int ns = slice_floats(d);
    if (q < 0) {
      for (int k = threadIdx.y; k < S; k += 8) s += partial[(size_t)k * d.Ps + i];
    } else {
      for (int k = threadIdx.y; k < ntiles; k += 8)
        if (flags[k]) s += slices[(size_t)k * ns + q];
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

// Shared memory of phase A and of phase B for these dims (0 if the kernels
// do not take them), for the wrapper's envelope check.
extern "C" int fused_decode_bwd_tc_smem(int Fi, int Dd, int E, int Ff,
                                        int Fd, int H, int K, int L1, int L3,
                                        int* phase_a, int* phase_b) {
  const Dims d = make_dims(0, Fi, Dd, E, Ff, Fd, H, K, L1, L3);
  *phase_a = takes(d) ? (int)shape_a(d).total : 0;
  *phase_b = takes(d) ? (int)smem_b(d) : 0;
  return 0;
}

// act: ntiles * 64 * sum(kp) bf16; gz: L * ntiles * 64 * H bf16; flags:
// ntiles ints; slices: ntiles * (L * H + H + 1) floats; partial: splits *
// (P rounded up to 4) floats; dparams: P floats, the parameter gradients in _flatten order.
extern "C" int fused_decode_bwd_tc_launch(
    const float* feat, const float* dists, const float* extras,
    const float* w, const void* W, const float* bias, const float* wa,
    const float* ba, const float* g_fagg, const float* g_alpha, int M, int Fi,
    int Dd, int E, int Ff, int Fd, int H, int K, int L1, int L3, float slope,
    float* g_feat, float* g_dists, float* g_extras, float* g_w, void* act,
    void* gz, int* flags, float* slices, float* partial, int splits,
    float* dparams, void* stream) {
  const Dims d = make_dims(M, Fi, Dd, E, Ff, Fd, H, K, L1, L3);
  if (!takes(d) || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0) return (int)cudaMemsetAsync(dparams, 0, sizeof(float) * d.P, s);
  const int ntiles = (M + kRows - 1) / kRows;
  const size_t sa = shape_a(d).total, sb = smem_b(d);
  cudaError_t e = cudaFuncSetAttribute(
      fused_decode_bwd_tc_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sa);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(fused_decode_bwd_tc_dw,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sb);
  if (e != cudaSuccess) return (int)e;
  fused_decode_bwd_tc_rows<<<ntiles, kThreads, sa, s>>>(
      feat, dists, extras, w, static_cast<const bf16*>(W), bias, wa, ba,
      g_fagg, g_alpha, d, slope, g_feat, g_dists, g_extras, g_w,
      static_cast<bf16*>(act), static_cast<bf16*>(gz), flags, slices);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const dim3 gb((H + kBN - 1) / kBN, d.L, splits);
  fused_decode_bwd_tc_dw<<<gb, kThreads, sb, s>>>(
      static_cast<const bf16*>(act), static_cast<const bf16*>(gz), flags, d,
      ntiles, partial);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  fused_decode_bwd_tc_reduce<<<(d.P + 31) / 32, dim3(32, 8), 0, s>>>(
      partial, splits, slices, flags, ntiles, d, dparams);
  return (int)cudaGetLastError();
}
