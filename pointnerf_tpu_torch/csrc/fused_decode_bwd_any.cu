// K4: fused decode backward, the general route.
//
// Replaces: pointnerf_tpu/ops/pallas_decode.py::fused_decode's custom-VJP
// backward (_bwd_rule -> pallas_call at :467 of _bwd_kernel), for every
// DecodeSpec inside JAX's fused envelope that the tuned kernels
// (fused_decode_bwd_tc.cu, bf16; fused_decode_bwd.cu, f32) do not take.
//
// Function (ops/fused_decode.py::fused_decode_bwd_plain, whose spec.bf16
// picks the rounding): the forward again, keeping each layer's input and
// the signs of its pre-activations; then per row
//   g_w  = h . g_fagg[g] + softplus(za - 1) g_alpha[g]
//   g_za = g_alpha[g] w sigmoid(za - 1);  g_h = g_fagg[g] w + g_za wa
// and down the layers g_z = g_h * (z > 0 ? 1 : slope), db += g_z,
// g_zr = rnd(g_z), dW += act^T g_zr, g_h = g_zr W^T (g_extras split off
// at block3's first layer), then the PE backward into g_feat and g_dists.
//
// Bound on the H100: operations, 3 x K3's (the forward again, g_h = g_z
// W^T and dW) on the rows that carry a weight, at 989 TFLOP/s (bf16) or 67
// (f32).
//
// Design, on the caller's stream (csrc/decode_any.cuh for the plan, the
// padding and the products):
//  0. the live-group list (csrc/decode_live.cuh) with K4's rule: a group is
//     live when a weight or its upstream gradient is nonzero; the pass
//     writes zeros into a dead group's row gradients. The live rows (the
//     live groups' K rows each, in list order) are what the phases visit.
//  A. k4_rows_tc (bf16) or k4_rows_cc: persistent CTAs walk tiles of T live
//     rows. A tile recomputes the forward through the plan's product,
//     keeping each layer's z signs as bits in shared memory and writing
//     each layer's input to a scratch buffer in device memory (bf16 on the
//     tensor cores: exact, they are bf16 values), and the last layer's
//     output after them (read by no phase: a check's view of the kernel's
//     roundings and branches, ops/fused_decode.py::general_bwd_scratch). Then the alpha head and
//     g_w, g_za in f32; the chain g_z -> rnd -> scratch -> g_h = g_zr W^T
//     layer by layer through the same product (the tensor cores read W_l
//     itself as the k-contiguous B operand; the CUDA cores W_l^T); db per
//     tile in f32; g_extras; the PE backward. The tile's db, dwa and dba
//     sums go to its own slice.
//  B. k4_dw_tc / k4_dw_cc: dW_l = act_l^T g_zr_l as a split-K product over
//     the scratch rows, tensor cores for bf16 (CTA = 128 inputs x 128
//     columns of one layer) and the register tile for f32 (64 x 256): split
//     s sums the 32-row chunks s, s + S, ... in order into its own f32
//     partial, each chunk from 0 and then added.
//  C. k4_slices sums the batch's tile slices in tile order into one vector
//     (db, dwa and dba are summed in f64, slices included);
//     k4_reduce adds the S partials of dW in order and takes db / dwa / dba
//     from that vector.
// The scratch holds `cap` rows, so A, B and the slice sum run in batches of
// cap rows, as many as M rows could need; a batch past the live rows exits
// at once (the first writes its partials, later ones add). No float
// atomics: every gradient is the same bits run to run on a given card. No
// dW slice is read and written per tile, and no per-CTA copy of the
// parameter vector exists.
#include "decode_any.cuh"

namespace {

using namespace dany;

constexpr int kRC = 32;         // phase B: scratch rows a staged chunk
constexpr int kTcBI = 128;      // phase B tensor cores: dW rows (inputs)
constexpr int kTcBJ = 128;      //   and columns a CTA
constexpr int kCcBI = 64;       // phase B CUDA cores: dW rows
constexpr int kCcBJ = 256;      //   and columns a CTA

__device__ __forceinline__ bool zsign(const unsigned* masks, int HW, int T,
                                      int l, int r, int c) {
  return (masks[((size_t)l * T + r) * HW + (c >> 5)] >> (c & 31)) & 1u;
}

// the live rows: the live groups' K rows each
__device__ __forceinline__ int live_rows(const Dims& d, const int* count) {
  return *count * d.K;
}

// rows x cols bf16 (cols % 8 == 0) from shared (row stride lds) to a dense
// [rows][cols] block in device memory, 16 bytes at a time
__device__ __forceinline__ void store_rows_bf16(const bf16* src, int lds,
                                                bf16* dst, int rows,
                                                int cols) {
  const int per = cols / 8;
  for (int p = threadIdx.x; p < rows * per; p += kThreads) {
    const int r = p / per, q = p - r * per;
    *reinterpret_cast<uint4*>(dst + (size_t)r * cols + q * 8) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * lds + q * 8);
  }
}

// the first `cols` (% 4 == 0) columns of the transposed tile S (element
// (r, c) at S[c * LD + r]) as rows r of dst (row stride cols)
__device__ __forceinline__ void store_rows_t(const float* S, int LD, int T,
                                             int cols, float* dst) {
  const int n4 = cols / 4;
  for (int i = threadIdx.x; i < T * n4; i += kThreads) {
    const int q = i / T, r = i - q * T;
    const float* s = S + (size_t)4 * q * LD + r;
    *reinterpret_cast<float4*>(dst + (size_t)r * cols + 4 * q) =
        make_float4(s[0], s[LD], s[2 * LD], s[3 * LD]);
  }
}

// The heads of a tile, a warp per row: g_w of each valid row and g_za
// into gza_s, from the last layer's h(r, c).
template <typename Hv>
__device__ __forceinline__ void heads(const Dims& d, const int* m_s,
                                      const float* w_s, float* gza_s,
                                      const float* __restrict__ wa,
                                      const float* __restrict__ ba,
                                      const float* __restrict__ gf,
                                      const float* __restrict__ ga,
                                      float* __restrict__ g_w, Hv h) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int H = d.H, K = d.K;
  for (int r = warp; r < d.T; r += kThreads / 32) {
    const int m = m_s[r];
    const bool valid = m >= 0;
    const float* gfr = gf + (size_t)(valid ? m / K : 0) * H;
    float pa = 0.f, pg = 0.f;
    for (int col = lane; col < H; col += 32) {
      const float hv = h(r, col);
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
      gza_s[r] = gav * w_s[r] * (1.f / (1.f + expf(-x)));
      if (valid) g_w[m] = pg + softplus(x) * gav;
    }
  }
}

// the tile's dwa and dba (slice entries L*H ...) from h(r, c) and g_za,
// summed in f64 (as db in layer_gz): dba and db are sums over every live
// row with much cancellation, which f32 partial sums would round to a
// share of their terms the plain version's tree sum does not lose
template <typename Hv>
__device__ __forceinline__ void head_sums(const Dims& d, const float* gza_s,
                                          double* slice, Hv h) {
  const int H = d.H, L = d.L;
  for (int col = threadIdx.x; col < H; col += kThreads) {
    double s = 0.0;
    for (int r = 0; r < d.T; ++r) s += (double)h(r, col) * gza_s[r];
    slice[L * H + col] = s;
  }
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int r = 0; r < d.T; ++r) s += gza_s[r];
    slice[L * H + H] = s;
  }
}

// g_z of layer l from g_h(r, c) (the last layer's: gh == nullptr, from the
// heads) times leaky'(z_l), for every padded column (zero past H); its
// column sums (db_l) into the slice; put(r, c, rnd(g_z)).
template <bool BF16, typename Gh, typename Put>
__device__ __forceinline__ void layer_gz(const Dims& d, int l, bool last,
                                         const int* m_s, const float* w_s,
                                         const float* gza_s,
                                         const unsigned* masks, int HW,
                                         const float* __restrict__ wa,
                                         const float* __restrict__ gf,
                                         float slope, double* slice, Gh gh,
                                         Put put) {
  const int H = d.H, K = d.K;
  for (int col = threadIdx.x; col < d.Hp; col += kThreads) {
    const bool real = col < H;
    const float wac = last && real ? __ldg(wa + col) : 0.f;
    double s = 0.0;
    for (int r = 0; r < d.T; ++r) {
      float g = 0.f;
      if (real) {
        float h;
        if (last) {
          const int m = m_s[r];
          const float gfv = m >= 0 ? gf[(size_t)(m / K) * H + col] : 0.f;
          h = gfv * w_s[r] + gza_s[r] * wac;
        } else {
          h = gh(r, col);
        }
        g = h * (zsign(masks, HW, d.T, l, r, col) ? 1.f : slope);
      }
      s += g;
      put(r, col, rnd<BF16>(g));
    }
    if (real) slice[l * H + col] = s;
  }
}

// g_extras and, at layer 0, the PE backward into g_feat and g_dists, from
// the input gradient gx(r, c), in the plain version's order
template <bool BF16, typename Gx>
__device__ __forceinline__ void pe_backward(const Dims& d, const int* m_s,
                                            const float* __restrict__ feat,
                                            const float* __restrict__ dists,
                                            float* __restrict__ g_feat,
                                            float* __restrict__ g_dists,
                                            Gx gx) {
  const int Fi = d.Fi, Dd = d.Dd, Ff = d.Ff, Fd = d.Fd;
  const int pe_d = Fi + 2 * Ff * Fi;
  for (int i = threadIdx.x; i < d.T * Fi; i += kThreads) {
    const int r = i / Fi, ch = i - r * Fi;
    const int m = m_s[r];
    if (m < 0) continue;
    const float fv = rnd<BF16>(feat[(size_t)m * Fi + ch]);
    float g = gx(r, ch);
    for (int f = 0; f < Ff; ++f) {
      const float sc = (float)(1 << f), b = fv * sc;
      const int q = Fi + (ch * Ff + f) * 2;
      g = g + sc * (gx(r, q) * cosf(b) - gx(r, q + 1) * sinf(b));
    }
    g_feat[(size_t)m * Fi + ch] = g;
  }
  for (int i = threadIdx.x; i < d.T * Dd; i += kThreads) {
    const int r = i / Dd, ch = i - r * Dd;
    const int m = m_s[r];
    if (m < 0) continue;
    float g;
    if (Fd > 0) {
      const float dv = rnd<BF16>(dists[(size_t)m * Dd + ch]);
      g = 0.f;
      for (int f = 0; f < Fd; ++f) {
        const float sc = (float)(1 << f), b = dv * sc;
        const int q = pe_d + (ch * Fd + f) * 2;
        g = g + sc * (gx(r, q) * cosf(b) - gx(r, q + 1) * sinf(b));
      }
    } else {
      g = gx(r, pe_d + ch);
    }
    g_dists[(size_t)m * Dd + ch] = g;
  }
}

template <typename Gx>
__device__ __forceinline__ void extras_grad(const Dims& d, const int* m_s,
                                            float* __restrict__ g_extras,
                                            Gx gx) {
  const int E = d.E;
  for (int i = threadIdx.x; i < d.T * E; i += kThreads) {
    const int r = i / E, e = i - r * E;
    const int m = m_s[r];
    if (m >= 0) g_extras[(size_t)m * E + e] = gx(r, d.H + e);
  }
}

// Phase A on the tensor cores, for tiles t0 + blockIdx.x, + gridDim.x, ...
// below t1 and the live rows' tiles. act: layer l's inputs [cap][kp_l]
// from row cap * kp_before(l), l = 0 .. L - 1, then the last layer's
// output [cap][Hp] from cap * kp_before(L); gz: [L][cap][Hp]; the batch's
// tile t writes scratch rows (t - t0) * T ... and slice t - t0.
__global__ void __launch_bounds__(kThreads, 1)
k4_rows_tc(const float* __restrict__ feat, const float* __restrict__ dists,
           const float* __restrict__ extras, const float* __restrict__ w,
           const bf16* __restrict__ W, const float* __restrict__ bias,
           const float* __restrict__ wa, const float* __restrict__ ba,
           const float* __restrict__ gf, const float* __restrict__ ga,
           Dims d, float slope, const int* __restrict__ list,
           const int* __restrict__ count, int t0, int t1, int cap,
           float* __restrict__ g_feat, float* __restrict__ g_dists,
           float* __restrict__ g_extras, float* __restrict__ g_w,
           bf16* __restrict__ act, bf16* __restrict__ gz,
           double* __restrict__ slices) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TcShape sh = tc_shape(d, true);
  bf16* A0 = reinterpret_cast<bf16*>(smem_raw);
  bf16* A1 = reinterpret_cast<bf16*>(smem_raw + sh.a1);
  float* GX = reinterpret_cast<float*>(smem_raw);  // aliases A0, A1
  bf16* Gr = reinterpret_cast<bf16*>(smem_raw + sh.gr);
  unsigned* masks = reinterpret_cast<unsigned*>(smem_raw + sh.masks);
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + sh.ring);
  float* w_s = reinterpret_cast<float*>(smem_raw + sh.rows);
  float* gza_s = w_s + d.T;
  int* m_s = reinterpret_cast<int*>(gza_s + d.T);
  const int tid = threadIdx.x;
  const int T = d.T, L = d.L, Hp = d.Hp, HW = d.Hp / 32;
  const int lda = tc_lda(d), ldb = tc_ldb(d), ldg = tc_ldg(d);
  const int gxs = tc_gxs(d), stage = tc_stage(d, true);
  const int nrows = live_rows(d, count);
  const int tend = imin(t1, (nrows + T - 1) / T);

  for (int t = t0 + blockIdx.x; t < tend; t += gridDim.x) {
    const size_t jb = (size_t)(t - t0) * T;  // the tile's scratch row
    double* slice = slices + (size_t)(t - t0) * slice_floats(d);
    for (int c = 0; c < kStages - 1; ++c) tc_issue(d, W, c, true, ring, stage);
    for (int r = tid; r < T; r += kThreads) {
      const int m = k4_row(d, list, nrows, t, r);
      m_s[r] = m;
      w_s[r] = m >= 0 ? dtc::round_bf16(w[m]) : 0.f;
    }
    for (int i = tid; i < L * T * HW; i += kThreads) masks[i] = 0u;
    __syncthreads();
    build_x<true>(d, feat, dists, m_s, [&](int r, int c, float v) {
      A0[r * lda + c] = __float2bfloat16_rn(v);
    });
    __syncthreads();
    store_rows_bf16(A0, lda, act + jb * d.kp0, T, d.kp0);

    // the forward again, keeping each layer's z signs and inputs
    bf16* in = A0;
    bf16* out = A1;
    int c = 0;
    for (int l = 0; l < L; ++l) {
      const float* bl = bias + (size_t)l * Hp;
      unsigned* ml = masks + (size_t)l * T * HW;
      c = tc_product<true>(
          d, W, true, ring, stage, c, in, lda, kp_of(d, l), Hp, ldb,
          [&](int r, int col, float v0, float v1) {
            float z0 = v0 + __ldg(bl + col), z1 = v1 + __ldg(bl + col + 1);
            const unsigned bits = (z0 > 0.f ? 1u : 0u) | (z1 > 0.f ? 2u : 0u);
            if (bits) atomicOr(ml + r * HW + (col >> 5), bits << (col & 31));
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
      __syncthreads();  // the layer's output is complete
      const int kn = l + 1 < L ? kp_of(d, l + 1) : Hp;
      store_rows_bf16(out, lda,
                      act + (size_t)cap * kp_before(d, l + 1) + jb * kn, T,
                      kn);
      bf16* tmp = in; in = out; out = tmp;
    }

    auto h = [&](int r, int col) { return __bfloat162float(in[r * lda + col]); };
    heads(d, m_s, w_s, gza_s, wa, ba, gf, ga, g_w, h);
    __syncthreads();
    head_sums(d, gza_s, slice, h);
    __syncthreads();  // h is dead: GX takes its bytes

    layer_gz<true>(d, L - 1, true, m_s, w_s, gza_s, masks, HW, wa, gf, slope,
                   slice, [&](int, int) { return 0.f; },
                   [&](int r, int col, float v) {
                     Gr[r * ldg + col] = __float2bfloat16_rn(v);
                   });
    __syncthreads();

    // block3 then block1, in reverse: g_h = g_zr W^T on the tensor cores
    for (int l = L - 1; l >= 0; --l) {
      store_rows_bf16(Gr, ldg, gz + ((size_t)l * cap + jb) * Hp, T, Hp);
      c = tc_product<false>(
          d, W, true, ring, stage, c, Gr, ldg, Hp, kp_of(d, l), kBStride,
          [&](int r, int col, float v0, float v1) {
            *reinterpret_cast<float2*>(GX + r * gxs + col) =
                make_float2(v0, v1);
          });
      __syncthreads();  // g_h in GX; every warp has read Gr
      auto gx = [&](int r, int col) { return GX[r * gxs + col]; };
      if (l == d.L1) extras_grad(d, m_s, g_extras, gx);
      if (l > 0) {
        layer_gz<true>(d, l - 1, false, m_s, w_s, gza_s, masks, HW, wa, gf,
                       slope, slice, gx, [&](int r, int col, float v) {
                         Gr[r * ldg + col] = __float2bfloat16_rn(v);
                       });
      } else {
        pe_backward<true>(d, m_s, feat, dists, g_feat, g_dists, gx);
      }
      __syncthreads();
    }
  }
  dtc::cp_async_wait<0>();
}

// Phase A on the CUDA cores (f32, or bf16 values with BF16). act, gz: f32
// scratch laid out as k4_rows_tc's; ws: the workspace when d.ws.
template <bool BF16>
__global__ void __launch_bounds__(kThreads, 1)
k4_rows_cc(const float* __restrict__ feat, const float* __restrict__ dists,
           const float* __restrict__ extras, const float* __restrict__ w,
           const float* __restrict__ W, const float* __restrict__ bias,
           const float* __restrict__ wa, const float* __restrict__ ba,
           const float* __restrict__ gf, const float* __restrict__ ga,
           Dims d, float slope, const int* __restrict__ list,
           const int* __restrict__ count, int t0, int t1, int cap,
           float* __restrict__ g_feat, float* __restrict__ g_dists,
           float* __restrict__ g_extras, float* __restrict__ g_w,
           float* __restrict__ act, float* __restrict__ gz,
           float* __restrict__ ws, double* __restrict__ slices) {
  extern __shared__ __align__(16) float smem_f[];
  const int T = d.T, L = d.L, Hp = d.Hp, HW = cc_hw(d);
  const int LD = cc_ld(T), half = cc_cw(T) / 2;
  const size_t xf = (size_t)d.kmax * LD;
  float* S = d.ws ? ws + (size_t)blockIdx.x * cc_state_floats(d, true)
                  : smem_f;
  float* X = S;                             // activations, then g_h
  float* Xo = d.ws ? X + xf : X;            // in place in shared memory
  float* Gz = X + (d.ws ? 2 : 1) * xf;      // [Hp][LD]: a layer's g_z
  unsigned* masks = reinterpret_cast<unsigned*>(Gz + (size_t)Hp * LD);
  float* ring = d.ws ? smem_f
                     : reinterpret_cast<float*>(masks + (size_t)L * T * HW);
  float* w_s = ring + (size_t)kCcStages * kCcKC * cc_cw(T);
  float* gza_s = w_s + T;
  int* m_s = reinterpret_cast<int*>(gza_s + T);
  const int tid = threadIdx.x, lane = tid & 31;
  const int nrows = live_rows(d, count);
  const int tend = imin(t1, (nrows + T - 1) / T);
  for (size_t i = tid; i < (d.ws ? 2 : 1) * xf; i += kThreads) X[i] = 0.f;

  for (int t = t0 + blockIdx.x; t < tend; t += gridDim.x) {
    const size_t jb = (size_t)(t - t0) * T;
    double* slice = slices + (size_t)(t - t0) * slice_floats(d);
    for (int c = 0; c < kCcStages - 1; ++c) cc_issue(d, W, c, true, ring);
    for (int r = tid; r < T; r += kThreads) {
      const int m = k4_row(d, list, nrows, t, r);
      m_s[r] = m;
      w_s[r] = m >= 0 ? rnd<BF16>(w[m]) : 0.f;
    }
    __syncthreads();
    float* in = X;
    float* out = Xo;
    build_x<BF16>(d, feat, dists, m_s,
                  [&](int r, int c, float v) { in[(size_t)c * LD + r] = v; });
    __syncthreads();
    store_rows_t(in, LD, T, d.kp0, act + jb * d.kp0);

    int c = 0;
    for (int l = 0; l < L; ++l) {
      const float* bl = bias + (size_t)l * Hp;
      unsigned* ml = masks + (size_t)l * T * HW;
      c = cc_product(d, W, true, ring, c, in, kp_of(d, l), Hp,
                     [&](float (&acc)[8][8], int cp, int r0, int c0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = cp + cc_col(c0, j, half);
          const float bj = col < Hp ? __ldg(bl + col) : 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i][j] += bj;
        }
        // the z signs: 8 consecutive lanes share each row's 32-column word
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
          const int w0 = (cp + c0) >> 5, w1 = (cp + c0 + half) >> 5;
          if ((lane & 7) == 0) {
            if (w0 < HW) ml[(r0 + i) * HW + w0] = b0;
            if (w1 < HW) ml[(r0 + i) * HW + w1] = b1;
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = cp + cc_col(c0, j, half);
          if (col < Hp) {
            float o[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float z = acc[i][j];
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
          out[(size_t)cc * LD + r] = v;
        });
      }
      __syncthreads();  // the layer's output is complete
      if (out != in) { float* tmp = in; in = out; out = tmp; }
      const int kn = l + 1 < L ? kp_of(d, l + 1) : Hp;
      store_rows_t(in, LD, T, kn,
                   act + (size_t)cap * kp_before(d, l + 1) + jb * kn);
    }

    auto h = [&](int r, int col) { return in[(size_t)col * LD + r]; };
    heads(d, m_s, w_s, gza_s, wa, ba, gf, ga, g_w, h);
    __syncthreads();
    head_sums(d, gza_s, slice, h);
    layer_gz<BF16>(d, L - 1, true, m_s, w_s, gza_s, masks, HW, wa, gf, slope,
                   slice, [&](int, int) { return 0.f; },
                   [&](int r, int col, float v) { Gz[(size_t)col * LD + r] = v; });
    __syncthreads();  // h is dead: `in` takes g_h

    // block3 then block1, in reverse: g_h = g_z W^T into `in`
    for (int l = L - 1; l >= 0; --l) {
      store_rows_t(Gz, LD, T, Hp, gz + ((size_t)l * cap + jb) * Hp);
      const int kp = kp_of(d, l);
      c = cc_product(d, W, true, ring, c, Gz, Hp, kp,
                     [&](float (&acc)[8][8], int cp, int r0, int c0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = cp + cc_col(c0, j, half);
          if (col < kp) {
            float* dst = in + (size_t)col * LD + r0;
            *reinterpret_cast<float4*>(dst) =
                make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
            *reinterpret_cast<float4*>(dst + 4) =
                make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
          }
        }
      });
      __syncthreads();  // g_h in `in`; every warp has read Gz
      auto gx = [&](int r, int col) { return in[(size_t)col * LD + r]; };
      if (l == d.L1) extras_grad(d, m_s, g_extras, gx);
      if (l > 0) {
        layer_gz<BF16>(d, l - 1, false, m_s, w_s, gza_s, masks, HW, wa, gf,
                       slope, slice, gx, [&](int r, int col, float v) {
                         Gz[(size_t)col * LD + r] = v;
                       });
      } else {
        pe_backward<BF16>(d, m_s, feat, dists, g_feat, g_dists, gx);
      }
      __syncthreads();
    }
  }
  dtc::cp_async_wait<0>();
}

// phase B's CTAs along y: ceil(kp_l / bi) for each layer, and the layer and
// first input of CTA y
inline int dw_blocks(const Dims& d, int bi) {
  int n = 0;
  for (int l = 0; l < d.L; ++l) n += (kp_of(d, l) + bi - 1) / bi;
  return n;
}
__device__ __forceinline__ void dw_block(const Dims& d, int bi, int y, int& l,
                                         int& i0) {
  l = 0;
  while (l < d.L - 1 && y >= (kp_of(d, l) + bi - 1) / bi) {
    y -= (kp_of(d, l) + bi - 1) / bi;
    ++l;
  }
  i0 = y * bi;
}

// the scratch rows the batch's phase A wrote (whole tiles)
__device__ __forceinline__ int batch_rows(const Dims& d, const int* count,
                                          int t0, int cap) {
  const int ntiles = (live_rows(d, count) + d.T - 1) / d.T;
  const int n = imin(ntiles - t0, cap / d.T);
  return n > 0 ? n * d.T : 0;
}

// Phase B on the tensor cores for one batch: partial[s] of dW_l[i0 : i0 +
// 128, j0 : j0 + 128] (+)= the sum over the batch's 32-row chunks s, s + S,
// ... of act_l^T g_zr_l. 8 warps: warp & 3 takes 32 inputs (two m16
// tiles), warp >> 2 64 columns (eight n8 tiles). `first`: the batch that
// writes the partials (later batches add to them).
__global__ void __launch_bounds__(kThreads)
k4_dw_tc(const bf16* __restrict__ act, const bf16* __restrict__ gz, Dims d,
         const int* __restrict__ count, int t0, int cap, int first,
         long long Ps, float* __restrict__ partial) {
  constexpr int kStage = kRC * (kTcBI + kPad) + kRC * (kTcBJ + kPad);
  __shared__ __align__(16) unsigned short sm_raw[2 * kStage];
  bf16* sm = reinterpret_cast<bf16*>(sm_raw);
  int l, i0;
  dw_block(d, kTcBI, blockIdx.y, l, i0);
  const int j0 = blockIdx.x * kTcBJ, s = blockIdx.z, S = gridDim.z;
  const int H = d.H, Hp = d.Hp, kp = kp_of(d, l), nin = in_of(d, l);
  const int nrows = batch_rows(d, count, t0, cap);
  const int nch = (nrows + kRC - 1) / kRC;
  if (!first && s >= nch) return;
  const bf16* A = act + (size_t)cap * kp_before(d, l);
  const bf16* B = gz + (size_t)l * cap * Hp;
  const int lda = kTcBI + kPad, ldg = kTcBJ + kPad;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int j8 = lane >> 3, r8 = lane & 7;

  auto load = [&](int ch, int st) {
    bf16* As = sm + st * kStage;
    bf16* Gs = As + kRC * lda;
    for (int p = tid; p < kRC * (kTcBI / 8); p += kThreads) {
      const int rr = p / (kTcBI / 8), q = p - rr * (kTcBI / 8);
      const int row = ch * kRC + rr, col = i0 + 8 * q;
      const bool ok = row < nrows && col < kp;
      df32::cp_async16_or_zero(As + rr * lda + 8 * q,
                               ok ? A + (size_t)row * kp + col : A, ok);
    }
    for (int p = tid; p < kRC * (kTcBJ / 8); p += kThreads) {
      const int rr = p / (kTcBJ / 8), q = p - rr * (kTcBJ / 8);
      const int row = ch * kRC + rr, col = j0 + 8 * q;
      const bool ok = row < nrows && col < Hp;
      df32::cp_async16_or_zero(Gs + rr * ldg + 8 * q,
                               ok ? B + (size_t)row * Hp + col : B, ok);
    }
  };

  float acc[2][8][4], part[2][8][4];
  dtc::zero_acc(acc);
  int ch = s, st = 0;
  if (ch < nch) load(ch, 0);
  dtc::cp_async_commit();
  while (ch < nch) {
    const int cn = ch + S;
    if (cn < nch) load(cn, st ^ 1);
    dtc::cp_async_commit();
    dtc::cp_async_wait<1>();
    __syncthreads();
    const bf16* As = sm + st * kStage;
    const bf16* Gs = As + kRC * lda;
    // each chunk sums from 0 and joins acc in one IEEE add (see mma_chunk)
    dtc::zero_acc(part);
#pragma unroll
    for (int k16 = 0; k16 < kRC / 16; ++k16) {
      uint32_t b[4][4];
#pragma unroll
      for (int np = 0; np < 4; ++np)
        dtc::ldsm4t(b[np], Gs + (k16 * 16 + r8 + 8 * (j8 & 1)) * ldg +
                               wn * 64 + np * 16 + 8 * (j8 >> 1));
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        dtc::ldsm4t(a[mt], As + (k16 * 16 + r8 + 8 * (j8 >> 1)) * lda +
                               wm * 32 + mt * 16 + 8 * (j8 & 1));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          dtc::mma16816(part[mt][2 * np], a[mt], b[np][0], b[np][1]);
          dtc::mma16816(part[mt][2 * np + 1], a[mt], b[np][2], b[np][3]);
        }
    }
    dtc::add_acc(acc, part, 8);
    __syncthreads();  // the stage is free for the load after next
    ch = cn;
    st ^= 1;
  }
  dtc::cp_async_wait<0>();

  const int g = lane >> 2, tq = lane & 3;
  float* o = partial + (size_t)s * Ps + pw_of(d, l);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = i0 + wm * 32 + mt * 16 + g + 8 * (e >> 1);
        const int col = j0 + wn * 64 + j * 8 + 2 * tq + (e & 1);
        if (row < nin && col < H) {
          float* p = o + (size_t)row * H + col;
          *p = first ? acc[mt][j][e] : *p + acc[mt][j][e];
        }
      }
}

// Phase B on the CUDA cores for one batch: partial[s] of dW_l[i0 : i0 + 64,
// j0 : j0 + 256] (+)= the sum over the batch's 32-row chunks s, s + S, ...
// of act_l^T g_z_l, exact f32 FMAs (the register tile of 64 x 256).
__global__ void __launch_bounds__(kThreads, 2)
k4_dw_cc(const float* __restrict__ act, const float* __restrict__ gz, Dims d,
         const int* __restrict__ count, int t0, int cap, int first,
         long long Ps, float* __restrict__ partial) {
  extern __shared__ __align__(16) float smem_f[];
  int l, i0;
  dw_block(d, kCcBI, blockIdx.y, l, i0);
  const int j0 = blockIdx.x * kCcBJ, s = blockIdx.z, S = gridDim.z;
  const int H = d.H, Hp = d.Hp, kp = kp_of(d, l), nin = in_of(d, l);
  const int nrows = batch_rows(d, count, t0, cap);
  const int nch = (nrows + kRC - 1) / kRC;
  if (!first && s >= nch) return;
  const float* A = act + (size_t)cap * kp_before(d, l);
  const float* B = gz + (size_t)l * cap * Hp;
  const int tid = threadIdx.x;
  auto load = [&](int ch, int st) {
    float* As = smem_f + (size_t)st * kRC * (kCcBI + kCcBJ);
    float* Bs = As + kRC * kCcBI;
    for (int p = tid; p < kRC * (kCcBI / 4); p += kThreads) {
      const int rr = p / (kCcBI / 4), q = p - rr * (kCcBI / 4);
      const int row = ch * kRC + rr, col = i0 + 4 * q;
      const bool ok = row < nrows && col < kp;
      df32::cp_async16_or_zero(As + rr * kCcBI + 4 * q,
                               ok ? A + (size_t)row * kp + col : A, ok);
    }
    for (int p = tid; p < kRC * (kCcBJ / 4); p += kThreads) {
      const int rr = p / (kCcBJ / 4), q = p - rr * (kCcBJ / 4);
      const int row = ch * kRC + rr, col = j0 + 4 * q;
      const bool ok = row < nrows && col < Hp;
      df32::cp_async16_or_zero(Bs + rr * kCcBJ + 4 * q,
                               ok ? B + (size_t)row * Hp + col : B, ok);
    }
  };
  int r0, c0;
  cc_map(64, r0, c0);
  float acc[8][8];
  df32::zero8x8(acc);
  int ch = s, st = 0;
  if (ch < nch) load(ch, 0);
  dtc::cp_async_commit();
  while (ch < nch) {
    const int cn = ch + S;
    if (cn < nch) load(cn, st ^ 1);
    dtc::cp_async_commit();
    dtc::cp_async_wait<1>();
    __syncthreads();
    const float* As = smem_f + (size_t)st * kRC * (kCcBI + kCcBJ);
    cc_mm<kRC>(acc, As, kCcBI, As + kRC * kCcBI, kCcBJ, r0, c0, kCcBJ / 2);
    __syncthreads();  // the stage is free for the load after next
    ch = cn;
    st ^= 1;
  }
  dtc::cp_async_wait<0>();

  float* o = partial + (size_t)s * Ps + pw_of(d, l);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = i0 + r0 + i;
    if (row >= nin) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j0 + cc_col(c0, j, kCcBJ / 2);
      if (col < H) {
        float* p = o + (size_t)row * H + col;
        *p = first ? acc[i][j] : *p + acc[i][j];
      }
    }
  }
}

// Phase C, per batch: sacc[q] (+)= the batch's tile slices q in tile
// order, in f64 (the first batch writes).
__global__ void k4_slices(const double* __restrict__ slices, Dims d,
                          const int* __restrict__ count, int t0, int cap,
                          int first, double* __restrict__ sacc) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const int nsl = slice_floats(d);
  if (q >= nsl) return;
  const int n = batch_rows(d, count, t0, cap) / d.T;
  double s = 0.0;
  for (int t = 0; t < n; ++t) s += slices[(size_t)t * nsl + q];
  sacc[q] = first ? s : sacc[q] + s;
}

// Phase C: out[i] for every parameter i: dW from the S phase-B partials in
// order, db / dwa / dba from the summed slices.
__global__ void k4_reduce(const float* __restrict__ partial, int S,
                          long long Ps, const double* __restrict__ sacc,
                          Dims d, float* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < d.P; i += (long long)gridDim.x * blockDim.x) {
    int q = -1;  // the parameter's place in a slice, if it has one
    if (i >= d.P - d.H - 1) {
      q = d.L * d.H + (int)(i - (d.P - d.H - 1));
    } else {
      for (int l = 0; l < d.L; ++l) {
        const long long pb = pb_of(d, l);
        if (i >= pb && i < pb + d.H) q = l * d.H + (int)(i - pb);
      }
    }
    float s = 0.f;
    if (q < 0) {
      for (int k = 0; k < S; ++k) s += partial[(size_t)k * Ps + i];
    } else {
      s = (float)sacc[q];
    }
    out[i] = s;
  }
}

const void* rows_kernel(const Dims& d) {
  if (d.kind == kTensorCores) return (const void*)k4_rows_tc;
  return d.bf16 ? (const void*)k4_rows_cc<true>
                : (const void*)k4_rows_cc<false>;
}

size_t smem_b(const Dims& d) {
  return d.kind == kTensorCores
             ? 0
             : sizeof(float) * 2 * kRC * (kCcBI + kCcBJ);
}

int set_smem(const Dims& d) {
  cudaError_t e = cudaFuncSetAttribute(
      rows_kernel(d), cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_need(d, true));
  if (e != cudaSuccess) return (int)e;
  if (d.kind == kCudaCores)
    e = cudaFuncSetAttribute(k4_dw_cc,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_b(d));
  return (int)e;
}

}  // namespace

// The plan of a launch at M rows with a scratch of at most cap_max rows:
// out[0..10] = kind (0 tensor cores, 1 CUDA cores), rows per tile T, phase
// A's shared memory bytes, phase B's dynamic shared memory bytes, workspace
// floats per CTA (0: the tile lies in shared memory), phase A's grid, Hp,
// kp0, kpE, phase B's CTAs along y, and the scratch rows `cap` (whole tiles,
// no more than M rows need). Nonzero when the dims are not taken.
extern "C" int fused_decode_bwd_any_plan(long long M, int Fi, int Dd, int E,
                                         int Ff, int Fd, int H, int K,
                                         int L1, int L3, int use_bf16,
                                         int cap_max, int* out) {
  const Dims d = plan(M, Fi, Dd, E, Ff, Fd, H, K, L1, L3, use_bf16, true);
  if (!takes(d) || cap_max < d.T) return (int)cudaErrorInvalidValue;
  const int cap = imax(
      d.T, imin(cap_max / d.T, (int)((M + d.T - 1) / d.T)) * d.T);
  int e = set_smem(d);
  if (e) return e;
  int grid = 0;
  const int tiles = cap / d.T;
  e = df32::persistent_grid(rows_kernel(d), smem_need(d, true), tiles,
                            &grid);
  if (e) return e;
  const int v[11] = {d.kind, d.T, (int)smem_need(d, true), (int)smem_b(d),
                     d.ws ? (int)cc_state_floats(d, true) : 0, grid, d.Hp,
                     d.kp0, d.kpE,
                     dw_blocks(d, d.kind == kTensorCores ? kTcBI : kCcBI),
                     cap};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

// W: the packed weights (pack_any_weights for this plan, with the backward
// stream on the CUDA cores); bias [L][Hp]; g_fagg [G][H], g_alpha [G];
// flags / counts / list / count: the live list's scratch; ws: grid x the
// plan's workspace floats (may be null when it asked for none); act: cap x
// (kp0 + kpE + (L - 1) Hp) and gz: L x cap x Hp, bf16 on the tensor cores
// and f32 on the CUDA cores; slices: cap / T x (L H + H + 1) doubles; sacc:
// L H + H + 1 doubles; partial: splits x (P rounded up to 4); dparams [P]:
// the parameter gradients in the _flatten order.
extern "C" int fused_decode_bwd_any_launch(
    const float* feat, const float* dists, const float* extras,
    const float* w, const void* W, const float* bias, const float* wa,
    const float* ba, const float* g_fagg, const float* g_alpha, long long M,
    int Fi, int Dd, int E, int Ff, int Fd, int H, int K, int L1, int L3,
    float slope, int use_bf16, int grid, void* flags, int* counts, int* list,
    int* count, float* ws, void* act, void* gz, int cap, double* slices,
    double* sacc, float* partial, int splits, float* g_feat, float* g_dists,
    float* g_extras, float* g_w, float* dparams, void* stream) {
  const Dims d = plan(M, Fi, Dd, E, Ff, Fd, H, K, L1, L3, use_bf16, true);
  if (!takes(d) || splits < 1 || cap < d.T || cap % d.T)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d.G == 0) return (int)cudaMemsetAsync(dparams, 0, sizeof(float) * d.P, s);
  if (grid < 1 || (d.ws && ws == nullptr))
    return (int)cudaErrorInvalidConfiguration;
  dlive::Owned own{{g_feat, g_dists, g_extras, g_w},
                   {K * Fi, K * Dd, K * E, K}};
  cudaError_t e = dlive::build(w, g_fagg, g_alpha, d.G, K, H, own,
                               static_cast<unsigned char*>(flags), counts,
                               list, count, s);
  if (e != cudaSuccess) return (int)e;
  int err = set_smem(d);
  if (err) return err;
  const long long Ps = (d.P + 3) / 4 * 4;
  const size_t sa = smem_need(d, true), sb = smem_b(d);
  const int cap_tiles = cap / d.T;
  const int max_tiles = (int)((M + d.T - 1) / d.T);
  const int bi = d.kind == kTensorCores ? kTcBI : kCcBI;
  const int bj = d.kind == kTensorCores ? kTcBJ : kCcBJ;
  const dim3 gb((d.Hp + bj - 1) / bj, dw_blocks(d, bi), splits);
  const int nsl = slice_floats(d);
  for (int b = 0; b * cap_tiles < max_tiles; ++b) {
    const int t0 = b * cap_tiles, t1 = t0 + cap_tiles;
    if (d.kind == kTensorCores) {
      k4_rows_tc<<<grid, kThreads, sa, s>>>(
          feat, dists, extras, w, static_cast<const bf16*>(W), bias, wa, ba,
          g_fagg, g_alpha, d, slope, list, count, t0, t1, cap, g_feat,
          g_dists, g_extras, g_w, static_cast<bf16*>(act),
          static_cast<bf16*>(gz), slices);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      k4_dw_tc<<<gb, kThreads, 0, s>>>(
          static_cast<const bf16*>(act), static_cast<const bf16*>(gz), d,
          count, t0, cap, b == 0, Ps, partial);
    } else {
      if (d.bf16)
        k4_rows_cc<true><<<grid, kThreads, sa, s>>>(
            feat, dists, extras, w, static_cast<const float*>(W), bias, wa,
            ba, g_fagg, g_alpha, d, slope, list, count, t0, t1, cap, g_feat,
            g_dists, g_extras, g_w, static_cast<float*>(act),
            static_cast<float*>(gz), ws, slices);
      else
        k4_rows_cc<false><<<grid, kThreads, sa, s>>>(
            feat, dists, extras, w, static_cast<const float*>(W), bias, wa,
            ba, g_fagg, g_alpha, d, slope, list, count, t0, t1, cap, g_feat,
            g_dists, g_extras, g_w, static_cast<float*>(act),
            static_cast<float*>(gz), ws, slices);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      k4_dw_cc<<<gb, kThreads, sb, s>>>(
          static_cast<const float*>(act), static_cast<const float*>(gz), d,
          count, t0, cap, b == 0, Ps, partial);
    }
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    k4_slices<<<(nsl + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        slices, d, count, t0, cap, b == 0, sacc);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  const long long nb = (d.P + kThreads - 1) / kThreads;
  k4_reduce<<<(int)(nb < 4096 ? nb : 4096), kThreads, 0, s>>>(
      partial, splits, Ps, sacc, d, dparams);
  return (int)cudaGetLastError();
}
