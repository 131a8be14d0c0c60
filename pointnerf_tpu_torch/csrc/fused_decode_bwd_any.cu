// K4: fused decode backward, the general route, on the CUDA cores.
//
// Replaces: pointnerf_tpu/ops/pallas_decode.py::fused_decode's custom-VJP
// backward (_bwd_rule -> pallas_call at :467 of _bwd_kernel), for every
// DecodeSpec inside JAX's fused envelope that the tuned kernels
// (fused_decode_bwd_tc.cu, bf16; fused_decode_bwd.cu, f32) do not take.
//
// Function (ops/fused_decode.py::fused_decode_bwd_plain, whose spec.bf16
// picks the template): the forward again, keeping each layer's input and
// the signs of its pre-activations; then per row
//   g_w  = h . g_fagg[g] + softplus(za - 1) g_alpha[g]
//   g_za = g_alpha[g] w sigmoid(za - 1);  g_h = g_fagg[g] w + g_za wa
// and down the layers g_z = g_h * (z > 0 ? 1 : slope), db += g_z,
// g_zr = rnd(g_z), dW += act^T g_zr, g_h = g_zr W^T (g_extras split off
// at block3's first layer), then the PE backward into g_feat and g_dists.
//
// Design (csrc/decode_any.cuh): CTAs of 256 threads walk tiles of whole
// groups in a fixed order (tile t on CTA t % grid, grid = min(tiles, SMs)).
// A tile whose rows all have w == 0 and whose groups have zero upstream
// gradients writes zero row gradients and adds nothing. A tile's state
// (every layer's input, the last h, two g_h buffers, per-row values and
// the sign bytes) lies in shared memory when it fits, else in a global
// workspace slice per CTA. Each CTA adds its tiles' dW/db/dwa/dba into its
// own slice of per-CTA partials (one thread per element, no atomics); a
// second kernel sums the slices in CTA order. So two calls give the same
// bits. Making it fast is later work.
#include "decode_any.cuh"

namespace {

using namespace dany;

__host__ __device__ long long sum_in(const Dims& d) {
  long long s = 0;
  for (int l = 0; l < d.L; ++l) s += layer_in(d, l);
  return s;
}

__host__ __device__ long long state_floats(const Dims& d) {
  const long long sign = ((long long)d.L * d.T * d.H + 3) / 4;
  return (long long)d.T * (sum_in(d) + d.H + 2LL * d.ld + 2) + sign + 4;
}

// out[i][j] += sum_r A[r][i] * Gm[r][j] for i < m, j < n, r < rows
__device__ void accum_tn(const float* A, int lda, int m, const float* Gm,
                         int ldg, int n, int rows, float* out) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int i0 = 0; i0 < m; i0 += kRows) {
    int ni = m - i0 - ty;
    ni = ni > 0 ? (ni + 7) >> 3 : 0;
    if (ni > 8) ni = 8;
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + tx;
      const bool jv = j < n;
      float acc[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float gv = jv ? Gm[(long long)r * ldg + j] : 0.f;
        const float* a = A + (long long)r * lda + i0 + ty;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (i < ni) acc[i] = fmaf(a[8 * i], gv, acc[i]);
      }
      if (!jv) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i >= ni) break;
        out[(long long)(i0 + ty + 8 * i) * n + j] += acc[i];
      }
    }
  }
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
fused_decode_bwd_any(const float* __restrict__ feat,
                     const float* __restrict__ dists,
                     const float* __restrict__ extras,
                     const float* __restrict__ w,
                     const float* __restrict__ W,
                     const float* __restrict__ bias,
                     const float* __restrict__ wa,
                     const float* __restrict__ ba,
                     const float* __restrict__ gf,
                     const float* __restrict__ ga, Dims d, float slope,
                     float* __restrict__ ws, float* __restrict__ part,
                     float* __restrict__ g_feat, float* __restrict__ g_dists,
                     float* __restrict__ g_extras, float* __restrict__ g_w) {
  extern __shared__ __align__(16) float smem[];
  float* S = ws == nullptr ? smem : ws + (long long)blockIdx.x * state_floats(d);
  const int T = d.T, H = d.H, K = d.K, ld = d.ld;
  float* acts = S;                                  // act_l [T][in_l]
  float* hL = acts + (long long)T * sum_in(d);      // [T][H]
  float* GA = hL + (long long)T * H;                // [T][ld]
  float* GB = GA + (long long)T * ld;               // [T][ld]
  float* w_s = GB + (long long)T * ld;              // [T] rounded w
  float* gza = w_s + T;                             // [T] g_za
  unsigned char* sign = reinterpret_cast<unsigned char*>(gza + T);  // [L][T][H]
  float* P = part + (long long)blockIdx.x * d.P;
  const float* Wt = W + wf_off(d, d.L);             // the W^T stream
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int t = blockIdx.x; t < d.ntiles; t += gridDim.x) {
    const long long g0 = (long long)t * d.gpt;
    const int ng = (int)(d.G - g0 < d.gpt ? d.G - g0 : d.gpt);
    const int rows = ng * K;
    const long long m0 = g0 * K;
    int live = 0;
    for (int r = tid; r < rows; r += kThreads) {
      const float v = rnd<BF16>(w[m0 + r]);
      w_s[r] = v;
      live |= v != 0.f;
    }
    for (int i = tid; i < ng * H; i += kThreads) live |= gf[g0 * H + i] != 0.f;
    for (int i = tid; i < ng; i += kThreads) live |= ga[g0 + i] != 0.f;
    if (!__syncthreads_or(live)) {
      for (long long i = tid; i < (long long)rows * d.Fi; i += kThreads)
        g_feat[m0 * d.Fi + i] = 0.f;
      for (long long i = tid; i < (long long)rows * d.Dd; i += kThreads)
        g_dists[m0 * d.Dd + i] = 0.f;
      for (long long i = tid; i < (long long)rows * d.E; i += kThreads)
        g_extras[m0 * d.E + i] = 0.f;
      for (int i = tid; i < rows; i += kThreads) g_w[m0 + i] = 0.f;
      continue;
    }

    // the forward, keeping each layer's input and its z > 0 bits
    build_x<BF16>(d, feat, dists, m0, rows, acts, d.x1);
    __syncthreads();
    long long aoff = 0;
    for (int l = 0; l < d.L; ++l) {
      const int nin = layer_in(d, l);
      const float* in = acts + aoff;
      aoff += (long long)T * nin;
      const int ldo = l + 1 < d.L ? layer_in(d, l + 1) : H;
      float* out = l + 1 < d.L ? acts + aoff : hL;
      product<BF16>(in, nin, nin, W + wf_off(d, l), H, rows, out, ldo,
                    bias + (long long)l * H, slope,
                    sign + (long long)l * T * H);
      if (l == d.L1 - 1) put_extras<BF16>(d, extras, m0, rows, out, ldo);
      __syncthreads();
    }

    // the heads, warp per row: g_w and g_za
    for (int r = warp; r < rows; r += kThreads / 32) {
      const float* gfr = gf + (g0 + r / K) * H;
      float za = 0.f, gh = 0.f;
      for (int c = lane; c < H; c += 32) {
        const float h = hL[(long long)r * H + c];
        za = fmaf(h, __ldg(wa + c), za);
        gh = fmaf(h, gfr[c], gh);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        za += __shfl_xor_sync(0xffffffffu, za, off);
        gh += __shfl_xor_sync(0xffffffffu, gh, off);
      }
      if (lane == 0) {
        const float x = za + __ldg(ba) - 1.f;
        const float gar = ga[g0 + r / K];
        g_w[m0 + r] = gh + softplus(x) * gar;
        gza[r] = gar * w_s[r] * (1.f / (1.f + expf(-x)));
      }
    }
    __syncthreads();
    for (int c = tid; c < H; c += kThreads) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s = fmaf(hL[(long long)r * H + c], gza[r], s);
      P[d.P - H - 1 + c] += s;
    }
    if (tid == 0) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += gza[r];
      P[d.P - 1] += s;
    }
    for (long long i = tid; i < (long long)rows * H; i += kThreads) {
      const int r = (int)(i / H), c = (int)(i - (long long)r * H);
      GA[(long long)r * ld + c] =
          gf[(g0 + r / K) * H + c] * w_s[r] + gza[r] * __ldg(wa + c);
    }
    __syncthreads();

    // down the layers
    for (int l = d.L - 1; l >= 0; --l) {
      const int nin = layer_in(d, l);
      aoff -= (long long)T * nin;
      const unsigned char* sg = sign + (long long)l * T * H;
      const long long pw = pw_off(d, l);
      for (int c = tid; c < H; c += kThreads) {
        float s = 0.f;
        for (int r = 0; r < rows; ++r) {
          float* p = GA + (long long)r * ld + c;
          const float z = *p * (sg[(long long)r * H + c] ? 1.f : slope);
          s += z;
          *p = rnd<BF16>(z);
        }
        P[pw + (long long)nin * H + c] += s;
      }
      __syncthreads();
      accum_tn(acts + aoff, nin, nin, GA, ld, H, rows, P + pw);
      product<BF16>(GA, ld, H, Wt + wf_off(d, l), nin, rows, GB, ld,
                    nullptr, slope, nullptr);
      __syncthreads();
      if (l == d.L1) {
        for (long long i = tid; i < (long long)rows * d.E; i += kThreads) {
          const int r = (int)(i / d.E), e = (int)(i - (long long)r * d.E);
          g_extras[(m0 + r) * d.E + e] = GB[(long long)r * ld + H + e];
        }
        __syncthreads();
      }
      float* tmp = GA; GA = GB; GB = tmp;
    }

    // GA: g_x [rows][x1]. The PE backward, in the plain version's order.
    const int pe_d = d.Fi + 2 * d.Ff * d.Fi;
    for (long long i = tid; i < (long long)rows * d.Fi; i += kThreads) {
      const int r = (int)(i / d.Fi), ch = (int)(i - (long long)r * d.Fi);
      const float* gx = GA + (long long)r * ld;
      const float x = rnd<BF16>(feat[(m0 + r) * d.Fi + ch]);
      float g = gx[ch];
      for (int f = 0; f < d.Ff; ++f) {
        const float p2 = (float)(1 << f), b = x * p2;
        const int q = d.Fi + (ch * d.Ff + f) * 2;
        g = g + p2 * (gx[q] * cosf(b) - gx[q + 1] * sinf(b));
      }
      g_feat[(m0 + r) * d.Fi + ch] = g;
    }
    for (long long i = tid; i < (long long)rows * d.Dd; i += kThreads) {
      const int r = (int)(i / d.Dd), ch = (int)(i - (long long)r * d.Dd);
      const float* gx = GA + (long long)r * ld;
      float g;
      if (d.Fd > 0) {
        const float x = rnd<BF16>(dists[(m0 + r) * d.Dd + ch]);
        g = 0.f;
        for (int f = 0; f < d.Fd; ++f) {
          const float p2 = (float)(1 << f), b = x * p2;
          const int q = pe_d + (ch * d.Fd + f) * 2;
          g = g + p2 * (gx[q] * cosf(b) - gx[q + 1] * sinf(b));
        }
      } else {
        g = gx[pe_d + ch];
      }
      g_dists[(m0 + r) * d.Dd + ch] = g;
    }
    __syncthreads();  // the tile's buffers are free for the next
  }
}

// dparams[p] = sum over CTAs b, in order, of part[b][p]
__global__ void sum_partials(const float* __restrict__ part, int nparts,
                             long long P, float* __restrict__ out) {
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < P;
       p += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < nparts; ++b) s += part[(long long)b * P + p];
    out[p] = s;
  }
}

void plan(const Dims& d, int sms, int* grid, long long* ws_floats,
          int* smem_bytes) {
  *grid = d.ntiles < sms ? d.ntiles : sms;
  const long long st = state_floats(d);
  *ws_floats = (long long)*grid * d.P + (in_smem(st) ? 0 : st * *grid);
  *smem_bytes = in_smem(st) ? (int)(st * 4) : 0;
}

template <bool BF16>
int launch(const float* feat, const float* dists, const float* extras,
           const float* w, const float* W, const float* bias,
           const float* wa, const float* ba, const float* gf,
           const float* ga, const Dims& d, float slope, int grid, float* ws,
           float* g_feat, float* g_dists, float* g_extras, float* g_w,
           float* dparams, cudaStream_t s) {
  const long long st = state_floats(d);
  const bool sm = in_smem(st);
  const size_t smem = sm ? (size_t)st * 4 : 0;
  float* part = ws;
  float* state = sm ? nullptr : ws + (long long)grid * d.P;
  cudaError_t e = cudaMemsetAsync(part, 0, sizeof(float) * grid * d.P, s);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(fused_decode_bwd_any<BF16>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  fused_decode_bwd_any<BF16><<<grid, kThreads, smem, s>>>(
      feat, dists, extras, w, W, bias, wa, ba, gf, ga, d, slope, state, part,
      g_feat, g_dists, g_extras, g_w);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  long long nb = (d.P + kThreads - 1) / kThreads;
  sum_partials<<<(int)(nb < 4096 ? nb : 4096), kThreads, 0, s>>>(part, grid,
                                                                 d.P, dparams);
  return (int)cudaGetLastError();
}

}  // namespace

// The grid and the global workspace (floats: the per-CTA partials, then
// the per-CTA tile state when it does not fit shared memory) of a launch;
// nonzero when the dims are not taken.
extern "C" int fused_decode_bwd_any_workspace(long long M, int Fi, int Dd,
                                              int E, int Ff, int Fd, int H,
                                              int K, int L1, int L3,
                                              int* grid,
                                              long long* ws_floats,
                                              int* smem_bytes) {
  const Dims d = make_dims(M, Fi, Dd, E, Ff, Fd, H, K, L1, L3);
  if (!takes(d)) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int e = sm_count(&sms);
  if (e) return e;
  plan(d, sms, grid, ws_floats, smem_bytes);
  return 0;
}

// W: the forward stream (W_l [in_l][H], layer after layer) then the
// backward stream (W_l^T [H][in_l]); bias [L][H]; g_fagg [G][H],
// g_alpha [G]; ws: the workspace fused_decode_bwd_any_workspace asked for;
// dparams [P] in the order (dW_0, db_0, ..., dwa, dba).
extern "C" int fused_decode_bwd_any_launch(
    const float* feat, const float* dists, const float* extras,
    const float* w, const float* W, const float* bias, const float* wa,
    const float* ba, const float* g_fagg, const float* g_alpha, long long M,
    int Fi, int Dd, int E, int Ff, int Fd, int H, int K, int L1, int L3,
    float slope, int bf16, int grid, float* ws, float* g_feat,
    float* g_dists, float* g_extras, float* g_w, float* dparams,
    void* stream) {
  const Dims d = make_dims(M, Fi, Dd, E, Ff, Fd, H, K, L1, L3);
  if (!takes(d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d.ntiles == 0)
    return (int)cudaMemsetAsync(dparams, 0, sizeof(float) * d.P, s);
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  return bf16 ? launch<true>(feat, dists, extras, w, W, bias, wa, ba, g_fagg,
                             g_alpha, d, slope, grid, ws, g_feat, g_dists,
                             g_extras, g_w, dparams, s)
              : launch<false>(feat, dists, extras, w, W, bias, wa, ba,
                              g_fagg, g_alpha, d, slope, grid, ws, g_feat,
                              g_dists, g_extras, g_w, dparams, s);
}
