// K1: fused KNN candidate distance + K-nearest selection on the prebuilt
// neighbor tables.
//
// Replaces: pointnerf_tpu/ops/pallas_knn.py::pallas_knn_select (_knn_kernel),
// called from pointnerf_tpu/ops/query.py::_knn_chunk (knn_select="pallas").
//
// Function: for each shading slot c, read the table row dslot[c] directly
// (nbr_xyz is coordinate-major: [x(QP) | y(QP) | z(QP)], nbr_pid [QP]),
// d2 = dx*dx + dy*dy + dz*dz to every candidate; a candidate is invalid when
// the slot is invalid (ok[c] == 0 or dslot[c] < 0), its x >= 1e7 (dead table
// entries hold 1e8) or d2 > r2 (r2 > 0 only). Then K min-extractions in
// ascending d2 with ties to the lowest candidate lane; an invalid winner is
// written as pid -1 / d2 +inf.
//
// Bound on the H100: bytes. Each slot reads 3*QP floats + QP ints (3.9 KB at
// QP = 243) and does ~10 flops per candidate, so the kernel is a streaming
// read of the gathered rows: at C = 36,352 slots ~141 MB, 0.042 ms at
// 3.35 TB/s.
//
// Design: one warp per slot. Lane l holds candidates l, l+32, ... in
// registers, so each coordinate plane of the row is read with coalesced
// 128-byte loads and the JAX path's transposed [C, QP, 3] gather never
// exists. Each of the K rounds takes the lane-local minimum and reduces
// (d2, lane index) lexicographically across the warp with shuffles, which
// gives the lowest-lane tie-break; the owner lane then retires its winner.
// Built with -fmad=false and written with __fmul_rn/__fadd_rn: the plain
// PyTorch twin rounds each product and sum, and a contracted FMA would move
// d2 by one ulp and flip near-ties.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;

template <int MAXC>
__global__ void knn_select_kernel(const float* __restrict__ nbr_xyz,
                                  const int* __restrict__ nbr_pid,
                                  const int* __restrict__ dslot,
                                  const float* __restrict__ centers,
                                  const uint8_t* __restrict__ ok, int C,
                                  int QP, int K, float r2,
                                  int* __restrict__ out_pid,
                                  float* __restrict__ out_d2) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= C) return;  // the whole warp leaves together
  const int slot = dslot[c];
  const bool cok = ok[c] != 0 && slot >= 0;
  const size_t row = (size_t)(slot > 0 ? slot : 0);
  const float* xs = nbr_xyz + row * 3 * QP;
  const int* ps = nbr_pid + row * QP;
  const float cx = centers[3 * c], cy = centers[3 * c + 1],
              cz = centers[3 * c + 2];

  float d[MAXC];
#pragma unroll
  for (int j = 0; j < MAXC; ++j) {
    const int q = lane + 32 * j;
    float v = CUDART_INF_F;
    if (cok && q < QP) {
      const float x = xs[q], y = xs[QP + q], z = xs[2 * QP + q];
      const float dx = __fsub_rn(x, cx), dy = __fsub_rn(y, cy),
                  dz = __fsub_rn(z, cz);
      const float dd = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      bool good = x < 1.0e7f;
      if (r2 > 0.f) good = good && (dd <= r2);
      v = good ? dd : CUDART_INF_F;
    }
    d[j] = v;
  }

  for (int k = 0; k < K; ++k) {
    float bv = CUDART_INF_F;
    int bi = kNone;
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      if (d[j] < bv) {  // strict: the earlier (lower) lane keeps a tie
        bv = d[j];
        bi = lane + 32 * j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oi = __shfl_xor_sync(kFull, bi, off);
      if (ov < bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
#pragma unroll
    for (int j = 0; j < MAXC; ++j)
      if (lane + 32 * j == bi) d[j] = CUDART_INF_F;
    if (lane == 0) {
      const bool fin = bv < CUDART_INF_F;
      out_pid[(size_t)c * K + k] = fin ? ps[bi] : -1;
      out_d2[(size_t)c * K + k] = fin ? bv : CUDART_INF_F;
    }
  }
}

}  // namespace

extern "C" int knn_select_launch(const float* nbr_xyz, const int* nbr_pid,
                                 const int* dslot, const float* centers,
                                 const uint8_t* ok, int C, int QP, int K,
                                 float r2, int* out_pid, float* out_d2,
                                 void* stream) {
  if (C == 0) return 0;
  const dim3 block(256);
  const dim3 grid((C + 7) / 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (QP <= 256) {
    knn_select_kernel<8><<<grid, block, 0, s>>>(nbr_xyz, nbr_pid, dslot,
                                                centers, ok, C, QP, K, r2,
                                                out_pid, out_d2);
  } else if (QP <= 512) {
    knn_select_kernel<16><<<grid, block, 0, s>>>(nbr_xyz, nbr_pid, dslot,
                                                 centers, ok, C, QP, K, r2,
                                                 out_pid, out_d2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
