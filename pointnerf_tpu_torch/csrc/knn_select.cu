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
// entries hold 1e8) or d2 > r2 (r2 > 0 only). Then the K smallest in
// ascending d2 with ties to the lowest candidate index; an invalid winner is
// written as pid -1 / d2 +inf.
//
// Bound on the H100: bytes. The function needs each distinct table row once
// (3*QP floats + QP ints, 3,888 B at QP = 243, 11,232 B at QP = 702), the slots' centers, dslot
// and ok, and the [C, K] outputs; ~10 flops per candidate. On the main path
// (C = 36,352 slots, 19,781 of which select, reading 8,112 distinct rows)
// that is ~31.6 MB, 0.0103 ms at 3.35 TB/s. Reading one row per selecting
// slot, as a kernel without reuse does, moves ~77 MB.
//
// Design, K <= 16 (the run path, knn_select_runs_kernel): a block of 256
// threads takes 64 consecutive slots. The slots arrive ray-major in depth
// order, so consecutive slots read the same row (2.2 slots a run on the
// main path); the block finds the runs of equal row among its selecting
// slots (invalid slots in between do not end a run) and stages each run's
// row in shared memory once, so the row traffic falls from one row per slot
// to one per run (~9,100 rows for 8,112 distinct ones). A warp stages a row
// with every load of it in flight at once, compacted to its live candidates
// (x < 1e7; ~34 of 243 on the main path) as float4 (x, y, z, pid) in
// ascending candidate order, so the selection loops over live candidates
// only. Rows start 4-byte aligned (3,888 B and 972 B planes), so the staging
// reads with 4-byte coalesced loads. Four lanes share a slot: each keeps a
// sorted top-K in registers over every fourth candidate, inserted with
// strict < in ascending order (the plain version's stable order, ties to
// the lowest candidate), and the lanes' lists merge on (d2, position) with
// shuffles. If a block's runs hold more live candidates than the pool, it
// stages and selects in rounds. Slots that do not select write (-1, inf)
// without touching a row. The time is one block's latency chain (slot
// loads, row loads, selection, merge) more than bandwidth: one block alone
// takes ~60% of the whole launch (PERF.md, Findings).
//
// Design, 16 < K <= QP (the warp path, knn_select_warp_kernel): one warp per
// slot. Lane l holds candidates l, l+32, ... in registers; each of the K
// rounds takes the lane-local minimum and reduces (d2, lane index)
// lexicographically across the warp with shuffles; the owner lane retires
// its winner.
//
// Design, QP > 512 (the wide path, knn_select_wide_warp_kernel, any K): a
// row no longer fits the run path's register staging (CH <= 16 chunks of
// 32) or the warp path's MAXC per lane, so the row is streamed in fixed
// chunks of kChunk = 512 candidates and each chunk merged into a running
// top-K. A warp per slot holds a chunk in registers (16 candidates a lane)
// and merges it with the running list, kept sorted in device memory ([C, K]
// in the output and a scratch buffer of the same shape, alternating so the
// last chunk writes the output): K rounds, each taking the smaller of the
// list's head and the chunk's warp minimum, the list's head on a tie. Every
// candidate of an earlier chunk sits before every candidate of a later
// one, so the list-first tie keeps the plain version's order, ties to the
// lowest candidate, across chunk edges. The run path's sharing of a staged
// row across a run of slots is left out here: at the reference ScanNet
// scene ~4% of the slots select and their runs average 1.0 slot, and a
// run kernel that carried its lists across the chunks measured slower than
// this one (PERF.md, Findings).
//
// Both paths are built with -fmad=false and written with
// __fsub_rn/__fmul_rn/__fadd_rn: the plain PyTorch twin rounds each product
// and sum, and a contracted FMA would move d2 by one ulp and flip near-ties.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;
constexpr float kDead = 1.0e7f;
constexpr int kThreads = 256;          // threads per block of the run path
constexpr int kLanes = 4;              // lanes per slot
constexpr int kSlots = kThreads / kLanes;   // slots per block
constexpr int kWarps = kThreads / 32;
// staged candidates per round: 16 a slot (the main path's runs need ~16;
// at least 512, one row at QP = 512)
constexpr int kPool = kSlots * 16 > 512 ? kSlots * 16 : 512;
constexpr int kNoPos = 0x7fffffff;
constexpr int kMaxRow = 512;           // the most candidates of the run and
                                       // warp paths' rows; wider: the wide path

__device__ __forceinline__ float dist2(float x, float y, float z, float cx,
                                       float cy, float cz) {
  const float dx = __fsub_rn(x, cx), dy = __fsub_rn(y, cy),
              dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// A barrier of the first kSlots threads (the run detection).
__device__ __forceinline__ void named_barrier_slots() {
  asm volatile("bar.sync 1, %0;" ::"r"(kSlots) : "memory");
}

// Stage row `row` into pool at a reserved offset, compacted to its live
// candidates in ascending order: one warp, every load of the row issued
// before the first is used (CH chunks of 32 candidates, QP <= 32 * CH).
// Returns the count, or -1 when the pool of this round is full (the run
// waits for the next round).
template <int CH>
__device__ __forceinline__ int stage_row(const float* __restrict__ nbr_xyz,
                                         const int* __restrict__ nbr_pid,
                                         int row, int QP, float4* pool,
                                         int* used, int lane, int* base_out) {
  const float* xs = nbr_xyz + (size_t)row * 3 * QP;
  const int* ps = nbr_pid + (size_t)row * QP;
  float x[CH], y[CH], z[CH];
  int p[CH];
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int q = 32 * j + lane;
    const bool in = q < QP;
    x[j] = in ? xs[q] : kDead;
    y[j] = in ? xs[QP + q] : 0.f;
    z[j] = in ? xs[2 * QP + q] : 0.f;
    p[j] = in ? ps[q] : 0;
  }
  unsigned m[CH];
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    m[j] = __ballot_sync(kFull, x[j] < kDead);
    cnt += __popc(m[j]);
  }
  int base = 0;
  if (lane == 0) base = atomicAdd(used, cnt);
  base = __shfl_sync(kFull, base, 0);
  if (base + cnt > kPool) return -1;
  const unsigned lt = (1u << lane) - 1u;
  int off = base;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    if (x[j] < kDead)
      pool[off + __popc(m[j] & lt)] =
          make_float4(x[j], y[j], z[j], __int_as_float(p[j]));
    off += __popc(m[j]);
  }
  *base_out = base;
  return cnt;
}

template <int MAXK, int CH>
__global__ void __launch_bounds__(kThreads)
    knn_select_runs_kernel(const float* __restrict__ nbr_xyz,
                           const int* __restrict__ nbr_pid,
                           const int* __restrict__ dslot,
                           const float* __restrict__ centers,
                           const uint8_t* __restrict__ ok, int C, int QP,
                           int K, float r2, int* __restrict__ out_pid,
                           float* __restrict__ out_d2) {
  extern __shared__ float4 pool[];
  __shared__ int run_row[kSlots], run_base[kSlots], run_cnt[kSlots],
      run_round[kSlots], slot_run[kSlots];
  __shared__ int warp_last[kSlots / 32], warp_starts[kSlots / 32];
  __shared__ int used, nruns;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int c0 = blockIdx.x * kSlots;

  // Runs, one thread per slot (the first kSlots threads): a selecting slot
  // starts one unless the nearest selecting slot before it in the block
  // reads the same row.
  if (t < kSlots) {
    const int c = c0 + t;
    const unsigned lt = (1u << lane) - 1u;
    int slot = -1;
    bool sel = false;
    if (c < C) {
      slot = dslot[c];
      sel = ok[c] != 0 && slot >= 0;
    }
    const unsigned smask = __ballot_sync(kFull, sel);
    const unsigned before = smask & lt;
    const int prev_in_warp =
        __shfl_sync(kFull, slot, before ? 31 - __clz(before) : lane);
    const int last =
        smask ? __shfl_sync(kFull, slot, 31 - __clz(smask)) : -1;
    if (lane == 0) warp_last[w] = last;
    named_barrier_slots();
    int prev = -1;
    if (before) {
      prev = prev_in_warp;
    } else {
      for (int v = w - 1; v >= 0; --v)
        if (warp_last[v] >= 0) {
          prev = warp_last[v];
          break;
        }
    }
    const bool start = sel && prev != slot;
    const unsigned stmask = __ballot_sync(kFull, start);
    if (lane == 0) warp_starts[w] = __popc(stmask);
    named_barrier_slots();
    int n = 0, run = -1;
#pragma unroll
    for (int v = 0; v < kSlots / 32; ++v) {
      if (v < w) run += warp_starts[v];
      n += warp_starts[v];
    }
    run += __popc(stmask & (lt | (1u << lane)));
    if (start) {
      run_row[run] = slot;
      run_round[run] = -1;
    }
    slot_run[t] = sel ? run : -1;
    if (t == 0) {
      nruns = n;
      used = 0;
    }
    if (c < C && !sel) {
      for (int k = 0; k < K; ++k) {
        out_pid[(size_t)c * K + k] = -1;
        out_d2[(size_t)c * K + k] = CUDART_INF_F;
      }
    }
  }
  __syncthreads();

  // Selection: kLanes lanes per slot, lane h of a slot takes the staged
  // candidates h, h + kLanes, ...
  const int sl = t / kLanes, h = t % kLanes;
  const int c = c0 + sl;
  const int run = slot_run[sl];
  const int n_runs = nruns;
  float cx = 0.f, cy = 0.f, cz = 0.f;
  if (run >= 0) {
    cx = centers[3 * c];
    cy = centers[3 * c + 1];
    cz = centers[3 * c + 2];
  }
  const float r2c = r2 > 0.f ? r2 : CUDART_INF_F;
  // the slot's lanes, which always take the same branches
  const unsigned group = ((1u << kLanes) - 1u) << (lane & ~(kLanes - 1));

  for (int rnd = 0;; ++rnd) {
    // each warp stages runs w, w + kWarps, ... that are not staged yet,
    // until the pool of this round is full
    for (int r = w; r < n_runs; r += kWarps) {
      if (run_round[r] >= 0) continue;
      if (__shfl_sync(kFull, *(volatile int*)&used, 0) >= kPool) break;
      int base;
      const int cnt = stage_row<CH>(nbr_xyz, nbr_pid, run_row[r], QP, pool,
                                    &used, lane, &base);
      if (cnt >= 0 && lane == 0) {
        run_base[r] = base;
        run_cnt[r] = cnt;
        run_round[r] = rnd;
      }
    }
    __syncthreads();
    if (t == 0) used = 0;
    if (run >= 0 && run_round[run] == rnd) {
      // a sorted top-K of this lane's candidates: (d2, position in the
      // staged row, which ascends with the candidate index)
      float td[MAXK];
      int tp[MAXK];
#pragma unroll
      for (int j = 0; j < MAXK; ++j) {
        td[j] = CUDART_INF_F;
        tp[j] = kNoPos;
      }
      const float4* e = pool + run_base[run];
      const int n = run_cnt[run];
      for (int i = h; i < n; i += kLanes) {
        const float4 v = e[i];
        const float dd = dist2(v.x, v.y, v.z, cx, cy, cz);
        if (dd <= r2c && dd < td[MAXK - 1]) {
          // insert after every entry <= dd: those came from lower candidates
#pragma unroll
          for (int j = MAXK - 1; j > 0; --j) {
            const bool up = dd < td[j - 1];
            const bool here = dd < td[j];
            tp[j] = up ? tp[j - 1] : (here ? i : tp[j]);
            td[j] = up ? td[j - 1] : (here ? dd : td[j]);
          }
          if (dd < td[0]) {
            td[0] = dd;
            tp[0] = i;
          }
        }
      }
      // merge the lanes' lists on (d2, position): K rounds of a minimum
      // over the slot's lanes; its owner pops it
#pragma unroll
      for (int k = 0; k < MAXK; ++k) {
        if (k < K) {
          float wd = td[0];
          int wp = tp[0];
#pragma unroll
          for (int off = 1; off < kLanes; off <<= 1) {
            const float od = __shfl_xor_sync(group, wd, off);
            const int op = __shfl_xor_sync(group, wp, off);
            if (od < wd || (od == wd && op < wp)) {
              wd = od;
              wp = op;
            }
          }
          if (tp[0] == wp) {
#pragma unroll
            for (int j = 0; j < MAXK - 1; ++j) {
              td[j] = td[j + 1];
              tp[j] = tp[j + 1];
            }
            td[MAXK - 1] = CUDART_INF_F;
            tp[MAXK - 1] = kNoPos;
          }
          if (h == 0) {
            const bool fin = wp != kNoPos;
            out_pid[(size_t)c * K + k] = fin ? __float_as_int(e[wp].w) : -1;
            out_d2[(size_t)c * K + k] = fin ? wd : CUDART_INF_F;
          }
        }
      }
    }
    // every run staged: done; else the pool is reused in the next round
    if (!__syncthreads_or(t < n_runs && run_round[t] < 0)) break;
  }
}

template <int MAXC>
__global__ void knn_select_warp_kernel(const float* __restrict__ nbr_xyz,
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
      const float x = xs[q];
      const float dd = dist2(x, xs[QP + q], xs[2 * QP + q], cx, cy, cz);
      bool good = x < kDead;
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

// ---- the wide path (QP > 512) ---------------------------------------------

constexpr int kChunk = 512;            // candidates a chunk of a wide row

// One warp per slot, any K: each chunk of the row in registers, merged with
// the running list (sorted, K entries) of the previous chunks into the
// other buffer.
__global__ void knn_select_wide_warp_kernel(
    const float* __restrict__ nbr_xyz, const int* __restrict__ nbr_pid,
    const int* __restrict__ dslot, const float* __restrict__ centers,
    const uint8_t* __restrict__ ok, int C, int QP, int K, float r2,
    int* __restrict__ out_pid, float* __restrict__ out_d2,
    int* __restrict__ tmp_pid, float* __restrict__ tmp_d2) {
  constexpr int CH = kChunk / 32;
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= C) return;  // the whole warp leaves together
  const size_t o = (size_t)c * K;
  const int slot = dslot[c];
  if (!(ok[c] != 0 && slot >= 0)) {
    for (int k = lane; k < K; k += 32) {
      out_pid[o + k] = -1;
      out_d2[o + k] = CUDART_INF_F;
    }
    return;
  }
  const float* xs = nbr_xyz + (size_t)slot * 3 * QP;
  const int* ps = nbr_pid + (size_t)slot * QP;
  const float cx = centers[3 * c], cy = centers[3 * c + 1],
              cz = centers[3 * c + 2];
  const int nch = (QP + kChunk - 1) / kChunk;

  for (int j = 0; j < nch; ++j) {
    const int q0 = j * kChunk;
    // the last chunk writes the output
    const bool to_out = ((nch - 1 - j) & 1) == 0;
    int* dp = to_out ? out_pid : tmp_pid;
    float* dd2 = to_out ? out_d2 : tmp_d2;
    const int* sp = to_out ? tmp_pid : out_pid;
    const float* sd2 = to_out ? tmp_d2 : out_d2;
    float d[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int q = q0 + lane + 32 * i;
      float v = CUDART_INF_F;
      if (q < QP) {
        const float x = xs[q];
        const float dd = dist2(x, xs[QP + q], xs[2 * QP + q], cx, cy, cz);
        bool good = x < kDead;
        if (r2 > 0.f) good = good && (dd <= r2);
        v = good ? dd : CUDART_INF_F;
      }
      d[i] = v;
    }
    int p = 0;  // the running list's head
    for (int k = 0; k < K; ++k) {
      float bv = CUDART_INF_F;
      int bi = kNone;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        if (d[i] < bv) {  // strict: the earlier candidate keeps a tie
          bv = d[i];
          bi = q0 + lane + 32 * i;
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
      // the list's head, from earlier chunks: it wins a tie
      const float hd = j > 0 ? sd2[o + p] : CUDART_INF_F;
      if (!(bv < CUDART_INF_F)) {
        // the chunk has nothing left: the rest comes from the list
        for (int kk = k + lane; kk < K; kk += 32) {
          const int src = p + kk - k;
          dp[o + kk] = j > 0 ? sp[o + src] : -1;
          dd2[o + kk] = j > 0 ? sd2[o + src] : CUDART_INF_F;
        }
        break;
      }
      if (hd <= bv) {
        if (lane == 0) {
          dp[o + k] = sp[o + p];
          dd2[o + k] = hd;
        }
        ++p;
      } else {
#pragma unroll
        for (int i = 0; i < CH; ++i)
          if (q0 + lane + 32 * i == bi) d[i] = CUDART_INF_F;
        if (lane == 0) {
          dp[o + k] = ps[bi];
          dd2[o + k] = bv;
        }
      }
    }
    __syncwarp();
  }
}

int launch_wide(const float* nbr_xyz, const int* nbr_pid, const int* dslot,
                const float* centers, const uint8_t* ok, int C, int QP, int K,
                float r2, int* out_pid, float* out_d2, int* tmp_pid,
                float* tmp_d2, cudaStream_t s) {
  if (tmp_pid == nullptr || tmp_d2 == nullptr)
    return (int)cudaErrorInvalidValue;
  knn_select_wide_warp_kernel<<<(C + 7) / 8, 256, 0, s>>>(
      nbr_xyz, nbr_pid, dslot, centers, ok, C, QP, K, r2, out_pid, out_d2,
      tmp_pid, tmp_d2);
  return 0;
}

template <int MAXK, int CH>
int launch_runs(const float* nbr_xyz, const int* nbr_pid, const int* dslot,
                const float* centers, const uint8_t* ok, int C, int QP, int K,
                float r2, int* out_pid, float* out_d2, cudaStream_t s) {
  const size_t smem = kPool * sizeof(float4);
  // above 48 KB of dynamic shared memory a kernel must opt in, once
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        knn_select_runs_kernel<MAXK, CH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  knn_select_runs_kernel<MAXK, CH><<<(C + kSlots - 1) / kSlots,
                                     kThreads, smem, s>>>(
      nbr_xyz, nbr_pid, dslot, centers, ok, C, QP, K, r2, out_pid, out_d2);
  return 0;
}

}  // namespace

// route: the register top-K's capacity of the run path (8 or 16, K <=
// route), or 0 for the warp path (any K <= QP). The wrapper picks it from K
// (ops/knn_select.py `route_for`). Rows of more than kMaxRow = 512
// candidates take the wide path at any route, its warp kernel keeping the
// running lists in the output and in tmp_pid / tmp_d2 ([C, K], given only
// for rows that wide).
extern "C" int knn_select_launch(const float* nbr_xyz, const int* nbr_pid,
                                 const int* dslot, const float* centers,
                                 const uint8_t* ok, int C, int QP, int K,
                                 float r2, int route, int* out_pid,
                                 float* out_d2, int* tmp_pid, float* tmp_d2,
                                 void* stream) {
  if (C == 0) return 0;
  if (K <= 0 || K > QP) return (int)cudaErrorInvalidValue;
  if (route > 0 && K > route) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (QP > kMaxRow) {
    const int e = launch_wide(nbr_xyz, nbr_pid, dslot, centers, ok, C, QP, K,
                              r2, out_pid, out_d2, tmp_pid, tmp_d2, s);
    return e ? e : (int)cudaGetLastError();
  }
  int err = 0;
  // the run path's instances: top-K capacity (route) x row chunks
  using Launch = int (*)(const float*, const int*, const int*, const float*,
                         const uint8_t*, int, int, int, float, int*, float*,
                         cudaStream_t);
  Launch runs = nullptr;
  if (route == 8 && K <= 8)
    runs = QP <= 256 ? &launch_runs<8, 8> : &launch_runs<8, 16>;
  else if (route == 16 && K <= 16)
    runs = QP <= 256 ? &launch_runs<16, 8> : &launch_runs<16, 16>;
  if (runs) {
    err = runs(nbr_xyz, nbr_pid, dslot, centers, ok, C, QP, K, r2, out_pid,
               out_d2, s);
  } else if (route == 0) {
    const dim3 grid((C + 7) / 8);
    if (QP <= 256)
      knn_select_warp_kernel<8><<<grid, 256, 0, s>>>(
          nbr_xyz, nbr_pid, dslot, centers, ok, C, QP, K, r2, out_pid, out_d2);
    else
      knn_select_warp_kernel<16><<<grid, 256, 0, s>>>(
          nbr_xyz, nbr_pid, dslot, centers, ok, C, QP, K, r2, out_pid, out_d2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return err ? err : (int)cudaGetLastError();
}
