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
// Design, QP > 512 and K <= 32 (the wide path: knn_select_wide_tiles_kernel
// then knn_select_wide_kernel): a row no longer fits the run path's
// register staging (CH <= 16 chunks of 32) or the warp path's MAXC per
// lane. At the reference ScanNet scene (QP 702, K 8) ~4% of the slots
// select, often whole rays of them side by side, ~98 of a row's 702
// candidates are live, and the [C, K] outputs are 62% of the bytes bound:
// - Pass 1, a block per tile of 128 consecutive slots (more past
//   kWideMaxTiles tiles), lists the tile's selecting slots (ok && dslot >=
//   0) in order with ballots and a prefix in shared memory, counts them,
//   and writes every other slot's (-1, inf) with all threads, coalesced.
// - Pass 2, as many blocks as the card holds at once, sums the tiles'
//   counts into a prefix in shared memory and gives every warp an equal,
//   contiguous share of all selecting slots, however they cluster: a tile
//   whose slots all select is spread over many warps, not one block's. No
//   host sync and no counter to reset: the scratch holds only the lists.
// - A warp holds a whole row in registers, J = 22, 27 or 34 candidates a
//   lane (QP <= 704 / 864 / 1,088; wider rows in chunks of 32 J), every
//   load issued before the first use. A candidate is a 64-bit key, (d2's
//   bits, candidate index): d2 >= 0, so the keys ascend as d2 does, ties
//   to the lowest index, the plain version's stable order.
// - The running top-K stays in registers, entry k in lane k. A chunk's
//   candidates are cut to those at or below its K-th least lane minimum
//   (K candidates lie at or below it, so none past it is among the chunk's
//   K nearest) and under the list's K-th key, a float compare and a ballot
//   a register; the few left (~10 of a row's 702 at K 8) merge with the
//   list in batches of at most 32 by their ranks in the union, counted
//   against a copy in shared memory, so no round of shuffles walks the row.
// - At the end the K lanes of the list gather the winners' ids in one load
//   and write the slot's pid and d2 coalesced.
// For K > 32 (knn_select_wide_warp_kernel) the list no longer fits a lane
// an entry: a warp per slot streams the row in chunks of kChunk = 512
// candidates and merges each into a running list kept sorted in device
// memory ([C, K] in the output and a scratch buffer of the same shape,
// alternating so the last chunk writes the output), K rounds, each taking
// the smaller of the list's head and the chunk's warp minimum, the list's
// head on a tie (every candidate of an earlier chunk has a lower index).
// The main paths use K 8 (checked also at 24); no path runs K > 32.
//
// Both paths are built with -fmad=false and written with
// __fsub_rn/__fmul_rn/__fadd_rn: the plain PyTorch twin rounds each product
// and sum, and a contracted FMA would move d2 by one ulp and flip near-ties.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

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

constexpr int kWideThreads = 128;           // threads a block of both kernels
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideMaxTiles = 11000;        // tiles whose prefix fits
                                            // 44 KB of shared memory
constexpr int kWideList = 32;               // the largest K of the register list
typedef unsigned long long u64;
constexpr u64 kNoKey = ~0ull;               // no candidate
constexpr unsigned kNoHalf = 0xffffffffu;
constexpr unsigned kInfBits = 0x7f800000u;  // +inf's bits: keys at or past
                                            // (inf, .) are padding
constexpr float kFltMax = 3.402823466e38f;

// The tiling of C slots: tiles of 128 m slots, m the least that keeps the
// tile count within kWideMaxTiles.
int wide_tile_slots(int C) {
  const int n = (C + kWideThreads - 1) / kWideThreads;
  const int m = (n + kWideMaxTiles - 1) / kWideMaxTiles;
  return kWideThreads * (m > 1 ? m : 1);
}

// A candidate's key: d2's bits above its index. d2 >= 0, so its bits order
// as its values, and equal d2 order by index, as the stable sort does.
__device__ __forceinline__ u64 wide_key(float d, int q) {
  return ((u64)__float_as_uint(d) << 32) | (unsigned)q;
}

// The K-entry list's padding: (inf, 2^31 + k), distinct, after every
// candidate and before kNoKey.
__device__ __forceinline__ u64 wide_pad(int k) {
  return ((u64)kInfBits << 32) | (0x80000000u + (unsigned)k);
}

// Merge the n <= 32 keys of buf into the list (lk: entry k in lane k < K,
// kNoKey in the others; lst: its copy in shared memory). Each key's new
// position is its rank in the union: for a candidate, the keys of buf and
// the list below it; for entry k, k plus the keys of buf below it. Keys are
// distinct, so the ranks 0..K-1 are taken once each.
__device__ __forceinline__ u64 wide_merge(u64 lk, const u64* buf, int n,
                                          int K, u64* lst, u64* nxt,
                                          int lane) {
  __syncwarp();
  const u64 ck = lane < n ? buf[lane] : kNoKey;
  int pc = 0, pl = lane;
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const u64 b = buf[i];
    pc += b < ck;
    pl += b < lk;
  }
#pragma unroll 4
  for (int k = 0; k < K; ++k) pc += lst[k] < ck;
  if (lane < n && pc < K) nxt[pc] = ck;
  if (lane < K && pl < K) nxt[pl] = lk;
  __syncwarp();
  lk = lane < K ? nxt[lane] : kNoKey;
  lst[lane] = lk;
  __syncwarp();
  return lk;
}

// The chunk's K-th least lane minimum: K candidates lie at or below it, so
// none past it is among the chunk's K nearest (kNoHalf when fewer than K
// lanes hold a candidate). K rounds, each taking the least and retiring
// one lane that holds it.
__device__ __forceinline__ unsigned wide_kth_lane_min(float lm, int K,
                                                      int lane) {
  unsigned v = lm < CUDART_INF_F ? __float_as_uint(lm) : kNoHalf;
  unsigned mh = kNoHalf;
  for (int k = 0; k < K; ++k) {
    mh = __reduce_min_sync(kFull, v);
    if (mh == kNoHalf) break;
    if (lane == __ffs(__ballot_sync(kFull, v == mh)) - 1) v = kNoHalf;
  }
  return mh;
}

// A chunk's x plane: 32 J candidates from q0, every load issued at once.
template <int J>
__device__ __forceinline__ void wide_load_x(const float* __restrict__ xs,
                                            int QP, int q0, int lane,
                                            float (&x)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int q = q0 + 32 * j + lane;
    x[j] = q < QP ? xs[q] : kDead;
  }
}

// Its y and z planes where x is live: a table voxel's live entries come
// first in its P, so the dead ones' sectors are not read.
template <int J>
__device__ __forceinline__ void wide_load_yz(const float* __restrict__ xs,
                                             int QP, int q0, int lane,
                                             const float (&x)[J],
                                             float (&y)[J], float (&z)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int q = q0 + 32 * j + lane;
    const bool live = x[j] < kDead;
    y[j] = live ? xs[QP + q] : 0.f;
    z[j] = live ? xs[2 * QP + q] : 0.f;
  }
}

// Merge one chunk of a slot's row into its list lk (K <= 32, entry k in
// lane k): d2 (+inf where the candidate is dead, cut, out of the row or not
// finite: r2c is r2, or FLT_MAX without a cut, and the plain version pads
// an infinite or NaN d2), cut to the candidates at or below the chunk's
// K-th least lane minimum and under the list's K-th key tk (the list, from
// lower indices, keeps a tie), merged in batches of at most 32.
template <int J>
__device__ __forceinline__ u64 wide_merge_chunk(
    const float (&x)[J], const float (&y)[J], const float (&z)[J], int q0,
    u64 lk, int K, float cx, float cy, float cz, float r2c, u64* buf,
    u64* lst, u64* nxt, int lane) {
  const unsigned lt = (1u << lane) - 1u;
  float d[J];
  float lm = CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float dd = dist2(x[j], y[j], z[j], cx, cy, cz);
    d[j] = x[j] < kDead && dd <= r2c ? dd : CUDART_INF_F;
    lm = fminf(lm, d[j]);
  }
  const unsigned mh = wide_kth_lane_min(lm, K, lane);
  u64 tk = __shfl_sync(kFull, lk, K - 1);
  float thr = fminf(fminf(mh == kNoHalf ? kFltMax : __uint_as_float(mh),
                          __uint_as_float((unsigned)(tk >> 32))),
                    kFltMax);
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (__ballot_sync(kFull, d[j] <= thr)) {
      const u64 key = wide_key(d[j], q0 + 32 * j + lane);
      bool p = d[j] <= thr && key < tk;
      unsigned m = __ballot_sync(kFull, p);
      if (cnt + __popc(m) > 32) {
        lk = wide_merge(lk, buf, cnt, K, lst, nxt, lane);
        tk = __shfl_sync(kFull, lk, K - 1);
        thr = fminf(thr, __uint_as_float((unsigned)(tk >> 32)));
        cnt = 0;
        p = d[j] <= thr && key < tk;
        m = __ballot_sync(kFull, p);
      }
      if (p) buf[cnt + __popc(m & lt)] = key;
      cnt += __popc(m);
    }
  }
  if (cnt) lk = wide_merge(lk, buf, cnt, K, lst, nxt, lane);
  return lk;
}

// A slot's output: the K lanes of its list gather the winners' ids in one
// load and write pid and d2 coalesced.
__device__ __forceinline__ void wide_write(u64 lk, int K,
                                           const int* __restrict__ ps,
                                           int* __restrict__ out_pid,
                                           float* __restrict__ out_d2,
                                           int lane) {
  if (lane < K) {
    const unsigned h = (unsigned)(lk >> 32);
    const bool fin = h < kInfBits;
    out_pid[lane] = fin ? ps[(unsigned)lk] : -1;
    out_d2[lane] = fin ? __uint_as_float(h) : CUDART_INF_F;
  }
}

// Pass 1: a block per tile of T slots (one a thread, T / 128 rounds) finds
// its selecting slots (ok && dslot >= 0) with ballots and a prefix in
// shared memory, lists them in order at slots[tile * T ...], counts them in
// counts[tile], and writes every other slot's (-1, inf), coalesced.
__global__ void __launch_bounds__(kWideThreads)
    knn_select_wide_tiles_kernel(const int* __restrict__ dslot,
                                 const uint8_t* __restrict__ ok, int C, int K,
                                 int T, int* __restrict__ slots,
                                 int* __restrict__ counts,
                                 int* __restrict__ out_pid,
                                 float* __restrict__ out_d2) {
  __shared__ int warp_cnt[kWideWarps];
  extern __shared__ uint8_t sel_flag[];        // [T]
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int c0 = blockIdx.x * T;
  const int n = C - c0 < T ? C - c0 : T;
  int base = 0;                                // the same in every thread
  for (int r = 0; r < T; r += kWideThreads) {
    const int c = c0 + r + t;
    const bool sel = r + t < n && ok[c] != 0 && dslot[c] >= 0;
    const unsigned m = __ballot_sync(kFull, sel);
    if (lane == 0) warp_cnt[w] = __popc(m);
    sel_flag[r + t] = sel;
    __syncthreads();
    int before = base;
#pragma unroll
    for (int v = 0; v < kWideWarps; ++v) {
      before += v < w ? warp_cnt[v] : 0;
      base += warp_cnt[v];
    }
    if (sel) slots[(size_t)c0 + before + __popc(m & ((1u << lane) - 1u))] = c;
    __syncthreads();
  }
  if (t == 0) counts[blockIdx.x] = base;
  int* op = out_pid + (size_t)c0 * K;
  float* od = out_d2 + (size_t)c0 * K;
  for (int e = t; e < n * K; e += kWideThreads)
    if (!sel_flag[e / K]) {
      op[e] = -1;
      od[e] = CUDART_INF_F;
    }
}

// Pass 2: every warp of the grid takes an equal share of all selecting
// slots, whichever tiles hold them: each block sums the tiles' counts into
// a prefix in shared memory, and warp g takes the selecting slots
// [S g / G, S (g + 1) / G) of the S in all, G warps in all, in batches of
// 32 whose slots, rows and centers its lanes look up at once. Each slot's
// row, chunk by chunk of 32 J candidates, merges into its list (K <= 32)
// in registers.
template <int J>
__global__ void __launch_bounds__(kWideThreads)
    knn_select_wide_kernel(const float* __restrict__ nbr_xyz,
                           const int* __restrict__ nbr_pid,
                           const float* __restrict__ centers,
                           const int* __restrict__ dslot,
                           const int* __restrict__ slots,
                           const int* __restrict__ counts, int ntiles, int T,
                           int QP, int K, float r2, int* __restrict__ out_pid,
                           float* __restrict__ out_d2) {
  extern __shared__ int pre[];                 // [ntiles + 1]
  __shared__ int wsum[kWideWarps];
  __shared__ u64 buf[kWideWarps][32], lst[kWideWarps][32],
      nxt[kWideWarps][32];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  // the prefix of the counts: read coalesced into shared memory, then
  // each thread sums a run of `per` tiles
#pragma unroll 8
  for (int i = t; i < ntiles; i += kWideThreads) pre[i] = counts[i];
  __syncthreads();
  const int per = (ntiles + kWideThreads - 1) / kWideThreads;
  const int s0 = t * per < ntiles ? t * per : ntiles;
  const int s1 = s0 + per < ntiles ? s0 + per : ntiles;
  int sum = 0;
  for (int i = s0; i < s1; ++i) sum += pre[i];
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) wsum[w] = incl;
  __syncthreads();
  int run = incl - sum;
#pragma unroll
  for (int v = 0; v < kWideWarps; ++v) run += v < w ? wsum[v] : 0;
  for (int i = s0; i < s1; ++i) {
    const int c = pre[i];
    pre[i] = run;
    run += c;
  }
  if (t == kWideThreads - 1) pre[ntiles] = run;
  __syncthreads();
  const long long S = pre[ntiles];
  const long long G = (long long)gridDim.x * kWideWarps;
  const long long g = (long long)blockIdx.x * kWideWarps + w;
  const int i0 = (int)(S * g / G), i1 = (int)(S * (g + 1) / G);
  const float r2c = r2 > 0.f ? r2 : kFltMax;
  for (int b = i0; b < i1; b += 32) {
    const int nb = i1 - b < 32 ? i1 - b : 32;
    // lane l looks up slot b + l: its tile (the last whose prefix is at
    // most b + l), the slot, its row and its center
    int my_cs = 0, my_row = 0;
    float my_cx = 0.f, my_cy = 0.f, my_cz = 0.f;
    if (lane < nb) {
      const int i = b + lane;
      int lo = 0, hi = ntiles - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (pre[mid] <= i) lo = mid; else hi = mid - 1;
      }
      my_cs = slots[(size_t)lo * T + (i - pre[lo])];
      my_row = dslot[my_cs];
      my_cx = centers[3 * my_cs];
      my_cy = centers[3 * my_cs + 1];
      my_cz = centers[3 * my_cs + 2];
    }
    for (int k = 0; k < nb; ++k) {
      const int cs = __shfl_sync(kFull, my_cs, k);
      const int row = __shfl_sync(kFull, my_row, k);
      const float cx = __shfl_sync(kFull, my_cx, k),
                  cy = __shfl_sync(kFull, my_cy, k),
                  cz = __shfl_sync(kFull, my_cz, k);
      const float* xs = nbr_xyz + (size_t)3 * QP * row;
      u64 lk = lane < K ? wide_pad(lane) : kNoKey;
      lst[w][lane] = lk;
      for (int q0 = 0; q0 < QP; q0 += 32 * J) {
        float x[J], y[J], z[J];
        wide_load_x<J>(xs, QP, q0, lane, x);
        wide_load_yz<J>(xs, QP, q0, lane, x, y, z);
        lk = wide_merge_chunk<J>(x, y, z, q0, lk, K, cx, cy, cz, r2c, buf[w],
                                 lst[w], nxt[w], lane);
      }
      wide_write(lk, K, nbr_pid + (size_t)row * QP, out_pid + (size_t)cs * K,
                 out_d2 + (size_t)cs * K, lane);
    }
  }
}

constexpr int kChunk = 512;            // candidates a chunk, K > 32

// K > 32: one warp per slot, each chunk of the row in registers, merged
// with the running list (sorted, K entries) of the previous chunks into
// the other buffer.
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

// The bytes of scratch a wide launch needs (knn_select_scratch_bytes):
// K <= 32, pass 1's slot lists and counts; past it the [C, K] pid / d2
// pair of the K > 32 kernel.
long long wide_scratch_need(int C, int K) {
  if (K > kWideList) return 8ll * C * K;
  const int T = wide_tile_slots(C);
  const long long nt = (C + T - 1) / T;
  return 4 * (nt * T + nt);
}

// Pass 2's grid: as many blocks as fit the current device at once, kept
// for each device and shared-memory size (C sets the latter).
template <int J>
int wide_grid(int smem, int* grid) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, int> grids;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(dev, smem);
  auto it = grids.find(key);
  if (it == grids.end()) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, knn_select_wide_kernel<J>, kWideThreads, smem);
    if (e != cudaSuccess) return (int)e;
    it = grids.emplace(key, sms * (per_sm > 0 ? per_sm : 1)).first;
  }
  *grid = it->second;
  return 0;
}

template <int J>
int launch_wide_list(const float* nbr_xyz, const int* nbr_pid,
                     const int* dslot, const float* centers,
                     const uint8_t* ok, int C, int QP, int K, float r2,
                     int* out_pid, float* out_d2, int* slots,
                     cudaStream_t s) {
  const int T = wide_tile_slots(C);
  const int ntiles = (C + T - 1) / T;
  int* counts = slots + (size_t)ntiles * T;
  knn_select_wide_tiles_kernel<<<ntiles, kWideThreads, T, s>>>(
      dslot, ok, C, K, T, slots, counts, out_pid, out_d2);
  const int smem = (ntiles + 1) * (int)sizeof(int);
  int grid = 0;
  const int e = wide_grid<J>(smem, &grid);
  if (e) return e;
  knn_select_wide_kernel<J><<<grid, kWideThreads, smem, s>>>(
      nbr_xyz, nbr_pid, centers, dslot, slots, counts, ntiles, T, QP, K, r2,
      out_pid, out_d2);
  return 0;
}

int launch_wide(const float* nbr_xyz, const int* nbr_pid, const int* dslot,
                const float* centers, const uint8_t* ok, int C, int QP, int K,
                float r2, int* out_pid, float* out_d2, void* scratch,
                long long scratch_bytes, cudaStream_t s) {
  if (scratch == nullptr || scratch_bytes < wide_scratch_need(C, K))
    return (int)cudaErrorInvalidValue;
  if (K <= kWideList) {
    int* slots = static_cast<int*>(scratch);
    if (QP <= 32 * 22)
      return launch_wide_list<22>(nbr_xyz, nbr_pid, dslot, centers, ok, C,
                                  QP, K, r2, out_pid, out_d2, slots, s);
    if (QP <= 32 * 27)
      return launch_wide_list<27>(nbr_xyz, nbr_pid, dslot, centers, ok, C,
                                  QP, K, r2, out_pid, out_d2, slots, s);
    return launch_wide_list<34>(nbr_xyz, nbr_pid, dslot, centers, ok, C, QP,
                                K, r2, out_pid, out_d2, slots, s);
  }
  int* tmp_pid = static_cast<int*>(scratch);
  float* tmp_d2 = reinterpret_cast<float*>(tmp_pid + (size_t)C * K);
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
// candidates take the wide path at any route, with `scratch_bytes` of
// scratch, as knn_select_scratch_bytes counts it.
extern "C" int knn_select_launch(const float* nbr_xyz, const int* nbr_pid,
                                 const int* dslot, const float* centers,
                                 const uint8_t* ok, int C, int QP, int K,
                                 float r2, int route, int* out_pid,
                                 float* out_d2, void* scratch,
                                 long long scratch_bytes, void* stream) {
  if (C == 0) return 0;
  if (K <= 0 || K > QP) return (int)cudaErrorInvalidValue;
  if (route > 0 && K > route) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (QP > kMaxRow) {
    const int e = launch_wide(nbr_xyz, nbr_pid, dslot, centers, ok, C, QP, K,
                              r2, out_pid, out_d2, scratch, scratch_bytes, s);
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

// The bytes of scratch a launch over C slots of QP candidates at K needs:
// pass 1's slot lists and counts on the wide path for K <= kWideList, the
// K > 32 kernel's second [C, K] list pair past it, none for rows of at
// most kMaxRow. The wrapper allocates it.
extern "C" long long knn_select_scratch_bytes(int C, int QP, int K) {
  if (C <= 0 || QP <= kMaxRow) return 0;
  return wide_scratch_need(C, K);
}
