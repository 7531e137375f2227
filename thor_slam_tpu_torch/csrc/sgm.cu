// Semi-global matching on the card: the exact path scan and the fused
// winner / left-right pass.
//
// Replaces two TPU kernels of thor_slam_tpu/ops/sgm_pallas.py:
//
// * _scan_kernel / _scan_add_kernel (entry points sgm_aggregate_dir and
//   sgm_aggregate_4dir): the SGM recurrence along one image axis,
//     L[s] = c[s] + (min(L[s-1], min(L[s-1] at d-1, d+1) + P1, minL + P2) - minL),
//   with minL = min over d of L[s-1], forward or reverse, optionally adding
//   volumes of the output's layout into the output (the opposite
//   direction's result: the fused pair sum of _scan_add_kernel).
// * _winner_kernel (entry point winner_lr): per pixel the argmin disparity,
//   the costs at clip(d-1), d, clip(d+1), the second-best outside +-1 and
//   the right-view winner at the left match (the left-right check).
//
// Arithmetic is float32 in the reference's order, so with integral costs and
// penalties every value is the integer the TPU kernel's bfloat16 carry
// holds (all stay <= 256), and with non-integral penalties the scan is still
// the exact recurrence. The TPU layout gates (D % 16, step blocks that
// divide the path, H % 16, W padded to 3 x 128 windows) do not apply: any
// D <= 256 and any H, W are taken.
//
// ---- Scan (sgm_scan_kernel) ----------------------------------------------
//
// What bounds it. The recurrence is sequential over the S steps of a path
// (640 horizontal, 400 vertical at the flagship size); only lines x
// disparities are independent: ~1000 lines in flight, ~8 a SM. One WARP
// runs one line: lane l holds disparities l, l + 32, ... in registers (the
// carry never leaves them), d-1 / d+1 come from the neighbouring lanes, and
// the min over the warp is one redux.sync on an order-preserving int image
// of the floats (one instruction on the chain where the butterfly was five
// dependent shuffles). With one or two line warps per scheduler the step
// is bound by the in-order issue of its instructions: two lines
// interleaved in one warp doubled the warp's step time. The 4-direction
// path also moves ~11 V (V = 65.5 MB at D = 64, 400 x 640): the cost read
// 4x, two forward results written and read back, the output written twice
// and read once (the port's tables count V in + V out as its bound).
//
// Design. The kernel reads the (D, H, W) cost volume where it lies and
// writes (D, H, W): every volume is addressed as (step, disparity, line)
// through strides. A block runs LB adjacent lines (LB line warps) and
// kCopyWarps copy warps. The copy warps move chunks of TS steps, a
// (TS x LB x D) tile each, through a ring of kStages buffers in shared
// memory: cp.async in, kStages - 1 chunks ahead, and stores out once the
// line warps are done, walking each tile with the volume's unit-stride axis
// across the lanes (steps for the horizontal pair, lines for the vertical
// one), so each warp access covers whole 32-byte sectors. Named barriers
// pace the ring (FULL and DONE per buffer): a waiting warp is descheduled
// and takes no issue slots from the line warps (a spinning mbarrier wait
// did, and was slower). The line warps only scan: inputs from the tile
// (disparity innermost, rows padded to an odd length: conflict-free), the
// result written back in place, plus the added volumes in the reference's
// order. The kernel is specialised on the number of added volumes, and the
// lanes past D compute on a clamped address instead of branching: both
// take instructions off the step.
//
// The 4-direction path is three launches of this one kernel:
//   1. forward horizontal + forward vertical (two jobs, one grid): F_h, F_v;
//   2. reverse horizontal + F_h -> out (the horizontal pair);
//   3. reverse vertical + F_v + out -> out: (L_rev_v + F_v) + pair_h, equal
//      bit for bit to pair_h + (L_rev_v + F_v) since f32 addition commutes.
// No layout copy and no separate sum remain, and no float atomics: every
// output element is written by exactly one thread. Its device time on the
// H100, against the 2.0 ms that four scans, a layout copy and a sum took,
// is in PERF.md.
//
// ---- Winner / LR (winner_lr_kernel) ----------------------------------------
//
// What bounds it: one read of the (D, H, W) volume (65.5 MB at D = 64,
// 400 x 640) and six (H, W) planes out, ~21 us at 3.35 TB/s. The old design
// (one block per row) walked all D disparities three times from device
// memory with ~3 blocks per SM.
//
// Design. One block per tile of kTW = 128 columns of one row (2000 blocks at
// 400 x 640). The right-view winner at column xr is the argmin over dd of
// agg[dd, y, xr + dd], and the left match of column x is xr = x - d_best, so
// the tile needs the window of columns [x0 - (D - 1), x0 + kTW - 1 + D - 1].
// The window streams through shared memory in chunks of kWinDC disparities
// (16-byte cp.async where W % 4 == 0), kWinStages - 1 chunks ahead of the
// compute, so the volume is read once from device memory (the halo again
// from L2) and no block holds all D rows. The left view is one pass over d:
// the first argmin, the costs at d -+ 1, and the second best outside +-1 as
// the min of the prefix before d - 1 (taken when d becomes the argmin) and of
// the values after d + 1; the right-view argmins run over the same chunks.
// The six outputs are written one column per thread, coalesced. It is
// bound by instructions (the streaming left update is ~15 an element);
// its time on the H100 is in PERF.md.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kBig = 1e9f;  // never wins: above any reachable cost
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStages = 4;                     // scan: chunks in the ring
constexpr int kScanMaxTSLog2 = 4;              // scan: at most 16 steps a chunk
constexpr size_t kScanSmemBudget = 220 << 10;  // scan: dynamic shared memory per block, at most
constexpr int kMaxJobs = 2;
constexpr int kCopyWarps = 8;                  // scan: warps that copy chunks in and out
constexpr int kTW = 128;                       // winner: columns (= threads) per block
constexpr int kWinDC = 8;                      // winner: disparities per staged chunk
constexpr int kWinStages = 3;                  // winner: chunks in flight + 1

// Order-preserving int image of a float (no NaN): a < b <=> ordered(a) < ordered(b).
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int i) { return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff); }

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One path scan of a launch. Volumes are (S, D, X) through the strides; the
// output and the added volumes share the cost's strides.
struct ScanJob {
  const float* cost;
  const float* add;   // nullable
  const float* add2;  // nullable
  float* out;
  long long ss, sx, sd;
  int S, X;
  int reverse;
  int mode;    // the unit-stride axis the tile copy walks: 0 steps, 1 lines, 2 disparities
  int block0;  // first block of this job
};

struct ScanArgs {
  ScanJob job[kMaxJobs];
  int njobs;
  int D, Dp;             // disparities, padded tile row (odd)
  int ts_log2, lb_log2;  // chunk steps, lines per block
  int ntiles;            // tiles per stage: cost (+ add) (+ add2)
  float p1, p2;
};

// The scan's stage ring is paced by named barriers (id 0 is __syncthreads):
// buffer b is FULL once the copy warps have landed a chunk in it, DONE once
// the line warps have scanned it; kCopyBar orders the copy warps among
// themselves. A warp waiting at a barrier is descheduled, so the copy warps
// take no issue slots from the line warps while they wait.
constexpr int kCopyBar = 1;
__device__ __forceinline__ int full_bar(int b) { return 2 + b; }
__device__ __forceinline__ int done_bar(int b) { return 2 + kStages + b; }
__device__ __forceinline__ void bar_sync(int id, int n) { asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory"); }
__device__ __forceinline__ void bar_arrive(int id, int n) { asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory"); }

// K: registers of disparities a lane holds; NADD: volumes added to the result.
template <int K, int NADD>
__global__ void __launch_bounds__(32 * (8 + kCopyWarps)) sgm_scan_kernel(const __grid_constant__ ScanArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int bid = blockIdx.x;
  const ScanJob j = (a.njobs > 1 && bid >= a.job[1].block0) ? a.job[1] : a.job[0];
  const int D = a.D, Dp = a.Dp, ts_log2 = a.ts_log2, lb_log2 = a.lb_log2;
  const int ts = 1 << ts_log2, lb = 1 << lb_log2;
  const int x0 = (bid - j.block0) << lb_log2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tile_elems = ts * lb * Dp;
  const int stage_elems = tile_elems * a.ntiles;
  const int nchunks = (j.S + ts - 1) >> ts_log2;
  const int nthreads = blockDim.x;
  // Offset of (step t, line l) in a tile; disparity is innermost, and the
  // copy's unit-stride axis sits next to it so its lanes land one odd
  // padded row apart (distinct banks).
  auto row_at = [&](int t, int l) {
    return j.mode == 0 ? ((l << ts_log2) + t) * Dp : ((t << lb_log2) + l) * Dp;
  };

  if (warp >= lb) {
    // ---- Copy warps: chunks c + 1 .. c + kStages - 1 in flight while c is scanned.
    const int ctid = threadIdx.x - 32 * lb;
    const int ncopy = 32 * kCopyWarps;
    // Device offset of (step t, line l, disparity 0) of a chunk, or -1 past the volume.
    auto global_at = [&](int chunk, int t, int l) -> long long {
      const int i = (chunk << ts_log2) + t;
      const int x = x0 + l;
      if (i >= j.S || x >= j.X) return -1;
      const int s = j.reverse ? j.S - 1 - i : i;
      return (long long)s * j.ss + (long long)x * j.sx;
    };
    // Calls f(tile offset, device offset) for each element this thread
    // copies. Threads own (step, line) pairs, the copy's unit-stride axis
    // fastest across the lanes, and share their disparities; disparity-major
    // volumes (mode 2) walk disparity fastest. Loads and stores take the
    // same walk, so a thread only rewrites elements it has itself stored.
    auto walk = [&](int chunk, auto f) {
      const int plog = ts_log2 + lb_log2;
      const int pairs = 1 << plog;
      if (j.mode != 2) {
        // ncopy >= pairs: ncopy / pairs threads share a pair's disparities.
        const bool spread = ncopy >= pairs;
        const int dfirst = spread ? ctid >> plog : 0;
        const int dstep = spread ? ncopy >> plog : 1;
        const long long gstep = (long long)dstep * j.sd;
        for (int q = spread ? ctid & (pairs - 1) : ctid; q < pairs; q += spread ? pairs : ncopy) {
          const int t = j.mode == 0 ? q & (ts - 1) : q >> lb_log2;
          const int l = j.mode == 0 ? q >> ts_log2 : q & (lb - 1);
          long long g = global_at(chunk, t, l);
          if (g < 0) continue;
          int at = row_at(t, l) + dfirst;
          g += (long long)dfirst * j.sd;
#pragma unroll 4
          for (int d = dfirst; d < D; d += dstep, at += dstep, g += gstep) f(at, g);
        }
        return;
      }
      for (int e = ctid; e < pairs * D; e += ncopy) {
        const int d = e % D;
        const int q = e / D;
        const int t = q & (ts - 1), l = q >> ts_log2;
        const long long g = global_at(chunk, t, l);
        if (g >= 0) f(row_at(t, l) + d, g + (long long)d * j.sd);
      }
    };
    auto load = [&](int chunk) {
      float* st = smem + (chunk % kStages) * stage_elems;
      walk(chunk, [&](int at, long long off) {
        cp_async4(st + at, j.cost + off);
        if (NADD > 0) cp_async4(st + tile_elems + at, j.add + off);
        if (NADD > 1) cp_async4(st + 2 * tile_elems + at, j.add2 + off);
      });
    };
    for (int c = 0; c < kStages; ++c) {
      if (c < nchunks) load(c);
      cp_async_commit();
    }
    cp_async_wait<kStages - 1>();  // chunk 0 landed
    bar_arrive(full_bar(0), nthreads);
    for (int c = 0; c < nchunks; ++c) {
      const int b = c % kStages;
      if (c + 1 < nchunks) {
        cp_async_wait<kStages - 2>();  // chunk c + 1 landed
        bar_arrive(full_bar((c + 1) % kStages), nthreads);
      }
      bar_sync(done_bar(b), nthreads);  // chunk c scanned
      const float* st = smem + b * stage_elems;
      walk(c, [&](int at, long long off) { j.out[off] = st[at]; });
      bar_sync(kCopyBar, ncopy);  // every copy thread has read buffer b
      if (c + kStages < nchunks) load(c + kStages);
      cp_async_commit();
    }
    cp_async_wait<0>();
    return;
  }

  // ---- Line warps: warp w scans line x0 + w. The carry: lane l holds
  // disparities l, l + 32, ...; past D the sentinel, computed on the last
  // disparity's cost (a clamped address, no branch) and never stored. A
  // uniform carry makes the first step exact: L[0] == c[0]. Scalars are
  // copied into registers: stores to shared memory through a generic
  // pointer could otherwise make the compiler reload the parameter block.
  const float p1 = a.p1, p2 = a.p2;
  const int S = j.S;
  bool active[K];
  int at_k[K];  // the lane's k-th disparity in a tile row
  float L[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    active[k] = k * 32 + lane < D;
    at_k[k] = min(k * 32 + lane, D - 1);
    L[k] = active[k] ? 0.0f : kBig;
  }
  const bool line_ok = x0 + warp < j.X;  // uniform per warp
#pragma unroll 1
  for (int c = 0; c < nchunks; ++c) {
    const int b = c % kStages;
    bar_sync(full_bar(b), nthreads);
    float* st = smem + b * stage_elems;
    const int steps = min(ts, S - (c << ts_log2));
    if (line_ok) {
#pragma unroll 1
      for (int t = 0; t < steps; ++t) {
        float* row = st + row_at(t, warp);
        // The step's inputs first: none depends on the carry.
        float cv[K], av[K], bv[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          cv[k] = row[at_k[k]];
          if (NADD > 0) av[k] = row[tile_elems + at_k[k]];
          if (NADD > 1) bv[k] = row[2 * tile_elems + at_k[k]];
        }
        float m = L[0];
#pragma unroll
        for (int k = 1; k < K; ++k) m = fminf(m, L[k]);
        const float pm = unordered(__reduce_min_sync(kFull, ordered(m)));
        float nl[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float up = __shfl_down_sync(kFull, L[k], 1);  // d + 1
          float dn = __shfl_up_sync(kFull, L[k], 1);    // d - 1
          const float next_first = __shfl_sync(kFull, L[k + 1 < K ? k + 1 : k], 0);
          const float prev_last = __shfl_sync(kFull, L[k > 0 ? k - 1 : k], 31);
          if (lane == 31) up = k + 1 < K ? next_first : kBig;
          if (lane == 0) dn = k > 0 ? prev_last : kBig;
          const float best = fminf(fminf(L[k], fminf(up, dn) + p1), pm + p2);
          nl[k] = active[k] ? cv[k] + (best - pm) : kBig;
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          L[k] = nl[k];
          float v = nl[k];
          if (NADD > 0) v = v + av[k];
          if (NADD > 1) v = v + bv[k];
          if (active[k]) row[at_k[k]] = v;
        }
      }
    }
    bar_arrive(done_bar(b), nthreads);
  }
}

template <int K, int NADD>
cudaError_t launch_scan(const ScanArgs& a, int blocks, size_t smem, cudaStream_t stream) {
  // The 48 KB default counts static shared memory too: opt in to the budget.
  // The attribute belongs to the current device's context, so it is set on
  // every launch (a cheap host call) rather than once per process.
  const cudaError_t e = cudaFuncSetAttribute(sgm_scan_kernel<K, NADD>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kScanSmemBudget);
  if (e != cudaSuccess) return e;
  sgm_scan_kernel<K, NADD><<<blocks, 32 * ((1 << a.lb_log2) + kCopyWarps), smem, stream>>>(a);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_scan_k(const ScanArgs& a, int blocks, size_t smem, cudaStream_t stream) {
  switch (a.ntiles) {
    case 1: return launch_scan<K, 0>(a, blocks, smem, stream);
    case 2: return launch_scan<K, 1>(a, blocks, smem, stream);
    default: return launch_scan<K, 2>(a, blocks, smem, stream);
  }
}

__global__ void __launch_bounds__(kTW)
    winner_lr_kernel(const float* __restrict__ agg, int D, int H, int W, int WW, int vec4,
                     int* __restrict__ d_best, float* __restrict__ c0, float* __restrict__ cm,
                     float* __restrict__ cp, float* __restrict__ second, int* __restrict__ d_r_at) {
  extern __shared__ __align__(16) float win[];
  const int tid = threadIdx.x;
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * kTW;
  const int x = x0 + tid;
  const long long plane = (long long)H * W;
  const float* row = agg + (long long)y * W;
  const int rlo = x0 - (D - 1);  // first right-view column the tile can match
  const int nr = kTW + D - 1;    // right-view columns [rlo, rlo + nr)
  const int nchunks = (D + kWinDC - 1) / kWinDC;
  const int stage = kWinDC * WW;
  int* s_dbr = reinterpret_cast<int*>(win + kWinStages * stage);
  const float kInf = __int_as_float(0x7f800000);
  constexpr int kR = (kTW + 255 + kTW - 1) / kTW;  // right-view columns per thread (D <= 256)

  // Chunk c: disparities [d0, d0 + kWinDC), columns [cb, cb + WW) of the row,
  // cb the multiple of 4 at or below rlo + d0 (the chunk's diagonals start
  // there and end before cb + WW).
  auto load = [&](int c) {
    const int d0 = c * kWinDC, dc = min(kWinDC, D - d0);
    const int cb = (rlo + d0) & ~3;
    float* st = win + (c % kWinStages) * stage;
    if (vec4) {  // W % 4 == 0: a group of 4 columns is all inside or all outside
      const int ng = WW >> 2;
      for (int e = tid; e < dc * ng; e += kTW) {
        const int r = e / ng, g = e - r * ng;
        const int gx = cb + 4 * g;
        if (gx >= 0 && gx < W) cp_async16(st + r * WW + 4 * g, row + (d0 + r) * plane + gx);
      }
    } else {
      for (int e = tid; e < dc * WW; e += kTW) {
        const int r = e / WW, col = e - r * WW;
        const int gx = cb + col;
        if (gx >= 0 && gx < W) cp_async4(st + r * WW + col, row + (d0 + r) * plane + gx);
      }
    }
  };

  // Left view, one pass over d: the first argmin v1 at d1 (strict <), the
  // costs at d1 -+ 1 (clipped), and the second best outside d1 +- 1 as the
  // min of [0, d1 - 2] (the prefix min pre2 when d1 was set) and of
  // [d1 + 2, D) (m_right, restarted when d1 moves).
  float v1 = kInf, prev1 = kInf, pre2 = kInf, left_min = kInf, m_right = kInf, vm = kInf, vp = kInf;
  int d1 = 0;
  float rvb[kR];
  int rdb[kR];
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    rvb[q] = kInf;
    rdb[q] = 0;
  }

#pragma unroll 1
  for (int c = 0; c < kWinStages - 1; ++c) {
    if (c < nchunks) load(c);
    cp_async_commit();
  }
#pragma unroll 1
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kWinStages - 2>();
    __syncthreads();  // chunk c landed; chunk c - 1's buffer is free
    if (c + kWinStages - 1 < nchunks) load(c + kWinStages - 1);
    cp_async_commit();
    const int d0 = c * kWinDC, dc = min(kWinDC, D - d0);
    const int cb = (rlo + d0) & ~3;
    const float* st = win + (c % kWinStages) * stage;
    if (x < W) {
      const float* src = st + (x - cb);
      for (int r = 0; r < dc; ++r) {
        const int dd = d0 + r;
        const float v = src[r * WW];
        if (v < v1) {
          left_min = pre2;
          vm = dd > 0 ? prev1 : v;
          vp = v;  // the clipped d1 + 1 while d1 is the last disparity
          v1 = v;
          d1 = dd;
          m_right = kInf;
        } else if (dd == d1 + 1) {
          vp = v;
        } else if (dd > d1 + 1) {
          m_right = fminf(m_right, v);
        }
        pre2 = fminf(pre2, prev1);
        prev1 = v;
      }
    }
    // Right view: dbr[xr] = argmin_dd agg[dd, y, xr + dd]; columns past the
    // image never win (dd = 0 is always inside).
#pragma unroll
    for (int q = 0; q < kR; ++q) {
      const int rr = tid + q * kTW;
      const int xr = rlo + rr;
      if (rr < nr && xr >= 0 && xr < W) {
        const int rmax = min(dc, W - xr - d0);  // xr + dd < W
        const float* src = st + (xr + d0 - cb);
        for (int r = 0; r < rmax; ++r) {
          const float v = src[r * WW + r];
          if (v < rvb[q]) {
            rvb[q] = v;
            rdb[q] = d0 + r;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    if (tid + q * kTW < nr) s_dbr[tid + q * kTW] = rdb[q];
  }
  __syncthreads();
  if (x < W) {
    const long long o = (long long)y * W + x;
    const int xr = x - d1;
    d_best[o] = d1;
    c0[o] = v1;
    cm[o] = vm;
    cp[o] = vp;
    second[o] = fminf(kBig, fminf(left_min, m_right));
    d_r_at[o] = xr >= 0 ? s_dbr[xr - rlo] : 0;
  }
}

// Window row length: the chunk's span kTW + D - 1 + kWinDC - 1, plus up to 3
// columns of alignment, rounded up to a multiple of 4.
int winner_row(int D) { return (kTW + D + kWinDC + 1 + 3) & ~3; }
size_t winner_smem(int D) { return sizeof(float) * ((size_t)kWinStages * kWinDC * winner_row(D) + kTW + D - 1); }

}  // namespace

// desc holds njobs records of 10 int64: cost, add, add2, out (pointers; 0 for
// none), S, X, ss, sx, sd (elements), reverse.
extern "C" int thor_sgm_scan(int njobs, const long long* desc, int D, float p1, float p2, void* stream) {
  if (njobs < 1 || njobs > kMaxJobs || D < 1 || D > 256) return static_cast<int>(cudaErrorInvalidValue);
  ScanArgs a{};
  a.njobs = njobs;
  a.D = D;
  a.p1 = p1;
  a.p2 = p2;
  bool line_major = false, add = false, add2 = false;
  for (int i = 0; i < njobs; ++i) {
    const long long* r = desc + 10 * i;
    ScanJob& j = a.job[i];
    j.cost = reinterpret_cast<const float*>(r[0]);
    j.add = reinterpret_cast<const float*>(r[1]);
    j.add2 = reinterpret_cast<const float*>(r[2]);
    j.out = reinterpret_cast<float*>(r[3]);
    j.S = (int)r[4];
    j.X = (int)r[5];
    j.ss = r[6];
    j.sx = r[7];
    j.sd = r[8];
    j.reverse = (int)r[9];
    // A job with add2 but no add keeps its tiles where the kernel reads them.
    if (j.add2 != nullptr && j.add == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    j.mode = (j.S > 1 && j.ss == 1) ? 0 : (j.X == 1 || j.sx == 1) ? 1 : 2;
    line_major |= j.mode == 1;
    add |= j.add != nullptr;
    add2 |= j.add2 != nullptr;
  }
  a.ntiles = 1 + add + add2;
  // The kernel is specialised on the number of added volumes: jobs of one
  // launch agree on it.
  for (int i = 0; i < njobs; ++i) {
    if ((a.job[i].add != nullptr) != add || (a.job[i].add2 != nullptr) != add2)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  // Vertical lines are the unit-stride axis: 8 lines fill a 32-byte sector.
  a.lb_log2 = line_major ? 3 : 2;
  a.Dp = D | 1;
  auto smem_for = [&](int ts_log2) {
    return (size_t)kStages * a.ntiles * (a.Dp << (ts_log2 + a.lb_log2)) * sizeof(float);
  };
  a.ts_log2 = kScanMaxTSLog2;
  while (a.ts_log2 > 0 && smem_for(a.ts_log2) > kScanSmemBudget) --a.ts_log2;
  const size_t smem = smem_for(a.ts_log2);
  int blocks = 0;
  for (int i = 0; i < njobs; ++i) {
    ScanJob& j = a.job[i];
    j.block0 = blocks;
    if (j.S > 0) blocks += (j.X + (1 << a.lb_log2) - 1) >> a.lb_log2;
  }
  if (blocks == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  switch ((D + 31) / 32) {
    case 1: return launch_scan_k<1>(a, blocks, smem, st);
    case 2: return launch_scan_k<2>(a, blocks, smem, st);
    case 3: return launch_scan_k<3>(a, blocks, smem, st);
    case 4: return launch_scan_k<4>(a, blocks, smem, st);
    case 5: return launch_scan_k<5>(a, blocks, smem, st);
    case 6: return launch_scan_k<6>(a, blocks, smem, st);
    case 7: return launch_scan_k<7>(a, blocks, smem, st);
    default: return launch_scan_k<8>(a, blocks, smem, st);
  }
}

extern "C" int thor_sgm_winner_lr(const float* agg, int D, int H, int W, int* d_best,
                                  float* c0, float* cm, float* cp, float* second, int* d_r_at,
                                  void* stream) {
  if (D <= 0 || H <= 0 || W <= 0) return 0;
  if (D > 256) return static_cast<int>(cudaErrorInvalidValue);
  const int vec4 = W % 4 == 0 && reinterpret_cast<uintptr_t>(agg) % 16 == 0;
  const dim3 grid((W + kTW - 1) / kTW, H);
  winner_lr_kernel<<<grid, kTW, winner_smem(D), static_cast<cudaStream_t>(stream)>>>(
      agg, D, H, W, winner_row(D), vec4, d_best, c0, cm, cp, second, d_r_at);
  return static_cast<int>(cudaGetLastError());
}
