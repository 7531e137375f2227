// Semi-global matching on the card: the exact path scan and the fused
// winner / left-right pass.
//
// Replaces two TPU kernels of thor_slam_tpu/ops/sgm_pallas.py:
//
// * _scan_kernel / _scan_add_kernel (entry points sgm_aggregate_dir and
//   sgm_aggregate_4dir): the SGM recurrence along one image axis,
//     L[s] = c[s] + (min(L[s-1], min(L[s-1] at d-1, d+1) + P1, minL + P2) - minL),
//   with minL = min over d of L[s-1], forward or reverse, optionally adding a
//   second volume of the same layout into the output (the opposite
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
// Scan, what bounds it: the recurrence is sequential over the S steps of a
// path (400 or 640 at the flagship size), so only lines x disparities are
// independent: 400 x 64 for the horizontal pair, 640 x 64 for the vertical.
// One thread per line would leave most of the 132 SMs idle, so one WARP runs
// one line: lane l holds disparities l, l + 32, ... in registers (the carry
// never leaves them), the running min is a butterfly of shuffles and the
// d-1 / d+1 neighbours come from the neighbouring lanes. The time is the
// latency of that per-step chain, not bandwidth; the cost (and add) loads
// do not depend on the carry, so they are issued kPrefetch steps ahead
// from a register ring to keep device-memory latency off the chain.
//
// Layout: the volume is addressed through three strides (step, line,
// disparity), so the caller may pass the reference's step-major (S, D, X)
// tensor or any permuted view of it. sgm_aggregate_4dir passes views of one
// (H, W, D) copy of the cost volume: disparity is the unit-stride axis there
// for both the horizontal (line = row) and the vertical (line = column)
// pair, so each warp's load or store of one step is 32 consecutive floats
// per register, fully coalesced in all four directions, with no transpose
// between them.
//
// Winner / LR, what bounds it: one read of the (D, H, W) float32 volume per
// pass (3 passes, the second and third mostly from L2). One block per image
// row; threads stride the W columns, so each per-disparity read of a row is
// coalesced. The right-view winners of the row go to shared memory (W
// ints), then each pixel gathers the one at its match x - d.

#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e9f;  // never wins: above any reachable cost
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPrefetch = 4;
constexpr int kScanWarps = 4;  // lines per block

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

template <int K>
__global__ void __launch_bounds__(32 * kScanWarps)
    sgm_scan_kernel(const float* __restrict__ cost, const float* __restrict__ add,
                    float* __restrict__ out, int S, int X, int D, long long ss,
                    long long sx, long long sd, int reverse, float p1, float p2) {
  const int line = blockIdx.x * kScanWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (line >= X) return;  // uniform per warp: every shuffle below has 32 lanes
  const long long base = (long long)line * sx;
  long long doff[K];
  bool active[K];
  float L[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int d = k * 32 + lane;
    active[k] = d < D;
    doff[k] = (long long)d * sd;
    // A uniform carry makes the first step exact: best - minL == 0, so
    // L[0] == c[0]. Disparities past D hold the sentinel for d = D - 1.
    L[k] = active[k] ? 0.0f : kBig;
  }
  const int s0 = reverse ? S - 1 : 0;
  const int ds = reverse ? -1 : 1;

  float cbuf[kPrefetch][K];
  float abuf[kPrefetch][K];
#pragma unroll
  for (int j = 0; j < kPrefetch; ++j) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      cbuf[j][k] = 0.0f;
      abuf[j][k] = 0.0f;
      if (j < S && active[k]) {
        const long long o = (long long)(s0 + j * ds) * ss + base + doff[k];
        cbuf[j][k] = cost[o];
        if (add != nullptr) abuf[j][k] = add[o];
      }
    }
  }

  for (int i0 = 0; i0 < S; i0 += kPrefetch) {
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      const int i = i0 + j;
      if (i >= S) break;  // uniform across the warp
      const long long srow = (long long)(s0 + i * ds) * ss + base;
      float c[K], a[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        c[k] = cbuf[j][k];
        a[k] = abuf[j][k];
      }
      const int inext = i + kPrefetch;
      if (inext < S) {
        const long long nrow = (long long)(s0 + inext * ds) * ss + base;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (active[k]) {
            cbuf[j][k] = cost[nrow + doff[k]];
            if (add != nullptr) abuf[j][k] = add[nrow + doff[k]];
          }
        }
      }

      float m = L[0];
#pragma unroll
      for (int k = 1; k < K; ++k) m = fminf(m, L[k]);
      const float pm = warp_min(m);
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
        nl[k] = active[k] ? c[k] + (best - pm) : kBig;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        L[k] = nl[k];
        if (active[k]) out[srow + doff[k]] = add != nullptr ? L[k] + a[k] : L[k];
      }
    }
  }
}

template <int K>
cudaError_t launch_scan(const float* cost, const float* add, float* out, int S, int X, int D,
                        long long ss, long long sx, long long sd, int reverse, float p1,
                        float p2, cudaStream_t stream) {
  const int blocks = (X + kScanWarps - 1) / kScanWarps;
  sgm_scan_kernel<K><<<blocks, 32 * kScanWarps, 0, stream>>>(cost, add, out, S, X, D, ss, sx,
                                                              sd, reverse, p1, p2);
  return cudaGetLastError();
}

__global__ void winner_lr_kernel(const float* __restrict__ agg, int D, int H, int W,
                                 int* __restrict__ d_best, float* __restrict__ c0,
                                 float* __restrict__ cm, float* __restrict__ cp,
                                 float* __restrict__ second, int* __restrict__ d_r_at) {
  extern __shared__ int smem[];
  int* s_db = smem;       // left winner per column of this row
  int* s_dbr = smem + W;  // right-view winner per column of this row
  const int y = blockIdx.x;
  const long long plane = (long long)H * W;
  const float* row = agg + (long long)y * W;
  const long long orow = (long long)y * W;

  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    // argmin over d, first index on ties (strict <, as jnp.argmin).
    float vb = row[x];
    int db = 0;
    for (int dd = 1; dd < D; ++dd) {
      const float v = row[dd * plane + x];
      if (v < vb) {
        vb = v;
        db = dd;
      }
    }
    float sec = kBig;
    for (int dd = 0; dd < D; ++dd) {
      if (dd < db - 1 || dd > db + 1) sec = fminf(sec, row[dd * plane + x]);
    }
    const int dm = db > 0 ? db - 1 : 0;
    const int dp = db < D - 1 ? db + 1 : D - 1;
    s_db[x] = db;
    d_best[orow + x] = db;
    c0[orow + x] = vb;
    cm[orow + x] = row[dm * plane + x];
    cp[orow + x] = row[dp * plane + x];
    second[orow + x] = sec;
  }
  // Right view: dbr[xr] = argmin_dd agg[dd, y, xr + dd]; columns past the
  // image never win (dd = 0 is always inside).
  for (int xr = threadIdx.x; xr < W; xr += blockDim.x) {
    float vb = row[xr];
    int db = 0;
    for (int dd = 1; dd < D && xr + dd < W; ++dd) {
      const float v = row[dd * plane + xr + dd];
      if (v < vb) {
        vb = v;
        db = dd;
      }
    }
    s_dbr[xr] = db;
  }
  __syncthreads();
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    const int xr = x - s_db[x];
    d_r_at[orow + x] = xr >= 0 ? s_dbr[xr] : 0;
  }
}

}  // namespace

extern "C" int thor_sgm_scan(const float* cost, const float* add, float* out, int S, int X,
                             int D, long long ss, long long sx, long long sd, int reverse,
                             float p1, float p2, void* stream) {
  if (S <= 0 || X <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  switch ((D + 31) / 32) {
    case 1: return launch_scan<1>(cost, add, out, S, X, D, ss, sx, sd, reverse, p1, p2, st);
    case 2: return launch_scan<2>(cost, add, out, S, X, D, ss, sx, sd, reverse, p1, p2, st);
    case 3: return launch_scan<3>(cost, add, out, S, X, D, ss, sx, sd, reverse, p1, p2, st);
    case 4: return launch_scan<4>(cost, add, out, S, X, D, ss, sx, sd, reverse, p1, p2, st);
    case 5: return launch_scan<5>(cost, add, out, S, X, D, ss, sx, sd, reverse, p1, p2, st);
    case 6: return launch_scan<6>(cost, add, out, S, X, D, ss, sx, sd, reverse, p1, p2, st);
    case 7: return launch_scan<7>(cost, add, out, S, X, D, ss, sx, sd, reverse, p1, p2, st);
    case 8: return launch_scan<8>(cost, add, out, S, X, D, ss, sx, sd, reverse, p1, p2, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int thor_sgm_winner_lr(const float* agg, int D, int H, int W, int* d_best,
                                  float* c0, float* cm, float* cp, float* second, int* d_r_at,
                                  void* stream) {
  if (D <= 0 || H <= 0 || W <= 0) return 0;
  const size_t smem = 2 * sizeof(int) * (size_t)W;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        winner_lr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  winner_lr_kernel<<<H, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      agg, D, H, W, d_best, c0, cm, cp, second, d_r_at);
  return static_cast<int>(cudaGetLastError());
}
