// lms_step.cuh: the normalised-LMS recurrence in the grouped exact algebra,
// walked by three warps of a block, shared by the two kernels that run it
// (lms.cu: K3; sweep_chain.cuh: the chains with the LMS denoiser or
// auto-notch folded in).
//
// CMSIS arm_lms_norm_f32 with the reference's 128-sample decorrelation delay
// (ops/lms.py). Per sample t, with win_t the last 96 inputs (win_t[95] =
// x[t]) and the desired sample d_t (x[t-128]):
//   y_t = w . win_t,  e_t = d_t - y_t,  w += (mu * e_t / (||win_t||^2 + eps)) * win_t.
// Walked one sample at a time, every step waits for the update of the step
// before it: a 96-tap dot product reduced across a warp, e, the scale and
// the update, all in series. The grouped algebra (the TPU kernel's
// _grouped_macro, radiodsp_sdr_rx_tpu/ops/pallas_lms.py:127) takes a group
// of kGroup samples from t0 and the weights w at its start. With, for k, l
// in the group,
//   q_k = ||win_k||^2,  inv_k = mu / (q_k + eps),  r_{k,l} = win_k . win_l,
//   p_k = w . win_k,
// it runs
//   y_k = p_k + sum_{j<k} c_j r_{j,k},  e_k = d_k - y_k,  c_k = e_k inv_k,
//   w' = w + sum_k c_k win_k,
// which is the recurrence exactly, since (w + sum_{j<k} c_j win_j) . win_k
// = y_k. The c_k solve L c = b, b_k = inv_k (d_k - p_k), with L unit lower
// triangular, L_kj = inv_k r_{j,k}: L depends on the input alone, only b on
// the weights.
//
// A warp issues its instructions in order and, alone on its SM sub-partition,
// waits out every latency of its own; one warp walking the chain c_k ->
// y_{k+1} also reads every r from shared memory. So the walk (walk())
// pipelines three warps of the block, a tile of 32 samples (two groups)
// apart, meeting at a named barrier once a tile:
//   - the lags warp (Lags, warp 1) takes the tile's inputs (zeros past the
//     end) into the ring with their desired samples x[t-128] (from the
//     carried delay line for t < 128, or x[t] itself while `first`), and
//     forms q and r. Lane d < kGroup keeps R = win_e . win_{e+d} in a
//     register and slides it a sample at a time, R += x[e+1] x[e+1+d] -
//     x[e-95] x[e-95+d]: a group's 16 increments first (independent), then
//     one add a sample. At a group that starts on a multiple of kRebase
//     samples of the call R is summed afresh (lanes d and d + 16 a half
//     each), so no rounding drift carries past kRebase samples;
//     ops/lms_bank.py's plain version keeps the same schedule. Lane l then
//     turns q of the tile's sample l into inv (an IEEE division; 0 past the
//     end, so that a short last group's c_k are 0);
//   - the solver warp (solve(), warp 2) inverts each group's L by forward
//     substitution, a column a lane, over the rows of r broadcast from
//     shared memory: A = L^-1, input-only work off the weights' path;
//   - the predictor warp (Predictor, warp 0) holds the weights, lane l those
//     of taps 4l-1 .. 4l+2, whose window values of a group are 5 aligned
//     float4s of the ring (kept for the update). Its 16 partial dot
//     products per lane go through shared memory (lane k sums column k), so
//     lane k holds p_k and forms b_k; b goes to every lane, lane k forms
//     c_k = (A b)_k and y_k = p_k + sum_{j<k} r_{j,k} c_j from its rows of A
//     and r, c goes to every lane, and every lane updates its weights. No
//     step waits on the one before beyond these two broadcasts.
// The tables of r, A, inv and d are kept per tile (three of r, inv and d,
// two of A), so no warp waits for another within a tile. The ring holds
// kRing inputs, stored twice (x[m] at m mod kRing and at that plus kRing)
// so that any span x[t0-160 .. t0+31] is contiguous from one base pointer
// and every read is at a constant offset; the lags warp's writes of tile i
// replace inputs older than any the predictor reads for tile i - 2.

#pragma once

#include <cuda_runtime.h>

namespace {
namespace lms {

constexpr int kTaps = 96;               // ops/lms.LMS_TAPS
constexpr int kDelay = 128;             // ops/lms.LMS_DELAY
constexpr int kLaneTaps = 4;            // the predictor's weights per lane
constexpr int kGroup = 16;              // samples per group (ops/lms_bank.LMS_GROUP)
constexpr int kRebase = 128;            // R summed afresh (ops/lms_bank.LMS_REBASE)
constexpr int kTile = 32;               // samples per tile: two groups
constexpr int kRing = 256;              // ring of inputs, a power of two >= kDelay + 2 kTile
constexpr int kLd = 20;                 // row stride of the tables: float4 rows, no conflicts
constexpr int kMat = kGroup * kLd;      // one group's table
constexpr float kEps = 1.1920929e-7f;   // CMSIS DELTA of arm_lms_norm_f32
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWalkThreads = 96;        // the walk's three warps

static_assert(kLaneTaps * 24 == kTaps && kGroup == 16 && kTile == 2 * kGroup,
              "a lane per sample of a tile, two lanes per sample of a group");
static_assert(kRebase % kTile == 0, "tiles tile the rebase period");
static_assert(kRing >= kDelay + 2 * kTile && (kRing & (kRing - 1)) == 0,
              "the ring holds x[t0-160 .. t0+31]");

struct __align__(16) Scratch {
  float ring[2 * kRing];          // x[m] at m & (kRing - 1) and at that + kRing
  float rc[3][2][kMat];           // [tile mod 3][group]: rc[k * kLd + i] = r_{i,k}, i < k
  float a[2][2][kMat];            // [tile parity][group]: a[k * kLd + j] = (L^-1)_{kj}
  float q[3][kTile];              // [tile mod 3]: q_k, then inv_k, by sample of the tile
  float d[3][kTile];              // [tile mod 3]: the desired samples
  float part[32 * kLd];           // the predictor's partial sums, a row a lane
  float bc[2][kGroup];            // the predictor's b, then c

  __device__ __forceinline__ void put(int m, float v) {
    const int s = m & (kRing - 1);
    ring[s] = v;
    ring[s + kRing] = v;
  }
  __device__ __forceinline__ float at(int m) const { return ring[m & (kRing - 1)]; }
  // x[t0 + o] == base(t0)[o] for -kDelay <= o <= kRing - kDelay
  __device__ __forceinline__ const float* base(int t0) const {
    return ring + ((t0 - kDelay) & (kRing - 1)) + kDelay;
  }
  // one warp: the tables' entries never written (r_{i,k} for i >= k) and
  // the ring to 0 (the predictor's taps past 95 read samples not yet
  // written, at weight 0), then the carried window win[j] = x[j - 96] into
  // the ring; after a walk of n samples, the window out
  __device__ __forceinline__ void load_window(const float* __restrict__ win) {
    for (int j = threadIdx.x & 31; j < 3 * 2 * kMat; j += 32) (&rc[0][0][0])[j] = 0.f;
    for (int j = threadIdx.x & 31; j < 2 * kRing; j += 32) ring[j] = 0.f;
    __syncwarp();
    for (int j = threadIdx.x & 31; j < kTaps; j += 32) put(j - kTaps, win[j]);
  }
  __device__ __forceinline__ void store_window(float* __restrict__ win, int n) const {
    for (int j = threadIdx.x & 31; j < kTaps; j += 32) win[j] = at(n - kTaps + j);
  }
};

constexpr int kScratchFloats = (int)(sizeof(Scratch) / sizeof(float));

// warps 0, 1 and 2 of the block, barrier 1 (barrier 0 is __syncthreads)
__device__ __forceinline__ void walk_sync() { asm volatile("bar.sync 1, 96;" ::: "memory"); }

// N floats from 16-byte aligned shared memory into registers
template <int N>
__device__ __forceinline__ void load4(const float* p, float (&v)[N]) {
#pragma unroll
  for (int a = 0; a < N / 4; ++a) {
    const float4 f = reinterpret_cast<const float4*>(p)[a];
    v[4 * a] = f.x, v[4 * a + 1] = f.y, v[4 * a + 2] = f.z, v[4 * a + 3] = f.w;
  }
}

// The lags warp (warp 1): the lag products and scales of each tile.
struct Lags {
  float r;   // lane d < kGroup: win_e . win_{e+d}, e = t0 - 1 - d after a group

  // the lag products of the group from t0 (t0 counts from the call's first
  // sample): r_{i,k} into rc (row k), q_k into q
  __device__ __forceinline__ void group(const Scratch& s, int t0, float* rc, float* q) {
    const int lane = threadIdx.x & 31;
    const float* xb = s.base(t0);
    const bool rebase = t0 % kRebase == 0;
    if (rebase) {   // R = win_{t0} . win_{t0+d}
      const float* a = xb - (kTaps - 1) + (lane >> 4) * (kTaps / 2);
      const int d = lane & (kGroup - 1);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int i = 0; i < kTaps / 2; i += 4) {
        s0 = fmaf(a[i], a[i + d], s0);
        s1 = fmaf(a[i + 1], a[i + 1 + d], s1);
        s2 = fmaf(a[i + 2], a[i + 2 + d], s2);
        s3 = fmaf(a[i + 3], a[i + 3 + d], s3);
      }
      const float part = (s0 + s1) + (s2 + s3);
      r = part + __shfl_down_sync(kFull, part, 16);
    }
    if (lane < kGroup) {
      const int d = lane;
      const float* xd = xb - 1 - d;   // x[e] after slide j: xd[j]
      float un[kGroup], uo[kGroup];   // x[e + d] and x[e - 96 + d], the same on every lane
      load4(xb, un);
      load4(xb - kTaps, uo);
      // the slides' increments first (independent), then one add a slide
      float rv[kGroup];               // R after slide j; stored after the last slide,
#pragma unroll                        // so that no store orders the loads
      for (int j = 1; j <= kGroup; ++j)
        rv[j - 1] = fmaf(xd[j], un[j - 1], -(xd[j - kTaps] * uo[j - 1]));
#pragma unroll
      for (int j = 1; j <= kGroup; ++j) {
        if (!rebase || j > d + 1) r += rv[j - 1];
        rv[j - 1] = r;
      }
      // after slide j, R = r_{k,k+d} for k = j - 1 - d: row j - 1, column
      // j - 1 - d of rc, that is rd[(kLd + 1) j]
      float* rd = rc - (kLd + 1) - d;
#pragma unroll
      for (int j = 1; j <= kGroup; ++j) {
        if (j > d && d > 0) rd[(kLd + 1) * j] = rv[j - 1];
        if (j > d && d == 0) q[j - 1] = rv[j - 1];
      }
    }
  }

  // The tile of `valid` samples from t0, its inputs in the ring: the tables
  // and scales of buffer b
  __device__ __forceinline__ void tile(Scratch& s, int t0, int valid, int b, float mu) {
    const int lane = threadIdx.x & 31;
    group(s, t0, s.rc[b][0], s.q[b]);
    if (valid > kGroup) group(s, t0 + kGroup, s.rc[b][1], s.q[b] + kGroup);
    __syncwarp();
    s.q[b][lane] = lane < valid ? __fdiv_rn(mu, s.q[b][lane] + kEps) : 0.f;
  }
};

// The solver warp (warp 2): A = L^-1 of each group, L = I + (inv_k r_{i,k})
// below the diagonal, a column a lane: a_jj = 1, a_kj = -inv_k sum_{j<=i<k}
// r_{i,k} a_ij (forward substitution, rows of rc broadcast).
__device__ __forceinline__ void solve(const float* __restrict__ rc, const float* __restrict__ inv,
                                      float* a) {
  const int j = threadIdx.x & 31;
  float col[kGroup];
  float iv[kGroup];
  load4(inv, iv);
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    float row[kGroup];
    load4(rc + k * kLd, row);   // r_{i,k} for i < k, 0 beyond
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < k; ++i) acc = fmaf(row[i], col[i], acc);
    col[k] = k < j ? 0.f : k == j ? 1.f : -iv[k] * acc;
  }
  if (j < kGroup) {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) a[k * kLd + j] = col[k];
  }
}

// The predictor warp (warp 0): the weights, the predictions, c = A b, y,
// the update.
struct Predictor {
  // lane l: the weights of taps 4l - 1 .. 4l + 2 (0 for taps outside
  // 0 .. 95; lanes 25 .. 31 none), so that its window values of a group
  // are 5 aligned float4s of the ring
  float w[kLaneTaps];

  __device__ __forceinline__ void load(const float* __restrict__ w_in) {
#pragma unroll
    for (int t = 0; t < kLaneTaps; ++t) {
      const int i = kLaneTaps * (threadIdx.x & 31) - 1 + t;
      w[t] = i >= 0 && i < kTaps ? w_in[i] : 0.f;
    }
  }
  __device__ __forceinline__ void store(float* __restrict__ w_out) const {
#pragma unroll
    for (int t = 0; t < kLaneTaps; ++t) {
      const int i = kLaneTaps * (threadIdx.x & 31) - 1 + t;
      if (i >= 0 && i < kTaps) w_out[i] = w[t];
    }
  }

  // Group g of the tile from t0: its tables rc and a, its inv and d (by
  // sample of the group). Returns on lanes k and 16 + k the output of sample
  // t0 + 16 g + k: e when `notch`, else y.
  __device__ __forceinline__ float group(Scratch& s, int t0, int g, const float* rc,
                                         const float* a, const float* inv, const float* dv,
                                         int notch) {
    const int lane = threadIdx.x & 31, k = lane & (kGroup - 1);
    // win_m[4 lane - 1 + t] = x[t0 + m - 96 + 4 lane + t] = xw[t + m]
    float xw[kLaneTaps + kGroup];
    load4(s.base(t0 + kGroup * g) - kTaps + kLaneTaps * lane, xw);

    // p_m = w . win_m: 16 partial sums a lane over its 4 taps, reduced through
    // shared memory: lane l's sums to row l; lane (h, k) sums column k of
    // rows 16h .. 16h + 15 (half 1 four rows ahead, 16 banks from half 0),
    // and the two halves add up through one shuffle
    {
      float acc[kGroup];
#pragma unroll
      for (int m = 0; m < kGroup; ++m) {
        acc[m] = w[0] * xw[m];
#pragma unroll
        for (int t = 1; t < kLaneTaps; ++t) acc[m] = fmaf(w[t], xw[t + m], acc[m]);
      }
      float4* mine = reinterpret_cast<float4*>(s.part + kLd * lane);
#pragma unroll
      for (int q = 0; q < kGroup / 4; ++q)
        mine[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    }
    // meanwhile independent of p: this lane's rows of A and of the lags, d, inv
    float arow[kGroup], rrow[kGroup];
    load4(a + k * kLd, arow);
    load4(rc + k * kLd, rrow);
    const float dk = dv[k], ik = inv[k];
    __syncwarp();
    float pk;
    {
      const int h = lane >> 4;
      float q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        q[i % 4] += s.part[kLd * (kGroup * h + ((i + 4 * h) & (kGroup - 1))) + k];
      pk = (q[0] + q[1]) + (q[2] + q[3]);
      pk += __shfl_xor_sync(kFull, pk, 16);
    }
    // b = inv (d - p) to every lane, c = A b (lane k row k), c to every lane
    float bv[kGroup], cv[kGroup];
    if (lane < kGroup) s.bc[0][k] = ik * (dk - pk);
    __syncwarp();
    load4(s.bc[0], bv);
    {
      float u[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kGroup; ++j) u[j % 4] = fmaf(arow[j], bv[j], u[j % 4]);
      if (lane < kGroup) s.bc[1][k] = (u[0] + u[1]) + (u[2] + u[3]);
    }
    __syncwarp();
    load4(s.bc[1], cv);
    // y_k = p_k + sum_{i<k} r_{i,k} c_i
    float yk;
    {
      float u[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kGroup; ++i) u[i % 4] = fmaf(rrow[i], cv[i], u[i % 4]);
      yk = pk + ((u[0] + u[1]) + (u[2] + u[3]));
    }
    // w += sum_m c_m win_m, four partial sums a weight
#pragma unroll
    for (int t = 0; t < kLaneTaps; ++t) {
      float u[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) u[q] = cv[q] * xw[t + q];
#pragma unroll
      for (int m = 4; m < kGroup; ++m) u[m % 4] = fmaf(cv[m], xw[t + m], u[m % 4]);
      const int i = kLaneTaps * lane - 1 + t;   // taps outside 0 .. 95 stay 0
      if (i >= 0 && i < kTaps) w[t] += (u[0] + u[1]) + (u[2] + u[3]);
    }
    return notch ? dk - yk : yk;
  }
};

// Warps 0 (the predictor), 1 (the lags) and 2 (the solver) of the block,
// together: the `count` samples from call position pos0, a tile of 32 at
// a time, each warp a tile behind the one before (lags, solver, predictor).
// The lags warp takes tile it's inputs from io.fetch(it) (every lane its
// sample it * 32 + lane, 0 past the end), the predictor hands the outputs
// (e when `notch`, else y) to io.put(it, v); delay is the carried delay
// line (the desired samples of positions 0..127 unless `first`). Ends at
// the walk's barrier. No warp's state (the weights, R) leaves its
// registers.
template <class Io>
__device__ __forceinline__ void walk(Predictor& pr, Lags& lg, Scratch& s, int pos0, int count,
                                     Io& io, const float* __restrict__ delay, bool first,
                                     float mu, int notch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (count + kTile - 1) / kTile;
  for (int it = 0; it <= tiles + 1; ++it) {
    if (warp == 1 && it < tiles) {
      const int i0 = it * kTile, i = i0 + lane, m = pos0 + i;
      const float xv = io.fetch(it);
      const int b = it % 3;
      s.d[b][lane] = i >= count ? 0.f : m >= kDelay ? s.at(m - kDelay) : first ? xv : delay[m];
      s.put(m, xv);
      __syncwarp();
      lg.tile(s, pos0 + i0, min(kTile, count - i0), b, mu);
    } else if (warp == 2 && it >= 1 && it <= tiles) {
      const int t = it - 1, b = t % 3;
      solve(s.rc[b][0], s.q[b], s.a[t & 1][0]);
      if (count - t * kTile > kGroup) solve(s.rc[b][1], s.q[b] + kGroup, s.a[t & 1][1]);
    } else if (warp == 0 && it >= 2) {
      const int t = it - 2, b = t % 3, i0 = t * kTile;
      float o = pr.group(s, pos0 + i0, 0, s.rc[b][0], s.a[t & 1][0], s.q[b], s.d[b], notch);
      if (count - i0 > kGroup) {
        const float o2 = pr.group(s, pos0 + i0, 1, s.rc[b][1], s.a[t & 1][1], s.q[b] + kGroup,
                                  s.d[b] + kGroup, notch);
        if (lane >= kGroup) o = o2;
      }
      io.put(t, o);
    }
    walk_sync();
  }
}

}  // namespace lms
}  // namespace
