// sweep_chain.cuh: the whole receive chain of one channel per thread block,
// one template over demod x noise blanker x NR stage x R output.
//
// Replaces _chain_kernel (radiodsp_sdr_rx_tpu/ops/pallas_sweep.py:261),
// _spec_chain_kernel (ops/pallas_sweep_spec.py:46) and _lanes_chain_kernel
// (ops/pallas_chain_lanes.py:98). The instantiations live in four sources,
// built in parallel:
//   sweep_chain.cu   K1: ssb, ssb + blanker, am, am + blanker, ssb without R
//                    (emit_r=False); K6: sam, sam + blanker (nr="none")
//   sweep_denoise.cu K6 nr="denoise": {ssb, am, sam} x blanker {off, on}
//   sweep_notch.cu   K6 nr="notch":   {ssb, am, sam} x blanker {off, on}
//   sweep_spec.cu    K4 (ssb, spectral, no blanker) and K6 nr="spectral":
//                    ssb + blanker, {am, sam} x blanker {off, on}
// Per sample: input gain / IQ balance, [nb: the noise blanker,] DDS NCO mix,
// then
//   ssb: overlap-save band-pass + SSB demod as frames(rows,512) @ w_ssb(512,128);
//   am:  the complex band-pass frames(rows,512) @ w_sb(512,256) -> (zr | zi),
//        envelope sqrt(zr^2 + zi^2), DC blocker
//        y[n] = env[n] - env[n-1] + pole*y[n-1] (pole 0.995);
//   sam: the complex band-pass, then the PLL's in-phase product vr in place
//        of the envelope (carry: the (2, C) [phase | freq] rows, re-seeded
//        on the schedule the caller passes), then the same DC blocker;
// [notch: the LMS error e (lms_step.cuh) replaces the audio,] then AGC
// env[k] = max(|a[k]|, env[k-1]*release), gain = min(target/max(env,1e-12),
// max_gain) (not applied with AGC off), PBT frames(rows,256) @ w_pbt(256,256)
// -> [L|R], then by NR stage:
//   none:     [L|R] times the output gain;
//   denoise:  the LMS prediction y of L, times 1.1, times the output gain;
//             R is neither computed nor stored (the bank copies L);
//   spectral: per 128-sample row, [prev_l | l | prev_r | r] @ W_fwd(512,512)
//             -> [sr | si] over 256 bins, mag = sqrt(sr^2 + si^2),
//             floor_est = (sum of mag over bins 30..180) * nr_gain,
//             nf[j] = 0.35*nf[j-1] + 0.65*floor_est[j] across rows, chunks
//             and segments, scale = 0.2 where mag <= max(nf, 0), else
//             1 - nf/max(mag, 1e-20), [sr*scale | si*scale] @ W_inv(512,256)
//             -> the right halves [yl | yr], times the output gain.
//
// The noise blanker works on the scaled input before the mix: mag = |x|,
// avg[t] = a*avg[t-1] + (1-a)*mag[t] on the unblanked magnitude, and a sample
// is zeroed unless mag <= avg*thresh + 1e-12. The carried framing tail is
// re-mixed and multiplied by the previous segment's last keep mask; the
// average at the last sample and the last row's keep mask carry out. The
// DC blocker carries [last envelope, last output] (C, 2); the LMS its
// weights (C, 96), window (C, 96) and delay line (C, 128); the spectral
// stage its floor (unclamped: the clamp shows only in nf) and the last
// post-PBT rows of l and r (before the output gain).
//
// What bounds it on an H100: per IQ sample it reads 8 B and writes 8 B
// (4 B with one output), and does 2,048 flops for ssb (1,024 for each of the
// two products per 128 samples) or 3,072 for am and sam (2,048 for the
// twice-as-wide band-pass); without R 1,536 (the compiler drops the R half
// of the PBT product, whose sums are never stored); spectral adds 6,144
// (W_fwd 4,096, W_inv 2,048). One 128-channel x 2^19-sample ssb segment is
// 1.07 GB (0.32 ms at 3.35 TB/s) and 137 GFLOP (2.0 ms at the 67 TFLOP/s
// fp32 rate outside the tensor cores): in fp32 SIMT it is bound by
// arithmetic. The blanker adds about 10 flops and a square root per sample,
// the AM envelope and DC blocker about 6 and a square root, the LMS 576.
// The SAM PLL and the LMS are not bound by a rate: each is a chain of
// dependent per-sample steps, n of them per segment whatever the channel
// count. The PLL walks them one sample at a time (sam_pll.cuh); the LMS runs
// the grouped exact algebra of lms_step.cuh on warps 0-2: the lag products
// and each group's triangular inverse off the weights' path, the weights
// waiting only for the predictions and two broadcasts a group. A SAM route
// costs the larger of the PLL's walk and the rest of its chain (the LMS's
// walk included), as long as the two overlap (sam_chain_kernel below).
//
// What the design does about it: every intermediate stays on chip, so device
// memory sees only the 16 B/sample; the time goes to the products, run as
// register-blocked fp32 FMA (8 rows x 4 or 8 columns per thread, the frame
// operand broadcast from shared memory, chain_common.cuh). One block of 256
// threads owns one channel (128 blocks for 132 SMs; a 64-channel bank keeps
// only 64 SMs busy) and walks time in chunks of 64 rows of 128 samples,
// which is what the TPU grid did with its sequential axis. Every carry stays
// in shared memory or registers from chunk to chunk. In the AM band-pass each
// thread's 8 columns are j and j+128 for four j, so the same thread holds zr
// and zi of a sample and writes its envelope straight into the audio rows.
// SAM runs in sam_chain_kernel, every NR stage included: lane 0 of a ninth
// warp walks the PLL over chunk k+1 while the chain's eight warps run chunk
// k's DC blocker, [notch,] AGC, PBT product [and denoise or the spectral
// stage], then chunk k+2's mix and band-pass (chain_common.cuh's
// walk_ahead); the block meets at one barrier a chunk and the chain at a
// named barrier of its own. The block is ChainSync's, 288 threads, the walk
// on warp 8; on the spectral routes SoloSync's, 384 threads, the walk alone
// on its scheduler, since their chain's products (four a chunk) took the
// walker's issue slots and slowed the walk, which paces them (about 198
// cycles a step against 153 alone on the H100). A chunk's rows live in one of two
// slots of [I rows | Q rows]: the mix writes them, the band-pass writes zr
// over the I rows and zi over the Q rows (the mixed rows' last row saved
// first as the next chunk's row 0), the PLL writes vr over zr, and the DC
// blocker, AGC and PBT read it there, the audio rows' last row saved in a
// carry row; denoise writes L over the dead zi, the spectral stage l over vr
// and r over zi. Shared memory (bytes of the 232,448 one block may have):
// sam 177,712, + blanker 178,224, + denoise or notch 196,156, + both
// 196,668, + spectral 228,656, + spectral and blanker 229,168. The spectral
// routes fit because pass A's spectrum lies over the upper half of the
// operator tiles Bs and 49,408 B after them: pass A streams its operator in
// K tiles of 16 rows before the spectrum exists, pass B and W_inv in tiles
// of 8 rows through the lower half (spectral_rows' kTK), each sum in the same
// order. The LMS stages run on warps 0-2
// (lms_step.cuh's walk), in place, 32 samples (two groups) a tile: notch
// over the audio rows, denoise over L, which the PBT product writes into
// the dead mixed I rows. The lags warp takes each tile's inputs into the
// LMS's ring of the last 256 (in its scratch, 18 KB of shared memory) with
// their desired samples x[t-128] before the predictor, two tiles behind,
// overwrites them with the outputs, so the in-place walk needs no pristine
// copy of its input. The spectral stage is K4's (spectral_rows): the mixed
// rows' last row waits in its own buffer, PBT writes l and r into the mixed
// rows, W_fwd runs as two passes of 256 columns (its columns permuted by the
// wrapper so that a pass holds sr and si of 128 bins and one thread holds sr
// and si of the same bin): pass A's spectrum goes to a 64 x 257 buffer, pass
// B's stays in registers until l and r are dead (their last rows saved as
// the carries) and then overwrites them. The floor's order: each warp sums
// its rows' VAD bins (shuffles), one thread runs the 64-row one-pole scan
// from the carry, and only then is any bin scaled. W_inv reads the two
// spectrum halves in their natural row order (ALayout::kSpectrum). Shared
// memory of the SSB and AM spectral routes: 211,500 B with the blanker. The
// AGC, the blanker's average and the DC blocker are scans over
// the chunk, run as 256 segments of 32 samples: each thread scans its
// segment from zero, warp 0 scans the segment ends (a decaying max for the
// AGC, a decaying sum for the other two) and each thread re-runs its segment
// from the true carry, so every sample follows the sequential recurrence.
// Segments past the end of a partial last chunk come after every valid one
// and never reach a carry. Hiding the LMS's walk behind the products on the
// routes without SAM, and a TF32/3xTF32 tensor-core design of the products
// are later work.

#pragma once

#include <type_traits>

#include "chain_args.cuh"
#include "chain_common.cuh"
#include "lms_step.cuh"
#include "sam_pll.cuh"

namespace {

enum class Demod { kSSB, kAM, kSAM };
enum class Nr { kNone, kDenoise, kNotch, kSpectral };

constexpr double kDcPole = 0.995;        // the AM DC blocker's pole (ops/iir.DC_POLE)
constexpr float kDenoiseMakeup = 1.1f;   // RDSP_convolutional.h:334

constexpr int kSpecFloats = kRows * kLdSpec;  // one spectrum half: 64 rows x (128 sr | 128 si)
constexpr int kVadStart = 30, kVadEnd = 180;  // the VAD band, bins inclusive
constexpr float kFloorBeta = 0.65f;
constexpr float kFloorA = (float)(1.0 - 0.65);
constexpr float kUnderFloorGain = 0.2f;

static_assert(kSpecFloats <= 2 * kRowBuf, "pass B's spectrum fits the two mixed-row buffers");

__host__ __device__ constexpr bool is_lms(Nr nr) { return nr == Nr::kDenoise || nr == Nr::kNotch; }

// As, Bs, three row buffers, scan segment ends, 8 carries; the blanker adds
// the keep mask of the last row, the LMS its scratch (16-byte aligned: up to
// 3 floats of padding before it), the spectral stage pass A's spectrum, the
// per-row floor sums and floors, the mixed carry row and the l/r carry rows
template <bool kNB, Nr kNR>
constexpr int smem_floats() {
  return kAsFloats + kBsFloats + 3 * kRowBuf + kThreads + 8 + (kNB ? kBlk : 0) +
         (is_lms(kNR) ? lms::kScratchFloats + 3 : 0) +
         (kNR == Nr::kSpectral ? kSpecFloats + 2 * kRows + 4 * kBlk : 0);
}

__device__ __forceinline__ float magnitude(float sr, float si) {
  return sqrtf(__fadd_rn(__fmul_rn(sr, sr), __fmul_rn(si, si)));
}

__device__ __forceinline__ float subtract_scale(float mag, float nf) {
  return mag <= nf ? kUnderFloorGain : 1.f - nf / fmaxf(mag, 1e-20f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// lms_step.cuh's walk over the chunk's rows 1..rows of buf, in place: each
// sample's output overwrites its input once the lags warp has taken the
// input into its ring.
struct RowIo {
  float* buf;
  int count;
  __device__ __forceinline__ float* at(int i) const { return buf + (i / kBlk + 1) * kLd + i % kBlk; }
  __device__ __forceinline__ float fetch(int it) const {
    const int i = it * lms::kTile + (threadIdx.x & 31);
    return i < count ? *at(i) : 0.f;
  }
  __device__ __forceinline__ void put(int it, float v) const {
    const int i = it * lms::kTile + (threadIdx.x & 31);
    if (i < count) *at(i) = v;
  }
};

// Warps 0 and 1: the LMS over rows 1..rows of buf, the chunk's samples from
// segment position pos0, in time order and in place.
__device__ __forceinline__ void lms_walk(lms::Predictor& pr, lms::Lags& lg, lms::Scratch& ls,
                                         float* buf, int rows, int pos0,
                                         const float* __restrict__ delay, bool first, float mu,
                                         int notch) {
  RowIo io{buf, rows * kBlk};
  lms::walk(pr, lg, ls, pos0, rows * kBlk, io, delay, first, mu, notch);
}

// The chunk phases 1, 2b and 3 of both kernels, each on a barrier policy
// (chain_common.cuh), which also gives each thread its index in the chain:
// the whole block's in sweep_chain_kernel (BlockSync), the chain's named
// barrier in sam_chain_kernel (ChainSync, or SoloSync on the spectral
// routes).
//
// The per-block constants of the chunk phases: the DDS phase and increment,
// the AGC's release, the blanker's one-pole factor, the DC blocker's pole,
// each with its segment and lane decay factors (seg_factors).
struct ChunkConsts {
  uint32_t ph0, dph;
  float rel, rel_seg, rel_lanes[5];
  float nb_af, nb_om, nb_seg, nb_lanes[5];
  float dc_pf, dc_seg, dc_lanes[5];
};

template <bool kNB, bool kDsb>
__device__ __forceinline__ ChunkConsts chunk_consts(const ChainArgs& a, int c) {
  ChunkConsts cc;
  cc.ph0 = (uint32_t)a.phase0[c];
  cc.dph = (uint32_t)a.inc[c];
  cc.rel = (float)a.release;
  cc.rel_seg = seg_factors(a.release, cc.rel_lanes);
  cc.nb_af = cc.nb_om = cc.nb_seg = 0.f;
  if constexpr (kNB) {
    cc.nb_af = (float)a.nb_a;
    cc.nb_om = (float)(1.0 - a.nb_a);
    cc.nb_seg = seg_factors(a.nb_a, cc.nb_lanes);
  }
  cc.dc_pf = cc.dc_seg = 0.f;
  if constexpr (kDsb) {
    cc.dc_pf = (float)kDcPole;
    cc.dc_seg = seg_factors(kDcPole, cc.dc_lanes);
  }
  return cc;
}

// 1. scale [+ blank] + mix rows row0.. of the segment into rows 1..kRows of
// Mr and Mi (zeros past the end); with the blanker, the keep mask of the
// segment's last row so far into keep_row and the average's carry in
// env_c[1]. Ends with Sync::sync().
template <bool kNB, class Sync>
__device__ __forceinline__ void mix_rows(const ChainArgs& a, const ChunkConsts& cc, float* Mr,
                                         float* Mi, float* keep_row, float* seg, float* env_c,
                                         size_t base, int row0, int rows) {
  const int tid = Sync::tid(), warp = tid >> 5;
  const uint32_t ph0 = cc.ph0, dph = cc.dph;
  const float nb_af = cc.nb_af, nb_om = cc.nb_om, nb_seg = cc.nb_seg;
  if constexpr (kNB) {
    // 1a. load and scale
#pragma unroll 4
    for (int e = tid; e < kRows * kBlk; e += kThreads) {
      const int r = e / kBlk, j = e % kBlk;
      float vr = 0.f, vi = 0.f;
      if (r < rows) {
        const int pos = (row0 + r) * kBlk + j;
        vr = a.xr[base + pos] * a.g_i;
        vi = a.xi[base + pos] * a.g_q;
      }
      Mr[(r + 1) * kLd + j] = vr;
      Mi[(r + 1) * kLd + j] = vi;
    }
    Sync::sync();

    // 1b. blank: segment s = 4*row + quarter of the average's scan
    {
      const int r = tid % kRows, quarter = tid / kRows;
      const int s = r * kSegsPerRow + quarter;
      float* pr = Mr + (r + 1) * kLd + quarter * kSegLen;
      float* pi = Mi + (r + 1) * kLd + quarter * kSegLen;
      float y = 0.f;
      for (int k = 0; k < kSegLen; ++k)
        y = nb_af * y + nb_om * sqrtf(pr[k] * pr[k] + pi[k] * pi[k]);
      seg[s] = y;
      Sync::sync();
      if (warp == 0) scan_segment_carries<true>(seg, env_c[1], nb_seg, cc.nb_lanes);
      Sync::sync();
      y = seg[s];
      for (int k = 0; k < kSegLen; ++k) {
        const float m = sqrtf(pr[k] * pr[k] + pi[k] * pi[k]);
        y = nb_af * y + nb_om * m;
        const bool keep = m <= y * a.nb_thresh + 1e-12f;
        if (!keep) {
          pr[k] = 0.f;
          pi[k] = 0.f;
        }
        if (r + 1 == rows) keep_row[quarter * kSegLen + k] = keep ? 1.f : 0.f;
      }
      if (s == rows * kSegsPerRow - 1) env_c[1] = y;
    }
    Sync::sync();

    // 1c. mix in place
#pragma unroll 4
    for (int e = tid; e < rows * kBlk; e += kThreads) {
      const int r = e / kBlk, j = e % kBlk;
      float* pr = Mr + (r + 1) * kLd + j;
      float* pi = Mi + (r + 1) * kLd + j;
      mix(*pr, *pi, ph0 + (uint32_t)((row0 + r) * kBlk + j) * dph, 1.f, 1.f, *pr, *pi);
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < kRows * kBlk; e += kThreads) {
      const int r = e / kBlk, j = e % kBlk;
      float vr = 0.f, vi = 0.f;
      if (r < rows) {
        const int pos = (row0 + r) * kBlk + j;
        mix(a.xr[base + pos], a.xi[base + pos], ph0 + (uint32_t)pos * dph, a.g_i, a.g_q, vr,
            vi);
      }
      Mr[(r + 1) * kLd + j] = vr;
      Mi[(r + 1) * kLd + j] = vi;
    }
  }
  Sync::sync();
}

// 2b. am, sam: the DC blocker in place over rows 1..rows of Ab,
// y = (x - x_prev) + pole*y, the blanker's segmented decaying-sum scan. Each
// thread reads the input just before its segment before any thread
// overwrites one. The carries in env_c[2] (last input) and env_c[3] (last
// output). Ends with Sync::sync().
template <class Sync>
__device__ __forceinline__ void dc_rows(const ChunkConsts& cc, float* Ab, int rows, float* seg,
                                        float* env_c) {
  const int tid = Sync::tid(), warp = tid >> 5;
  const float dc_pf = cc.dc_pf, dc_seg = cc.dc_seg;
  const int r = tid % kRows, quarter = tid / kRows;
  const int s = r * kSegsPerRow + quarter;
  float* p = Ab + (r + 1) * kLd + quarter * kSegLen;
  const float prev = quarter ? p[-1] : (r ? Ab[r * kLd + kBlk - 1] : env_c[2]);
  float y = 0.f, q = prev;
  for (int k = 0; k < kSegLen; ++k) {
    const float v = p[k];
    y = (v - q) + dc_pf * y;
    q = v;
  }
  seg[s] = y;
  Sync::sync();
  if (warp == 0) scan_segment_carries<true>(seg, env_c[3], dc_seg, cc.dc_lanes);
  Sync::sync();
  y = seg[s];
  q = prev;
  for (int k = 0; k < kSegLen; ++k) {
    const float v = p[k];
    y = (v - q) + dc_pf * y;
    q = v;
    p[k] = y;
  }
  if (s == rows * kSegsPerRow - 1) {
    env_c[2] = q;
    env_c[3] = y;
  }
  Sync::sync();
}

// 3. AGC over rows 1..rows of Ab, in place. Segment s = 4*row + quarter;
// segments past the end come after every valid one, so they never reach a
// valid carry. The envelope's carry in env_c[0]. Ends with Sync::sync().
template <class Sync>
__device__ __forceinline__ void agc_rows(const ChainArgs& a, const ChunkConsts& cc, float* Ab,
                                         int rows, float* seg, float* env_c) {
  const int tid = Sync::tid(), warp = tid >> 5;
  const float rel = cc.rel, rel_seg = cc.rel_seg;
  const int r = tid % kRows, quarter = tid / kRows;
  const int s = r * kSegsPerRow + quarter;
  float* p = Ab + (r + 1) * kLd + quarter * kSegLen;
  float e = 0.f;
  for (int k = 0; k < kSegLen; ++k) e = fmaxf(fabsf(p[k]), e * rel);
  seg[s] = e;
  Sync::sync();
  if (warp == 0) scan_segment_carries<false>(seg, env_c[0], rel_seg, cc.rel_lanes);
  Sync::sync();
  e = seg[s];
  for (int k = 0; k < kSegLen; ++k) {
    const float v = p[k];
    e = fmaxf(fabsf(v), e * rel);
    if (a.agc_enabled) p[k] = v * fminf(a.target / fmaxf(e, 1e-12f), a.max_gain);
  }
  if (s == rows * kSegsPerRow - 1) env_c[0] = e;
  Sync::sync();
}

// 4s-9s. The spectral stage after PBT, on a barrier policy: l and r (lr,
// the PBT product) into rows 1..kRows of X and Y, whose row 0 takes the l/r
// carry rows st; W_fwd pass A into Sa with each row's VAD sum, pass B in
// registers until l and r are dead (st takes their last rows), then over X
// and Y (Sb = X, 64 rows of kLdSpec); the floor across the chunk's rows from
// its carry env_c[4] before any bin is scaled; W_inv; the output rows. Pass B
// and W_inv stream the operator in K tiles of kTK rows, so that with kTK =
// kKT / 2 Sa may lie over the upper half of Bs (sam_chain_kernel). Ends with
// Sync::sync() (W_inv's).
template <class Sync, int kTK>
__device__ __forceinline__ void spectral_rows(const ChainArgs& a, const float (&lr)[8][8],
                                              float* X, float* Y, float* Sa, float* fsum,
                                              float* nfr, float* st, float* env_c, float* As,
                                              float* Bs, size_t base, int row0, int rows) {
  const int tid = Sync::tid(), warp = tid >> 5, lane = tid & 31;
  float* Sb = X;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      X[(warp * 8 + i + 1) * kLd + lane * 4 + j] = lr[i][j];
      Y[(warp * 8 + i + 1) * kLd + lane * 4 + j] = lr[i][4 + j];
    }
  if (tid < kBlk) {
    X[tid] = st[tid];
    Y[tid] = st[kBlk + tid];
  }
  Sync::sync();

  // 5s. W_fwd pass A: bins 0..127 -> Sa, and each row's VAD sum over them
  {
    float acc[8][8];
    chunk_gemm<256, ALayout::kFrames, kRows, Sync>(X, Y, a.w_fwd, 512, As, Bs, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int bin = lane * 4 + j;
        float* p = Sa + (warp * 8 + i) * kLdSpec + bin;
        p[0] = acc[i][j];
        p[kBlk] = acc[i][4 + j];
        if (bin >= kVadStart) part += magnitude(acc[i][j], acc[i][4 + j]);
      }
      part = warp_sum(part);
      if (lane == 0) fsum[warp * 8 + i] = part;
    }
  }

  // 6s. W_fwd pass B: bins 128..255 stay in registers until l and r are
  // dead; their last rows are the next chunk's l/r carries
  float acc_b[8][8];
  chunk_gemm<256, ALayout::kFrames, kRows, Sync, kTK>(X, Y, a.w_fwd + 512 * 256, 512, As, Bs,
                                                      acc_b);
  if (tid < kBlk) {
    st[tid] = X[rows * kLd + tid];
    st[kBlk + tid] = Y[rows * kLd + tid];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (kBlk + lane * 4 + j <= kVadEnd) part += magnitude(acc_b[i][j], acc_b[i][4 + j]);
    part = warp_sum(part);
    if (lane == 0) fsum[warp * 8 + i] += part;
  }
  Sync::sync();

  // 7s. the floor across the chunk's rows, from the carry, before any scale
  if (tid == 0) {
    float nf = env_c[4];
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) nf = kFloorBeta * (fsum[r] * a.nr_gain) + kFloorA * nf;
      nfr[r] = r < rows ? fmaxf(nf, 0.f) : 0.f;
    }
    env_c[4] = nf;
  }
  Sync::sync();

  // 8s. scale every bin: pass B from registers into Sb (over the dead l
  // and r), pass A in place in Sa
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = warp * 8 + i;
    const float nf = nfr[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int bin = lane * 4 + j;
      float g = subtract_scale(magnitude(acc_b[i][j], acc_b[i][4 + j]), nf);
      Sb[r * kLdSpec + bin] = acc_b[i][j] * g;
      Sb[r * kLdSpec + kBlk + bin] = acc_b[i][4 + j] * g;
      float* p = Sa + r * kLdSpec + bin;
      const float sr = p[0], si = p[kBlk];
      g = subtract_scale(magnitude(sr, si), nf);
      p[0] = sr * g;
      p[kBlk] = si * g;
    }
  }
  Sync::sync();

  // 9s. W_inv -> [yl | yr] right halves, output gain, straight to device memory
  float acc[8][8];
  chunk_gemm<256, ALayout::kSpectrum, kRows, Sync, kTK>(Sa, Sb, a.w_inv, 512, As, Bs, acc);
  store_rows<256, 2, Sync>(acc, a.out_l, a.out_r, base, row0, rows, a.out_gain);
}

template <Demod kDemod, bool kNB, Nr kNR, bool kEmitR>
__global__ void __launch_bounds__(kThreads, 1) sweep_chain_kernel(const ChainArgs a) {
  static_assert(kDemod != Demod::kSAM, "SAM runs sam_chain_kernel");
  constexpr bool kDsb = kDemod == Demod::kAM;  // the complex band-pass and DC blocker
  constexpr bool kLMS = is_lms(kNR);
  constexpr bool kSpec = kNR == Nr::kSpectral;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = As + kAsFloats;
  float* Mr = Bs + kBsFloats;  // mixed I rows
  float* Mi = Mr + kRowBuf;    // mixed Q rows
  float* Ab = Mi + kRowBuf;    // demodulated audio rows, AGC applied in place
  float* seg = Ab + kRowBuf;   // scan segment ends, then carries into segments
  float* env_c = seg + kThreads;  // [0] AGC envelope, [1] blanker average,
                                  // [2] [3] DC blocker: last envelope, last output,
                                  // [4] spectral floor
  float* keep_row = env_c + 8;                    // nb: keep mask of the last row so far
  float* tail = keep_row + (kNB ? kBlk : 0);
  // LMS: the scratch of lms_step.cuh (its ring of inputs), 16-byte aligned
  lms::Scratch& ls = *reinterpret_cast<lms::Scratch*>(
      smem + ((tail - smem + 3) & ~3));
  float* Sa = tail;                               // spectral: pass A's spectrum
  float* fsum = Sa + kSpecFloats;                 // per row: the VAD band's magnitude sum
  float* nfr = fsum + kRows;                      // per row: the floor, clamped at 0
  float* mt = nfr + kRows;                        // the mixed carry row [re | im]
  float* st = mt + 2 * kBlk;                      // the l/r carry rows [l | r]
  float* carry_r = kSpec ? mt : Mr;               // where the mixed rows' last row waits
  float* carry_i = kSpec ? mt + kBlk : Mi;

  const int c = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = a.n;
  const size_t base = (size_t)c * n;
  const ChunkConsts cc = chunk_consts<kNB, kDsb>(a, c);

  // the carried raw tail, re-scaled and re-mixed at positions -128..-1
  if (tid < kBlk) {
    const size_t t = (size_t)c * kBlk + tid;
    mix(a.tail_r[t], a.tail_i[t], cc.ph0 + (uint32_t)(tid - kBlk) * cc.dph, a.g_i, a.g_q,
        Mr[tid], Mi[tid]);
    if constexpr (kNB) {
      Mr[tid] *= a.nb_mask0[t];
      Mi[tid] *= a.nb_mask0[t];
    }
    Ab[tid] = a.atail_in[t];
    if constexpr (kSpec) {
      st[tid] = a.stl0[t];
      st[kBlk + tid] = a.str0[t];
    }
  }
  // LMS: warps 0 and 1 run the channel's LMS, the weights and the lag
  // products in their registers across chunks
  lms::Predictor pr;
  lms::Lags lg;
  bool lms_first = false;
  if (kLMS && warp == 0) pr.load(a.lms_w0 + c * lms::kTaps);
  if (kLMS && warp == 1) {
    ls.load_window(a.lms_win0 + c * lms::kTaps);
    lms_first = *a.lms_first != 0;
  }
  if (tid == 0) {
    env_c[0] = a.env0[c];
    if constexpr (kNB) env_c[1] = a.nb_avg0[c];
    if constexpr (kDsb) {
      env_c[2] = a.dc0[2 * c];
      env_c[3] = a.dc0[2 * c + 1];
    }
    if constexpr (kSpec) env_c[4] = a.nfl0[c];
  }

  const int nrows = n / kBlk;
  for (int row0 = 0; row0 < nrows; row0 += kRows) {
    const int rows = min(kRows, nrows - row0);

    // 1. scale [+ blank] + mix into rows 1..kRows (zeros past the end)
    mix_rows<kNB, BlockSync>(a, cc, Mr, Mi, keep_row, seg, env_c, base, row0, rows);

    // 2. band-pass + SSB demod (ssb), or band-pass + envelope (am): Ab rows
    // 1..kRows. In the am product acc[i][j] and acc[i][4+j] are columns
    // 4*lane+j and 128+4*lane+j: zr and zi of one sample.
    {
      if constexpr (kDsb) {
        float acc[8][8];
        chunk_gemm<256>(Mr, Mi, a.w_band, 512, As, Bs, acc);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            Ab[(warp * 8 + i + 1) * kLd + lane * 4 + j] =
                sqrtf(acc[i][j] * acc[i][j] + acc[i][4 + j] * acc[i][4 + j]);
      } else {
        float acc[8][4];
        chunk_gemm<128>(Mr, Mi, a.w_band, 512, As, Bs, acc);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) Ab[(warp * 8 + i + 1) * kLd + lane * 4 + j] = acc[i][j];
      }
      // the product has read every mixed row (chunk_gemm ends at a barrier):
      // their last row becomes the next chunk's row 0 now
      if (tid < kBlk) {
        carry_r[tid] = Mr[rows * kLd + tid];
        carry_i[tid] = Mi[rows * kLd + tid];
      }
    }
    __syncthreads();

    // 2b. am: the DC blocker in place
    if constexpr (kDsb) dc_rows<BlockSync>(cc, Ab, rows, seg, env_c);

    // 2c. notch: the LMS error replaces the audio, warps 0 and 1 walking the chunk
    if constexpr (kNR == Nr::kNotch) {
      if (warp < 3)
        lms_walk(pr, lg, ls, Ab, rows, row0 * kBlk, a.lms_delay0 + c * lms::kDelay, lms_first,
                 a.mu, 1);
      __syncthreads();
    }

    // 3. AGC in place
    agc_rows<BlockSync>(a, cc, Ab, rows, seg, env_c);

    // 4. PBT -> [L|R]; the audio rows' last row becomes the next chunk's
    // row 0 (the product has read them all); then the NR stage after PBT
    float lr[8][8];
    chunk_gemm<256>(Ab, Ab, a.w_pbt, 256, As, Bs, lr);
    if (tid < kBlk) Ab[tid] = Ab[rows * kLd + tid];
    if constexpr (kNR == Nr::kNone || kNR == Nr::kNotch) {
      // [L|R] (L alone without kEmitR), output gain, straight to device memory
      store_rows<256, kEmitR ? 2 : 1>(lr, a.out_l, a.out_r, base, row0, rows, a.out_gain);
    } else if constexpr (kNR == Nr::kDenoise) {
      // L into the dead mixed I rows; warps 0 and 1 replace it by the LMS
      // prediction; then y * 1.1 * output gain, straight to device memory
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Mr[(warp * 8 + i + 1) * kLd + lane * 4 + j] = lr[i][j];
      __syncthreads();
      if (warp < 3)
        lms_walk(pr, lg, ls, Mr, rows, row0 * kBlk, a.lms_delay0 + c * lms::kDelay, lms_first,
                 a.mu, 0);
      __syncthreads();
#pragma unroll 4
      for (int e = tid; e < rows * kBlk; e += kThreads) {
        const int r = e / kBlk, j = e % kBlk;
        a.out_l[base + (size_t)(row0 + r) * kBlk + j] =
            Mr[(r + 1) * kLd + j] * kDenoiseMakeup * a.out_gain;
      }
      __syncthreads();   // the next chunk's mix overwrites the rows just read
    } else {
      // 4s-9s. spectral: l into Mr, r into Mi, pass B's spectrum over them
      spectral_rows<BlockSync, kKT>(a, lr, Mr, Mi, Sa, fsum, nfr, st, env_c, As, Bs, base,
                                    row0, rows);
      // the mixed carry back into row 0, over pass B's spectrum (W_inv has
      // read it: chunk_gemm ends at a barrier)
      if (tid < kBlk) {
        Mr[tid] = mt[tid];
        Mi[tid] = mt[kBlk + tid];
      }
    }
  }
  if (tid < kBlk) a.atail_out[(size_t)c * kBlk + tid] = Ab[tid];
  if (tid == 0) a.env_out[c] = env_c[0];
  if constexpr (kNB) {
    if (tid < kBlk) a.nb_mask_out[(size_t)c * kBlk + tid] = keep_row[tid];
    if (tid == 0) a.nb_avg_out[c] = env_c[1];
  }
  if constexpr (kDsb) {
    if (tid == 0) {
      a.dc_out[2 * c] = env_c[2];
      a.dc_out[2 * c + 1] = env_c[3];
    }
  }
  if constexpr (kLMS) {
    // the weights, the window and the delay line: the segment's last 128 inputs
    if (warp == 0) pr.store(a.lms_w_out + c * lms::kTaps);
    if (warp == 1) {
      ls.store_window(a.lms_win_out + c * lms::kTaps, n);
#pragma unroll
      for (int k = lane; k < lms::kDelay; k += 32)
        a.lms_delay_out[c * lms::kDelay + k] = ls.at(n - lms::kDelay + k);
    }
  }
  if constexpr (kSpec) {
    if (tid < kBlk) {
      const size_t t = (size_t)c * kBlk + tid;
      a.stl_out[t] = st[tid];
      a.str_out[t] = st[kBlk + tid];
    }
    if (tid == 0) a.nfl_out[c] = env_c[4];
  }
}

// The SAM routes: the chain's eight warps and lane 0 of a ninth, which walks
// the PLL, a chunk apart (chain_common.cuh's walk_ahead; the header's
// description). The spectral routes, whose chain issues the most on the
// walker's scheduler, take SoloSync's block, the walker alone on its
// scheduler; the others ChainSync's.
template <Nr kNR>
using SamSync = std::conditional_t<kNR == Nr::kSpectral, SoloSync, ChainSync>;
//
// The spectral stage's pass A spectrum (kSpecFloats) lies over the upper half
// of Bs and the kSpecExtra floats after it, so its pass B and W_inv stream
// their operators in K tiles of kKT / 2 rows through the lower half.
constexpr int kSpecExtra = kSpecFloats - kBsFloats / 2;

// As, Bs, two slots of [I rows | Q rows], scan segment ends, 8 carries, the
// mixed carry row [re | im] and the audio carry row; the blanker adds the
// keep mask of the last row, the LMS its scratch (16-byte aligned), the
// spectral stage the rest of pass A's spectrum, the per-row floor sums and
// floors and the l/r carry rows
template <bool kNB, Nr kNR>
constexpr int sam_smem_floats() {
  return kAsFloats + kBsFloats + 4 * kRowBuf + kThreads + 8 + 3 * kBlk + (kNB ? kBlk : 0) +
         (is_lms(kNR) ? lms::kScratchFloats + 3 : 0) +
         (kNR == Nr::kSpectral ? kSpecExtra + 2 * kRows + 2 * kBlk : 0);
}

template <bool kNB, Nr kNR>
__global__ void __launch_bounds__(SamSync<kNR>::kBlock, 1) sam_chain_kernel(const ChainArgs a) {
  using Sync = SamSync<kNR>;
  constexpr bool kLMS = is_lms(kNR);
  constexpr bool kSpec = kNR == Nr::kSpectral;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = As + kAsFloats;
  float* Sa = Bs + kBsFloats / 2;   // spectral: pass A's spectrum
  float* slots = Bs + kBsFloats + (kSpec ? kSpecExtra : 0);  // chunk k in slot k & 1: I rows,
                                                              // then Q rows
  float* seg = slots + 4 * kRowBuf;
  float* env_c = seg + kThreads;  // [0] AGC envelope, [1] blanker average,
                                  // [2] [3] DC blocker: last input, last output,
                                  // [4] spectral floor
  float* mc = env_c + 8;          // the mixed rows' carry row [re | im]
  float* ac = mc + 2 * kBlk;      // the audio rows' carry row
  float* keep_row = ac + kBlk;    // nb: keep mask of the last row so far
  float* tail = keep_row + (kNB ? kBlk : 0);
  lms::Scratch& ls = *reinterpret_cast<lms::Scratch*>(smem + ((tail - smem + 3) & ~3));
  float* fsum = tail;             // spectral: per row, the VAD band's magnitude sum
  float* nfr = fsum + kRows;      // per row: the floor, clamped at 0
  float* st = nfr + kRows;        // the l/r carry rows [l | r]

  const int c = blockIdx.x, tid = Sync::tid(), warp = tid >> 5, lane = tid & 31;
  const int n = a.n;
  const size_t base = (size_t)c * n;
  const ChunkConsts cc = chunk_consts<kNB, true>(a, c);
  const int nrows = n / kBlk, chunks = (nrows + kRows - 1) / kRows;

  // the carried raw tail, re-scaled and re-mixed at positions -128..-1
  if (tid < kBlk) {
    const size_t t = (size_t)c * kBlk + tid;
    mix(a.tail_r[t], a.tail_i[t], cc.ph0 + (uint32_t)(tid - kBlk) * cc.dph, a.g_i, a.g_q,
        mc[tid], mc[kBlk + tid]);
    if constexpr (kNB) {
      mc[tid] *= a.nb_mask0[t];
      mc[kBlk + tid] *= a.nb_mask0[t];
    }
    ac[tid] = a.atail_in[t];
    if constexpr (kSpec) {
      st[tid] = a.stl0[t];
      st[kBlk + tid] = a.str0[t];
    }
  }
  // the PLL thread's state in registers across chunks
  Pll pll{};
  int next_seed = 0;
  if (tid == kThreads) {
    pll.phase = a.pll0[c];
    pll.freq = a.pll0[gridDim.x + c];
  }
  lms::Predictor pr;
  lms::Lags lg;
  bool lms_first = false;
  if (kLMS && warp == 0) pr.load(a.lms_w0 + c * lms::kTaps);
  if (kLMS && warp == 1) {
    ls.load_window(a.lms_win0 + c * lms::kTaps);
    lms_first = *a.lms_first != 0;
  }
  if (tid == 0) {
    env_c[0] = a.env0[c];
    if constexpr (kNB) env_c[1] = a.nb_avg0[c];
    env_c[2] = a.dc0[2 * c];
    env_c[3] = a.dc0[2 * c + 1];
    if constexpr (kSpec) env_c[4] = a.nfl0[c];
  }
  __syncthreads();

  // the chain: chunk k's mix [and blanker] and band-pass into its slot, zr
  // over the I rows and zi over the Q rows
  auto front = [&](int k) {
    float* Sr = slots + (k & 1) * 2 * kRowBuf;
    float* Si = Sr + kRowBuf;
    const int row0 = k * kRows, rows = min(kRows, nrows - row0);
    Sync::sync();   // chunk k-2's tail has read the slot
    if (tid < kBlk) {
      Sr[tid] = mc[tid];
      Si[tid] = mc[kBlk + tid];
    }
    mix_rows<kNB, Sync>(a, cc, Sr, Si, keep_row, seg, env_c, base, row0, rows);
    float acc[8][8];
    chunk_gemm<256, ALayout::kFrames, kRows, Sync>(Sr, Si, a.w_band, 512, As, Bs, acc);
    if (tid < kBlk) {
      mc[tid] = Sr[rows * kLd + tid];
      mc[kBlk + tid] = Si[rows * kLd + tid];
    }
    Sync::sync();
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = (warp * 8 + i + 1) * kLd + lane * 4 + j;
        Sr[o] = acc[i][j];
        Si[o] = acc[i][4 + j];
      }
  };
  // the walking warp's lane 0: the PLL over chunk k in time order, vr over zr
  auto walk = [&](int k) {
    if (tid != kThreads) return;
    float* Sr = slots + (k & 1) * 2 * kRowBuf;
    const float* Si = Sr + kRowBuf;
    const int row0 = k * kRows, rows = min(kRows, nrows - row0);
    for (int r = 1; r <= rows; ++r)
      walk_row(pll, a.gains, a.reseed, next_seed, (row0 + r - 1) * kBlk, kBlk, Sr + r * kLd,
               Si + r * kLd, Sr + r * kLd);
  };
  // the chain: chunk k's DC blocker, [notch,] AGC, PBT [and denoise or the
  // spectral stage] from vr
  auto back = [&](int k) {
    float* Sr = slots + (k & 1) * 2 * kRowBuf;
    float* Si = Sr + kRowBuf;
    const int row0 = k * kRows, rows = min(kRows, nrows - row0);
    if (tid < kBlk) Sr[tid] = ac[tid];   // row 0, which only PBT reads
    dc_rows<Sync>(cc, Sr, rows, seg, env_c);
    if constexpr (kNR == Nr::kNotch) {
      if (warp < 3)
        lms_walk(pr, lg, ls, Sr, rows, row0 * kBlk, a.lms_delay0 + c * lms::kDelay, lms_first,
                 a.mu, 1);
      Sync::sync();
    }
    agc_rows<Sync>(a, cc, Sr, rows, seg, env_c);
    float lr[8][8];
    chunk_gemm<256, ALayout::kFrames, kRows, Sync>(Sr, Sr, a.w_pbt, 256, As, Bs, lr);
    if (tid < kBlk) ac[tid] = Sr[rows * kLd + tid];
    if constexpr (kNR == Nr::kDenoise) {
      // L over the dead zi; warps 0-2 replace it by the LMS prediction
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Si[(warp * 8 + i + 1) * kLd + lane * 4 + j] = lr[i][j];
      Sync::sync();
      if (warp < 3)
        lms_walk(pr, lg, ls, Si, rows, row0 * kBlk, a.lms_delay0 + c * lms::kDelay, lms_first,
                 a.mu, 0);
      Sync::sync();
#pragma unroll 4
      for (int e = tid; e < rows * kBlk; e += kThreads) {
        const int r = e / kBlk, j = e % kBlk;
        a.out_l[base + (size_t)(row0 + r) * kBlk + j] =
            Si[(r + 1) * kLd + j] * kDenoiseMakeup * a.out_gain;
      }
    } else if constexpr (kSpec) {
      // l over vr, r over the dead zi, pass B's spectrum over both, once the
      // audio carry row has been read
      Sync::sync();
      spectral_rows<Sync, kKT / 2>(a, lr, Sr, Si, Sa, fsum, nfr, st, env_c, As, Bs, base,
                                        row0, rows);
    } else {
      store_rows<256, 2, Sync>(lr, a.out_l, a.out_r, base, row0, rows, a.out_gain);
    }
  };

  walk_ahead<Sync>(chunks, front, walk, back);

  if (tid < kBlk) {
    a.atail_out[(size_t)c * kBlk + tid] = ac[tid];
    if constexpr (kNB) a.nb_mask_out[(size_t)c * kBlk + tid] = keep_row[tid];
  }
  if (tid == 0) {
    a.env_out[c] = env_c[0];
    if constexpr (kNB) a.nb_avg_out[c] = env_c[1];
    a.dc_out[2 * c] = env_c[2];
    a.dc_out[2 * c + 1] = env_c[3];
  }
  if (tid == kThreads) {
    a.pll_out[c] = pll.phase;
    a.pll_out[gridDim.x + c] = pll.freq;
  }
  if constexpr (kLMS) {
    if (warp == 0) pr.store(a.lms_w_out + c * lms::kTaps);
    if (warp == 1) {
      ls.store_window(a.lms_win_out + c * lms::kTaps, n);
#pragma unroll
      for (int k = lane; k < lms::kDelay; k += 32)
        a.lms_delay_out[c * lms::kDelay + k] = ls.at(n - lms::kDelay + k);
    }
  }
  if constexpr (kSpec) {
    if (tid < kBlk) {
      const size_t t = (size_t)c * kBlk + tid;
      a.stl_out[t] = st[tid];
      a.str_out[t] = st[kBlk + tid];
    }
    if (tid == 0) a.nfl_out[c] = env_c[4];
  }
}

// Launch on `stream` of CUDA device `device`, one block per channel; returns
// the cudaError_t of the launch (0 on success).
template <Demod kDemod, bool kNB, Nr kNR = Nr::kNone, bool kEmitR = kNR != Nr::kDenoise>
int launch(const ChainArgs& a, int channels, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if constexpr (kDemod == Demod::kSAM) {
    constexpr int smem = sam_smem_floats<kNB, kNR>() * (int)sizeof(float);
    static_assert(smem <= 232448, "shared memory of one H100 block");
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(sam_chain_kernel<kNB, kNR>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    sam_chain_kernel<kNB, kNR><<<channels, SamSync<kNR>::kBlock, smem, (cudaStream_t)stream>>>(a);
  } else {
    constexpr int smem = smem_floats<kNB, kNR>() * (int)sizeof(float);
    static_assert(smem <= 232448, "shared memory of one H100 block");
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(sweep_chain_kernel<kDemod, kNB, kNR, kEmitR>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    sweep_chain_kernel<kDemod, kNB, kNR, kEmitR>
        <<<channels, kThreads, smem, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// The instantiation of NR stage kNR for demod (0 ssb, 1 am, 2 sam) and the
// blanker (nb != 0); cudaErrorInvalidValue for another demod.
template <Nr kNR>
int launch_variant(const ChainArgs& a, int demod, int nb, int channels, int device,
                   void* stream) {
  switch (demod * 2 + (nb != 0)) {
    case 0: return launch<Demod::kSSB, false, kNR>(a, channels, device, stream);
    case 1: return launch<Demod::kSSB, true, kNR>(a, channels, device, stream);
    case 2: return launch<Demod::kAM, false, kNR>(a, channels, device, stream);
    case 3: return launch<Demod::kAM, true, kNR>(a, channels, device, stream);
    case 4: return launch<Demod::kSAM, false, kNR>(a, channels, device, stream);
    case 5: return launch<Demod::kSAM, true, kNR>(a, channels, device, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
