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
//   spectral: per 128-sample row, Z = DFT256([prev_l | l] + i [prev_r | r])
//             (sr + i si over 256 bins), mag = sqrt(sr^2 + si^2),
//             floor_est = (sum of mag over bins 30..180) * nr_gain,
//             nf[j] = 0.35*nf[j-1] + 0.65*floor_est[j] across rows, chunks
//             and segments, scale = 0.2 where mag <= max(nf, 0), else
//             1 - nf/max(mag, 1e-20), IDFT256(Z * scale) / 256 -> the right
//             halves, yl = Re and yr = Im, times the output gain. The TPU
//             kernel multiplies by the dense DFT operators W_fwd (512, 512)
//             and W_inv (512, 256); here the stage is a 256-point FFT.
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
// of the PBT product, whose sums are never stored); spectral adds about 137
// (a forward and an inverse FFT of 7,296 flops a row, the magnitudes, the
// scales: 128 samples a row), where the TPU kernel's dense DFT products did
// 6,144 (W_fwd 4,096, W_inv 2,048); the kernels run the forward FFT and the
// magnitudes a second time (65 more, above the bound, see below). One 128-channel x 2^19-sample ssb segment is
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
// on its scheduler (warp id mod 4), so that no chain warp takes the
// walker's issue slots: the walk paces these routes, and on the H100 a SAM
// chain with the walk beside chain warps ran SAM + spectral at 13.1 ms a
// 128 x 2^17 segment against 10.1 on SoloSync, sweep_chain_sam 10.4-10.5
// against 9.5-9.6 (the former with the stage's dense products of the
// TPU's design). Whether the FFT stage still needs the layout is not
// measured. A chunk's rows live in one of two
// slots of [I rows | Q rows]: the mix writes them, the band-pass writes zr
// over the I rows and zi over the Q rows (the mixed rows' last row saved
// first as the next chunk's row 0), the PLL writes vr over zr, and the DC
// blocker, AGC and PBT read it there, the audio rows' last row saved in a
// carry row; denoise writes L over the dead zi, the spectral stage l over vr
// and r over zi. Shared memory (bytes of the 232,448 one block may have):
// sam 177,712, + blanker 178,224, + denoise or notch 196,156, + both
// 196,668, + spectral 181,296, + spectral and blanker 181,808. The LMS
// stages run on warps 0-2
// (lms_step.cuh's walk), in place, 32 samples (two groups) a tile: notch
// over the audio rows, denoise over L, which the PBT product writes into
// the dead mixed I rows. The lags warp takes each tile's inputs into the
// LMS's ring of the last 256 (in its scratch, 18 KB of shared memory) with
// their desired samples x[t-128] before the predictor, two tiles behind,
// overwrites them with the outputs, so the in-place walk needs no pristine
// copy of its input. The spectral stage is K4's (spectral_rows): the mixed
// rows' last row waits in its own buffer, PBT writes l and r into the mixed
// rows, and each warp runs its 8 rows' frames through an in-warp 256-point
// FFT (namespace fft below: 8 points a lane, radix 8 x 8 x 4, two exchanges
// through shared memory, the bins left in digit-reversed order, which the
// inverse takes as they are). The floor's order: each warp sums its rows'
// VAD bins (their natural indices read through the digit reversal), one
// thread runs the 64-row one-pole scan from the carry, and only then is any
// bin scaled; the forward FFT runs a second time for the scale and the
// inverse, since keeping 64 spectra would take 128 KB, which the SAM routes'
// two slots leave no room for. The FFT's exchange buffers lie in the
// operator tiles, which no product uses meanwhile. Shared memory of the SSB
// and AM spectral routes: 147,756 B with the blanker. The
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

constexpr int kVadStart = 30, kVadEnd = 180;  // the VAD band, bins inclusive
constexpr float kFloorBeta = 0.65f;
constexpr float kFloorA = (float)(1.0 - 0.65);
constexpr float kUnderFloorGain = 0.2f;

__host__ __device__ constexpr bool is_lms(Nr nr) { return nr == Nr::kDenoise || nr == Nr::kNotch; }

// The spectral stage's 256-point complex FFT, one warp a frame, 8 points a
// lane in registers: radix 8 x 8 x 4 by decimation in frequency, twiddles
// between the stages, two exchanges through the warp's buffer in shared
// memory. Stage 1, lane l: z[l + 32m] over m -> k1, times W^(l k1) (W =
// exp(-2 pi i / 256)). Stage 2, lane 4 k1 + l1: over l2 (l = l1 + 4 l2) ->
// k2a, times W^(8 l1 k2a). Stage 3, lane 4 k1 + g: over l1 -> k2b for k2a =
// 2g and 2g + 1. Lane q's register j then holds bin k1 + 8 k2a + 64 k2b =
// bin_of(8q + j): the bins in digit-reversed order, position 32 k1 + 4 k2a +
// k2b (spectral_sub.fft256_model is this FFT in PyTorch). The inverse runs the
// stages backwards on the conjugate twiddles from that order, so no pass
// reorders the bins, and ends with lane l holding y[l + 32m], m = 4..7 the
// outputs kept. The twiddles W^j, j = 0..255, come from ChainArgs' fft_tw
// (float64 on the host, rounded to float32) through a table in shared memory.
namespace fft {

constexpr int kXLd = 36;                   // exchange stride: no bank conflict either way
constexpr int kXHalf = 7 * kXLd + 32;      // one part (re or im) of the buffer
constexpr int kXFloats = 2 * kXHalf;       // a warp's exchange buffer
constexpr float kSqrtHalf = 0.70710678118654752f;   // W^32's parts, +-

static_assert(8 * kXFloats <= kBsFloats, "the exchange buffers fit the operator tiles");

// the natural bin of digit-reversed position p = 32 k1 + 4 k2a + k2b
__device__ __forceinline__ int bin_of(int p) { return (p >> 5) + 8 * ((p >> 2) & 7) + 64 * (p & 3); }

// a lane's twiddles: stage 1's W^(lane k1) and stage 2's W^(8 (lane & 3) k2a),
// index 1..7 (0 is 1); the inverse takes their conjugates at the same lanes
struct Twiddles {
  float r1[8], i1[8], r2[8], i2[8];
};

__device__ __forceinline__ Twiddles twiddles(const float* tw, int lane) {
  Twiddles t;
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    t.r1[k] = tw[lane * k];
    t.i1[k] = tw[256 + lane * k];
    t.r2[k] = tw[8 * (lane & 3) * k];
    t.i2[k] = tw[256 + 8 * (lane & 3) * k];
  }
  return t;
}

// (re + i im) times (wr + i wi), or times its conjugate with kInv
template <bool kInv>
__device__ __forceinline__ void cmul(float& re, float& im, float wr, float wi) {
  if (kInv) wi = -wi;
  const float r = re * wr - im * wi;
  im = re * wi + im * wr;
  re = r;
}

// x[k] = sum_m x[m] W8^(+-mk) in place, natural order in and out: radix 2 by
// decimation in frequency, the bit reversal a renaming
template <bool kInv>
__device__ __forceinline__ void dft8(float (&xr)[8], float (&xi)[8]) {
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float ar = xr[m], ai = xi[m], br = xr[m + 4], bi = xi[m + 4];
    xr[m] = ar + br;
    xi[m] = ai + bi;
    const float dr = ar - br, di = ai - bi;
    if (m == 0) {
      xr[4] = dr;
      xi[4] = di;
    } else if (m == 1) {   // W8^(+-1) = sqrt(1/2) (1 -+ i)
      xr[5] = kSqrtHalf * (kInv ? dr - di : dr + di);
      xi[5] = kSqrtHalf * (kInv ? dr + di : di - dr);
    } else if (m == 2) {   // W8^(+-2) = -+i
      xr[6] = kInv ? -di : di;
      xi[6] = kInv ? dr : -dr;
    } else {               // W8^(+-3) = sqrt(1/2) (-1 -+ i)
      xr[7] = kSqrtHalf * (kInv ? -(dr + di) : di - dr);
      xi[7] = kSqrtHalf * (kInv ? dr - di : -(dr + di));
    }
  }
#pragma unroll
  for (int h = 0; h < 8; h += 4)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float ar = xr[h + m], ai = xi[h + m], br = xr[h + m + 2], bi = xi[h + m + 2];
      xr[h + m] = ar + br;
      xi[h + m] = ai + bi;
      const float dr = ar - br, di = ai - bi;
      xr[h + m + 2] = m == 0 ? dr : (kInv ? -di : di);
      xi[h + m + 2] = m == 0 ? di : (kInv ? dr : -dr);
    }
#pragma unroll
  for (int p = 0; p < 8; p += 2) {
    const float ar = xr[p], ai = xi[p], br = xr[p + 1], bi = xi[p + 1];
    xr[p] = ar + br;
    xi[p] = ai + bi;
    xr[p + 1] = ar - br;
    xi[p + 1] = ai - bi;
  }
  float t = xr[1]; xr[1] = xr[4]; xr[4] = t;
  t = xi[1]; xi[1] = xi[4]; xi[4] = t;
  t = xr[3]; xr[3] = xr[6]; xr[6] = t;
  t = xi[3]; xi[3] = xi[6]; xi[6] = t;
}

// the 4-point DFT of x[o], x[o+1], x[o+2], x[o+3] in place, W4 = -+i
template <bool kInv>
__device__ __forceinline__ void dft4(float (&xr)[8], float (&xi)[8], int o) {
  const float t0r = xr[o] + xr[o + 2], t0i = xi[o] + xi[o + 2];
  const float t1r = xr[o] - xr[o + 2], t1i = xi[o] - xi[o + 2];
  const float t2r = xr[o + 1] + xr[o + 3], t2i = xi[o + 1] + xi[o + 3];
  const float dr = xr[o + 1] - xr[o + 3], di = xi[o + 1] - xi[o + 3];
  const float t3r = kInv ? -di : di, t3i = kInv ? dr : -dr;
  xr[o] = t0r + t2r;
  xi[o] = t0i + t2i;
  xr[o + 2] = t0r - t2r;
  xi[o + 2] = t0i - t2i;
  xr[o + 1] = t1r + t3r;
  xi[o + 1] = t1i + t3i;
  xr[o + 3] = t1r - t3r;
  xi[o + 3] = t1i - t3i;
}

// The exchanges, through the warp's buffer xb ([re | im], kXHalf each):
// register k of a lane at its base + off<kO>(k). Stage 1 <-> 2: lane l's
// value k1 at k1 kXLd + l, lane 4 k1 + l1's value l2 at k1 kXLd + l1 + 4 l2.
// Stage 2 <-> 3: lane 4 k1 + l1's value k2a at k1 + 8 l1 + kXLd k2a, lane
// 4 k1 + g's value 4h + l1 at the same place for k2a = 2g + h.
enum Off { kRows, kQuads, kPairs };
template <Off kO>
__device__ __forceinline__ int off(int k) {
  return kO == kRows ? k * kXLd : kO == kQuads ? 4 * k : kXLd * (k >> 2) + 8 * (k & 3);
}
struct Bases {   // a lane's bases: b1 (stage 1) <-> b2 (stage 2), b3 (stage 2) <-> b4 (stage 3)
  int b1, b2, b3, b4;
  __device__ __forceinline__ explicit Bases(int lane)
      : b1(lane), b2((lane >> 2) * kXLd + (lane & 3)), b3((lane >> 2) + 8 * (lane & 3)),
        b4((lane >> 2) + 2 * kXLd * (lane & 3)) {}
};
template <Off kO>
__device__ __forceinline__ void put(float* xb, int base, const float (&xr)[8],
                                    const float (&xi)[8]) {
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    xb[base + off<kO>(k)] = xr[k];
    xb[kXHalf + base + off<kO>(k)] = xi[k];
  }
  __syncwarp();
}
template <Off kO>
__device__ __forceinline__ void get(const float* xb, int base, float (&xr)[8], float (&xi)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    xr[k] = xb[base + off<kO>(k)];
    xi[k] = xb[kXHalf + base + off<kO>(k)];
  }
}

// z (lane l: z[l + 32m] in register m) -> its spectrum, register j of lane q
// holding bin bin_of(8q + j)
__device__ __forceinline__ void forward(const Twiddles& t, float* xb, int lane, float (&xr)[8],
                                        float (&xi)[8]) {
  const Bases b(lane);
  dft8<false>(xr, xi);
#pragma unroll
  for (int k = 1; k < 8; ++k) cmul<false>(xr[k], xi[k], t.r1[k], t.i1[k]);
  put<kRows>(xb, b.b1, xr, xi);
  get<kQuads>(xb, b.b2, xr, xi);
  dft8<false>(xr, xi);
#pragma unroll
  for (int k = 1; k < 8; ++k) cmul<false>(xr[k], xi[k], t.r2[k], t.i2[k]);
  put<kRows>(xb, b.b3, xr, xi);
  get<kPairs>(xb, b.b4, xr, xi);
  dft4<false>(xr, xi, 0);
  dft4<false>(xr, xi, 4);
}

// the spectrum as forward leaves it -> 256 y (unscaled), lane l holding
// y[l + 32m] in register m
__device__ __forceinline__ void inverse(const Twiddles& t, float* xb, int lane, float (&xr)[8],
                                        float (&xi)[8]) {
  const Bases b(lane);
  dft4<true>(xr, xi, 0);
  dft4<true>(xr, xi, 4);
  put<kPairs>(xb, b.b4, xr, xi);
  get<kRows>(xb, b.b3, xr, xi);
#pragma unroll
  for (int k = 1; k < 8; ++k) cmul<true>(xr[k], xi[k], t.r2[k], t.i2[k]);
  dft8<true>(xr, xi);
  put<kQuads>(xb, b.b2, xr, xi);
  get<kRows>(xb, b.b1, xr, xi);
#pragma unroll
  for (int k = 1; k < 8; ++k) cmul<true>(xr[k], xi[k], t.r1[k], t.i1[k]);
  dft8<true>(xr, xi);
}

}  // namespace fft

// As, Bs, three row buffers, scan segment ends, 8 carries; the blanker adds
// the keep mask of the last row, the LMS its scratch (16-byte aligned: up to
// 3 floats of padding before it), the spectral stage the per-row floor sums
// and floors, the mixed carry row, the l/r carry rows and the twiddle table
template <bool kNB, Nr kNR>
constexpr int smem_floats() {
  return kAsFloats + kBsFloats + 3 * kRowBuf + kThreads + 8 + (kNB ? kBlk : 0) +
         (is_lms(kNR) ? lms::kScratchFloats + 3 : 0) +
         (kNR == Nr::kSpectral ? 2 * kRows + 4 * kBlk + 512 : 0);
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
// carry rows st (st then takes their last rows); each warp runs its rows'
// frames x + i y through the FFT for their VAD sums; the floor across the
// chunk's rows from its carry env_c[4] before any bin is scaled; then each
// warp runs its frames through the FFT again, scales every bin, runs the
// inverse and stores the right halves, times 1/256 and the output gain,
// straight to device memory. tw is the twiddle table, xbuf the warps'
// exchange buffers (the operator tiles, which no product uses meanwhile).
// Ends with Sync::sync(), so the caller may overwrite X and Y.
template <class Sync>
__device__ __forceinline__ void spectral_rows(const ChainArgs& a, const float (&lr)[8][8],
                                              float* X, float* Y, const float* tw, float* xbuf,
                                              float* fsum, float* nfr, float* st, float* env_c,
                                              size_t base, int row0, int rows) {
  const int tid = Sync::tid(), warp = tid >> 5, lane = tid & 31;
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
  if (tid < kBlk) {
    st[tid] = X[rows * kLd + tid];
    st[kBlk + tid] = Y[rows * kLd + tid];
  }
  const fft::Twiddles t = fft::twiddles(tw, lane);
  float* xb = xbuf + warp * fft::kXFloats;
  // frame r (buffer rows r and r + 1) into lane's registers: z[lane + 32m]
  auto frame = [&](int r, float (&zr)[8], float (&zi)[8]) {
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int o = (r + (m >> 2)) * kLd + lane + 32 * (m & 3);
      zr[m] = X[o];
      zi[m] = Y[o];
    }
  };

  // 5s. each row's VAD sum
  for (int i = 0; i < 8; ++i) {
    const int r = warp * 8 + i;
    if (r >= rows) break;
    float zr[8], zi[8];
    frame(r, zr, zi);
    fft::forward(t, xb, lane, zr, zi);
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int bin = fft::bin_of(8 * lane + j);
      if (bin >= kVadStart && bin <= kVadEnd) part += magnitude(zr[j], zi[j]);
    }
    part = warp_sum(part);
    if (lane == 0) fsum[r] = part;
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

  // 8s-9s. the spectrum again, every bin scaled, the inverse, the right
  // halves [yl | yr] times 1/256 (exact) and the output gain
  const float gain = a.out_gain * (1.f / 256.f);
  for (int i = 0; i < 8; ++i) {
    const int r = warp * 8 + i;
    if (r >= rows) break;
    float zr[8], zi[8];
    frame(r, zr, zi);
    fft::forward(t, xb, lane, zr, zi);
    const float nf = nfr[r];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float g = subtract_scale(magnitude(zr[j], zi[j]), nf);
      zr[j] *= g;
      zi[j] *= g;
    }
    fft::inverse(t, xb, lane, zr, zi);
    const size_t o = base + (size_t)(row0 + r) * kBlk + lane;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      a.out_l[o + 32 * m] = zr[4 + m] * gain;
      a.out_r[o + 32 * m] = zi[4 + m] * gain;
    }
  }
  Sync::sync();
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
  float* fsum = tail;                             // spectral: per row, the VAD band's sum
  float* nfr = fsum + kRows;                      // per row: the floor, clamped at 0
  float* mt = nfr + kRows;                        // the mixed carry row [re | im]
  float* st = mt + 2 * kBlk;                      // the l/r carry rows [l | r]
  float* tw = st + 2 * kBlk;                      // the FFT's twiddle table [re | im]
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
  if constexpr (kSpec) {
    for (int e = tid; e < 512; e += kThreads) tw[e] = a.fft_tw[e];
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
      // 4s-9s. spectral: l into Mr, r into Mi
      spectral_rows<BlockSync>(a, lr, Mr, Mi, tw, Bs, fsum, nfr, st, env_c, base, row0, rows);
      // the mixed carry back into row 0 (the stage ends at a barrier)
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

// As, Bs, two slots of [I rows | Q rows], scan segment ends, 8 carries, the
// mixed carry row [re | im] and the audio carry row; the blanker adds the
// keep mask of the last row, the LMS its scratch (16-byte aligned), the
// spectral stage the per-row floor sums and floors, the l/r carry rows and
// the twiddle table
template <bool kNB, Nr kNR>
constexpr int sam_smem_floats() {
  return kAsFloats + kBsFloats + 4 * kRowBuf + kThreads + 8 + 3 * kBlk + (kNB ? kBlk : 0) +
         (is_lms(kNR) ? lms::kScratchFloats + 3 : 0) +
         (kNR == Nr::kSpectral ? 2 * kRows + 2 * kBlk + 512 : 0);
}

template <bool kNB, Nr kNR>
__global__ void __launch_bounds__(SamSync<kNR>::kBlock, 1) sam_chain_kernel(const ChainArgs a) {
  using Sync = SamSync<kNR>;
  constexpr bool kLMS = is_lms(kNR);
  constexpr bool kSpec = kNR == Nr::kSpectral;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = As + kAsFloats;
  float* slots = Bs + kBsFloats;   // chunk k in slot k & 1: I rows, then Q rows
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
  float* tw = st + 2 * kBlk;      // the FFT's twiddle table [re | im]

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
  if constexpr (kSpec) {
    if (tid < kThreads)
      for (int e = tid; e < 512; e += kThreads) tw[e] = a.fft_tw[e];
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
    chunk_gemm<256, kRows, Sync>(Sr, Si, a.w_band, 512, As, Bs, acc);
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
    chunk_gemm<256, kRows, Sync>(Sr, Sr, a.w_pbt, 256, As, Bs, lr);
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
      // l over vr, r over the dead zi, once the audio carry row has been read
      Sync::sync();
      spectral_rows<Sync>(a, lr, Sr, Si, tw, Bs, fsum, nfr, st, env_c, base, row0, rows);
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
