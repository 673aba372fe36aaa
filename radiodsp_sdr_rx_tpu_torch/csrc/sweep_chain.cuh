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
// the AM envelope and DC blocker about 6 and a square root. The SAM PLL and
// the LMS are not bound by a rate: each is a chain of dependent per-sample
// steps (sam_pll.cuh, lms_step.cuh), n of them per segment whatever the
// channel count, and their latency sets the time of those instantiations.
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
// SAM writes zr into the audio rows and zi into the mixed Q rows (dead after
// the product once their last row has moved out), and thread 0 walks the
// chunk's 8,192 samples in time order, overwriting zr with vr, while the
// other 255 threads wait at the barrier. The LMS stages run the same way on
// warp 0, in place: notch over the audio rows, denoise over L, which the PBT
// product writes into the dead mixed I rows. The desired sample x[t-128] is
// read from the input ring just before x[t] replaces it (from the carried
// delay line for the segment's first 128 samples), so the in-place walk
// needs no pristine copy of its input. The spectral stage is K4's: the mixed
// rows' last row waits in its own buffer, PBT writes l and r into the mixed
// rows, W_fwd runs as two passes of 256 columns (its columns permuted by the
// wrapper so that a pass holds sr and si of 128 bins and one thread holds sr
// and si of the same bin): pass A's spectrum goes to a 64 x 257 buffer, pass
// B's stays in registers until l and r are dead (their last rows saved as
// the carries) and then overwrites them. The floor's order: each warp sums
// its rows' VAD bins (shuffles), one thread runs the 64-row one-pole scan
// from the carry, and only then is any bin scaled. W_inv reads the two
// spectrum halves in their natural row order (ALayout::kSpectrum). Shared
// memory is the constraint there: 211.5 KB of the 227 KB with SAM and the
// blanker. The AGC, the blanker's average and the DC blocker are scans over
// the chunk, run as 256 segments of 32 samples: each thread scans its
// segment from zero, warp 0 scans the segment ends (a decaying max for the
// AGC, a decaying sum for the other two) and each thread re-runs its segment
// from the true carry, so every sample follows the sequential recurrence.
// Segments past the end of a partial last chunk come after every valid one
// and never reach a carry. Hiding the PLL's and the LMS's walks behind the
// next chunk's products (warp specialisation) and a TF32/3xTF32 tensor-core
// design of the products are later work.

#pragma once

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
// the keep mask of the last row, the LMS its input ring, the spectral stage
// pass A's spectrum, the per-row floor sums and floors, the mixed carry row
// and the l/r carry rows
template <bool kNB, Nr kNR>
constexpr int smem_floats() {
  return kAsFloats + kBsFloats + 3 * kRowBuf + kThreads + 8 + (kNB ? kBlk : 0) +
         (is_lms(kNR) ? lms::kRing : 0) +
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

// Warp 0: the LMS over rows 1..rows of buf, the chunk's samples from
// segment position pos0, in time order and in place: each sample's output
// overwrites its input. The desired sample x[m-128] is read from the ring
// just before x[m] replaces it; for m < 128 it comes from the carried delay
// line, or is x[m] itself while `first` (the reference's first-block quirk).
__device__ __forceinline__ void lms_walk(lms::Warp& lw, float* ring, float* buf, int rows,
                                         int pos0, const float* __restrict__ delay,
                                         bool first, float mu, int notch) {
  const int lane = threadIdx.x;
  for (int i0 = 0; i0 < rows * kBlk; i0 += 32) {
    const int i = i0 + lane, m = pos0 + i;
    float* px = buf + (i / kBlk + 1) * kLd + i % kBlk;
    __syncwarp();   // the previous tile's window loads are done
    const float xv = *px;
    const int slot = m & (lms::kRing - 1);
    const float dv = m >= lms::kDelay ? ring[slot] : (first ? xv : delay[m]);
    ring[slot] = xv;
    __syncwarp();
    *px = lw.tile(ring, pos0 + i0, 32, dv, mu, notch);
  }
}

template <Demod kDemod, bool kNB, Nr kNR, bool kEmitR>
__global__ void __launch_bounds__(kThreads, 1) sweep_chain_kernel(const ChainArgs a) {
  constexpr bool kSAM = kDemod == Demod::kSAM;
  constexpr bool kDsb = kDemod == Demod::kAM || kSAM;  // the complex band-pass and DC blocker
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
  float* ring = keep_row + (kNB ? kBlk : 0);      // LMS: the last 128 inputs
  float* Sa = ring + (kLMS ? lms::kRing : 0);     // spectral: pass A's spectrum
  float* fsum = Sa + kSpecFloats;                 // per row: the VAD band's magnitude sum
  float* nfr = fsum + kRows;                      // per row: the floor, clamped at 0
  float* mt = nfr + kRows;                        // the mixed carry row [re | im]
  float* st = mt + 2 * kBlk;                      // the l/r carry rows [l | r]
  float* Sb = Mr;                                 // pass B's spectrum over Mr and Mi
  float* carry_r = kSpec ? mt : Mr;               // where the mixed rows' last row waits
  float* carry_i = kSpec ? mt + kBlk : Mi;

  const int c = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = a.n;
  const size_t base = (size_t)c * n;
  const uint32_t ph0 = (uint32_t)a.phase0[c];
  const uint32_t dph = (uint32_t)a.inc[c];
  const float rel = (float)a.release;
  float rel_lanes[5];
  const float rel_seg = seg_factors(a.release, rel_lanes);
  float nb_af = 0.f, nb_om = 0.f, nb_seg = 0.f, nb_lanes[5];
  if constexpr (kNB) {
    nb_af = (float)a.nb_a;
    nb_om = (float)(1.0 - a.nb_a);
    nb_seg = seg_factors(a.nb_a, nb_lanes);
  }
  float dc_pf = 0.f, dc_seg = 0.f, dc_lanes[5];
  if constexpr (kDsb) {
    dc_pf = (float)kDcPole;
    dc_seg = seg_factors(kDcPole, dc_lanes);
  }

  // the carried raw tail, re-scaled and re-mixed at positions -128..-1
  if (tid < kBlk) {
    const size_t t = (size_t)c * kBlk + tid;
    mix(a.tail_r[t], a.tail_i[t], ph0 + (uint32_t)(tid - kBlk) * dph, a.g_i, a.g_q, Mr[tid],
        Mi[tid]);
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
  // SAM: thread 0 runs the channel's PLL, its state in registers across chunks
  Pll pll{0.f, 0.f, 0.f, 0.f};
  int next_seed = 0;
  if (kSAM && tid == 0) {
    pll.phase = a.pll0[c];
    pll.freq = a.pll0[gridDim.x + c];
  }
  // LMS: warp 0 runs the channel's LMS, its weights in registers across chunks
  lms::Warp lw;
  bool lms_first = false;
  if (kLMS && warp == 0) {
    lw.load(a.lms_w0 + c * lms::kTaps, a.lms_win0 + c * lms::kTaps, ring);
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
      __syncthreads();

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
        __syncthreads();
        if (warp == 0) scan_segment_carries<true>(seg, env_c[1], nb_seg, nb_lanes);
        __syncthreads();
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
      __syncthreads();

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
    __syncthreads();

    // 2. band-pass + SSB demod (ssb), or band-pass + envelope (am): Ab rows
    // 1..kRows. In the am product acc[i][j] and acc[i][4+j] are columns
    // 4*lane+j and 128+4*lane+j: zr and zi of one sample.
    {
      if constexpr (kSAM) {
        float acc[8][8];
        chunk_gemm<256>(Mr, Mi, a.w_band, 512, As, Bs, acc);
        // the mixed rows' last row moves out now: zi overwrites the Q rows
        if (tid < kBlk) {
          carry_r[tid] = Mr[rows * kLd + tid];
          carry_i[tid] = Mi[rows * kLd + tid];
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int o = (warp * 8 + i + 1) * kLd + lane * 4 + j;
            Ab[o] = acc[i][j];
            Mi[o] = acc[i][4 + j];
          }
        __syncthreads();
        // 2a. the PLL over the chunk in time order: vr over zr in place
        if (tid == 0) {
          for (int r = 0; r < rows; ++r) {
            float* p = Ab + (r + 1) * kLd;
            const float* q = Mi + (r + 1) * kLd;
            const int pos0 = (row0 + r) * kBlk;
#pragma unroll 4
            for (int k = 0; k < kBlk; ++k) {
              if (pos0 + k == next_seed) {
                pll.reseed();
                next_seed = a.reseed.next(next_seed);
              }
              p[k] = pll.step(p[k], q[k], a.gains);
            }
          }
        }
      } else if constexpr (kDsb) {
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
      // their last row becomes the next chunk's row 0 now, as SAM's does
      if (!kSAM && tid < kBlk) {
        carry_r[tid] = Mr[rows * kLd + tid];
        carry_i[tid] = Mi[rows * kLd + tid];
      }
    }
    __syncthreads();

    // 2b. am: DC blocker in place, y = (env - env_prev) + pole*y, the
    // blanker's segmented decaying-sum scan. Each thread reads the envelope
    // just before its segment before any thread overwrites one.
    if constexpr (kDsb) {
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
      __syncthreads();
      if (warp == 0) scan_segment_carries<true>(seg, env_c[3], dc_seg, dc_lanes);
      __syncthreads();
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
      __syncthreads();
    }

    // 2c. notch: the LMS error replaces the audio, warp 0 walking the chunk
    if constexpr (kNR == Nr::kNotch) {
      if (warp == 0)
        lms_walk(lw, ring, Ab, rows, row0 * kBlk, a.lms_delay0 + c * lms::kDelay, lms_first,
                 a.mu, 1);
      __syncthreads();
    }

    // 3. AGC. Segment s = 4*row + quarter; segments past the end come after
    // every valid one, so they never reach a valid carry.
    {
      const int r = tid % kRows, quarter = tid / kRows;
      const int s = r * kSegsPerRow + quarter;
      float* p = Ab + (r + 1) * kLd + quarter * kSegLen;
      float e = 0.f;
      for (int k = 0; k < kSegLen; ++k) e = fmaxf(fabsf(p[k]), e * rel);
      seg[s] = e;
      __syncthreads();
      if (warp == 0) scan_segment_carries<false>(seg, env_c[0], rel_seg, rel_lanes);
      __syncthreads();
      e = seg[s];
      for (int k = 0; k < kSegLen; ++k) {
        const float v = p[k];
        e = fmaxf(fabsf(v), e * rel);
        if (a.agc_enabled) p[k] = v * fminf(a.target / fmaxf(e, 1e-12f), a.max_gain);
      }
      if (s == rows * kSegsPerRow - 1) env_c[0] = e;
    }
    __syncthreads();

    // 4. PBT -> [L|R]; the audio rows' last row becomes the next chunk's
    // row 0 (the product has read them all); then the NR stage after PBT
    float lr[8][8];
    chunk_gemm<256>(Ab, Ab, a.w_pbt, 256, As, Bs, lr);
    if (tid < kBlk) Ab[tid] = Ab[rows * kLd + tid];
    if constexpr (kNR == Nr::kNone || kNR == Nr::kNotch) {
      // [L|R] (L alone without kEmitR), output gain, straight to device memory
      store_rows<256, kEmitR ? 2 : 1>(lr, a.out_l, a.out_r, base, row0, rows, a.out_gain);
    } else if constexpr (kNR == Nr::kDenoise) {
      // L into the dead mixed I rows; warp 0 replaces it by the LMS
      // prediction; then y * 1.1 * output gain, straight to device memory
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Mr[(warp * 8 + i + 1) * kLd + lane * 4 + j] = lr[i][j];
      __syncthreads();
      if (warp == 0)
        lms_walk(lw, ring, Mr, rows, row0 * kBlk, a.lms_delay0 + c * lms::kDelay, lms_first,
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
      // 4s. spectral: l into Mr, r into Mi (rows 1..kRows), their carries in row 0
      float* X = Mr;
      float* Y = Mi;
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
      __syncthreads();

      // 5s. W_fwd pass A: bins 0..127 -> Sa, and each row's VAD sum over them
      {
        float acc[8][8];
        chunk_gemm<256>(X, Y, a.w_fwd, 512, As, Bs, acc);
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
      chunk_gemm<256>(X, Y, a.w_fwd + 512 * 256, 512, As, Bs, acc_b);
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
      __syncthreads();

      // 7s. the floor across the chunk's rows, from the carry, before any scale
      if (tid == 0) {
        float nf = env_c[4];
        for (int r = 0; r < kRows; ++r) {
          if (r < rows) nf = kFloorBeta * (fsum[r] * a.nr_gain) + kFloorA * nf;
          nfr[r] = r < rows ? fmaxf(nf, 0.f) : 0.f;
        }
        env_c[4] = nf;
      }
      __syncthreads();

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
      __syncthreads();

      // 9s. W_inv -> [yl | yr] right halves, output gain, straight to device memory
      {
        float acc[8][8];
        chunk_gemm<256, ALayout::kSpectrum>(Sa, Sb, a.w_inv, 512, As, Bs, acc);
        store_rows<256>(acc, a.out_l, a.out_r, base, row0, rows, a.out_gain);
      }
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
  if (kSAM && tid == 0) {
    a.pll_out[c] = pll.phase;
    a.pll_out[gridDim.x + c] = pll.freq;
  }
  if constexpr (kLMS) {
    // the weights, the window and the delay line: the segment's last 128 inputs
    if (warp == 0) {
      lw.store(a.lms_w_out + c * lms::kTaps, a.lms_win_out + c * lms::kTaps, ring, n);
#pragma unroll
      for (int k = lane; k < lms::kDelay; k += 32)
        a.lms_delay_out[c * lms::kDelay + k] = ring[(n - lms::kDelay + k) & (lms::kRing - 1)];
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
  constexpr int smem = smem_floats<kNB, kNR>() * (int)sizeof(float);
  static_assert(smem <= 232448, "shared memory of one H100 block");
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sweep_chain_kernel<kDemod, kNB, kNR, kEmitR>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  sweep_chain_kernel<kDemod, kNB, kNR, kEmitR>
      <<<channels, kThreads, smem, (cudaStream_t)stream>>>(a);
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
