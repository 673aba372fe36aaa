// sweep_chain.cu: the whole receive chain of one channel per thread block.
//
// Replaces _chain_kernel (radiodsp_sdr_rx_tpu/ops/pallas_sweep.py:261) in five
// instantiations of one template, demod x noise blanker x R output, and the
// SAM stage of _lanes_chain_kernel (ops/pallas_chain_lanes.py:98, stage "sam",
// wrapper sweep_lanes_chain :748) in two more:
//   sweep_chain_ssb      demod="ssb"            (wrapper sweep_full_chain :628)
//   sweep_chain_ssb_nb   demod="ssb", nb=true   (:327-331, 361-363, 386-403)
//   sweep_chain_am       demod="am"             (wrapper sweep_am_chain :695;
//                                                :339-341, 357-360, 418-447)
//   sweep_chain_am_nb    demod="am", nb=true
//   sweep_chain_ssb_mono demod="ssb", emit_r=False (:482-489, 558-561): R is
//                        neither computed into the output nor stored
//   sweep_chain_sam      pallas_chain_lanes demod="sam", nr="none" (:413-455,
//                        :620-627): the AM chain with the carrier PLL of
//                        sam_pll.cuh in place of the envelope
//   sweep_chain_sam_nb   the same with the noise blanker
// Per sample: input gain / IQ balance, [nb: the noise blanker,] DDS NCO mix,
// then
//   ssb: overlap-save band-pass + SSB demod as frames(rows,512) @ w_ssb(512,128);
//   am:  the complex band-pass frames(rows,512) @ w_sb(512,256) -> (zr | zi),
//        envelope sqrt(zr^2 + zi^2), DC blocker
//        y[n] = env[n] - env[n-1] + pole*y[n-1] (pole 0.995);
//   sam: the complex band-pass, then the PLL's in-phase product vr in place
//        of the envelope (carry: the (2, C) [phase | freq] rows, re-seeded
//        on the schedule the caller passes), then the same DC blocker;
// then AGC env[k] = max(|a[k]|, env[k-1]*release), gain =
// min(target/max(env,1e-12), max_gain) (not applied with AGC off), PBT
// frames(rows,256) @ w_pbt(256,256) -> [L|R], output gain.
//
// The noise blanker works on the scaled input before the mix: mag = |x|,
// avg[t] = a*avg[t-1] + (1-a)*mag[t] on the unblanked magnitude, and a sample
// is zeroed unless mag <= avg*thresh + 1e-12. The carried framing tail is
// re-mixed and multiplied by the previous segment's last keep mask; the
// average at the last sample and the last row's keep mask carry out. The AM
// DC blocker carries [last envelope, last output] (C, 2).
//
// What bounds it on an H100: per IQ sample it reads 8 B and writes 8 B, and
// does 2,048 flops for ssb (1,024 for each of the two products per 128
// samples) or 3,072 for am (2,048 for the twice-as-wide band-pass); the mono
// variant writes 4 B, not 8, and needs 1,536 flops (the compiler drops the R
// half of the PBT product, whose sums are never stored: 127 registers
// against 159). One
// 128-channel x 2^19-sample ssb segment is 1.07 GB (0.32 ms at 3.35 TB/s) and
// 137 GFLOP (2.0 ms at the 67 TFLOP/s fp32 rate outside the tensor cores):
// in fp32 SIMT it is bound by arithmetic. The blanker adds about 10 flops
// and a square root per sample, the AM envelope and DC blocker about 6 and
// a square root.
//
// What the design does about it: every intermediate stays on chip, so device
// memory sees only the 16 B/sample; the time goes to the two products, run
// as register-blocked fp32 FMA (8 rows x 4 or 8 columns per thread, the
// frame operand broadcast from shared memory, chain_common.cuh). One block of
// 256 threads owns one channel (128 blocks for 132 SMs; a 64-channel bank
// keeps only 64 SMs busy) and walks time in chunks of 64 rows of 128
// samples, which is what the TPU grid did with its sequential axis. The
// framing tail, the PBT tail, the AGC envelope, the blanker's average and the
// DC blocker's carries stay in shared memory from chunk to chunk. In the AM
// band-pass each thread's 8 columns are j and j+128 for four j, so the same
// thread holds zr and zi of a sample and writes its envelope straight into
// the audio rows. SAM writes zr into the audio rows and zi into the mixed Q
// rows (dead after the product once their last row has moved to row 0), and
// thread 0 walks the chunk's 8,192 samples in time order, overwriting zr with
// vr, while the other 255 threads wait at the barrier: the PLL's chain of
// dependent steps (sam.cu) then bounds the SAM kernels, about n steps of it
// per segment, with the rest of the chain stalled behind it. The AGC, the blanker's average and the DC blocker are
// scans over the chunk, run as 256 segments of 32 samples: each thread scans
// its segment from zero, warp 0 scans the segment ends (a decaying max for
// the AGC, a decaying sum for the other two) and each thread re-runs its
// segment from the true carry, so every sample follows the sequential
// recurrence. Segments past the end of a partial last chunk come after every
// valid one and never reach a carry. A TF32/3xTF32 tensor-core design of the
// two products is later work.

#include "chain_common.cuh"
#include "sam_pll.cuh"

namespace {

// every instantiation: As, Bs, three row buffers, segment ends, carries;
// nb adds the keep mask of the last row
constexpr int kSmemFloats = kAsFloats + kBsFloats + 3 * kRowBuf + kThreads + 4;

enum class Demod { kSSB, kAM, kSAM };

constexpr double kDcPole = 0.995;  // the AM DC blocker's pole (ops/iir.DC_POLE)

template <Demod kDemod, bool kNB, bool kEmitR>
__global__ void __launch_bounds__(kThreads, 1) sweep_chain_kernel(
    const float* __restrict__ xr, const float* __restrict__ xi,
    const long long* __restrict__ inc, const long long* __restrict__ phase0,
    const float* __restrict__ w_band, const float* __restrict__ w_pbt,
    const float* __restrict__ tail_r, const float* __restrict__ tail_i,
    const float* __restrict__ atail_in, const float* __restrict__ env0,
    float* __restrict__ out_l, float* __restrict__ out_r,
    float* __restrict__ atail_out, float* __restrict__ env_out, int n,
    double release, float target, float max_gain, int agc_enabled,
    float out_gain, float g_i, float g_q,
    const float* __restrict__ nb_avg0, const float* __restrict__ nb_mask0,
    float* __restrict__ nb_avg_out, float* __restrict__ nb_mask_out,
    double nb_a, float nb_thresh, const float* __restrict__ dc0,
    float* __restrict__ dc_out, const float* __restrict__ pll0,
    float* __restrict__ pll_out, PllGains gains, Reseed reseed) {
  constexpr bool kSAM = kDemod == Demod::kSAM;
  constexpr bool kDsb = kDemod == Demod::kAM || kSAM;  // the complex band-pass and DC blocker
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = As + kAsFloats;
  float* Mr = Bs + kBsFloats;  // mixed I rows
  float* Mi = Mr + kRowBuf;    // mixed Q rows
  float* Ab = Mi + kRowBuf;    // demodulated audio rows, AGC applied in place
  float* seg = Ab + kRowBuf;   // scan segment ends, then carries into segments
  float* env_c = seg + kThreads;  // [0] AGC envelope, [1] blanker average,
                                  // [2] [3] DC blocker: last envelope, last output
  float* keep_row = env_c + 4;    // nb: keep mask of the last row so far

  const int c = blockIdx.x, tid = threadIdx.x, warp = tid >> 5;
  const size_t base = (size_t)c * n;
  const uint32_t ph0 = (uint32_t)phase0[c];
  const uint32_t dph = (uint32_t)inc[c];
  const float rel = (float)release;
  float rel_lanes[5];
  const float rel_seg = seg_factors(release, rel_lanes);
  float nb_af = 0.f, nb_om = 0.f, nb_seg = 0.f, nb_lanes[5];
  if constexpr (kNB) {
    nb_af = (float)nb_a;
    nb_om = (float)(1.0 - nb_a);
    nb_seg = seg_factors(nb_a, nb_lanes);
  }
  float dc_pf = 0.f, dc_seg = 0.f, dc_lanes[5];
  if constexpr (kDsb) {
    dc_pf = (float)kDcPole;
    dc_seg = seg_factors(kDcPole, dc_lanes);
  }

  // the carried raw tail, re-scaled and re-mixed at positions -128..-1
  if (tid < kBlk) {
    const size_t t = (size_t)c * kBlk + tid;
    mix(tail_r[t], tail_i[t], ph0 + (uint32_t)(tid - kBlk) * dph, g_i, g_q,
        Mr[tid], Mi[tid]);
    if constexpr (kNB) {
      Mr[tid] *= nb_mask0[t];
      Mi[tid] *= nb_mask0[t];
    }
    Ab[tid] = atail_in[t];
  }
  // SAM: thread 0 runs the channel's PLL, its state in registers across chunks
  Pll pll{0.f, 0.f, 0.f, 0.f};
  int next_seed = 0;
  if (kSAM && tid == 0) {
    pll.phase = pll0[c];
    pll.freq = pll0[gridDim.x + c];
  }
  if (tid == 0) {
    env_c[0] = env0[c];
    if constexpr (kNB) env_c[1] = nb_avg0[c];
    if constexpr (kDsb) {
      env_c[2] = dc0[2 * c];
      env_c[3] = dc0[2 * c + 1];
    }
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
          vr = xr[base + pos] * g_i;
          vi = xi[base + pos] * g_q;
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
          const bool keep = m <= y * nb_thresh + 1e-12f;
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
          mix(xr[base + pos], xi[base + pos], ph0 + (uint32_t)pos * dph, g_i, g_q, vr, vi);
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
      const int lane = tid & 31;
      if constexpr (kSAM) {
        float acc[8][8];
        chunk_gemm<256>(Mr, Mi, w_band, 512, As, Bs, acc);
        // the mixed rows' last row becomes row 0 now: zi overwrites the Q rows
        if (tid < kBlk) {
          Mr[tid] = Mr[rows * kLd + tid];
          Mi[tid] = Mi[rows * kLd + tid];
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
            float* a = Ab + (r + 1) * kLd;
            const float* b = Mi + (r + 1) * kLd;
            const int pos0 = (row0 + r) * kBlk;
#pragma unroll 4
            for (int k = 0; k < kBlk; ++k) {
              if (pos0 + k == next_seed) {
                pll.reseed();
                next_seed = reseed.next(next_seed);
              }
              a[k] = pll.step(a[k], b[k], gains);
            }
          }
        }
      } else if constexpr (kDsb) {
        float acc[8][8];
        chunk_gemm<256>(Mr, Mi, w_band, 512, As, Bs, acc);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            Ab[(warp * 8 + i + 1) * kLd + lane * 4 + j] =
                sqrtf(acc[i][j] * acc[i][j] + acc[i][4 + j] * acc[i][4 + j]);
      } else {
        float acc[8][4];
        chunk_gemm<128>(Mr, Mi, w_band, 512, As, Bs, acc);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) Ab[(warp * 8 + i + 1) * kLd + lane * 4 + j] = acc[i][j];
      }
    }
    __syncthreads();

    // 2b. am: DC blocker in place, y = (env - env_prev) + pole*y, the
    // blanker's segmented decaying-sum scan. Each thread reads the envelope
    // just before its segment before any thread overwrites one.
    if constexpr (kDsb) {
      const int r = tid % kRows, quarter = tid / kRows;
      const int s = r * kSegsPerRow + quarter;
      float* a = Ab + (r + 1) * kLd + quarter * kSegLen;
      const float prev = quarter ? a[-1] : (r ? Ab[r * kLd + kBlk - 1] : env_c[2]);
      float y = 0.f, p = prev;
      for (int k = 0; k < kSegLen; ++k) {
        const float v = a[k];
        y = (v - p) + dc_pf * y;
        p = v;
      }
      seg[s] = y;
      __syncthreads();
      if (warp == 0) scan_segment_carries<true>(seg, env_c[3], dc_seg, dc_lanes);
      __syncthreads();
      y = seg[s];
      p = prev;
      for (int k = 0; k < kSegLen; ++k) {
        const float v = a[k];
        y = (v - p) + dc_pf * y;
        p = v;
        a[k] = y;
      }
      if (s == rows * kSegsPerRow - 1) {
        env_c[2] = p;
        env_c[3] = y;
      }
      __syncthreads();
    }

    // 3. AGC. Segment s = 4*row + quarter; segments past the end come after
    // every valid one, so they never reach a valid carry.
    {
      const int r = tid % kRows, quarter = tid / kRows;
      const int s = r * kSegsPerRow + quarter;
      float* a = Ab + (r + 1) * kLd + quarter * kSegLen;
      float e = 0.f;
      for (int k = 0; k < kSegLen; ++k) e = fmaxf(fabsf(a[k]), e * rel);
      seg[s] = e;
      __syncthreads();
      if (warp == 0) scan_segment_carries<false>(seg, env_c[0], rel_seg, rel_lanes);
      __syncthreads();
      e = seg[s];
      for (int k = 0; k < kSegLen; ++k) {
        const float v = a[k];
        e = fmaxf(fabsf(v), e * rel);
        if (agc_enabled) a[k] = v * fminf(target / fmaxf(e, 1e-12f), max_gain);
      }
      if (s == rows * kSegsPerRow - 1) env_c[0] = e;
    }
    __syncthreads();

    // 4. PBT -> [L|R] (L alone without kEmitR), output gain, straight to
    // device memory
    {
      float acc[8][8];
      chunk_gemm<256>(Ab, Ab, w_pbt, 256, As, Bs, acc);
      store_rows<256, kEmitR ? 2 : 1>(acc, out_l, out_r, base, row0, rows, out_gain);
    }

    // 5. this chunk's last row becomes the next chunk's row 0 (SAM moved
    // the mixed rows' in step 2)
    if (tid < kBlk) {
      if constexpr (!kSAM) {
        Mr[tid] = Mr[rows * kLd + tid];
        Mi[tid] = Mi[rows * kLd + tid];
      }
      Ab[tid] = Ab[rows * kLd + tid];
    }
    __syncthreads();
  }
  if (tid < kBlk) atail_out[(size_t)c * kBlk + tid] = Ab[tid];
  if (tid == 0) env_out[c] = env_c[0];
  if constexpr (kNB) {
    if (tid < kBlk) nb_mask_out[(size_t)c * kBlk + tid] = keep_row[tid];
    if (tid == 0) nb_avg_out[c] = env_c[1];
  }
  if constexpr (kDsb) {
    if (tid == 0) {
      dc_out[2 * c] = env_c[2];
      dc_out[2 * c + 1] = env_c[3];
    }
  }
  if (kSAM && tid == 0) {
    pll_out[c] = pll.phase;
    pll_out[gridDim.x + c] = pll.freq;
  }
}

template <Demod kDemod, bool kNB, bool kEmitR = true>
int launch(const float* xr, const float* xi, const long long* inc,
           const long long* phase0, const float* w_band, const float* w_pbt,
           const float* tail_r, const float* tail_i, const float* atail_in,
           const float* env0, float* out_l, float* out_r, float* atail_out,
           float* env_out, int channels, int n, int device, double release,
           float target, float max_gain, int agc_enabled, float out_gain,
           float g_i, float g_q, const float* nb_avg0, const float* nb_mask0,
           float* nb_avg_out, float* nb_mask_out, double nb_a, float nb_thresh,
           const float* dc0, float* dc_out, void* stream, const float* pll0 = nullptr,
           float* pll_out = nullptr, PllGains gains = {}, Reseed reseed = {}) {
  const int smem = (kSmemFloats + (kNB ? kBlk : 0)) * (int)sizeof(float);
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(sweep_chain_kernel<kDemod, kNB, kEmitR>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  sweep_chain_kernel<kDemod, kNB, kEmitR><<<channels, kThreads, smem, (cudaStream_t)stream>>>(
      xr, xi, inc, phase0, w_band, w_pbt, tail_r, tail_i, atail_in, env0, out_l,
      out_r, atail_out, env_out, n, release, target, max_gain, agc_enabled,
      out_gain, g_i, g_q, nb_avg0, nb_mask0, nb_avg_out, nb_mask_out, nb_a,
      nb_thresh, dc0, dc_out, pll0, pll_out, gains, reseed);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream` of CUDA device `device`; returns the cudaError_t of the
// launch (0 on success). Pointers are device pointers to contiguous tensors.
extern "C" int sweep_chain_ssb(
    const float* xr, const float* xi, const long long* inc,
    const long long* phase0, const float* w_ssb, const float* w_pbt,
    const float* tail_r, const float* tail_i, const float* atail_in,
    const float* env0, float* out_l, float* out_r, float* atail_out,
    float* env_out, int channels, int n, int device, double release,
    float target, float max_gain, int agc_enabled, float out_gain, float g_i,
    float g_q, void* stream) {
  return launch<Demod::kSSB, false>(
      xr, xi, inc, phase0, w_ssb, w_pbt, tail_r, tail_i, atail_in, env0, out_l,
      out_r, atail_out, env_out, channels, n, device, release, target, max_gain,
      agc_enabled, out_gain, g_i, g_q, nullptr, nullptr, nullptr, nullptr, 0.0,
      0.f, nullptr, nullptr, stream);
}

// The same with the noise blanker: nb_avg0 (C,) and nb_mask0 (C,128) in,
// nb_avg_out (C,) and nb_mask_out (C,128) out; nb_a = exp(-1/tau),
// nb_thresh = 10^(dB/20).
extern "C" int sweep_chain_ssb_nb(
    const float* xr, const float* xi, const long long* inc,
    const long long* phase0, const float* w_ssb, const float* w_pbt,
    const float* tail_r, const float* tail_i, const float* atail_in,
    const float* env0, float* out_l, float* out_r, float* atail_out,
    float* env_out, const float* nb_avg0, const float* nb_mask0,
    float* nb_avg_out, float* nb_mask_out, int channels, int n, int device,
    double release, float target, float max_gain, int agc_enabled,
    float out_gain, float g_i, float g_q, double nb_a, float nb_thresh,
    void* stream) {
  return launch<Demod::kSSB, true>(
      xr, xi, inc, phase0, w_ssb, w_pbt, tail_r, tail_i, atail_in, env0, out_l,
      out_r, atail_out, env_out, channels, n, device, release, target, max_gain,
      agc_enabled, out_gain, g_i, g_q, nb_avg0, nb_mask0, nb_avg_out,
      nb_mask_out, nb_a, nb_thresh, nullptr, nullptr, stream);
}

// The AM chain: w_sb (512,256) is the complex band-pass; dc0 (C,2) in and
// dc_out (C,2) out are the DC blocker's [last envelope, last output].
extern "C" int sweep_chain_am(
    const float* xr, const float* xi, const long long* inc,
    const long long* phase0, const float* w_sb, const float* w_pbt,
    const float* tail_r, const float* tail_i, const float* atail_in,
    const float* env0, const float* dc0, float* out_l, float* out_r,
    float* atail_out, float* env_out, float* dc_out, int channels, int n,
    int device, double release, float target, float max_gain, int agc_enabled,
    float out_gain, float g_i, float g_q, void* stream) {
  return launch<Demod::kAM, false>(
      xr, xi, inc, phase0, w_sb, w_pbt, tail_r, tail_i, atail_in, env0, out_l,
      out_r, atail_out, env_out, channels, n, device, release, target, max_gain,
      agc_enabled, out_gain, g_i, g_q, nullptr, nullptr, nullptr, nullptr, 0.0,
      0.f, dc0, dc_out, stream);
}

// The AM chain with the noise blanker (its carries as in sweep_chain_ssb_nb).
extern "C" int sweep_chain_am_nb(
    const float* xr, const float* xi, const long long* inc,
    const long long* phase0, const float* w_sb, const float* w_pbt,
    const float* tail_r, const float* tail_i, const float* atail_in,
    const float* env0, const float* dc0, float* out_l, float* out_r,
    float* atail_out, float* env_out, float* dc_out, const float* nb_avg0,
    const float* nb_mask0, float* nb_avg_out, float* nb_mask_out, int channels,
    int n, int device, double release, float target, float max_gain,
    int agc_enabled, float out_gain, float g_i, float g_q, double nb_a,
    float nb_thresh, void* stream) {
  return launch<Demod::kAM, true>(
      xr, xi, inc, phase0, w_sb, w_pbt, tail_r, tail_i, atail_in, env0, out_l,
      out_r, atail_out, env_out, channels, n, device, release, target, max_gain,
      agc_enabled, out_gain, g_i, g_q, nb_avg0, nb_mask0, nb_avg_out,
      nb_mask_out, nb_a, nb_thresh, dc0, dc_out, stream);
}

// The SSB chain without R (FusedNRBank(fold=False)'s DNR route): as
// sweep_chain_ssb, with no out_r.
extern "C" int sweep_chain_ssb_mono(
    const float* xr, const float* xi, const long long* inc,
    const long long* phase0, const float* w_ssb, const float* w_pbt,
    const float* tail_r, const float* tail_i, const float* atail_in,
    const float* env0, float* out_l, float* atail_out, float* env_out,
    int channels, int n, int device, double release, float target,
    float max_gain, int agc_enabled, float out_gain, float g_i, float g_q,
    void* stream) {
  return launch<Demod::kSSB, false, false>(
      xr, xi, inc, phase0, w_ssb, w_pbt, tail_r, tail_i, atail_in, env0, out_l,
      nullptr, atail_out, env_out, channels, n, device, release, target,
      max_gain, agc_enabled, out_gain, g_i, g_q, nullptr, nullptr, nullptr,
      nullptr, 0.0, 0.f, nullptr, nullptr, stream);
}

// The SAM chain: as sweep_chain_am, plus the PLL carry pll0 (2,C) in and
// pll_out (2,C) out, [phase row | freq row]; the loop gains kp, ki, max_freq;
// the oscillator re-seeds every `period` samples before position `split` and
// every `period2` samples from `split` on (sam_pll.cuh, Reseed).
extern "C" int sweep_chain_sam(
    const float* xr, const float* xi, const long long* inc,
    const long long* phase0, const float* w_sb, const float* w_pbt,
    const float* tail_r, const float* tail_i, const float* atail_in,
    const float* env0, const float* dc0, const float* pll0, float* out_l,
    float* out_r, float* atail_out, float* env_out, float* dc_out, float* pll_out,
    int channels, int n, int device, double release, float target, float max_gain,
    int agc_enabled, float out_gain, float g_i, float g_q, float kp, float ki,
    float max_freq, int period, int split, int period2, void* stream) {
  return launch<Demod::kSAM, false>(
      xr, xi, inc, phase0, w_sb, w_pbt, tail_r, tail_i, atail_in, env0, out_l,
      out_r, atail_out, env_out, channels, n, device, release, target, max_gain,
      agc_enabled, out_gain, g_i, g_q, nullptr, nullptr, nullptr, nullptr, 0.0,
      0.f, dc0, dc_out, stream, pll0, pll_out, {kp, ki, max_freq},
      {period, split, period2});
}

// The SAM chain with the noise blanker (its carries as in sweep_chain_ssb_nb).
extern "C" int sweep_chain_sam_nb(
    const float* xr, const float* xi, const long long* inc,
    const long long* phase0, const float* w_sb, const float* w_pbt,
    const float* tail_r, const float* tail_i, const float* atail_in,
    const float* env0, const float* dc0, const float* pll0, float* out_l,
    float* out_r, float* atail_out, float* env_out, float* dc_out, float* pll_out,
    const float* nb_avg0, const float* nb_mask0, float* nb_avg_out,
    float* nb_mask_out, int channels, int n, int device, double release,
    float target, float max_gain, int agc_enabled, float out_gain, float g_i,
    float g_q, double nb_a, float nb_thresh, float kp, float ki, float max_freq,
    int period, int split, int period2, void* stream) {
  return launch<Demod::kSAM, true>(
      xr, xi, inc, phase0, w_sb, w_pbt, tail_r, tail_i, atail_in, env0, out_l,
      out_r, atail_out, env_out, channels, n, device, release, target, max_gain,
      agc_enabled, out_gain, g_i, g_q, nb_avg0, nb_mask0, nb_avg_out,
      nb_mask_out, nb_a, nb_thresh, dc0, dc_out, stream, pll0, pll_out,
      {kp, ki, max_freq}, {period, split, period2});
}
