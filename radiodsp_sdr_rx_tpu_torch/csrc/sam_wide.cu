// sam_wide.cu: the whole SAM chain for banks of more than 128 channels, G
// channels per thread block sharing one serial PLL stream (K7).
//
// Replaces _sam_wide_kernel (radiodsp_sdr_rx_tpu/ops/pallas_sam_wide.py:49;
// wrapper sweep_sam_wide :325) in two instantiations, each for G = 2, 4 or 8:
//   sam_wide      the chain without the blanker
//   sam_wide_nb   with the noise blanker (pallas_sam_wide.py:163-177)
// Per channel it computes what sweep_chain_sam (sweep_chain.cu) computes:
// input gain / IQ balance, [the blanker,] DDS NCO mix, the complex band-pass
// frames(rows,512) @ w_sb(512,256) -> (zr | zi), the carrier PLL of
// sam_pll.cuh -> vr, the DC blocker y[n] = vr[n] - vr[n-1] + 0.995*y[n-1],
// AGC, PBT frames(rows,256) @ w_pbt(256,256) -> [L|R], output gain, with the
// same carries. Only the re-seed schedule the caller passes differs: the JAX
// wide kernel re-seeds every 256 samples, the lanes kernel every 1,024.
//
// What bounds it on an H100: the PLL's chain of dependent steps (sam.cu), as
// in K6, and not the 3,072 flops and 16 B per sample of the rest. K6 runs one
// channel per block, so a 1,024-channel bank would run the serial chain in
// eight waves of 128 blocks.
//
// What the design does about it, the card's counterpart of the TPU's
// sublane trick: a block owns G channels and walks time in chunks of 64 rows
// of 128 samples as K1 does, but the 64 rows are R = 64/G rows of each of its
// G channels, so the two products keep K1's 64-row shape (chain_common.cuh's
// chunk_gemm with each channel's rows after its own carry row). Threads 0..G-1
// of warp 0 then run the G channels' PLLs side by side, one thread each, so
// the bank pays the serial chain once per G channels: 128 blocks of 8 for
// 1,024 channels, one wave. The DC blocker, the AGC and the blanker's average
// are the segmented scans of K1 with one carry per channel: each thread scans
// its 32-sample segment from zero, thread g runs channel g's segment ends
// serially into the carries (4R of them, a few against the PLL's 128R steps)
// and each thread re-runs its segment from the true carry. Channels past the
// end read zeros and store nothing.

#include "chain_args.cuh"
#include "chain_common.cuh"
#include "sam_pll.cuh"

namespace {

constexpr double kDcPole = 0.995;  // the DC blocker's pole (ops/iir.DC_POLE)

template <bool kSum>
__device__ __forceinline__ float scan_channel(float* seg, int nseg, float carry, float f_seg) {
  for (int s = 0; s < nseg; ++s) {
    const float end = seg[s];
    seg[s] = carry;
    carry = kSum ? end + carry * f_seg : fmaxf(end, carry * f_seg);
  }
  return carry;
}

template <int G>
constexpr int smem_floats(bool nb) {
  return kAsFloats + kBsFloats + 3 * (kRows + G) * kLd + kThreads + 6 * G + (nb ? G * kBlk : 0);
}

template <int G, bool kNB>
__global__ void __launch_bounds__(kThreads, 1) sam_wide_kernel(
    const float* __restrict__ xr, const float* __restrict__ xi,
    const long long* __restrict__ inc, const long long* __restrict__ phase0,
    const float* __restrict__ w_sb, const float* __restrict__ w_pbt,
    const float* __restrict__ tail_r, const float* __restrict__ tail_i,
    const float* __restrict__ atail_in, const float* __restrict__ env0,
    const float* __restrict__ dc0, const float* __restrict__ pll0,
    float* __restrict__ out_l, float* __restrict__ out_r,
    float* __restrict__ atail_out, float* __restrict__ env_out,
    float* __restrict__ dc_out, float* __restrict__ pll_out, int channels, int n,
    double release, float target, float max_gain, int agc_enabled, float out_gain,
    float g_i, float g_q, const float* __restrict__ nb_avg0,
    const float* __restrict__ nb_mask0, float* __restrict__ nb_avg_out,
    float* __restrict__ nb_mask_out, double nb_a, float nb_thresh, PllGains gains,
    Reseed reseed) {
  constexpr int R = kRows / G;       // rows of each channel in a chunk
  constexpr int kBuf = (kRows + G) * kLd;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = As + kAsFloats;
  float* Mr = Bs + kBsFloats;   // mixed I rows; channel g's rows g*(R+1) + 0..R
  float* Mi = Mr + kBuf;        // mixed Q rows, then zi
  float* Ab = Mi + kBuf;        // zr, then vr, then the audio, AGC applied in place
  float* seg = Ab + kBuf;       // scan segment ends, then carries into segments
  float* env_c = seg + kThreads;  // per channel: AGC envelope
  float* nbavg = env_c + G;       // blanker average
  float* dcx = nbavg + G;         // DC blocker: last input
  float* dcy = dcx + G;           // DC blocker: last output
  uint32_t* words = reinterpret_cast<uint32_t*>(dcy + G);   // [phase0 | inc]
  float* keep_row = dcy + 3 * G;  // nb: keep mask of the last row so far

  const int c0 = blockIdx.x * G, tid = threadIdx.x;
  const float rel = (float)release;
  const float rel_seg = (float)pow(release, (double)kSegLen);
  const float nb_af = (float)nb_a, nb_om = (float)(1.0 - nb_a);
  const float nb_seg = (float)pow(nb_a, (double)kSegLen);
  const float dc_pf = (float)kDcPole;
  const float dc_seg = (float)pow(kDcPole, (double)kSegLen);

  // the carried raw tails, re-scaled and re-mixed at positions -128..-1
  if (tid < G) {
    const int c = c0 + tid;
    const bool ok = c < channels;
    words[tid] = ok ? (uint32_t)phase0[c] : 0u;
    words[G + tid] = ok ? (uint32_t)inc[c] : 0u;
    env_c[tid] = ok ? env0[c] : 0.f;
    nbavg[tid] = ok && kNB ? nb_avg0[c] : 0.f;
    dcx[tid] = ok ? dc0[2 * c] : 0.f;
    dcy[tid] = ok ? dc0[2 * c + 1] : 0.f;
  }
  __syncthreads();
  for (int e = tid; e < G * kBlk; e += kThreads) {
    const int g = e / kBlk, j = e % kBlk, c = c0 + g;
    const int o = g * (R + 1) * kLd + j;
    float vr = 0.f, vi = 0.f, a = 0.f;
    if (c < channels) {
      const size_t t = (size_t)c * kBlk + j;
      mix(tail_r[t], tail_i[t], words[g] + (uint32_t)(j - kBlk) * words[G + g], g_i, g_q,
          vr, vi);
      if constexpr (kNB) {
        vr *= nb_mask0[t];
        vi *= nb_mask0[t];
      }
      a = atail_in[t];
    }
    Mr[o] = vr;
    Mi[o] = vi;
    Ab[o] = a;
  }

  // threads 0..G-1 run the PLLs, their state in registers across chunks
  Pll pll{0.f, 0.f, 0.f, 0.f};
  int next_seed = 0;
  if (tid < G && c0 + tid < channels) {
    pll.phase = pll0[c0 + tid];
    pll.freq = pll0[channels + c0 + tid];
  }

  // the thread's scan segment: chunk row i = g*R + r, quarter of the row
  const int si = tid % kRows, quarter = tid / kRows;
  const int sg = si / R, sr = si % R, s = si * kSegsPerRow + quarter;
  const int srow = sg * (R + 1) + 1 + sr;   // its buffer row

  const int nrows = n / kBlk;
  for (int row0 = 0; row0 < nrows; row0 += R) {
    const int rows = min(R, nrows - row0);

    // 1. scale [+ blank] + mix into each channel's rows 1..R (zeros past the end)
    // element e of the chunk: its buffer offset o, channel g and position pos
    auto in_row = [&](int e, int& o, int& g, int& pos) {
      const int i = e / kBlk, j = e % kBlk, r = i % R;
      g = i / R;
      o = (g * (R + 1) + 1 + r) * kLd + j;
      pos = (row0 + r) * kBlk + j;
      return r < rows && c0 + g < channels;
    };
    if constexpr (kNB) {
#pragma unroll 4
      for (int e = tid; e < kRows * kBlk; e += kThreads) {
        int o, g, pos;
        const bool ok = in_row(e, o, g, pos);
        const size_t at = (size_t)(c0 + g) * n + pos;
        Mr[o] = ok ? xr[at] * g_i : 0.f;
        Mi[o] = ok ? xi[at] * g_q : 0.f;
      }
      __syncthreads();
      {
        float* pr = Mr + srow * kLd + quarter * kSegLen;
        float* pi = Mi + srow * kLd + quarter * kSegLen;
        float y = 0.f;
        for (int k = 0; k < kSegLen; ++k)
          y = nb_af * y + nb_om * sqrtf(pr[k] * pr[k] + pi[k] * pi[k]);
        seg[s] = y;
        __syncthreads();
        if (tid < G) scan_channel<true>(seg + tid * R * kSegsPerRow, rows * kSegsPerRow,
                                        nbavg[tid], nb_seg);
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
          if (sr + 1 == rows) keep_row[sg * kBlk + quarter * kSegLen + k] = keep ? 1.f : 0.f;
        }
        if (sr + 1 == rows && quarter == kSegsPerRow - 1) nbavg[sg] = y;
      }
      __syncthreads();
#pragma unroll 4
      for (int e = tid; e < kRows * kBlk; e += kThreads) {
        int o, g, pos;
        if (in_row(e, o, g, pos))
          mix(Mr[o], Mi[o], words[g] + (uint32_t)pos * words[G + g], 1.f, 1.f, Mr[o], Mi[o]);
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < kRows * kBlk; e += kThreads) {
        int o, g, pos;
        float vr = 0.f, vi = 0.f;
        if (in_row(e, o, g, pos)) {
          const size_t at = (size_t)(c0 + g) * n + pos;
          mix(xr[at], xi[at], words[g] + (uint32_t)pos * words[G + g], g_i, g_q, vr, vi);
        }
        Mr[o] = vr;
        Mi[o] = vi;
      }
    }
    __syncthreads();

    // 2. complex band-pass: zr into the audio rows, zi into the Q rows, once
    // each channel's last mixed row has moved to its carry row
    {
      const int lane = tid & 31, warp = tid >> 5;
      float acc[8][8];
      chunk_gemm<256, ALayout::kFrames, R>(Mr, Mi, w_sb, 512, As, Bs, acc);
      for (int e = tid; e < G * kBlk; e += kThreads) {
        const int g = e / kBlk, j = e % kBlk, o = g * (R + 1) * kLd + j;
        Mr[o] = Mr[o + rows * kLd];
        Mi[o] = Mi[o + rows * kLd];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = warp * 8 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = (r + r / R + 1) * kLd + lane * 4 + j;
          Ab[o] = acc[i][j];
          Mi[o] = acc[i][4 + j];
        }
      }
    }
    __syncthreads();

    // 3. the G PLLs side by side, each over its channel's rows in time order
    if (tid < G) {
      for (int r = 0; r < rows; ++r) {
        float* a = Ab + (tid * (R + 1) + 1 + r) * kLd;
        const float* b = Mi + (tid * (R + 1) + 1 + r) * kLd;
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
    __syncthreads();

    // 4. DC blocker in place; each thread reads the input just before its
    // segment before any thread overwrites one
    {
      float* a = Ab + srow * kLd + quarter * kSegLen;
      const float prev = quarter ? a[-1] : (sr ? a[-kLd + kBlk - 1] : dcx[sg]);
      float y = 0.f, p = prev;
      for (int k = 0; k < kSegLen; ++k) {
        const float v = a[k];
        y = (v - p) + dc_pf * y;
        p = v;
      }
      seg[s] = y;
      __syncthreads();
      if (tid < G) scan_channel<true>(seg + tid * R * kSegsPerRow, rows * kSegsPerRow,
                                      dcy[tid], dc_seg);
      __syncthreads();
      y = seg[s];
      p = prev;
      for (int k = 0; k < kSegLen; ++k) {
        const float v = a[k];
        y = (v - p) + dc_pf * y;
        p = v;
        a[k] = y;
      }
      if (sr + 1 == rows && quarter == kSegsPerRow - 1) {
        dcx[sg] = p;
        dcy[sg] = y;
      }
    }
    __syncthreads();

    // 5. AGC
    {
      float* a = Ab + srow * kLd + quarter * kSegLen;
      float e = 0.f;
      for (int k = 0; k < kSegLen; ++k) e = fmaxf(fabsf(a[k]), e * rel);
      seg[s] = e;
      __syncthreads();
      if (tid < G) scan_channel<false>(seg + tid * R * kSegsPerRow, rows * kSegsPerRow,
                                       env_c[tid], rel_seg);
      __syncthreads();
      e = seg[s];
      for (int k = 0; k < kSegLen; ++k) {
        const float v = a[k];
        e = fmaxf(fabsf(v), e * rel);
        if (agc_enabled) a[k] = v * fminf(target / fmaxf(e, 1e-12f), max_gain);
      }
      if (sr + 1 == rows && quarter == kSegsPerRow - 1) env_c[sg] = e;
    }
    __syncthreads();

    // 6. PBT -> [L|R], output gain, straight to device memory
    {
      const int lane = tid & 31, warp = tid >> 5;
      float acc[8][8];
      chunk_gemm<256, ALayout::kFrames, R>(Ab, Ab, w_pbt, 256, As, Bs, acc);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = (warp * 8 + i) % R, g = (warp * 8 + i) / R;
        if (r < rows && c0 + g < channels) {
          const size_t o = (size_t)(c0 + g) * n + (size_t)(row0 + r) * kBlk + lane * 4;
          *reinterpret_cast<float4*>(out_l + o) =
              make_float4(acc[i][0] * out_gain, acc[i][1] * out_gain,
                          acc[i][2] * out_gain, acc[i][3] * out_gain);
          *reinterpret_cast<float4*>(out_r + o) =
              make_float4(acc[i][4] * out_gain, acc[i][5] * out_gain,
                          acc[i][6] * out_gain, acc[i][7] * out_gain);
        }
      }
    }

    // 7. each channel's last audio row becomes its carry row
    for (int e = tid; e < G * kBlk; e += kThreads) {
      const int o = (e / kBlk) * (R + 1) * kLd + e % kBlk;
      Ab[o] = Ab[o + rows * kLd];
    }
    __syncthreads();
  }

  for (int e = tid; e < G * kBlk; e += kThreads) {
    const int g = e / kBlk, j = e % kBlk, c = c0 + g;
    if (c < channels) {
      atail_out[(size_t)c * kBlk + j] = Ab[g * (R + 1) * kLd + j];
      if constexpr (kNB) nb_mask_out[(size_t)c * kBlk + j] = keep_row[g * kBlk + j];
    }
  }
  if (tid < G && c0 + tid < channels) {
    const int c = c0 + tid;
    env_out[c] = env_c[tid];
    dc_out[2 * c] = dcx[tid];
    dc_out[2 * c + 1] = dcy[tid];
    pll_out[c] = pll.phase;
    pll_out[channels + c] = pll.freq;
    if constexpr (kNB) nb_avg_out[c] = nbavg[tid];
  }
}

template <int G, bool kNB>
cudaError_t launch(const ChainArgs& a, int channels, cudaStream_t stream) {
  const int smem = smem_floats<G>(kNB) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(sam_wide_kernel<G, kNB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  sam_wide_kernel<G, kNB><<<(channels + G - 1) / G, kThreads, smem, stream>>>(
      a.xr, a.xi, a.inc, a.phase0, a.w_band, a.w_pbt, a.tail_r, a.tail_i, a.atail_in, a.env0,
      a.dc0, a.pll0, a.out_l, a.out_r, a.atail_out, a.env_out, a.dc_out, a.pll_out, channels,
      a.n, a.release, a.target, a.max_gain, a.agc_enabled, a.out_gain, a.g_i, a.g_q,
      a.nb_avg0, a.nb_mask0, a.nb_avg_out, a.nb_mask_out, a.nb_a, a.nb_thresh, a.gains,
      a.reseed);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_nb(const ChainArgs& a, int nb, int channels, cudaStream_t stream) {
  return nb ? launch<G, true>(a, channels, stream) : launch<G, false>(a, channels, stream);
}

}  // namespace

// chain_args.cuh's entry, with `groups` (2, 4 or 8) channels per block; the
// arguments as sweep_chain.cu's SAM chain takes them.
extern "C" int launch_chain(const void* args, int groups, int nb, int channels, int device,
                            void* stream) {
  const ChainArgs& a = *static_cast<const ChainArgs*>(args);
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (groups) {
    case 2: return (int)launch_nb<2>(a, nb, channels, s);
    case 4: return (int)launch_nb<4>(a, nb, channels, s);
    case 8: return (int)launch_nb<8>(a, nb, channels, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
