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
// What bounds it on an H100: the PLL's chain of dependent steps (sam_pll.cuh),
// n of them per segment whatever the channel count, and the 3,072 flops and
// 16 B per sample of the rest. K6 runs one channel per block, so a
// 1,024-channel bank would run the serial chain in eight waves of 128 blocks.
//
// What the design does about it, the card's counterpart of the TPU's
// sublane trick: a block owns G channels and walks time in chunks of 64 rows
// of 128 samples as K1 does, but the 64 rows are R = 64/G rows of each of its
// G channels, so the two products keep K1's 64-row shape (chain_common.cuh's
// chunk_gemm with each channel's rows after its own carry row: channel g's
// rows g*(R+1) + 0..R of a buffer). Lanes 0..G-1 of a ninth warp walk the
// G channels' PLLs side by side, one lane each, so the bank pays the serial
// chain once per G channels: 128 blocks of 8 for 1,024 channels, one wave.
// The walk runs a chunk ahead of the rest of the chain, as sweep_chain.cuh's
// sam_chain_kernel does (chain_common.cuh's walk_ahead): while the walking
// warp walks chunk k+1, the chain's eight warps run chunk k's DC blocker,
// AGC, PBT and output, then chunk k+2's scale, [blanker,] mix and band-pass,
// meeting at a named barrier. The block is SoloSync's, twelve warps, the
// walking warp alone on its scheduler: beside chain warps, its hundred
// instructions a step took their issue slots, and the chain, which paces
// K7, slowed with them. Chunk k lives in slot k & 1 of [I rows | Q
// rows]: the mix writes them, the band-pass writes zr over the I rows and zi
// over the Q rows (each channel's last mixed row saved first in its mixed
// carry row, the next chunk's row 0), the walk writes vr over zr, and the
// back reads it there, each channel's last audio row saved in its audio carry
// row. The DC blocker, the AGC and the blanker's average are the segmented
// scans of K1 with one carry per channel: each thread scans its 32-sample
// segment from zero, thread g runs channel g's segment ends serially into the
// carries (4R of them, a few against the PLL's 128R steps) and each thread
// re-runs its segment from the true carry; the blanker's scan stays in the
// front, since it feeds the mix. Channels past the end read zeros and store
// nothing, and a partial last chunk (fewer than R rows a channel) never
// reaches a carry. Shared memory (sam_wide_smem below), G = 8 with the
// blanker: 51,792 floats, 207,168 B of the 232,448 B a block may have.

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

// As, Bs, two slots of [I rows | Q rows] of 64 + G rows each, scan segment
// ends, 4 carries and 2 phase words a channel, the mixed carry rows [re | im]
// and the audio carry rows of the G channels; the blanker adds the keep masks
// of their last rows
// The block: the chain's eight warps and the walking warp on a scheduler of
// its own (chain_common.cuh's SoloSync)
using Sync = SoloSync;

template <int G, bool kNB>
constexpr int sam_wide_smem() {
  return kAsFloats + kBsFloats + 4 * (kRows + G) * kLd + kThreads + 6 * G + 3 * G * kBlk +
         (kNB ? G * kBlk : 0);
}

template <int G, bool kNB>
__global__ void __launch_bounds__(Sync::kBlock, 1) sam_wide_kernel(const ChainArgs a,
                                                                    int channels) {
  constexpr int R = kRows / G;       // rows of each channel in a chunk
  constexpr int kBuf = (kRows + G) * kLd;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = As + kAsFloats;
  float* slots = Bs + kBsFloats;  // chunk k in slot k & 1: I rows, then Q rows
  float* seg = slots + 4 * kBuf;  // scan segment ends, then carries into segments
  float* env_c = seg + kThreads;  // per channel: AGC envelope
  float* nbavg = env_c + G;       // blanker average
  float* dcx = nbavg + G;         // DC blocker: last input
  float* dcy = dcx + G;           // DC blocker: last output
  uint32_t* words = reinterpret_cast<uint32_t*>(dcy + G);   // [phase0 | inc]
  float* mc = dcy + 3 * G;        // per channel: the mixed rows' carry row [re | im]
  float* ac = mc + 2 * G * kBlk;  // per channel: the audio rows' carry row
  float* keep_row = ac + G * kBlk;  // nb: keep mask of the last row so far

  const int c0 = blockIdx.x * G, tid = Sync::tid(), warp = tid >> 5, lane = tid & 31;
  const int n = a.n, nrows = n / kBlk, chunks = (nrows + R - 1) / R;
  const float rel = (float)a.release;
  const float rel_seg = (float)pow(a.release, (double)kSegLen);
  const float nb_af = (float)a.nb_a, nb_om = (float)(1.0 - a.nb_a);
  const float nb_seg = (float)pow(a.nb_a, (double)kSegLen);
  const float dc_pf = (float)kDcPole;
  const float dc_seg = (float)pow(kDcPole, (double)kSegLen);

  if (tid < G) {
    const int c = c0 + tid;
    const bool ok = c < channels;
    words[tid] = ok ? (uint32_t)a.phase0[c] : 0u;
    words[G + tid] = ok ? (uint32_t)a.inc[c] : 0u;
    env_c[tid] = ok ? a.env0[c] : 0.f;
    nbavg[tid] = ok && kNB ? a.nb_avg0[c] : 0.f;
    dcx[tid] = ok ? a.dc0[2 * c] : 0.f;
    dcy[tid] = ok ? a.dc0[2 * c + 1] : 0.f;
  }
  __syncthreads();
  // the carried raw tails, re-scaled and re-mixed at positions -128..-1, and
  // the audio tails
  for (int e = tid; e < G * kBlk; e += Sync::kBlock) {
    const int g = e / kBlk, j = e % kBlk, c = c0 + g;
    float vr = 0.f, vi = 0.f, at = 0.f;
    if (c < channels) {
      const size_t t = (size_t)c * kBlk + j;
      mix(a.tail_r[t], a.tail_i[t], words[g] + (uint32_t)(j - kBlk) * words[G + g], a.g_i,
          a.g_q, vr, vi);
      if constexpr (kNB) {
        vr *= a.nb_mask0[t];
        vi *= a.nb_mask0[t];
      }
      at = a.atail_in[t];
    }
    mc[g * 2 * kBlk + j] = vr;
    mc[g * 2 * kBlk + kBlk + j] = vi;
    ac[g * kBlk + j] = at;
  }

  // lanes 0..G-1 of the walking warp walk the PLLs, their state in registers
  // across chunks
  const bool walker = warp == kThreads / 32 && lane < G;
  Pll pll{};
  int next_seed = 0;
  if (walker && c0 + lane < channels) {
    pll.phase = a.pll0[c0 + lane];
    pll.freq = a.pll0[channels + c0 + lane];
  }
  __syncthreads();

  // the thread's scan segment: chunk row i = g*R + r, quarter of the row
  const int si = tid % kRows, quarter = tid / kRows;
  const int sg = si / R, sr = si % R, s = si * kSegsPerRow + quarter;
  const int srow = sg * (R + 1) + 1 + sr;   // its buffer row

  // the chain: chunk k's scale [+ blank] + mix into each channel's rows 1..R
  // (zeros past the end) and the band-pass, zr over the I rows and zi over
  // the Q rows
  auto front = [&](int k) {
    float* Sr = slots + (k & 1) * 2 * kBuf;
    float* Si = Sr + kBuf;
    const int row0 = k * R, rows = min(R, nrows - row0);
    Sync::sync();   // chunk k-2's back has read the slot
    for (int e = tid; e < G * kBlk; e += kThreads) {
      const int g = e / kBlk, j = e % kBlk, o = g * (R + 1) * kLd + j;
      Sr[o] = mc[g * 2 * kBlk + j];
      Si[o] = mc[g * 2 * kBlk + kBlk + j];
    }
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
        Sr[o] = ok ? a.xr[at] * a.g_i : 0.f;
        Si[o] = ok ? a.xi[at] * a.g_q : 0.f;
      }
      Sync::sync();
      {
        float* pr = Sr + srow * kLd + quarter * kSegLen;
        float* pi = Si + srow * kLd + quarter * kSegLen;
        float y = 0.f;
        for (int q = 0; q < kSegLen; ++q)
          y = nb_af * y + nb_om * sqrtf(pr[q] * pr[q] + pi[q] * pi[q]);
        seg[s] = y;
        Sync::sync();
        if (tid < G) scan_channel<true>(seg + tid * R * kSegsPerRow, rows * kSegsPerRow,
                                        nbavg[tid], nb_seg);
        Sync::sync();
        y = seg[s];
        for (int q = 0; q < kSegLen; ++q) {
          const float m = sqrtf(pr[q] * pr[q] + pi[q] * pi[q]);
          y = nb_af * y + nb_om * m;
          const bool keep = m <= y * a.nb_thresh + 1e-12f;
          if (!keep) {
            pr[q] = 0.f;
            pi[q] = 0.f;
          }
          if (sr + 1 == rows) keep_row[sg * kBlk + quarter * kSegLen + q] = keep ? 1.f : 0.f;
        }
        if (sr + 1 == rows && quarter == kSegsPerRow - 1) nbavg[sg] = y;
      }
      Sync::sync();
#pragma unroll 4
      for (int e = tid; e < kRows * kBlk; e += kThreads) {
        int o, g, pos;
        if (in_row(e, o, g, pos))
          mix(Sr[o], Si[o], words[g] + (uint32_t)pos * words[G + g], 1.f, 1.f, Sr[o], Si[o]);
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < kRows * kBlk; e += kThreads) {
        int o, g, pos;
        float vr = 0.f, vi = 0.f;
        if (in_row(e, o, g, pos)) {
          const size_t at = (size_t)(c0 + g) * n + pos;
          mix(a.xr[at], a.xi[at], words[g] + (uint32_t)pos * words[G + g], a.g_i, a.g_q, vr,
              vi);
        }
        Sr[o] = vr;
        Si[o] = vi;
      }
    }
    Sync::sync();

    // the complex band-pass; each channel's last mixed row moves to its carry
    // row before zi overwrites the Q rows
    float acc[8][8];
    chunk_gemm<256, R, Sync>(Sr, Si, a.w_band, 512, As, Bs, acc);
    for (int e = tid; e < G * kBlk; e += kThreads) {
      const int g = e / kBlk, j = e % kBlk, o = (g * (R + 1) + rows) * kLd + j;
      mc[g * 2 * kBlk + j] = Sr[o];
      mc[g * 2 * kBlk + kBlk + j] = Si[o];
    }
    Sync::sync();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = warp * 8 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = (r + r / R + 1) * kLd + lane * 4 + j;
        Sr[o] = acc[i][j];
        Si[o] = acc[i][4 + j];
      }
    }
  };

  // the walking warp's lanes 0..G-1: the G PLLs side by side over chunk k,
  // each over its channel's rows in time order, vr over zr
  auto walk = [&](int k) {
    if (!walker) return;
    float* Sr = slots + (k & 1) * 2 * kBuf;
    const int row0 = k * R, rows = min(R, nrows - row0);
    for (int r = 0; r < rows; ++r) {
      float* p = Sr + (lane * (R + 1) + 1 + r) * kLd;
      walk_row(pll, a.gains, a.reseed, next_seed, (row0 + r) * kBlk, kBlk, p, p + kBuf, p);
    }
  };

  // the chain: chunk k's DC blocker, AGC, PBT and output from vr
  auto back = [&](int k) {
    float* Sr = slots + (k & 1) * 2 * kBuf;
    const int row0 = k * R, rows = min(R, nrows - row0);
    // each channel's row 0, which only PBT reads
    for (int e = tid; e < G * kBlk; e += kThreads) {
      const int g = e / kBlk, j = e % kBlk;
      Sr[g * (R + 1) * kLd + j] = ac[g * kBlk + j];
    }

    // the DC blocker in place; each thread reads the input just before its
    // segment before any thread overwrites one
    {
      float* p = Sr + srow * kLd + quarter * kSegLen;
      const float prev = quarter ? p[-1] : (sr ? p[-kLd + kBlk - 1] : dcx[sg]);
      float y = 0.f, q = prev;
      for (int m = 0; m < kSegLen; ++m) {
        const float v = p[m];
        y = (v - q) + dc_pf * y;
        q = v;
      }
      seg[s] = y;
      Sync::sync();
      if (tid < G) scan_channel<true>(seg + tid * R * kSegsPerRow, rows * kSegsPerRow,
                                      dcy[tid], dc_seg);
      Sync::sync();
      y = seg[s];
      q = prev;
      for (int m = 0; m < kSegLen; ++m) {
        const float v = p[m];
        y = (v - q) + dc_pf * y;
        q = v;
        p[m] = y;
      }
      if (sr + 1 == rows && quarter == kSegsPerRow - 1) {
        dcx[sg] = q;
        dcy[sg] = y;
      }
    }
    Sync::sync();

    // AGC in place
    {
      float* p = Sr + srow * kLd + quarter * kSegLen;
      float e = 0.f;
      for (int m = 0; m < kSegLen; ++m) e = fmaxf(fabsf(p[m]), e * rel);
      seg[s] = e;
      Sync::sync();
      if (tid < G) scan_channel<false>(seg + tid * R * kSegsPerRow, rows * kSegsPerRow,
                                       env_c[tid], rel_seg);
      Sync::sync();
      e = seg[s];
      for (int m = 0; m < kSegLen; ++m) {
        const float v = p[m];
        e = fmaxf(fabsf(v), e * rel);
        if (a.agc_enabled) p[m] = v * fminf(a.target / fmaxf(e, 1e-12f), a.max_gain);
      }
      if (sr + 1 == rows && quarter == kSegsPerRow - 1) env_c[sg] = e;
    }
    Sync::sync();

    // PBT -> [L|R], output gain, straight to device memory; each channel's
    // last audio row becomes its carry row (the product has read them all)
    float acc[8][8];
    chunk_gemm<256, R, Sync>(Sr, Sr, a.w_pbt, 256, As, Bs, acc);
    for (int e = tid; e < G * kBlk; e += kThreads) {
      const int g = e / kBlk, j = e % kBlk;
      ac[g * kBlk + j] = Sr[(g * (R + 1) + rows) * kLd + j];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (warp * 8 + i) % R, g = (warp * 8 + i) / R;
      if (r < rows && c0 + g < channels) {
        const size_t o = (size_t)(c0 + g) * n + (size_t)(row0 + r) * kBlk + lane * 4;
        *reinterpret_cast<float4*>(a.out_l + o) =
            make_float4(acc[i][0] * a.out_gain, acc[i][1] * a.out_gain,
                        acc[i][2] * a.out_gain, acc[i][3] * a.out_gain);
        *reinterpret_cast<float4*>(a.out_r + o) =
            make_float4(acc[i][4] * a.out_gain, acc[i][5] * a.out_gain,
                        acc[i][6] * a.out_gain, acc[i][7] * a.out_gain);
      }
    }
  };

  walk_ahead<Sync>(chunks, front, walk, back);

  for (int e = tid; e < G * kBlk; e += Sync::kBlock) {
    const int g = e / kBlk, j = e % kBlk, c = c0 + g;
    if (c < channels) {
      a.atail_out[(size_t)c * kBlk + j] = ac[g * kBlk + j];
      if constexpr (kNB) a.nb_mask_out[(size_t)c * kBlk + j] = keep_row[g * kBlk + j];
    }
  }
  if (tid < G && c0 + tid < channels) {
    const int c = c0 + tid;
    a.env_out[c] = env_c[tid];
    a.dc_out[2 * c] = dcx[tid];
    a.dc_out[2 * c + 1] = dcy[tid];
    if constexpr (kNB) a.nb_avg_out[c] = nbavg[tid];
  }
  if (walker && c0 + lane < channels) {
    a.pll_out[c0 + lane] = pll.phase;
    a.pll_out[channels + c0 + lane] = pll.freq;
  }
}

template <int G, bool kNB>
cudaError_t launch(const ChainArgs& a, int channels, cudaStream_t stream) {
  constexpr int smem = sam_wide_smem<G, kNB>() * (int)sizeof(float);
  static_assert(smem <= 232448, "shared memory of one H100 block");
  cudaError_t err = cudaFuncSetAttribute(sam_wide_kernel<G, kNB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  sam_wide_kernel<G, kNB><<<(channels + G - 1) / G, Sync::kBlock, smem, stream>>>(a, channels);
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
